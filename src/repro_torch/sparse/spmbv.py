"""Distributed SpMBV:  W = A · V  with node-aware halo exchange.

Port of ``repro/sparse/spmbv.py``.  The matrix is row-partitioned over a
("node", "proc") mesh; block vectors share the row distribution (paper §3).
The halo exchange replays a static
:class:`~repro_torch.core.node_aware.ExchangePlan`, then the local SpMBV runs
on [own rows ‖ halo rows].

The reference runs the per-rank program under ``shard_map``.  Here every
per-rank array is stacked along a leading rank axis over the ranks the
process holds (all p on a :class:`~repro_torch.launch.mesh.VirtualMesh`,
see below for one rank per process), so a block vector in the padded
per-rank layout is one (p·rmax, t) tensor, viewed as (p, rmax, t), and one
kernel launch serves all p ranks:

* the exchange is *phase-packed*: each phase of the plan is ONE
  ``halo_pack`` launch (a fused gather into a contiguous send buffer for
  every rank), one ``mesh.ppermute`` per nonzero rotation offset, and ONE
  ``halo_unpack`` launch (a fused, in-place scatter into the halo/stage
  slots).  Each width keeps its exchange in a
  :class:`~repro_torch.sparse.exchange.HaloExchange` over static buffers,
  replayed as one CUDA graph on the card, so an apply costs the host the
  copy of V's rows into the ``[own ‖ halo ‖ pad]`` operand, one graph
  launch and the local product;
* ``backend="pallas"`` runs the p local Block-ELL products as ONE
  ``bsr_spmbv`` launch: the stacked tiles are flattened to
  (p·nbr, kmax, br, bc), rank r's block-column ids are offset by
  r·m_pad_r/bc, and [own ‖ halo] of all ranks is laid out as one
  (p·m_pad_r, t) operand;
* ``backend="jnp"`` runs the CSR form as one gather / ``index_add_`` over a
  block-diagonal CSR of the p local [own ‖ halo] blocks.

The device program uses only ``mesh.local_ranks``, ``mesh.ppermute`` and
``mesh.device``.  Every process computes the partition and the exchange
plan whole (they are equal bit for bit everywhere); the build then
converts (on ``mesh.device``) and stacks only the ranks the process holds
(``mesh.ranks``): all p on a :class:`~repro_torch.launch.mesh.VirtualMesh`,
its own on a :class:`~repro_torch.launch.mesh.ProcessGroupMesh` (one rank
per process), whose block vectors are (rmax, t) and whose exchange arrays
are its own row of each phase's, padded over ranks as the plan pads them,
so every send equals the matching receive in size.  ``unshard`` gathers
every rank's rows there (``mesh.all_gather``).  The overlap schedule needs
every rank stacked and is refused on a process-group mesh.

Col-split plans (wide-halo payload splitting, nodal-optimal strategy) are
transparent here: the exchange views the own rows ``(rmax, t)`` as
``(rmax·cs, t/cs)`` segments and reassembles whole halo rows afterwards.

``overlap=True`` is the comm/compute overlap schedule.  At build time each
rank's local rows are split into *interior* rows (no halo column;
:func:`~repro_torch.sparse.partition.interior_boundary_split`, whole block
rows for the pallas backend) and *boundary* rows, each set gathered into
its own stacked Block-ELL arrays (pallas) or CSR triples (jnp), in the
reference's layout (:attr:`DistributedSpMBV.split`).  An apply then runs the
interior product on V alone while the exchange runs, the boundary product on
[own ‖ halo] after it, and copies both into one output by row.  On the card
the exchange's CUDA graph replays on a second stream (enqueued first) while
the interior SpMBV runs on the current one, and the boundary SpMBV waits on
the replay's event; on CPU tensors it is the same code with no streams.

``tune`` hands the strategy, the Block-ELL tile and the overlap to the
setup-time autotuner (:mod:`repro_torch.tune`), as the reference does.

:func:`make_distributed_spmbv` and :func:`distributed_ecg` are the
reference's legacy spellings (each warns ``DeprecationWarning``): the first
builds the bare operator, the second maps its argument list onto a
:class:`~repro_torch.solver.SolverConfig`, builds an
:class:`~repro_torch.solver.ECGSolver` handle and solves once.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from repro_torch.core.node_aware import ExchangePlan, build_exchange_plan
from repro_torch.kernels.bsr_spmbv.ops import (
    _as_tensor,
    _block_ell_fill,
    bsr_spmbv,
    count_block_ell_tiles,
)
from repro_torch.launch.mesh import refuse_unstacked
from repro_torch.sparse.csr import CSRMatrix, csr_spmbv
from repro_torch.sparse.exchange import HaloExchange
from repro_torch.sparse.partition import (
    PartitionedMatrix,
    interior_boundary_split,
    partition_csr,
    rebased_local_csr,
)


@dataclasses.dataclass
class DistributedSpMBV:
    """Device-ready distributed SpMBV operator on a mesh.  Its device arrays
    hold the ranks ``mesh.ranks`` names (below, p is their count: every
    rank on a virtual mesh, one on a process-group mesh).

    ``backend`` selects the local SpMBV formulation (CSR gather/``index_add_``
    vs the Block-ELL CUDA kernel).  Only the representation the selected
    backend reads is on the device: ``ell`` (pallas) or ``csr`` (jnp).
    """

    mesh: object
    plan: ExchangePlan
    n: int                 # true global rows
    rmax: int              # padded rows per rank
    starts: np.ndarray     # (p+1,) partition row offsets (true global ids)
    # stacked per-PHASE exchange index arrays, (p, width) int32 on the device
    # (widths padded over every rank of the mesh)
    gathers: list[torch.Tensor]
    scatters: list[torch.Tensor]
    backend: str = "jnp"
    # pallas: {"blocks": (p·nbr, kmax, br, bc), "indices": (p·nbr, kmax),
    #          "m_pad": per-rank operand rows}
    ell: dict = dataclasses.field(default_factory=dict)
    # jnp: block-diagonal CSR of the p local [own ‖ halo] blocks
    csr: CSRMatrix | None = None
    # rows of one rank's [own ‖ halo ‖ pad] operand
    operand_rows: int = 0
    # overlap=True: the interior/boundary split in the reference's stacked
    # layout (see _build_split), and the kernels' views of it (_split_views)
    overlap: bool = False
    split: dict = dataclasses.field(default_factory=dict)
    _views: dict = dataclasses.field(default_factory=dict)
    _side_stream: object = None
    # the applied repro_torch.tune.TunedConfig (None when built untuned)
    tuned: object = None
    # per-width device index arrays, filled on demand by width re-slices
    _width_arrays: dict = dataclasses.field(default_factory=dict)
    # one HaloExchange (static buffers, CUDA graph) per
    # (plan width, col split, applied width, dtype)
    _exchanges: dict = dataclasses.field(default_factory=dict)
    # the tiles cast to another working dtype (a float32 operator solved
    # with a float64 right-hand side runs in float64, as the reference)
    _blocks_by_dtype: dict = dataclasses.field(default_factory=dict)

    @property
    def p(self) -> int:
        return self.plan.p

    @property
    def n_padded(self) -> int:
        """Rows of this process's padded layout: p·rmax on a virtual mesh,
        rmax per rank it holds."""
        return self.mesh.local_ranks * self.rmax

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    # ----------------------------------------------------------- layouts
    def shard_vector(self, v, dtype=None) -> torch.Tensor:
        """Lay out a global (n,) or (n, t) array into the padded per-rank
        layout (rank r's block of rmax rows holds its partition rows, then
        zeros), as an (n_padded, ...) tensor on the mesh's device holding
        the ranks of ``mesh.ranks``."""
        v = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        out = np.zeros((self.n_padded,) + v.shape[1:], v.dtype)
        for i, r in enumerate(self.mesh.ranks):
            lo, hi = self.starts[r], self.starts[r + 1]
            out[i * self.rmax : i * self.rmax + (hi - lo)] = v[lo:hi]
        return torch.as_tensor(out, device=self.device, dtype=dtype)

    def unshard(self, w) -> np.ndarray:
        """Inverse of :meth:`shard_vector`: a global (n, ...) numpy array,
        from every rank's padded rows (``mesh.all_gather``: on a
        process-group mesh every process calls it and gets the whole)."""
        w = torch.as_tensor(w, device=self.device)
        w = self.mesh.all_gather(w.reshape((self.mesh.local_ranks, self.rmax) + w.shape[1:]))
        w = w.reshape((self.p * self.rmax,) + w.shape[2:]).detach().cpu().numpy()
        out = np.zeros((self.n,) + w.shape[1:], w.dtype)
        for r in range(self.p):
            lo, hi = self.starts[r], self.starts[r + 1]
            out[lo:hi] = w[r * self.rmax : r * self.rmax + (hi - lo)]
        return out

    def padded_mask(self) -> np.ndarray:
        """(n_padded,) 1.0 where the slot backs a true row."""
        return (self.true_row_of_slot() >= 0).astype(np.float64)

    def true_row_of_slot(self) -> np.ndarray:
        """(n_padded,) true global row id per padded slot of this process
        (-1 for pads)."""
        m = np.full(self.n_padded, -1, dtype=np.int64)
        for i, r in enumerate(self.mesh.ranks):
            lo, hi = self.starts[r], self.starts[r + 1]
            m[i * self.rmax : i * self.rmax + (hi - lo)] = np.arange(lo, hi)
        return m

    # ------------------------------------------------------------ exchange
    @property
    def m_pad(self) -> int:
        """Rows of one rank's [own ‖ halo ‖ pad] operand."""
        return self.operand_rows

    def exchange(self, plan: ExchangePlan, t: int, dtype) -> HaloExchange:
        """The exchange of ``plan`` (``self.plan`` or one of its width
        re-slices) applied to ``t`` columns of ``dtype`` (built at first use)."""
        key = (plan.t, plan.col_split, t, dtype)
        ex = self._exchanges.get(key)
        if ex is None:
            gathers, scatters = self.exchange_arrays(plan)
            ex = HaloExchange(self.mesh, plan, gathers, scatters, self.rmax, self.m_pad, t, dtype)
            self._exchanges[key] = ex
        return ex

    # ----------------------------------------------------- local products
    def _tiles(self, name: str, blocks: torch.Tensor, dtype) -> torch.Tensor:
        """``blocks`` in ``dtype`` (cast once and kept: a float32 operator
        solved with a float64 right-hand side runs in float64)."""
        if blocks.dtype == dtype:
            return blocks
        hit = self._blocks_by_dtype.get((name, dtype))
        if hit is None:
            hit = self._blocks_by_dtype[(name, dtype)] = blocks.to(dtype)
        return hit

    def _local_spmbv(self, xfull: torch.Tensor) -> torch.Tensor:
        """The local [own ‖ halo] products of ``xfull`` (p, m_pad, t), p the
        ranks this process holds; returns (p, rmax, t)."""
        p, m_pad, t = xfull.shape
        if self.backend == "pallas":
            blocks = self._tiles("ell", self.ell["blocks"], xfull.dtype)
            w = bsr_spmbv(blocks, self.ell["indices"], xfull.view(p * m_pad, t))  # (p·nbr·br, t)
            return w.reshape(p, -1, t)[:, : self.rmax]
        return csr_spmbv(self.csr, xfull.view(p * m_pad, t)).reshape(p, self.rmax, t)

    def _part_spmbv(self, part: str, operand: torch.Tensor) -> torch.Tensor:
        """The interior (``part="int"``, ``operand`` the own rows (p, rmax,
        t)) or boundary (``"bnd"``, ``operand`` [own ‖ halo] (p, m_pad, t))
        product of all ranks, one output row per row of the part's stacked
        layout."""
        view = self._split_views()[part]
        t = operand.shape[-1]
        if self.backend == "pallas":
            rows = view["operand_rows"]
            if operand.shape[1] != rows:  # own rows short of the interior's tile grid
                operand = torch.nn.functional.pad(operand, (0, 0, 0, rows - operand.shape[1]))
            blocks = self._tiles(part, view["blocks"], operand.dtype)
            return bsr_spmbv(blocks, view["indices"], operand.reshape(-1, t))
        return csr_spmbv(view["csr"], operand.reshape(-1, t))

    def _split_views(self) -> dict:
        """Per part, what the products read (built once from :attr:`split`):
        pallas: the stacked tiles flattened to (p·nbr, kmax, br, bc), their
        block-column ids offset by rank and the operand rows of a rank; jnp:
        a block-diagonal CSR of the p ranks' gathered rows.  ``dst``: per
        output row, its row of the (p·rmax + 1, t) output (the last row
        takes the padding rows); ``"pad"``: the output rows that no part
        writes (the padding rows past a rank's own), which stay zero."""
        if self._views:
            return self._views
        p, rmax, dev = self.p, self.rmax, self.device
        for part, n_cols in (("int", rmax), ("bnd", self.m_pad)):
            rows = self.split[f"{part}_rows"]  # (p, n_max), padded with rmax
            view = {}
            if self.backend == "pallas":
                blocks, idx = self.split[f"{part}_blocks"], self.split[f"{part}_idx"]
                _, nbr, kmax, br, bc = blocks.shape
                nbc = -(-n_cols // bc)
                offsets = torch.arange(p, dtype=torch.int32, device=dev) * nbc
                view.update(blocks=blocks.reshape((-1,) + tuple(blocks.shape[2:])),
                            indices=(idx + offsets[:, None, None]).reshape(-1, kmax).contiguous(),
                            operand_rows=nbc * bc)
                out_rows = nbr * br  # output rows per rank
            else:
                view["csr"] = _block_diagonal_gathered_csr(
                    self.split[f"{part}_indptr"], self.split[f"{part}_indices"],
                    self.split[f"{part}_data"], n_cols)
                out_rows = rows.shape[1]
            dst = torch.full((p, out_rows), p * rmax, dtype=torch.int64, device=dev)
            n_max = rows.shape[1]
            real = rows.long()
            dst[:, :n_max] = torch.where(
                real < rmax, real + torch.arange(p, device=dev)[:, None] * rmax, p * rmax)
            view["dst"] = dst.reshape(-1)
            view["empty"] = n_max == 0
            self._views[part] = view
        # the padding rows of ranks with fewer than rmax rows: the only rows
        # of the output neither part writes (none at Example 2.1's shape)
        covered = np.zeros(p * rmax, bool)
        for part in ("int", "bnd"):
            rows = self.split[f"{part}_rows"].cpu().numpy()
            flat = rows + np.arange(p)[:, None] * rmax
            covered[flat[rows < rmax]] = True
        self._views["pad"] = torch.as_tensor(np.flatnonzero(~covered), device=dev)
        return self._views

    def _overlap_apply(self, ex: HaloExchange, v3: torch.Tensor) -> torch.Tensor:
        """One SpMBV by the interior/boundary schedule: the exchange (on the
        side stream on the card), the interior product on the own rows, then
        the boundary product on [own ‖ halo] once the exchange is done; the
        two copied into one output by row.  Returns (p·rmax, t)."""
        p, rmax, t = v3.shape
        views = self._split_views()
        stream = None
        if v3.is_cuda:
            if self._side_stream is None:
                self._side_stream = torch.cuda.Stream(device=v3.device)
            stream = self._side_stream
        xfull, done = ex.start(v3, stream)  # enqueued before the interior product
        out = torch.empty(p * rmax + 1, t, dtype=v3.dtype, device=v3.device)
        if views["pad"].numel():
            out.index_fill_(0, views["pad"], 0.0)
        if not views["int"]["empty"]:
            out.index_copy_(0, views["int"]["dst"], self._part_spmbv("int", v3))
        if done is not None:
            torch.cuda.current_stream(v3.device).wait_event(done)
        if not views["bnd"]["empty"]:
            out.index_copy_(0, views["bnd"]["dst"], self._part_spmbv("bnd", xfull))
        return out[: p * rmax]

    # ------------------------------------------------- width-sliced arrays
    def exchange_arrays(self, plan: ExchangePlan):
        """Stacked per-phase device index arrays for ``plan``: the operator's
        own when ``plan`` shares its phases, else built once per width and
        col-split."""
        if plan.phases is self.plan.phases:
            return self.gathers, self.scatters
        key = (plan.t, plan.col_split)
        hit = self._width_arrays.get(key)
        if hit is None:
            hit = _phase_arrays(plan, self.rmax, self.device, self.mesh.ranks)
            self._width_arrays[key] = hit
        return hit

    # ------------------------------------------------------------------ api
    def matvec_fn(self, t_active: int | None = None):
        """Returns ``f(V (n_padded, t)) -> (n_padded, t)``.

        ``t_active`` applies the operator through the width-sliced sub-plan
        ``plan.at_width(t_active)``; the block vectors passed to the
        returned function must then carry ``t_active`` columns."""
        plan = self.plan if t_active is None else self.plan.at_width(t_active)

        def apply(v: torch.Tensor) -> torch.Tensor:
            v3 = v.reshape(self.mesh.local_ranks, self.rmax, -1)
            ex = self.exchange(plan, v3.shape[2], v3.dtype)
            if self.overlap:
                return self._overlap_apply(ex, v3).reshape(v.shape)
            return self._local_spmbv(ex.run(v3)).reshape(v.shape)

        return apply

    def masked_matvec_fn(self, t_active: int):
        """Width-compacted apply for the adaptive solver.

        Returns ``f(V (n_padded, t), active (t,) bool) -> (n_padded, t)``:
        the ``t_active`` active columns (zero-masked block vectors guarantee
        the rest are zero) are gathered to the front in their order, pushed
        through the width-``t_active`` operator — its exchange, over
        ``plan.at_width(t_active)`` and its own CUDA graph, moves exactly
        ``t_active`` columns — and scattered back into a zero (n, t) block.
        Equal to the full-width apply: the gather and scatter move data only
        and A·0 = 0 for the retired columns.
        """
        apply_active = self.matvec_fn(t_active=t_active)

        def apply(v: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
            # stable argsort: active columns first, original order preserved;
            # gather/scatter along rows (index_select along dim 1 reads the
            # (n, t) block at a fraction of the card's memory rate)
            cols = torch.argsort(~active, stable=True)[:t_active].expand(v.shape[0], t_active)
            wc = apply_active(torch.gather(v, 1, cols))
            return torch.zeros_like(v).scatter_(1, cols, wc)

        return apply


def _phase_arrays(plan: ExchangePlan, rmax: int, device, ranks: range | None = None):
    """Per-phase (len(ranks), width) int32 gather/scatter tensors on
    ``device``, the rows of ``ranks`` (default every rank), each checked
    once against the buffer it indexes (the kernels do not check)."""
    src_rows = {"x": rmax * plan.col_split, "stage": plan.stage_size + 1}
    dst_rows = {"halo": plan.halo_size + 1, "stage": plan.stage_size + 1}
    own = slice(None) if ranks is None else slice(ranks.start, ranks.stop)
    gathers, scatters = [], []
    for ph in plan.phases:
        for arr, bound, what in ((ph.gather_idx, src_rows[ph.src], "gather"),
                                 (ph.scatter_pos, dst_rows[ph.dst], "scatter")):
            if arr.size and not (0 <= arr.min() and arr.max() < bound):
                raise ValueError(f"plan {what} index outside [0, {bound}) in phase "
                                 f"{ph.axis}:{ph.src}->{ph.dst}")
        gathers.append(torch.as_tensor(np.ascontiguousarray(ph.gather_idx[own], np.int32), device=device))
        scatters.append(torch.as_tensor(np.ascontiguousarray(ph.scatter_pos[own], np.int32), device=device))
    return gathers, scatters


def _gather_csr_rows(ptr, ix, dat, rows):
    """The CSR rows ``rows`` as a compact (len(rows), ·) CSR triple (the
    reference's, vectorized)."""
    counts = np.diff(ptr)[rows]
    gptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    src = np.repeat(ptr[rows] - gptr[:-1], counts) + np.arange(gptr[-1])
    return gptr, ix[src], dat[src]


def _stack_gathered_csr(per_rank, n_rows_max, rmax, dtype):
    """Per-rank gathered CSR triples and their row ids stacked into (p, ·)
    arrays, as the reference: row ids padded with the dump row ``rmax``,
    indptr with its last value, nonzeros with index 0 and value 0."""
    p = len(per_rank)
    nnz_max = max((int(g[1][-1]) for g in per_rank), default=0)
    rows_ids = np.full((p, n_rows_max), rmax, np.int32)
    indptr = np.zeros((p, n_rows_max + 1), np.int32)
    indices = np.zeros((p, nnz_max), np.int32)
    data = np.zeros((p, nnz_max), dtype)
    for r, (rows, gptr, gix, gdat) in enumerate(per_rank):
        rows_ids[r, : len(rows)] = rows
        indptr[r, : len(gptr)] = gptr
        indptr[r, len(gptr):] = gptr[-1]
        indices[r, : len(gix)] = gix
        data[r, : len(gdat)] = gdat
    return rows_ids, indptr, indices, data


def _build_split(pm, rebased, rmax, n_cols_full, backend, br, bc, dtype, device) -> dict:
    """The overlap schedule's interior/boundary arrays in the reference's
    stacked (p, ·) layout (``DistributedSpMBV.split`` there): ``int_rows``/
    ``bnd_rows`` and, for pallas, ``int_blocks``/``int_idx`` over the own
    rows and ``bnd_blocks``/``bnd_idx`` over [own ‖ halo]; for jnp the
    gathered CSR triples ``{int,bnd}_{indptr,indices,data}``.  The pallas
    split classifies whole block rows, so the gathered subsets keep the
    Block-ELL tiles as built (converted on ``device``)."""
    io = interior_boundary_split(pm, block_row=br if backend == "pallas" else 1)
    n_int_max = max(len(i) for i, _ in io)
    n_bnd_max = max(len(b_) for _, b_ in io)
    int_per_rank, bnd_per_rank = [], []
    for (ptr, ix, dat, _n_local), (int_rows, bnd_rows) in zip(rebased, io):
        int_per_rank.append((int_rows,) + _gather_csr_rows(ptr, ix, dat, int_rows))
        bnd_per_rank.append((bnd_rows,) + _gather_csr_rows(ptr, ix, dat, bnd_rows))
    int_ids, int_ptr, int_ix, int_dat = _stack_gathered_csr(int_per_rank, n_int_max, rmax, dtype)
    bnd_ids, bnd_ptr, bnd_ix, bnd_dat = _stack_gathered_csr(bnd_per_rank, n_bnd_max, rmax, dtype)
    split = {"int_rows": int_ids, "bnd_rows": bnd_ids}
    if backend == "pallas":
        split["int_blocks"], split["int_idx"] = _stack_block_ell(
            int_per_rank, n_int_max, rmax, br, bc, device)
        split["bnd_blocks"], split["bnd_idx"] = _stack_block_ell(
            bnd_per_rank, n_bnd_max, n_cols_full, br, bc, device)
    else:
        split.update(int_indptr=int_ptr, int_indices=int_ix, int_data=int_dat,
                     bnd_indptr=bnd_ptr, bnd_indices=bnd_ix, bnd_data=bnd_dat)
    return split


def _block_diagonal_gathered_csr(indptr, indices, data, n_cols) -> CSRMatrix:
    """The stacked per-rank gathered CSR triples (p, ·) as one block-diagonal
    CSR: rank r's rows start at r·n_rows, its columns at r·n_cols."""
    p, n_rows = indptr.shape[0], indptr.shape[1] - 1
    ptr = indptr.long()
    counts = (ptr[:, 1:] - ptr[:, :-1]).reshape(-1)
    keep = torch.arange(indices.shape[1], device=indices.device)[None, :] < ptr[:, -1:]
    cols = (indices.long() + torch.arange(p, device=indices.device)[:, None] * n_cols)[keep]
    full = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
    return CSRMatrix(full.to(torch.int32), cols.to(torch.int32), data[keep],
                     (p * n_rows, p * n_cols))


def _stack_block_ell(per_rank, n_rows_max, n_cols, br, bc, device):
    """Convert per-rank CSR triples to one stacked Block-ELL array on
    ``device``: blocks (p, nbr, kmax, br, bc), indices (p, nbr, kmax).  The
    tile count and the fill run there, on a copy of the ranks' CSR arrays
    (the card's for a mesh on it), as the sequential build's conversion
    does (``csr_arrays_to_block_ell``'s arrays, exactly)."""
    p = len(per_rank)
    nbr = max(1, (n_rows_max + br - 1) // br)
    ranks = [(len(rows),) + tuple(_as_tensor(a).to(device) for a in (gptr, gix, gdat))
             for rows, gptr, gix, gdat in per_rank]
    kmax = max([count_block_ell_tiles(ptr, ix, n, n_cols, br, bc) for n, ptr, ix, _ in ranks] + [1])
    blocks = torch.zeros((p, nbr, kmax, br, bc), dtype=ranks[0][3].dtype, device=device)
    idx = torch.zeros((p, nbr, kmax), dtype=torch.int32, device=device)
    for r, (n, ptr, ix, dat) in enumerate(ranks):
        blocks[r], idx[r] = _block_ell_fill(ptr, ix, dat, n, n_cols, br, bc, nbr, kmax)
    return blocks, idx


def _block_diagonal_csr(rebased, rmax, n_cols, dtype, device) -> CSRMatrix:
    """The p local [own ‖ halo] CSR blocks as one block-diagonal CSR of shape
    (p·rmax, p·n_cols): rank r's rows start at r·rmax, its columns at
    r·n_cols (rows past a rank's n_local are empty)."""
    p = len(rebased)
    counts = np.zeros(p * rmax, np.int64)
    indices, data = [], []
    for r, (ptr, ix, dat, n_local) in enumerate(rebased):
        counts[r * rmax : r * rmax + n_local] = np.diff(ptr)
        indices.append(ix + r * n_cols)
        data.append(dat)
    indptr = np.concatenate([[0], np.cumsum(counts)])
    return CSRMatrix.from_numpy(
        indptr, np.concatenate(indices), np.concatenate(data).astype(dtype, copy=False),
        (p * rmax, p * n_cols), device=device,
    )


def make_distributed_spmbv(
    a: CSRMatrix,
    mesh,
    strategy: str = "standard",
    t: int = 1,
    machine=None,
    pm: PartitionedMatrix | None = None,
    backend: str = "jnp",
    overlap: bool = False,
    ell_block: int | tuple[int, int] = 8,
    tune: str | object = "off",
    col_split: int | None = None,
) -> DistributedSpMBV:
    """Deprecated spelling of the operator build — the handle API owns it.

    ``ECGSolver.build(a, mesh, SolverConfig(...))`` performs the same
    partition + plan + tune + Block-ELL setup once and exposes the operator
    as ``solver.op``; this function remains for external callers that only
    want the bare SpMBV operator.  See :func:`_make_distributed_spmbv` for
    the arguments.
    """
    warnings.warn(
        "make_distributed_spmbv() is the legacy stringly-typed spelling; "
        "build a repro_torch.solver.ECGSolver handle (typed SolverConfig) and use "
        "solver.op instead",
        DeprecationWarning,
        stacklevel=2,
    )
    return _make_distributed_spmbv(
        a, mesh, strategy, t=t, machine=machine, pm=pm, backend=backend,
        overlap=overlap, ell_block=ell_block, tune=tune, col_split=col_split,
    )


def _make_distributed_spmbv(
    a: CSRMatrix,
    mesh,
    strategy: str = "standard",
    t: int = 1,
    machine=None,
    pm: PartitionedMatrix | None = None,
    backend: str = "jnp",
    overlap: bool = False,
    ell_block: int | tuple[int, int] = 8,
    tune: str | object = "off",
    col_split: int | None = None,
    ell: dict | None = None,
) -> DistributedSpMBV:
    """Partition ``a`` over ``mesh`` and build the device-ready operator.

    ``backend="pallas"`` converts each rank's local [own ‖ halo] CSR block to
    Block-ELL here (a one-time cost, on the mesh's device) with tile ``ell_block`` (an int for
    square tiles or a (br, bc) pair); ``col_split`` overrides the
    nodal-optimal wide-halo splitting factor (must divide t; ``None`` = §4.3
    byte model).

    ``tune`` hands the strategy, tile and overlap to the setup-time
    autotuner (:mod:`repro_torch.tune`): ``"model"`` selects them from the
    paper's analytic performance models, ``"model:structural"`` from the
    executor-structural model (plan dispatches + moved bytes),
    ``"measure"`` from setup-time microbenchmarks on ``mesh``, and a
    :class:`~repro_torch.tune.TunedConfig` applies a previous choice; the
    tuned strategy, overlap, tile, machine and ``col_split`` then win over
    the explicit arguments, and :attr:`DistributedSpMBV.tuned` records the
    config.  ``"off"`` (default) keeps the explicit arguments.

    ``ell`` reuses another operator's Block-ELL arrays (its ``.ell``) built
    on the same partition and tile: the [own ‖ halo] layout depends on the
    partition alone, not on the exchange strategy, so a sibling operator
    with another strategy skips the conversion.

    ``overlap=True`` builds the interior/boundary split instead of the
    whole local blocks (:attr:`DistributedSpMBV.split`, as the reference).

    Only the ranks ``mesh.ranks`` holds are converted and put on the
    device; on a process-group mesh ``overlap`` and ``tune="measure"``
    raise ``NotImplementedError`` (the split and the microbenchmarks stack
    every rank).
    """
    if backend not in ("jnp", "pallas"):
        raise ValueError(f"unknown backend {backend!r}")
    if tune == "measure":
        refuse_unstacked(mesh, 'tune mode "measure"')
    n_nodes, ppn = mesh.shape
    p = n_nodes * ppn
    pm = pm or partition_csr(a, p)
    if pm.p != p:
        raise ValueError(f"partition has {pm.p} ranks, mesh {p}")

    tuned = None
    if not (tune is None or tune == "off"):
        from repro_torch.tune import TunedConfig, tune as run_tune

        if isinstance(tune, TunedConfig):
            tuned = tune
        elif tune in ("model", "model:structural", "measure"):
            tuned = run_tune(
                a, t=t, machine=machine, n_nodes=n_nodes, ppn=ppn,
                pm=pm, backend=backend, mode=tune, mesh=mesh,
            )
        else:
            raise ValueError(f"unknown tune mode {tune!r}")
        strategy = tuned.strategy
        overlap = tuned.overlap
        ell_block = (tuned.br, tuned.bc)
        # keep the built plan consistent with the config's byte-model
        # decisions: the tuner's dtype-resolved machine wins over the raw
        # caller argument it was derived from
        machine = tuned.machine or machine
        if col_split is None and tuned.col_split > 1:
            col_split = tuned.col_split

    plan = build_exchange_plan(
        pm, n_nodes, ppn, strategy, t=t, machine=machine, col_split=col_split
    )
    if overlap:
        refuse_unstacked(mesh, "the overlap schedule (overlap=True)")
    rmax = pm.part.max_local_rows
    val_dtype = np.asarray(pm.local_data[0]).dtype
    # per held rank (indptr, indices-with-halo-at-rmax, data, n_local)
    rebased = rebased_local_csr(pm, mesh.ranks)
    n_cols_full = rmax + plan.halo_rows
    br, bc = (ell_block, ell_block) if isinstance(ell_block, int) else tuple(ell_block)

    nbc_r = -(-n_cols_full // bc)  # block columns of one rank's operand
    operand_rows = nbc_r * bc if backend == "pallas" else n_cols_full
    nbr = max(1, -(-rmax // br))  # block rows of one rank
    csr, split = None, {}
    if overlap:
        ell = {}
        split = {k_: torch.as_tensor(v_, device=mesh.device) for k_, v_ in _build_split(
            pm, rebased, rmax, n_cols_full, backend, br, bc, val_dtype, mesh.device).items()}
    elif backend == "pallas" and ell:
        if (ell["m_pad"] != operand_rows or tuple(ell["blocks"].shape[-2:]) != (br, bc)
                or ell["blocks"].shape[0] != mesh.local_ranks * nbr):
            raise ValueError("the supplied Block-ELL arrays do not fit this partition, tile and mesh")
    elif backend == "pallas":
        # the held ranks' tiles, their block-column ids offset by position
        per_rank = [(np.arange(n_local), ptr, ix, dat) for ptr, ix, dat, n_local in rebased]
        blocks, idx = _stack_block_ell(per_rank, rmax, n_cols_full, br, bc, mesh.device)
        idx += (torch.arange(len(rebased), dtype=torch.int32, device=mesh.device) * nbc_r)[:, None, None]
        ell = {
            "blocks": blocks.view((-1,) + blocks.shape[2:]),
            "indices": idx.view(-1, idx.shape[-1]),
            "m_pad": operand_rows,
        }
    else:
        ell = {}
        csr = _block_diagonal_csr(rebased, rmax, n_cols_full, val_dtype, mesh.device)

    gathers, scatters = _phase_arrays(plan, rmax, mesh.device, mesh.ranks)
    return DistributedSpMBV(
        mesh=mesh,
        plan=plan,
        n=a.shape[0],
        rmax=rmax,
        starts=pm.part.starts,
        gathers=gathers,
        scatters=scatters,
        backend=backend,
        ell=ell,
        csr=csr,
        operand_rows=operand_rows,
        overlap=overlap,
        split=split,
        tuned=tuned,
    )


def distributed_ecg(
    a: CSRMatrix,
    b,
    mesh,
    t: int | str,
    strategy: str = "standard",
    tol: float = 1e-8,
    max_iters: int = 500,
    machine=None,
    backend: str = "jnp",
    overlap: bool = False,
    ell_block: int | tuple[int, int] = 8,
    tune: str | object = "off",
    adaptive: object = None,
    t_candidates: tuple = (1, 2, 4, 8, 16),
):
    """Distributed ECG solve with the selected node-aware SpMBV strategy.

    Returns ``(SolveResult, operator)``; ``result.x`` is in the operator's
    padded per-rank layout (``operator.unshard`` gives the global vector).
    ``strategy="tuned"`` is shorthand for ``tune="model"``; ``t="auto"``
    picks the enlarging factor at build time and runs the tuner's config
    for it; ``adaptive`` selects the width controller (width-segmented
    exchange on the mesh) — the handle's options, see
    :class:`repro_torch.solver.ECGSolver`.  ``mesh`` is a
    :class:`~repro_torch.launch.mesh.VirtualMesh` or a
    :class:`~repro_torch.launch.mesh.ProcessGroupMesh` (every process
    calls it), and the solve runs on its device.

    .. deprecated::
        This is the legacy stringly-typed spelling.  It builds a
        :class:`repro_torch.solver.ECGSolver` handle, solves once, and
        discards the handle — build the handle yourself to amortize setup
        over many right-hand sides.
    """
    warnings.warn(
        "distributed_ecg() is the legacy stringly-typed spelling; build a "
        "repro_torch.solver.ECGSolver handle (compile-once / solve-many, typed "
        "SolverConfig) instead",
        DeprecationWarning,
        stacklevel=2,
    )
    solver = _build_legacy_solver(
        a, mesh, t, strategy=strategy, tol=tol, max_iters=max_iters,
        machine=machine, backend=backend, overlap=overlap,
        ell_block=ell_block, tune=tune, adaptive=adaptive,
        t_candidates=t_candidates, b=b,
    )
    return solver.solve(b), solver.op


def _build_legacy_solver(
    a, mesh, t, *, strategy="standard", tol=1e-8, max_iters=500, machine=None,
    backend="jnp", overlap=False, ell_block=8, tune="off", adaptive=None,
    t_candidates=(1, 2, 4, 8, 16), b=None,
):
    """Map the legacy ``distributed_ecg`` argument list onto a typed
    :class:`~repro_torch.solver.SolverConfig` and build the handle."""
    from repro_torch.solver import (
        AdaptiveConfig, CommConfig, ECGSolver, KernelConfig, SolverConfig,
        TuneConfig,
    )

    if strategy == "tuned":
        strategy = "standard"
        if tune is None or tune == "off":
            tune = "model"
    config = SolverConfig(
        t=t,
        tol=tol,
        max_iters=max_iters,
        comm=CommConfig(strategy=strategy, overlap=overlap, machine=machine),
        kernel=KernelConfig(backend=backend, ell_block=ell_block),
        tune=TuneConfig.coerce(None if tune == "off" else tune),
        adaptive=AdaptiveConfig(policy=adaptive, t_candidates=tuple(t_candidates)),
    )
    return ECGSolver.build(a, mesh, config, b=b)
