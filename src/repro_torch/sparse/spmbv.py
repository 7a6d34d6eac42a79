"""Distributed SpMBV:  W = A · V  with node-aware halo exchange.

Port of ``repro/sparse/spmbv.py``.  The matrix is row-partitioned over a
("node", "proc") mesh; block vectors share the row distribution (paper §3).
The halo exchange replays a static
:class:`~repro_torch.core.node_aware.ExchangePlan`, then the local SpMBV runs
on [own rows ‖ halo rows].

The reference runs the per-rank program under ``shard_map``.  Here the mesh
is a :class:`~repro_torch.launch.mesh.VirtualMesh`: every per-rank array is
stacked along a leading rank axis, so a block vector in the padded per-rank
layout is one (p·rmax, t) tensor, viewed as (p, rmax, t), and one kernel
launch serves all p ranks:

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
``mesh.device``.  The host-side build stacks the arrays of all p ranks; a
process-group mesh (one rank per process, ROADMAP.md queue 1 item 5b)
keeps its own rank's slice of each.

Col-split plans (wide-halo payload splitting, nodal-optimal strategy) are
transparent here: the exchange views the own rows ``(rmax, t)`` as
``(rmax·cs, t/cs)`` segments and reassembles whole halo rows afterwards.

Not ported yet: ``overlap=True`` (the interior/boundary schedule, ROADMAP.md
queue 1 item 5a) and tuning (item 9).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.node_aware import ExchangePlan, build_exchange_plan
from repro_torch.kernels.bsr_spmbv.ops import (
    bsr_spmbv,
    count_block_ell_tiles,
    csr_arrays_to_block_ell,
)
from repro_torch.sparse.csr import CSRMatrix, csr_spmbv
from repro_torch.sparse.exchange import HaloExchange
from repro_torch.sparse.partition import (
    PartitionedMatrix,
    partition_csr,
    rebased_local_csr,
)


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md {item})")


@dataclasses.dataclass
class DistributedSpMBV:
    """Device-ready distributed SpMBV operator on a (virtual) mesh.

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
    gathers: list[torch.Tensor]
    scatters: list[torch.Tensor]
    backend: str = "jnp"
    # pallas: {"blocks": (p·nbr, kmax, br, bc), "indices": (p·nbr, kmax),
    #          "m_pad": per-rank operand rows}
    ell: dict = dataclasses.field(default_factory=dict)
    # jnp: block-diagonal CSR of the p local [own ‖ halo] blocks
    csr: CSRMatrix | None = None
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
        return self.p * self.rmax

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    # ----------------------------------------------------------- layouts
    def shard_vector(self, v, dtype=None) -> torch.Tensor:
        """Lay out a global (n,) or (n, t) array into the padded per-rank
        layout (rank r's block of rmax rows holds its partition rows, then
        zeros), as a (p·rmax, ...) tensor on the mesh's device."""
        v = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        out = np.zeros((self.n_padded,) + v.shape[1:], v.dtype)
        for r in range(self.p):
            lo, hi = self.starts[r], self.starts[r + 1]
            out[r * self.rmax : r * self.rmax + (hi - lo)] = v[lo:hi]
        return torch.as_tensor(out, device=self.device, dtype=dtype)

    def unshard(self, w) -> np.ndarray:
        """Inverse of :meth:`shard_vector`: a global (n, ...) numpy array."""
        w = w.detach().cpu().numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        out = np.zeros((self.n,) + w.shape[1:], w.dtype)
        for r in range(self.p):
            lo, hi = self.starts[r], self.starts[r + 1]
            out[lo:hi] = w[r * self.rmax : r * self.rmax + (hi - lo)]
        return out

    def padded_mask(self) -> np.ndarray:
        """(n_padded,) 1.0 where the slot backs a true row."""
        return (self.true_row_of_slot() >= 0).astype(np.float64)

    def true_row_of_slot(self) -> np.ndarray:
        """(n_padded,) true global row id per padded slot (-1 for pads)."""
        m = np.full(self.n_padded, -1, dtype=np.int64)
        for r in range(self.p):
            lo, hi = self.starts[r], self.starts[r + 1]
            m[r * self.rmax : r * self.rmax + (hi - lo)] = np.arange(lo, hi)
        return m

    # ------------------------------------------------------------ exchange
    @property
    def m_pad(self) -> int:
        """Rows of one rank's [own ‖ halo ‖ pad] operand."""
        return self.ell["m_pad"] if self.backend == "pallas" else self.rmax + self.plan.halo_rows

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
    def _local_spmbv(self, xfull: torch.Tensor) -> torch.Tensor:
        """The p local [own ‖ halo] products of ``xfull`` (p, m_pad, t);
        returns (p, rmax, t)."""
        p, m_pad, t = xfull.shape
        if self.backend == "pallas":
            blocks = self.ell["blocks"]
            if blocks.dtype != xfull.dtype:
                blocks = self._blocks_by_dtype.get(xfull.dtype)
                if blocks is None:
                    blocks = self._blocks_by_dtype[xfull.dtype] = self.ell["blocks"].to(xfull.dtype)
            w = bsr_spmbv(blocks, self.ell["indices"], xfull.view(p * m_pad, t))  # (p·nbr·br, t)
            return w.reshape(p, -1, t)[:, : self.rmax]
        return csr_spmbv(self.csr, xfull.view(p * m_pad, t)).reshape(p, self.rmax, t)

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
            hit = _phase_arrays(plan, self.rmax, self.device)
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
            xfull = self.exchange(plan, v3.shape[2], v3.dtype).run(v3)
            return self._local_spmbv(xfull).reshape(v.shape)

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


def _phase_arrays(plan: ExchangePlan, rmax: int, device):
    """Per-phase (p, width) int32 gather/scatter tensors on ``device``, each
    checked once against the buffer it indexes (the kernels do not check)."""
    src_rows = {"x": rmax * plan.col_split, "stage": plan.stage_size + 1}
    dst_rows = {"halo": plan.halo_size + 1, "stage": plan.stage_size + 1}
    gathers, scatters = [], []
    for ph in plan.phases:
        for arr, bound, what in ((ph.gather_idx, src_rows[ph.src], "gather"),
                                 (ph.scatter_pos, dst_rows[ph.dst], "scatter")):
            if arr.size and not (0 <= arr.min() and arr.max() < bound):
                raise ValueError(f"plan {what} index outside [0, {bound}) in phase "
                                 f"{ph.axis}:{ph.src}->{ph.dst}")
        gathers.append(torch.as_tensor(np.ascontiguousarray(ph.gather_idx, np.int32), device=device))
        scatters.append(torch.as_tensor(np.ascontiguousarray(ph.scatter_pos, np.int32), device=device))
    return gathers, scatters


def _stack_block_ell(per_rank, n_rows_max, n_cols, br, bc, dtype):
    """Convert per-rank CSR triples to one stacked Block-ELL array:
    blocks (p, nbr, kmax, br, bc), indices (p, nbr, kmax)."""
    p = len(per_rank)
    nbr = max(1, (n_rows_max + br - 1) // br)
    kmax = max(
        [count_block_ell_tiles(g[1], g[2], len(g[0]), n_cols, br, bc) for g in per_rank]
        + [1]
    )
    blocks = np.zeros((p, nbr, kmax, br, bc), dtype)
    idx = np.zeros((p, nbr, kmax), np.int32)
    for r, (rows, gptr, gix, gdat) in enumerate(per_rank):
        blocks[r], idx[r] = csr_arrays_to_block_ell(
            gptr, gix, gdat, len(rows), n_cols, br, bc, nbr, kmax
        )
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
    Block-ELL here (one-time host cost) with tile ``ell_block`` (an int for
    square tiles or a (br, bc) pair); ``col_split`` overrides the
    nodal-optimal wide-halo splitting factor (must divide t; ``None`` = §4.3
    byte model).  ``overlap=True`` and ``tune`` other than ``"off"`` are not
    ported yet.

    ``ell`` reuses another operator's Block-ELL arrays (its ``.ell``) built
    on the same partition and tile: the [own ‖ halo] layout depends on the
    partition alone, not on the exchange strategy, so a sibling operator
    with another strategy skips the conversion.
    """
    if backend not in ("jnp", "pallas"):
        raise ValueError(f"unknown backend {backend!r}")
    if overlap:
        _not_ported("overlap=True (the interior/boundary schedule)", "queue 1 item 5a")
    if not (tune is None or tune == "off"):
        _not_ported(f"tuning (tune={tune!r})", "queue 1 item 9")
    n_nodes, ppn = mesh.shape
    p = n_nodes * ppn
    pm = pm or partition_csr(a, p)
    if pm.p != p:
        raise ValueError(f"partition has {pm.p} ranks, mesh {p}")

    plan = build_exchange_plan(
        pm, n_nodes, ppn, strategy, t=t, machine=machine, col_split=col_split
    )
    rmax = pm.part.max_local_rows
    val_dtype = np.asarray(pm.local_data[0]).dtype
    # per-rank (indptr, indices-with-halo-at-rmax, data, n_local)
    rebased = rebased_local_csr(pm)
    n_cols_full = rmax + plan.halo_rows
    br, bc = (ell_block, ell_block) if isinstance(ell_block, int) else tuple(ell_block)

    csr = None
    if backend == "pallas" and ell:
        nbc_r = -(-n_cols_full // bc)
        if ell["m_pad"] != nbc_r * bc or tuple(ell["blocks"].shape[-2:]) != (br, bc):
            raise ValueError("the supplied Block-ELL arrays do not fit this partition and tile")
    elif backend == "pallas":
        per_rank = [(np.arange(n_local), ptr, ix, dat) for ptr, ix, dat, n_local in rebased]
        blocks, idx = _stack_block_ell(per_rank, rmax, n_cols_full, br, bc, val_dtype)
        nbc_r = -(-n_cols_full // bc)  # block columns of one rank's operand
        idx = idx + (np.arange(p, dtype=np.int32) * nbc_r)[:, None, None]
        ell = {
            "blocks": torch.as_tensor(blocks.reshape((-1,) + blocks.shape[2:]), device=mesh.device),
            "indices": torch.as_tensor(idx.reshape(-1, idx.shape[-1]), device=mesh.device),
            "m_pad": nbc_r * bc,
        }
    else:
        ell = {}
        csr = _block_diagonal_csr(rebased, rmax, n_cols_full, val_dtype, mesh.device)

    gathers, scatters = _phase_arrays(plan, rmax, mesh.device)
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
    )
