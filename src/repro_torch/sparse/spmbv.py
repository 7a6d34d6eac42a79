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
  slots);
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
transparent here: the executor reshapes ``(rmax, t) -> (rmax·cs, t/cs)``
around the exchange rounds and reassembles whole halo rows afterwards.

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
from repro_torch.kernels.halo_pack.ops import halo_pack, halo_unpack
from repro_torch.sparse.csr import CSRMatrix, csr_spmbv
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
    def _exchange(self, v3: torch.Tensor, plan: ExchangePlan, gathers, scatters) -> torch.Tensor:
        """Packed halo exchange of all ranks.  v3: (p, rmax, t) own rows;
        returns the halo blocks in row units, (p, plan.halo_rows, t).

        One ``halo_pack`` + ``halo_unpack`` pair per *phase*, one ppermute
        per nonzero rotation offset on a slice of the packed buffer.
        Col-split plans index (row, column-segment) slots: the rows are
        reshaped ``(rmax, t) -> (rmax·cs, t/cs)`` around the rounds, with t
        padded up to a multiple of cs when the applied width differs from
        the plan's (the width-1 initial residual)."""
        p, _, t = v3.shape
        cs = plan.col_split
        if cs > 1:
            tp = -(-t // cs) * cs
            if tp != t:
                v3 = torch.nn.functional.pad(v3, (0, tp - t))
            xs = v3.reshape(p, self.rmax * cs, tp // cs)
        else:
            xs = v3
        w = xs.shape[-1]
        halo = xs.new_zeros((p, plan.halo_size + 1, w))
        stage = xs.new_zeros((p, plan.stage_size + 1, w))
        for phase, g_idx, s_pos in zip(plan.phases, gathers, scatters):
            buf = halo_pack(xs if phase.src == "x" else stage, g_idx)  # (p, width, w)
            if any(phase.offsets):
                parts = []
                for i, off in enumerate(phase.offsets):
                    seg = buf[:, phase.bounds[i] : phase.bounds[i + 1]]
                    if off:
                        seg = self.mesh.ppermute(seg, phase.axis, off)
                    parts.append(seg)
                buf = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0].contiguous()
            halo_unpack(halo if phase.dst == "halo" else stage, buf, s_pos)
        halo = halo[:, : plan.halo_size]
        if cs > 1:
            halo = halo.reshape(p, plan.halo_rows, -1)[:, :, :t]
        return halo

    # ----------------------------------------------------- local products
    def _local_spmbv(self, v3: torch.Tensor, halo: torch.Tensor) -> torch.Tensor:
        """The p local [own ‖ halo] products; returns (p, rmax, t)."""
        p, rmax, t = v3.shape
        if self.backend == "pallas":
            m_pad = self.ell["m_pad"]
            parts = [v3, halo]
            if m_pad > rmax + halo.shape[1]:
                parts.append(v3.new_zeros((p, m_pad - rmax - halo.shape[1], t)))
            xfull = torch.cat(parts, dim=1).reshape(p * m_pad, t)
            blocks = self.ell["blocks"]
            if blocks.dtype != xfull.dtype:
                blocks = self._blocks_by_dtype.get(xfull.dtype)
                if blocks is None:
                    blocks = self._blocks_by_dtype[xfull.dtype] = self.ell["blocks"].to(xfull.dtype)
            w = bsr_spmbv(blocks, self.ell["indices"], xfull)  # (p·nbr·br, t)
            return w.reshape(p, -1, t)[:, :rmax]
        xfull = torch.cat([v3, halo], dim=1).reshape(-1, t)
        return csr_spmbv(self.csr, xfull).reshape(p, rmax, t)

    # ------------------------------------------------- width-sliced arrays
    def exchange_arrays(self, plan: ExchangePlan):
        """Stacked per-phase device index arrays for ``plan`` (cached by the
        plan's width and col-split)."""
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
        if plan is self.plan or plan.phases is self.plan.phases:
            gathers, scatters = self.gathers, self.scatters
        else:
            gathers, scatters = self.exchange_arrays(plan)

        def apply(v: torch.Tensor) -> torch.Tensor:
            shape = v.shape
            v3 = v.reshape(self.mesh.local_ranks, self.rmax, -1)
            halo = self._exchange(v3, plan, gathers, scatters)
            return self._local_spmbv(v3, halo).reshape(shape)

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
