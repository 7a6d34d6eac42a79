"""Build the preconditioner apply callable for a solver handle.

Port of ``repro/precondition/build.py``.  Both builders return
``precond(V, k) -> M⁻¹ₖ V`` (or ``None`` for ``kind="none"``): V is the
(n, t) block in the handle's vector layout (padded per-rank slots on a
mesh), k the iteration index — only the inexact kind reads it.

Reduction accounting (what keeps the classic scheme's three reductions per
iteration):

* block-Jacobi — one ``block_trisolve`` launch for all ranks, no exchange
  and no reduction;
* Chebyshev / inexact — extra SpMBV applications (halo exchanges only); no
  preconditioner apply ever issues a ``psum``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.kernels.block_trisolve.ops import block_trisolve
from repro_torch.precondition.block_jacobi import (
    extract_blocks,
    factor_blocks,
    rank_slot_layout,
    slot_layout,
)
from repro_torch.precondition.chebyshev import (
    distributed_power_matvec,
    make_chebyshev_apply,
    resolve_bounds,
)
from repro_torch.precondition.config import PreconditionConfig
from repro_torch.precondition.inexact import extract_diagonal, make_inexact_apply


class BlockJacobiApply:
    """``(V, k) -> M⁻¹V`` for block-Jacobi: one ``block_trisolve`` launch
    over the (ranks·rmax, t) row layout, each rank's rows cut into its own
    blocks.  Rows past rmax in a rank's last block are identity padding
    slots, which the op treats as zero rows, so no apply pads or copies V.

    ``factors`` are the (nb, bs, bs) lower factors on the device, cast once
    per working dtype (the reference casts on every apply); ``build_s``
    holds the extract / factor / transfer seconds of the build.
    """

    def __init__(self, a, row_of_slot: np.ndarray, block: int, ranks: int, device):
        t0 = time.perf_counter()
        blocks = extract_blocks(a, row_of_slot, block)
        t1 = time.perf_counter()
        factors = factor_blocks(blocks)
        t2 = time.perf_counter()
        self.factors = torch.as_tensor(factors, device=device)
        if self.factors.is_cuda:
            torch.cuda.synchronize(self.factors.device)
        self.build_s = dict(extract_s=t1 - t0, factor_s=t2 - t1,
                            transfer_s=time.perf_counter() - t2)
        self.ranks = ranks
        self._by_dtype = {self.factors.dtype: self.factors}

    @property
    def factor_bytes(self) -> int:
        return self.factors.numel() * self.factors.element_size()

    def __call__(self, x: torch.Tensor, k=None) -> torch.Tensor:
        l = self._by_dtype.get(x.dtype)
        if l is None:
            l = self._by_dtype[x.dtype] = self.factors.to(x.dtype)
        return block_trisolve(l, x, ranks=self.ranks)


def build_sequential_preconditioner(a, cfg: PreconditionConfig, a_apply):
    """Preconditioner for the single-device handle (``None`` when inactive).

    a_apply: the handle's (n, t) → (n, t) SpMBV — Chebyshev/inexact applies
    compose it, so they run whatever backend the operator was built with.
    """
    if not cfg.active:
        return None
    n = a.shape[0]
    if cfg.kind == "block_jacobi":
        row_of_slot, _ = slot_layout(n, cfg.block)
        return BlockJacobiApply(a, row_of_slot, cfg.block, 1, a.device)
    if cfg.kind == "chebyshev":
        # λmax power iteration through the CSR SpMV on the device
        lmin, lmax = resolve_bounds(a, cfg)
        cheb = make_chebyshev_apply(a_apply, lmin, lmax, cfg.degree)
        return lambda x, k: cheb(x)
    # inexact
    diag = extract_diagonal(a)
    return make_inexact_apply(a_apply, diag, cfg.omega, cfg.sweeps)


def build_distributed_preconditioner(a, cfg: PreconditionConfig, op, mesh, a_apply):
    """Preconditioner for the distributed handle (``None`` when inactive).

    Block-Jacobi blocks are carved inside each rank's padded slot range
    (identity on padding slots, blocks never straddle ranks), the factors
    of the ranks this process holds (``mesh.ranks``: all p on a virtual
    mesh, its own on a process-group mesh) stacked as (ranks·nb_rank, bs,
    bs) and applied in one launch.  Chebyshev/inexact compose the
    distributed SpMBV (the power iteration's vectors go through
    ``op.shard_vector``/``op.unshard``, global on every process).
    """
    if not cfg.active:
        return None
    if cfg.kind == "chebyshev":
        # the power iteration runs distributed: width-1 SpMBV sub-plan,
        # exchanges only, no reduction on the mesh
        lmin, lmax = resolve_bounds(a, cfg, matvec=distributed_power_matvec(op))
        cheb = make_chebyshev_apply(a_apply, lmin, lmax, cfg.degree)
        return lambda x, k: cheb(x)
    if cfg.kind == "inexact":
        diag = extract_diagonal(a, row_of_slot=op.true_row_of_slot())
        return make_inexact_apply(a_apply, diag, cfg.omega, cfg.sweeps)
    row_of_slot = rank_slot_layout(op.true_row_of_slot(), mesh.local_ranks, cfg.block)
    return BlockJacobiApply(a, row_of_slot, cfg.block, mesh.local_ranks, mesh.device)
