"""Iteration-scheme abstraction for the ECG engine.

One ECG configuration = one :class:`MethodSpec` (the *scheme*: which
reductions fire per iteration and what the loop carry holds) bound to one
:class:`MethodContext` (the *plumbing*: the SpMBV operator, the reduction
closures, the splitting).  ``repro_torch.core.ecg.make_ecg_runner`` builds
the context once and delegates the ``init``/``step`` closures to the spec.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.kernels.chol_apply.ops import chol_apply


def _chol_inv_apply(g: torch.Tensor, *mats: torch.Tensor, eps: float = 0.0):
    """Given G = CᵀC, return [M C⁻¹ for M in mats].

    ``eps > 0`` factors G + eps·I instead (the reference's ``chol_eps``
    jitter).  As the reference's ``jnp.linalg.cholesky``: G is symmetrised
    first, and a G that is not positive definite (after the jitter) yields
    NaNs (``cholesky_ex`` reports it in ``info`` instead of raising), which
    the loop's breakdown guard turns into ``breakdown=True``.  Y·C = M is
    solved by the ``chol_apply`` op, two blocks per call: one row-pass
    kernel launch on CUDA tensors, triangular solves on CPU tensors.
    """
    if eps:
        g = g + eps * torch.eye(g.shape[0], dtype=g.dtype, device=g.device)
    low, info = torch.linalg.cholesky_ex((g + g.mT) / 2)
    c = torch.where(info == 0, low.mT, torch.full_like(low, float("nan"))).contiguous()  # G = CᵀC
    return [y for i in range(0, len(mats), 2) for y in chol_apply(c, *mats[i:i + 2])]


def _apply_vec(a_apply: Callable, v: torch.Tensor, t: int) -> torch.Tensor:
    """Apply the SpMBV operator to a single vector as a width-1 block.

    Used once, for the initial residual (Alg 3 line 1): a width-1 SpMV costs
    t× fewer flops and bytes than embedding v in an (n, t) block.
    """
    del t  # kept in the signature for call-site clarity; width is always 1
    return a_apply(v[:, None])[:, 0]


@dataclasses.dataclass(frozen=True)
class MethodContext:
    """Everything a :class:`MethodSpec` needs to build its loop closures.

    ``gram1``/``gram2``/``sqnorm`` are the reductions, ``tail`` the local
    X/R/Z update, ``split_fn`` is T_{r,t}.  ``policy`` is the adaptive
    :class:`~repro_torch.adaptive.ReductionPolicy` (None = fixed width);
    ``a_apply_masked(V, active)`` and ``use_mask`` carry the width-compacted
    exchange of the segmented distributed solver.

    ``precond`` is the preconditioner apply ``M⁻¹ₖ: (V, k) -> (n, t)`` (None
    = unpreconditioned); when set, the scheme orthogonalizes the
    preconditioned directions W = M⁻¹AP through ``gram2p``, the 5-operand
    packed reduction ``[PᵀR | APᵀW | AP_oldᵀW]`` (still one reduction).
    ``precond_reseed`` reseeds the direction chain from the preconditioned
    residual every that-many iterations: the chain ``Z' = W − Pd −
    P_old d_old`` never re-reads the residual, so an iteration-varying M⁻¹ₖ
    needs this flexible restart (Notay, SISC 22(4), 2000).

    ``chol_eps`` is the Cholesky jitter of the classic and pipelined
    schemes (G + eps·I is factored; 0 = none).

    ``s``, ``reorth`` and ``rank_rtol`` parameterize the s-step scheme: its
    inner-step count, its per-block Cholesky-QR2 second pass and the pivot
    threshold of its rank-revealing factorization (None defers to the
    policy's threshold or the dtype default).

    ``groups`` (classic only) is a :class:`~repro_torch.adaptive.GroupSpec`
    describing a *packed* multi-RHS solve: ``t`` becomes the total width
    ``n_groups · t_each``, ``init`` takes (n, n_groups) operands, and each
    group converges against its own tolerance and retires (R and Z slabs
    zeroed) independently.  ``sqnorm_cols`` is the matching per-column
    squared-norm reduction ``(n, g) -> (g,)``; it *replaces* the scalar
    ``sqnorm`` reduction in group mode, so the scheme's reduction count is
    unchanged.
    """

    t: int
    max_iters: int
    a_apply: Callable
    split_fn: Callable
    gram1: Callable
    gram2: Callable
    sqnorm: Callable
    tail: Callable
    precond: Callable | None = None
    gram2p: Callable | None = None
    precond_reseed: int | None = None
    policy: object = None
    use_mask: bool = False
    a_apply_masked: Callable | None = None
    chol_eps: float = 0.0
    s: int = 1
    reorth: bool = False
    rank_rtol: float | None = None
    groups: object = None
    sqnorm_cols: Callable | None = None


class MethodSpec:
    """One iteration scheme: loop closures + collective accounting.

    ``overlaps_gram`` declares that the packed Gram reduction reads nothing
    the iteration's SpMBV writes (the pipelining invariant).
    """

    name: str = "?"
    overlaps_gram: bool = False

    def validate(self, ctx: MethodContext) -> None:
        """Raise ``ValueError`` for context options this scheme cannot run."""
        if ctx.s != 1:
            raise ValueError(
                f"method {self.name!r} has no inner-step count; s={ctx.s} "
                "only applies to method 'sstep'"
            )
        if ctx.reorth:
            raise ValueError(
                "reorth (per-block Cholesky-QR2) only applies to method 'sstep'"
            )

    def build(self, ctx: MethodContext):
        """Return ``(init, step)``: ``init(b, x0) -> carry`` and one raw,
        unguarded ``step(carry) -> carry`` of this scheme."""
        raise NotImplementedError

    def iters_per_block(self, s: int = 1) -> int:
        """SpMBV sweeps amortized by one ``step`` call."""
        return 1

    def psums_per_block(self, s: int = 1, reorth: bool = False) -> int:
        """Allreduce-shaped reductions one ``step`` call issues (the
        convergence-norm reduction is excluded)."""
        return 2

    def psum_payload_floats(self, t: int, s: int = 1, reorth: bool = False) -> int:
        """Total floats those reductions carry (t² + 3t² for the classic shape)."""
        return 4 * t * t

    def collectives_per_iteration(self, s: int = 1, reorth: bool = False) -> float:
        return self.psums_per_block(s, reorth) / self.iters_per_block(s)
