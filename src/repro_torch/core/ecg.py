"""Enlarged Conjugate Gradients (paper Algorithms 1–3): the method-agnostic
solve loop.

Communication-efficient Grigori–Tissot form, per iteration:

    AZ   = A * Z                          SpMBV
    G    = ZᵀAZ                           block inner product  (t²)
    CᵀC  = chol(G)                        local Cholesky
    P    = Z C⁻¹ ;  AP = AZ C⁻¹           local TRSMs (AP reuses AZ)
    c    = PᵀR ; d = APᵀAP ; d_old = AP_oldᵀAP
                                          fused block inner products (3t²)
    X   += P c ;  R -= AP c
    Z    = AP − P d − P_old d_old

That is the *classic* scheme, one of three (:mod:`repro_torch.core.methods`):
``pipelined`` makes the packed Gram reduction independent of the SpMBV by
an AZ recurrence, and ``sstep`` amortizes both reductions over s SpMBV
sweeps with a rank-revealing safeguard.  This module runs any
of them.

Backend switch: ``backend="jnp"`` runs the Gram products and the tail as
plain torch ops; ``backend="pallas"`` routes them through the hand-written
CUDA kernels ``fused_gram`` and ``ecg_tail`` (their plain versions on CPU
tensors).  The SpMBV is owned by the caller via ``a_apply``, and the
distributed handle hands in its own reductions through the hooks of
:func:`make_ecg_runner`.  Every solve is
breakdown-guarded: a non-finite iterate freezes the state at the last
finite iteration and sets ``SolveResult.breakdown``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core.cg import SolveResult, _guarded_while
from repro_torch.core.enlarging import split_residual
from repro_torch.core.methods import MethodContext, get_method
from repro_torch.kernels.block_update.ops import ecg_tail
from repro_torch.kernels.fused_gram.ops import fused_gram


@dataclasses.dataclass(frozen=True)
class ECGRunner:
    """The iteration machinery of one ECG configuration.

    ``init(b, x0) -> carry`` builds the initial loop carry (initial residual
    SpMV, splitting, norm); ``step(carry) -> carry`` is one raw, unguarded
    iteration of the scheme (a block of ``s`` for s-step); ``run(carry) ->
    carry`` is the breakdown-guarded loop to convergence.
    """

    t: int
    tol: float
    max_iters: int
    init: Callable
    step: Callable
    run: Callable
    method: str = "classic"
    s: int = 1


def _plain_gram2(p, r, ap, apo):
    return torch.cat([p.T @ r, ap.T @ ap, apo.T @ ap], dim=1)


def _plain_tail(x, r, p, ap, po, c, d, do):
    return x + p @ c, r - ap @ c, ap - p @ d - po @ do


def make_ecg_runner(
    a_apply: Callable[[torch.Tensor], torch.Tensor],
    t: int,
    *,
    tol: float = 1e-8,
    max_iters: int = 1000,
    allreduce: Callable[[torch.Tensor], torch.Tensor] = lambda x: x,
    split: Callable[[torch.Tensor, int], torch.Tensor] | None = None,
    gram1: Callable | None = None,
    gram2: Callable | None = None,
    sqnorm: Callable | None = None,
    tail: Callable | None = None,
    backend: str = "jnp",
    method: str = "classic",
    precond: Callable | None = None,
    gram2p: Callable | None = None,
    precond_reseed: int | None = None,
    policy=None,
    a_apply_masked: Callable | None = None,
    exit_below_width: int | None = None,
    s: int = 1,
    reorth: bool = False,
    rank_rtol: float | None = None,
    groups=None,
    sqnorm_cols: Callable | None = None,
) -> ECGRunner:
    """Build the ECG iteration machinery for one fixed configuration.

    ``a_apply`` maps (n, t) block vectors to (n, t) block vectors; the Gram
    products and the tail follow ``backend`` (see the module docstring).
    The hooks are the reference's: ``allreduce`` wraps the default
    reductions (identity sequentially); ``gram1(z, az)``,
    ``gram2(p, r, ap, ap_old)`` and ``sqnorm(v)`` replace them outright
    (the distributed handle passes per-rank products followed by one
    ``mesh.psum`` each); ``tail`` replaces the X/R/Z update; ``split(r, t)``
    replaces T_{r,t} (default: :func:`split_residual`).

    ``precond`` is the preconditioner apply ``(V, k) -> M⁻¹ₖ V`` (see
    :mod:`repro_torch.precondition`); ``gram2p`` the matching 5-operand
    packed reduction ``[PᵀR | APᵀW | AP_oldᵀW]`` (default: three plain
    products wrapped in ``allreduce``, as the reference: the ``fused_gram``
    kernel's middle term is the symmetric APᵀAP, so it cannot serve);
    ``precond_reseed`` the flexible-restart period of an iteration-varying
    preconditioner.

    ``policy`` is a resolved :class:`~repro_torch.adaptive.ReductionPolicy`
    (None = fixed width): the rank-revealing factorization, stagnation drops
    and optional restart of :mod:`repro_torch.adaptive`.  ``a_apply_masked(V,
    active)`` is the width-compacted SpMBV of the segmented distributed
    solver (used only with a policy); with it, ``exit_below_width`` ends the
    loop once fewer than that many directions are active, so the caller can
    re-slice the exchange at the narrower width and resume from the carry.
    The port has no ``chol_eps`` regularization, which the reference refuses
    together with a policy.

    ``method`` selects the iteration scheme ("classic" | "pipelined" |
    "sstep", see :mod:`repro_torch.core.methods`); ``s``/``reorth``/
    ``rank_rtol`` parameterize the s-step scheme (inner-step count,
    per-block Cholesky-QR2 second pass, pivot threshold of its
    rank-revealing factorization).  Every scheme resumes from a carry
    (``run``), which is how the segmented solve continues at a narrower
    exchange width.

    ``groups`` (a :class:`~repro_torch.adaptive.GroupSpec`, classic only)
    turns the runner into a *packed* multi-RHS solve: ``t`` is the total
    width ``n_groups · t_each``, ``init`` takes (n, n_groups) operands, each
    group converges against its own tolerance and retires independently,
    and the loop runs while any group is live.  ``sqnorm_cols`` is the
    per-column squared-norm reduction ``(n, g) -> (g,)`` that replaces the
    scalar ``sqnorm`` in group mode (``allreduce`` of the local column sums
    by default; one psum of g floats on a mesh).
    """
    if backend not in ("jnp", "pallas"):
        raise ValueError(f"unknown backend {backend!r}")
    if not isinstance(s, int) or s < 1:
        raise ValueError(f"s must be an int >= 1, got {s!r}")
    spec = get_method(method)
    if gram1 is None:
        gram1 = lambda z, az: allreduce(z.T @ az)
    if gram2 is None:
        if backend == "pallas":
            gram2 = lambda p, r, ap, apo: allreduce(fused_gram(p, r, ap, apo))
        else:
            gram2 = lambda p, r, ap, apo: allreduce(_plain_gram2(p, r, ap, apo))
    if gram2p is None:
        gram2p = lambda p, r, ap, apo, w: allreduce(
            torch.cat([p.T @ r, ap.T @ w, apo.T @ w], dim=1)
        )
    if sqnorm is None:
        sqnorm = lambda v: allreduce(torch.dot(v, v))
    if tail is None:
        tail = ecg_tail if backend == "pallas" else _plain_tail
    split_fn = split if split is not None else split_residual
    if groups is not None:
        if spec.name != "classic":
            raise ValueError(
                f"packed group solves require method 'classic', got {spec.name!r}"
            )
        if groups.width != t:
            raise ValueError(
                f"groups describe width {groups.width} "
                f"({groups.n_groups}×{groups.t_each}) but t={t}"
            )
        if policy is None:
            raise ValueError(
                "packed group solves require a rank-revealing policy "
                "(adaptive='rankrev' at minimum): retirement zeroes Z "
                "columns, so the Gram matrix is structurally singular from "
                "the first retirement on, and the direction budget is "
                "enforced through the pivoted factorization's column mask"
            )
        if policy.restart:
            raise ValueError(
                "packed group solves cannot run a restart policy: the "
                "re-enlarge rebuilds the splitting from the summed residual, "
                "which would mix request boundaries"
            )
        if sqnorm_cols is None:
            sqnorm_cols = lambda m: allreduce(torch.sum(m * m, dim=0))
    use_mask = a_apply_masked is not None and policy is not None
    ctx = MethodContext(
        t=t, max_iters=max_iters, a_apply=a_apply, split_fn=split_fn,
        gram1=gram1, gram2=gram2, sqnorm=sqnorm, tail=tail,
        precond=precond, gram2p=gram2p, precond_reseed=precond_reseed,
        policy=policy, use_mask=use_mask, a_apply_masked=a_apply_masked,
        s=s, reorth=reorth, rank_rtol=rank_rtol,
        groups=groups, sqnorm_cols=sqnorm_cols,
    )
    spec.validate(ctx)
    init, iterate = spec.build(ctx)

    def cond(c):
        if groups is None:
            go = c["rn"] > tol and c["k"] < max_iters
        else:
            # packed solve: run while ANY request is live — each group's own
            # tolerance already gated its retirement inside the iteration
            # (a live group's grp_iter is -1, a host array)
            go = bool((c["grp_iter"] < 0).any()) and c["k"] < max_iters
        if exit_below_width is not None and use_mask:
            # width-reduction event: hand control back so the caller can
            # re-slice the exchange plan at the narrower width and resume
            # (the active width is the host trace's last entry)
            go = go and c["ahist"][c["k"]] >= exit_below_width
        return go

    def run(carry):
        return _guarded_while(cond, iterate, carry)

    return ECGRunner(
        t=t, tol=tol, max_iters=max_iters, init=init, step=iterate, run=run,
        method=spec.name, s=s,
    )


def finalize_result(out: dict, *, x0, t: int, tol: float, policy=None) -> SolveResult:
    """Convert a final loop carry into a :class:`SolveResult`."""
    x = x0 + out["X"].sum(dim=1)  # line 14: x = Σᵢ (X)ᵢ
    breakdown = bool(out["bd"])
    return SolveResult(
        x=x,
        n_iters=int(out["k"]),
        res_hist=out["hist"],
        converged=bool(out["rn"] <= tol) and not breakdown,
        breakdown=breakdown,
        t=t,
        active_hist=out["ahist"] if policy is not None else None,
        restarts=int(out["restarts"]) if policy is not None else 0,
        event_hist=out.get("evhist"),
        final_carry=out,
    )


@dataclasses.dataclass(frozen=True)
class ECGOperationCounts:
    """Per-iteration flop/communication counts of Algorithm 3 (used by the
    performance model, eq. 3.3)."""

    n: int
    nnz: int
    p: int
    t: int

    @property
    def spmbv_flops(self) -> float:  # 2·t·nnz/p
        return 2 * self.t * self.nnz / self.p

    @property
    def gram_flops(self) -> float:  # ZᵀAZ: 2·(n/p)·t² … counted as n/p·t² per Alg 3
        return self.n / self.p * self.t**2

    @property
    def fused_gram_flops(self) -> float:  # c,d,d_old: 3 products
        return 3 * self.n / self.p * self.t**2

    @property
    def cholesky_flops(self) -> float:  # (1/6)t³ (+ ~(1/2)t² triangular work)
        return self.t**3 / 6 + self.t**2 / 2

    @property
    def trsm_flops(self) -> float:  # two TRSMs with n/p rhs rows: 2·(n/p)·t²
        return 2 * self.n / self.p * self.t**2

    @property
    def update_flops(self) -> float:  # X += Pc, R -= APc, Z = AP − Pd − P_old d_old
        return (2 + 2) * self.n / self.p * self.t + 4 * self.n / self.p * self.t**2

    @property
    def total_flops(self) -> float:
        """Paper eq. (3.3): γ-weighted flop count per iteration."""
        return (
            (2 + 2 * self.t) * self.nnz / self.p
            + (4 * self.t + 4 * self.t**2) * self.n / self.p
            + self.t**2 / 2
            + self.t**3 / 6
        )

    @property
    def allreduce_payload_floats(self) -> tuple[int, int]:
        """(t², 3t²) — the two fused reductions of §3.1."""
        return (self.t**2, 3 * self.t**2)
