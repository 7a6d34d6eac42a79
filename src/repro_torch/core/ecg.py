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

Backend switch: ``backend="jnp"`` runs the Gram products and the tail as
plain torch ops; ``backend="pallas"`` routes them through the hand-written
CUDA kernels ``fused_gram`` and ``ecg_tail`` (their plain versions on CPU
tensors).  The SpMBV is owned by the caller via ``a_apply``.  Every solve is
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
    iteration of Algorithm 3; ``run(carry) -> carry`` is the
    breakdown-guarded loop to convergence.
    """

    t: int
    tol: float
    max_iters: int
    init: Callable
    step: Callable
    run: Callable
    method: str = "classic"


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
    backend: str = "jnp",
    method: str = "classic",
) -> ECGRunner:
    """Build the ECG iteration machinery for one fixed configuration.

    ``a_apply`` maps (n, t) block vectors to (n, t) block vectors; the Gram
    products and the tail follow ``backend`` (see the module docstring).
    The reference's hooks for distributed reductions and a custom splitting
    come with the distributed slice (ROADMAP.md queue 1 item 5).
    """
    if backend not in ("jnp", "pallas"):
        raise ValueError(f"unknown backend {backend!r}")
    spec = get_method(method)
    ctx = MethodContext(
        t=t, max_iters=max_iters, a_apply=a_apply, split_fn=split_residual,
        gram1=lambda z, az: z.T @ az,
        gram2=fused_gram if backend == "pallas" else _plain_gram2,
        sqnorm=lambda v: torch.dot(v, v),
        tail=ecg_tail if backend == "pallas" else _plain_tail,
    )
    init, iterate = spec.build(ctx)

    def cond(c):
        return c["rn"] > tol and c["k"] < max_iters

    def run(carry):
        return _guarded_while(cond, iterate, carry)

    return ECGRunner(
        t=t, tol=tol, max_iters=max_iters, init=init, step=iterate, run=run,
        method=spec.name,
    )


def finalize_result(out: dict, *, x0, t: int, tol: float) -> SolveResult:
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
        final_carry=out,
    )
