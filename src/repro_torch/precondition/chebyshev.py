"""Chebyshev polynomial preconditioner + build-time eigenvalue bounds.

Port of ``repro/precondition/chebyshev.py``.  ``M⁻¹ = p_d(A)`` with ``p_d``
the degree-``d`` Chebyshev acceleration polynomial on an interval
``[λmin, λmax]`` covering the spectrum, normalized so ``p_d(λ) > 0`` on
``(0, λmax]`` — M stays SPD for any SPD A whose spectrum the interval tops.

Each apply runs the semi-iterative recurrence (Saad, *Iterative Methods*,
Alg. 12.1) from a zero initial guess: ``degree - 1`` operator applications,
i.e. SpMBVs with their halo exchanges only — no reduction.

λmax is estimated once at build time by power iteration through the
operator apply from the reference's deterministic numpy start vector: the
sequential builder runs the CSR SpMV on the operator's device, the
distributed builder the width-1 node-aware SpMBV sub-plan (no reduction;
the Rayleigh quotient and norms reduce on the host after unshard).  λmin
defaults to λmax / eig_ratio.
"""

from __future__ import annotations

import numpy as np
import torch


def estimate_lambda_max(a, iters: int = 25, seed: int = 0, *, matvec=None) -> float:
    """Power-iteration estimate of the largest eigenvalue of SPD ``a``
    (returns the final Rayleigh quotient × 1.05 safety).

    ``matvec`` is the ``(n,) -> (n,)`` operator apply the iteration runs
    through (numpy in, array-like out); the default is the CSR SpMV on
    ``a``'s device."""
    n = a.shape[0]
    if matvec is None:
        from repro_torch.sparse.csr import csr_spmv

        matvec = lambda v: csr_spmv(a, torch.as_tensor(v, device=a.device)).cpu().numpy()
    v = np.random.default_rng(seed).standard_normal(n)
    v /= np.linalg.norm(v)
    lam = 1.0
    for _ in range(iters):
        w = np.asarray(matvec(v), dtype=np.float64)
        lam = float(v @ w)
        nw = np.linalg.norm(w)
        if nw == 0:
            break
        v = w / nw
    return 1.05 * lam


def distributed_power_matvec(op):
    """``(n,) -> (n,)`` matvec through the distributed SpMBV for the λmax
    power iteration: the width-1 sub-plan (``plan.at_width(1)``), so the
    exchange moves one column and no reduction runs on the mesh."""
    step = op.matvec_fn(t_active=1)

    def matvec(v):
        return op.unshard(step(op.shard_vector(np.asarray(v)[:, None])))[:, 0]

    return matvec


def resolve_bounds(a, cfg, *, matvec=None) -> tuple[float, float]:
    """The Chebyshev interval: explicit ``eig_bounds`` or the power-iteration
    estimate with ``λmin = λmax / eig_ratio``."""
    if cfg.eig_bounds is not None:
        return cfg.eig_bounds
    lmax = estimate_lambda_max(a, iters=cfg.power_iters, matvec=matvec)
    return lmax / cfg.eig_ratio, lmax


def make_chebyshev_apply(a_apply, lmin: float, lmax: float, degree: int):
    """Return ``f(V) -> p_d(A) V`` via the Chebyshev semi-iteration.

    ``a_apply`` is the (possibly distributed) block SpMBV; the recurrence is
    columnwise-linear, so zero columns stay zero."""
    theta = (lmax + lmin) / 2.0
    delta = (lmax - lmin) / 2.0
    sigma1 = theta / delta

    def apply(x):
        rho = 1.0 / sigma1
        d = x / theta
        y = d
        for _ in range(degree - 1):
            rho_new = 1.0 / (2.0 * sigma1 - rho)
            d = (rho_new * rho) * d + (2.0 * rho_new / delta) * (x - a_apply(y))
            y = y + d
            rho = rho_new
        return y

    return apply
