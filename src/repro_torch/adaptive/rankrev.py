"""Breakdown-safe, rank-revealing Gram factorization (pivoted Cholesky).

Port of ``repro/adaptive/rankrev.py``.  ECG A-orthonormalizes the t search
directions through ``G = ZᵀAZ`` every iteration.  When the columns of Z
become (near-)linearly dependent — a right-hand side that is zero on a
subdomain, t larger than the number of independent residual components —
G is singular and the bare Cholesky gives NaNs.  Factorizing G with
diagonal pivoting reveals the numerical rank; the block keeps its (n, t)
shape with the dependent directions zero-masked, so every downstream
product and kernel is unchanged (a zero column contributes zeros).

:func:`pivoted_cholesky` is the plain torch version, op for op in the
reference's order (its ``fori_loop`` becomes a Python loop of t steps on
t×t tensors, with no host copy).  :func:`rank_revealing_apply` runs the
``rank_apply`` kernel op, which factors G and applies the factor to the
blocks in one launch on CUDA tensors.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.chol_apply.ops import rank_apply


def default_rank_rtol(dtype: torch.dtype) -> float:
    """Relative pivot threshold: diagonal entries below ``rtol · max(diag G)``
    are treated as numerically dependent directions.  Scaled well above the
    unit roundoff because G's entries already carry O(n) accumulated rounding
    from the gram product."""
    eps = float(torch.finfo(dtype).eps)
    return eps ** (2.0 / 3.0)  # ~3.6e-11 (f64), ~2.4e-5 (f32)


def _argmax_nan_first(d: torch.Tensor) -> torch.Tensor:
    """``jnp.argmax``'s choice: the first NaN if there is one, else the first
    maximum."""
    isnan = torch.isnan(d)
    return torch.where(
        isnan.any(), torch.argmax(isnan.to(torch.int8)),
        torch.argmax(torch.where(isnan, -torch.inf, d)),
    )


def pivoted_cholesky(g: torch.Tensor, rtol: float | None = None):
    """Diagonally pivoted Cholesky of a PSD t x t matrix.

    Returns ``(l, perm, rank)`` with ``G[perm][:, perm] ≈ L·Lᵀ``, L lower
    triangular, and only the first ``rank`` columns of L nonzero (``perm``
    int64, ``rank`` a 0-dim int32 tensor, both on g's device).  Pivots are
    chosen greedily as the largest remaining diagonal entry, so once a pivot
    falls below ``rtol · max(diag G)`` all later ones do too — the dependent
    directions are exactly the trailing ``t − rank`` columns.  A G holding
    NaN on its diagonal gives a NaN threshold, so every pivot fails: rank 0.
    """
    t = g.shape[0]
    if rtol is None:
        rtol = default_rank_rtol(g.dtype)
    idx = torch.arange(t, device=g.device)
    thresh = rtol * torch.maximum(torch.max(torch.diagonal(g)), g.new_zeros(()))
    a, l, perm = g, torch.zeros_like(g), idx
    rank = torch.zeros((), dtype=torch.int32, device=g.device)
    for k in range(t):
        # pivot: largest remaining diagonal entry (rows/cols >= k)
        d = torch.where(idx >= k, torch.diagonal(a), -torch.inf)
        j = _argmax_nan_first(d)
        sw = torch.where(idx == k, j, torch.where(idx == j, k, idx))  # transposition k <-> j
        a = a[sw][:, sw]
        l = l[sw]
        perm = perm[sw]
        pivot = a[k, k]
        ok = pivot > thresh
        root = torch.sqrt(torch.where(ok, pivot, 1.0))
        col = torch.where(idx > k, a[:, k] / root, 0.0)
        col = torch.where(idx == k, root, col)
        col = torch.where(ok, col, 0.0)  # dependent direction: zero column
        l = torch.where(idx[None, :] == k, col[:, None], l)
        a = a - torch.outer(col, col)  # Schur complement update
        rank = rank + ok.to(torch.int32)
    return l, perm, rank


def rank_revealing_apply(g: torch.Tensor, *mats: torch.Tensor, rtol: float | None = None):
    """Breakdown-safe replacement for ``[M C⁻¹ for M in mats]`` (one or two
    blocks, as every caller passes).

    Returns ``(outs, rank, active)`` where ``outs[i] = mats[i][:, perm]·L⁻ᵀ``
    with the ``t − rank`` dependent columns zeroed, ``rank`` a 0-dim int32
    tensor and ``active`` the (t,)-bool column mask (the first ``rank``
    columns): one ``rank_apply`` call.
    """
    if rtol is None:
        rtol = default_rank_rtol(g.dtype)
    *outs, rank, _perm = rank_apply(g, *mats, rtol=rtol)
    return outs, rank, torch.arange(g.shape[0], device=g.device) < rank
