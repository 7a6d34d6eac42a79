"""Plain torch versions of the factor apply Y·C = M, and of the adaptive
solver's rank-revealing apply and stagnation drop."""

from __future__ import annotations

import torch


def chol_apply_ref(c: torch.Tensor, *mats: torch.Tensor) -> list[torch.Tensor]:
    """[Y with Y·C = M for M in mats] by triangular solves.

    c: (t, t) upper triangular; each M (rows, t).  On CUDA
    ``solve_triangular`` returns a column-major result, so each Y is made
    contiguous: the callers read (rows, t) row-major blocks.
    """
    return [torch.linalg.solve_triangular(c, m, upper=True, left=False).contiguous()
            for m in mats]


def chol_apply_dense(c: torch.Tensor, *mats: torch.Tensor) -> list[torch.Tensor]:
    """Substitution-form version (no LAPACK): per row the forward
    substitution y_j = (m_j − Σ_{i<j} y_i·C_ij) / C_jj, the sum in
    ascending i, vectorised over the rows — the arithmetic the CUDA kernel
    performs, in its order."""
    t = c.shape[0]
    outs = []
    for m in mats:
        y = m.clone()
        for j in range(t):
            acc = m[:, j].clone()
            for i in range(j):
                acc -= y[:, i] * c[i, j]
            y[:, j] = acc / c[j, j]
        outs.append(y)
    return outs


def rank_apply_ref(g: torch.Tensor, *mats: torch.Tensor, rtol: float):
    """The reference's rank-revealing apply (``rank_revealing_apply`` in
    ``src/repro/adaptive/rankrev.py``) in torch: the pivoted factorization
    G[perm][:, perm] = L·Lᵀ (:func:`repro_torch.adaptive.rankrev.pivoted_cholesky`),
    then per block Y with Y·L_solveᵀ = M[:, perm] (the reference's
    L_solve·Yᵀ = M[:, perm]ᵀ, row by row) by ``solve_triangular`` (dead pivots
    set to 1 on the diagonal of L_solve), made contiguous, times the column
    mask of the first ``rank`` columns.  The right-side form: on the card
    cuBLAS takes ~15 s for the left-side solve with (t, 1 310 720)
    right-hand sides, and ~1 ms for this one.

    Returns ``(*outs, rank, perm)``: ``rank`` a 0-dim int32 tensor, ``perm``
    a (t,) int32 tensor.
    """
    from repro_torch.adaptive.rankrev import pivoted_cholesky  # adaptive imports the kernels

    t = g.shape[0]
    l, perm, rank = pivoted_cholesky(g, rtol=rtol)
    active = torch.arange(t, device=g.device) < rank
    l_solve = l + torch.diag(torch.where(active, 0.0, 1.0).to(l.dtype))
    colmask = active.to(l.dtype)[None, :]
    outs = [torch.linalg.solve_triangular(l_solve.mT, m[:, perm], upper=True, left=False).contiguous()
            * colmask for m in mats]
    return (*outs, rank, perm.to(torch.int32))


def rank_apply_dense(g: torch.Tensor, *mats: torch.Tensor, rtol: float):
    """Substitution-form version of :func:`rank_apply_ref` (no LAPACK): per
    row of M[:, perm] the forward substitution y_j = (m_j − Σ_{i<j} L_ji·y_i)
    / L_jj against L_solve, the sum in ascending i, then y_j·(j < rank),
    vectorised over the rows — the arithmetic the CUDA kernel performs, in
    its order."""
    from repro_torch.adaptive.rankrev import pivoted_cholesky

    t = g.shape[0]
    l, perm, rank = pivoted_cholesky(g, rtol=rtol)
    active = torch.arange(t, device=g.device) < rank
    l_solve = l + torch.diag(torch.where(active, 0.0, 1.0).to(l.dtype))
    mask = active.to(l.dtype)
    outs = []
    for m in mats:
        mp = m[:, perm]
        y = torch.empty_like(mp)
        for j in range(t):
            acc = mp[:, j].clone()
            for i in range(j):
                acc -= y[:, i] * l_solve[j, i]
            y[:, j] = acc / l_solve[j, j]
        outs.append(y * mask)
    return (*outs, rank, perm.to(torch.int32))


def drop_mask_ref(c: torch.Tensor, rank: torch.Tensor, rn: float, policy):
    """The stagnation drop on the directions the factorization kept:
    :func:`repro_torch.adaptive.reduce.stagnation_mask` of ``arange(t) <
    rank``.  Returns the column mask in c's dtype and [rank, active count]
    in c's dtype (the values the iteration copies to the host)."""
    from repro_torch.adaptive.reduce import stagnation_mask

    active = stagnation_mask(c, rn, torch.arange(c.shape[0], device=c.device) < rank, policy)
    return active.to(c.dtype), torch.stack([rank.to(c.dtype), active.sum().to(c.dtype)])
