"""Plain torch versions of the factor apply Y·C = M."""

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
