"""Plain torch versions of the batched block-Cholesky solve."""

from __future__ import annotations

import torch


def block_trisolve_ref(l: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Solve ``L[i] L[i]ᵀ y[i] = x[i]`` for every block.

    l: (nb, bs, bs) lower Cholesky factors
    x: (nb, bs, t)  right-hand-side blocks
    returns (nb, bs, t)
    """
    l = l.to(x.dtype)
    y = torch.linalg.solve_triangular(l, x, upper=False)
    return torch.linalg.solve_triangular(l.mT, y, upper=True)


def block_trisolve_dense(l: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Substitution-form version (no LAPACK): forward then backward
    substitution row by row, vectorised over the blocks — the arithmetic
    the CUDA kernel performs."""
    l = l.to(x.dtype)
    bs = l.shape[1]
    y = torch.zeros_like(x)
    for i in range(bs):
        s = (l[:, i, None, :] @ y)[:, 0]
        y[:, i] = (x[:, i] - s) / l[:, i, i, None]
    z = torch.zeros_like(x)
    for i in range(bs - 1, -1, -1):
        s = (l[:, None, :, i] @ z)[:, 0]
        z[:, i] = (y[:, i] - s) / l[:, i, i, None]
    return z
