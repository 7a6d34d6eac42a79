"""Plain torch version of the Block-ELL SpMBV kernel."""

from __future__ import annotations

import torch


def bsr_spmbv_ref(blocks: torch.Tensor, indices: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """W = A @ V for Block-ELL A.

    blocks:  (nbr, kmax, br, bc) dense tiles (zero tiles where padded)
    indices: (nbr, kmax) block-column ids (0 where padded — safe: zero tiles)
    v:       (nbc * bc, t)
    returns: (nbr * br, t)
    """
    nbr, kmax, br, bc = blocks.shape
    t = v.shape[1]
    vt = v.reshape(-1, bc, t)                          # (nbc, bc, t)
    gathered = vt[indices.long()]                      # (nbr, kmax, bc, t)
    out = torch.einsum("nkrc,nkct->nrt", blocks, gathered)
    return out.reshape(nbr * br, t)
