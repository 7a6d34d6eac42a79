"""Plain torch versions of the packed halo-buffer kernels.

Both take a leading rank axis: every operand is stacked over the p ranks of
a (virtual) mesh, and rank r's indices address rank r's rows only.  The
per-device form of the reference, (m, w) with (c,) indices, is p = 1.
"""

from __future__ import annotations

import torch


def halo_pack_ref(src: torch.Tensor, idx: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """out[r, i] = src[r, idx[r, i]] — src (p, m, w), idx (p, c) -> (p, c, w),
    into ``out`` when it is given."""
    w = src.shape[-1]
    return torch.gather(src, 1, idx.long()[..., None].expand(-1, -1, w), out=out)


def halo_unpack_ref(dst: torch.Tensor, buf: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """dst[r, pos[r, i]] = buf[r, i], in place; returns ``dst``.

    dst (p, m, w), buf (p, c, w), pos (p, c).  Slots not named by ``pos``
    keep their contents.  Several entries may name the trailing dump slot;
    which of them lands there is unspecified (the executor discards it).
    """
    w = dst.shape[-1]
    return dst.scatter_(1, pos.long()[..., None].expand(-1, -1, w), buf)
