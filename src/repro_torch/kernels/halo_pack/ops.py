"""Public ops: packed halo-exchange buffers — the CUDA kernels on CUDA
tensors, the plain torch versions on CPU tensors.

``halo_pack`` assembles one contiguous send buffer for a whole exchange
phase; ``halo_unpack`` delivers a received buffer into its halo/stage slots,
in place.  Both take the stacked (p, rows, w) layout of a virtual mesh, so
one launch covers every rank of a phase; a 2-D (rows, w) operand with 1-D
indices is the single-rank form.  See :mod:`repro_torch.core.node_aware`
(phase grouping) and the executor in :mod:`repro_torch.sparse.spmbv`.

Index values are not checked here (that would cost a device sync per call):
the executor validates every plan array against its buffer sizes once, when
it is built.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import use_kernel
from repro_torch.kernels.halo_pack.ref import halo_pack_ref, halo_unpack_ref


def _ranked(x: torch.Tensor, idx: torch.Tensor):
    """(m, w) + (c,) -> (1, m, w) + (1, c); 3-D + 2-D pass through."""
    if x.dim() == 2 and idx.dim() == 1:
        return x[None], idx[None], True
    if x.dim() == 3 and idx.dim() == 2:
        return x, idx, False
    raise ValueError(
        f"expected (p, m, w) rows with (p, c) indices or (m, w) with (c,), got "
        f"{tuple(x.shape)} and {tuple(idx.shape)}"
    )


def halo_pack(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Pack ``src[r, idx[r]]`` for every rank r into one (p, c, w) buffer.

    CUDA tensors launch ``halo_pack`` in ``csrc/halo_pack.cu`` (counted in
    ``halo_pack.launches``); CPU tensors run :func:`halo_pack_ref`.
    """
    src3, idx2, flat = _ranked(src, idx)
    if use_kernel("halo_pack", src3, idx2):
        out = _halo_pack_cuda(src3, idx2)
    else:
        out = halo_pack_ref(src3, idx2)
    return out[0] if flat else out


halo_pack.launches = 0


def halo_unpack(dst: torch.Tensor, buf: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Scatter a received phase buffer in place: ``dst[r, pos[r]] = buf[r]``.

    Returns ``dst``.  CUDA tensors launch ``halo_unpack`` in
    ``csrc/halo_pack.cu`` (counted in ``halo_unpack.launches``); CPU tensors
    run :func:`halo_unpack_ref`.
    """
    dst3, pos2, flat = _ranked(dst, pos)
    buf3 = buf[None] if flat else buf
    if use_kernel("halo_unpack", dst3, buf3, pos2):
        _halo_unpack_cuda(dst3, buf3, pos2)
    else:
        halo_unpack_ref(dst3, buf3, pos2)
    return dst


halo_unpack.launches = 0


def _check(name, rows, idx, buf=None):
    """Raise on what the kernels do not take; returns (p, m, w, c)."""
    tensors = (rows, idx) if buf is None else (rows, idx, buf)
    if rows.dtype not in (torch.float32, torch.float64) or (buf is not None and buf.dtype != rows.dtype):
        raise TypeError(f"{name}: rows must be float32/float64 and share one dtype, got "
                        f"{[x.dtype for x in tensors if x is not idx]}")
    if idx.dtype != torch.int32:
        raise TypeError(f"{name}: indices must be int32, got {idx.dtype}")
    p, m, w = rows.shape
    c = idx.shape[1]
    if idx.shape[0] != p:
        raise ValueError(f"{name}: {idx.shape[0]} index rows for {p} ranks")
    if buf is not None and tuple(buf.shape) != (p, c, w):
        raise ValueError(f"{name}: buffer shape {tuple(buf.shape)} != {(p, c, w)}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError(f"{name}: operands must be contiguous")
    return p, m, w, c


def _halo_pack_cuda(src, idx):
    p, m, w, c = _check("halo_pack", src, idx)
    out = torch.empty((p, c, w), dtype=src.dtype, device=src.device)
    if out.numel() == 0:
        return out
    _build.launch(
        "halo_pack", src.dtype, src.data_ptr(), idx.data_ptr(), out.data_ptr(),
        p, m, c, w, torch.cuda.current_stream(src.device).cuda_stream,
    )
    halo_pack.launches += 1
    return out


def _halo_unpack_cuda(dst, buf, pos):
    p, m, w, c = _check("halo_unpack", dst, pos, buf)
    if buf.numel() == 0:
        return
    _build.launch(
        "halo_unpack", dst.dtype, dst.data_ptr(), buf.data_ptr(), pos.data_ptr(),
        p, m, c, w, torch.cuda.current_stream(dst.device).cuda_stream,
    )
    halo_unpack.launches += 1
