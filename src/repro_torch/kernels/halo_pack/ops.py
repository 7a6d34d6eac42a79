"""Public ops: packed halo-exchange buffers — the CUDA kernels on CUDA
tensors, the plain torch versions on CPU tensors.

``halo_pack`` assembles one contiguous send buffer for a whole exchange
phase; ``halo_unpack`` delivers a received buffer into its halo/stage slots,
in place.  Both take the stacked (p, rows, w) layout of a virtual mesh, so
one launch covers every rank of a phase; a 2-D (rows, w) operand with 1-D
indices is the single-rank form.  See :mod:`repro_torch.core.node_aware`
(phase grouping) and the executor in :mod:`repro_torch.sparse.exchange`.

Index values are not checked here (that would cost a device sync per call):
the executor validates every plan array against its buffer sizes once, when
it is built.  The C launcher in ``csrc/halo_pack.cu`` chooses the kernel's
path (16-byte vectors or single values) and grid; :func:`halo_plan` mirrors
that choice for the tests and for reports.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import use_kernel
from repro_torch.kernels.halo_pack.ref import halo_pack_ref, halo_unpack_ref

# mirrors of csrc/halo_pack.cu's constants
_THREADS = 256        # threads per CTA (repro::kThreads)
_CTAS_PER_SM = 8      # resident 256-thread CTAs per SM: one full wave (kCtasPerSm)
_MAX_UNITS = 1 << 30  # the kernels index units with 32-bit ints (kMaxUnits)


class HaloPlan(NamedTuple):
    """Launch geometry of one ``halo_pack``/``halo_unpack`` call, as the C
    launcher chooses it."""

    path: str   # "vec" (one 16-byte vector per unit) or "scalar" (one value)
    upr: int    # units per row
    units: int  # units over every rank's packed rows, p·c·upr
    grid: int   # CTAs of the 1-D grid (a grid-stride loop covers the rest)


def halo_plan(p: int, c: int, w: int, dtype, aligned: bool, sms: int) -> HaloPlan:
    """Which path a (p, c, w) call takes and its grid, on a card with ``sms``
    multiprocessors.  Rows of a multiple of 16 bytes whose two data pointers
    are 16-byte aligned (``aligned``) take the vector path; everything else
    the scalar path.  Raises where the launcher refuses the call."""
    es = 8 if dtype == torch.float64 else 4
    vec = aligned and (w * es) % 16 == 0
    upr = w * es // 16 if vec else w
    units = p * c * upr
    if units >= _MAX_UNITS:
        raise ValueError(f"halo kernels take fewer than {_MAX_UNITS} units, got {units}")
    grid = max(1, min(-(-units // _THREADS), sms * _CTAS_PER_SM))
    return HaloPlan("vec" if vec else "scalar", upr, units, grid)


def _stream(index: int) -> int:
    """The raw handle of the current stream of device ``index``, read at every
    call (a CUDA graph capture swaps it), without building a Stream object."""
    return torch._C._cuda_getCurrentRawStream(index)


def _ranked(x: torch.Tensor, idx: torch.Tensor):
    """(m, w) + (c,) -> (1, m, w) + (1, c); raises on any other pairing but
    the ranked (p, m, w) + (p, c), which the callers take as it is."""
    if x.dim() == 2 and idx.dim() == 1:
        return x[None], idx[None]
    raise ValueError(
        f"expected (p, m, w) rows with (p, c) indices or (m, w) with (c,), got "
        f"{tuple(x.shape)} and {tuple(idx.shape)}"
    )


def halo_pack(src: torch.Tensor, idx: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """Pack ``src[r, idx[r]]`` for every rank r into one (p, c, w) buffer,
    ``out`` when it is given (a contiguous buffer of ``src``'s dtype).

    CUDA tensors launch ``halo_pack`` in ``csrc/halo_pack.cu`` (counted in
    ``halo_pack.launches``); CPU tensors run :func:`halo_pack_ref`.
    """
    if src.dim() == 3 and idx.dim() == 2:
        return _pack(src, idx, out)
    src3, idx2 = _ranked(src, idx)
    return _pack(src3, idx2, None if out is None else out[None])[0]


halo_pack.launches = 0


def halo_unpack(dst: torch.Tensor, buf: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Scatter a received phase buffer in place: ``dst[r, pos[r]] = buf[r]``.

    Returns ``dst``.  CUDA tensors launch ``halo_unpack`` in
    ``csrc/halo_pack.cu`` (counted in ``halo_unpack.launches``); CPU tensors
    run :func:`halo_unpack_ref`.
    """
    if dst.dim() == 3 and pos.dim() == 2:
        _unpack(dst, buf, pos)
    else:
        dst3, pos2 = _ranked(dst, pos)
        _unpack(dst3, buf[None], pos2)
    return dst


halo_unpack.launches = 0


_F32, _F64, _I32 = torch.float32, torch.float64, torch.int32


def _check(name, rows, idx, buf=None):
    """Raise on what the kernels do not take; returns (p, m, w, c).  The
    operands' dimensions are the caller's to check."""
    dt = rows.dtype
    if (dt is not _F64 and dt is not _F32) or (buf is not None and buf.dtype is not dt):
        got = [dt] + ([] if buf is None else [buf.dtype])
        raise TypeError(f"{name}: rows must be float32/float64 and share one dtype, got {got}")
    if idx.dtype is not _I32:
        raise TypeError(f"{name}: indices must be int32, got {idx.dtype}")
    p, m, w = rows.shape
    p_idx, c = idx.shape
    if p_idx != p:
        raise ValueError(f"{name}: {p_idx} index rows for {p} ranks")
    if buf is not None and buf.shape != (p, c, w):
        raise ValueError(f"{name}: buffer shape {tuple(buf.shape)} != {(p, c, w)}")
    if not (rows.is_contiguous() and idx.is_contiguous() and (buf is None or buf.is_contiguous())):
        raise ValueError(f"{name}: operands must be contiguous")
    return p, m, w, c


def _pack(src, idx, out):
    operands = (src, idx) if out is None else (src, idx, out)
    if not all(x.is_cuda for x in operands):
        use_kernel("halo_pack", *operands)  # raises unless all lie on the CPU
        return halo_pack_ref(src, idx, out=out)
    p, m, w, c = _check("halo_pack", src, idx, out)
    if out is None:
        out = src.new_empty((p, c, w))
    if p * c * w:
        _build.launch("halo_pack", src.dtype, src.data_ptr(), idx.data_ptr(), out.data_ptr(),
                      p, m, c, w, _stream(src.get_device()))
        halo_pack.launches += 1
    return out


def _unpack(dst, buf, pos):
    if not (dst.is_cuda and buf.is_cuda and pos.is_cuda):
        use_kernel("halo_unpack", dst, buf, pos)  # raises unless all lie on the CPU
        halo_unpack_ref(dst, buf, pos)
        return
    p, m, w, c = _check("halo_unpack", dst, pos, buf)
    if p * c * w:
        _build.launch("halo_unpack", dst.dtype, dst.data_ptr(), buf.data_ptr(), pos.data_ptr(),
                      p, m, c, w, _stream(dst.get_device()))
        halo_unpack.launches += 1


__all__ = ["HaloPlan", "halo_pack", "halo_plan", "halo_unpack"]
