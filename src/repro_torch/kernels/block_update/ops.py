"""Public op: the fused ECG iteration tail — the CUDA kernel on CUDA tensors,
the plain torch version on CPU tensors.

``ecg_tail`` produces X + P·c, R − AP·c and AP − P·d − P_old·d_old in one row
pass, so P and AP stream from device memory once per iteration.
``block_update`` is the reference's two-output op (X + P·c, R − AP·c); no
solve path calls it, in the reference or here.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.block_update.ref import block_update_ref, ecg_tail_ref
from repro_torch.kernels.dispatch import use_kernel

#: largest block width the kernel takes (c, d, d_old live in dynamic shared
#: memory: 24.6 KB at t = 32 in float64)
MAX_T = 32


def ecg_tail(x, r, p, ap, p_old, c, d, d_old):
    """Fused tail of one ECG iteration; see :func:`ecg_tail_ref` for the math.

    CUDA tensors launch the kernel in ``csrc/ecg_tail.cu`` (``launches``
    counts those launches), which writes three new tensors and leaves every
    input untouched; CPU tensors run :func:`ecg_tail_ref`.
    """
    if use_kernel("ecg_tail", x, r, p, ap, p_old, c, d, d_old):
        return _ecg_tail_cuda(x, r, p, ap, p_old, c, d, d_old)
    return ecg_tail_ref(x, r, p, ap, p_old, c, d, d_old)


ecg_tail.launches = 0


def block_update(x, r, p, ap, c):
    """X + P·c and R − AP·c in one row pass; see :func:`block_update_ref`.

    CUDA tensors launch the kernel in ``csrc/ecg_tail.cu`` (``launches``
    counts those launches), which writes two new tensors; CPU tensors run
    :func:`block_update_ref`.
    """
    if use_kernel("block_update", x, r, p, ap, c):
        return _row_kernel(block_update, (x, r, p, ap), (c,), 2)
    return block_update_ref(x, r, p, ap, c)


block_update.launches = 0


def _ecg_tail_cuda(x, r, p, ap, p_old, c, d, d_old):
    return _row_kernel(ecg_tail, (x, r, p, ap, p_old), (c, d, d_old), 3)


def _row_kernel(op, rows, coeffs, n_out):
    """Check and launch the kernel of ``op``, one of the row-pass kernels of
    ``csrc/ecg_tail.cu``: ``rows`` are (n, t) blocks, ``coeffs`` (t, t)
    matrices; returns ``n_out`` new (n, t) tensors."""
    name = op.__name__
    x = rows[0]
    if x.dim() != 2 or any(m.shape != x.shape for m in rows):
        raise ValueError(f"{name}: block vectors must share one (n, t) shape, got {[tuple(m.shape) for m in rows]}")
    n, t = x.shape
    if not 1 <= t <= MAX_T:
        raise ValueError(f"{name}: kernel takes 1 <= t <= {MAX_T}, got t={t}")
    # the (t, t) coefficients arrive as column slices of the packed Gram
    # matrix; the kernel wants them dense (a few hundred values at most)
    coeffs = tuple(m.contiguous() for m in coeffs)
    if any(m.shape != (t, t) for m in coeffs):
        raise ValueError(f"{name}: coefficients must be ({t}, {t}), got {[tuple(m.shape) for m in coeffs]}")
    dtype = x.dtype
    if dtype not in (torch.float32, torch.float64) or any(m.dtype != dtype for m in rows + coeffs):
        raise TypeError(f"{name}: operands must share float32/float64, got {[m.dtype for m in rows + coeffs]}")
    if not all(m.is_contiguous() for m in rows):
        raise ValueError(f"{name}: block vectors must be contiguous")
    outs = tuple(torch.empty_like(x) for _ in range(n_out))
    if n == 0:
        return outs
    _build.launch(
        name, dtype, *(m.data_ptr() for m in rows + coeffs),
        *(o.data_ptr() for o in outs), n, t,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    op.launches += 1
    return outs
