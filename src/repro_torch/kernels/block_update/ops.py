"""Public op: the fused ECG iteration tail — the CUDA kernel on CUDA tensors,
the plain torch version on CPU tensors.

``ecg_tail`` produces X + P·c, R − AP·c and AP − P·d − P_old·d_old in one row
pass, so P and AP stream from device memory once per iteration.  The
two-output ``block_update`` of the reference has no caller on the solver's
path and is not ported yet.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.block_update.ref import ecg_tail_ref
from repro_torch.kernels.dispatch import use_kernel

#: largest block width the kernel takes (c, d, d_old live in shared memory)
MAX_T = 16


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


def _ecg_tail_cuda(x, r, p, ap, p_old, c, d, d_old):
    rows = (x, r, p, ap, p_old)
    if x.dim() != 2 or any(m.shape != x.shape for m in rows):
        raise ValueError(f"ecg_tail: block vectors must share one (n, t) shape, got {[tuple(m.shape) for m in rows]}")
    n, t = x.shape
    if not 1 <= t <= MAX_T:
        raise ValueError(f"ecg_tail: kernel takes 1 <= t <= {MAX_T}, got t={t}")
    # the (t, t) coefficients arrive as column slices of the packed Gram
    # matrix; the kernel wants them dense (a few hundred values at most)
    coeffs = tuple(m.contiguous() for m in (c, d, d_old))
    if any(m.shape != (t, t) for m in coeffs):
        raise ValueError(f"ecg_tail: coefficients must be ({t}, {t}), got {[tuple(m.shape) for m in coeffs]}")
    dtype = x.dtype
    if dtype not in (torch.float32, torch.float64) or any(m.dtype != dtype for m in rows + coeffs):
        raise TypeError(f"ecg_tail: operands must share float32/float64, got {[m.dtype for m in rows + coeffs]}")
    if not all(m.is_contiguous() for m in rows):
        raise ValueError("ecg_tail: block vectors must be contiguous")
    xo, ro, zo = (torch.empty_like(x) for _ in range(3))
    if n == 0:
        return xo, ro, zo
    _build.launch(
        "ecg_tail", dtype, *(m.data_ptr() for m in rows + coeffs),
        xo.data_ptr(), ro.data_ptr(), zo.data_ptr(), n, t,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    ecg_tail.launches += 1
    return xo, ro, zo
