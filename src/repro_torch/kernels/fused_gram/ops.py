"""Public op: fused ECG Gram products — the CUDA kernel on CUDA tensors,
the plain torch version on CPU tensors.

With ``backend="pallas"`` this op is the local compute of the solver's
second reduction, the packed (t, 3t) payload [PᵀR | APᵀAP | AP_oldᵀAP].
On a virtual mesh the operands carry a leading rank axis, (p, rows, t), and
one launch yields the p local payloads, (p, t, 3t), which the mesh sums.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import use_kernel
from repro_torch.kernels.fused_gram.ref import fused_gram_ref

#: largest block width the kernel takes (3·t² outputs on 256 threads)
MAX_T = 16
_PARTS_PER_SM = 8  # pass-1 CTAs per streaming multiprocessor
_MIN_ROWS_PER_PART = 1024


def fused_gram(p, r, ap, ap_old):
    """[PᵀR | APᵀAP | AP_oldᵀAP] for (n, t) operands -> (t, 3t); for
    (ranks, n, t) operands -> (ranks, t, 3t), one payload per rank.

    CUDA tensors launch the two-pass kernel in ``csrc/fused_gram.cu``
    (``launches`` counts those launches); CPU tensors run
    :func:`fused_gram_ref`.
    """
    if use_kernel("fused_gram", p, r, ap, ap_old):
        return _fused_gram_cuda(p, r, ap, ap_old)
    return fused_gram_ref(p, r, ap, ap_old)


fused_gram.launches = 0


def _fused_gram_cuda(p, r, ap, ap_old):
    ops = (p, r, ap, ap_old)
    if p.dim() not in (2, 3) or any(x.shape != p.shape for x in ops):
        raise ValueError(f"fused_gram: operands must share one (n, t) or (ranks, n, t) shape, "
                         f"got {[tuple(x.shape) for x in ops]}")
    dtype = p.dtype
    if dtype not in (torch.float32, torch.float64) or any(x.dtype != dtype for x in ops):
        raise TypeError(f"fused_gram: operands must share float32/float64, got {[x.dtype for x in ops]}")
    if not all(x.is_contiguous() for x in ops):
        raise ValueError("fused_gram: operands must be contiguous")
    ranks = p.shape[0] if p.dim() == 3 else 1
    n, t = p.shape[-2:]
    if not 1 <= t <= MAX_T:
        raise ValueError(f"fused_gram: kernel takes 1 <= t <= {MAX_T}, got t={t}")
    sms = torch.cuda.get_device_properties(p.device).multi_processor_count
    # pass-1 CTAs per rank, so that all ranks together fill the card
    parts = max(1, min(-(-sms * _PARTS_PER_SM // ranks), -(-n // _MIN_ROWS_PER_PART)))
    rows_per_part = -(-n // parts)
    partials = torch.empty((ranks * parts, 3 * t * t), dtype=dtype, device=p.device)
    out = torch.empty(p.shape[:-2] + (t, 3 * t), dtype=dtype, device=p.device)
    _build.launch(
        "fused_gram", dtype, p.data_ptr(), r.data_ptr(), ap.data_ptr(),
        ap_old.data_ptr(), partials.data_ptr(), out.data_ptr(), ranks, n, t, parts,
        rows_per_part, torch.cuda.current_stream(p.device).cuda_stream,
    )
    fused_gram.launches += 1
    return out
