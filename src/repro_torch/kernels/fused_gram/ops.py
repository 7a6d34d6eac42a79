"""Public op: fused ECG Gram products — the CUDA kernel on CUDA tensors,
the plain torch version on CPU tensors.

With ``backend="pallas"`` this op is the local compute of the solver's
second reduction, the packed (t, 3t) payload [PᵀR | APᵀAP | AP_oldᵀAP].
On a virtual mesh the operands carry a leading rank axis, (p, rows, t), and
one launch yields the p local payloads, (p, t, 3t), which the mesh sums.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import use_kernel
from repro_torch.kernels.fused_gram.ref import fused_gram_ref

#: largest block width the kernel takes
MAX_T = 32
_CTAS_PER_SM = 4     # pass-1 CTAs per streaming multiprocessor, all ranks together
_MMA_THREADS = 128   # csrc/fused_gram.cu kMmaWarps = 4
_FMA_THREADS = 256   # kFmaThreads
_FMA_ROWS = 4        # rows a thread group loads per step (kRows)


class GramPlan(NamedTuple):
    """Launch geometry of one ``fused_gram`` call."""

    path: str           # pass 1: "mma" (float64 tensor cores) or "fma" (float32)
    threads: int        # pass-1 threads per CTA
    parts: int          # pass-1 CTAs per rank, each one partial per output
    rows_per_part: int  # rows each pass-1 CTA owns (the last part may own fewer)
    partials: int       # float64 scratch values: ranks·3t²·parts


def rows_per_step(t: int, path: str) -> int:
    """Rows one pass-1 CTA covers in one round of its loop."""
    if path == "mma":
        mt = -(-t // 8)  # MT x MT tiles of 8 a side per product (fused_gram_mma<MT>)
        return 4 * 4 * (8 // mt if mt < 4 else 1)  # 4 warps x U four-row steps
    ta = -(-t // 4)
    return _FMA_ROWS * (_FMA_THREADS // (3 * ta * ta))  # kRows x thread groups


def gram_plan(ranks: int, n: int, t: int, dtype, sms: int) -> GramPlan:
    """Pass-1 geometry and the scratch for ``ranks`` stacked (n, t) operands
    on a card with ``sms`` multiprocessors: about ``_CTAS_PER_SM`` pass-1 CTAs
    per multiprocessor, each owning whole rounds of rows and none empty
    (pass 2 runs one warp per output).  Raises on what the kernel does not
    take."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"fused_gram: kernel takes float32/float64, got {dtype}")
    if not 1 <= t <= MAX_T:
        raise ValueError(f"fused_gram: kernel takes 1 <= t <= {MAX_T}, got t={t}")
    if ranks < 1 or n < 0:
        raise ValueError(f"fused_gram: bad shape ranks={ranks}, n={n}")
    path = "mma" if dtype == torch.float64 else "fma"
    step = rows_per_step(t, path)
    per_rank = -(-sms * _CTAS_PER_SM // ranks)
    rows_per_part = max(1, -(-n // (per_rank * step))) * step
    parts = max(1, -(-n // rows_per_part))
    return GramPlan(path, _MMA_THREADS if path == "mma" else _FMA_THREADS, parts,
                    rows_per_part, ranks * 3 * t * t * parts)


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
    if any(x.dtype != dtype for x in ops):
        raise TypeError(f"fused_gram: operands must share a dtype, got {[x.dtype for x in ops]}")
    if not all(x.is_contiguous() for x in ops):
        raise ValueError("fused_gram: operands must be contiguous")
    ranks = p.shape[0] if p.dim() == 3 else 1
    n, t = p.shape[-2:]
    sms = torch.cuda.get_device_properties(p.device).multi_processor_count
    plan = gram_plan(ranks, n, t, dtype, sms)
    partials = torch.empty(plan.partials, dtype=torch.float64, device=p.device)
    out = torch.empty(p.shape[:-2] + (t, 3 * t), dtype=dtype, device=p.device)
    _build.launch(
        "fused_gram", dtype, p.data_ptr(), r.data_ptr(), ap.data_ptr(),
        ap_old.data_ptr(), partials.data_ptr(), out.data_ptr(), ranks, n, t, plan.parts,
        plan.rows_per_part, torch.cuda.current_stream(p.device).cuda_stream,
    )
    fused_gram.launches += 1
    return out
