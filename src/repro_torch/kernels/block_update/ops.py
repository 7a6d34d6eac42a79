"""Public op: the fused ECG iteration tail — the CUDA kernel on CUDA tensors,
the plain torch version on CPU tensors.

``ecg_tail`` produces X + P·c, R − AP·c and AP − P·d − P_old·d_old in one row
pass, so P and AP stream from device memory once per iteration.
``block_update`` is the reference's two-output op (X + P·c, R − AP·c); no
solve path calls it, in the reference or here.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.block_update.ref import block_update_ref, ecg_tail_ref
from repro_torch.kernels.dispatch import use_kernel

#: largest block width the kernel takes (c, d, d_old live in dynamic shared
#: memory: 24.6 KB at t = 32 in float64)
MAX_T = 32
#: the launcher's constants in ``csrc/ecg_tail.cu``: float64 widths from
#: _MMA_MIN_T take the mma kernel (kMmaMinT), the rest one thread an element;
#: the mma kernel's tile rows (kTileRows), tiles in flight a CTA (kStages)
#: and warps a CTA (kMmaWarps)
_MMA_MIN_T, _TILE_ROWS, _STAGES, _MMA_WARPS = 9, 32, 4, 8
#: threads of the element kernel's CTAs (repro::kThreads) and the dynamic
#: shared memory a launch gets without opting in
_THREADS, _SMEM_DEFAULT = 256, 48 * 1024


def tail_ls(t: int) -> int:
    """Values in one staged row of the mma kernel (``tail_ls``): the least
    ls >= 4·cdiv(t, 4) with ls ≡ 4 (mod 8)."""
    return (t + 3) // 8 * 8 + 4


@dataclasses.dataclass(frozen=True)
class TailPlan:
    """How ``ecg_tail`` launches at width t (``launch`` in
    ``csrc/ecg_tail.cu``): the mma kernel (float64 from _MMA_MIN_T columns)
    or one thread an element."""

    path: str          # "mma" or "element"
    t: int
    copy_bytes: int    # mma: bytes one cp.async moves (16 where t is even and every block 16-byte aligned, else 8); else 0
    rows: int          # mma: rows of a staged tile; else 0
    stages: int        # mma: tiles in flight a CTA; else 0
    ls: int            # mma: values a staged row; else 0
    threads: int       # threads a CTA
    smem_bytes: int    # dynamic shared memory a CTA
    opt_in: bool       # above the 48 KB default: the launcher opts in
    sms: int           # the card's multiprocessors

    def grid(self, n: int, per_sm: int) -> int:
        """CTAs of a launch over n >= 1 rows, where the runtime holds
        ``per_sm`` CTAs of the kernel an SM (the launcher asks it: shared
        memory and registers decide).  The mma kernel takes at most one wave
        and walks the rest with a grid stride; the element kernel takes a
        CTA per ``threads`` elements, at most 65535·16."""
        if self.path == "element":
            return min(-(-n * self.t // self.threads), 65535 * 16)
        return min(-(-n // self.rows), self.sms * per_sm)


def tail_plan(t: int, dtype, aligned: bool = True, sms: int = 132) -> TailPlan:
    """The launch geometry of ``ecg_tail`` at width ``t`` (the C launcher
    owns the choice; this mirrors it for the tests and reports).
    ``aligned``: every block's pointer 16-byte aligned."""
    if not 1 <= t <= MAX_T:
        raise ValueError(f"ecg_tail: kernel takes 1 <= t <= {MAX_T}, got t={t}")
    es = {torch.float32: 4, torch.float64: 8}[dtype]
    if dtype == torch.float64 and t >= _MMA_MIN_T:
        ks, nt, ls = -(-t // 4), -(-t // 8), tail_ls(t)
        smem = (3 * ks * nt * 32 + _STAGES * 3 * _TILE_ROWS * ls) * es
        return TailPlan("mma", t, 16 if aligned and t % 2 == 0 else 8, _TILE_ROWS, _STAGES, ls,
                        32 * _MMA_WARPS, smem, smem > _SMEM_DEFAULT, sms)
    return TailPlan("element", t, 0, 0, 0, 0, _THREADS, 3 * t * t * es, False, sms)


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
