"""Public op: Y·C = M for ECG's t×t Cholesky factor — the CUDA kernel on
CUDA tensors, the plain torch version on CPU tensors.

Each iteration of the classic scheme turns its Gram matrix G = CᵀC into the
new directions P = Z·C⁻¹ and AP = AZ·C⁻¹ (``core/methods/base.py``
``_chol_inv_apply``).  The reference leaves the two triangular solves to
XLA; here one row-pass kernel, ``csrc/chol_apply.cu``, writes both blocks in
one launch, row-major, where cuBLAS's solve returns column-major results
that must then be copied.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.chol_apply.ref import chol_apply_ref
from repro_torch.kernels.dispatch import use_kernel

#: widest t the kernel takes (the row's t values are registers)
MAX_T = 16


def chol_apply(c: torch.Tensor, *mats: torch.Tensor) -> list[torch.Tensor]:
    """[Y with Y·C = M for M in mats], for one or two (rows, t) blocks.

    c: (t, t) upper triangular factor.  CUDA tensors launch the kernel in
    ``csrc/chol_apply.cu`` once for both blocks (``launches`` counts those
    launches); CPU tensors run :func:`chol_apply_ref`.  A C holding NaNs
    gives NaN blocks on both paths.
    """
    if not 1 <= len(mats) <= 2:
        raise ValueError(f"chol_apply: takes one or two blocks, got {len(mats)}")
    if c.dim() != 2 or c.shape[0] != c.shape[1]:
        raise ValueError(f"chol_apply: the factor must be square, got {tuple(c.shape)}")
    t = c.shape[0]
    for m in mats:
        if m.dim() != 2 or m.shape != mats[0].shape or m.shape[1] != t:
            raise ValueError(
                f"chol_apply: blocks must share one (rows, {t}) shape, got "
                f"{[tuple(x.shape) for x in mats]}"
            )
    if use_kernel("chol_apply", c, *mats):
        return _chol_apply_cuda(c, mats)
    return chol_apply_ref(c, *mats)


chol_apply.launches = 0


def _chol_apply_cuda(c, mats):
    dtype = c.dtype
    if dtype not in (torch.float32, torch.float64) or any(m.dtype != dtype for m in mats):
        raise TypeError(f"chol_apply: kernel takes float32/float64 operands of one dtype, "
                        f"got {[c.dtype] + [m.dtype for m in mats]}")
    t = c.shape[0]
    if not 1 <= t <= MAX_T:
        raise ValueError(f"chol_apply: kernel takes 1 <= t <= {MAX_T}, got t={t}")
    if not (c.is_contiguous() and all(m.is_contiguous() for m in mats)):
        raise ValueError("chol_apply: operands must be contiguous")
    outs = [torch.empty_like(m) for m in mats]
    if mats[0].shape[0] == 0:
        return outs
    m1, y1 = (mats[1].data_ptr(), outs[1].data_ptr()) if len(mats) == 2 else (None, None)
    _build.launch(
        "chol_apply", dtype, c.data_ptr(), mats[0].data_ptr(), outs[0].data_ptr(), m1, y1,
        mats[0].shape[0], t, torch.cuda.current_stream(c.device).cuda_stream,
    )
    chol_apply.launches += 1
    return outs
