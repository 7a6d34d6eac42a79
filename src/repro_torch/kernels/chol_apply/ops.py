"""Public op: Y·C = M for ECG's t×t Cholesky factor — the CUDA kernel on
CUDA tensors, the plain torch version on CPU tensors.

Each iteration of the classic scheme turns its Gram matrix G = CᵀC into the
new directions P = Z·C⁻¹ and AP = AZ·C⁻¹ (``core/methods/base.py``
``_chol_inv_apply``).  The reference leaves the two triangular solves to
XLA; here one row-pass kernel, ``csrc/chol_apply.cu``, writes both blocks in
one launch, row-major, where cuBLAS's solve returns column-major results
that must then be copied.

The adaptive solver (a ``ReductionPolicy``) calls two more kernels of that
source instead: :func:`rank_apply`, the pivoted factorization of G and the
apply of its factor in one launch (the reference's ``rank_revealing_apply``),
and :func:`drop_mask`, the stagnation drop on the step coefficients (its
``stagnation_mask``).  Neither copies anything to the host: the rank and the
active count stay on the device until the iteration's one copy.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.chol_apply.ref import chol_apply_ref, drop_mask_ref, rank_apply_ref
from repro_torch.kernels.dispatch import use_kernel

#: widest t the kernel takes (the row's t values are registers)
MAX_T = 16


def _check_blocks(name, t, mats):
    if not 1 <= len(mats) <= 2:
        raise ValueError(f"{name}: takes one or two blocks, got {len(mats)}")
    for m in mats:
        if m.dim() != 2 or m.shape != mats[0].shape or m.shape[1] != t:
            raise ValueError(
                f"{name}: blocks must share one (rows, {t}) shape, got "
                f"{[tuple(x.shape) for x in mats]}"
            )


def _check_kernel_operands(name, square, mats):
    dtype = square.dtype
    if dtype not in (torch.float32, torch.float64) or any(m.dtype != dtype for m in mats):
        raise TypeError(f"{name}: kernel takes float32/float64 operands of one dtype, "
                        f"got {[square.dtype] + [m.dtype for m in mats]}")
    t = square.shape[0]
    if not 1 <= t <= MAX_T:
        raise ValueError(f"{name}: kernel takes 1 <= t <= {MAX_T}, got t={t}")
    if not (square.is_contiguous() and all(m.is_contiguous() for m in mats)):
        raise ValueError(f"{name}: operands must be contiguous")


def chol_apply(c: torch.Tensor, *mats: torch.Tensor) -> list[torch.Tensor]:
    """[Y with Y·C = M for M in mats], for one or two (rows, t) blocks.

    c: (t, t) upper triangular factor.  CUDA tensors launch the kernel in
    ``csrc/chol_apply.cu`` once for both blocks (``launches`` counts those
    launches); CPU tensors run :func:`chol_apply_ref`.  A C holding NaNs
    gives NaN blocks on both paths.
    """
    if c.dim() != 2 or c.shape[0] != c.shape[1]:
        raise ValueError(f"chol_apply: the factor must be square, got {tuple(c.shape)}")
    _check_blocks("chol_apply", c.shape[0], mats)
    if use_kernel("chol_apply", c, *mats):
        return _chol_apply_cuda(c, mats)
    return chol_apply_ref(c, *mats)


chol_apply.launches = 0


def _chol_apply_cuda(c, mats):
    _check_kernel_operands("chol_apply", c, mats)
    dtype, t = c.dtype, c.shape[0]
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


def rank_apply(g: torch.Tensor, *mats: torch.Tensor, rtol: float):
    """The rank-revealing apply of one or two (rows, t) blocks: with the
    diagonally pivoted factorization G[perm][:, perm] = L·Lᵀ, each M becomes
    Y with L·Yᵀ = M[:, perm]ᵀ (dead pivots unit-ized), its columns past the
    numerical rank zeroed.

    g: (t, t) Gram matrix; ``rtol`` the relative pivot threshold.  Returns
    ``(*outs, rank, perm)``: ``rank`` a 0-dim int32 tensor and ``perm`` a (t,)
    int32 tensor, both on g's device.  CUDA tensors launch ``rank_apply`` in
    ``csrc/chol_apply.cu`` once for both blocks (``launches`` counts those
    launches); CPU tensors run :func:`rank_apply_ref`.  A G holding NaN gives
    rank 0 and zero blocks on both paths.
    """
    if g.dim() != 2 or g.shape[0] != g.shape[1]:
        raise ValueError(f"rank_apply: G must be square, got {tuple(g.shape)}")
    _check_blocks("rank_apply", g.shape[0], mats)
    if use_kernel("rank_apply", g, *mats):
        return _rank_apply_cuda(g, mats, rtol)
    return rank_apply_ref(g, *mats, rtol=rtol)


rank_apply.launches = 0


def _rank_apply_cuda(g, mats, rtol):
    _check_kernel_operands("rank_apply", g, mats)
    t = g.shape[0]
    outs = [torch.empty_like(m) for m in mats]
    rank = torch.empty((), dtype=torch.int32, device=g.device)
    perm = torch.empty(t, dtype=torch.int32, device=g.device)
    m1, y1 = (mats[1].data_ptr(), outs[1].data_ptr()) if len(mats) == 2 else (None, None)
    _build.launch(
        "rank_apply", g.dtype, g.data_ptr(), mats[0].data_ptr(), outs[0].data_ptr(), m1, y1,
        mats[0].shape[0], t, float(rtol), rank.data_ptr(), perm.data_ptr(),
        torch.cuda.current_stream(g.device).cuda_stream,
    )
    rank_apply.launches += 1
    return (*outs, rank, perm)


def drop_mask(c: torch.Tensor, rank: torch.Tensor, rn: float, policy):
    """The flexible-ECG stagnation drop (``stagnation_mask``) on the first
    ``rank`` directions: direction i is retired when ‖c_{i,:}‖ ≤ τ·rn, at most
    ``n_active − policy.min_t`` of them, the lowest scores first.

    c: (t, t) step coefficients (rows with unit stride; a column slice of the
    packed Gram payload is fine); rank: :func:`rank_apply`'s 0-dim int32;
    rn: the residual norm (a host float).  Returns ``(mask, counts)``: the
    (t,) column mask in c's dtype (1 kept, 0 retired) and [rank, active
    count] in c's dtype.  CUDA tensors launch ``drop_mask`` in
    ``csrc/chol_apply.cu``, one warp (``launches`` counts those launches);
    CPU tensors run :func:`drop_mask_ref`.
    """
    t = c.shape[0]
    if c.dim() != 2 or c.shape[1] != t or rank.dim() != 0:
        raise ValueError(f"drop_mask: takes a (t, t) c and a 0-dim rank, got "
                         f"{tuple(c.shape)} and {tuple(rank.shape)}")
    if not use_kernel("drop_mask", c, rank):
        return drop_mask_ref(c, rank, rn, policy)
    if c.dtype not in (torch.float32, torch.float64) or rank.dtype != torch.int32:
        raise TypeError(f"drop_mask: kernel takes a float32/float64 c and an int32 rank, "
                        f"got {c.dtype} and {rank.dtype}")
    if not 1 <= t <= MAX_T or c.stride(1) != 1:
        raise ValueError(f"drop_mask: kernel takes 1 <= t <= {MAX_T} and rows of unit stride, "
                         f"got t={t}, strides {c.stride()}")
    out = torch.empty(t + 2, dtype=c.dtype, device=c.device)
    _build.launch(
        "drop_mask", c.dtype, c.data_ptr(), c.stride(0), rank.data_ptr(), float(rn),
        policy.resolved_drop_tol(c.dtype), policy.min_t, t, out.data_ptr(),
        out[t:].data_ptr(), torch.cuda.current_stream(c.device).cuda_stream,
    )
    drop_mask.launches += 1
    return out[:t], out[t:]


drop_mask.launches = 0
