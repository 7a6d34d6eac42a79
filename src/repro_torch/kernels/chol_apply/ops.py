"""Public op: Y·C = M for ECG's t×t Cholesky factor — the CUDA kernel on
CUDA tensors, the plain torch version on CPU tensors.

Each iteration of the classic scheme turns its Gram matrix G = CᵀC into the
new directions P = Z·C⁻¹ and AP = AZ·C⁻¹ (``core/methods/base.py``
``_chol_inv_apply``).  The reference leaves the two triangular solves to
XLA; here one row-pass kernel, ``csrc/chol_apply.cu``, writes both blocks in
one launch, row-major, where cuBLAS's solve returns column-major results
that must then be copied.  It takes 1 <= t <= 32: at t <= 2 a vector path
with no staging, above it the staged row pass (:func:`chol_plan`).

The adaptive solver (a ``ReductionPolicy``) and the s-step scheme call two
more kernels of that source instead: :func:`rank_apply`, the pivoted
factorization of G and the apply of its factor in one launch (the
reference's ``rank_revealing_apply``; up to 32 columns, s-step's s·t), and
:func:`drop_mask`, the stagnation drop on the step coefficients (its
``stagnation_mask``).  Neither copies anything to the host: the rank and the
active count stay on the device until the iteration's one copy.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.chol_apply.ref import chol_apply_ref, drop_mask_ref, rank_apply_ref
from repro_torch.kernels.dispatch import use_kernel

#: widest t ``chol_apply`` takes (the row's t values are registers)
MAX_T = 32
#: widest t ``rank_apply`` takes, and the most directions and coefficients
#: ``drop_mask`` scores (one warp)
MAX_RANK_T = 32
#: widest t ``chol_apply`` solves on its vector path (a 16-byte vector holds
#: whole rows)
_VEC_MAX_T = 2
#: threads of a ``chol_apply``/``rank_apply`` CTA (``repro::kThreads``) and
#: the dynamic shared memory a launch gets without opting in
_THREADS, _SMEM_DEFAULT = 256, 48 * 1024
#: shared memory of one SM, and what the runtime keeps of it per CTA
_SMEM_SM, _SMEM_CTA = 233_472, 1024


@dataclasses.dataclass(frozen=True)
class CholPlan:
    """How ``chol_apply`` launches at width t (``launch_t`` in
    ``csrc/chol_apply.cu``): the vector path (t <= 2, 16-byte aligned
    blocks; no shared memory) or the staged path, whose dynamic shared
    memory (``CholSmem``) holds C and each warp's tile of 32 rows of
    ``stride`` values."""

    path: str           # "vector" or "staged"
    stride: int         # staged: values per staged row (odd: no bank conflict); vector: 0
    rows_per_vec: int   # vector: rows in one 16-byte vector; staged: 0
    smem_bytes: int     # dynamic shared memory per CTA
    opt_in: bool        # above the 48 KB default: the launcher opts in
    ctas_by_smem: int   # resident CTAs per SM that shared memory allows


def chol_plan(t: int, dtype, aligned: bool = True) -> CholPlan:
    """The launch geometry of ``chol_apply`` at width ``t`` (the C launcher
    owns the choice; this mirrors it for the tests and reports).  The
    registers may allow fewer CTAs per SM than ``ctas_by_smem``; the
    launcher asks the runtime."""
    if not 1 <= t <= MAX_T:
        raise ValueError(f"chol_apply: kernel takes 1 <= t <= {MAX_T}, got t={t}")
    es = {torch.float32: 4, torch.float64: 8}[dtype]
    blocks = 2048 // _THREADS
    if t <= _VEC_MAX_T and aligned:
        return CholPlan("vector", 0, 16 // es // t, 0, False, blocks)
    stride = t if t % 2 else t + 1
    smem = (t * t + (_THREADS // 32) * 32 * stride) * es
    return CholPlan("staged", stride, 0, smem, smem > _SMEM_DEFAULT,
                    min(blocks, _SMEM_SM // (smem + _SMEM_CTA)))


@dataclasses.dataclass(frozen=True)
class RankPlan:
    """The shared memory ``rank_apply_kernel<T, t>`` launches with
    (``RankSmem`` in ``csrc/chol_apply.cu``): each warp's tile buffer of 32
    rows of ``stride`` values, L in ``t`` rows of ``stride`` values, the
    column mask and the pivot order; the Schur complement of the
    factorization lives in warp 0's buffer."""

    stride: int         # values per staged row (odd: no bank conflict)
    warps: int          # warps per CTA
    smem_bytes: int     # dynamic shared memory per CTA
    opt_in: bool        # above the 48 KB default: the launcher opts in
    ctas_by_smem: int   # resident CTAs per SM that shared memory allows


def rank_plan(t: int, dtype) -> RankPlan:
    """The launch geometry of ``rank_apply`` at width ``t`` (the C launcher
    owns the choice; this mirrors it for the tests and reports).  The
    registers may allow fewer CTAs per SM than ``ctas_by_smem``; the
    launcher asks the runtime."""
    if not 1 <= t <= MAX_RANK_T:
        raise ValueError(f"rank_apply: kernel takes 1 <= t <= {MAX_RANK_T}, got t={t}")
    es = {torch.float32: 4, torch.float64: 8}[dtype]
    stride = t if t % 2 else t + 1
    warps = _THREADS // 32
    smem = (warps * 32 * stride + t * stride + t) * es + 4 * t
    return RankPlan(stride, warps, smem, smem > _SMEM_DEFAULT,
                    min(2048 // _THREADS, _SMEM_SM // (smem + _SMEM_CTA)))


def _check_blocks(name, t, mats):
    if not 1 <= len(mats) <= 2:
        raise ValueError(f"{name}: takes one or two blocks, got {len(mats)}")
    for m in mats:
        if m.dim() != 2 or m.shape != mats[0].shape or m.shape[1] != t:
            raise ValueError(
                f"{name}: blocks must share one (rows, {t}) shape, got "
                f"{[tuple(x.shape) for x in mats]}"
            )


def _check_kernel_operands(name, square, mats, max_t):
    dtype = square.dtype
    if dtype not in (torch.float32, torch.float64) or any(m.dtype != dtype for m in mats):
        raise TypeError(f"{name}: kernel takes float32/float64 operands of one dtype, "
                        f"got {[square.dtype] + [m.dtype for m in mats]}")
    t = square.shape[0]
    if not 1 <= t <= max_t:
        raise ValueError(f"{name}: kernel takes 1 <= t <= {max_t}, got t={t}")
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
    _check_kernel_operands("chol_apply", c, mats, MAX_T)
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

    g: (t, t) Gram matrix, t <= 32 on CUDA tensors; ``rtol`` the relative
    pivot threshold.  Returns
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
    _check_kernel_operands("rank_apply", g, mats, MAX_RANK_T)
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


def drop_mask(c: torch.Tensor, rank: torch.Tensor, rn: float, policy, live: torch.Tensor | None = None):
    """The flexible-ECG stagnation drop (``stagnation_mask``) on the live
    directions: direction i is retired when ‖c_{i,:}‖ ≤ τ·rn, at most
    ``n_live − policy.min_t`` of them, the lowest scores first.

    c: (t, k) step coefficients, a row per direction (rows with unit
    stride; a column slice of the packed Gram payload is fine): k = t for
    the classic and pipelined schemes, s·t for s-step's transposed
    coefficient block; rank: :func:`rank_apply`'s 0-dim int32; rn: the
    residual norm (a host float); live: the (t,) bool live directions (the
    s-step scheme's carried seed mask), or None for the first ``rank``.
    Returns ``(mask, counts)``: the (t,) column mask in c's dtype (1 kept, 0
    retired) and [rank, active count] in c's dtype.  CUDA tensors launch
    ``drop_mask`` in ``csrc/chol_apply.cu``, one warp, for t, k <= 32
    (``launches`` counts those launches); CPU tensors run
    :func:`drop_mask_ref`.
    """
    t, k = c.shape if c.dim() == 2 else (0, 0)
    if c.dim() != 2 or rank.dim() != 0 or (live is not None and tuple(live.shape) != (t,)):
        raise ValueError(f"drop_mask: takes a (t, k) c, a 0-dim rank and a (t,) live mask, got "
                         f"{tuple(c.shape)}, {tuple(rank.shape)} and "
                         f"{None if live is None else tuple(live.shape)}")
    tensors = (c, rank) if live is None else (c, rank, live)
    if not use_kernel("drop_mask", *tensors):
        return drop_mask_ref(c, rank, rn, policy, live)
    if c.dtype not in (torch.float32, torch.float64) or rank.dtype != torch.int32 or (
            live is not None and live.dtype != torch.bool):
        raise TypeError(f"drop_mask: kernel takes a float32/float64 c, an int32 rank and a bool "
                        f"live mask, got {c.dtype}, {rank.dtype} and "
                        f"{None if live is None else live.dtype}")
    if not (1 <= t <= MAX_RANK_T and 1 <= k <= MAX_RANK_T) or c.stride(1) != 1 or (
            live is not None and not live.is_contiguous()):
        raise ValueError(f"drop_mask: kernel takes 1 <= t, k <= {MAX_RANK_T}, rows of unit stride "
                         f"and a contiguous live mask, got {(t, k)}, strides {c.stride()}")
    out = torch.empty(t + 2, dtype=c.dtype, device=c.device)
    _build.launch(
        "drop_mask", c.dtype, c.data_ptr(), c.stride(0), k, rank.data_ptr(),
        None if live is None else live.data_ptr(), float(rn),
        policy.resolved_drop_tol(c.dtype), policy.min_t, t, out.data_ptr(),
        out[t:].data_ptr(), torch.cuda.current_stream(c.device).cuda_stream,
    )
    drop_mask.launches += 1
    return out[:t], out[t:]


drop_mask.launches = 0
