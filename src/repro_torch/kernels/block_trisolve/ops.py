"""Public op: batched block-Cholesky solve — the CUDA kernel on CUDA tensors,
the plain torch version on CPU tensors.

The apply of the block-Jacobi preconditioner: given per-block lower
Cholesky factors of ``blockdiag(A)``, solve every ``L Lᵀ y = x`` in one
launch.  Besides the reference's (nb, bs, t) form the op takes block
vectors in the solver's row layout, so neither the sequential apply (n not
a multiple of bs) nor the distributed one (each rank's rmax rows cut into
blocks of its own) pads or copies x.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.block_trisolve.ref import block_trisolve_ref
from repro_torch.kernels.dispatch import use_kernel

#: largest block and width the kernel takes (a lane owns one row of a
#: block, two at bs > 32, and holds its rows' values of one chunk of up to
#: _CHUNK right-hand sides in registers)
MAX_BS, MAX_T = 64, 32
_CHUNK = 16            # right-hand sides a pass solves above t = 16
_SMEM_SM = 233_472     # shared memory of an SM, 228 KB (kSmemSm) ...
_SMEM_CTA = 1024       # ... of which each CTA holds 1 KB for the system (kSmemCta)
_RECIP = 64            # reciprocals of a warp's diagonals (kRecip)


def _max_warps(rows: int) -> int:
    """Warps (one-warp CTAs) per SM at most (max_warps): 16 where a lane
    owns one row, 8 where it owns two."""
    return 16 if rows == 1 else 8


class TrisolvePlan(NamedTuple):
    """Launch geometry of one ``block_trisolve`` call, as the C launcher
    chooses it."""

    rows: int       # rows a lane owns: 2 at bs > 32, else 1
    seg: int        # lanes per block: bs rounded up to 8, 16 or 32
    per_warp: int   # blocks a warp solves at once, 32 // seg
    cols: int       # right-hand sides a pass solves: t rounded up to 1, 2, 4, 8 or 16 (16 above)
    chunks: int     # passes over the staged tile, cdiv(t, cols): 1 up to t = 16, 2 to t = 32
    ls: int         # elements per staged row of L: a multiple of vec (16 bytes), ls / vec odd
    tp: int         # elements per staged tile: bs·ls, rounded up to seg modulo 32
                    # where a warp takes several blocks (no bank conflict)
    stage: int      # elements of one stage: per_warp tiles
    warp_smem: int  # bytes of a warp's two stages and its _RECIP reciprocals
    warps: int      # warps per SM, each a CTA of its own
    tasks: int      # warp tasks, cdiv(nb, per_warp)
    grid: int       # CTAs, one warp each: at most warps per SM × SMs (a grid stride covers the rest)
    smem: int       # shared memory the grid's CTAs take on one SM, bytes


def _check(bs: int, t: int, dtype) -> None:
    """Raise on what the kernel does not take."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"block_trisolve: kernel takes float32/float64, got {dtype}")
    if not 1 <= bs <= MAX_BS or not 1 <= t <= MAX_T:
        raise ValueError(f"block_trisolve: kernel takes 1 <= bs <= {MAX_BS} and 1 <= t <= {MAX_T}, "
                         f"got bs={bs}, t={t}")


def trisolve_plan(nb: int, bs: int, t: int, dtype, sms: int) -> TrisolvePlan:
    """The geometry ``csrc/block_trisolve.cu`` launches for ``nb`` blocks of
    ``bs`` rows and ``t`` right-hand sides on a card with ``sms``
    multiprocessors (for the tests and for reports; the C launcher owns the
    choice).  Raises where the launcher refuses the call."""
    _check(bs, t, dtype)
    es = 8 if dtype == torch.float64 else 4
    vec = 16 // es
    rows = 2 if bs > 32 else 1
    seg = 8 if bs <= 8 else 16 if bs <= 16 else 32
    per_warp = 32 // seg
    cols = next((c for c in (1, 2, 4, 8) if t <= c), _CHUNK)
    chunks = -(-t // cols)
    ls = vec * (-(-bs // vec) | 1)
    tp = bs * ls + ((seg - bs * ls) % 32 if per_warp > 1 else 0)
    stage = per_warp * tp
    warp_smem = (2 * stage + _RECIP) * es
    warps = max(1, min(_max_warps(rows), _SMEM_SM // (warp_smem + _SMEM_CTA)))
    tasks = -(-nb // per_warp)
    grid = min(sms * warps, tasks)
    return TrisolvePlan(rows, seg, per_warp, cols, chunks, ls, tp, stage, warp_smem, warps, tasks,
                        grid, warps * (warp_smem + _SMEM_CTA))


def block_trisolve(l: torch.Tensor, x: torch.Tensor, ranks: int = 1) -> torch.Tensor:
    """Solve ``L[i] L[i]ᵀ y[i] = x[i]`` for every diagonal block.

    l: (nb, bs, bs) lower Cholesky factors (cast to x's dtype, as the
    reference does).  x is either

    * (nb, bs, t) blocks -> (nb, bs, t), the reference's form; or
    * (ranks·rmax, t) rows -> (ranks·rmax, t): each of the ``ranks``
      consecutive ranges of rmax rows is cut into nb/ranks blocks of bs
      rows; rows past rmax in a rank's last block (nb/ranks·bs > rmax)
      count as zero and are not returned.

    CUDA tensors launch the kernel in ``csrc/block_trisolve.cu``
    (``launches`` counts those launches); CPU tensors run
    :func:`block_trisolve_ref`.
    """
    nb, bs, bs2 = l.shape
    if bs != bs2:
        raise ValueError(f"block_trisolve: factors must be square, got {tuple(l.shape)}")
    blocks_form = x.dim() == 3
    if blocks_form and tuple(x.shape[:2]) != (nb, bs):
        raise ValueError(f"block_trisolve: x {tuple(x.shape)} does not match factors {tuple(l.shape)}")
    rows = x.reshape(nb * bs, x.shape[-1]) if blocks_form else x
    if rows.dim() != 2 or nb % ranks or rows.shape[0] % ranks:
        raise ValueError(
            f"block_trisolve: x {tuple(x.shape)} does not fit {nb} blocks over {ranks} ranks"
        )
    nb_rank, rmax = nb // ranks, rows.shape[0] // ranks
    if rmax > nb_rank * bs:
        raise ValueError(f"block_trisolve: {rmax} rows per rank exceed {nb_rank} blocks of {bs}")
    if l.dtype != x.dtype:
        l = l.to(x.dtype)
    if use_kernel("block_trisolve", l, x):
        y = _block_trisolve_cuda(l, rows, nb_rank, rmax)
    else:
        y = _block_trisolve_rows(l, rows, nb_rank, rmax)
    return y.reshape(x.shape)


block_trisolve.launches = 0


def _block_trisolve_rows(l, rows, nb_rank, rmax):
    """The plain version on the row layout: pad each rank to whole blocks,
    solve, drop the padding rows."""
    nb, bs, _ = l.shape
    ranks, t = nb // nb_rank, rows.shape[1]
    x3 = rows.reshape(ranks, rmax, t)
    if nb_rank * bs != rmax:
        x3 = torch.nn.functional.pad(x3, (0, 0, 0, nb_rank * bs - rmax))
    y = block_trisolve_ref(l, x3.reshape(nb, bs, t))
    return y.reshape(ranks, nb_rank * bs, t)[:, :rmax].reshape(ranks * rmax, t)


def _block_trisolve_cuda(l, rows, nb_rank, rmax):
    nb, bs, _ = l.shape
    t = rows.shape[1]
    dtype = rows.dtype
    _check(bs, t, dtype)
    if not (l.is_contiguous() and rows.is_contiguous()):
        raise ValueError("block_trisolve: operands must be contiguous")
    y = torch.empty_like(rows)
    if nb == 0 or rows.shape[0] == 0:
        return y
    _build.launch(
        "block_trisolve", dtype, l.data_ptr(), rows.data_ptr(), y.data_ptr(),
        nb, bs, t, nb_rank, rmax, torch.cuda.current_stream(rows.device).cuda_stream,
    )
    block_trisolve.launches += 1
    return y
