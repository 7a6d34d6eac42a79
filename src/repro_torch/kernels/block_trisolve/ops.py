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

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.block_trisolve.ref import block_trisolve_ref
from repro_torch.kernels.dispatch import use_kernel

#: largest block and width the kernel takes (a register array of the block's
#: column per thread; one thread per (block, column))
MAX_BS, MAX_T = 64, 16
# a CTA takes as many blocks as fit 64 threads and 32 KB of staged tiles:
# on the H100 that beat 256 threads / 64 KB at bs = 16, 32 and 64 (small
# CTAs overlap one CTA's staging with another's substitutions; PERF.md)
_MAX_THREADS = 64
_SMEM_BYTES = 32 * 1024


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
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"block_trisolve: kernel takes float32/float64, got {dtype}")
    if not 1 <= bs <= MAX_BS or not 1 <= t <= MAX_T:
        raise ValueError(f"block_trisolve: kernel takes 1 <= bs <= {MAX_BS} and 1 <= t <= {MAX_T}, "
                         f"got bs={bs}, t={t}")
    if not (l.is_contiguous() and rows.is_contiguous()):
        raise ValueError("block_trisolve: operands must be contiguous")
    tile_bytes = (bs * bs + 16 // l.element_size()) * l.element_size()
    blocks_per_cta = max(1, min(_MAX_THREADS // t, _SMEM_BYTES // tile_bytes))
    y = torch.empty_like(rows)
    if nb == 0 or rows.shape[0] == 0:
        return y
    _build.launch(
        "block_trisolve", dtype, l.data_ptr(), rows.data_ptr(), y.data_ptr(),
        nb, bs, t, nb_rank, rmax, blocks_per_cta,
        torch.cuda.current_stream(rows.device).cuda_stream,
    )
    block_trisolve.launches += 1
    return y
