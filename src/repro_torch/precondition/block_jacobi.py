"""Block-Jacobi preconditioner: M = blockdiag(A) with host Cholesky factors.

Port of ``repro/precondition/block_jacobi.py``; every array is equal to the
reference's.  Every block is a principal submatrix of the SPD operator, so
M is SPD and its Cholesky factorization exists unconditionally.
Factorization happens once at build time on the host (numpy, as the
reference); each apply is a batched two-triangle solve ``L Lᵀ y = x`` per
block, served by the :mod:`repro_torch.kernels.block_trisolve` op.

The reference walks every row in Python to extract the blocks; here the
extraction is vectorised over the nonzeros and runs on the CSR's device
(on the card for a CUDA operator), so Example 2.1 at full scale (1 310 720
rows, ~104.5M nonzeros) does not spend seconds of host work a build.

Distributed, the blocks are carved *inside* each rank's padded slot range
— a block never straddles ranks, so the apply is local to every rank.
Padding slots get identity rows, which makes M the identity on the padding
subspace: padded-slot zeros stay zero through every apply.
"""

from __future__ import annotations

import numpy as np
import torch


def extract_blocks(a, row_of_slot: np.ndarray, block: int) -> np.ndarray:
    """Dense diagonal blocks of A in *slot* order.

    row_of_slot: (n_slots,) true-row id per slot, -1 for padding slots.
    Returns (nb, block, block) with ``nb = n_slots // block`` (n_slots must
    already be padded to a multiple of ``block``); slot pairs whose rows
    live in the same block contribute ``A[ri, rj]``, padding slots
    contribute an identity row/column.  The blocks are built on the CSR's
    device (index arithmetic over the nonzeros, no arithmetic on values, so
    they equal a host build exactly) and returned to the host, where they
    are factored.
    """
    n_slots = row_of_slot.shape[0]
    if n_slots % block:
        raise ValueError(f"n_slots={n_slots} not a multiple of block={block}")
    dev = a.device
    nb = n_slots // block
    ros = torch.as_tensor(np.asarray(row_of_slot, np.int64), device=dev)
    out = torch.zeros((nb, block, block), dtype=a.data.dtype, device=dev)
    live = torch.nonzero(ros >= 0).squeeze(1)
    # slot of every true row (-1: the row has no slot)
    slot_of_row = torch.full((a.shape[0],), -1, dtype=torch.int64, device=dev)
    slot_of_row[ros[live]] = live
    # the slots of each nonzero's row and column; it lands in a block when
    # both have slots in the same one
    sr = torch.repeat_interleave(slot_of_row, torch.diff(a.indptr.long()), output_size=a.nnz)
    sc = slot_of_row[a.indices.long()]
    keep = (sr >= 0) & (sc >= 0) & (torch.div(sr, block, rounding_mode="floor")
                                     == torch.div(sc, block, rounding_mode="floor"))
    sr, sc = sr[keep], sc[keep]
    out[sr // block, sr % block, sc % block] = a.data[keep]
    del sr, sc, keep
    pad = torch.nonzero(ros < 0).squeeze(1)  # identity rows keep M SPD and pads inert
    out[pad // block, pad % block, pad % block] = 1.0
    bad = torch.nonzero(torch.diagonal(out, dim1=1, dim2=2).amin(dim=1) <= 0).squeeze(1)
    if bad.numel():
        raise ValueError(
            f"block {int(bad[0])} has a non-positive diagonal entry — the operator "
            "is not SPD (block-Jacobi needs an SPD matrix)"
        )
    return out.cpu().numpy()


def factor_blocks(blocks: np.ndarray) -> np.ndarray:
    """Lower Cholesky factor per block: blocks[i] = L[i] @ L[i].T."""
    return np.linalg.cholesky(blocks)


def slot_layout(n: int, block: int) -> tuple[np.ndarray, int]:
    """Sequential slot layout: rows 0..n-1 then identity padding slots up to
    the next multiple of ``block``.  Returns (row_of_slot, n_slots)."""
    n_slots = -(-n // block) * block
    row_of_slot = np.full(n_slots, -1, dtype=np.int64)
    row_of_slot[:n] = np.arange(n)
    return row_of_slot, n_slots


def rank_slot_layout(true_row_of_slot: np.ndarray, p: int, block: int) -> np.ndarray:
    """Distributed slot layout: each rank's ``rmax`` slots padded (with -1
    identity slots) to a multiple of ``block`` so no block straddles ranks.

    true_row_of_slot: (p * rmax,) from ``DistributedSpMBV.true_row_of_slot``,
    p the ranks the process holds.
    Returns (p * rmax_pad,) row-of-slot in the padded per-rank order.
    """
    rmax = true_row_of_slot.shape[0] // p
    rmax_pad = -(-rmax // block) * block
    out = np.full((p, rmax_pad), -1, dtype=np.int64)
    out[:, :rmax] = np.asarray(true_row_of_slot).reshape(p, rmax)
    return out.reshape(-1)
