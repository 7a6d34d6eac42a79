"""Public op: Block-ELL SpMBV — the CUDA kernel on CUDA tensors, the plain
torch version on CPU tensors.

Besides the kernel wrapper this module carries the host-side (numpy)
conversion that puts the kernel on the solver's path:

* :func:`csr_arrays_to_block_ell` / :func:`count_block_ell_tiles` convert raw
  CSR arrays into the fixed-``kmax`` Block-ELL layout the kernel consumes.
  The per-tile fill is vectorised (one stable sort + fancy assignment), so
  Example 2.1 at full scale converts without a Python loop over its ~1.6M
  tiles; the layout is equal to the reference's.
* :func:`block_ell_meta` / :func:`block_ell_arrays` split the conversion into
  the tile analysis and the fill, so persisted meta skips the analysis.
* :func:`make_block_ell_apply_from_arrays` builds the sequential solver's
  ``(n, t) -> (n, t)`` closure over converted arrays;
  :func:`make_block_ell_apply` converts a CSR matrix
  (:func:`block_ell_from_csr`) and builds it, the one-shot solvers'
  operator; :func:`bsr_to_block_ell` converts a BSR matrix a caller holds.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, NamedTuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bsr_spmbv.ref import bsr_spmbv_ref
from repro_torch.kernels.dispatch import use_kernel

if TYPE_CHECKING:
    from repro_torch.sparse.csr import BSRMatrix, CSRMatrix

#: largest block width the kernel takes
MAX_T = 32
#: tile rows and columns the float64 tensor-core path takes (br = 8·MT,
#: bc = 4·S in ``csrc/bsr_spmbv.cu``)
MMA_BR, MMA_BC = (8, 16), (4, 8, 16)
_MMA_WARPS = 4         # warps per CTA, one block row each (kMmaWarps)
_MMA_CTAS_PER_SM = 4   # the kernel's __launch_bounds__ minimum
_FMA_THREADS = 256     # one output row each (kFmaThreads)
_FMA_CTAS_PER_SM = 8


class SpmbvPlan(NamedTuple):
    """Launch geometry of one ``bsr_spmbv`` call."""

    path: str     # "mma" (f64 tensor cores) or "fma" (register-tiled FMAs)
    grid: int     # CTAs of the persistent grid
    threads: int  # threads per CTA
    rows: int     # work items the grid strides over: block rows (mma, one
                  # warp each) or output rows (fma, one thread each)
    cols: int     # output columns the kernel instance holds: 8·NT, NT =
                  # cdiv(t, 8) column tiles (mma), or 8, 16 or 32 sums (fma)


def spmbv_plan(nbr: int, br: int, bc: int, t: int, n_w: int, dtype, sms: int,
               aligned: bool = True) -> SpmbvPlan:
    """Which kernel path a shape takes and its grid, for a card with ``sms``
    multiprocessors.  float64 tiles of (br, bc) in ``MMA_BR`` x ``MMA_BC``
    whose data is 16-byte aligned take the tensor-core path; everything else
    (float32, other tiles) the FMA path.  Raises on what neither takes."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"bsr_spmbv: kernel takes float32/float64, got {dtype}")
    if not 1 <= t <= MAX_T:
        raise ValueError(f"bsr_spmbv: kernel takes 1 <= t <= {MAX_T}, got t={t}")
    if min(br, bc) < 1:
        raise ValueError(f"bsr_spmbv: empty ({br}, {bc}) tiles")
    if not 0 <= n_w <= nbr * br:
        raise ValueError(f"bsr_spmbv: n_rows={n_w} outside [0, {nbr * br}]")
    if dtype == torch.float64 and br in MMA_BR and bc in MMA_BC and aligned:
        rows = min(nbr, -(-n_w // br))
        grid = min(-(-rows // _MMA_WARPS), sms * _MMA_CTAS_PER_SM)
        return SpmbvPlan("mma", max(grid, 1), 32 * _MMA_WARPS, rows, 8 * -(-t // 8))
    rows = n_w
    grid = min(-(-rows // _FMA_THREADS), sms * _FMA_CTAS_PER_SM)
    return SpmbvPlan("fma", max(grid, 1), _FMA_THREADS, rows, next(c for c in (8, 16, 32) if t <= c))


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def bsr_to_block_ell(b: BSRMatrix, kmax: int | None = None):
    """BSR -> Block-ELL (fixed tiles per block row; zero-padded).

    Each block row's tiles fill its first slots in BSR order; unused slots
    stay zero with block-column id 0.  ``kmax`` defaults to the fullest
    block row.  Returns ``(blocks, indices)``: (nbr, kmax, br, bc) values and
    (nbr, kmax) int32 block-column ids, tensors on ``b``'s device, equal to
    the reference's arrays.
    """
    indptr = _host(b.block_indptr).astype(np.int64)
    src_blocks = _host(b.blocks)
    nbr = len(indptr) - 1
    per_row = np.diff(indptr)
    kmax = int(per_row.max()) if kmax is None else int(kmax)
    if len(per_row) and int(per_row.max()) > kmax:
        raise ValueError(f"block row {int(per_row.argmax())} overflows kmax={kmax}")
    br, bc = src_blocks.shape[1:]
    rows = np.repeat(np.arange(nbr, dtype=np.int64), per_row)
    slot = np.arange(len(rows), dtype=np.int64) - indptr[rows]
    blocks = np.zeros((nbr, kmax, br, bc), dtype=src_blocks.dtype)
    indices = np.zeros((nbr, kmax), dtype=np.int32)
    blocks[rows, slot] = src_blocks
    indices[rows, slot] = _host(b.block_indices)
    dev = b.blocks.device
    return torch.as_tensor(blocks, device=dev), torch.as_tensor(indices, device=dev)


def block_ell_from_csr(a: CSRMatrix, br: int, bc: int):
    """CSR -> Block-ELL with (br, bc) tiles: ``(blocks, indices)``, the
    arrays of :func:`block_ell_arrays` (equal to the reference's CSR -> BSR
    -> Block-ELL), so a one-shot apply and a handle's are the same."""
    return block_ell_arrays(a, br, bc)[:2]


def _tile_keys(indptr: np.ndarray, indices: np.ndarray, n_rows: int, br: int, bc: int,
               nbc: int) -> np.ndarray:
    """Sorted distinct tile keys (block row · nbc + block column) of the
    first ``n_rows`` CSR rows.  A nonzero whose tile equals the previous
    nonzero's in the same row is dropped before the sort: its key is already
    there, so the result is the same, and the sort sees a few entries per
    row instead of every nonzero."""
    nnz = int(indptr[n_rows])
    rows = np.repeat(np.arange(n_rows, dtype=np.int64), np.diff(indptr[: n_rows + 1]))
    tcol = indices[:nnz] // bc
    new = np.ones(nnz, dtype=bool)
    new[1:] = (tcol[1:] != tcol[:-1]) | (rows[1:] != rows[:-1])
    return np.unique((rows[new] // br) * nbc + tcol[new])


def count_block_ell_tiles(indptr, indices, n_rows: int, n_cols: int, br: int, bc: int) -> int:
    """Max distinct (br x bc) tiles in any block row of a raw-CSR matrix."""
    indptr = np.asarray(_host(indptr), dtype=np.int64)
    indices = np.asarray(_host(indices), dtype=np.int64)
    n_rows = min(n_rows, len(indptr) - 1)
    if int(indptr[n_rows]) == 0:
        return 0
    nbc = (n_cols + bc - 1) // bc
    tiles = _tile_keys(indptr, indices, n_rows, br, bc, nbc)
    return int(np.bincount(tiles // nbc).max())


def csr_arrays_to_block_ell(
    indptr, indices, data, n_rows: int, n_cols: int, br: int, bc: int,
    nbr: int, kmax: int,
):
    """Raw CSR arrays -> Block-ELL numpy arrays with caller-fixed (nbr, kmax).

    Tiles fill each block row's slots in ascending block-column order;
    unused slots stay zero with block-column id 0 (safe: zero tiles
    contribute nothing).  Returns ``(blocks, ell_idx)``.
    """
    indptr = _host(indptr).astype(np.int64)
    indices = _host(indices).astype(np.int64)
    data = _host(data)
    blocks = np.zeros((nbr, kmax, br, bc), dtype=data.dtype)
    ell_idx = np.zeros((nbr, kmax), dtype=np.int32)
    nnz = int(indptr[min(n_rows, len(indptr) - 1)])
    if nnz == 0:
        return blocks, ell_idx
    # Few passes over the ~1e8 nonzeros, in place where numpy allows: each
    # pass and each fresh nnz-long temporary costs ~0.1 s at full scale.
    counts = np.diff(indptr[: n_rows + 1])
    r = np.arange(n_rows, dtype=np.int64)
    nbc = (n_cols + bc - 1) // bc
    cols = indices[:nnz]
    key = np.repeat(r // br * nbc, counts)  # tile key: block row · nbc + block column
    key += cols // bc
    order = np.argsort(key, kind="stable")
    key = key[order]
    first = np.empty(nnz, dtype=bool)
    first[0] = True
    np.not_equal(key[1:], key[:-1], out=first[1:])
    uniq = key[first]
    del key
    bi, bj = uniq // nbc, uniq % nbc
    slot = np.arange(len(uniq)) - np.searchsorted(bi, bi, side="left")
    over = np.flatnonzero(slot >= kmax)
    if len(over):
        raise ValueError(f"block row {int(bi[over[0]])} overflows kmax={kmax}")
    ell_idx[bi, slot] = bj
    # the flat index into ``blocks`` of every nonzero, in sorted order: one
    # single-index scatter in place of a four-index one
    tile = np.cumsum(first)
    del first
    tile -= 1
    lin = (bi * kmax + slot)[tile]
    del tile
    lin *= br
    lin += np.repeat(r % br, counts)[order]
    lin *= bc
    lin += (cols % bc)[order]
    blocks.reshape(-1)[lin] = data[:nnz][order]
    return blocks, ell_idx


def block_ell_meta(a: CSRMatrix, br: int, bc: int) -> dict:
    """Tile analysis of the CSR -> Block-ELL conversion — JSON-serializable.

    ``pad_hist[k]`` counts block rows holding exactly k tiles — the padding
    histogram behind the ``kmax`` waste.  Equal to the reference's meta.
    """
    indptr = _host(a.indptr).astype(np.int64)
    indices = _host(a.indices).astype(np.int64)
    n, m = a.shape
    n_pad = (n + br - 1) // br * br
    m_pad = (m + bc - 1) // bc * bc
    nbr, nbc = n_pad // br, m_pad // bc
    tiles = _tile_keys(indptr, indices, n, br, bc, nbc)
    per_row = np.bincount((tiles // nbc).astype(np.int64), minlength=nbr)
    kmax = int(per_row.max()) if len(tiles) else 0
    return dict(
        br=int(br), bc=int(bc), shape=[int(n), int(m)], nnz=int(a.nnz),
        nbr=int(nbr), nbc=int(nbc), kmax=kmax,
        n_pad=int(n_pad), m_pad=int(m_pad),
        pad_hist=np.bincount(per_row, minlength=kmax + 1).tolist(),
    )


def _meta_matches(meta: dict | None, a: CSRMatrix, br: int, bc: int) -> bool:
    if not isinstance(meta, dict):
        return False
    try:
        return (
            int(meta["br"]) == br
            and int(meta["bc"]) == bc
            and [int(s) for s in meta["shape"]] == [int(s) for s in a.shape]
            and int(meta["nnz"]) == a.nnz
            and int(meta["kmax"]) >= 0
        )
    except (KeyError, TypeError, ValueError):
        return False


def block_ell_arrays(a: CSRMatrix, br: int, bc: int, meta: dict | None = None):
    """CSR -> Block-ELL tensors on ``a``'s device, optionally skipping the
    analysis.

    Returns ``(blocks, indices, m_pad, meta, analyzed)``.  With a valid
    ``meta`` (from :func:`block_ell_meta` of the same matrix and tile) the
    analysis is skipped (``analyzed=False``); a stale or missing meta
    triggers a fresh analysis (``analyzed=True``), never an error.
    """
    analyzed = not _meta_matches(meta, a, br, bc)
    if analyzed:
        meta = block_ell_meta(a, br, bc)
    n, m = a.shape
    blocks, indices = csr_arrays_to_block_ell(
        a.indptr, a.indices, a.data, n, m, br, bc,
        nbr=int(meta["nbr"]), kmax=int(meta["kmax"]),
    )
    return (
        torch.as_tensor(blocks, device=a.device),
        torch.as_tensor(indices, device=a.device),
        int(meta["m_pad"]), meta, analyzed,
    )


def make_block_ell_apply_from_arrays(blocks: torch.Tensor, indices: torch.Tensor, n: int):
    """``apply(V: (n, t)) -> (n, t)`` over precomputed Block-ELL tensors.

    V is passed unpadded: the op reads rows past its end as zero and writes
    only the first ``n`` rows.  The tiles are cast once per working dtype
    (a float32 operator solved with a float64 right-hand side runs in
    float64, as the reference promotes).
    """
    by_dtype = {blocks.dtype: blocks}

    def apply(v):
        blk = by_dtype.get(v.dtype)
        if blk is None:
            blk = by_dtype[v.dtype] = blocks.to(v.dtype)
        return bsr_spmbv(blk, indices, v, n_rows=n)

    return apply


def make_block_ell_apply(a: CSRMatrix, block: int | tuple[int, int] = 8,
                         use_pallas: bool | None = None):
    """Build the sequential solver's SpMBV closure over the Block-ELL kernel.

    Converts ``a`` once (CSR -> Block-ELL, on the host) and returns
    ``apply(V: (n, t)) -> (n, t)`` running :func:`bsr_spmbv` on ``a``'s
    device: the kernel on CUDA tensors, the plain version on CPU tensors.
    ``block`` is an int for square tiles or an explicit (br, bc) pair — e.g.
    the ``ell_block`` a :class:`repro_torch.tune.TunedConfig` selected.

    ``use_pallas`` is the reference's dispatch switch; the port's rule is
    the operands' device, so ``None`` and ``True`` both take it.  ``False``
    (the reference's unkernelled oracle) is refused rather than quietly
    served by the plain version: the unkernelled product is the CSR one,
    ``csr_spmbv`` (``backend="jnp"``).
    """
    if use_pallas is False:
        raise ValueError(
            "make_block_ell_apply: use_pallas=False has no counterpart in the port, "
            "whose Block-ELL apply runs the bsr_spmbv kernel on CUDA tensors and its "
            "plain version only on CPU tensors; for the unkernelled product use the "
            "CSR SpMBV (backend='jnp', repro_torch.sparse.csr_spmbv)"
        )
    br, bc = (block, block) if isinstance(block, int) else block
    blocks, indices = block_ell_from_csr(a, br, bc)
    return make_block_ell_apply_from_arrays(blocks, indices, a.shape[0])


def bsr_spmbv(blocks: torch.Tensor, indices: torch.Tensor, v: torch.Tensor,
              n_rows: int | None = None) -> torch.Tensor:
    """W = A @ V for Block-ELL A; returns the first ``n_rows`` rows (default
    all ``nbr·br``).  Rows of V past its end count as zero.

    CUDA tensors launch the kernel in ``csrc/bsr_spmbv.cu`` (``launches``
    counts those launches); CPU tensors run :func:`bsr_spmbv_ref`.
    """
    nbr, kmax, br, bc = blocks.shape
    n_rows = nbr * br if n_rows is None else int(n_rows)
    if use_kernel("bsr_spmbv", blocks, indices, v):
        return _bsr_spmbv_cuda(blocks, indices, v, n_rows)
    nbc = -(-v.shape[0] // bc)
    if indices.numel():
        nbc = max(nbc, int(indices.max()) + 1)
    vp = torch.nn.functional.pad(v, (0, 0, 0, nbc * bc - v.shape[0]))
    return bsr_spmbv_ref(blocks, indices, vp)[:n_rows]


bsr_spmbv.launches = 0


def _bsr_spmbv_cuda(blocks, indices, v, n_rows):
    nbr, kmax, br, bc = blocks.shape
    if v.dim() != 2:
        raise ValueError(f"bsr_spmbv: V must be (rows, t), got {tuple(v.shape)}")
    t = v.shape[1]
    dtype = blocks.dtype
    if v.dtype != dtype:
        raise TypeError(f"bsr_spmbv: blocks and V must share a dtype, got {dtype}/{v.dtype}")
    if indices.dtype != torch.int32:
        raise TypeError(f"bsr_spmbv: indices must be int32, got {indices.dtype}")
    if tuple(indices.shape) != (nbr, kmax):
        raise ValueError(f"bsr_spmbv: indices shape {tuple(indices.shape)} != {(nbr, kmax)}")
    if not (blocks.is_contiguous() and indices.is_contiguous() and v.is_contiguous()):
        raise ValueError("bsr_spmbv: operands must be contiguous")
    sms = torch.cuda.get_device_properties(v.device).multi_processor_count
    plan = spmbv_plan(nbr, br, bc, t, n_rows, dtype, sms, aligned=blocks.data_ptr() % 16 == 0)
    w = torch.empty((n_rows, t), dtype=dtype, device=v.device)
    if n_rows == 0:
        return w
    _build.launch(
        "bsr_spmbv", dtype, blocks.data_ptr(), indices.data_ptr(), v.data_ptr(),
        w.data_ptr(), nbr, kmax, br, bc, t, v.shape[0], n_rows, int(plan.path == "mma"),
        plan.grid, torch.cuda.current_stream(v.device).cuda_stream,
    )
    bsr_spmbv.launches += 1
    return w
