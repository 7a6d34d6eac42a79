"""Public op: Block-ELL SpMBV — the CUDA kernel on CUDA tensors, the plain
torch version on CPU tensors.

Besides the kernel wrapper this module carries the conversion that puts
the kernel on the solver's path:

* :func:`csr_arrays_to_block_ell` / :func:`count_block_ell_tiles` convert raw
  CSR arrays into the fixed-``kmax`` Block-ELL layout the kernel consumes.
  The fill is vectorised torch work on the arrays' device (the card's for a
  CSR matrix there, the host's for numpy arrays): only the runs of a row's
  nonzeros in one tile are sorted, never the ~1e8 nonzeros of Example 2.1
  at full scale, and the layout is equal to the reference's.
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


def _as_tensor(x) -> torch.Tensor:
    """A tensor as it is; an array as a host tensor (a read-only array, as
    JAX hands out, copied first)."""
    if isinstance(x, torch.Tensor):
        return x
    x = np.asarray(x)
    return torch.from_numpy(x if x.flags.writeable else x.copy())


def _csr_tensors(indptr, indices):
    """indptr as int64 and indices as int32 or int64 tensors, on the device
    they are on (numpy arrays: the host), without a copy where they are
    already so."""
    indptr = _as_tensor(indptr).long()
    indices = _as_tensor(indices)
    if indices.dtype not in (torch.int32, torch.int64):
        indices = indices.long()
    return indptr, indices


def _tile_runs(indptr: torch.Tensor, indices: torch.Tensor, n_rows: int, br: int, bc: int,
               nbc: int):
    """The runs of the first ``n_rows`` CSR rows: maximal stretches of a
    row's nonzeros in one tile.  Returns the runs' start offsets and their
    tile keys (block row · nbc + block column).  A row's nonzeros in one
    tile form one run where its column ids are sorted, so the keys are a
    few a row, not one a nonzero."""
    nnz = int(indptr[n_rows])
    tcol = indices[:nnz] // bc
    new = torch.empty(nnz, dtype=torch.bool, device=indices.device)
    new[0] = True
    torch.ne(tcol[1:], tcol[:-1], out=new[1:])
    row_start = indptr[:n_rows]
    new[row_start[row_start < nnz]] = True
    starts = torch.nonzero(new).view(-1)
    del new
    brow = torch.searchsorted(indptr[: n_rows + 1], starts, right=True) - 1
    return starts, brow // br * nbc + tcol[starts].long()


def _tile_keys(indptr: torch.Tensor, indices: torch.Tensor, n_rows: int, br: int, bc: int,
               nbc: int) -> torch.Tensor:
    """Sorted distinct tile keys (block row · nbc + block column) of the
    first ``n_rows`` CSR rows."""
    return torch.unique(_tile_runs(indptr, indices, n_rows, br, bc, nbc)[1])


def count_block_ell_tiles(indptr, indices, n_rows: int, n_cols: int, br: int, bc: int) -> int:
    """Max distinct (br x bc) tiles in any block row of a raw-CSR matrix."""
    indptr, indices = _csr_tensors(indptr, indices)
    n_rows = min(n_rows, len(indptr) - 1)
    if int(indptr[n_rows]) == 0:
        return 0
    nbc = (n_cols + bc - 1) // bc
    tiles = _tile_keys(indptr, indices, n_rows, br, bc, nbc)
    return int(torch.bincount(tiles // nbc).max())


def _block_ell_fill(indptr, indices, data, n_rows: int, n_cols: int, br: int, bc: int,
                    nbr: int, kmax: int):
    """:func:`csr_arrays_to_block_ell` on tensors: ``(blocks, ell_idx)`` on
    the device of ``data``."""
    indptr, indices = _csr_tensors(indptr, indices)
    data = _as_tensor(data)
    dev = data.device
    blocks = torch.zeros((nbr, kmax, br, bc), dtype=data.dtype, device=dev)
    ell_idx = torch.zeros((nbr, kmax), dtype=torch.int32, device=dev)
    n_rows = min(n_rows, len(indptr) - 1)
    nnz = int(indptr[n_rows])
    if nnz == 0:
        return blocks, ell_idx
    # A few passes over the ~1e8 nonzeros and no sort or permutation of
    # them: only the runs' tile keys are sorted, and each nonzero takes its
    # tile's slot from its run.
    nbc = (n_cols + bc - 1) // bc
    starts, run_key = _tile_runs(indptr, indices, n_rows, br, bc, nbc)
    uniq, inv = torch.unique(run_key, sorted=True, return_inverse=True)
    del run_key
    bi, bj = uniq // nbc, uniq % nbc
    slot = torch.arange(len(uniq), device=dev) - torch.searchsorted(bi, bi)
    over = torch.nonzero(slot >= kmax).view(-1)
    if len(over):
        raise ValueError(f"block row {int(bi[over[0]])} overflows kmax={kmax}")
    ell_idx[bi, slot] = bj.to(torch.int32)
    # the flat index into ``blocks`` of every nonzero: its run's tile base,
    # then its row and its column inside the tile
    run_base = (bi * kmax + slot)[inv] * (br * bc)
    lin = torch.repeat_interleave(run_base, torch.diff(starts, append=starts.new_tensor([nnz])),
                                  output_size=nnz)
    del run_base, starts
    row_off = torch.arange(n_rows, device=dev) % br * bc
    lin += torch.repeat_interleave(row_off, indptr[1: n_rows + 1] - indptr[:n_rows], output_size=nnz)
    lin += indices[:nnz] % bc
    blocks.view(-1)[lin] = data[:nnz]
    return blocks, ell_idx


def csr_arrays_to_block_ell(
    indptr, indices, data, n_rows: int, n_cols: int, br: int, bc: int,
    nbr: int, kmax: int,
):
    """Raw CSR arrays -> Block-ELL numpy arrays with caller-fixed (nbr, kmax).

    Tiles fill each block row's slots in ascending block-column order;
    unused slots stay zero with block-column id 0 (safe: zero tiles
    contribute nothing).  Returns ``(blocks, ell_idx)``.  The work runs on
    the arrays' device (numpy arrays: the host).
    """
    blocks, ell_idx = _block_ell_fill(indptr, indices, data, n_rows, n_cols, br, bc, nbr, kmax)
    return blocks.cpu().numpy(), ell_idx.cpu().numpy()


def block_ell_meta(a: CSRMatrix, br: int, bc: int) -> dict:
    """Tile analysis of the CSR -> Block-ELL conversion — JSON-serializable.

    ``pad_hist[k]`` counts block rows holding exactly k tiles — the padding
    histogram behind the ``kmax`` waste.  Equal to the reference's meta.
    """
    indptr, indices = _csr_tensors(a.indptr, a.indices)
    n, m = a.shape
    n_pad = (n + br - 1) // br * br
    m_pad = (m + bc - 1) // bc * bc
    nbr, nbc = n_pad // br, m_pad // bc
    if int(indptr[n]) == 0:
        tiles = indptr.new_zeros(0)
    else:
        tiles = _tile_keys(indptr, indices, n, br, bc, nbc)
    per_row = torch.bincount(tiles // nbc, minlength=nbr)
    kmax = int(per_row.max()) if len(tiles) else 0
    return dict(
        br=int(br), bc=int(bc), shape=[int(n), int(m)], nnz=int(a.nnz),
        nbr=int(nbr), nbc=int(nbc), kmax=kmax,
        n_pad=int(n_pad), m_pad=int(m_pad),
        pad_hist=torch.bincount(per_row, minlength=kmax + 1).tolist(),
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
    blocks, indices = _block_ell_fill(
        a.indptr, a.indices, a.data, n, m, br, bc,
        nbr=int(meta["nbr"]), kmax=int(meta["kmax"]),
    )
    return blocks, indices, int(meta["m_pad"]), meta, analyzed


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
