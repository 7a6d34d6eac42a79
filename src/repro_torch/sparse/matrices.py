"""Sparse test-matrix generators.

Port of ``repro/sparse/matrices.py``; every generator's CSR arrays are equal
to the reference's.  The grid Laplacians and the Kronecker block expansion
are vectorised: ``dg_laplace_2d((320, 256), block=16)`` (Example 2.1 at full
scale: 1 310 720 rows, ~104.5M nonzeros) is built in seconds instead of the
reference's per-row Python loops.  Arrays are built on the host with numpy
and handed to ``device`` once.

The SuiteSparse matrices of the paper's Table 3 are generated as
*structural surrogates* (:func:`suite_surrogate`, :func:`surrogate_graph`)
matched to the published rows and nonzeros per row.  Their id shuffle is
seeded with ``hash(name) % 2**31``, as the reference's: Python randomises
``str`` hashes per process (unless ``PYTHONHASHSEED`` is set), so these
operators differ from one process to the next, and they equal the
reference's only when both are built in the same process.  The seed is
copied as it is so that the arrays stay equal to the reference's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.sparse.csr import CSRMatrix


def _kron_block_csr(
    indptr: np.ndarray,
    indices: np.ndarray,
    data: np.ndarray,
    n: int,
    block: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """CSR(L) ⊗ dense SPD block -> CSR arrays.  Kronecker of SPD x SPD is SPD.

    Block row i of the result holds, for each of the b sub-rows r, the b
    entries of every nonzero (i, j) of L in order:
    columns j·b + 0..b-1 with values L_ij · block[r, :].
    """
    b = block.shape[0]
    indptr = np.asarray(indptr, np.int64)
    counts = np.diff(indptr)
    new_indptr = np.zeros(n * b + 1, dtype=np.int64)
    new_indptr[1:] = np.cumsum(np.repeat(counts, b) * b)

    nnz = len(indices)
    new_indices = np.empty(nnz * b * b, dtype=np.int32)
    new_data = np.empty(nnz * b * b, dtype=block.dtype)
    rows = np.repeat(np.arange(n, dtype=np.int64), counts)
    col_offsets = np.arange(b, dtype=np.int32)
    blk_cols = (indices[:, None] * b + col_offsets[None, :]).astype(np.int32)  # (nnz, b)
    # position of nonzero q's first entry in sub-row 0 of its block row
    pos0 = b * b * indptr[rows] + (np.arange(nnz, dtype=np.int64) - indptr[rows]) * b
    step = b * counts[rows]  # distance between consecutive sub-rows
    for r in range(b):
        pos = (pos0 + r * step)[:, None] + col_offsets[None, :]
        new_indices[pos] = blk_cols
        new_data[pos] = data[:, None] * block[r][None, :]
    return new_indptr, new_indices, new_data


def _grid_laplacian_2d(nx: int, ny: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """5-point Laplacian (Dirichlet) on an nx x ny grid, scalar CSR arrays."""
    return _grid_laplacian((nx, ny), 4.0)


def _grid_laplacian_3d(nx: int, ny: int, nz: int):
    return _grid_laplacian((nx, ny, nz), 6.0)


def _grid_laplacian(dims: tuple[int, ...], diag: float, weights=None):
    """(2·d+1)-point Laplacian on a row-major grid: ``diag`` on the diagonal,
    −weights[axis] (default 1) to each in-grid neighbour along that axis."""
    weights = weights or (1.0,) * len(dims)
    n = int(np.prod(dims))
    idx = np.arange(n).reshape(dims)
    rows, cols, vals = [idx.ravel()], [idx.ravel()], [np.full(n, diag)]
    for axis in range(len(dims)):
        for shift in (-1, 1):
            lo = [slice(None)] * len(dims)
            hi = [slice(None)] * len(dims)
            if shift < 0:
                lo[axis], hi[axis] = slice(1, None), slice(None, -1)
            else:
                lo[axis], hi[axis] = slice(None, -1), slice(1, None)
            r = idx[tuple(lo)].ravel()
            rows.append(r)
            cols.append(idx[tuple(hi)].ravel())
            vals.append(np.full(len(r), -weights[axis]))
    return _coo_to_csr(
        np.concatenate(rows), np.concatenate(cols), np.concatenate(vals), n
    )


def _coo_to_csr(rows, cols, vals, n):
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr[1:], rows, 1)
    indptr = np.cumsum(indptr)
    return indptr, cols.astype(np.int32), vals.astype(np.float64)


def _permute_graph(indptr, cols, vals, n, perm):
    """Symmetric permutation  A -> P A Pᵀ  of a scalar CSR graph."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(n)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    return _coo_to_csr(inv[rows], inv[cols], vals, n)


def window_shuffle_perm(n: int, window: int, seed: int = 0) -> np.ndarray:
    """Permutation shuffling ids within windows — emulates the 'natural'
    (non-graph-partitioned) ordering of unstructured FE meshes, which scatters
    geometric neighbours across nearby index ranges.  Used for the SuiteSparse
    surrogates so comm graphs show the paper's message heterogeneity."""
    rng = np.random.default_rng(seed)
    perm = np.arange(n)
    for s in range(0, n, window):
        e = min(s + window, n)
        perm[s:e] = rng.permutation(perm[s:e])
    return perm


def _spd_block(b: int, seed: int = 7) -> np.ndarray:
    """Deterministic dense SPD b x b block with unit diagonal scale."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, b))
    m = q @ q.T / b + np.eye(b)
    return (m / np.linalg.norm(m, 2)).astype(np.float64) * 2.0


def _csr(indptr, cols, vals, n, dtype, device) -> CSRMatrix:
    vals = torch.as_tensor(vals).to(dtype)
    return CSRMatrix.from_numpy(indptr, cols, vals.numpy(), (n, n), device=device)


def fd_laplace_2d(nx: int, ny: int | None = None, dtype=torch.float64,
                  device="cuda") -> CSRMatrix:
    """5-point finite-difference Laplacian, Dirichlet BCs (SPD)."""
    ny = ny or nx
    indptr, cols, vals = _grid_laplacian_2d(nx, ny)
    return _csr(indptr, cols, vals, nx * ny, dtype, device)


def fd_laplace_3d(nx: int, ny: int | None = None, nz: int | None = None,
                  dtype=torch.float64, device="cuda") -> CSRMatrix:
    ny, nz = ny or nx, nz or nx
    indptr, cols, vals = _grid_laplacian_3d(nx, ny, nz)
    return _csr(indptr, cols, vals, nx * ny * nz, dtype, device)


def dg_laplace_2d(
    elements: tuple[int, int] = (32, 32),
    block: int = 16,
    dtype=torch.float64,
    device="cuda",
) -> CSRMatrix:
    """DG-structured Laplacian: dense ``block``-sized element blocks on the
    5-point element stencil (Example 2.1 surrogate).  SPD by construction
    (Kronecker of SPD factors)."""
    nx, ny = elements
    indptr, cols, vals = _grid_laplacian_2d(nx, ny)
    indptr, cols, vals = _kron_block_csr(indptr, cols, vals, nx * ny, _spd_block(block))
    return _csr(indptr, cols, vals, nx * ny * block, dtype, device)


def aniso_laplace_2d(nx: int, ny: int | None = None, eps: float = 0.01,
                     dtype=torch.float64, device="cuda") -> CSRMatrix:
    """Anisotropic 5-point Laplacian: −u_xx − eps·u_yy (Dirichlet, SPD).

    ``eps`` ≪ 1 stretches the spectrum (κ grows like κ(isotropic)/eps): the
    ill-conditioned operator on which a preconditioner pays for itself.
    """
    if not 0 < eps <= 1:
        raise ValueError(f"eps must be in (0, 1], got {eps!r}")
    ny = ny or nx
    indptr, cols, vals = _grid_laplacian((nx, ny), 2.0 + 2.0 * eps, weights=(1.0, eps))
    return _csr(indptr, cols, vals, nx * ny, dtype, device)


def scaled_laplace_2d(nx: int, ny: int | None = None, decades: float = 4.0, seed: int = 0,
                      dtype=torch.float64, device="cuda") -> CSRMatrix:
    """Diagonally-scaled 5-point Laplacian: D^{1/2} L D^{1/2} with D drawn
    log-uniformly over ``decades`` orders of magnitude (SPD by congruence):
    the regime where (block-)Jacobi captures exactly the scaling that
    inflates κ."""
    if decades <= 0:
        raise ValueError(f"decades must be > 0, got {decades!r}")
    ny = ny or nx
    n = nx * ny
    indptr, cols, vals = _grid_laplacian_2d(nx, ny)
    rng = np.random.default_rng(seed)
    d_half = np.power(10.0, rng.uniform(-decades / 2, decades / 2, size=n))
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    vals = vals * d_half[rows] * d_half[cols]
    return _csr(indptr, cols, vals, n, dtype, device)


def random_spd(n: int, density: float = 0.05, seed: int = 0, dtype=torch.float64,
               device="cuda") -> CSRMatrix:
    """Random sparse SPD: symmetrised random mask, diagonally dominant."""
    rng = np.random.default_rng(seed)
    mask = rng.random((n, n)) < density
    mask = mask | mask.T
    np.fill_diagonal(mask, True)
    vals = rng.standard_normal((n, n)) * mask
    vals = (vals + vals.T) / 2
    # diagonal dominance => SPD
    np.fill_diagonal(vals, np.abs(vals).sum(axis=1) + 1.0)
    rows, cols = np.nonzero(vals)
    indptr, cols_s, vals_s = _coo_to_csr(rows, cols, vals[rows, cols], n)
    return _csr(indptr, cols_s, vals_s, n, dtype, device)


#: Example 2.1 of the paper: 1 310 720 rows, ~104.5M nnz at full scale.
EXAMPLE_2_1 = dict(elements=(320, 256), block=16)


@dataclasses.dataclass(frozen=True)
class SuiteSpec:
    """Published stats (paper Table 3) + surrogate generator parameters."""

    rows: int
    nnz: int
    nnz_per_row: float
    # surrogate params: block size + element grid (2D) or grid (3D stencil)
    block: int
    grid: tuple[int, ...]
    # id-shuffle window (elements) emulating the unstructured natural ordering;
    # 0 = keep the structured ordering
    window: int = 2048


# Table 3 of the paper.  Surrogate: dense `block` blocks on a 5-pt (2D) or
# 7-pt (3D, thermal2) stencil, grid sized so rows and nnz/row approximate the
# published values (rows_surrogate = block * prod(grid)).
SUITE_MATRICES: dict[str, SuiteSpec] = {
    "audikw_1": SuiteSpec(943_695, 77_651_847, 82.3, 16, (243, 243)),
    "Geo_1438": SuiteSpec(1_437_960, 60_236_322, 41.9, 8, (424, 424)),
    "bone010": SuiteSpec(986_703, 47_851_783, 48.5, 9, (331, 331)),
    "Emilia_923": SuiteSpec(923_136, 40_373_538, 43.7, 9, (320, 320)),
    "Flan_1565": SuiteSpec(1_565_794, 114_165_372, 72.9, 15, (323, 323)),
    "Hook_1498": SuiteSpec(1_498_023, 59_374_451, 39.6, 8, (433, 433)),
    "ldoor": SuiteSpec(952_203, 42_493_817, 44.6, 9, (325, 325)),
    "Serena": SuiteSpec(1_391_349, 64_131_971, 46.1, 9, (393, 393)),
    "thermal2": SuiteSpec(1_228_045, 8_580_313, 7.0, 1, (107, 107, 107)),
}


def _surrogate_graph_arrays(name: str, scale: float):
    """The element-level graph of a Table-3 surrogate, id-shuffled within
    windows (seed ``hash(name) % 2**31``: per process, see the module
    docstring)."""
    spec = SUITE_MATRICES[name]
    grid = tuple(max(2, int(g * scale)) for g in spec.grid)
    if len(grid) == 3:
        indptr, cols, vals = _grid_laplacian_3d(*grid)
    else:
        indptr, cols, vals = _grid_laplacian_2d(*grid)
    n = int(np.prod(grid))
    if spec.window:
        window = max(16, int(spec.window * scale))
        perm = window_shuffle_perm(n, window, seed=hash(name) % 2**31)
        indptr, cols, vals = _permute_graph(indptr, cols, vals, n, perm)
    return indptr, cols, vals, n, spec


def suite_surrogate(name: str, scale: float = 1.0, dtype=torch.float64,
                    device="cuda") -> CSRMatrix:
    """Structural surrogate of a Table-3 matrix (optionally scaled down).

    ``scale`` < 1 shrinks the grid linearly (rows shrink ~quadratically for 2D
    surrogates); structure class (block size, stencil) is preserved.
    """
    indptr, cols, vals, n, spec = _surrogate_graph_arrays(name, scale)
    if spec.block == 1:
        return _csr(indptr, cols, vals, n, dtype, device)
    indptr, cols, vals = _kron_block_csr(indptr, cols, vals, n, _spd_block(spec.block))
    return _csr(indptr, cols, vals, n * spec.block, dtype, device)


def surrogate_graph(name: str, scale: float = 1.0, device="cuda") -> tuple[CSRMatrix, int]:
    """Element-level graph of a Table-3 surrogate + its ``row_block`` factor.

    Communication statistics computed on this graph with
    ``build_comm_graph(..., row_block=block)`` are identical to dof-level
    statistics when partitions align to element blocks — and ~block² cheaper
    to build, so full published scale is tractable.
    """
    indptr, cols, vals, n, spec = _surrogate_graph_arrays(name, scale)
    return _csr(indptr, cols, vals, n, torch.float64, device), spec.block


def example_2_1_graph(scale: float = 1.0, device="cuda") -> tuple[CSRMatrix, int]:
    """Element-level graph of Example 2.1 (320x256 elements, block 16)."""
    nx, ny = EXAMPLE_2_1["elements"]
    nx, ny = max(2, int(nx * scale)), max(2, int(ny * scale))
    indptr, cols, vals = _grid_laplacian_2d(nx, ny)
    return _csr(indptr, cols, vals, nx * ny, torch.float64, device), EXAMPLE_2_1["block"]
