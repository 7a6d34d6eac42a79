"""Sparse test-matrix generators.

Port of ``repro/sparse/matrices.py``; every generator's CSR arrays are equal
to the reference's.  The grid Laplacians and the Kronecker block expansion
are vectorised: ``dg_laplace_2d((320, 256), block=16)`` (Example 2.1 at full
scale: 1 310 720 rows, ~104.5M nonzeros) is built in seconds instead of the
reference's per-row Python loops.  Arrays are built on the host with numpy
and handed to ``device`` once.
"""

from __future__ import annotations

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
