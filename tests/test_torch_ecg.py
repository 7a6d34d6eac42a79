"""Port parity: the classic-ECG solve (repro_torch vs repro), float64 on the CPU.

The same operator (the reference's generator output, carried over with
``CSRMatrix.from_numpy``) and the same numpy right-hand side go through both
packages' ``ECGSolver``; iteration counts must be equal, ``res_hist`` agree
to rtol 1e-8 and x to 1e-8 relative to max|x|.

The two packages sum in different orders, so their iterates differ by
rounding, and ECG amplifies rounding once it has resolved the extreme
eigenvalues (the reference's own jnp and pallas backends part the same way).
On the DG operators with dense element blocks that phase starts early, so
the solves here stop at a relative residual of 1e-6, before it.  The chosen
operators and widths keep every compared history within 1e-9 of each other.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.sparse as ref_sparse
import repro.solver as ref_solver
from repro.core.cg import _cg_solve as ref_cg_solve
from repro.core.enlarging import split_residual as ref_split
from repro.core.methods.base import _chol_inv_apply as ref_chol_inv_apply

import repro_torch.solver as port_solver
from repro_torch.core.cg import _cg_solve
from repro_torch.core.enlarging import collapse, split_residual
from repro_torch.core.methods.base import _apply_vec, _chol_inv_apply
from repro_torch.sparse import csr_spmbv, csr_spmv
from repro_torch.sparse.csr import CSRMatrix

MATRICES = {
    "fd": lambda: ref_sparse.fd_laplace_2d(16),
    "dg": lambda: ref_sparse.dg_laplace_2d((8, 8), block=2),
}
RTOL_SOLVE = 1e-6  # solve tolerance, relative to ||b||


def _port(ra):
    return CSRMatrix.from_numpy(ra.indptr, ra.indices, ra.data, ra.shape, device="cpu")


def _solve_both(ra, b, tol, t, backend, max_iters=2000):
    rcfg = ref_solver.SolverConfig(
        t=t, tol=tol, max_iters=max_iters,
        kernel=ref_solver.KernelConfig(backend=backend, ell_block=(4, 4)),
    )
    pcfg = port_solver.SolverConfig.from_json(rcfg.to_json())
    want = ref_solver.ECGSolver.build(ra, config=rcfg).solve(b)
    got = port_solver.ECGSolver.build(_port(ra), config=pcfg, device="cpu").solve(b)
    return want, got


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("t", [1, 2, 4, 8])
@pytest.mark.parametrize("matrix", sorted(MATRICES))
def test_solve_matches_reference(matrix, t, backend):
    ra = MATRICES[matrix]()
    b = np.random.default_rng(0).standard_normal(ra.shape[0])
    want, got = _solve_both(ra, b, RTOL_SOLVE * np.linalg.norm(b), t, backend)
    assert want.converged and got.converged
    assert got.n_iters == want.n_iters
    assert got.t == want.t == t
    hw, hg = np.asarray(want.res_hist), got.res_hist.numpy()
    assert hg.shape == hw.shape
    k = want.n_iters + 1
    np.testing.assert_allclose(hg[:k], hw[:k], rtol=1e-8, atol=0)
    assert np.isnan(hg[k:]).all() and np.isnan(hw[k:]).all()
    xw, xg = np.asarray(want.x), got.x.numpy()
    assert np.abs(xg - xw).max() <= 1e-8 * np.abs(xw).max()


def test_singular_gram_breakdown_matches_reference():
    """A right-hand side that vanishes on one subdomain leaves one column of
    the split residual zero, so the first Gram matrix is singular: both
    packages report breakdown at the same iteration with the last finite
    state."""
    ra = ref_sparse.fd_laplace_2d(8)
    b = np.random.default_rng(1).standard_normal(ra.shape[0])
    b[16:32] = 0.0  # subdomain 1 of 4 (contiguous mapping)
    want, got = _solve_both(ra, b, 1e-8, 4, "jnp")
    assert want.breakdown and got.breakdown
    assert not got.converged
    assert got.n_iters == want.n_iters
    np.testing.assert_allclose(got.res_hist.numpy()[: got.n_iters + 1],
                               np.asarray(want.res_hist)[: want.n_iters + 1], rtol=1e-12)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=1e-12)
    assert np.isfinite(got.x.numpy()).all()


def test_cg_baseline_matches_reference():
    ra = MATRICES["fd"]()
    pa = _port(ra)
    b = np.random.default_rng(2).standard_normal(ra.shape[0])
    tol = 1e-6 * np.linalg.norm(b)
    want = ref_cg_solve(lambda v: ref_sparse.csr_spmv(ra, v), jnp.asarray(b), tol=tol, max_iters=500)
    got = _cg_solve(lambda v: csr_spmv(pa, v), torch.as_tensor(b), tol=tol, max_iters=500)
    assert got.t is None and got.converged
    assert got.n_iters == want.n_iters
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("mapping", ["contiguous", "round_robin"])
@pytest.mark.parametrize("n,t", [(37, 4), (64, 8), (10, 1)])
def test_split_residual_equal(n, t, mapping):
    r = np.random.default_rng(n).standard_normal(n)
    want = np.asarray(ref_split(jnp.asarray(r), t, mapping))
    big = split_residual(torch.as_tensor(r), t, mapping)
    np.testing.assert_array_equal(big.numpy(), want)
    np.testing.assert_allclose(collapse(big).numpy(), r, rtol=0, atol=1e-15)  # eq. (2.3)


def test_chol_inv_apply_matches_reference_and_flags_non_spd():
    ra = MATRICES["dg"]()
    pa = _port(ra)
    z = np.random.default_rng(3).standard_normal((ra.shape[0], 5))
    az = csr_spmbv(pa, torch.as_tensor(z))
    g = z.T @ az.numpy()
    want = ref_chol_inv_apply(jnp.asarray(g), jnp.asarray(z), jnp.asarray(az.numpy()))
    got = _chol_inv_apply(torch.as_tensor(g), torch.as_tensor(z), az)
    for w, o in zip(want, got):
        np.testing.assert_allclose(o.numpy(), np.asarray(w), rtol=1e-10, atol=1e-12)
    p = got[0]
    np.testing.assert_allclose((p.T @ csr_spmbv(pa, p)).numpy(), np.eye(5), atol=1e-8)
    # a singular G comes back as NaNs (as jnp.linalg.cholesky), not an exception
    g[:, 2] = g[2, :] = 0.0
    bad = _chol_inv_apply(torch.as_tensor(g), torch.as_tensor(z))[0]
    assert torch.isnan(bad).all()


def test_initial_residual_is_width1():
    pa = _port(MATRICES["fd"]())
    seen = []

    def spy(v):
        seen.append(tuple(v.shape))
        return csr_spmbv(pa, v)

    b = torch.as_tensor(np.random.default_rng(4).standard_normal(pa.shape[0]))
    out = _apply_vec(spy, b, 8)
    assert seen == [(pa.shape[0], 1)]
    torch.testing.assert_close(out, csr_spmv(pa, b), rtol=0, atol=1e-12)
