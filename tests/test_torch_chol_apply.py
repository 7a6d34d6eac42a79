"""Port parity: the factor apply P = Z·C⁻¹, AP = AZ·C⁻¹ of the classic
iteration (repro_torch vs repro), on the CPU.

The reference leaves this step to XLA (two triangular solves in
``repro.core.methods.base._chol_inv_apply``); the port runs the
``chol_apply`` op, whose plain version solves the same triangular systems
and whose CUDA kernel does the substitution-form arithmetic of
:func:`chol_apply_dense`.  Inputs are numpy arrays: Z from a seed and
G = ZᵀAZ, a real gram1 on a small ``dg_laplace_2d``.

Tolerances: the port against the reference 1e-12 relative (both factor the
same float64 G and solve with t-term sums, t ≤ 32, on factors with
κ(C) < 1e3; only the summation order inside LAPACK and XLA differs, well
below 1e-12 of max|y|).  The substitution form against ``solve_triangular``:
the forward error bound of a t-term substitution, 2·t·eps·κ(C)·max|y|.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.sparse as ref_sparse
from repro.core.methods.base import _chol_inv_apply as ref_chol_inv_apply

from repro_torch import kernels
from repro_torch.core.methods.base import _chol_inv_apply
from repro_torch.kernels.chol_apply.ops import chol_apply
from repro_torch.kernels.chol_apply.ref import chol_apply_dense, chol_apply_ref
from repro_torch.sparse import csr_spmbv
from repro_torch.sparse.csr import CSRMatrix


def _gram1(t, seed=3):
    """(G, Z, AZ) as numpy float64: Z from a seed, AZ = A·Z and G = ZᵀAZ on
    the reference's DG operator."""
    ra = ref_sparse.dg_laplace_2d((8, 8), block=2)
    pa = CSRMatrix.from_numpy(ra.indptr, ra.indices, ra.data, ra.shape, device="cpu")
    z = np.random.default_rng(seed).standard_normal((ra.shape[0], t))
    az = csr_spmbv(pa, torch.as_tensor(z)).numpy()
    return z.T @ az, z, az


def _upper(t, dtype, seed=0):
    """An upper Cholesky factor of a well-conditioned SPD t×t matrix."""
    q = np.random.default_rng(seed).standard_normal((t, t))
    g = q @ q.T / t + np.eye(t)
    return torch.as_tensor(np.linalg.cholesky(g).T.copy()).to(dtype)


@pytest.mark.parametrize("t", [1, 4, 8, 20, 32])
def test_chol_inv_apply_matches_reference(t):
    g, z, az = _gram1(t)
    c = np.linalg.cholesky(g).T
    assert np.linalg.cond(c) < 1e3
    want = ref_chol_inv_apply(jnp.asarray(g), jnp.asarray(z), jnp.asarray(az))
    got = _chol_inv_apply(torch.as_tensor(g), torch.as_tensor(z), torch.as_tensor(az))
    assert len(got) == 2
    for w, o in zip(want, got):
        w = np.asarray(w)
        assert o.shape == w.shape and o.is_contiguous()
        np.testing.assert_allclose(o.numpy(), w, rtol=1e-12, atol=1e-12 * np.abs(w).max())
    # P is A-orthonormal: PᵀAP = I
    np.testing.assert_allclose(got[0].numpy().T @ got[1].numpy(), np.eye(t), atol=1e-10)


def test_non_spd_gram_gives_nans_on_both_sides():
    g, z, az = _gram1(4)
    g[:, 1] = g[1, :] = 0.0  # singular
    want = ref_chol_inv_apply(jnp.asarray(g), jnp.asarray(z), jnp.asarray(az))
    got = _chol_inv_apply(torch.as_tensor(g), torch.as_tensor(z), torch.as_tensor(az))
    for w, o in zip(want, got):
        assert np.isnan(np.asarray(w)).all()
        assert torch.isnan(o).all()
    # a NaN factor reaches every entry of the substitution form too
    nan_c = torch.full((4, 4), float("nan"), dtype=torch.float64)
    for y in chol_apply_dense(nan_c, torch.as_tensor(z), torch.as_tensor(az)):
        assert torch.isnan(y).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("t", [1, 4, 8, 16])
def test_substitution_form_matches_solve_triangular(t, dtype):
    c = _upper(t, dtype, seed=t)
    rng = np.random.default_rng(t + 1)
    mats = [torch.as_tensor(rng.standard_normal((300, t))).to(dtype) for _ in range(2)]
    want = chol_apply_ref(c, *mats)
    got = chol_apply_dense(c, *mats)
    kappa = float(np.linalg.cond(c.double().numpy()))
    eps = torch.finfo(dtype).eps
    for w, o in zip(want, got):
        assert o.dtype == dtype and o.shape == (300, t)
        tol = 2 * t * eps * kappa * float(w.abs().max())
        assert float((o.double() - w.double()).abs().max()) <= tol
    for m, y in zip(mats, got):  # Y·C = M to the same bound
        resid = (y.double() @ c.double() - m.double()).abs().max()
        assert float(resid) <= 2 * t * eps * kappa * float(m.abs().max())


@pytest.mark.parametrize("ranks,rmax,t", [(8, 37, 8), (3, 50, 4), (2, 1, 1)])
def test_rank_row_layout_agrees_with_per_rank_solves(ranks, rmax, t):
    """The distributed solve hands over its (ranks·rmax, t) stacked rows:
    the apply is row by row, so it equals each rank's own apply."""
    c = _upper(t, torch.float64, seed=7)
    rng = np.random.default_rng(8)
    z, az = (torch.as_tensor(rng.standard_normal((ranks * rmax, t))) for _ in range(2))
    p, ap = chol_apply(c, z, az)
    dense = chol_apply_dense(c, z, az)
    for r in range(ranks):
        rows = slice(r * rmax, (r + 1) * rmax)
        want = chol_apply(c, z[rows], az[rows])
        for got, w in zip((p, ap), want):
            torch.testing.assert_close(got[rows], w, rtol=1e-14, atol=1e-14)
        # the substitution form works row by row: equal bit for bit
        for got, w in zip(dense, chol_apply_dense(c, z[rows], az[rows])):
            assert torch.equal(got[rows], w)


def test_op_checks_and_cpu_tensors_never_count_launches():
    kernels.reset_launch_counts()
    c = _upper(4, torch.float64)
    m = torch.randn(10, 4, dtype=torch.float64)
    assert len(chol_apply(c, m)) == 1
    assert len(chol_apply(c, m, m)) == 2
    with pytest.raises(ValueError, match="one or two blocks"):
        chol_apply(c, m, m, m)
    with pytest.raises(ValueError, match="share one"):
        chol_apply(c, m, m[:, :3].contiguous())
    with pytest.raises(ValueError, match="square"):
        chol_apply(c[:3], m)
    with pytest.raises(ValueError, match="must all be CUDA tensors or all CPU tensors"):
        chol_apply(c.to("meta"), m)
    # _chol_inv_apply takes any number of blocks, two per op call
    g = (c.mT @ c).numpy()
    ys = _chol_inv_apply(torch.as_tensor(g), m, 2 * m, 3 * m)
    assert len(ys) == 3
    torch.testing.assert_close(ys[2], 3 * ys[0], rtol=1e-13, atol=1e-13)
    assert kernels.launch_counts()["chol_apply"] == 0
