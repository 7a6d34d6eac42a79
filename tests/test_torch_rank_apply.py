"""Port parity: the rank-revealing factorization and apply of the adaptive
solver (repro_torch vs repro), on the CPU.

The reference factors G = ZᵀAZ with diagonal pivoting (``pivoted_cholesky``)
and applies the factor with XLA ops (``rank_revealing_apply``); the port
runs the same steps as plain torch ops on CPU tensors, and the
``rank_apply`` CUDA kernel (held to :func:`rank_apply_dense`, the
substitution form in the kernel's order, on the card) on CUDA tensors.

Inputs: Z from a seed with t − r columns set to zero, AZ = A·Z and
G = ZᵀAZ on the reference's DG operator, so G's dependent rows and columns
are exactly zero, as a right-hand side that vanishes on subdomains makes
them.  The remaining pivots are far apart, so the pivot order does not hang
on rounding: the reference contracts the Schur update into fused
multiply-adds under ``jit`` and the port does not, which moves L by a few
ulps, not the order.

Tolerances: ``perm`` and ``rank`` exactly equal; L and the blocks 1e-12
relative to their largest entry in float64 (t-term sums on factors with
κ < 1e3), 1e-5 in float32; the substitution form against
``solve_triangular`` within 2·t·eps·κ(L)·max|y|, the forward error bound
of a t-term substitution.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.sparse as ref_sparse
from repro.adaptive import default_rank_rtol as ref_rtol
from repro.adaptive import pivoted_cholesky as ref_pivoted_cholesky
from repro.adaptive import rank_revealing_apply as ref_rank_revealing_apply

from repro_torch import kernels
from repro_torch.adaptive import default_rank_rtol, pivoted_cholesky, rank_revealing_apply
from repro_torch.kernels.chol_apply.ops import rank_apply
from repro_torch.kernels.chol_apply.ref import rank_apply_dense, rank_apply_ref
from repro_torch.sparse import csr_spmbv
from repro_torch.sparse.csr import CSRMatrix

CASES = [(t, r) for t in (1, 2, 4, 8, 16) for r in range(t + 1)]
IDS = [f"t{t}-rank{r}" for t, r in CASES]


def _gram(t, r, seed=0, dtype=np.float64):
    """(G, Z, AZ) as numpy arrays: Z from a seed with t − r zero columns at
    seeded positions, AZ = A·Z and G = ZᵀAZ on a small DG operator."""
    ra = ref_sparse.dg_laplace_2d((8, 8), block=2)
    pa = CSRMatrix.from_numpy(ra.indptr, ra.indices, ra.data, ra.shape, device="cpu")
    rng = np.random.default_rng(seed + 17 * t + r)
    z = rng.standard_normal((ra.shape[0], t))
    z[:, rng.permutation(t)[r:]] = 0.0
    az = csr_spmbv(pa, torch.as_tensor(z)).numpy()
    g = z.T @ az
    return (g + g.T).astype(dtype) / 2, z.astype(dtype), az.astype(dtype)


def _close(got, want, rel):
    scale = max(float(np.abs(want).max()), 1e-300)
    assert np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max() <= rel * scale


@pytest.mark.parametrize("t,r", CASES, ids=IDS)
def test_pivoted_cholesky_matches_reference(t, r):
    g, _, _ = _gram(t, r)
    l_w, perm_w, rank_w = ref_pivoted_cholesky(jnp.asarray(g))
    l, perm, rank = pivoted_cholesky(torch.as_tensor(g))
    assert perm.tolist() == np.asarray(perm_w).tolist()
    assert int(rank) == int(rank_w) == r
    _close(l.numpy(), np.asarray(l_w), 1e-12)
    assert not l[:, r:].any()  # dependent directions: the trailing zero columns


@pytest.mark.parametrize("t,r", CASES, ids=IDS)
def test_rank_revealing_apply_matches_reference(t, r):
    g, z, az = _gram(t, r)
    (p_w, ap_w), rank_w, act_w = ref_rank_revealing_apply(jnp.asarray(g), jnp.asarray(z),
                                                          jnp.asarray(az))
    (p, ap), rank, active = rank_revealing_apply(*map(torch.as_tensor, (g, z, az)))
    assert int(rank) == int(rank_w) and active.tolist() == np.asarray(act_w).tolist()
    _close(p.numpy(), np.asarray(p_w), 1e-12)
    _close(ap.numpy(), np.asarray(ap_w), 1e-12)
    assert not p[:, r:].any() and not ap[:, r:].any()


@pytest.mark.parametrize("t", [1, 2, 4, 8, 16])
def test_nan_gram_matches_reference(t):
    """A G holding NaN on its diagonal: thresh is NaN, every pivot fails,
    rank 0 and zero blocks; the pivot order follows ``jnp.argmax`` (a NaN
    first) on both sides."""
    g, z, az = _gram(t, t)
    g[t // 2, t // 2] = np.nan
    l_w, perm_w, rank_w = ref_pivoted_cholesky(jnp.asarray(g))
    l, perm, rank = pivoted_cholesky(torch.as_tensor(g))
    assert perm.tolist() == np.asarray(perm_w).tolist() and int(rank) == int(rank_w) == 0
    assert not l.any() and not np.asarray(l_w).any()
    (p_w, _), _, _ = ref_rank_revealing_apply(jnp.asarray(g), jnp.asarray(z), jnp.asarray(az))
    *ys, rank, perm_k = rank_apply(*map(torch.as_tensor, (g, z, az)),
                                   rtol=default_rank_rtol(torch.float64))
    assert int(rank) == 0 and perm_k.tolist() == np.asarray(perm_w).tolist()
    assert not any(y.any() for y in ys) and not np.asarray(p_w).any()


@pytest.mark.parametrize("r", [0, 3, 5, 8])
def test_float32_matches_reference(r):
    g, z, az = _gram(8, r, dtype=np.float32)
    l_w, perm_w, rank_w = ref_pivoted_cholesky(jnp.asarray(g))
    l, perm, rank = pivoted_cholesky(torch.as_tensor(g))
    assert perm.tolist() == np.asarray(perm_w).tolist() and int(rank) == int(rank_w) == r
    _close(l.numpy(), np.asarray(l_w), 1e-5)
    (p_w, _), _, _ = ref_rank_revealing_apply(jnp.asarray(g), jnp.asarray(z), jnp.asarray(az))
    (p, _), _, _ = rank_revealing_apply(*map(torch.as_tensor, (g, z, az)))
    _close(p.numpy(), np.asarray(p_w), 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_default_rank_rtol_matches_reference(dtype):
    assert default_rank_rtol(dtype) == ref_rtol(jnp.float32 if dtype == torch.float32 else jnp.float64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("t,r", [(1, 1), (4, 2), (8, 4), (8, 8), (16, 11)])
def test_rank_apply_dense_matches_ref(t, r, dtype):
    """The substitution form (the kernel's arithmetic) against the
    ``solve_triangular`` plain version: the same factorization, so the same
    rank and pivot order; blocks within the forward error bound."""
    g, z, az = (torch.as_tensor(x).to(dtype) for x in _gram(t, r))
    rtol = default_rank_rtol(dtype)
    *want, rank_w, perm_w = rank_apply_ref(g, z, az, rtol=rtol)
    *got, rank, perm = rank_apply_dense(g, z, az, rtol=rtol)
    assert torch.equal(rank, rank_w) and torch.equal(perm, perm_w) and int(rank) == r
    l, _, _ = pivoted_cholesky(g.double(), rtol=rtol)
    kappa = float(torch.linalg.cond(l[:r, :r])) if r else 1.0
    eps = torch.finfo(dtype).eps
    for y, w in zip(got, want):
        bound = 2 * t * eps * kappa * float(w.abs().max())
        assert float((y.double() - w.double()).abs().max()) <= bound
        assert not y[:, r:].any()


def test_rank_apply_on_cpu_runs_the_plain_version_and_checks():
    g, z, az = (torch.as_tensor(x) for x in _gram(4, 3))
    kernels.reset_launch_counts()
    got = rank_apply(g, z, az, rtol=1e-10)
    want = rank_apply_ref(g, z, az, rtol=1e-10)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got[-1].dtype == torch.int32 and got[-2].dtype == torch.int32 and got[-2].dim() == 0
    assert kernels.launch_counts() == dict.fromkeys(kernels.launch_counts(), 0)
    with pytest.raises(ValueError, match="square"):
        rank_apply(g[:3], z, rtol=1e-10)
    with pytest.raises(ValueError, match="one or two blocks"):
        rank_apply(g, z, az, z, rtol=1e-10)
    with pytest.raises(ValueError, match="share one"):
        rank_apply(g, z, az[:5], rtol=1e-10)
    with pytest.raises(ValueError, match="CUDA tensors or all CPU"):
        rank_apply(g.to("meta"), z, rtol=1e-10)
