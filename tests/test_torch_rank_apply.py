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

from pathlib import Path

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


# ----------------------------------------- s-step widths (s·t up to 32)
WIDE = [(24, 12), (24, 24), (32, 0), (32, 16), (32, 29), (32, 32)]


@pytest.mark.parametrize("t,r", WIDE, ids=[f"t{t}-rank{r}" for t, r in WIDE])
def test_wide_rank_revealing_apply_matches_reference(t, r):
    """The s-step scheme factors an (s·t)×(s·t) Gram every block: at t = 8
    and s = 3, 4 that is 24 and 32 columns (t = 16 is in CASES above)."""
    g, z, az = _gram(t, r)
    l_w, perm_w, rank_w = ref_pivoted_cholesky(jnp.asarray(g))
    (p_w, ap_w), _, act_w = ref_rank_revealing_apply(jnp.asarray(g), jnp.asarray(z),
                                                     jnp.asarray(az))
    l, perm, rank = pivoted_cholesky(torch.as_tensor(g))
    assert perm.tolist() == np.asarray(perm_w).tolist() and int(rank) == int(rank_w) == r
    _close(l.numpy(), np.asarray(l_w), 1e-12)
    (p, ap), rank, active = rank_revealing_apply(*map(torch.as_tensor, (g, z, az)))
    assert active.tolist() == np.asarray(act_w).tolist()
    _close(p.numpy(), np.asarray(p_w), 1e-12)
    _close(ap.numpy(), np.asarray(ap_w), 1e-12)


def _sstep_gram(s, t=8):
    """G = VᵀAV of the first s-step block, V = [R, AR, …, A^{s−1}R] of the
    split residual of a random b on the DG operator, with Z = V, AZ = A·V:
    the monomial basis the scheme factors (its last columns nearly
    dependent)."""
    ra = ref_sparse.dg_laplace_2d((8, 8), block=2)
    pa = CSRMatrix.from_numpy(ra.indptr, ra.indices, ra.data, ra.shape, device="cpu")
    from repro_torch.core.enlarging import split_residual

    cur = split_residual(torch.as_tensor(np.random.default_rng(5).standard_normal(ra.shape[0])), t)
    vs, avs = [], []
    for _ in range(s):
        nxt = csr_spmbv(pa, cur)
        vs.append(cur)
        avs.append(nxt)
        cur = nxt
    v, av = torch.cat(vs, dim=1), torch.cat(avs, dim=1)
    return (v.T @ av).numpy(), v.numpy(), av.numpy()


@pytest.mark.parametrize("s", [2, 4])
def test_sstep_gram_pivots_match_reference(s):
    """A real s-step Gram at s·t = 16 and 32: the same pivot order and rank
    as the reference's (its pivots stay apart from each other and from the
    threshold on this operator)."""
    g, z, az = _sstep_gram(s)
    _, perm_w, rank_w = ref_pivoted_cholesky(jnp.asarray(g))
    (p_w, _), _, _ = ref_rank_revealing_apply(jnp.asarray(g), jnp.asarray(z), jnp.asarray(az))
    *ys, rank, perm = rank_apply(*map(torch.as_tensor, (g, z, az)),
                                 rtol=default_rank_rtol(torch.float64))
    assert perm.tolist() == np.asarray(perm_w).tolist() and int(rank) == int(rank_w)
    _close(ys[0].numpy(), np.asarray(p_w), 1e-8)


def test_rank_plan_fits_shared_memory_and_mirrors_the_source():
    """``rank_apply``'s dynamic shared memory at every width it takes: under
    the 227 KB a CTA may use, opting in above 48 KB (t >= 22 in float64),
    warp 0's tile buffer large enough for the Schur complement, and the
    formula the C launcher uses."""
    from repro_torch.kernels.chol_apply import ops as cops

    for dtype in (torch.float32, torch.float64):
        for t in range(1, cops.MAX_RANK_T + 1):
            plan = cops.rank_plan(t, dtype)
            assert plan.stride % 2 == 1 and plan.stride >= t
            assert t * plan.stride <= 32 * plan.stride  # the Schur complement in warp 0's buffer
            assert plan.smem_bytes <= 232_448 and plan.ctas_by_smem >= 1
            assert plan.opt_in == (plan.smem_bytes > 48 * 1024)
    assert cops.rank_plan(8, torch.float64).smem_bytes == 19_104
    assert cops.rank_plan(32, torch.float64).smem_bytes == 76_416
    assert cops.rank_plan(32, torch.float64).ctas_by_smem == 3
    assert [t for t in range(1, 33) if cops.rank_plan(t, torch.float64).opt_in] == list(range(22, 33))
    assert not cops.rank_plan(32, torch.float32).opt_in
    with pytest.raises(ValueError, match="1 <= t <= 32"):
        cops.rank_plan(33, torch.float64)
    src = (Path(cops.__file__).resolve().parents[1] / "csrc" / "chol_apply.cu").read_text()
    assert "static constexpr int kStride = TT % 2 ? TT : TT + 1;" in src
    assert ("(static_cast<size_t>(kWarps) * kTile + TT * kStride + TT) * sizeof(T) + "
            "TT * sizeof(int);") in src
    assert "REPRO_RANK_T(32)" in src and "REPRO_RANK_T(33)" not in src
    # the wrapper refuses a width the kernel does not take (before launching)
    g = torch.eye(33, dtype=torch.float64)
    with pytest.raises(ValueError, match="1 <= t <= 32"):
        cops._check_kernel_operands("rank_apply", g, [torch.zeros(4, 33, dtype=torch.float64)],
                                    cops.MAX_RANK_T)
    with pytest.raises(ValueError, match="1 <= t <= 32"):
        cops._check_kernel_operands("chol_apply", g, [torch.zeros(4, 33, dtype=torch.float64)],
                                    cops.MAX_T)


# ------------------------------- drop_mask on s-step's (t, s·t) coefficients
HOLES = [(8, 16, (1, 0, 1, 1, 0, 1, 1, 1)), (8, 32, (0, 1, 1, 1, 1, 1, 0, 1)),
         (8, 32, (1, 1, 1, 1, 1, 1, 1, 1)), (4, 16, (0, 1, 0, 1))]


@pytest.mark.parametrize("policy", [{}, {"drop_tol": 0.0}, {"drop_tol": 0.3, "min_t": 3}],
                         ids=["default", "rankrev", "tau0.3-min3"])
@pytest.mark.parametrize("t,k,live", HOLES, ids=[f"t{t}-k{k}-{''.join(map(str, m))}"
                                                 for t, k, m in HOLES])
def test_drop_mask_with_a_mask_that_has_holes_matches_reference(t, k, live, policy):
    """s-step scores the (t, s·t) transposed coefficient block against its
    carried seed mask (``stagnation_mask(c.T, rn, act_t, policy)``): the
    plain version against the reference's, mask and active count exact.
    The row norms sit at 10^-4 … 10^2 (every score at least a factor 10
    from the thresholds)."""
    import repro.adaptive as ref_adaptive
    from repro_torch.adaptive import ReductionPolicy
    from repro_torch.kernels.chol_apply.ops import drop_mask

    rng = np.random.default_rng(t + k)
    ct = rng.standard_normal((t, k))
    ct /= np.linalg.norm(ct, axis=1, keepdims=True)
    ct *= 10.0 ** rng.permutation(np.linspace(-4, 2, t))[:, None]
    c = ct.T.copy()  # the (s·t, t) block PᵀR the scheme forms
    act = np.asarray(live, bool)
    want = ref_adaptive.stagnation_mask(jnp.asarray(c).T, 1.0, jnp.asarray(act),
                                        ref_adaptive.ReductionPolicy(**policy))
    rank = torch.tensor(k - 1, dtype=torch.int32)
    mask, counts = drop_mask(torch.as_tensor(c).T.contiguous(), rank, 1.0,
                             ReductionPolicy(**policy), live=torch.as_tensor(act))
    assert mask.tolist() == np.asarray(want).astype(float).tolist()
    assert counts.tolist() == [k - 1, float(np.asarray(want).sum())]
    assert not (mask.numpy() > act).any()  # a dead seed column stays dead


def test_drop_mask_checks_its_live_mask():
    from repro_torch.adaptive import ReductionPolicy
    from repro_torch.kernels.chol_apply.ops import drop_mask

    c, rank = torch.ones(4, 8, dtype=torch.float64), torch.tensor(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="live mask"):
        drop_mask(c, rank, 1.0, ReductionPolicy(), live=torch.ones(3, dtype=torch.bool))
    with pytest.raises(ValueError, match="CUDA tensors or all CPU"):
        drop_mask(c, rank, 1.0, ReductionPolicy(), live=torch.ones(4, dtype=torch.bool,
                                                                    device="meta"))
