"""Port parity at the widths the card's kernels take above 16 columns (up to
32), on the CPU.

The kernels ``chol_apply``, ``block_trisolve``, ``bsr_spmbv``,
``fused_gram`` and ``ecg_tail`` take 1 <= t <= 32 on the card.  Here:

* whole solves at t = 20 against the reference's ``ECGSolver`` at t = 20 on
  ``fd_laplace_2d(32)`` (n = 1024), stopped at 1e-6·‖b‖: classic under both
  backends and block-Jacobi at the default block (32).  Iterations equal;
  ``res_hist`` within 1e-9 relative (and 1e-15·‖r₀‖ absolute) and x within
  1e-9 of max|x| — float64, only the summation order of the products
  differs.  (On DG operators small enough for a test the t = 20 block
  either loses rank and breaks down or, on ``dg_laplace_2d((16, 16),
  block=4)``, takes 33 iterations under the reference's jnp backend and 32
  under its pallas one: the dense element blocks amplify rounding, ROADMAP.md
  §3; an FD operator gives counts both backends agree on.)
* ``block_trisolve``'s plain version against the reference's Pallas kernel
  in interpret mode at bs = 16 and 32, t = 20 and 32 (1e-12 in float64,
  1e-5 in float32, on blocks with κ < 10);
* the launch plans the C launchers choose, mirrored in Python, at
  t ∈ {17, 20, 24, 32}: ``spmbv_plan``, ``gram_plan``, ``trisolve_plan`` and
  ``chol_plan``;
* the handle's refusal of blocks wider than 32 columns on the card, before
  any device work (the device is faked: the check reads it alone);
* static checks that the CUDA sources hold the wide instances.
"""

import importlib
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.solver as ref_solver
import repro.sparse as ref_sparse
from repro.kernels.block_trisolve.kernel import block_trisolve_pallas

from repro_torch import kernels
from repro_torch.core.ecg import check_card_width
from repro_torch.kernels import _build
from repro_torch.solver import ECGSolver, SolverConfig
from repro_torch.sparse.csr import CSRMatrix

bops = importlib.import_module("repro_torch.kernels.bsr_spmbv.ops")
gops = importlib.import_module("repro_torch.kernels.fused_gram.ops")
tops = importlib.import_module("repro_torch.kernels.block_trisolve.ops")
cops = importlib.import_module("repro_torch.kernels.chol_apply.ops")
handle = importlib.import_module("repro_torch.solver.handle")

CSRC = Path(_build.CSRC)
F32, F64 = torch.float32, torch.float64
WIDE = [17, 20, 24, 32]


def _port(ra):
    return CSRMatrix.from_numpy(ra.indptr, ra.indices, ra.data, ra.shape, device="cpu")


@pytest.fixture(scope="module")
def system():
    ra = ref_sparse.fd_laplace_2d(32)
    b = np.random.default_rng(0).standard_normal(ra.shape[0])
    return ra, b, 1e-6 * float(np.linalg.norm(b))


def _solve_pair(ra, b, tol, **kw):
    rcfg = ref_solver.SolverConfig(t=20, tol=tol, max_iters=400, **kw)
    want = ref_solver.ECGSolver.build(ra, config=rcfg).solve(b)
    got = ECGSolver.build(_port(ra), config=SolverConfig.from_json(rcfg.to_json()),
                          device="cpu").solve(b)
    return want, got


def _assert_same_solve(want, got):
    k = want.n_iters
    assert want.converged and got.converged and got.n_iters == k and got.t == 20
    hist = np.asarray(want.res_hist)[: k + 1]
    np.testing.assert_allclose(got.res_hist.numpy()[: k + 1], hist, rtol=1e-9, atol=1e-15 * hist[0])
    x_ref = np.asarray(want.x)
    assert np.abs(got.x.numpy() - x_ref).max() <= 1e-9 * np.abs(x_ref).max()


# ------------------------------------------------------------ whole solves
@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_classic_solve_at_t20_matches_reference(system, backend):
    ra, b, tol = system
    kernels.reset_launch_counts()
    want, got = _solve_pair(ra, b, tol, kernel=backend)
    _assert_same_solve(want, got)
    assert kernels.launch_counts()["chol_apply"] == 0  # CPU tensors: the plain versions


def test_block_jacobi_solve_at_t20_matches_reference(system):
    ra, b, tol = system
    want, got = _solve_pair(ra, b, tol, kernel="pallas",
                            precondition=ref_solver.PreconditionConfig(kind="block_jacobi", block=32))
    _assert_same_solve(want, got)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("t", [20, 32])
@pytest.mark.parametrize("bs", [16, 32])
def test_block_trisolve_plain_matches_pallas_at_wide_t(bs, t, dtype):
    nb = 3
    q = np.random.default_rng(bs).standard_normal((nb, bs, bs))
    l = np.linalg.cholesky(q @ q.transpose(0, 2, 1) / (4 * bs) + np.eye(bs)).astype(dtype)
    x = np.random.default_rng(bs + t).standard_normal((nb, bs, t)).astype(dtype)
    got = kernels.block_trisolve(torch.as_tensor(l), torch.as_tensor(x)).numpy()
    want = np.asarray(block_trisolve_pallas(jnp.asarray(l), jnp.asarray(x), interpret=True))
    tol = dict(rtol=1e-12, atol=1e-12) if dtype == "float64" else dict(rtol=1e-5, atol=1e-5)
    assert got.dtype == np.dtype(dtype) and got.shape == (nb, bs, t)
    np.testing.assert_allclose(got, want, **tol)


# ------------------------------------------------------------ launch plans
@pytest.mark.parametrize("t", WIDE)
def test_spmbv_plan_at_wide_t(t):
    # f64 mma tiles: NT = cdiv(t, 8) column tiles of 8; FMA: 32 sums a thread
    for br, bc in ((8, 8), (16, 16), (8, 4)):
        plan = bops.spmbv_plan(163_840, br, bc, t, 1_310_720, F64, 132)
        assert plan.path == "mma" and plan.cols == 8 * -(-t // 8) and plan.cols - 8 < t <= plan.cols
    for dtype, tile in ((F32, (8, 8)), (F64, (4, 8)), (F64, (32, 32))):
        plan = bops.spmbv_plan(1000, *tile, t, 1000 * tile[0], dtype, 132)
        assert plan.path == "fma" and plan.cols == 32
    with pytest.raises(ValueError, match="1 <= t <= 32"):
        bops.spmbv_plan(64, 8, 8, 33, 512, F64, 132)


@pytest.mark.parametrize("t", WIDE)
@pytest.mark.parametrize("ranks", [1, 8])
def test_gram_plan_at_wide_t(t, ranks):
    n = 1_310_720 // ranks
    for dtype in (F64, F32):
        plan = gops.gram_plan(ranks, n, t, dtype, 132)
        assert plan.path == ("mma" if dtype == F64 else "fma")
        step = gops.rows_per_step(t, plan.path)
        assert plan.rows_per_part % step == 0
        assert (plan.parts - 1) * plan.rows_per_part < n <= plan.parts * plan.rows_per_part
        assert plan.partials == ranks * 3 * t * t * plan.parts
        assert plan.partials * 8 < 64 * 2**20  # float64 scratch stays small
    # MT = cdiv(t, 8) tiles a side; each of 4 warps loads U four-row steps:
    # 2 at MT = 3, 1 at MT = 4
    assert gops.rows_per_step(t, "mma") == 4 * 4 * {3: 2, 4: 1}[-(-t // 8)]
    # the FMA path: a 4x4 tile of one product a thread, all 3·cdiv(t, 4)² in one CTA
    assert 3 * (-(-t // 4)) ** 2 <= gops._FMA_THREADS


@pytest.mark.parametrize("t", WIDE)
@pytest.mark.parametrize("bs", [8, 16, 32, 64])
def test_trisolve_plan_at_wide_t(bs, t):
    for dtype in (F64, F32):
        plan = tops.trisolve_plan(1_310_720 // bs, bs, t, dtype, 132)
        # chunks of 16 right-hand sides against one staged tile
        assert plan.cols == 16 and plan.chunks == 2 and plan.cols * plan.chunks >= t
        narrow = tops.trisolve_plan(1_310_720 // bs, bs, 16, dtype, 132)
        assert plan._replace(chunks=1) == narrow  # the geometry of t = 16, walked twice


@pytest.mark.parametrize("t", [1, 2] + WIDE)
def test_chol_plan_mirrors_the_launcher(t):
    for dtype, es in ((F64, 8), (F32, 4)):
        plan = cops.chol_plan(t, dtype)
        if t <= 2:
            assert plan.path == "vector" and plan.smem_bytes == 0
            assert plan.rows_per_vec == 16 // es // t
            assert cops.chol_plan(t, dtype, aligned=False).path == "staged"
            continue
        assert plan.path == "staged" and plan.stride % 2 == 1 and plan.stride >= t
        assert plan.smem_bytes == (t * t + 8 * 32 * plan.stride) * es
        assert plan.opt_in == (plan.smem_bytes > 48 * 1024) and plan.ctas_by_smem >= 1
    assert cops.chol_plan(32, F64).smem_bytes == 75_776 and cops.chol_plan(32, F64).ctas_by_smem == 3
    assert [t for t in range(3, 33) if cops.chol_plan(t, F64).opt_in] == list(range(22, 33))
    assert not cops.chol_plan(32, F32).opt_in
    with pytest.raises(ValueError, match="1 <= t <= 32"):
        cops.chol_plan(33, F64)


# ------------------------------------------------------ the handle's refusal
@pytest.mark.parametrize("overrides,what", [
    (dict(t=33), "t=33"),
    (dict(t=8, method="sstep", s=5), "s=5"),
    (dict(t="auto", t_candidates=(8, 40)), "auto"),
])
def test_wider_than_32_is_refused_on_the_card_before_device_work(system, monkeypatch, overrides, what):
    ra, b, tol = system
    pa = _port(ra)
    cfg = SolverConfig(t=8, tol=tol).replace(**overrides)
    # build: the device resolves to CUDA (faked); the refusal comes before
    # the operator is moved there, which a CPU-only torch could not do
    monkeypatch.setattr(handle, "resolve_device", lambda device="cuda": torch.device("cuda"))
    with pytest.raises(NotImplementedError, match=f"(?s){what}.*at most 32.*fault E"):
        ECGSolver.build(pa, config=cfg, device="cuda")
    monkeypatch.undo()
    # with_config on a handle whose device is CUDA (faked) refuses too
    solver = ECGSolver.build(pa, config=SolverConfig(t=8, tol=tol), device="cpu")
    solver.device = torch.device("cuda")
    with pytest.raises(NotImplementedError, match="at most 32"):
        solver.with_config(**overrides)
    assert (solver.stats.builds, solver.stats.solves) == (1, 0)
    # 32 columns fit; on the CPU any width runs
    for fits in (SolverConfig(t=32), SolverConfig(t=8).replace(method="sstep", s=4),
                 SolverConfig(t="auto").replace(t_candidates=(1, 32))):
        check_card_width(torch.device("cuda"), fits.t, fits.method.s, fits.adaptive.t_candidates)
    check_card_width(torch.device("cpu"), cfg.t, cfg.method.s, cfg.adaptive.t_candidates)


# ------------------------------------------------------------ CUDA sources
def test_cuda_sources_hold_the_wide_instances():
    chol = (CSRC / "chol_apply.cu").read_text()
    assert "REPRO_CHOL_T(32)" in chol and "REPRO_CHOL_T(33)" not in chol
    assert "chol_apply_vec_kernel<T, TT>" in chol
    assert ("(static_cast<size_t>(TT) * TT + static_cast<size_t>(kWarps) * kTile) * sizeof(T);"
            in chol)
    bsr = (CSRC / "bsr_spmbv.cu").read_text()
    assert "launch_mma<MT, S, 4>(a);" in bsr and "bsr_spmbv_fma<T, 32>" in bsr
    gram = (CSRC / "fused_gram.cu").read_text()
    assert "fused_gram_mma<3>" in gram and "fused_gram_mma<4>;" in gram
    tail = (CSRC / "ecg_tail.cu").read_text()
    # the mma kernel: an instance a width from kMmaMinT to 32, which float64
    # takes; float32 and the narrow float64 widths one thread an element
    uops = importlib.import_module("repro_torch.kernels.block_update.ops")
    mma_min = uops._MMA_MIN_T
    assert f"REPRO_TAIL_T({mma_min})" in tail and f"REPRO_TAIL_T({mma_min - 1})" not in tail
    assert "REPRO_TAIL_T(32)" in tail and "REPRO_TAIL_T(33)" not in tail
    assert "launch_mma<TT>(" in tail and "ecg_tail_mma_kernel<TT>;" in tail
    assert f"constexpr int kMmaMinT = {mma_min};" in tail and 1 < mma_min <= 17
    assert [uops.tail_plan(t, F64).path for t in (1, mma_min - 1, mma_min, 20, 32)] == ["element"] * 2 + ["mma"] * 3
    assert {uops.tail_plan(t, F32).path for t in range(1, 33)} == {"element"}
    tri = (CSRC / "block_trisolve.cu").read_text()
    assert "p.chunks = (t + p.cols - 1) / p.cols;" in tri
    for src in (bsr, gram, tri):
        assert "t > 32" in src and "t > 16" not in src
    assert "if constexpr (TT <= 2)" in chol and cops._VEC_MAX_T == 2  # the vector path's widths
    for mod in (bops, gops, tops, cops, importlib.import_module("repro_torch.kernels.block_update.ops")):
        assert mod.MAX_T == 32
