"""Port parity: the adaptive ECG width controller (repro_torch vs repro), on
the CPU.

The same numpy inputs from seeds go to ``repro`` and ``repro_torch``
(``device="cpu"``): the controller's pieces (``stagnation_mask``,
``plateau_update``, ``ReductionPolicy.resolved_drop_tol``, ``GroupSpec``),
the ``drop_mask`` op's plain version, and whole sequential solves under
``rankrev``, ``reduce``, ``reduce+restart`` and custom policies, after the
reference's ``tests/test_adaptive.py``.  A right-hand side that vanishes on
subdomains makes the first Gram matrix singular: the fixed-width solve
breaks down on both sides, the adaptive one drops the dependent directions
at iteration 1 and converges.

Tolerances: iteration counts, ``active_hist``, ``reduction_events()``,
``recovery_events()`` and ``restarts`` exactly equal; ``res_hist`` within
1e-8 relative plus 1e-12·‖r₀‖ in float64 (1e-4 plus 1e-5·‖r₀‖ in float32):
the two packages sum in different orders, and the relative gap of the last
entries grows with the rounding ECG amplifies near convergence, as in the
fixed-width solves (``tests/test_torch_ecg.py``).  The step coefficients
in the stagnation tests keep every score at least a factor 10 from the
threshold, so the drop decisions do not hang on rounding.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.adaptive as ref_adaptive
import repro.core as ref_core
import repro.solver as ref_solver
import repro.sparse as ref_sparse
from repro.core.cg import SolveResult as RefSolveResult

import repro_torch.solver as port_solver
from repro_torch.adaptive import (
    GroupSpec,
    ReductionPolicy,
    plateau_update,
    resolve_policy,
    stagnation_mask,
)
from repro_torch.core.cg import SolveResult
from repro_torch.core.ecg import finalize_result, make_ecg_runner
from repro_torch.kernels.chol_apply.ops import drop_mask
from repro_torch.launch import solve as port_cli
from repro_torch.sparse import csr_spmbv
from repro_torch.sparse.csr import CSRMatrix

JNP = {torch.float32: jnp.float32, torch.float64: jnp.float64}
NP = {torch.float32: np.float32, torch.float64: np.float64}


@pytest.fixture(scope="module")
def system():
    ra = ref_sparse.fd_laplace_2d(16)  # 256 rows
    return ra, np.random.default_rng(0).standard_normal(ra.shape[0])


def deficient_rhs(n, t, m, seed=0):
    """b supported on the first m of t contiguous subdomains: the split
    residual has t − m exactly-zero columns (the reference test's)."""
    b = np.zeros(n)
    hi = (m * n) // t
    b[:hi] = np.random.default_rng(seed).standard_normal(hi)
    return b


def _port(ra, dtype=np.float64):
    return CSRMatrix.from_numpy(ra.indptr, ra.indices, ra.data.astype(dtype), ra.shape, device="cpu")


def _solve_both(ra, b, dtype=torch.float64, policy=None, **cfg):
    """The reference's and the port's handle solve of one config; ``policy``
    holds the fields of a custom ReductionPolicy built on each side."""
    rcfg = ref_solver.SolverConfig(**cfg)
    pcfg = port_solver.SolverConfig(**cfg)
    if policy is not None:
        rcfg = rcfg.replace(adaptive=ref_adaptive.ReductionPolicy(**policy))
        pcfg = pcfg.replace(adaptive=ReductionPolicy(**policy))
    np_dtype = NP[dtype]
    ra_d = dataclasses.replace(ra, data=ra.data.astype(np_dtype))
    want = ref_solver.ECGSolver.build(ra_d, config=rcfg).solve(jnp.asarray(b, JNP[dtype]))
    got = port_solver.ECGSolver.build(_port(ra, np_dtype), config=pcfg, device="cpu").solve(
        b.astype(np_dtype))
    return want, got


def _assert_same_solve(got, want, dtype=torch.float64):
    assert got.n_iters == want.n_iters
    assert (got.converged, got.breakdown) == (want.converged, want.breakdown)
    assert np.array_equal(got.active_hist, np.asarray(want.active_hist))
    assert got.reduction_events() == want.reduction_events()
    assert got.recovery_events() == want.recovery_events()
    assert got.restarts == want.restarts
    k = want.n_iters + 1
    hw, hg = np.asarray(want.res_hist)[:k], got.res_hist.numpy()[:k]
    rtol, floor = (1e-8, 1e-12) if dtype == torch.float64 else (1e-4, 1e-5)
    np.testing.assert_allclose(hg, hw, rtol=rtol, atol=floor * float(hw[0]))


# ------------------------------------------------------------ the controller
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kw", [{}, {"drop_tol": 0.0}, {"drop_tol": 1e-3}, {"drop_tol": 0.25}])
def test_resolved_drop_tol_matches_reference(kw, dtype):
    want = ref_adaptive.ReductionPolicy(**kw).resolved_drop_tol(JNP[dtype])
    assert ReductionPolicy(**kw).resolved_drop_tol(dtype) == want


def _coefficients(t, seed, dtype):
    """(t, t) step coefficients whose row norms sit at 10^-4 … 10^2 · rn with
    rn = 1 (every score at least a factor 10 from τ² at τ ∈ {1e-3, 0.3}),
    and distinct."""
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((t, t))
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    c *= 10.0 ** rng.permutation(np.linspace(-4, 2, t))[:, None]
    return c.astype(NP[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("policy", [
    {}, {"drop_tol": 0.0}, {"drop_tol": 0.3}, {"drop_tol": 0.3, "min_t": 3},
    {"drop_tol": 1e-3, "min_t": 2},
], ids=["default", "rankrev", "tau0.3", "tau0.3-min3", "tau1e-3-min2"])
@pytest.mark.parametrize("t,n_live", [(1, 1), (4, 4), (8, 5), (8, 8), (16, 9)])
def test_stagnation_mask_matches_reference(t, n_live, policy, dtype):
    c = _coefficients(t, 10 * t + n_live, dtype)
    active = np.arange(t) < n_live
    want = ref_adaptive.stagnation_mask(jnp.asarray(c), jnp.asarray(1.0, JNP[dtype]),
                                        jnp.asarray(active), ref_adaptive.ReductionPolicy(**policy))
    got = stagnation_mask(torch.as_tensor(c), 1.0, torch.as_tensor(active), ReductionPolicy(**policy))
    assert got.tolist() == np.asarray(want).tolist()
    # the drop_mask op's plain version: the same mask from the rank, and
    # [rank, active count] in c's dtype
    mask, counts = drop_mask(torch.as_tensor(c), torch.tensor(n_live, dtype=torch.int32), 1.0,
                             ReductionPolicy(**policy))
    assert mask.dtype == counts.dtype == dtype
    assert mask.tolist() == np.asarray(want, np.float64).tolist()
    assert counts.tolist() == [n_live, int(np.asarray(want).sum())]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plateau_update_matches_reference(dtype):
    """A residual history that improves, stalls within the 0.99 ratio and
    improves again: the same (best, since) sequence, the ratio's rounding in
    the solve's dtype included."""
    rns = [1.0, 0.5, 0.499, 0.4951, 0.5, 0.3, 0.2999, 0.1]
    policy, ref_policy = ReductionPolicy(), ref_adaptive.ReductionPolicy()
    np_dtype = NP[dtype]
    best, since = np_dtype(2.0), 0
    best_w, since_w = jnp.asarray(2.0, JNP[dtype]), jnp.asarray(0)
    for rn in rns:
        best, since = plateau_update(np_dtype(rn), best, since, policy)
        best_w, since_w = ref_adaptive.plateau_update(jnp.asarray(rn, JNP[dtype]), best_w, since_w,
                                                      ref_policy)
        assert (float(best), since) == (float(best_w), int(since_w))
        assert np.asarray(best).dtype == np_dtype


@pytest.mark.parametrize("kw", [
    dict(t_each=2, tols=(1e-8, 1e-6)), dict(t_each=1, tols=(1,)), dict(t_each=0, tols=(1e-8,)),
    dict(t_each=2.0, tols=(1e-8,)), dict(t_each=2, tols=()), dict(t_each=2, tols=(1e-8, 0.0)),
])
def test_group_spec_matches_reference(kw):
    try:
        want = ref_adaptive.GroupSpec(**kw)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(",")[0]):
            GroupSpec(**kw)
        return
    got = GroupSpec(**kw)
    assert (got.tols, got.n_groups, got.width) == (want.tols, want.n_groups, want.width)
    assert all(isinstance(x, float) for x in got.tols) and hash(got) == hash(GroupSpec(**kw))


def test_policy_objects_and_errors():
    assert resolve_policy(None) is None and resolve_policy("off") is None
    pol = resolve_policy("reduce+restart")
    assert isinstance(pol, ReductionPolicy) and pol.restart
    custom = ReductionPolicy(min_t=2, drop_tol=1e-3)
    assert resolve_policy(custom) is custom
    with pytest.raises(ValueError):
        resolve_policy("bogus")
    with pytest.raises(TypeError):
        resolve_policy(3)


# ------------------------------------------------------------ whole solves
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("t", [2, 4, 8])
def test_deficient_solve_matches_reference(system, t, dtype):
    ra, _ = system
    m = max(t // 2, 1)
    b = deficient_rhs(ra.shape[0], t, m)
    tol = 1e-9 if dtype == torch.float64 else 2e-4
    fixed_w, fixed = _solve_both(ra, b, dtype, t=t, tol=tol, max_iters=1500)
    assert fixed.breakdown and fixed_w.breakdown and fixed.n_iters == fixed_w.n_iters
    want, got = _solve_both(ra, b, dtype, t=t, tol=tol, max_iters=1500, adaptive="reduce")
    assert got.converged and not got.breakdown
    _assert_same_solve(got, want, dtype)
    # the dependent directions dropped at iteration 1, to the splitting's rank
    assert got.active_hist[0] == t and got.active_hist[1] == m
    assert got.reduction_events()[0] == (1, t, m) and got.recovery_events()[0] == 1
    ad = ra.todense().astype(np.float64)
    x = got.x.numpy().astype(np.float64)
    assert np.linalg.norm(ad @ x - b) / np.linalg.norm(b) < (1e-7 if dtype == torch.float64 else 1e-2)


def test_duplicated_split_degrades_to_cg_as_reference(system):
    """An exactly duplicated splitting (rank 1) breaks the fixed width and
    degrades the adaptive solve to CG, on both sides."""
    ra, b = system
    pa = _port(ra)
    ref_apply = lambda V: ref_sparse.csr_spmbv(ra, V)
    dup_w = lambda r, t_: jnp.tile(r[:, None], (1, t_)) / t_
    dup = lambda r, t_: r[:, None].expand(-1, t_) / t_
    want = ref_core.ecg_solve(ref_apply, jnp.asarray(b), t=4, tol=1e-9, max_iters=1500,
                              split=dup_w, adaptive="reduce")
    results = {}
    for policy in (None, resolve_policy("reduce")):
        runner = make_ecg_runner(lambda V: csr_spmbv(pa, V), 4, tol=1e-9, max_iters=1500,
                                 split=dup, policy=policy)
        x0 = torch.zeros(ra.shape[0], dtype=torch.float64)
        results[policy] = finalize_result(runner.run(runner.init(torch.as_tensor(b), x0)), x0=x0,
                                          t=4, tol=1e-9, policy=policy)
    assert results[None].breakdown
    got = results[resolve_policy("reduce")]
    assert got.converged and got.active_hist[1] == 1
    _assert_same_solve(got, want)
    cg = ref_core.cg_solve(lambda v: ref_sparse.csr_spmv(ra, v), jnp.asarray(b), tol=1e-9,
                           max_iters=1500)
    assert abs(got.n_iters - cg.n_iters) <= 2


@pytest.mark.parametrize("adaptive", ["rankrev", "reduce", "reduce+restart"])
def test_no_spurious_drops_on_full_rank(system, adaptive):
    ra, b = system
    plain_w, plain = _solve_both(ra, b, t=4, tol=1e-9, max_iters=2000)
    want, got = _solve_both(ra, b, t=4, tol=1e-9, max_iters=2000, adaptive=adaptive)
    assert got.converged and got.n_iters <= plain.n_iters + 2
    _assert_same_solve(got, want)
    assert got.reduction_events() == [] and got.active_hist[0] == 4


def test_custom_policy_matches_reference(system):
    """min_t = 2, drop_tol = 0.1 at t = 8 on a full-rank right-hand side:
    stagnation drops down to the floor (and below it only by rank), held
    over the first 60 iterations."""
    ra, b = system
    want, got = _solve_both(ra, b, t=8, tol=1e-9, max_iters=60,
                            policy=dict(min_t=2, drop_tol=0.1))
    _assert_same_solve(got, want)
    assert len(got.reduction_events()) >= 3 and min(got.active_hist[1:61]) >= 2


@pytest.mark.parametrize("case", ["deficient", "stagnating"])
def test_restart_matches_reference(system, case):
    """plateau_window = 10: on the deficient system (t = 4, m = 2, the
    reference's smoke test) and with stagnation drops at drop_tol = 0.1,
    where a plateau on the reduced block re-enlarges to t = 8."""
    ra, b = system
    if case == "deficient":
        t, b, kw = 4, deficient_rhs(ra.shape[0], 4, 2), {}
    else:
        t, kw = 8, {"drop_tol": 0.1}
    want, got = _solve_both(ra, b, t=t, tol=1e-9, max_iters=1500,
                            policy=dict(restart=True, plateau_window=10, **kw))
    assert got.converged
    _assert_same_solve(got, want)
    if case == "stagnating":
        assert got.restarts >= 1 and any(after == 8 for _, _, after in got.reduction_events())


def test_iter_trace_and_events_match_reference(system):
    ra, _ = system
    b = deficient_rhs(ra.shape[0], 4, 2)
    want, got = _solve_both(ra, b, t=4, tol=1e-9, max_iters=1500, adaptive="reduce")
    rows_w, rows = want.iter_trace(), got.iter_trace()
    assert [(r["k"], r["active"], r["events"]) for r in rows] == [
        (r["k"], r["active"], r["events"]) for r in rows_w]
    np.testing.assert_allclose([r["resnorm"] for r in rows], [r["resnorm"] for r in rows_w],
                               rtol=1e-8, atol=1e-12 * rows_w[0]["resnorm"])
    assert rows[1]["events"] == ("recovery",) and rows[1]["active"] == 2


def test_capped_final_iteration_drop_is_reported(system):
    """max_iters = 1 caps the solve on the iteration that drops the width:
    the event is still reported, as the reference's."""
    ra, _ = system
    b = deficient_rhs(ra.shape[0], 4, 2)
    want, got = _solve_both(ra, b, t=4, tol=1e-9, max_iters=1, adaptive="reduce")
    assert not got.converged and got.reduction_events() == want.reduction_events() == [(1, 4, 2)]


def test_reduction_events_read_the_trace_only():
    kw = dict(x=torch.zeros(4), n_iters=0, res_hist=torch.zeros(5), converged=False)
    for hist, events in (([4, 2, 2, 1, -1], [(1, 4, 2), (3, 2, 1)]), ([4, 4, 4, -1, -1], [])):
        got = SolveResult(**kw, active_hist=np.asarray(hist, np.int32))
        want = RefSolveResult(**{**kw, "x": jnp.zeros(4), "res_hist": jnp.zeros(5)},
                              active_hist=jnp.asarray(hist))
        assert got.reduction_events() == want.reduction_events() == events
    assert SolveResult(**kw).reduction_events() == [] and SolveResult(**kw).iter_trace()[0]["active"] is None


# ------------------------------------------------------------ handle and CLI
def test_with_config_carries_the_policy(system):
    ra, _ = system
    b = deficient_rhs(ra.shape[0], 4, 2)
    fixed = port_solver.ECGSolver.build(_port(ra), config=port_solver.SolverConfig(t=4, tol=1e-9),
                                        device="cpu")
    assert fixed.policy is None and fixed.solve(b).breakdown
    reduced = fixed.with_config(adaptive="reduce")
    assert reduced.stats.op_reused and reduced.policy == resolve_policy("reduce")
    res = reduced.solve(b)
    assert res.converged and res.active_hist[1] == 2 and res.comm_segments is None
    back = reduced.with_config(adaptive="off")
    assert back.policy is None and back.solve(b).active_hist is None


def test_cli_adaptive_summary(capsys):
    port_cli.main(["--matrix", "fd", "--elements", "4", "--t", "8", "--strategy", "sequential",
                   "--adaptive", "reduce+restart", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "sequential ECG[classic/jnp] t=8: iters=" in out and "converged=True" in out
    assert ("active width constant at t=8" in out) or ("active width reduced" in out)
