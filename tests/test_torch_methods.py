"""Port parity: the pipelined and s-step iteration schemes (repro_torch vs
repro), float64 on the CPU.

The same operator (the reference's generator output) and the same numpy
right-hand sides go through both packages' ``ECGSolver``, sequentially, on
``dg_laplace_2d((10, 10), block=8)`` (800 rows, the reference's
``tests/test_methods.py`` system) at t = 4 and 8, for ``pipelined`` and for
``sstep`` at s ∈ {1, 2, 4} with and without ``reorth``, each without a
policy, under ``reduce`` and (s-step) ``reduce+restart``; the policies get a
right-hand side on t/2 of the t subdomains, so the width drops at the first
iteration.  Also: the registry, the collective accounting, the validation
errors, the segmented resume protocol, and the width-polymorphic per-rank
product of the distributed handle.

Tolerances.  On this DG operator ECG amplifies rounding once it has resolved
the extreme eigenvalues, in the reference's own two backends as in the port
(ROADMAP.md queue 3), so the solves stop at 1e-6·‖b‖ and the histories are
held in two parts: entries above 1e-2·‖r₀‖ to 1e-9 relative (measured:
2e-11 at most), every entry to 50% (the tail, where the two packages' last
entries part by up to 45%).  Iteration counts, ``active_hist`` and restarts
are equal; x agrees to 1e-6 of max|x| (measured: 2.2e-7).  The last
threshold crossing can move by one block where the tail parts: at t = 4,
s = 4 with ``reorth`` and no policy the port stops after 14 blocks at
0.92·tol, the reference after 15 (1.37·tol at block 14), as the reference's
own jnp and pallas backends stop after 29 and 28 blocks at t = 4, s = 2; so
that one configuration has its own test, which holds the count to one block,
the history above 1e-2·‖r₀‖ to 1e-9 and x to 2e-6 of max|x| (measured:
9.1e-7).  Recovery events (the
safeguard's rank losses) are equal for s ≤ 2; at s = 4 the monomial basis
puts pivots at the rank threshold, where rounding decides.  With
block-Jacobi the preconditioned basis stays far from both effects: every
history entry agrees to 1e-8 relative and x to 1e-9.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.adaptive as ref_adaptive
import repro.core.methods as ref_methods
import repro.solver as ref_solver
import repro.sparse as ref_sparse
from repro.core.ecg import make_ecg_runner as ref_make_ecg_runner

import repro_torch.solver as port_solver
from repro_torch import kernels
from repro_torch.adaptive import resolve_policy
from repro_torch.core.ecg import finalize_result, make_ecg_runner
from repro_torch.core.methods import METHODS, MethodContext, MethodSpec, SStepMethod, get_method
from repro_torch.launch.mesh import VirtualMesh
from repro_torch.sparse import csr_spmbv, fd_laplace_2d
from repro_torch.sparse.csr import CSRMatrix

RTOL_SOLVE = 1e-6
MAX_ITERS = 400
SCHEMES = [("pipelined", 1, False), ("sstep", 1, False), ("sstep", 2, False), ("sstep", 4, False),
           ("sstep", 2, True), ("sstep", 4, True)]


@pytest.fixture(scope="module")
def system():
    ra = ref_sparse.dg_laplace_2d((10, 10), block=8)
    pa = CSRMatrix.from_numpy(ra.indptr, ra.indices, ra.data, ra.shape, device="cpu")
    return ra, pa


def _rhs(n, t, adaptive):
    """A random b, or (under a policy) one on the first t/2 of t contiguous
    subdomains: the split residual's other columns are exactly zero."""
    if adaptive is None:
        return np.random.default_rng(0).standard_normal(n)
    b = np.zeros(n)
    hi = ((t // 2) * n) // t
    b[:hi] = np.random.default_rng(7).standard_normal(hi)
    return b


def _solve_both(system, t, method, s, reorth, adaptive, **cfg):
    ra, pa = system
    b = _rhs(ra.shape[0], t, adaptive)
    fields = dict(t=t, tol=RTOL_SOLVE * float(np.linalg.norm(b)), max_iters=MAX_ITERS,
                  method=method, adaptive=adaptive, **cfg)
    rcfg = ref_solver.SolverConfig(**fields).replace(s=s, reorth=reorth)
    pcfg = port_solver.SolverConfig(**fields).replace(s=s, reorth=reorth)
    want = ref_solver.ECGSolver.build(ra, config=rcfg).solve(jnp.asarray(b))
    got = port_solver.ECGSolver.build(pa, config=pcfg, device="cpu").solve(b)
    return want, got


def _assert_counts_and_traces(got, want):
    assert want.converged and got.converged and not got.breakdown
    assert got.n_iters == want.n_iters
    if want.active_hist is None:
        assert got.active_hist is None
    else:
        assert np.array_equal(got.active_hist, np.asarray(want.active_hist))
        assert got.reduction_events() == want.reduction_events()
    assert got.restarts == want.restarts


def _case_ids(cases):
    return [f"t{t}-{m}-s{s}{'-reorth' if r else ''}-{a or 'fixed'}" for t, m, s, r, a in cases]


CASES = [(t, m, s, r, a) for t in (4, 8) for m, s, r in SCHEMES
         for a in (None, "reduce") + (("reduce+restart",) if m == "sstep" else ())
         if (t, m, s, r, a) != (4, "sstep", 4, True, None)]


@pytest.mark.parametrize("t,method,s,reorth,adaptive", CASES, ids=_case_ids(CASES))
def test_sequential_solve_matches_reference(system, t, method, s, reorth, adaptive):
    kernels.reset_launch_counts()
    want, got = _solve_both(system, t, method, s, reorth, adaptive, kernel="pallas")
    _assert_counts_and_traces(got, want)
    if s <= 2:
        assert got.recovery_events() == want.recovery_events()
    k = want.n_iters + 1
    hw, hg = np.asarray(want.res_hist)[:k], got.res_hist.numpy()[:k]
    early = hw >= 1e-2 * hw[0]
    np.testing.assert_allclose(hg[early], hw[early], rtol=1e-9, atol=0)
    np.testing.assert_allclose(hg, hw, rtol=0.5, atol=0)
    assert np.isnan(got.res_hist.numpy()[k:]).all()
    xw, xg = np.asarray(want.x), got.x.numpy()
    assert np.abs(xg - xw).max() <= 1e-6 * np.abs(xw).max()
    assert kernels.launch_counts() == dict.fromkeys(kernels.launch_counts(), 0)  # CPU tensors


def test_sstep_s4_reorth_t4_stops_within_one_block_of_reference(system):
    """The fixed-width case CASES leaves out (see the module docstring):
    the last threshold crossing lands one block apart, everything before it
    agrees."""
    want, got = _solve_both(system, 4, "sstep", 4, True, None, kernel="pallas")
    assert want.converged and got.converged and not got.breakdown
    assert abs(got.n_iters - want.n_iters) <= 1
    k = min(want.n_iters, got.n_iters) + 1
    hw, hg = np.asarray(want.res_hist)[:k], got.res_hist.numpy()[:k]
    early = hw >= 1e-2 * hw[0]
    np.testing.assert_allclose(hg[early], hw[early], rtol=1e-9, atol=0)
    xw, xg = np.asarray(want.x), got.x.numpy()
    assert np.abs(xg - xw).max() <= 2e-6 * np.abs(xw).max()


# pallas at t = 4 and 8; the jnp backend (CSR SpMBV; the scheme code does
# not depend on the backend) at t = 8
PREC_CASES = [(t, m, s, r, a, backend) for t in (4, 8) for m, s, r in SCHEMES
              for a in (None, "reduce") for backend in ("pallas",) + (("jnp",) if t == 8 else ())]


@pytest.mark.parametrize("t,method,s,reorth,adaptive,backend", PREC_CASES,
                         ids=[f"{i}-{c[-1]}" for i, c in zip(_case_ids([c[:5] for c in PREC_CASES]),
                                                             PREC_CASES)])
def test_block_jacobi_solve_matches_reference(system, t, method, s, reorth, adaptive, backend):
    want, got = _solve_both(system, t, method, s, reorth, adaptive, kernel=backend,
                            precondition="block_jacobi")
    _assert_counts_and_traces(got, want)
    assert got.recovery_events() == want.recovery_events()
    k = want.n_iters + 1
    np.testing.assert_allclose(got.res_hist.numpy()[:k], np.asarray(want.res_hist)[:k],
                               rtol=1e-8, atol=0)
    xw, xg = np.asarray(want.x), got.x.numpy()
    assert np.abs(xg - xw).max() <= 1e-9 * np.abs(xw).max()


# ---------------------------------------------------------------- registry
def test_registry():
    assert sorted(METHODS) == sorted(ref_methods.METHODS) == ["classic", "pipelined", "sstep"]
    for name, spec in METHODS.items():
        assert isinstance(spec, MethodSpec) and spec.name == name
        assert get_method(name) is spec
        assert spec.overlaps_gram == ref_methods.get_method(name).overlaps_gram
    with pytest.raises(ValueError, match="classic"):
        get_method("bogus")


@pytest.mark.parametrize("reorth", [False, True])
@pytest.mark.parametrize("s", [1, 2, 4])
@pytest.mark.parametrize("name", ["classic", "pipelined", "sstep"])
def test_collective_accounting_matches_reference(name, s, reorth):
    port, ref = get_method(name), ref_methods.get_method(name)
    assert port.iters_per_block(s) == ref.iters_per_block(s)
    assert port.psums_per_block(s, reorth) == ref.psums_per_block(s, reorth)
    assert port.collectives_per_iteration(s, reorth) == ref.collectives_per_iteration(s, reorth)
    for t in (1, 4, 8):
        assert port.psum_payload_floats(t, s, reorth) == ref.psum_payload_floats(t, s, reorth)


# -------------------------------------------------------------- validation
def _runner_error(make, apply, **kw):
    with pytest.raises(ValueError) as e:
        make(apply, 4, **kw)
    return str(e.value)


@pytest.mark.parametrize("kw,port_kw", [
    (dict(method="pipelined", policy=ref_adaptive.resolve_policy("reduce+restart")),
     dict(method="pipelined", policy=resolve_policy("reduce+restart"))),
    (dict(method="sstep", s=0), dict(method="sstep", s=0)),
    (dict(method="classic", s=2), dict(method="classic", s=2)),
    (dict(method="pipelined", reorth=True), dict(method="pipelined", reorth=True)),
])
def test_validation_errors_match_reference(kw, port_kw):
    """pipelined refuses a restart policy, s < 1 is refused, and s / reorth
    apply to s-step only: the same errors, word for word."""
    want = _runner_error(ref_make_ecg_runner, lambda v: v, **kw)
    got = _runner_error(make_ecg_runner, lambda v: v, **port_kw)
    assert got == want


def test_sstep_validate_refuses_s_below_one():
    ctx = MethodContext(t=4, max_iters=1, a_apply=None, split_fn=None, gram1=None, gram2=None,
                        sqnorm=None, tail=None, s=0)
    with pytest.raises(ValueError, match="s must be >= 1, got 0"):
        SStepMethod().validate(ctx)


def test_handle_threads_the_method_and_reuses_the_operator(system):
    _, pa = system
    base = port_solver.ECGSolver.build(pa, config=port_solver.SolverConfig(t=4), device="cpu")
    for method, s, reorth in (("pipelined", 1, False), ("sstep", 2, True)):
        sib = base.with_config(method=method, s=s, reorth=reorth)
        assert sib.stats.op_reused and sib._apply is base._apply
        runner = sib._runner(sib.t)
        assert (runner.method, runner.s) == (method, s)
    with pytest.raises(ValueError, match="cannot run a restart policy"):
        base.with_config(method="pipelined", adaptive="reduce+restart").solve(np.ones(pa.shape[0]))


# -------------------------------------------------------- segmented resume
@pytest.mark.parametrize("method,s", [("pipelined", 1), ("sstep", 2)])
def test_resume_matches_monolithic(system, method, s):
    """exit_below_width + a resumed run must replay the scheme's own
    monolithic adaptive solve exactly (the protocol of the width-segmented
    distributed solve; the reference's tests/test_methods.py)."""
    _, pa = system
    n = pa.shape[0]
    t, m = 8, 2
    b = np.zeros(n)
    b[: (m * n) // t] = np.random.default_rng(7).standard_normal((m * n) // t)
    b = torch.as_tensor(b)
    x0 = torch.zeros_like(b)
    apply = lambda v: csr_spmbv(pa, v)
    masked = lambda z, act: apply(z)
    policy = resolve_policy("reduce")
    common = dict(tol=1e-8, max_iters=MAX_ITERS, method=method, s=s, policy=policy)

    mono = make_ecg_runner(apply, t, **common)
    ref = finalize_result(mono.run(mono.init(b, x0)), x0=x0, t=t, tol=1e-8, policy=policy)
    assert ref.converged

    seg = make_ecg_runner(apply, t, a_apply_masked=masked, exit_below_width=t, **common)
    carry = seg.run(seg.init(b, x0))
    assert carry["rn"] > 1e-8 and carry["k"] < ref.n_iters
    n_act = int(carry["act"].sum())
    assert n_act == m
    seg2 = make_ecg_runner(apply, t, a_apply_masked=masked, exit_below_width=n_act, **common)
    out = finalize_result(seg2.run(carry), x0=x0, t=t, tol=1e-8, policy=policy)
    assert out.converged and out.n_iters == ref.n_iters
    assert np.array_equal(out.res_hist.numpy(), ref.res_hist.numpy(), equal_nan=True)
    assert torch.equal(out.x, ref.x)
    assert np.array_equal(out.active_hist, ref.active_hist)


# ------------------------------------------------ the distributed product
def test_local_product_takes_operands_of_two_widths():
    """The distributed gram1 maps (n, a)ᵀ(n, b) to the summed (a, b) for
    any widths (s-step reduces (n, 3st)ᵀ(n, st) and (n, st)ᵀ(n, t)), and
    keeps the square classic product as it was, bit for bit."""
    a = fd_laplace_2d(13, device="cpu")
    mesh = VirtualMesh(2, 4, device="cpu")
    solver = port_solver.ECGSolver.build(a, mesh, port_solver.SolverConfig(t=4, kernel="pallas"))
    op = solver.op
    rng = np.random.default_rng(3)
    mask = op.padded_mask()[:, None]
    for wa, wb in ((12, 4), (4, 12), (24, 8), (3, 1), (4, 4)):
        u = rng.standard_normal((op.n_padded, wa)) * mask
        v = rng.standard_normal((op.n_padded, wb)) * mask
        got = solver._gram1(torch.as_tensor(u), torch.as_tensor(v)).numpy()
        assert got.shape == (wa, wb)
        np.testing.assert_allclose(got, u.T @ v, rtol=1e-12, atol=1e-12 * np.abs(u.T @ v).max())
    # the square product: the per-rank chunked bmm summed in a fixed order
    p, rmax = mesh.p, op.rmax
    chunks = np.gcd(rmax, 64)
    z, az = (torch.as_tensor(rng.standard_normal((op.n_padded, 4)) * mask) for _ in range(2))
    zc, azc = (m.reshape(p * chunks, rmax // chunks, 4) for m in (z, az))
    old = torch.bmm(zc.mT, azc).reshape(p, chunks, 4, 4).sum(dim=1).sum(dim=0)
    assert torch.equal(solver._gram1(z, az), old)
