"""Port parity: the sequential solver handle, its config and its CLI."""

import re

import numpy as np
import pytest
import torch

import repro.solver as ref_solver
import repro.sparse as ref_sparse

import repro_torch.solver as port_solver
from repro_torch.launch import solve as port_cli
from repro_torch.solver import ECGSolver, SolverConfig
from repro_torch.sparse import dg_laplace_2d, fd_laplace_2d
from repro_torch.sparse.csr import CSRMatrix


def _configs(mod):
    return [
        mod.SolverConfig(),
        mod.SolverConfig(t=4, tol=1e-10, max_iters=77, kernel=mod.KernelConfig(backend="pallas", ell_block=(4, 8))),
        mod.SolverConfig(t=2, comm=mod.CommConfig(strategy="3step", overlap=True, col_split=2),
                         kernel="pallas", tune="model", adaptive="reduce+restart"),
        mod.SolverConfig(method="sstep", precondition="chebyshev").replace(s=4, degree=3, eig_bounds=(0.1, 4)),
        mod.SolverConfig(t="auto", adaptive=mod.AdaptiveConfig(policy="off", t_candidates=(2, 8))),
        mod.SolverConfig(t=8).replace(backend="pallas", ell_block=16, policy="rankrev", tol=0.5),
    ]


@pytest.mark.parametrize("i", range(len(_configs(ref_solver))))
def test_config_json_round_trip_equals_reference(i):
    want = ref_solver.config.solverconfig_to_dict(_configs(ref_solver)[i])
    port_cfg = _configs(port_solver)[i]
    assert port_solver.config.solverconfig_to_dict(port_cfg) == want
    assert SolverConfig.from_json(port_cfg.to_json()) == port_cfg
    # the reference's JSON loads into the same port config
    assert SolverConfig.from_json(_configs(ref_solver)[i].to_json()) == port_cfg


def test_config_validation_matches_reference():
    for bad in (dict(t=0), dict(tol=-1.0), dict(max_iters=0), dict(kernel="cuda")):
        with pytest.raises(ValueError):
            ref_solver.SolverConfig(**bad)
        with pytest.raises(ValueError):
            SolverConfig(**bad)
    with pytest.raises(ValueError, match="unknown config override"):
        SolverConfig().replace(nope=1)


def test_config_values_without_a_port_refuse_json():
    """A ``machine``, the values that had no JSON form in the port until the
    models were ported, now serialises to the reference's dict and loads
    back; a malformed one raises as the reference's does."""
    from repro.core.machines import LASSEN as REF_LASSEN
    from repro_torch.core.machines import LASSEN

    ref_cfg = ref_solver.SolverConfig(comm=ref_solver.CommConfig(machine=REF_LASSEN))
    d = ref_solver.config.solverconfig_to_dict(ref_cfg)
    cfg = SolverConfig(comm=port_solver.CommConfig(machine=LASSEN))
    assert port_solver.config.solverconfig_to_dict(cfg) == d
    assert SolverConfig.from_json(d) == cfg == SolverConfig.from_json(cfg.to_json())
    d["comm"]["machine"] = {"name": "x"}
    with pytest.raises(TypeError):
        ref_solver.SolverConfig.from_json(d)
    with pytest.raises(TypeError):
        SolverConfig.from_json(d)


@pytest.fixture(scope="module")
def op():
    return dg_laplace_2d((6, 6), block=4, device="cpu")


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_stats_and_runner_reuse(op, backend):
    s = ECGSolver.build(op, config=SolverConfig(t=4, kernel=port_solver.KernelConfig(backend=backend)),
                        device="cpu")
    assert (s.stats.builds, s.stats.traces, s.stats.solves) == (1, 0, 0)
    assert s.stats.conv_analyzed is (backend == "pallas")
    b = np.random.default_rng(0).standard_normal(op.shape[0])
    r1 = s.solve(b)
    r2 = s.solve(b)
    assert (s.stats.builds, s.stats.traces, s.stats.solves) == (1, 1, 2)
    assert r1.converged
    assert torch.equal(r1.x, r2.x)


def test_solve_many_bit_identical_to_solo(op):
    s = ECGSolver.build(op, config=SolverConfig(t=4, kernel="pallas"), device="cpu")
    rng = np.random.default_rng(1)
    bs = [rng.standard_normal(op.shape[0]) for _ in range(3)]
    x0s = [None, rng.standard_normal(op.shape[0]), None]
    many = s.solve_many(bs, x0s)
    for b, x0, r in zip(bs, x0s, many):
        solo = s.solve(b, x0)
        assert torch.equal(solo.x, r.x) and solo.n_iters == r.n_iters
        assert torch.equal(solo.res_hist.isnan(), r.res_hist.isnan())
        assert torch.equal(solo.res_hist.nan_to_num(), r.res_hist.nan_to_num())
    assert s.stats.traces == 1
    with pytest.raises(ValueError, match="initial guesses"):
        s.solve_many(bs, x0s[:2])


def test_with_config_reuses_operator(op):
    s = ECGSolver.build(op, config=SolverConfig(t=4, kernel="pallas"), device="cpu")
    b = np.random.default_rng(2).standard_normal(op.shape[0])
    loose = s.with_config(tol=1e-4, max_iters=500)
    assert loose.stats.op_reused and loose._apply is s._apply
    assert loose.stats.builds == 0 and loose.conversion is s.conversion
    assert loose.solve(b).n_iters < s.solve(b).n_iters
    # an operator-level override rebuilds, reusing the conversion artifacts
    wider = s.with_config(t=8)
    assert not wider.stats.op_reused and wider.stats.builds == 1
    assert wider.stats.conv_reused and not wider.stats.conv_analyzed
    assert wider.solve(b).converged
    plain = s.with_config(backend="jnp")
    assert plain.conversion is None and plain.solve(b).converged


def test_build_from_reference_conversion():
    ra = ref_sparse.dg_laplace_2d((5, 5), block=4)
    rs = ref_solver.ECGSolver.build(ra, config=ref_solver.SolverConfig(t=4, kernel="pallas"))
    arrays = {k: (np.asarray(v) if k in ("blocks", "indices") else v)
              for k, v in rs.conversion["arrays"].items()}
    pa = CSRMatrix.from_numpy(ra.indptr, ra.indices, ra.data, ra.shape, device="cpu")
    s = ECGSolver.build(pa, config=SolverConfig(t=4, kernel="pallas"),
                        conversion={"arrays": arrays}, device="cpu")
    assert s.stats.conv_reused and not s.stats.conv_analyzed
    b = np.random.default_rng(3).standard_normal(ra.shape[0])
    cold = ECGSolver.build(pa, config=SolverConfig(t=4, kernel="pallas"), device="cpu")
    assert torch.equal(s.solve(b).x, cold.solve(b).x)


@pytest.mark.parametrize("overrides,item", [
    (dict(t="auto"), "queue 1 item 6b"),
    (dict(tune="model"), "queue 1 item 9"),
    # every scheme and preconditioner runs (tests/test_torch_methods.py);
    # composed with an option not ported yet they still raise
    (dict(method="sstep", precondition="block_jacobi", tune="model"), "queue 1 item 9"),
    (dict(method="pipelined", t="auto"), "queue 1 item 6b"),
    (dict(method="sstep", tune="model:structural"), "queue 1 item 9"),
])
def test_options_not_ported_raise(op, overrides, item):
    """The options that raised until their ROADMAP.md ``item`` was ported
    (``t="auto"``, tuning) now build and solve; a ``t="auto"`` handle
    records its selection and runs at the chosen width."""
    s = ECGSolver.build(op, config=SolverConfig(**overrides), device="cpu")
    res = s.solve(np.random.default_rng(4).standard_normal(op.shape[0]))
    assert res.converged
    if overrides.get("t") == "auto":
        assert res.selection is s.selection and res.t == s.t == s.selection.t
        assert s.policy is not None  # auto-t implies rankrev


@pytest.mark.parametrize("adaptive", ["rankrev", "reduce", "reduce+restart"])
def test_adaptive_policy_builds_and_solves(op, adaptive):
    """An adaptive policy runs (it raised before the controller was ported):
    the handle builds, solves and records the width trace."""
    s = ECGSolver.build(op, config=SolverConfig(t=4, adaptive=adaptive), device="cpu")
    res = s.solve(np.random.default_rng(4).standard_normal(op.shape[0]))
    assert res.converged and s.policy is not None and res.active_hist[0] == 4


def test_mesh_and_solve_packed_not_ported(op):
    with pytest.raises(NotImplementedError, match="queue 1 item 5"):
        ECGSolver.build(op, mesh=object(), device="cpu")
    s = ECGSolver.build(op, device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        s.solve_packed([np.ones(op.shape[0])])
    # a method change reuses the operator (it raised before the schemes
    # were ported)
    sib = s.with_config(method="sstep", s=2)
    assert sib.stats.op_reused and sib._apply is s._apply


def test_build_without_device_needs_cuda(op, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ECGSolver.build(op)


def test_unshard_is_host_copy(op):
    s = ECGSolver.build(op, device="cpu")
    res = s.solve(np.ones(op.shape[0]))
    x = s.unshard(res.x)
    assert isinstance(x, np.ndarray) and x.shape == (op.shape[0],)


def test_float32_operator_with_float64_rhs_promotes():
    a32 = fd_laplace_2d(8, dtype=torch.float32, device="cpu")
    s = ECGSolver.build(a32, config=SolverConfig(t=2, kernel="pallas"), device="cpu")
    res = s.solve(np.random.default_rng(5).standard_normal(a32.shape[0]))
    assert res.x.dtype == torch.float64 and res.converged


SUMMARY = re.compile(
    r"^sequential ECG\[classic/(jnp|pallas)\] t=4: iters=(\d+) converged=True [\d.]+s$", re.M
)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_cli_summary_line(capsys, backend):
    port_cli.main(["--matrix", "dg", "--elements", "4", "--block", "4", "--t", "4",
                   "--backend", backend, "--strategy", "sequential", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "matrix: 64 rows" in out and "method: classic (2 psums/iter)" in out
    m = SUMMARY.search(out)
    assert m and m.group(1) == backend and int(m.group(2)) > 0
    assert re.search(r"^reference CG:  iters=\d+$", out, re.M)


def test_cli_refuses_distributed_run():
    """A distributed run whose ranks do not fill whole nodes is refused (the
    default tuned run itself now runs: tests/test_torch_tune.py)."""
    with pytest.raises(SystemExit):
        port_cli.main(["--devices", "8", "--ppn", "3", "--device", "cpu"])
