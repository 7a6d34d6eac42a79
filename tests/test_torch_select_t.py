"""Port parity: ``t="auto"`` — the enlarging factor chosen at setup
(repro_torch.adaptive.select_t vs repro.adaptive.select_t), on the CPU,
after the reference's ``tests/test_adaptive.py`` (``TestSelectT``).

The system is the reference test's: ``fd_laplace_2d(16)`` (256 rows) with a
seeded Gaussian right-hand side, built by the reference and handed to the
port as numpy arrays; every machine is passed explicitly (the port's tuner
defaults to the H100's measured set, the reference's to its TPU-v5e set).
Compared:

* ``select_t`` in ``"probe"`` mode (sequentially, and with the cost of a
  2 × 4 mesh under the structural model) and in ``"kappa"`` mode: the
  chosen t, the candidates and ``probe_iters_used`` exactly, and
  ``est_iters`` equal; each candidate's fitted rate, average active width,
  per-iteration and total cost to 1e-9 relative (the probes are real ECG
  iterations, summed in another order by each package);
* the ``TSelection`` JSON: the port's round-trips, and the reference's loads
  into the port's with the same fields;
* ``t="auto"`` handles, sequential and on ``VirtualMesh(2, 4)`` (the
  reference's side in a subprocess with 8 forced host devices): the same
  t, the same tuner config, the same iterations and the same
  ``active_hist``;
* the explicit ``adaptive="off"`` case and the reference's errors.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
TOL, MAX_ITERS = 1e-8, 2000
DIST = dict(n_nodes=2, ppn=4, tune_mode="model:structural")


def _ref_system():
    import repro.sparse as ref_sparse

    a = ref_sparse.fd_laplace_2d(16)
    return a, np.random.default_rng(0).standard_normal(a.shape[0])


def _port(ra):
    from repro_torch.sparse.csr import CSRMatrix

    return CSRMatrix.from_numpy(ra.indptr, ra.indices, ra.data, ra.shape, device="cpu")


# ----------------------------------------------------------- reference side
def _reference_results(out_path):
    """Runs in the subprocess: the reference's distributed t="auto" solve."""
    import jax

    jax.config.update("jax_enable_x64", True)
    from repro.core.machines import TPU_V5E_POD
    from repro.solver import CommConfig, ECGSolver, SolverConfig

    mesh = jax.make_mesh((2, 4), ("node", "proc"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
    a, b = _ref_system()
    cfg = SolverConfig(t="auto", tol=TOL, max_iters=MAX_ITERS, kernel="pallas",
                       comm=CommConfig(machine=TPU_V5E_POD))
    solver = ECGSolver.build(a, mesh, cfg, b=b)
    res = solver.solve(b)
    tuned = solver.tuned
    np.savez(out_path, t=res.t, n_iters=res.n_iters, active_hist=np.asarray(res.active_hist),
             tuned=json.dumps([tuned.strategy, tuned.br, tuned.bc, tuned.overlap]),
             selection=solver.selection.to_json())


# ---------------------------------------------------------------- port side
@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("select_t_ref") / "reference.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, __file__, str(path)], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, f"STDOUT:\n{proc.stdout}\nSTDERR:\n{proc.stderr[-4000:]}"
    return dict(np.load(path))


@pytest.fixture(scope="module")
def system():
    from repro.core.machines import TPU_V5E_POD as RM

    from repro_torch.core.machines import TPU_V5E_POD as M

    ra, b = _ref_system()
    return ra, _port(ra), b, M, RM


@pytest.fixture(scope="module")
def selections(system):
    """(port, reference) selections: probe sequential, probe with the mesh's
    cost, kappa."""
    from repro.adaptive import select_t as ref_select_t

    from repro_torch.adaptive import select_t

    ra, a, b, m, rm = system
    out = {}
    for key, kw in (("probe", dict(tol=TOL)), ("probe_dist", dict(tol=TOL, **DIST)),
                    ("kappa", dict(candidates=(1, 4, 16), mode="kappa"))):
        out[key] = (select_t(a, b, machine=m, **kw), ref_select_t(ra, b, machine=rm, **kw))
    return out


def _assert_selection_equal(sel, want):
    assert (sel.t, sel.candidates, sel.mode, sel.tol, sel.probe_iters) == (
        want.t, want.candidates, want.mode, want.tol, want.probe_iters)
    assert sel.probe_iters_used == want.probe_iters_used
    assert sel.table.keys() == want.table.keys()
    for t, row in want.table.items():
        got = sel.table[t]
        assert got.keys() == row.keys() and got["est_iters"] == row["est_iters"], t
        for k in ("rate", "avg_active", "iter_cost_s", "total_cost_s"):
            assert got[k] == pytest.approx(row[k], rel=1e-9, abs=0.0), (t, k)
    assert sel.configs.keys() == want.configs.keys()
    for t, cfg in want.configs.items():
        got = sel.configs[t]
        assert (got.strategy, got.ell_block, got.kmax, got.overlap, got.col_split) == (
            cfg.strategy, cfg.ell_block, cfg.kmax, cfg.overlap, cfg.col_split)


@pytest.mark.parametrize("key", ["probe", "probe_dist", "kappa"])
def test_select_t_equals_reference(selections, key):
    sel, want = selections[key]
    _assert_selection_equal(sel, want)
    costs = {t: row["total_cost_s"] for t, row in sel.table.items()}
    assert sel.t == min(costs, key=costs.get) and "chosen" in sel.summary()
    if key == "kappa":
        assert sel.probe_iters_used == {} and sel.probe_iters == 0


def test_tselection_json(selections):
    from repro_torch.adaptive import TSelection

    sel, want = selections["probe_dist"]
    back = TSelection.from_json(sel.to_json())
    assert back == sel and back.configs.keys() == sel.configs.keys()
    assert json.loads(back.to_json()) == json.loads(sel.to_json())
    # the reference's JSON loads into a port selection with its values
    loaded = TSelection.from_json(want.to_json())
    assert loaded.t == want.t and loaded.table == want.table
    assert loaded.probe_iters_used == want.probe_iters_used
    _assert_selection_equal(loaded, want)
    d = json.loads(sel.to_json())
    assert d.keys() == json.loads(want.to_json()).keys()


def test_auto_t_sequential_handle_matches_reference(system):
    import repro.solver as ref_solver

    from repro_torch.solver import CommConfig, ECGSolver, SolverConfig

    ra, a, b, m, rm = system
    kw = dict(t="auto", tol=TOL, max_iters=MAX_ITERS, kernel="pallas")
    ref = ref_solver.ECGSolver.build(ra, config=ref_solver.SolverConfig(
        comm=ref_solver.CommConfig(machine=rm), **kw), b=b)
    port = ECGSolver.build(a, config=SolverConfig(comm=CommConfig(machine=m), **kw), b=b,
                           device="cpu")
    assert port.t == ref.t and port.tuned.ell_block == ref.tuned.ell_block
    assert port.tuned is port.selection.configs[port.t]
    rres, res = ref.solve(b), port.solve(b)
    assert res.converged and res.n_iters == rres.n_iters and res.t == rres.t
    np.testing.assert_array_equal(res.active_hist, np.asarray(rres.active_hist))
    assert res.selection is port.selection
    # a solve-level override keeps the selection; a new tolerance re-runs it
    sib = port.with_config(max_iters=MAX_ITERS + 1)
    assert sib.stats.op_reused and sib.selection is port.selection and sib.policy is port.policy
    again = port.with_config(tol=TOL * 10)
    assert not again.stats.op_reused and again.selection is not port.selection
    assert again.selection.tol == TOL * 10


def test_auto_t_distributed_handle_matches_reference(reference, system):
    from repro_torch.launch.mesh import VirtualMesh
    from repro_torch.solver import CommConfig, ECGSolver, SolverConfig

    _, a, b, m, _ = system
    cfg = SolverConfig(t="auto", tol=TOL, max_iters=MAX_ITERS, kernel="pallas",
                       comm=CommConfig(machine=m))
    solver = ECGSolver.build(a, VirtualMesh(2, 4, device="cpu"), cfg, b=b)
    res = solver.solve(b)
    assert solver.t == res.t == int(reference["t"])
    tuned = solver.tuned
    assert [tuned.strategy, tuned.br, tuned.bc, tuned.overlap] == json.loads(str(reference["tuned"]))
    assert tuned.selection is solver.selection and solver.op.plan.strategy == tuned.strategy
    assert res.converged and res.n_iters == int(reference["n_iters"])
    np.testing.assert_array_equal(res.active_hist, reference["active_hist"])
    from repro_torch.adaptive import TSelection

    want = TSelection.from_json(str(reference["selection"]))
    assert solver.selection.probe_iters_used == want.probe_iters_used


def test_explicit_off_and_errors_match_reference(system, selections):
    import repro.solver as ref_solver
    from repro.adaptive import resolve_auto_t as ref_resolve
    from repro.adaptive import select_t as ref_select_t

    from repro_torch.adaptive import resolve_auto_t, select_t
    from repro_torch.solver import CommConfig, ECGSolver, SolverConfig

    ra, a, b, m, rm = system
    # t="auto" implies rankrev, but an explicit "off" keeps the bare
    # Cholesky (no width trace)
    port = ECGSolver.build(a, config=SolverConfig(t="auto", tol=TOL, max_iters=MAX_ITERS,
                                                  adaptive="off", comm=CommConfig(machine=m)),
                           b=b, device="cpu")
    res = port.solve(b)
    ref = ref_solver.ECGSolver.build(ra, config=ref_solver.SolverConfig(
        t="auto", tol=TOL, max_iters=MAX_ITERS, adaptive="off",
        comm=ref_solver.CommConfig(machine=rm)), b=b).solve(b)
    assert res.converged and res.active_hist is None and port.policy is None
    assert ref.active_hist is None and res.t == ref.t and res.n_iters == ref.n_iters
    # a precomputed selection is used as it is
    sel, _ = selections["probe"]
    pre = ECGSolver.build(a, config=SolverConfig(t="auto", tol=TOL, adaptive=dict(select=sel),
                                                 comm=CommConfig(machine=m)), device="cpu")
    assert pre.selection is sel and pre.t == sel.t
    for resolve, mat in ((resolve_auto_t, a), (ref_resolve, ra)):
        with pytest.raises(ValueError, match="matrix="):
            resolve("auto", None)
        with pytest.raises(ValueError, match="'auto'"):
            resolve("bogus", None, a=mat)
    for fn, mat in ((select_t, a), (ref_select_t, ra)):
        with pytest.raises(ValueError, match="unknown selection mode"):
            fn(mat, b, mode="bogus")
        with pytest.raises(ValueError, match="needs the right-hand side"):
            fn(mat, None, mode="probe")
        with pytest.raises(ValueError, match="no valid candidates"):
            fn(mat, b, candidates=(0, 10**6))


if __name__ == "__main__":
    _reference_results(sys.argv[1])
