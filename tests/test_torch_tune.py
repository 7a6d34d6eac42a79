"""Port parity: the setup-time autotuner (repro_torch.tune vs repro.tune), on
the CPU, after the reference's ``tests/test_tune.py``.

The operator is the reference test's ``dg_laplace_2d((16, 12), block=8)``
over 8 ranks (2 nodes of 4), built by the reference and handed to the port
as numpy arrays.  Every machine is passed explicitly (the port's tuner
defaults to the H100's measured set, the reference's to its TPU-v5e set).
Compared:

* ``tune`` in ``"model"`` and ``"model:structural"`` for ``BLUE_WATERS``,
  ``LASSEN``, ``TPU_V5E_POD`` and ``HOST`` at t ∈ {4, 8}: strategy, tile,
  kmax, overlap and col_split exactly, every ``predicted`` time to rtol
  1e-12, and ``to_json`` parsed equal to the reference's (the models are
  the reference's formulas in its order of operations, so the floats come
  out equal); ``from_json`` round-trips in the port;
* ``tile_stats`` for every tile of ``DEFAULT_TILES``, exactly;
* ``rank_methods``' table, to rtol 1e-12;
* tuned handles, sequential (``backend="pallas"``: the tuner picks the tile)
  and on ``VirtualMesh(2, 4)`` (the reference's side in a subprocess with 8
  forced host devices, as ``tests/test_torch_distributed.py``): the same
  applied config and iteration count, ``res_hist`` within 1e-10 relative
  (plus 1e-15·‖r₀‖).  These solve ``dg_laplace_2d((8, 8), block=2)`` to
  1e-6·‖b‖: on the (16, 12)-element, block-8 operator the two packages'
  histories part by up to 9% once ECG amplifies their different summation
  orders (ROADMAP.md, "Behaviours the port copies"), on this one they agree
  to ~2e-11;
* ``tune(mode="measure")`` on the CPU virtual mesh returns a config from
  its own measured grid (the times themselves are the host's and are not
  compared), and ``measure_dispatch_overhead`` a positive float;
* the error paths, and the CLI's tuned runs: the tile and strategy the port
  CLI prints equal the reference tuner's for the same machine (the
  reference CLI tunes with its TPU-v5e set sequentially and with
  ``TPU_V5E_POD.with_ppn(ppn)`` on a mesh; the port CLI with the H100 set
  sequentially and the same TPU-v5e set on a mesh).
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
MACHINES = ("BLUE_WATERS", "LASSEN", "TPU_V5E_POD", "HOST")
MODES = ("model", "model:structural")
T_SOLVE, MAX_ITERS = 4, 400
DIST_TUNES = (("model", "TPU_V5E_POD"), ("model:structural", "HOST"))


def _ref_operator():
    import repro.sparse as ref_sparse

    return ref_sparse.dg_laplace_2d((16, 12), block=8)


def _solve_operator():
    import repro.sparse as ref_sparse

    return ref_sparse.dg_laplace_2d((8, 8), block=2)


def _port(ra):
    from repro_torch.sparse.csr import CSRMatrix

    return CSRMatrix.from_numpy(ra.indptr, ra.indices, ra.data, ra.shape, device="cpu")


def _rhs(n):
    return np.random.default_rng(n).standard_normal(n)


def _tol(b):
    return 1e-6 * float(np.linalg.norm(b))


def _tuned_fields(cfg):
    return (cfg.strategy, cfg.br, cfg.bc, cfg.kmax, cfg.overlap, cfg.col_split, cfg.mode)


# ----------------------------------------------------------- reference side
def _reference_results(out_path):
    """Runs in the subprocess: the reference's tuned distributed solves."""
    import jax

    jax.config.update("jax_enable_x64", True)
    import repro.core.machines as machines
    from repro.solver import CommConfig, ECGSolver, SolverConfig

    mesh = jax.make_mesh((2, 4), ("node", "proc"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
    a = _solve_operator()
    b = _rhs(a.shape[0])
    out = {}
    for mode, machine in DIST_TUNES:
        cfg = SolverConfig(t=T_SOLVE, tol=_tol(b), max_iters=MAX_ITERS, kernel="pallas", tune=mode,
                           comm=CommConfig(machine=getattr(machines, machine)))
        solver = ECGSolver.build(a, mesh, cfg)
        res = solver.solve(b)
        key = f"dist/{mode}"
        out[key + "/tuned"] = np.asarray(json.dumps(_tuned_fields(solver.tuned)))
        out[key + "/n_iters"] = np.asarray(res.n_iters)
        out[key + "/res_hist"] = np.asarray(res.res_hist)
    np.savez(out_path, **out)


# ---------------------------------------------------------------- port side
@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("tune_ref") / "reference.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, __file__, str(path)], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, f"STDOUT:\n{proc.stdout}\nSTDERR:\n{proc.stderr[-4000:]}"
    return dict(np.load(path))


@pytest.fixture(scope="module")
def dg():
    """(reference matrix, reference partition, port matrix, port partition)."""
    import repro.sparse as ref_sparse

    from repro_torch.sparse import partition_csr

    ra = _ref_operator()
    a = _port(ra)
    return ra, ref_sparse.partition_csr(ra, 8), a, partition_csr(a, 8)


def _machines(name):
    import repro.core.machines as ref_machines

    import repro_torch.core.machines as port_machines

    return getattr(port_machines, name), getattr(ref_machines, name)


def _assert_close_tree(got, want, path=""):
    """Nested dicts of floats: same keys, values to rtol 1e-12."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            _assert_close_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=1e-12, abs=0.0), path
    else:
        assert got == want, path


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("t", [4, 8])
@pytest.mark.parametrize("machine", MACHINES)
def test_tune_equals_reference(dg, machine, t, mode):
    from repro.tune import tune as ref_tune

    from repro_torch.tune import TunedConfig, tune

    ra, rpm, a, pm = dg
    m, rm = _machines(machine)
    cfg = tune(a, t=t, machine=m, n_nodes=2, ppn=4, pm=pm, mode=mode)
    want = ref_tune(ra, t=t, machine=rm, n_nodes=2, ppn=4, pm=rpm, mode=mode)
    assert _tuned_fields(cfg) == _tuned_fields(want)
    assert (cfg.backend, cfg.t) == (want.backend, want.t)
    assert dataclasses.asdict(cfg.machine) == dataclasses.asdict(want.machine)
    _assert_close_tree(cfg.predicted, want.predicted)
    assert json.loads(cfg.to_json()) == json.loads(want.to_json())
    back = TunedConfig.from_json(cfg.to_json())
    assert back == cfg and back.machine == cfg.machine and back.predicted == json.loads(
        cfg.to_json())["predicted"]
    # the reference's JSON loads into the port's config
    assert TunedConfig.from_json(want.to_json()) == cfg


@pytest.mark.parametrize("tile", [(4, 4), (8, 8), (16, 16), (8, 16), (16, 8), (32, 32)])
def test_tile_stats_equal_reference(dg, tile):
    from repro.tune import DEFAULT_TILES as REF_TILES
    from repro.tune import tile_stats as ref_tile_stats

    from repro_torch.tune import DEFAULT_TILES, tile_stats

    ra, rpm, a, pm = dg
    assert DEFAULT_TILES == REF_TILES and tile in DEFAULT_TILES
    got, want = tile_stats(pm, *tile), ref_tile_stats(rpm, *tile)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.stored, got.fill) == (want.stored, want.fill)
    assert tile_stats(pm, *tile) is got  # cached on the partition


@pytest.mark.parametrize("machine", MACHINES)
def test_rank_methods_equal_reference(dg, machine):
    from repro.tune import rank_methods as ref_rank

    from repro_torch.tune import rank_methods

    ra, rpm, a, pm = dg
    m, rm = _machines(machine)
    for kw in (dict(), dict(s=4, reorth=True, backend="pallas", mode="model")):
        best, table = rank_methods(a, 8, machine=m, n_nodes=2, ppn=4, pm=pm, **kw)
        rbest, rtable = ref_rank(ra, 8, machine=rm, n_nodes=2, ppn=4, pm=rpm, **kw)
        assert best == rbest
        _assert_close_tree(table, rtable)


def test_tuned_sequential_handle_matches_reference():
    import repro.solver as ref_solver

    from repro_torch.solver import CommConfig, ECGSolver, SolverConfig

    ra = _solve_operator()
    a = _port(ra)
    b = _rhs(a.shape[0])
    m, rm = _machines("TPU_V5E_POD")
    kw = dict(t=T_SOLVE, tol=_tol(b), max_iters=MAX_ITERS, kernel="pallas", tune="model")
    ref = ref_solver.ECGSolver.build(ra, config=ref_solver.SolverConfig(
        comm=ref_solver.CommConfig(machine=rm), **kw))
    port = ECGSolver.build(a, config=SolverConfig(comm=CommConfig(machine=m), **kw), device="cpu")
    assert _tuned_fields(port.tuned) == _tuned_fields(ref.tuned)
    assert port.conversion["arrays"]["br"] == ref.tuned.br
    rres, res = ref.solve(b), port.solve(b)
    assert res.converged and res.n_iters == rres.n_iters
    want = np.asarray(rres.res_hist)[: rres.n_iters + 1]
    got = res.res_hist.numpy()[: res.n_iters + 1]
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-15 * want[0])
    # a solve-level override reuses the tuned operator
    sib = port.with_config(tol=_tol(b) / 10)
    assert sib.stats.op_reused and sib.tuned is port.tuned


@pytest.mark.parametrize("mode,machine", DIST_TUNES)
def test_tuned_distributed_handle_matches_reference(reference, mode, machine):
    from repro_torch.launch.mesh import VirtualMesh
    from repro_torch.solver import CommConfig, ECGSolver, SolverConfig

    a = _port(_solve_operator())
    b = _rhs(a.shape[0])
    m, _ = _machines(machine)
    cfg = SolverConfig(t=T_SOLVE, tol=_tol(b), max_iters=MAX_ITERS, kernel="pallas", tune=mode,
                       comm=CommConfig(machine=m))
    solver = ECGSolver.build(a, VirtualMesh(2, 4, device="cpu"), cfg)
    key = f"dist/{mode}"
    assert list(_tuned_fields(solver.tuned)) == json.loads(str(reference[key + "/tuned"]))
    assert solver.op.plan.strategy == solver.tuned.strategy
    assert solver.op.overlap == solver.tuned.overlap and solver.op.plan.col_split == solver.tuned.col_split
    res = solver.solve(b)
    assert res.converged and res.n_iters == int(reference[key + "/n_iters"])
    want = reference[key + "/res_hist"][: res.n_iters + 1]
    np.testing.assert_allclose(res.res_hist.numpy()[: res.n_iters + 1], want, rtol=1e-10,
                               atol=1e-15 * want[0])
    # the applied config, loaded back from JSON, rebuilds the same operator
    from repro_torch.tune import TunedConfig

    again = ECGSolver.build(a, VirtualMesh(2, 4, device="cpu"), cfg.replace(
        tuned=TunedConfig.from_json(solver.tuned.to_json())), pm=solver.partition)
    assert _tuned_fields(again.tuned) == _tuned_fields(solver.tuned)
    assert again.op.plan.wire_bytes(8) == solver.op.plan.wire_bytes(8)


def test_measure_mode_on_the_cpu_mesh(dg):
    from repro_torch.core.models import STRATEGIES
    from repro_torch.launch.mesh import VirtualMesh
    from repro_torch.tune import DEFAULT_TILES, measure_dispatch_overhead, tune

    _, _, a, pm = dg
    mesh = VirtualMesh(2, 4, device="cpu")
    cfg = tune(a, t=4, mesh=mesh, pm=pm, mode="measure")
    grid = cfg.predicted["measured_us"]
    key = f"{cfg.strategy}/{cfg.br}x{cfg.bc}/{'overlap' if cfg.overlap else 'blocking'}"
    assert cfg.mode == "measure" and key in grid and all(v > 0 for v in grid.values())
    # coordinate descent: 4 strategies, then the tiles, then overlap
    assert len(grid) == len(STRATEGIES) + len(DEFAULT_TILES) - 1 + 1
    assert cfg.strategy == min(STRATEGIES, key=lambda s: grid[f"{s}/8x8/blocking"])
    assert (cfg.br, cfg.bc) == min(DEFAULT_TILES, key=lambda tl: grid[f"{cfg.strategy}/{tl[0]}x{tl[1]}/blocking"])
    overhead = measure_dispatch_overhead(mesh)
    assert isinstance(overhead, float) and overhead > 0


def test_error_paths_match_reference(dg):
    import repro.solver as ref_solver
    from repro.tune import tune as ref_tune

    from repro_torch.solver import ECGSolver, SolverConfig
    from repro_torch.tune import tune

    ra, rpm, a, pm = dg
    for fn, mat, part in ((tune, a, pm), (ref_tune, ra, rpm)):
        with pytest.raises(ValueError, match="unknown tune mode"):
            fn(mat, t=4, n_nodes=2, ppn=4, pm=part, mode="bogus")
        with pytest.raises(ValueError, match="needs a mesh or explicit"):
            fn(mat, t=4)
        with pytest.raises(ValueError, match="needs a mesh to time on"):
            fn(mat, t=4, n_nodes=2, ppn=4, pm=part, mode="measure")
    msg = 'tune mode "measure" times candidate operators on a device mesh'
    with pytest.raises(ValueError, match=msg):
        ref_solver.ECGSolver.build(ra, config=ref_solver.SolverConfig(kernel="pallas", tune="measure"))
    with pytest.raises(ValueError, match=msg):
        ECGSolver.build(a, config=SolverConfig(kernel="pallas", tune="measure"), device="cpu")


def _cli(capsys, *flags):
    from repro_torch.launch import solve as port_cli

    port_cli.main(["--device", "cpu", "--elements", "4", "--t", "4", *flags])
    return capsys.readouterr().out


def test_cli_defaults_tune(capsys):
    """The CLI's defaults (``--strategy tuned``, hence ``--tune model``)
    run: with ``--backend jnp`` sequential tuning does nothing (the
    reference ignores it too); with ``--backend pallas`` the tuner picks the
    tile, with the H100 set, as the reference tuner picks it with the same
    constants; on a mesh (TPU-v5e set, as the reference CLI) the strategy
    and tile equal the reference tuner's."""
    import repro.core.machines as ref_machines
    import repro.sparse as ref_sparse
    from repro.tune import tune as ref_tune

    import repro_torch.core.machines as port_machines

    ra = ref_sparse.dg_laplace_2d((4, 4), block=16)
    out = _cli(capsys)
    assert "tuned" not in out and re.search(r"^sequential ECG\[classic/jnp\] t=4: iters=\d+ converged=True",
                                            out, re.M)
    out = _cli(capsys, "--backend", "pallas")
    h100 = ref_machines.MachineParams(**dataclasses.asdict(port_machines.H100))
    want = ref_tune(ra, t=4, machine=h100, n_nodes=1, ppn=1, backend="pallas")
    assert f"tuned tile: {want.ell_block} kmax={want.kmax}\n" in out
    assert re.search(r"^sequential ECG\[classic/pallas\] t=4: iters=\d+ converged=True", out, re.M)
    out = _cli(capsys, "--devices", "8", "--strategy", "tuned", "--tune", "model:structural")
    want = ref_tune(ra, t=4, machine=ref_machines.TPU_V5E_POD.with_ppn(4), n_nodes=2, ppn=4,
                    backend="jnp", mode="model:structural")
    assert (f"tuned[model:structural]: strategy={want.strategy} tile={want.ell_block} "
            f"kmax={want.kmax} overlap={want.overlap} col_split={want.col_split}\n") in out
    assert re.search(rf"^distributed ECG\[classic/{want.strategy}/jnp\] t=4 on 8 devices: "
                     r"iters=\d+ converged=True", out, re.M)
    out = _cli(capsys, "--devices", "8", "--tune", "measure")
    assert re.search(r"^tuned\[measure\]: strategy=\w+", out, re.M) and "converged=True" in out


if __name__ == "__main__":
    _reference_results(sys.argv[1])
