"""Port parity: the distributed node-aware ECG solve on a virtual (2, 4) mesh.

The reference's distributed path needs 8 devices, so its side runs as this
file executed as a script, in a subprocess with 8 forced host devices (as
``tests/test_distributed.py`` runs ``tests/dist_worker.py``); it writes its
results to an ``.npz``.  The port runs all 8 ranks on a
``VirtualMesh(2, 4, device="cpu")`` in the test process.  Inputs are made
from seeds with numpy on both sides.  Compared:

(a) ``DistributedSpMBV`` applies on random (n, t) blocks, unsharded, for
    every strategy and both backends: 1e-12 relative to max|W| in float64
    (only the summation order differs);
(b) whole solves ``ECGSolver.build(a, mesh, cfg).solve(b)`` on
    ``fd_laplace_2d(13)`` (169 rows, uneven over 8 ranks) to 1e-8·‖b‖:
    equal ``n_iters``, ``res_hist`` within 1e-9 relative, x within 1e-9 of
    max|x|; on ``dg_laplace_2d((8, 8), block=2)`` to 1e-6·‖b‖ (ROADMAP.md
    queue 3 says why DG solves stop early);
(c) the port's distributed solve against its sequential solve;
(d) the mesh counters that stand in for the reference's lowered
    collective counts (``tests/dist_worker.py``).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
STRATEGIES = ["standard", "2step", "3step", "optimal"]
SOLVES = [(s, "pallas") for s in STRATEGIES] + [("3step", "jnp")]
T_APPLY, T_SOLVE = 3, 4
MAX_ITERS = 500


def _ref_operators(sparse):
    # dg: applies; dg2: the DG solve, on the operator whose sequential
    # histories tests/test_torch_ecg.py holds to the reference
    return {"fd": sparse.fd_laplace_2d(13), "dg": sparse.dg_laplace_2d((8, 6), block=4),
            "dg2": sparse.dg_laplace_2d((8, 8), block=2)}


def _rhs(n):
    return np.random.default_rng(n).standard_normal(n)


def _block(n, t):
    return np.random.default_rng(100 + n).standard_normal((n, t))


def _tol(name, b):
    return (1e-6 if name.startswith("dg") else 1e-8) * float(np.linalg.norm(b))


# ----------------------------------------------------------- reference side
def _reference_results(out_path):
    """Runs in the subprocess: the reference's applies and solves."""
    import jax

    jax.config.update("jax_enable_x64", True)
    import repro.sparse as ref_sparse
    from repro.core.machines import BLUE_WATERS
    from repro.solver import CommConfig, ECGSolver, SolverConfig
    from repro.sparse.spmbv import _make_distributed_spmbv

    # Auto axes: on an Explicit-axis mesh this JAX version's sharding types
    # refuse the reference's row-sharded triangular solves
    mesh = jax.make_mesh((2, 4), ("node", "proc"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
    out = {}
    for name, a in _ref_operators(ref_sparse).items():
        n = a.shape[0]
        v = _block(n, T_APPLY)
        for strategy in STRATEGIES if name != "dg2" else []:
            for backend in ("jnp", "pallas"):
                op = _make_distributed_spmbv(a, mesh, strategy, t=T_APPLY, machine=BLUE_WATERS,
                                             backend=backend)
                w = op.unshard(jax.jit(op.matvec_fn())(op.shard_vector(v)))
                out[f"apply/{name}/{strategy}/{backend}"] = w
        b = _rhs(n)
        solves = {"fd": SOLVES, "dg2": [("optimal", "pallas")]}.get(name, [])
        for strategy, backend in solves:
            cfg = SolverConfig(t=T_SOLVE, tol=_tol(name, b), max_iters=MAX_ITERS,
                               comm=CommConfig(strategy=strategy, machine=BLUE_WATERS),
                               kernel=backend)
            solver = ECGSolver.build(a, mesh, cfg)
            res = solver.solve(b)
            key = f"solve/{name}/{strategy}/{backend}"
            out[key + "/n_iters"] = np.asarray(res.n_iters)
            out[key + "/res_hist"] = np.asarray(res.res_hist)
            out[key + "/x"] = solver.unshard(res.x)
    np.savez(out_path, **out)


# ---------------------------------------------------------------- port side
@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("dist_ref") / "reference.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, __file__, str(path)], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, f"STDOUT:\n{proc.stdout}\nSTDERR:\n{proc.stderr[-4000:]}"
    return dict(np.load(path))


@pytest.fixture(scope="module")
def operators():
    import repro.sparse as ref_sparse

    from repro_torch.sparse.csr import CSRMatrix

    return {
        name: CSRMatrix.from_numpy(a.indptr, a.indices, a.data, a.shape, device="cpu")
        for name, a in _ref_operators(ref_sparse).items()
    }


def _mesh():
    from repro_torch.launch.mesh import VirtualMesh

    return VirtualMesh(2, 4, device="cpu")


def _config(name, b, strategy, backend, **comm):
    from repro_torch.core.machines import BLUE_WATERS
    from repro_torch.solver import CommConfig, SolverConfig

    return SolverConfig(t=T_SOLVE, tol=_tol(name, b), max_iters=MAX_ITERS,
                        comm=CommConfig(strategy=strategy, machine=BLUE_WATERS, **comm),
                        kernel=backend)


def _assert_hist_close(got, want):
    """1e-9 relative per entry; entries within 1e-15·‖r₀‖ (a few ulps of the
    initial residual norm, the rounding floor of every later entry) pass too."""
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-15 * want[0])


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("name", ["fd", "dg"])
def test_spmbv_apply_matches_reference(reference, operators, name, strategy, backend):
    from repro_torch.core.machines import BLUE_WATERS
    from repro_torch.sparse.spmbv import _make_distributed_spmbv

    a = operators[name]
    mesh = _mesh()
    op = _make_distributed_spmbv(a, mesh, strategy, t=T_APPLY, machine=BLUE_WATERS, backend=backend)
    v = _block(a.shape[0], T_APPLY)
    mesh.reset_counters()
    w = op.unshard(op.matvec_fn()(op.shard_vector(v)))
    want = reference[f"apply/{name}/{strategy}/{backend}"]
    assert np.abs(w - want).max() <= 1e-12 * np.abs(want).max()
    # (d) one apply: no psum, one ppermute per nonzero rotation offset, and
    # the permuted payload's real (non-dump) rows are the plan's wire bytes
    plan = op.plan
    assert mesh.psum_calls == 0
    assert mesh.ppermute_calls == sum(1 for s in plan.steps if s.offset)
    permuted = [s for s in plan.steps if s.offset]
    assert mesh.ppermute_elements == sum(s.gather_idx.size for s in permuted) * T_APPLY
    real = sum(int((s.scatter_pos < plan._dump(s)).sum()) for s in permuted) * T_APPLY
    assert real == plan.wire_bytes(8) // 8


@pytest.mark.parametrize("strategy,backend", SOLVES, ids=[f"{s}-{b}" for s, b in SOLVES])
def test_solve_matches_reference_and_sequential(reference, operators, strategy, backend):
    from repro_torch import kernels
    from repro_torch.solver import ECGSolver, SolverConfig

    a = operators["fd"]
    b = _rhs(a.shape[0])
    mesh = _mesh()
    solver = ECGSolver.build(a, mesh, _config("fd", b, strategy, backend))
    mesh.reset_counters()
    kernels.reset_launch_counts()
    res = solver.solve(b)
    key = f"solve/fd/{strategy}/{backend}"
    k = int(reference[key + "/n_iters"])
    assert res.converged and res.n_iters == k
    _assert_hist_close(res.res_hist.numpy()[: k + 1], reference[key + "/res_hist"][: k + 1])
    x = solver.unshard(res.x)
    want = reference[key + "/x"]
    assert np.abs(x - want).max() <= 1e-9 * np.abs(want).max()
    # (d) the classic iteration's 3 reductions (gram1, gram2, the residual
    # norm) plus the initial residual norm, as dist_worker.py counts
    # "3 body + 1 init all-reduces"; one exchange per SpMBV
    assert mesh.psum_calls == 3 * k + 1
    n_perm = sum(1 for s in solver.op.plan.steps if s.offset)
    assert mesh.ppermute_calls == n_perm * (k + 1)
    assert kernels.launch_counts() == dict.fromkeys(kernels.launch_counts(), 0)  # CPU tensors
    # (c) the sequential port solve of the same system
    seq = ECGSolver.build(a, config=SolverConfig(t=T_SOLVE, tol=_tol("fd", b), max_iters=MAX_ITERS,
                                                 kernel=backend), device="cpu").solve(b)
    assert seq.n_iters == k
    assert np.abs(x - seq.x.numpy()).max() <= 1e-9 * np.abs(want).max()


def test_dg_solve_matches_reference(reference, operators):
    from repro_torch.solver import ECGSolver

    a = operators["dg2"]
    b = _rhs(a.shape[0])
    solver = ECGSolver.build(a, _mesh(), _config("dg2", b, "optimal", "pallas"))
    res = solver.solve(b)
    key = "solve/dg2/optimal/pallas"
    k = int(reference[key + "/n_iters"])
    assert res.converged and res.n_iters == k
    _assert_hist_close(res.res_hist.numpy()[: k + 1], reference[key + "/res_hist"][: k + 1])
    want = reference[key + "/x"]
    assert np.abs(solver.unshard(res.x) - want).max() <= 1e-9 * np.abs(want).max()


@pytest.mark.parametrize("col_split", [2, 4])
def test_col_split_apply_and_width_one_exchange(operators, col_split):
    """A col-split plan reshapes (rmax, t) -> (rmax·cs, t/cs) around the
    exchange, and pads the width-1 initial residual up to cs columns."""
    a = operators["dg"]
    dense = a.todense().numpy()
    mesh = _mesh()
    from repro_torch.core.machines import BLUE_WATERS
    from repro_torch.sparse.spmbv import _make_distributed_spmbv

    op = _make_distributed_spmbv(a, mesh, "optimal", t=8, machine=BLUE_WATERS, backend="pallas",
                                 col_split=col_split)
    assert op.plan.col_split == col_split
    for t in (8, 1, 3):
        v = _block(a.shape[0], t)
        w = op.unshard(op.matvec_fn()(op.shard_vector(v)))
        assert np.abs(w - dense @ v).max() <= 1e-12 * np.abs(dense @ v).max()


def test_layouts_and_partition_reuse(operators):
    from repro_torch.solver import ECGSolver

    a = operators["fd"]
    b = _rhs(a.shape[0])
    mesh = _mesh()
    solver = ECGSolver.build(a, mesh, _config("fd", b, "2step", "pallas"))
    op = solver.op
    assert op.n_padded == 8 * op.rmax and op.rmax == 22
    assert np.array_equal(op.unshard(op.shard_vector(b)), b)
    assert op.padded_mask().sum() == a.shape[0]
    slots = op.true_row_of_slot()
    assert np.array_equal(slots[slots >= 0], np.arange(a.shape[0]))
    sibling = solver.with_config(strategy="optimal")
    assert sibling.partition is solver.partition and sibling.stats.partition_reused
    assert not sibling.stats.op_reused and sibling.op.plan.strategy == "optimal"
    # the [own ‖ halo] Block-ELL layout depends on the partition alone
    assert sibling.stats.conv_reused and sibling.op.ell["blocks"] is op.ell["blocks"]
    same_op = solver.with_config(tol=solver.config.tol / 10)
    assert same_op.stats.op_reused and same_op.op is op
    shared = ECGSolver.build(a, mesh, _config("fd", b, "3step", "jnp"), pm=solver.partition)
    assert shared.partition is solver.partition
    r1, r2 = sibling.solve(b), shared.solve(b)
    assert r1.converged and r2.converged


def test_batched_fused_gram_equals_per_rank(operators):
    from repro.kernels.fused_gram.kernel import fused_gram_pallas
    import jax.numpy as jnp

    from repro_torch import kernels

    rng = np.random.default_rng(5)
    mats = [rng.standard_normal((8, 37, 4)) for _ in range(4)]
    got = kernels.fused_gram(*map(torch.as_tensor, mats)).numpy()
    assert got.shape == (8, 4, 12)
    for r in range(8):
        per_rank = kernels.fused_gram(*(torch.as_tensor(m[r]) for m in mats)).numpy()
        assert np.array_equal(got[r], per_rank)
        want = np.asarray(fused_gram_pallas(*(jnp.asarray(m[r]) for m in mats), interpret=True))
        np.testing.assert_allclose(got[r], want, rtol=1e-12, atol=1e-12)


def test_mesh_rotations_and_sum():
    mesh = _mesh()
    x = torch.arange(8.0)[:, None] * torch.ones(8, 3)
    # rank i sends to rank (i + offset) mod n along the axis: rank j holds
    # what its source sent
    assert mesh.ppermute(x, "flat", 3)[:, 0].tolist() == [5, 6, 7, 0, 1, 2, 3, 4]
    assert mesh.ppermute(x, "proc", 1)[:, 0].tolist() == [3, 0, 1, 2, 7, 4, 5, 6]
    assert mesh.ppermute(x, "node", 1)[:, 0].tolist() == [4, 5, 6, 7, 0, 1, 2, 3]
    assert mesh.psum(x).tolist() == [28.0] * 3
    assert (mesh.psum_calls, mesh.ppermute_calls, mesh.ppermute_elements) == (1, 3, 72)
    mesh.reset_counters()
    assert (mesh.psum_calls, mesh.ppermute_calls, mesh.ppermute_elements) == (0, 0, 0)
    with pytest.raises(ValueError, match="leading rank axis"):
        mesh.psum(torch.zeros(4))
    with pytest.raises(ValueError, match="unknown mesh axis"):
        mesh.ppermute(x, "pod", 1)


@pytest.mark.parametrize("override,item", [
    (dict(overlap=True), "queue 1 item 5a"),
    (dict(tune="model"), "queue 1 item 9"),
    (dict(t="auto"), "queue 1 item 6"),
    (dict(method="sstep"), "queue 1 item 7"),
])
def test_unported_distributed_options_raise(operators, override, item):
    from repro_torch.solver import ECGSolver, SolverConfig

    with pytest.raises(NotImplementedError, match=item):
        ECGSolver.build(operators["fd"], _mesh(), SolverConfig().replace(**override))


def test_cli_runs_the_virtual_mesh_and_refuses_tuned(capsys):
    from repro_torch.launch import solve as port_cli

    port_cli.main(["--matrix", "fd", "--elements", "4", "--t", "4", "--devices", "8", "--ppn", "4",
                   "--strategy", "3step", "--backend", "pallas", "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("distributed ECG[classic/3step/pallas] t=4 on 8 devices:")
    assert "converged=True" in line
    for flags, item in ((["--strategy", "tuned"], "queue 1 item 9"),
                        (["--strategy", "3step", "--overlap"], "queue 1 item 5a")):
        with pytest.raises(SystemExit):
            port_cli.main(["--matrix", "fd", "--elements", "4", "--devices", "8", "--ppn", "4",
                           "--device", "cpu", *flags])
        assert item in capsys.readouterr().err


if __name__ == "__main__":
    _reference_results(sys.argv[1])
