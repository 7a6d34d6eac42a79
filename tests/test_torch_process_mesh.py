"""The process-group mesh: one rank per process over ``torch.distributed``.

A module-scoped world of 8 gloo processes on the CPU (``file://``
rendezvous under ``tmp_path``) runs a ``ProcessGroupMesh(2, 4)``: this file
executed as a script, once per rank, in subprocesses with a timeout (the
children import ``repro_torch`` only, not JAX and not the reference).  Each
writes its results to an ``.npz``; the parent holds them against a
``VirtualMesh(2, 4, device="cpu")`` run of the same function (:func:`_side`)
and against the reference's sequential solve in float64, both in-process.
Operators: ``fd_laplace_2d(13)`` (169 rows, uneven over 8 ranks) and
``dg_laplace_2d((8, 8), block=2)``.

(a) ``ppermute`` on each axis at offsets ±1, ±2, ``psum`` and
    ``all_gather``, on integer-valued data: exactly the virtual mesh's
    rows; the counters count this process's calls and elements.
(b) host artefacts: partition starts, the plan's phases, each phase's
    gather and scatter rows, the own Block-ELL tiles and indices (equal to
    the stacked rank slice up to its all-zero padding columns), the own
    slots' true rows; each process holds its own rank's block rows only.
(c) one apply per strategy × backend × t ∈ {1, 3, 8}: the virtual mesh's
    rank rows within 1e-12 of max|W|.
(d) classic solves (t = 4; fd to 1e-8·‖b‖, dg to 1e-6·‖b‖): the virtual
    mesh's iterations, x within 1e-9 of max|x| of the reference's, 3k + 1
    psums and n_perm·(k + 1) ppermutes on every process, the processes'
    ``ppermute_elements`` summing to the virtual mesh's.
(e) adaptive ``reduce`` (width segments), block-Jacobi, Chebyshev,
    inexact, pipelined and s-step s = 2: iterations, widths and psums equal
    on every process and to the virtual mesh's; ``bytes_drift`` sums the
    moved bytes over the group.
(f) the overlap schedule, ``tune`` mode ``"measure"``, ``t="auto"``, the
    serving layer and ``solve_packed`` raise ``NotImplementedError`` naming
    queue 1 item 5b; so does a world whose size differs from the mesh's and
    a NCCL rank on a CPU device (``ValueError``).
(g) ``make_solver_mesh()`` inside the world: the reference's shape rule
    with the world size as the device count.
(h) the solve CLI inside the world: rank 0 prints the result line, the
    other ranks nothing.
"""

import contextlib
import datetime
import io
import os
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SHAPE, WORLD = (2, 4), 8
OFFSETS = (1, -1, 2, -2)
STRATEGIES = ["standard", "2step", "3step", "optimal"]
BACKENDS = ["jnp", "pallas"]
TS = [1, 3, 8]
T_SOLVE, MAX_ITERS = 4, 500
APPLIES = [(n, s, b, t) for n in ("fd", "dg") for s in STRATEGIES for b in BACKENDS for t in TS]
SOLVES = [("fd", "standard", "pallas"), ("fd", "3step", "jnp"), ("fd", "optimal", "pallas"),
          ("dg", "optimal", "pallas")]
VARIANTS = {
    "reduce": dict(adaptive="reduce"),
    "block_jacobi": dict(precondition=dict(kind="block_jacobi", block=8)),
    "chebyshev": dict(precondition="chebyshev"),
    "inexact": dict(precondition="inexact"),
    "pipelined": dict(method="pipelined"),
    "sstep": dict(method="sstep", s=2),
}
REFUSALS = ["overlap", "tune_measure", "auto_t", "with_config_overlap", "serve", "solve_packed"]
MESH_SHAPES = [dict(ppn=4), dict(ppn=2), dict(ppn=8), dict(multi_pod=True), dict(ppn=16)]
TIMEOUT_S = 150


def _operators():
    from repro_torch.sparse import dg_laplace_2d, fd_laplace_2d

    return {"fd": fd_laplace_2d(13, device="cpu"), "dg": dg_laplace_2d((8, 8), block=2, device="cpu")}


def _rhs(n):
    return np.random.default_rng(n).standard_normal(n)


def _deficient_rhs(n):
    """Two of the four subdomains zero: the fixed width breaks down."""
    b = np.zeros(n)
    b[: n // 2] = np.random.default_rng(7).standard_normal(n // 2)
    return b


def _block(n, t):
    return np.random.default_rng(100 + n + t).standard_normal((n, t))


def _tol(name, b):
    return (1e-6 if name == "dg" else 1e-8) * float(np.linalg.norm(b))


def _rank_values(r):
    """Rank r's (2, 3) integer-valued block."""
    return 100.0 * r + torch.arange(6, dtype=torch.float64).reshape(2, 3)


def _config(name, b, strategy, backend, **over):
    from repro_torch.core.machines import BLUE_WATERS
    from repro_torch.solver import CommConfig, SolverConfig

    return SolverConfig(t=T_SOLVE, tol=_tol(name, b), max_iters=MAX_ITERS,
                        comm=CommConfig(strategy=strategy, machine=BLUE_WATERS),
                        kernel=backend).replace(**over)


def _counters(mesh):
    return np.asarray([mesh.psum_calls, mesh.ppermute_calls, mesh.ppermute_elements,
                       mesh.all_gather_calls])


def _side(mesh) -> dict:
    """Everything (a)-(e) compares, on ``mesh``: the same calls in the same
    order on a virtual mesh (in the test process) and on every process of
    the world.  Per-rank values come back in the mesh's own layout."""
    from repro_torch.core.machines import BLUE_WATERS
    from repro_torch.observe.drift import bytes_drift
    from repro_torch.solver import ECGSolver
    from repro_torch.sparse import partition_csr
    from repro_torch.sparse.spmbv import _make_distributed_spmbv

    out = {}
    # (a)
    buf = torch.stack([_rank_values(r) for r in mesh.ranks])
    mesh.reset_counters()
    for axis in ("node", "proc", "flat"):
        for off in OFFSETS:
            out[f"a/{axis}/{off}"] = mesh.ppermute(buf, axis, off).numpy()
    out["a/psum"] = mesh.psum(buf).numpy()
    out["a/all_gather"] = mesh.all_gather(buf).numpy()
    out["a/counters"] = _counters(mesh)
    # (b), (c)
    ops = _operators()
    for name, a in ops.items():
        pm = partition_csr(a, mesh.p)
        for strategy, backend, t in ((s, b, t) for s in STRATEGIES for b in BACKENDS for t in TS):
            op = _make_distributed_spmbv(a, mesh, strategy, t=t, machine=BLUE_WATERS, pm=pm,
                                         backend=backend)
            key = f"{name}/{strategy}/{backend}/{t}"
            out["c/" + key] = op.matvec_fn()(op.shard_vector(_block(a.shape[0], t))).numpy()
            if t == 3 and backend == "pallas":
                out[f"b/{name}/{strategy}/starts"] = op.starts
                out[f"b/{name}/{strategy}/rmax"] = np.asarray(op.rmax)
                out[f"b/{name}/{strategy}/true_rows"] = op.true_row_of_slot()
                out[f"b/{name}/{strategy}/n_phases"] = np.asarray(len(op.plan.phases))
                out[f"b/{name}/{strategy}/wire_bytes"] = np.asarray(op.plan.wire_bytes(8))
                for i, (g, s_) in enumerate(zip(op.gathers, op.scatters)):
                    out[f"b/{name}/{strategy}/gather{i}"] = g.numpy()
                    out[f"b/{name}/{strategy}/scatter{i}"] = s_.numpy()
                out[f"b/{name}/{strategy}/blocks"] = op.ell["blocks"].numpy()
                out[f"b/{name}/{strategy}/indices"] = op.ell["indices"].numpy()
                out[f"b/{name}/{strategy}/nbc"] = np.asarray(op.m_pad // op.ell["blocks"].shape[-1])
    # (d)
    for name, strategy, backend in SOLVES:
        a = ops[name]
        b = _rhs(a.shape[0])
        solver = ECGSolver.build(a, mesh, _config(name, b, strategy, backend))
        mesh.reset_counters()
        res = solver.solve(b)
        key = f"d/{name}/{strategy}/{backend}"
        out[key + "/counters"] = _counters(mesh)
        out[key + "/n_perm"] = np.asarray(sum(1 for s in solver.op.plan.steps if s.offset))
        out[key + "/n_iters"] = np.asarray(res.n_iters)
        out[key + "/converged"] = np.asarray(res.converged)
        out[key + "/res_hist"] = res.res_hist.numpy()[: res.n_iters + 1]
        out[key + "/x"] = solver.unshard(res.x)
    # (e)
    a = ops["fd"]
    for kind, over in VARIANTS.items():
        b = _deficient_rhs(a.shape[0]) if kind == "reduce" else _rhs(a.shape[0])
        solver = ECGSolver.build(a, mesh, _config("fd", b, "optimal", "pallas", **over))
        mesh.reset_counters()
        res = solver.solve(b)
        key = f"e/{kind}"
        out[key + "/counters"] = _counters(mesh)
        out[key + "/n_iters"] = np.asarray(res.n_iters)
        out[key + "/converged"] = np.asarray(res.converged)
        out[key + "/x"] = solver.unshard(res.x)
        if res.active_hist is not None:
            out[key + "/active_hist"] = np.asarray(res.active_hist)
            out[key + "/segments"] = np.asarray(res.comm_segments, np.int64)
        if kind == "reduce":
            out[key + "/drift"] = np.asarray([[bd["plan_bytes"], bd["moved_bytes"]] for bd in
                                              (bytes_drift(solver, w) for w in (T_SOLVE, 2))])
    return out


def _world_only(mesh) -> dict:
    """(f), (g), (h): what only a process-group world can show."""
    from repro_torch.launch import solve as port_cli
    from repro_torch.launch.mesh import ProcessGroupMesh, make_solver_mesh
    from repro_torch.serve import ECGServer
    from repro_torch.solver import CommConfig, ECGSolver, SolverConfig

    out = {}
    a = _operators()["fd"]
    b = _rhs(a.shape[0])
    cfg = _config("fd", b, "optimal", "pallas")
    handle = ECGSolver.build(a, mesh, cfg.replace(adaptive="rankrev"))
    tries = {
        "overlap": lambda: ECGSolver.build(a, mesh, cfg.replace(comm=CommConfig(overlap=True))),
        "tune_measure": lambda: ECGSolver.build(a, mesh, cfg.replace(tune="measure")),
        "auto_t": lambda: ECGSolver.build(a, mesh, SolverConfig(t="auto")),
        "with_config_overlap": lambda: handle.with_config(overlap=True),
        "serve": lambda: ECGServer(mesh=mesh),
        "solve_packed": lambda: handle.solve_packed([b, b]),
    }
    for kind, fn in tries.items():
        try:
            fn()
            out[f"f/{kind}"] = np.asarray("no error")
        except NotImplementedError as e:
            out[f"f/{kind}"] = np.asarray(f"NotImplementedError: {e}")
    try:
        ProcessGroupMesh(2, 2)
        out["f/world_size"] = np.asarray("no error")
    except ValueError as e:
        out["f/world_size"] = np.asarray(f"ValueError: {e}")
    for i, kw in enumerate(MESH_SHAPES):
        try:
            m = make_solver_mesh(**kw)
            out[f"g/{i}"] = np.asarray([type(m).__name__, str(m.shape)])
        except ValueError as e:
            out[f"g/{i}"] = np.asarray(["ValueError", str(e)])
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        port_cli.main(["--matrix", "fd", "--elements", "4", "--t", "4", "--devices", str(WORLD),
                       "--ppn", "4", "--strategy", "3step", "--backend", "pallas", "--device", "cpu"])
    out["h/stdout"] = np.asarray(text.getvalue())
    return out


def _worker(out_dir: Path, rank: int) -> None:
    """One rank of the world: run :func:`_side` and :func:`_world_only` on
    a ``ProcessGroupMesh(2, 4)`` and save the results."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import ProcessGroupMesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir / 'rendezvous'}", rank=rank,
                            world_size=WORLD, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = ProcessGroupMesh(*SHAPE)
        out = _side(mesh) | _world_only(mesh)
        out["rank"] = np.asarray(mesh.rank)
        out["modules"] = np.asarray(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro")))
    finally:
        dist.destroy_process_group()
    np.savez(out_dir / f"rank{rank}.npz", **out)


# ------------------------------------------------------------- parent side
def _reference_solves():
    """The reference's sequential float64 solves of (d)'s systems."""
    import repro.sparse as ref_sparse
    from repro.solver import ECGSolver as RefSolver, SolverConfig as RefConfig

    ref = {"fd": ref_sparse.fd_laplace_2d(13), "dg": ref_sparse.dg_laplace_2d((8, 8), block=2)}
    out = {}
    for name, a in ref.items():
        b = _rhs(a.shape[0])
        res = RefSolver.build(a, config=RefConfig(t=T_SOLVE, tol=_tol(name, b),
                                                  max_iters=MAX_ITERS)).solve(b)
        out[name] = (int(res.n_iters), np.asarray(res.x))
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(the 8 processes' results, the virtual mesh's, the reference's):
    the world runs while the test process computes the other two."""
    from repro_torch.launch.mesh import VirtualMesh

    d = tmp_path_factory.mktemp("process_mesh")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), WORLD_SIZE=str(WORLD),
               OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME=os.environ.get("GLOO_SOCKET_IFNAME", "lo"))
    logs = [open(d / f"rank{r}.log", "w") for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, __file__, str(d), str(r)], env=env, stdout=logs[r],
                              stderr=subprocess.STDOUT) for r in range(WORLD)]
    try:
        virtual = _side(VirtualMesh(*SHAPE, device="cpu"))
        reference = _reference_solves()
        deadline = time.monotonic() + TIMEOUT_S
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    failed = {r: (d / f"rank{r}.log").read_text()[-3000:] for r, p in enumerate(procs) if p.returncode}
    assert not failed, failed
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]
    return ranks, virtual, reference


def _rank_rows(stacked, r, rows):
    return stacked[r * rows : (r + 1) * rows]


def test_workers_import_neither_jax_nor_the_reference(world):
    ranks, _, _ = world
    assert [int(out["rank"]) for out in ranks] == list(range(WORLD))
    assert all(out["modules"].size == 0 for out in ranks), [out["modules"] for out in ranks]


@pytest.mark.parametrize("axis", ["node", "proc", "flat"])
@pytest.mark.parametrize("off", OFFSETS)
def test_ppermute_equals_the_virtual_mesh(world, axis, off):
    ranks, virtual, _ = world
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out[f"a/{axis}/{off}"], virtual[f"a/{axis}/{off}"][r : r + 1])


def test_psum_all_gather_and_counters(world):
    ranks, virtual, _ = world
    for out in ranks:
        np.testing.assert_array_equal(out["a/psum"], virtual["a/psum"])
        np.testing.assert_array_equal(out["a/all_gather"], virtual["a/all_gather"])
        # 12 rotations of this rank's 6 elements, one psum, one gather
        assert out["a/counters"].tolist() == [1, 12, 12 * 6, 1]
    assert virtual["a/counters"].tolist() == [1, 12, 12 * 6 * WORLD, 1]


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("name", ["fd", "dg"])
def test_host_artefacts_are_the_rank_slice(world, name, strategy):
    ranks, virtual, _ = world
    k = f"b/{name}/{strategy}"
    rmax = int(virtual[k + "/rmax"])
    vblocks, vidx, nbc = virtual[k + "/blocks"], virtual[k + "/indices"], int(virtual[k + "/nbc"])
    nbr = vblocks.shape[0] // WORLD
    for r, out in enumerate(ranks):
        for key in ("/starts", "/rmax", "/n_phases", "/wire_bytes"):
            np.testing.assert_array_equal(out[k + key], virtual[k + key])
        np.testing.assert_array_equal(out[k + "/true_rows"], _rank_rows(virtual[k + "/true_rows"], r, rmax))
        for i in range(int(virtual[k + "/n_phases"])):
            for arr in (f"/gather{i}", f"/scatter{i}"):
                np.testing.assert_array_equal(out[k + arr], virtual[k + arr][r : r + 1])
        blocks, idx = out[k + "/blocks"], out[k + "/indices"]
        # the own rank's block rows only; its kmax may be below the stacked one
        assert blocks.shape[0] == nbr and blocks.shape[1] <= vblocks.shape[1]
        kmax = blocks.shape[1]
        np.testing.assert_array_equal(blocks, _rank_rows(vblocks, r, nbr)[:, :kmax])
        assert not _rank_rows(vblocks, r, nbr)[:, kmax:].any()
        np.testing.assert_array_equal(idx, _rank_rows(vidx, r, nbr)[:, :kmax] - r * nbc)


@pytest.mark.parametrize("name,strategy,backend,t", APPLIES, ids=["-".join(map(str, c)) for c in APPLIES])
def test_apply_equals_the_virtual_mesh_rows(world, name, strategy, backend, t):
    ranks, virtual, _ = world
    want = virtual[f"c/{name}/{strategy}/{backend}/{t}"]
    rmax = want.shape[0] // WORLD
    for r, out in enumerate(ranks):
        got = out[f"c/{name}/{strategy}/{backend}/{t}"]
        assert got.shape == (rmax, t)
        assert np.abs(got - _rank_rows(want, r, rmax)).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("name,strategy,backend", SOLVES, ids=["-".join(c) for c in SOLVES])
def test_classic_solve_matches_virtual_mesh_and_reference(world, name, strategy, backend):
    ranks, virtual, reference = world
    key = f"d/{name}/{strategy}/{backend}"
    k = int(virtual[key + "/n_iters"])
    ref_k, ref_x = reference[name]
    assert bool(virtual[key + "/converged"]) and k == ref_k
    n_perm = int(virtual[key + "/n_perm"])
    psums, perms, v_elements, _ = virtual[key + "/counters"].tolist()
    assert (psums, perms) == (3 * k + 1, n_perm * (k + 1))
    elements = 0
    for out in ranks:
        assert int(out[key + "/n_iters"]) == k and bool(out[key + "/converged"])
        np.testing.assert_allclose(out[key + "/res_hist"], virtual[key + "/res_hist"],
                                   rtol=1e-9, atol=1e-15 * virtual[key + "/res_hist"][0])
        assert np.abs(out[key + "/x"] - ref_x).max() <= 1e-9 * np.abs(ref_x).max()
        np.testing.assert_array_equal(out[key + "/x"], ranks[0][key + "/x"])  # one x everywhere
        p_psums, p_perms, p_elements, gathers = out[key + "/counters"].tolist()
        assert (p_psums, p_perms, gathers) == (3 * k + 1, n_perm * (k + 1), 0)
        elements += p_elements
    assert elements == v_elements


@pytest.mark.parametrize("kind", list(VARIANTS))
def test_variant_solve_matches_virtual_mesh(world, kind):
    ranks, virtual, _ = world
    key = f"e/{kind}"
    k = int(virtual[key + "/n_iters"])
    assert bool(virtual[key + "/converged"])
    for out in ranks:
        assert int(out[key + "/n_iters"]) == k and bool(out[key + "/converged"])
        assert out[key + "/counters"][0] == virtual[key + "/counters"][0]  # psums
        assert out[key + "/counters"][1] == virtual[key + "/counters"][1]  # rotations
        x, want = out[key + "/x"], virtual[key + "/x"]
        assert np.abs(x - want).max() <= 1e-9 * np.abs(want).max()
        for extra in ("/active_hist", "/segments", "/drift"):
            if key + extra in virtual:
                np.testing.assert_array_equal(out[key + extra], virtual[key + extra])
    assert sum(out[key + "/counters"][2] for out in ranks) == virtual[key + "/counters"][2]
    if kind == "reduce":  # width-segmented: the exchange re-sliced at width 2
        segments = [tuple(s) for s in virtual[key + "/segments"].tolist()]
        assert segments[0][0] == T_SOLVE and segments[-1][0] == 2 and len(segments) == 2


@pytest.mark.parametrize("kind", REFUSALS)
def test_unported_options_refused_on_the_process_mesh(world, kind):
    ranks, _, _ = world
    for out in ranks:
        msg = str(out[f"f/{kind}"])
        assert msg.startswith("NotImplementedError") and "queue 1 item 5b" in msg, msg


def test_mesh_refuses_a_world_of_another_size_and_a_mismatched_device(world):
    from repro_torch.launch.mesh import ProcessGroupMesh, process_device

    ranks, _, _ = world
    for out in ranks:
        assert str(out["f/world_size"]).startswith("ValueError") and "holds 8" in str(out["f/world_size"])
    with pytest.raises(ValueError, match="NCCL process group computes on a CUDA device"):
        process_device("nccl", "cpu")
    with pytest.raises(ValueError, match="NCCL or gloo"):
        process_device("mpi")
    assert process_device("gloo") == torch.device("cpu")
    with pytest.raises(ValueError, match="init_process_group first"):
        ProcessGroupMesh(2, 4)  # the test process has no world


@pytest.mark.parametrize("backend", ["mpi", "ucc", "xccl", "undefined", "NCCL"])
def test_process_device_refuses_other_backends_and_takes_the_fake_world(backend):
    """Only NCCL, gloo and the dry-run's ``fake`` world are taken; NCCL on
    the CPU and gloo off it are refused; a fake world computes on the
    device it is given (no card needed: nothing runs there)."""
    from repro_torch.launch.mesh import process_device

    with pytest.raises(ValueError, match="NCCL or gloo"):
        process_device(backend)
    with pytest.raises(ValueError, match="NCCL process group computes on a CUDA device"):
        process_device("nccl", "cpu")
    with pytest.raises(ValueError, match="device must be a CUDA device or 'cpu'"):
        process_device("gloo", "meta")
    with pytest.raises(ValueError, match="device must be a CUDA device or 'cpu'"):
        process_device("fake", "meta")
    assert process_device("gloo") == torch.device("cpu")
    assert process_device("fake") == torch.device("cuda")
    assert process_device("fake", "cpu") == torch.device("cpu")
    assert process_device("fake", "cuda:3") == torch.device("cuda", 3)


@pytest.mark.parametrize("i", range(len(MESH_SHAPES)))
def test_make_solver_mesh_in_a_world_follows_reference_rule(world, monkeypatch, i):
    import repro.launch.mesh as ref_mesh

    ranks, _, _ = world
    kw = MESH_SHAPES[i]
    stub = types.SimpleNamespace(devices=lambda: [None] * WORLD,
                                 make_mesh=lambda shape, axes: tuple(shape))
    monkeypatch.setattr(ref_mesh, "jax", stub)
    shape = ref_mesh.make_solver_mesh(**kw)
    for out in ranks:
        got = out[f"g/{i}"].tolist()
        if shape[0] * shape[1] == WORLD and min(shape) >= 1:
            assert got == ["ProcessGroupMesh", str(shape)]
        else:
            assert got[0] == "ValueError" and "does not cover a world of 8" in got[1]


def test_cli_runs_one_rank_per_process_and_prints_on_rank_zero(world):
    ranks, _, _ = world
    line = str(ranks[0]["h/stdout"]).strip().splitlines()[-1]
    assert line.startswith("distributed ECG[classic/3step/pallas] t=4 on 8 processes:")
    assert "converged=True" in line
    assert all(str(out["h/stdout"]) == "" for out in ranks[1:])


if __name__ == "__main__":
    _worker(Path(sys.argv[1]), int(sys.argv[2]))
