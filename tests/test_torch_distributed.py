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
    collective counts (``tests/dist_worker.py``);
(e) preconditioned solves (block-Jacobi at block 8, which does not divide
    the ranks' 22 rows, Chebyshev and inexact) on ``fd_laplace_2d(13)`` to
    1e-8·‖b‖, held as in (b), with equal reseed iterations; a
    preconditioner adds no psum, and only Chebyshev and inexact add
    exchanges (their extra SpMBVs);
(f) adaptive solves (``tests/dist_worker.py``'s ``check_adaptive_and_auto_t``
    without its auto-t half): ``fd_laplace_2d(13)`` with t = 4 and a
    right-hand side on m = 2 of the 4 subdomains, ``3step`` and ``optimal``.
    The fixed width breaks down; ``reduce`` converges width-segmented with
    ``comm_segments``, ``active_hist`` and the iterations equal to the
    reference's and ``res_hist`` as in (b); against the port's sequential
    adaptive solve ``active_hist`` is equal and ``res_hist`` agrees to 1e-5
    (the distributed reductions sum in another order); the reduced segment's
    exchanges move exactly m/t of the full width's elements.
(g) the pipelined and s-step schemes (s = 2, with and without ``reorth``)
    on ``fd_laplace_2d(13)`` at 1e-8·‖b‖ (``optimal``, pallas), held as in
    (b) against the reference's distributed solves and against the port's
    sequential solve; ``psum`` (psums_per_block + 1)·k + 1 (k blocks for
    s-step), exchanges one per SpMBV (s per block, one for r₀, and for
    pipelined one more that seeds AZ₀); and ``pipelined``/s-step ``reduce``
    width-segmented on the deficient right-hand side of (f).
(h) packed multi-RHS solves (``tests/dist_worker.py``'s
    ``check_packed_retirement``): three requests on ``fd_laplace_2d(13)``
    at t = 4 (one width-12 pack, ``optimal``, ``rankrev``), tolerances
    1e-2/1e-5/1e-8, and the same on ``fd_laplace_2d(20)``.  Each request's
    true residual meets its tolerance, retirements follow the tolerances,
    the exchange re-slices at each retirement (widths 12 → 8 → 4, as the
    reference's), ``psum`` 3·k + 1, and every exchange moves its width's
    elements; per-request iterations within the reference's own margin
    (max(5, k/3)) of the port's sequential pack.  The port restarts the
    pack at a retirement where the reference drops directions
    (``repro_torch.core.methods.classic``), so the two agree up to and
    including the first retirement: its iteration and the first segment
    are equal.  After it the reference's remaining requests slow down or
    stall: on ``fd_laplace_2d(20)`` its third request runs to
    ``max_iters`` (500) unconverged, where the port's converges in 52
    iterations.
(i) the drift helpers: ``bytes_drift`` at widths 4 and 2 (``standard``,
    ``optimal``): the bytes the port's exchange moved equal the
    reference's count of its compiled collective-permutes, and
    ``predicted_iteration_seconds`` equals the reference's (1e-12).
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
STRATEGIES = ["standard", "2step", "3step", "optimal"]
SOLVES = [(s, "pallas") for s in STRATEGIES] + [("3step", "jnp")]
PRECONDS = {"block_jacobi": dict(kind="block_jacobi", block=8), "chebyshev": "chebyshev",
            "inexact": "inexact"}
PREC_SOLVES = [(kind, "pallas") for kind in PRECONDS] + [("block_jacobi", "jnp")]
T_APPLY, T_SOLVE = 3, 4
MAX_ITERS = 500
ADAPTIVE_M, ADAPTIVE_TOL, ADAPTIVE_MAX_ITERS = 2, 1e-8, 300
METHOD_SOLVES = [("pipelined", 1, False, None), ("sstep", 2, False, None), ("sstep", 2, True, None),
                 ("pipelined", 1, False, "reduce"), ("sstep", 2, False, "reduce")]
PACK_TOLS, PACK_MAX_ITERS = [1e-2, 1e-5, 1e-8], 500


def _pack_rhs(n):
    rng = np.random.default_rng(7)
    return [rng.standard_normal(n) for _ in range(3)]


def _method_key(method, s, reorth, adaptive):
    return f"method/{method}/{s}/{reorth}/{adaptive}"


def _ref_operators(sparse):
    # dg: applies; dg2: the DG solve, on the operator whose sequential
    # histories tests/test_torch_ecg.py holds to the reference
    return {"fd": sparse.fd_laplace_2d(13), "dg": sparse.dg_laplace_2d((8, 6), block=4),
            "dg2": sparse.dg_laplace_2d((8, 8), block=2)}


def _rhs(n):
    return np.random.default_rng(n).standard_normal(n)


def _block(n, t):
    return np.random.default_rng(100 + n).standard_normal((n, t))


def _deficient_rhs(n):
    """t − m zero subdomains (dist_worker.py's right-hand side)."""
    b = np.zeros(n)
    hi = (ADAPTIVE_M * n) // T_SOLVE
    b[:hi] = np.random.default_rng(7).standard_normal(hi)
    return b


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
        for kind, backend in PREC_SOLVES if name == "fd" else []:
            cfg = SolverConfig(t=T_SOLVE, tol=_tol(name, b), max_iters=MAX_ITERS,
                               comm=CommConfig(strategy="optimal", machine=BLUE_WATERS),
                               kernel=backend, precondition=PRECONDS[kind])
            solver = ECGSolver.build(a, mesh, cfg)
            res = solver.solve(b)
            key = f"precond/{kind}/{backend}"
            out[key + "/n_iters"] = np.asarray(res.n_iters)
            out[key + "/res_hist"] = np.asarray(res.res_hist)
            out[key + "/x"] = solver.unshard(res.x)
            out[key + "/reseeds"] = np.asarray(res.reseed_events(), np.int64)
        for strategy in ("3step", "optimal") if name == "fd" else []:
            bd = _deficient_rhs(n)
            for adaptive in (None, "reduce"):
                cfg = SolverConfig(t=T_SOLVE, tol=ADAPTIVE_TOL, max_iters=ADAPTIVE_MAX_ITERS,
                                   comm=CommConfig(strategy=strategy, machine=BLUE_WATERS),
                                   kernel="pallas", adaptive=adaptive)
                res = ECGSolver.build(a, mesh, cfg).solve(bd)
                key = f"adaptive/{strategy}/{adaptive}"
                out[key + "/n_iters"] = np.asarray(res.n_iters)
                out[key + "/breakdown"] = np.asarray(res.breakdown)
                if adaptive is not None:
                    out[key + "/res_hist"] = np.asarray(res.res_hist)
                    out[key + "/active_hist"] = np.asarray(res.active_hist)
                    out[key + "/segments"] = np.asarray(res.comm_segments, np.int64)
        for method, s, reorth, adaptive in METHOD_SOLVES if name == "fd" else []:
            bm = b if adaptive is None else _deficient_rhs(n)
            cfg = SolverConfig(t=T_SOLVE, tol=_tol(name, bm), max_iters=MAX_ITERS,
                               comm=CommConfig(strategy="optimal", machine=BLUE_WATERS),
                               kernel="pallas", method=method, adaptive=adaptive,
                               ).replace(s=s, reorth=reorth)
            solver = ECGSolver.build(a, mesh, cfg)
            res = solver.solve(bm)
            key = _method_key(method, s, reorth, adaptive)
            out[key + "/n_iters"] = np.asarray(res.n_iters)
            out[key + "/res_hist"] = np.asarray(res.res_hist)
            out[key + "/x"] = solver.unshard(res.x)
            if adaptive is not None:
                out[key + "/active_hist"] = np.asarray(res.active_hist)
                out[key + "/segments"] = np.asarray(res.comm_segments, np.int64)
    # (h) packed retirement, on the reference test's operator and on a
    # larger one
    for nfd in (13, 20):
        a = ref_sparse.fd_laplace_2d(nfd)
        cfg = SolverConfig(t=T_SOLVE, tol=1e-8, max_iters=PACK_MAX_ITERS, adaptive="rankrev",
                           comm=CommConfig(strategy="optimal", machine=BLUE_WATERS))
        res = ECGSolver.build(a, mesh, cfg).solve_packed(_pack_rhs(a.shape[0]), tols=PACK_TOLS)
        key = f"packed/{nfd}"
        out[key + "/n_iters"] = np.asarray([r.n_iters for r in res])
        out[key + "/converged"] = np.asarray([bool(r.converged) for r in res])
        out[key + "/packed_iters"] = np.asarray(res[0].pack["packed_iters"])
        out[key + "/segments"] = np.asarray(res[0].comm_segments, np.int64)
    # (i) the drift helpers
    from repro.observe.drift import bytes_drift, predicted_iteration_seconds

    a = ref_sparse.fd_laplace_2d(13)
    for strategy in ("standard", "optimal"):
        solver = ECGSolver.build(a, mesh, SolverConfig(t=T_SOLVE, comm=CommConfig(
            strategy=strategy, machine=BLUE_WATERS)))
        for w in (4, 2):
            bd = bytes_drift(solver, w)
            out[f"drift/{strategy}/{w}"] = np.asarray(
                [bd["plan_bytes"], bd["hlo_bytes"], predicted_iteration_seconds(solver, w)])
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


def _assert_hist_close(got, want, floor=1e-15):
    """1e-9 relative per entry; entries within floor·‖r₀‖ (by default a few
    ulps of the initial residual norm, the rounding floor of every later
    entry) pass too."""
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=floor * want[0])


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


@pytest.mark.parametrize("kind,backend", PREC_SOLVES, ids=[f"{k}-{b}" for k, b in PREC_SOLVES])
def test_preconditioned_solve_matches_reference(reference, operators, kind, backend):
    from repro_torch import kernels
    from repro_torch.solver import ECGSolver, SolverConfig

    a = operators["fd"]
    b = _rhs(a.shape[0])
    mesh = _mesh()
    solver = ECGSolver.build(a, mesh, _config("fd", b, "optimal", backend).replace(
        precondition=PRECONDS[kind]))
    assert solver.op.rmax == 22  # block 8 leaves each rank a ragged last block
    mesh.reset_counters()
    kernels.reset_launch_counts()
    res = solver.solve(b)
    key = f"precond/{kind}/{backend}"
    k = int(reference[key + "/n_iters"])
    assert res.converged and res.n_iters == k
    # the iteration-varying inexact apply and its reseeds carry the
    # summation-order rounding further: its last entries (~1e-8·‖r₀‖)
    # agree to ~1e-14·‖r₀‖, 10 ulps of ‖r₀‖
    _assert_hist_close(res.res_hist.numpy()[: k + 1], reference[key + "/res_hist"][: k + 1],
                       floor=2e-14 if kind == "inexact" else 1e-15)
    want = reference[key + "/x"]
    assert np.abs(solver.unshard(res.x) - want).max() <= 1e-9 * np.abs(want).max()
    assert res.reseed_events() == reference[key + "/reseeds"].tolist()
    # (d)/(e) the preconditioner adds no psum; exchanges: one per SpMBV
    assert mesh.psum_calls == 3 * k + 1
    n_perm = sum(1 for s in solver.op.plan.steps if s.offset)
    spmbvs = k + 1  # the loop's and the width-1 initial residual's
    if kind == "chebyshev":
        spmbvs += (k + 1) * (solver.config.precondition.degree - 1)  # start + one apply per iteration
    elif kind == "inexact":
        applies = k + 1 + res.n_reseeds
        spmbvs += applies * (solver.config.precondition.sweeps - 1)
    assert mesh.ppermute_calls == n_perm * spmbvs
    assert kernels.launch_counts() == dict.fromkeys(kernels.launch_counts(), 0)  # CPU tensors


@pytest.mark.parametrize("strategy", ["3step", "optimal"])
def test_adaptive_solve_matches_reference_and_sequential(reference, operators, strategy):
    from repro_torch.solver import ECGSolver

    a = operators["fd"]
    b = _deficient_rhs(a.shape[0])
    mesh = _mesh()
    cfg = _config("fd", b, strategy, "pallas").replace(tol=ADAPTIVE_TOL,
                                                        max_iters=ADAPTIVE_MAX_ITERS)
    key = f"adaptive/{strategy}"
    fixed = ECGSolver.build(a, mesh, cfg).solve(b)
    assert fixed.breakdown and not fixed.converged and bool(reference[key + "/None/breakdown"])
    assert fixed.n_iters == int(reference[key + "/None/n_iters"])
    solver = ECGSolver.build(a, mesh, cfg.replace(adaptive="reduce"))
    mesh.reset_counters()
    res = solver.solve(b)
    k = int(reference[key + "/reduce/n_iters"])
    assert res.converged and res.n_iters == k
    assert res.comm_segments == [tuple(s) for s in reference[key + "/reduce/segments"].tolist()]
    assert res.comm_segments[0][0] == T_SOLVE and res.comm_segments[-1][0] == ADAPTIVE_M
    assert sum(it for _, it in res.comm_segments) == k
    assert np.array_equal(res.active_hist, reference[key + "/reduce/active_hist"])
    _assert_hist_close(res.res_hist.numpy()[: k + 1], reference[key + "/reduce/res_hist"][: k + 1])
    # (d) the policy adds no reduction; every exchange moves its width's
    # columns: one at width 1 (the initial residual), then per segment
    assert mesh.psum_calls == 3 * k + 1
    per_exchange = {}
    for w in (1, T_SOLVE, ADAPTIVE_M):  # widths 1 and t go through the full plan
        mesh.reset_counters()
        apply_w = solver.op.matvec_fn() if w in (1, T_SOLVE) else solver.op.matvec_fn(t_active=w)
        apply_w(torch.zeros(solver.op.n_padded, w, dtype=torch.float64))
        per_exchange[w] = mesh.ppermute_elements
    assert per_exchange[ADAPTIVE_M] * T_SOLVE == per_exchange[T_SOLVE] * ADAPTIVE_M
    mesh.reset_counters()
    solver.solve(b)
    assert mesh.ppermute_elements == per_exchange[1] + sum(
        per_exchange[w] * it for w, it in res.comm_segments)
    # the port's sequential adaptive solve: the same drops
    seq = ECGSolver.build(a, config=cfg.replace(adaptive="reduce"), device="cpu").solve(b)
    assert seq.converged and seq.comm_segments is None and abs(seq.n_iters - k) <= 2
    common = min(k, seq.n_iters) + 1
    assert np.array_equal(res.active_hist[:common], seq.active_hist[:common])
    np.testing.assert_allclose(res.res_hist.numpy()[:common], seq.res_hist.numpy()[:common],
                               rtol=1e-5, atol=1e-10)
    x = solver.unshard(res.x)
    assert np.linalg.norm(a.todense().numpy() @ x - b) / np.linalg.norm(b) < 1e-6


def _pack_solve(nfd):
    """The port's distributed packed solve of (h), with the mesh's counters
    of the solve alone."""
    from repro_torch.core.machines import BLUE_WATERS
    from repro_torch.solver import CommConfig, ECGSolver, SolverConfig
    from repro_torch.sparse import fd_laplace_2d

    a = fd_laplace_2d(nfd, device="cpu")
    bs = _pack_rhs(a.shape[0])
    mesh = _mesh()
    cfg = SolverConfig(t=T_SOLVE, tol=1e-8, max_iters=PACK_MAX_ITERS, adaptive="rankrev",
                       comm=CommConfig(strategy="optimal", machine=BLUE_WATERS))
    solver = ECGSolver.build(a, mesh, cfg)
    mesh.reset_counters()
    res = solver.solve_packed(bs, tols=PACK_TOLS)
    counters = (mesh.psum_calls, mesh.ppermute_elements)
    return a, bs, mesh, solver, res, counters


def _elements_per_exchange(solver, mesh, w):
    mesh.reset_counters()
    solver.op.matvec_fn(t_active=w)(torch.zeros(solver.op.n_padded, w, dtype=torch.float64))
    return mesh.ppermute_elements


@pytest.mark.parametrize("nfd", [13, 20])
def test_packed_retirement_matches_reference(reference, nfd):
    from repro_torch.solver import ECGSolver

    a, bs, mesh, solver, res, (psums, elements) = _pack_solve(nfd)
    key = f"packed/{nfd}"
    k = res[0].pack["packed_iters"]
    dense = a.todense().numpy()
    for r, b, tol in zip(res, bs, PACK_TOLS):
        assert r.converged and r.pack["retired_iter"] == r.n_iters
        assert np.linalg.norm(dense @ solver.unshard(r.x) - b) <= tol * 1.01
    iters = [r.n_iters for r in res]
    assert iters == sorted(iters)
    # up to and including the first retirement the port is the reference
    ref_iters = reference[key + "/n_iters"].tolist()
    ref_segs = [tuple(s) for s in reference[key + "/segments"].tolist()]
    segs = res[0].comm_segments
    assert iters[0] == ref_iters[0] and segs[0] == ref_segs[0]
    assert [w for w, _ in segs] == [w for w, _ in ref_segs] == [12, 8, 4]
    assert sum(it for _, it in segs) == k
    seq = ECGSolver.build(a, config=solver.config, device="cpu").solve_packed(bs, tols=PACK_TOLS)
    assert all(abs(g.n_iters - w.n_iters) <= max(5, w.n_iters // 3) for g, w in zip(res, seq))
    if nfd == 20:  # the reference's third request stalls after the retirements
        assert reference[key + "/converged"].tolist() == [True, True, False]
        assert ref_iters[2] == PACK_MAX_ITERS > iters[2]
    # one norm reduction of g floats replaces the scalar one: 3 per
    # iteration + 1 at the start, at every width
    assert psums == 3 * k + 1
    widths = [w for w, _ in segs]
    per = {w: _elements_per_exchange(solver, mesh, w) for w in widths}
    assert all(per[w1] > per[w2] for w1, w2 in zip(widths, widths[1:]))
    assert elements == per[widths[0]] + sum(per[w] * it for w, it in segs)


@pytest.mark.parametrize("strategy", ["standard", "optimal"])
def test_drift_helpers_match_reference(reference, operators, strategy):
    from repro_torch.core.machines import BLUE_WATERS
    from repro_torch.observe.drift import bytes_drift, predicted_iteration_seconds
    from repro_torch.solver import CommConfig, ECGSolver, SolverConfig

    solver = ECGSolver.build(operators["fd"], _mesh(), SolverConfig(
        t=T_SOLVE, comm=CommConfig(strategy=strategy, machine=BLUE_WATERS)))
    for w in (4, 2):
        plan_bytes, hlo_bytes, seconds = reference[f"drift/{strategy}/{w}"].tolist()
        bd = bytes_drift(solver, w)
        assert bd["plan_bytes"] == plan_bytes and bd["moved_bytes"] == hlo_bytes
        assert predicted_iteration_seconds(solver, w) == pytest.approx(seconds, rel=1e-12)


@pytest.mark.parametrize("method,s,reorth,adaptive", METHOD_SOLVES,
                         ids=[_method_key(*c).removeprefix("method/") for c in METHOD_SOLVES])
def test_method_solve_matches_reference_and_sequential(reference, operators, method, s, reorth,
                                                      adaptive):
    from repro_torch.core.methods import get_method
    from repro_torch.solver import ECGSolver

    a = operators["fd"]
    b = _rhs(a.shape[0]) if adaptive is None else _deficient_rhs(a.shape[0])
    mesh = _mesh()
    cfg = _config("fd", b, "optimal", "pallas").replace(method=method, s=s, reorth=reorth,
                                                         adaptive=adaptive)
    solver = ECGSolver.build(a, mesh, cfg)
    mesh.reset_counters()
    res = solver.solve(b)
    key = _method_key(method, s, reorth, adaptive)
    k = int(reference[key + "/n_iters"])
    assert res.converged and res.n_iters == k
    # the recurred AZ carries the summation-order rounding one step further:
    # the last entries (~1e-6·‖r₀‖) agree to ~2e-15·‖r₀‖, 10 ulps of ‖r₀‖
    _assert_hist_close(res.res_hist.numpy()[: k + 1], reference[key + "/res_hist"][: k + 1],
                       floor=1e-14)
    want = reference[key + "/x"]
    x = solver.unshard(res.x)
    assert np.abs(x - want).max() <= 1e-9 * np.abs(want).max()
    # (d) the scheme's reductions per block plus the residual norm, and the
    # initial residual norm; one exchange per SpMBV
    spec = get_method(method)
    assert mesh.psum_calls == (spec.psums_per_block(s, reorth) + 1) * k + 1
    n_perm = sum(1 for st in solver.op.plan.steps if st.offset)
    spmbvs = 1 + s * k + (method == "pipelined")  # r₀, the loop's, the AZ₀ seed
    if adaptive is None:
        assert mesh.ppermute_calls == n_perm * spmbvs
    else:
        assert res.comm_segments == [tuple(x_) for x_ in reference[key + "/segments"].tolist()]
        assert res.comm_segments[0][0] == T_SOLVE and res.comm_segments[-1][0] == ADAPTIVE_M
        assert np.array_equal(res.active_hist, reference[key + "/active_hist"])
    # (c) the port's sequential solve of the same system
    seq = ECGSolver.build(a, config=cfg.replace(strategy="standard"), device="cpu").solve(b)
    assert seq.n_iters == k
    assert np.abs(x - seq.x.numpy()).max() <= 1e-9 * np.abs(want).max()


def test_masked_apply_equals_the_full_width_apply(operators):
    """The width-compacted apply gathers the active columns, applies the
    narrower operator and scatters back: equal to the full-width apply of a
    block whose retired columns are zero."""
    from repro_torch.core.machines import BLUE_WATERS
    from repro_torch.sparse.spmbv import _make_distributed_spmbv

    a = operators["dg"]
    op = _make_distributed_spmbv(a, _mesh(), "optimal", t=8, machine=BLUE_WATERS, backend="pallas")
    active = torch.tensor([True, False, True, True, False, False, True, False])
    v = _block(a.shape[0], 8) * active.numpy()
    full = op.matvec_fn()(op.shard_vector(v))
    masked = op.masked_matvec_fn(4)(op.shard_vector(v), active)
    assert torch.allclose(masked, full, rtol=1e-13, atol=1e-13 * float(full.abs().max()))
    assert not masked[:, ~active].any()


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


@pytest.mark.parametrize("t", [T_APPLY, 1])
@pytest.mark.parametrize("strategy,col_split", [(s, None) for s in STRATEGIES] + [("optimal", 2)])
def test_exchange_halo_equals_reference(operators, strategy, col_split, t):
    """The halo rows the exchange leaves in the static [own ‖ halo ‖ pad]
    operand equal the reference's host replay of the same plan exactly
    (zero past each rank's halo); own rows are V's, pad rows stay zero."""
    import repro.core.node_aware as ref_na
    import repro.sparse as ref_sparse
    import repro.sparse.partition as ref_part
    from repro.core.machines import BLUE_WATERS as REF_BLUE_WATERS

    from repro_torch.core.machines import BLUE_WATERS
    from repro_torch.sparse.spmbv import _make_distributed_spmbv

    ra = _ref_operators(ref_sparse)["dg"]
    ref_pm = ref_part.partition_csr(ra, 8)
    ref_plan = ref_na.build_exchange_plan(ref_pm, 2, 4, strategy, t=T_APPLY if col_split is None else 8,
                                          machine=REF_BLUE_WATERS, col_split=col_split)
    a = operators["dg"]
    op = _make_distributed_spmbv(a, _mesh(), strategy, t=T_APPLY if col_split is None else 8,
                                 machine=BLUE_WATERS, backend="pallas", col_split=col_split)
    assert op.plan.col_split == ref_plan.col_split == (col_split or op.plan.col_split)
    v = _block(a.shape[0], t)
    v3 = op.shard_vector(v).reshape(8, op.rmax, t)
    ex = op.exchange(op.plan, t, torch.float64)
    for _ in range(2):  # the buffers are static: a second run sees no stale halo
        xfull = ex.run(v3).clone()
        want = ref_na.simulate_plan(ref_plan, ref_pm, v)
        for d in range(8):
            h = len(ref_pm.halo_sources[d])
            assert np.array_equal(xfull[d, op.rmax : op.rmax + h].numpy(), want[d])
            assert not xfull[d, op.rmax + h : op.rmax + op.plan.halo_rows].any()
        assert torch.equal(xfull[:, : op.rmax], v3)
        assert not xfull[:, op.rmax + op.plan.halo_rows :].any()
        v = -2.0 * v
        v3 = op.shard_vector(v).reshape(8, op.rmax, t)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("strategy,col_split", [(s, None) for s in STRATEGIES] + [("optimal", 2)])
def test_static_workspace_apply_equals_a_fresh_operator(operators, strategy, col_split, backend):
    """Two different right-hand sides in a row through one operator's static
    buffers, each against an operator that never applied before."""
    from repro_torch.core.machines import BLUE_WATERS
    from repro_torch.sparse.spmbv import _make_distributed_spmbv

    a = operators["dg"]

    def build():
        return _make_distributed_spmbv(a, _mesh(), strategy, t=8, machine=BLUE_WATERS,
                                       backend=backend, col_split=col_split)

    op = build()
    for t, seed in ((8, 1), (8, 2), (1, 3), (8, 4), (1, 5)):
        v = np.random.default_rng(seed).standard_normal((a.shape[0], t))
        got = op.matvec_fn()(op.shard_vector(v))
        fresh = build()
        assert torch.equal(got, fresh.matvec_fn()(fresh.shard_vector(v)))
    assert sorted(k[2] for k in op._exchanges) == [1, 8]  # one exchange per applied width
    sub = op.matvec_fn(t_active=2)
    for seed in (6, 7):
        v = np.random.default_rng(seed).standard_normal((a.shape[0], 2))
        fresh = build()
        assert torch.equal(sub(op.shard_vector(v)), fresh.matvec_fn(t_active=2)(fresh.shard_vector(v)))


def test_replayed_counts_are_the_captured_deltas():
    """The bookkeeping of a captured exchange: count_deltas records what one
    run adds to each counter and restores them; add_counts adds it back."""
    from types import SimpleNamespace

    from repro_torch.sparse.exchange import add_counts, count_deltas

    a, b = SimpleNamespace(launches=5), SimpleNamespace(calls=0, elements=7)
    counters = [(a, "launches"), (b, "calls"), (b, "elements")]

    def one_run():
        a.launches += 4
        b.calls += 9
        b.elements += 72

    deltas = count_deltas(counters, one_run)
    assert deltas == [4, 9, 72]
    assert (a.launches, b.calls, b.elements) == (5, 0, 7)  # the capture counts nothing
    for _ in range(3):
        add_counts(counters, deltas)
    assert (a.launches, b.calls, b.elements) == (5 + 12, 27, 7 + 216)

    def failing():
        a.launches += 1
        raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError, match="capture failed"):
        count_deltas(counters, failing)
    assert a.launches == 17  # restored


def test_exchange_counts_on_the_mesh_as_before(operators):
    """A CPU exchange runs eagerly every time: one ppermute per rotation and
    apply, as the eager executor always counted."""
    from repro_torch.core.machines import BLUE_WATERS
    from repro_torch.sparse.spmbv import _make_distributed_spmbv

    mesh = _mesh()
    op = _make_distributed_spmbv(operators["fd"], mesh, "optimal", t=4, machine=BLUE_WATERS,
                                 backend="pallas")
    v = op.shard_vector(_block(operators["fd"].shape[0], 4))
    apply = op.matvec_fn()
    mesh.reset_counters()
    for _ in range(3):
        apply(v)
    n_rot = sum(1 for s in op.plan.steps if s.offset)
    assert mesh.ppermute_calls == 3 * n_rot and mesh.psum_calls == 0
    ex = op.exchange(op.plan, 4, torch.float64)
    assert ex.graph is None and ex.runs == 3


@pytest.mark.parametrize("strategy,col_split", [(s, None) for s in STRATEGIES] + [("optimal", 2)])
def test_exchange_plan_counts_equal_an_eager_exchange(operators, strategy, col_split):
    """What a capture must count (HaloExchange.deltas, from the plan) is what
    one eager exchange adds: on the CPU the mesh's counters move as on the
    card, and the kernel counts are one pack and one unpack per phase."""
    from repro_torch.core.machines import BLUE_WATERS
    from repro_torch.kernels import KERNEL_OPS
    from repro_torch.sparse.exchange import count_deltas
    from repro_torch.sparse.spmbv import _make_distributed_spmbv

    op = _make_distributed_spmbv(operators["dg"], _mesh(), strategy, t=8, machine=BLUE_WATERS,
                                 backend="pallas", col_split=col_split)
    k = len(KERNEL_OPS)
    for t in (8, 1):
        ex = op.exchange(op.plan, t, torch.float64)
        ex.own.copy_(torch.ones_like(ex.own))
        eager = count_deltas(ex.counters, ex.exchange)
        assert eager[:k] == [0] * k  # CPU operands launch nothing
        assert eager[k:] == ex.deltas[k:]
        n_rot = sum(1 for s in op.plan.steps if s.offset)
        assert ex.deltas[k:k + 2] == [0, n_rot]
        n_phases = len(op.plan.phases)
        assert {op_.__name__: d for op_, d in zip(KERNEL_OPS, ex.deltas[:k]) if d} == {
            "halo_pack": n_phases, "halo_unpack": n_phases}


def test_exchange_refuses_operands_it_was_not_built_for(operators):
    """The exchange copies V into its static buffer: V of another device,
    dtype or shape is refused, not quietly converted."""
    from repro_torch.core.machines import BLUE_WATERS
    from repro_torch.sparse.spmbv import _make_distributed_spmbv

    op = _make_distributed_spmbv(operators["fd"], _mesh(), "optimal", t=4, machine=BLUE_WATERS,
                                 backend="pallas")
    ex = op.exchange(op.plan, 4, torch.float64)
    good = torch.zeros(8, op.rmax, 4, dtype=torch.float64)
    for bad in (good.to("meta"), good.float(), good[:, :, :3]):
        with pytest.raises(ValueError, match="exchange of"):
            ex.run(bad)
    with pytest.raises(ValueError, match="exchange of"):
        op.matvec_fn()(op.shard_vector(_block(operators["fd"].shape[0], 4)).to("meta"))
    assert ex.runs == 0
    assert ex.run(good) is ex.xfull and ex.runs == 1


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
    (dict(overlap=True, tune="model:structural"), "queue 1 item 9"),
    (dict(tune="model"), "queue 1 item 9"),
    (dict(t="auto"), "queue 1 item 6b"),
    (dict(method="sstep", t="auto"), "queue 1 item 6b"),
])
def test_unported_distributed_options_raise(operators, override, item):
    """The options that raised until their ROADMAP.md ``item`` was ported
    (tuning, ``t="auto"``) now build and solve on the mesh: the handle
    records the applied tuner config (and, for ``t="auto"``, the
    selection, whose config it runs)."""
    from repro_torch.solver import ECGSolver, SolverConfig

    a = operators["fd"]
    b = _rhs(a.shape[0])
    solver = ECGSolver.build(a, _mesh(), SolverConfig(tol=1e-8 * np.linalg.norm(b)).replace(**override))
    res = solver.solve(b)
    assert res.converged and solver.tuned is not None
    assert solver.op.plan.strategy == solver.tuned.strategy and solver.op.overlap == solver.tuned.overlap
    if override.get("t") == "auto":
        assert res.selection is solver.selection and res.t == solver.selection.t
        assert solver.tuned.selection is solver.selection


def test_cli_runs_the_virtual_mesh_and_refuses_tuned(capsys):
    from repro_torch.launch import solve as port_cli

    port_cli.main(["--matrix", "fd", "--elements", "4", "--t", "4", "--devices", "8", "--ppn", "4",
                   "--strategy", "3step", "--backend", "pallas", "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("distributed ECG[classic/3step/pallas] t=4 on 8 devices:")
    assert "converged=True" in line
    for flags, item in ((["--t", "auto", "--tune", "off"], "cannot run with --tune off"),
                        (["--strategy", "3step", "--method", "pipelined", "--precondition",
                          "inexact"], "cannot absorb")):
        with pytest.raises(SystemExit):
            port_cli.main(["--matrix", "fd", "--elements", "4", "--devices", "8", "--ppn", "4",
                           "--device", "cpu", *flags])
        assert item in capsys.readouterr().err
    # --strategy tuned runs the tuner on the mesh (it was refused before
    # the tuner was ported)
    port_cli.main(["--matrix", "fd", "--elements", "4", "--t", "4", "--devices", "8", "--ppn", "4",
                   "--strategy", "tuned", "--backend", "pallas", "--device", "cpu"])
    out = capsys.readouterr().out
    assert re.search(r"^tuned\[model\]: strategy=\w+ tile=\(\d+, \d+\) kmax=\d+", out, re.M)
    assert "converged=True" in out.strip().splitlines()[-1]
    # the overlap schedule and the other schemes run (they were refused
    # before they were ported)
    port_cli.main(["--matrix", "fd", "--elements", "4", "--t", "4", "--devices", "8", "--ppn", "4",
                   "--strategy", "3step", "--backend", "pallas", "--device", "cpu", "--overlap",
                   "--method", "sstep", "--s", "2"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("distributed ECG[sstep[s=2]/3step/pallas/overlap] t=4 on 8 devices:")
    assert "converged=True" in line


if __name__ == "__main__":
    _reference_results(sys.argv[1])
