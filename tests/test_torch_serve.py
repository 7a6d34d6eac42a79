"""Port parity: the serving layer (``repro_torch.serve``) against ``repro.serve``.

Inputs are the reference test's operators (``tests/test_serve.py``:
``fd_laplace_2d(12)``, ``aniso_laplace_2d(10, eps=0.01)``,
``dg_laplace_2d((4, 3), block=4)``), carried to the port's CSR on the CPU.

Host artefacts are held **exactly**: fingerprints (also of a CSR whose rows
are stored in reverse order, which takes the sort), ``operator_nbytes``,
``payload_key``, ``config_digest``, ``mesh_tag``, the LRU order, the
warm-start cache files (an entry written by either package loads in the
other), a 12-request trace replayed through both servers (``stats()``
without its wall times, batch and pack layouts, the metric sequence) and
the configuration errors.  Device results in float64: batched equals solo
in the port bit for bit; the sequential ``solve_packed`` per request
against the reference's: ``n_iters``, ``retired_iter`` and ``packed_iters``
equal, x and ``res_hist`` within 1e-9 (relative to max|x| and per entry,
the history's rounding floor excepted), the x0-at-tolerance case too.  On
these operators every request retires at the first retirement; past it
the port restarts the pack where the reference drops directions
(``repro_torch.core.methods.classic``), held on ``dg_laplace_2d((16, 12),
block=8)``: the first retirement equal, then the reference's live requests
stall at ``max_iters`` and the port's converge within their solo counts.
``launch/serve.py --device cpu`` prints the reference CLI's layout.
"""

import dataclasses
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.serve as R
import repro_torch.serve as P

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _x64():
    import jax

    jax.config.update("jax_enable_x64", True)


@pytest.fixture(scope="module")
def operators():
    from repro.sparse import aniso_laplace_2d, dg_laplace_2d, fd_laplace_2d

    return [fd_laplace_2d(12), aniso_laplace_2d(10, eps=0.01), dg_laplace_2d((4, 3), block=4)]


def _port(a):
    from repro_torch.sparse.csr import CSRMatrix

    return CSRMatrix.from_numpy(np.asarray(a.indptr), np.asarray(a.indices), np.asarray(a.data),
                                a.shape, device="cpu")


@pytest.fixture(scope="module")
def port_ops(operators):
    return [_port(a) for a in operators]


def _reorder_rows(a):
    """Same matrix, each row's entries stored in reversed order."""
    indptr = np.asarray(a.indptr)
    indices = np.asarray(a.indices).copy()
    data = np.asarray(a.data).copy()
    for i in range(a.shape[0]):
        lo, hi = indptr[i], indptr[i + 1]
        indices[lo:hi] = indices[lo:hi][::-1]
        data[lo:hi] = data[lo:hi][::-1]
    return dataclasses.replace(a, indices=indices, data=data)


def _ref_cfg(**kw):
    from repro.solver import SolverConfig

    return SolverConfig(**kw)


def _port_cfg(**kw):
    from repro_torch.solver import SolverConfig

    return SolverConfig(**kw)


# ------------------------------------------------------------- host artefacts
def test_fingerprints_and_sizes_equal_the_reference(operators, port_ops):
    for a, pa in zip(operators, port_ops):
        assert P.fingerprint_csr(pa) == R.fingerprint_csr(a)
        assert P.operator_nbytes(pa) == R.operator_nbytes(a)
        rev = _reorder_rows(a)
        assert P.fingerprint_csr(_port(rev)) == R.fingerprint_csr(rev) == R.fingerprint_csr(a)
    data = np.asarray(operators[0].data).copy()
    data[7] += 1e-13
    bumped = dataclasses.replace(operators[0], data=data)
    assert P.fingerprint_csr(_port(bumped)) == R.fingerprint_csr(bumped) != R.fingerprint_csr(operators[0])
    assert len({P.fingerprint_csr(pa) for pa in port_ops}) == 3


def test_payload_keys_equal_the_reference(operators, port_ops):
    fp = P.fingerprint_csr(port_ops[0])
    rng = np.random.default_rng(3)
    b = rng.standard_normal(operators[0].shape[0])
    x0 = rng.standard_normal(operators[0].shape[0])
    for args in ((b,), (b, x0), (b, None, 1e-4), (b, x0, 1e-8)):
        assert P.payload_key(fp, *args) == R.payload_key(fp, *args)
    assert P.payload_key(fp, torch.as_tensor(b)) == R.payload_key(fp, b)
    assert P.payload_key(fp, b) == P.payload_key(fp, b, tol=None) != P.payload_key(fp, b, tol=1e-4)


@pytest.mark.parametrize("kw", [
    dict(t=4, adaptive="rankrev"),
    dict(t=4, tol=1e-8, adaptive="rankrev", kernel="pallas"),
    dict(t=2, max_iters=50),
    dict(t=8, tol=1e-6, adaptive="reduce", comm=dict(strategy="optimal")),
    dict(t="auto", adaptive="rankrev", tune="model"),
])
def test_config_digest_equals_the_reference(kw):
    assert P.config_digest(_port_cfg(**kw)) == R.config_digest(_ref_cfg(**kw))


def test_mesh_tag_equals_the_reference():
    from repro_torch.launch.mesh import VirtualMesh

    assert P.mesh_tag(None) == R.mesh_tag(None) == "seq"
    ref_mesh = types.SimpleNamespace(devices=np.empty((2, 4)))
    assert P.mesh_tag(VirtualMesh(2, 4, device="cpu")) == R.mesh_tag(ref_mesh) == "2x4"


def test_default_solver_template_is_the_reference():
    assert P.ServeConfig().solver.to_json() == R.ServeConfig().solver.to_json()
    assert P.ServeConfig().solver.kernel.backend == "jnp"
    assert P.config_digest(P.ServeConfig().solver) == R.config_digest(R.ServeConfig().solver)


# ----------------------------------------------------------------- registry
def test_lru_order_equals_the_reference(operators, port_ops):
    nbytes = max(R.operator_nbytes(a) for a in operators)
    order = [0, 1, 0, 2, 1, 1, 0, 2]
    out = []
    for pkg, ops, cfg, kw in ((R, operators, _ref_cfg(t=2, max_iters=50), {}),
                              (P, port_ops, _port_cfg(t=2, max_iters=50), dict(device="cpu"))):
        reg = pkg.OperatorRegistry(pkg.ServeConfig(solver=cfg, registry_bytes=2 * nbytes), **kw)
        trail = []
        for i in order:
            key, _ = reg.get(ops[i])
            trail.append((key, reg.fingerprints(), reg.hits, reg.misses, reg.evictions,
                          reg.total_bytes))
        st = reg.stats()
        out.append((trail, {k: st[k] for k in ("hits", "misses", "evictions", "resident",
                                               "resident_bytes", "warm_builds", "cold_builds")}))
    assert out[0] == out[1]
    assert out[1][1]["evictions"] > 0


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_cache_entries_load_in_the_other_package(operators, port_ops, tmp_path, writer):
    """A tuned pallas session's entry (tuned config and conversion meta),
    written by one package, is a warm hit in the other: the tile analysis
    is skipped and the reader's own entry would be the same JSON."""
    kw = dict(t=4, tol=1e-8, adaptive="rankrev", kernel="pallas", tune="model")
    a, pa = operators[0], port_ops[0]
    regs = {
        "ref": lambda d: R.OperatorRegistry(R.ServeConfig(solver=_ref_cfg(**kw), cache_dir=str(d))),
        "port": lambda d: P.OperatorRegistry(P.ServeConfig(solver=_port_cfg(**kw), cache_dir=str(d)),
                                             device="cpu"),
    }
    mats = {"ref": a, "port": pa}
    reader = "port" if writer == "ref" else "ref"
    d = tmp_path / "shared"
    regs[writer](d).get(mats[writer])
    (name,) = os.listdir(d)
    written = json.loads((d / name).read_text())
    assert written["schema"] == 2 and written["tuned"] is not None
    assert isinstance(written["conversion"], dict)
    reg = regs[reader](d)
    _, solver = reg.get(mats[reader])
    rec = reg.build_records[-1]
    assert rec["warm"] and not rec["conv_analyzed"] and not rec["conv_reused"]
    assert tuple(solver.tuned.ell_block) == (written["tuned"]["br"], written["tuned"]["bc"])
    # the reader's own cold entry is the same file with the same JSON,
    # but for the tuned payload: an unset machine means the H100's measured
    # constants in the port and the TPU set in the reference
    own = tmp_path / "own"
    regs[reader](own).get(mats[reader])
    assert os.listdir(own) == [name]
    mine = json.loads((own / name).read_text())
    machines = {mine.pop("tuned")["machine"]["name"], written.pop("tuned")["machine"]["name"]}
    assert mine == written and len(machines) == 2


def test_eviction_readmission_reuses_the_conversion(port_ops):
    """As the reference's ``TestConversionWarmStart``: re-admission of an
    evicted operator rebuilds with zero re-conversions, bit-identically."""
    cfg = P.ServeConfig(solver=_port_cfg(t=4, tol=1e-8, adaptive="rankrev", kernel="pallas"),
                        registry_bytes=1)
    reg = P.OperatorRegistry(cfg, device="cpu")
    k1, s1 = reg.get(port_ops[0])
    assert s1.stats.conv_analyzed and not s1.stats.conv_reused
    reg.get(port_ops[1])
    assert k1 not in reg
    _, s1b = reg.get(port_ops[0])
    assert s1b.stats.conv_reused and not s1b.stats.conv_analyzed
    b = np.random.default_rng(19).standard_normal(port_ops[0].shape[0])
    assert torch.equal(s1.solve(b).x, s1b.solve(b).x)
    st = reg.stats()
    assert st["conv_reused"] == 1 and st["conv_resident"] == 2


# -------------------------------------------------------------------- traffic
N_REQUESTS = 12


def _trace(ops):
    rng = np.random.default_rng(5)
    reqs = []
    for i in range(N_REQUESTS - 2):
        a = ops[i % 2]
        reqs.append((i % 2, rng.standard_normal(a.shape[0])))
    return reqs + [reqs[0], reqs[1]]  # 2 duplicate payloads


def _replay(pkg, ops, cfg, packing, **kw):
    sink = (R if pkg is R else P).__dict__  # noqa: F841 (package marker)
    obs = __import__("repro.observe" if pkg is R else "repro_torch.observe", fromlist=["x"])
    mem = obs.MemorySink()
    server = pkg.ECGServer(pkg.ServeConfig(solver=cfg, max_batch=4, packing=packing),
                           tracer=obs.Tracer(sinks=[mem]), **kw)
    tickets = [server.submit(ops[i], b) for i, b in _trace(ops)]
    server.flush()
    assert all(tk.done for tk in tickets)
    st = server.stats()
    for section in ("registry", "queue"):
        for key in ("builds", "rolling"):
            st[section].pop(key, None)
    layout = [(tk.request_id, tk.batch_id, tk.batch_size, tk.deduped, tk.pack_id, tk.pack_width,
               tk.group_index) for tk in tickets]
    metrics = [(m["kind"], m["name"], m["value"]) for m in mem.metrics]
    spans = [s.name for s in mem.spans]
    return st, layout, metrics, spans, tickets


@pytest.mark.parametrize("packing", ["off", "width"])
def test_replayed_trace_equals_the_reference(operators, port_ops, packing):
    ref = _replay(R, operators, _ref_cfg(t=4, tol=1e-8, adaptive="rankrev"), packing)
    got = _replay(P, port_ops, _port_cfg(t=4, tol=1e-8, adaptive="rankrev"), packing,
                  device="cpu")
    assert got[0] == ref[0]  # stats without wall times
    assert got[1] == ref[1]  # batch / pack layout per ticket
    assert got[2] == ref[2]  # counter and gauge sequence
    assert got[3] == ref[3]  # span names, in closing order
    for tk, rk in zip(got[4], ref[4]):
        assert tk.result.n_iters == rk.result.n_iters
        if packing == "width":
            # both at the rounding floor of this small system
            assert tk.relres == pytest.approx(rk.relres, abs=1e-12) and tk.relres <= 1e-8
    assert got[0]["queue"]["completed"] == N_REQUESTS


def test_batched_equals_solo_bit_for_bit(port_ops):
    server = P.ECGServer(P.ServeConfig(solver=_port_cfg(t=4, tol=1e-8, adaptive="rankrev"),
                                       max_batch=4), device="cpu")
    rng = np.random.default_rng(1)
    reqs = []
    for i in range(9):
        a = port_ops[i % 3]
        b = rng.standard_normal(a.shape[0])
        reqs.append((i % 3, b, server.submit(a, b)))
    server.flush()
    solo = [P.OperatorRegistry(server.config, device="cpu").get(a)[1] for a in port_ops]
    for i, b, tk in reqs:
        ref = solo[i].solve(b)
        assert torch.equal(tk.result.x, ref.x) and tk.result.n_iters == ref.n_iters
        hist, want = tk.result.res_hist, ref.res_hist
        assert bool(((hist == want) | (hist.isnan() & want.isnan())).all())
    x = server.solution(reqs[0][2])
    assert isinstance(x, np.ndarray) and x.shape == (port_ops[0].shape[0],)
    hist = list(server.stream_residuals(reqs[0][2]))
    assert len(hist) == reqs[0][2].result.n_iters + 1


# ----------------------------------------------------------------- packing
PACK_TOLS = [1e-4, 1e-6, 1e-8, 1e-8]


def _packed_pair(a, pa, bs, tols=None, x0s=None):
    from repro.solver import ECGSolver as RefSolver
    from repro_torch.solver import ECGSolver

    kw = dict(t=4, tol=1e-8, adaptive="rankrev")
    ref = RefSolver.build(a, config=_ref_cfg(**kw)).solve_packed(bs, x0s=x0s, tols=tols)
    got = ECGSolver.build(pa, config=_port_cfg(**kw), device="cpu").solve_packed(bs, x0s=x0s,
                                                                               tols=tols)
    return ref, got


def _assert_packed_equal(ref, got):
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        assert g.pack == r.pack or {k: v for k, v in g.pack.items() if k != "packed_iters"} == \
            {k: v for k, v in r.pack.items() if k != "packed_iters"}
        assert g.n_iters == r.n_iters and bool(g.converged) == bool(r.converged)
        rx, gx = np.asarray(r.x), g.x.numpy()
        np.testing.assert_allclose(gx, rx, rtol=0, atol=1e-9 * np.abs(rx).max())
        rh, gh = np.asarray(r.res_hist), g.res_hist.numpy()
        assert np.array_equal(np.isnan(rh), np.isnan(gh))
        ok = ~np.isnan(rh)
        np.testing.assert_allclose(gh[ok], rh[ok], rtol=1e-9, atol=1e-14 * rh[0])


@pytest.mark.parametrize("op", [0, 1])
def test_solve_packed_equals_the_reference(operators, port_ops, op):
    a, pa = operators[op], port_ops[op]
    rng = np.random.default_rng(11 + op)
    bs = [rng.standard_normal(a.shape[0]) for _ in range(4)]
    ref, got = _packed_pair(a, pa, bs, tols=PACK_TOLS)
    _assert_packed_equal(ref, got)
    iters = [r.n_iters for r in got]
    assert iters[0] <= iters[1] <= iters[2]
    assert all(r.pack["retired_iter"] == r.n_iters for r in got)


def test_packed_retirement_restarts_where_the_reference_stalls():
    from repro.solver import ECGSolver as RefSolver
    from repro.sparse import dg_laplace_2d
    from repro_torch.solver import ECGSolver

    a = dg_laplace_2d((16, 12), block=8)
    pa = _port(a)
    bs = [np.random.default_rng(100 + j).standard_normal(a.shape[0]) for j in range(4)]
    tols = [c * np.linalg.norm(b) for c, b in zip(PACK_TOLS, bs)]
    kw = dict(t=4, tol=1e-8, adaptive="rankrev", max_iters=400)
    ref = RefSolver.build(a, config=_ref_cfg(**kw)).solve_packed(bs, tols=tols)
    solver = ECGSolver.build(pa, config=_port_cfg(**kw), device="cpu")
    got = solver.solve_packed(bs, tols=tols)
    solo = [solver.solve(b).n_iters for b in bs]
    # the first retirement on the same iteration; the histories agree to
    # 1e-9 over the first 10 iterations, then part by the DG rounding
    # amplification ROADMAP.md queue 3 describes (8% by iteration 35)
    assert got[0].n_iters == ref[0].n_iters == got[0].pack["retired_iter"]
    np.testing.assert_allclose(got[0].res_hist.numpy()[:10], np.asarray(ref[0].res_hist)[:10],
                               rtol=1e-9)
    assert [bool(r.converged) for r in ref] == [True, False, False, False]
    assert all(r.n_iters == 400 for r in ref[1:])
    dense = pa.todense().numpy()
    for r, b, tol in zip(got, bs, tols):
        assert r.converged and np.linalg.norm(dense @ r.x.numpy() - b) <= tol * 1.01
    assert got[0].pack["packed_iters"] <= max(solo)
    assert [r.n_iters for r in got] == sorted(r.n_iters for r in got)


def test_solve_packed_x0_at_tolerance(operators, port_ops):
    from repro.solver import ECGSolver as RefSolver

    a, pa = operators[0], port_ops[0]
    b = np.random.default_rng(23).standard_normal(a.shape[0])
    b2 = np.random.default_rng(24).standard_normal(a.shape[0])
    x_star = np.asarray(RefSolver.build(a, config=_ref_cfg(t=4, tol=1e-8, adaptive="rankrev"))
                        .solve(b).x)
    ref, got = _packed_pair(a, pa, [b, b2], x0s=[x_star, None])
    _assert_packed_equal(ref, got)
    assert got[0].n_iters == 0 and got[0].pack["retired_iter"] == 0 and got[1].n_iters > 0


def test_packed_server_relres_contract(port_ops):
    a = port_ops[0]
    rng = np.random.default_rng(11)
    bs = [rng.standard_normal(a.shape[0]) for _ in range(4)]
    server = P.ECGServer(P.ServeConfig(solver=_port_cfg(t=4, tol=1e-8, adaptive="rankrev"),
                                       packing=dict(pack="width", max_pack_width=16)), device="cpu")
    tks = [server.submit(a, b, tol=tol) for b, tol in zip(bs, PACK_TOLS)]
    assert all(tk.done for tk in tks)  # capacity 4 -> eager dispatch
    for tk, b, tol in zip(tks, bs, PACK_TOLS):
        dense = a.todense().numpy()
        relres = np.linalg.norm(dense @ server.solution(tk) - b) / np.linalg.norm(b)
        assert tk.relres == pytest.approx(relres, rel=1e-9) and tk.relres <= tol
        assert tk.pack_width == 16 and tk.result.pack["tol"] == tol
    assert server.stats()["queue"]["pack_layouts"] == [
        dict(pack_id=0, width=16, t_each=4, groups=4, comm_segments=[])]


def test_true_relres_and_host_copy(operators, port_ops):
    a, pa = operators[2], port_ops[2]
    rng = np.random.default_rng(18)
    x, b = rng.standard_normal(a.shape[0]), rng.standard_normal(a.shape[0])
    want = R.true_relres(a, x, b)
    assert P.true_relres(pa, x, b) == pytest.approx(want, rel=1e-12)
    assert P.true_relres(P.host_csr(pa), torch.as_tensor(x), b) == pytest.approx(want, rel=1e-12)


# ------------------------------------------------------------------ errors
def _message(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value).__name__, str(info.value)


@pytest.mark.parametrize("bad", [
    dict(registry_bytes=0), dict(max_batch=0), dict(max_wait_s=-1.0), dict(max_pending=0),
    dict(cache_dir=123), dict(packing=dict(pack="columns")), dict(packing=dict(max_pack_width=0)),
    dict(packing=dict(max_wait_s=-0.1)), dict(packing=42),
])
def test_config_validation_messages_equal_the_reference(bad):
    assert _message(lambda: P.ServeConfig(**bad)) == _message(lambda: R.ServeConfig(**bad))


def test_request_and_packing_errors_equal_the_reference(operators, port_ops):
    from repro.solver import ECGSolver as RefSolver
    from repro_torch.solver import ECGSolver

    assert _message(lambda: P.ServeConfig().replace(no_such_field=1)) == \
        _message(lambda: R.ServeConfig().replace(no_such_field=1))
    a, pa = operators[0], port_ops[0]
    b = np.ones(a.shape[0])
    ref_srv = R.ECGServer(R.ServeConfig(solver=_ref_cfg(t=4, adaptive="rankrev")))
    port_srv = P.ECGServer(P.ServeConfig(solver=_port_cfg(t=4, adaptive="rankrev")), device="cpu")
    assert _message(lambda: port_srv.submit(pa, b, tol=1e-4)) == \
        _message(lambda: ref_srv.submit(a, b, tol=1e-4))
    for kw, args in ((dict(t=4, tol=1e-8), ([b],)),
                     (dict(t=4, adaptive="rankrev", method="sstep"), ([b],)),
                     (dict(t=4, adaptive="reduce+restart"), ([b],)),
                     (dict(t=4, adaptive="rankrev"), ([],)),
                     (dict(t=4, adaptive="rankrev"), ([b], [None, None]))):
        want = _message(lambda: RefSolver.build(a, config=_ref_cfg(**kw)).solve_packed(*args))
        got = _message(lambda: ECGSolver.build(pa, config=_port_cfg(**kw), device="cpu")
                       .solve_packed(*args))
        assert got == want
    q = P.RequestQueue(max_pending=1)
    q.submit("f", b)
    assert _message(lambda: q.submit("f", b)) == _message(
        lambda: (lambda rq: (rq.submit("f", b), rq.submit("f", b)))(R.RequestQueue(max_pending=1)))


def test_wide_pack_is_refused_on_the_card_before_device_work(port_ops):
    """On CUDA a pack wider than the 16-column kernels raises before any
    device work; on the CPU (the plain versions) it runs."""
    from repro_torch.solver import ECGSolver

    rng = np.random.default_rng(4)
    bs = [rng.standard_normal(port_ops[0].shape[0]) for _ in range(4)]
    for backend, limit in (("pallas", "queue 2 item 4"), ("jnp", "rank_apply")):
        solver = ECGSolver.build(port_ops[0], config=_port_cfg(
            t=8, tol=1e-8, adaptive="rankrev", kernel=backend), device="cpu")
        res = solver.solve_packed(bs)  # width 32 on the CPU
        assert res[0].pack["width"] == 32 and all(r.converged for r in res)
        solver.device = torch.device("cuda")  # the check reads the handle's device only
        solves = solver.stats.solves
        wide = bs if backend == "pallas" else bs * 2  # jnp: past rank_apply's 32
        with pytest.raises(NotImplementedError, match=limit):
            solver.solve_packed(wide)
        assert solver.stats.solves == solves


# -------------------------------------------------------------------- CLI
def test_serve_cli_on_the_cpu_prints_the_reference_layout(capsys):
    from repro_torch.launch import serve as port_cli

    argv = ["--requests", "10", "--dups", "3", "--scale", "3", "--max-batch", "4"]
    port_cli.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-m", "repro.launch.serve", *argv], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    want = proc.stdout.splitlines()

    def layout(lines):
        # per-request lines without their iteration counts, and the
        # registry/batching summaries (timings and latencies differ)
        keep = []
        for line in lines:
            if line.lstrip().startswith("req "):
                keep.append(line.split("iters=")[0] + line.split("conv=")[1])
            elif line.startswith(("# trace:", "registry:", "batching:")):
                keep.append(line)
        return keep

    def iters(lines):
        return [int(line.split("iters=")[1].split()[0]) for line in lines
                if line.lstrip().startswith("req ")]

    assert layout(got) == layout(want) and len(layout(got)) == 13
    assert all(abs(g - w) <= 1 for g, w in zip(iters(got), iters(want)))
