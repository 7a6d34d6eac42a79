"""Port parity: telemetry (``repro_torch.observe``) against ``repro.observe``.

The tracer, the sinks, the rolling window and the timer are pure host code,
so the same script of operations under the same injected clock must give
equal records, equal JSONL bytes and equal Chrome traces in both packages
(exact).  The solver's spans on a small sequential solve and a
``solve_packed`` (``fd_laplace_2d(12)``, t = 4, float64): names, categories
and attributes (widths, iteration counts, groups) equal to the reference's
span for span, and the counters equal.  Tracing is observation only: a
traced solve equals an untraced one bit for bit.  The drift helpers:
``calibrated_drift`` equal to the reference's, ``predicted_iteration_
seconds`` equal to the reference's formula on the same plan and config
(1e-12 relative), and ``bytes_drift`` on a ``VirtualMesh(2, 4)`` at two
widths: the bytes the exchange moved at least ``plan.wire_bytes``, and
equal to the sum of its rotation buffers (the reference's HLO count of the
same plan is held equal in ``tests/test_torch_distributed.py``).
"""

import json
import types

import numpy as np
import pytest
import torch

import repro.observe as ref_observe
import repro_torch.observe as port_observe


class FakeClock:
    """Deterministic injectable clock: every read advances 0.25 s."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.25
        return self.t


def _script(obs, tmp, tag):
    """One fixed sequence of tracer operations; returns the records."""
    mem = obs.MemorySink()
    jsonl = obs.JsonlSink(str(tmp / f"{tag}.jsonl"))
    chrome = obs.ChromeTraceSink(str(tmp / f"{tag}.json"), pid=3)
    tr = obs.Tracer(sinks=[mem, jsonl, chrome], clock=FakeClock())
    with tr.span("outer", cat="build", n=5) as sp:
        with tr.span("outer/inner", cat="build"):
            tr.counter("c.one", 1, where="inner")
        sp.args["t"] = 4
        tr.gauge("g.drift", 1.5, strategy="optimal")
    tr.emit("serve/queue_wait", 0.1, 0.6, cat="serve", request_id=7)
    sp2 = tr.begin("paired", cat="solve", width=8)
    tr.instant("solve/width_change", k=3, before=8, after=4)
    tr.end(sp2, iters=12)
    with pytest.raises(RuntimeError):
        with tr.span("failing", cat="build"):
            raise RuntimeError("boom")
    tr.counter("c.one", 2)
    open_after = tr.open_spans
    tr.close()
    return dict(
        spans=[s.to_dict() for s in mem.spans], metrics=mem.metrics,
        by_name=[s.to_dict() for s in mem.by_name("outer")],
        counter=mem.counter_value("c.one"), missing=mem.counter_value("nope"),
        open=open_after,
        jsonl=(tmp / f"{tag}.jsonl").read_bytes(),
        chrome=json.loads((tmp / f"{tag}.json").read_text()),
    )


def test_tracer_and_sinks_equal_the_reference(tmp_path):
    want = _script(ref_observe, tmp_path, "ref")
    got = _script(port_observe, tmp_path, "port")
    assert got == want
    assert got["open"] == 0 and got["spans"][-1]["args"]["error"] == "RuntimeError"


def test_open_sink_and_null_tracer(tmp_path):
    for obs in (ref_observe, port_observe):
        assert isinstance(obs.open_sink(str(tmp_path / "x.jsonl")), obs.JsonlSink)
        assert isinstance(obs.open_sink(str(tmp_path / "x.json")), obs.ChromeTraceSink)
        null = obs.NULL_TRACER
        assert not null.enabled and null.span("a") is null.span("b")
        with null.span("a") as sp:
            sp.args["x"] = 1
        assert dict(sp.args) == {}
        assert obs.get_tracer() is null and obs.coerce_tracer(None) is null
        tr = obs.Tracer()
        prev = obs.set_tracer(tr)
        try:
            assert prev is null and obs.get_tracer() is tr and obs.coerce_tracer(None) is tr
            other = obs.Tracer()
            assert obs.coerce_tracer(other) is other
        finally:
            obs.set_tracer(None)
        assert obs.get_tracer() is null


def test_rolling_window_equals_the_reference():
    rng = np.random.default_rng(0)
    stamps = np.cumsum(rng.uniform(0.0, 3.0, 40))
    values = rng.uniform(0.01, 2.0, 40)
    out = []
    for obs in (ref_observe, port_observe):
        w = obs.RollingWindow(window_s=10.0)
        empty = w.snapshot(0.0)
        snaps = []
        for ts, v in zip(stamps, values):
            w.add(ts, v)
            snaps.append((len(w), w.snapshot(ts + 1.0)))
        out.append((empty, snaps))
        with pytest.raises(ValueError, match="window_s"):
            obs.RollingWindow(window_s=0)
    assert out[0] == out[1]
    assert out[1][0]["n"] == 0 and out[1][0]["p50"] is None


def test_timed_median_equals_the_reference():
    calls = []

    def fn(x, scale=1):
        calls.append(x)
        return torch.full((3,), float(x * scale))

    results = []
    for obs in (ref_observe, port_observe):
        sink = obs.MemorySink()
        tr = obs.Tracer(sinks=[sink], clock=FakeClock())
        out, s = obs.timed_median(fn, 2, repeats=4, warmup=2, label="unit", tracer=tr, scale=3)
        results.append((s, [(sp.name, sp.cat, dict(sp.args)) for sp in sink.spans]))
        assert torch.equal(torch.as_tensor(np.asarray(out)), torch.full((3,), 6.0))
        with pytest.raises(ValueError, match="repeats"):
            obs.timed_median(fn, 1, repeats=0)
        assert obs.timed_median_us(fn, 1, repeats=1, sync=False) >= 0
    assert results[0] == results[1]
    assert results[1][0] == 0.25 and len(results[1][1]) == 4


def test_timer_hook_of_the_tuner_reaches_the_ambient_tracer():
    from repro_torch.analysis.ecg_bench import _timeit

    sink = port_observe.MemorySink()
    prev = port_observe.set_tracer(port_observe.Tracer(sinks=[sink]))
    try:
        us = _timeit(lambda v: v * 2, torch.ones(4), repeats=3)
    finally:
        port_observe.set_tracer(prev)
    assert us >= 0
    assert [(s.name, s.args["rep"]) for s in sink.spans] == [("bench/ecg_bench", i) for i in range(3)]


# ----------------------------------------------------------------- solver spans
N_FD = 12
CFG = dict(t=4, tol=1e-8, max_iters=300)
PACK_TOLS = (1e-3, 1e-6, 1e-9)


def _system():
    from repro.sparse import fd_laplace_2d

    a = fd_laplace_2d(N_FD)
    rng = np.random.default_rng(7)
    bs = [rng.standard_normal(a.shape[0]) for _ in range(len(PACK_TOLS))]
    return a, bs


def _port_csr(a):
    from repro_torch.sparse.csr import CSRMatrix

    return CSRMatrix.from_numpy(np.asarray(a.indptr), np.asarray(a.indices), np.asarray(a.data),
                                a.shape, device="cpu")


def _same(u, v):
    """Equal bit for bit, NaN padding included."""
    return u.shape == v.shape and bool(((u == v) | (u.isnan() & v.isnan())).all())


def _records(sink):
    spans = [(s.name, s.cat, dict(s.args)) for s in sink.spans]
    metrics = [(m["kind"], m["name"], m["value"], m["attrs"]) for m in sink.metrics]
    return spans, metrics


@pytest.fixture(scope="module")
def traced():
    """The same traced session in both packages: a build, one solve and one
    packed solve of three requests (backend pallas: the build's convert
    span), each on a fresh sink."""
    import jax

    jax.config.update("jax_enable_x64", True)
    from repro.solver import ECGSolver as RefSolver, SolverConfig as RefConfig
    from repro_torch.solver import ECGSolver, SolverConfig

    a, bs = _system()
    out = {}
    for tag, solver_cls, cfg_cls, obs, kw, mat in (
        ("ref", RefSolver, RefConfig, ref_observe, {}, a),
        ("port", ECGSolver, SolverConfig, port_observe, dict(device="cpu"), _port_csr(a)),
    ):
        rows = {}
        sink = obs.MemorySink()
        solver = solver_cls.build(mat, config=cfg_cls(**CFG, adaptive="rankrev", kernel="pallas"),
                                  tracer=obs.Tracer(sinks=[sink]), **kw)
        rows["build"] = _records(sink)
        sink.spans.clear(), sink.metrics.clear()
        res = solver.solve(bs[0])
        rows["solve"] = _records(sink)
        rows["solve_iters"] = res.n_iters
        sink.spans.clear(), sink.metrics.clear()
        packed = solver.solve_packed(bs, tols=list(PACK_TOLS))
        rows["packed"] = _records(sink)
        rows["packed_iters"] = [r.n_iters for r in packed]
        rows["solver"] = solver
        out[tag] = rows
    return out


def test_build_spans_equal_the_reference(traced):
    got, want = traced["port"]["build"], traced["ref"]["build"]
    assert got == want
    assert [name for name, _, _ in got[0]] == ["build/convert", "build"]


def test_solve_spans_equal_the_reference(traced):
    got, want = traced["port"]["solve"], traced["ref"]["solve"]
    assert traced["port"]["solve_iters"] == traced["ref"]["solve_iters"]
    assert got == want
    names = [name for name, _, _ in got[0]]
    assert names == ["solve/dispatch", "solve/finalize", "solve/segment"]
    seg = got[0][-1][2]
    assert seg["width"] == 4 and seg["iters"] == traced["port"]["solve_iters"]


def test_packed_spans_equal_the_reference(traced):
    got, want = traced["port"]["packed"], traced["ref"]["packed"]
    assert traced["port"]["packed_iters"] == traced["ref"]["packed_iters"]
    assert got == want
    assert [name for name, _, _ in got[0]] == ["solve_packed/dispatch", "solve_packed/finalize"]
    assert got[0][0][2] == dict(width=12, groups=3)
    assert got[1] == [("counter", "solver.solves", 4, {})]


def test_with_config_shares_the_tracer(traced):
    solver = traced["port"]["solver"]
    assert solver.with_config(tol=1e-6)._tracer is solver._tracer
    assert solver.with_config(t=2)._tracer is solver._tracer


def test_tracing_off_is_bit_identical():
    from repro_torch.solver import ECGSolver, SolverConfig

    a, bs = _system()
    mat = _port_csr(a)
    cfg = SolverConfig(**CFG, adaptive="rankrev")
    plain = ECGSolver.build(mat, config=cfg, device="cpu")
    traced_ = ECGSolver.build(mat, config=cfg, device="cpu",
                              tracer=port_observe.Tracer(sinks=[port_observe.MemorySink()]))
    r0, r1 = plain.solve(bs[0]), traced_.solve(bs[0])
    assert _same(r0.x, r1.x) and _same(r0.res_hist, r1.res_hist)
    assert r0.n_iters == r1.n_iters
    p0, p1 = plain.solve_packed(bs, tols=list(PACK_TOLS)), traced_.solve_packed(bs, tols=list(PACK_TOLS))
    for u, v in zip(p0, p1):
        assert _same(u.x, v.x) and _same(u.res_hist, v.res_hist)
        assert u.pack == v.pack


def test_segmented_solve_emits_segment_spans_with_the_plan_accounting():
    """A distributed ``reduce`` solve of a right-hand side on half the
    subdomains: one ``solve/segment`` span per width segment, carrying the
    re-sliced plan's wire bytes, and a width-change instant."""
    from repro_torch.core.machines import BLUE_WATERS
    from repro_torch.launch.mesh import VirtualMesh
    from repro_torch.solver import CommConfig, ECGSolver, SolverConfig
    from repro_torch.sparse import fd_laplace_2d

    a = fd_laplace_2d(13, device="cpu")
    n = a.shape[0]
    b = np.zeros(n)
    b[: n // 2] = np.random.default_rng(7).standard_normal(n // 2)
    sink = port_observe.MemorySink()
    solver = ECGSolver.build(a, VirtualMesh(2, 4, device="cpu"), SolverConfig(
        t=4, tol=1e-8, max_iters=300, adaptive="reduce",
        comm=CommConfig(strategy="optimal", machine=BLUE_WATERS)),
        tracer=port_observe.Tracer(sinks=[sink]))
    assert [s.name for s in sink.spans] == ["build/partition", "build/operator", "build/reducers",
                                            "build"]
    res = solver.solve(b)
    segs = sink.by_name("solve/segment")
    assert [(s.args["width"], s.args["iters"]) for s in segs] == res.comm_segments
    assert len(segs) >= 2
    for s in segs:
        assert s.args["wire_bytes"] == solver.op.plan.at_width(s.args["width"]).wire_bytes(8)
        assert s.args["psums_per_iter"] == 2.0
    changes = [m for m in sink.metrics if m["name"] == "solve/width_change"]
    assert [(m["attrs"]["k"], m["attrs"]["before"], m["attrs"]["after"]) for m in changes] \
        == res.reduction_events()


# ------------------------------------------------------------------ drift
def test_calibrated_drift_equals_the_reference():
    from repro.observe.drift import calibrated_drift as ref_cal
    from repro_torch.observe.drift import calibrated_drift

    rows = [dict(time_drift=2.0), dict(time_drift=4.0), dict(time_drift=8.0),
            dict(time_drift=None)]
    assert calibrated_drift(rows) == ref_cal(rows)
    assert [r["calibrated_time_drift"] for r in calibrated_drift(rows)] == [0.5, 1.0, 2.0, None]
    assert "calibrated_time_drift" not in rows[0]


def test_drift_helpers_need_a_mesh():
    from repro_torch.observe.drift import bytes_drift, predicted_iteration_seconds
    from repro_torch.solver import ECGSolver, SolverConfig

    a, _ = _system()
    solver = ECGSolver.build(_port_csr(a), config=SolverConfig(t=4), device="cpu")
    for fn in (predicted_iteration_seconds, bytes_drift):
        with pytest.raises(ValueError, match="distributed"):
            fn(solver)


@pytest.fixture(scope="module")
def mesh_handles():
    from repro_torch.core.machines import BLUE_WATERS
    from repro_torch.launch.mesh import VirtualMesh
    from repro_torch.solver import CommConfig, ECGSolver, SolverConfig
    from repro_torch.sparse import fd_laplace_2d

    a = fd_laplace_2d(13, device="cpu")
    return {s: ECGSolver.build(a, VirtualMesh(2, 4, device="cpu"), SolverConfig(
        t=4, comm=CommConfig(strategy=s, machine=BLUE_WATERS))) for s in ("standard", "optimal")}


@pytest.mark.parametrize("strategy", ["standard", "optimal"])
def test_predicted_iteration_seconds_equals_the_reference(mesh_handles, strategy):
    """The reference's formula on the reference's own plan and config
    (built on the host, no devices needed) against the port's handle."""
    from repro.core.machines import BLUE_WATERS as REF_BW
    from repro.core.node_aware import build_exchange_plan
    from repro.observe.drift import predicted_iteration_seconds as ref_pred
    from repro.solver import CommConfig as RefComm, SolverConfig as RefConfig
    from repro.sparse import fd_laplace_2d, partition_csr
    from repro_torch.observe.drift import predicted_iteration_seconds

    a = fd_laplace_2d(13)
    plan = build_exchange_plan(partition_csr(a, 8), 2, 4, strategy, t=4, machine=REF_BW)
    fake = types.SimpleNamespace(
        op=types.SimpleNamespace(plan=plan, p=8), a=a, t=4, tuned=None,
        config=RefConfig(t=4, comm=RefComm(strategy=strategy, machine=REF_BW)))
    port = mesh_handles[strategy]
    for w in (4, 2):
        want = ref_pred(fake, w)
        assert predicted_iteration_seconds(port, w) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("strategy", ["standard", "optimal"])
def test_bytes_drift_against_the_plan(mesh_handles, strategy):
    from repro_torch.observe.drift import bytes_drift, model_drift

    solver = mesh_handles[strategy]
    for w in (4, 2):
        bd = bytes_drift(solver, w)
        plan = solver.op.plan.at_width(w)
        assert bd["plan_bytes"] == plan.wire_bytes(8)
        # every rotation moves its whole (p, segment, w) buffer
        rotated = sum(solver.mesh.p * (ph.bounds[i + 1] - ph.bounds[i]) * w * 8
                      for ph in plan.phases for i, off in enumerate(ph.offsets) if off)
        assert bd["moved_bytes"] == rotated >= bd["plan_bytes"] > 0
        assert bd["ratio"] == bd["moved_bytes"] / bd["plan_bytes"]
        # a second apply (an eager exchange again on the CPU) counts the same
        assert bytes_drift(solver, w) == bd
    sink = port_observe.MemorySink()
    rows = model_drift(solver, [(4, 10, 0.01), (2, 0, 0.0), (2, 5, 0.004)],
                       tracer=port_observe.Tracer(sinks=[sink]))
    assert [(r["t_active"], r["iters"]) for r in rows] == [(4, 10), (2, 5)]
    assert [m["name"] for m in sink.metrics] == ["model_drift", "model_drift"]
    assert rows[0]["moved_bytes"] == bytes_drift(solver, 4)["moved_bytes"]
