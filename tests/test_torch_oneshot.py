"""Port parity: the reference's one-shot functional API and its ECG sweep
script (repro_torch vs repro), float64 on the CPU unless noted.

The same numpy inputs (the reference's generators, carried over with
``CSRMatrix.from_numpy``) go through both packages:

* ``ecg_solve`` on ``fd_laplace_2d(16)`` and ``dg_laplace_2d((4, 4),
  block=4)`` under both mappings, t ∈ {1, 4, 8}, backends jnp (the CSR
  product) and pallas (``make_block_ell_apply``), with ``chol_eps`` under
  classic and pipelined, ``t="auto"`` with ``matrix=``: iteration counts
  equal, x within 1e-10 of max|x|, the same ``DeprecationWarning`` text
  but for the handle it names (``repro_torch.solver.ECGSolver``).
  DG solves stop at 1e-6·‖b‖, before rounding is amplified (ROADMAP §3).
  A width-segmented ``exit_below_width``/``resume_state`` run equals the
  monolithic one bit for bit;
* the ``chol_eps`` refusals, ``cg_solve``, ``split_rank`` (exact);
* ``bsr_to_block_ell``/``block_ell_from_csr``/``make_block_ell_apply``:
  arrays exactly equal, applies to 1e-13, ``use_pallas=False`` refused,
  and the one-shot arrays equal to the handle's ``block_ell_arrays``;
* ``make_distributed_spmbv``/``distributed_ecg`` on ``VirtualMesh(2, 4)``
  against the port's handle (bit for bit) and the reference's sequential
  ``ecg_solve`` (iterations), in one process;
* ``make_solver_mesh`` against the reference's shape rule;
* the two sweeps of ``analysis/ecg_bench.py`` at tiny sizes (row names and
  ``derived`` keys; the reference's on a 1 × 1 mesh of the one CPU device)
  and ``launch/perf.py --ecg``.
"""

import json
import types
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.sparse as ref_sparse
from repro.core import cg_solve as ref_cg_solve
from repro.core import ecg_solve as ref_ecg_solve
from repro.core import split_rank as ref_split_rank
from repro.kernels import block_ell_from_csr as ref_block_ell_from_csr
from repro.kernels import bsr_to_block_ell as ref_bsr_to_block_ell
from repro.kernels import make_block_ell_apply as ref_make_block_ell_apply

from repro_torch.core import cg_solve, ecg_solve, split_rank
from repro_torch.kernels import (
    block_ell_arrays,
    block_ell_from_csr,
    bsr_to_block_ell,
    make_block_ell_apply,
)
from repro_torch.sparse import csr_spmbv, csr_spmv, csr_to_bsr
from repro_torch.sparse.csr import CSRMatrix

MATRICES = {
    "fd": (lambda: ref_sparse.fd_laplace_2d(16), 1e-8),
    "dg": (lambda: ref_sparse.dg_laplace_2d((4, 4), block=4), 1e-6),
}
MAX_ITERS = 500


def _port(ra):
    return CSRMatrix.from_numpy(ra.indptr, ra.indices, ra.data, ra.shape, device="cpu")


def _rhs(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n)


def _applies(ra, a, backend):
    """(reference apply, port apply) of one backend."""
    if backend == "pallas":
        return ref_make_block_ell_apply(ra, 8), make_block_ell_apply(a, 8)
    return (lambda v: ref_sparse.csr_spmbv(ra, v)), (lambda v: csr_spmbv(a, v))


def _warned(fn, *args, **kw):
    """(result, the DeprecationWarning messages ``fn`` raised)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn(*args, **kw)
    return out, [str(w.message) for w in caught if w.category is DeprecationWarning]


def _ported(msgs):
    """The reference's warning texts as the port words them: the handle
    they name is the port's own."""
    return [m.replace("repro.solver.ECGSolver", "repro_torch.solver.ECGSolver") for m in msgs]


def _both(ra, b, t, backend="jnp", **kw):
    """The reference's and the port's one-shot solves and warning texts."""
    a = _port(ra)
    ref_apply, port_apply = _applies(ra, a, backend)
    want, w_msgs = _warned(ref_ecg_solve, ref_apply, jnp.asarray(b), t, backend=backend, **kw)
    got, g_msgs = _warned(ecg_solve, port_apply, torch.as_tensor(b), t, backend=backend, **kw)
    assert g_msgs == _ported(w_msgs) and len(g_msgs) == 1
    return want, got


def _assert_same_solve(want, got):
    assert got.n_iters == want.n_iters
    assert got.converged == want.converged and got.breakdown == want.breakdown
    xw, xg = np.asarray(want.x), got.x.numpy()
    assert np.abs(xg - xw).max() <= 1e-10 * np.abs(xw).max()


# ------------------------------------------------------------- ecg_solve
CASES = [("fd", m, t, be) for m in ("contiguous", "round_robin") for t in (1, 4, 8)
         for be in ("jnp", "pallas")] + [
    ("dg", "contiguous", 4, "pallas"), ("dg", "round_robin", 8, "pallas"),
    ("dg", "round_robin", 4, "jnp"), ("dg", "contiguous", 8, "jnp")]


@pytest.mark.parametrize("matrix,mapping,t,backend", CASES)
def test_ecg_solve_matches_reference(matrix, mapping, t, backend):
    make, rtol = MATRICES[matrix]
    ra = make()
    b = _rhs(ra.shape[0])
    want, got = _both(ra, b, t, backend, tol=rtol * np.linalg.norm(b), max_iters=MAX_ITERS,
                      mapping=mapping)
    assert want.converged and got.t == want.t == t
    _assert_same_solve(want, got)


@pytest.mark.parametrize("method", ["classic", "pipelined"])
def test_chol_eps_matches_reference(method):
    ra = ref_sparse.fd_laplace_2d(16)
    b = _rhs(ra.shape[0])
    want, got = _both(ra, b, 4, "pallas", tol=1e-8 * np.linalg.norm(b), max_iters=MAX_ITERS,
                      chol_eps=1e-10, method=method)
    assert want.converged
    _assert_same_solve(want, got)


def test_chol_eps_refusals_match_reference():
    ra = ref_sparse.fd_laplace_2d(8)
    a = _port(ra)
    b = _rhs(ra.shape[0])
    cases = (dict(adaptive="rankrev", chol_eps=1e-10), dict(method="sstep", s=2, chol_eps=1e-10))
    for kw in cases:
        with pytest.raises(ValueError) as want:
            _warned(ref_ecg_solve, lambda v: ref_sparse.csr_spmbv(ra, v), jnp.asarray(b), 4, **kw)
        with pytest.raises(ValueError) as got:
            _warned(ecg_solve, lambda v: csr_spmbv(a, v), torch.as_tensor(b), 4, **kw)
        assert str(got.value) == str(want.value)


def test_auto_t_matches_reference():
    from repro.core.machines import TPU_V5E_POD as RM

    from repro_torch.core.machines import TPU_V5E_POD as M

    ra = ref_sparse.fd_laplace_2d(16)
    a = _port(ra)
    b = _rhs(ra.shape[0])
    tol = 1e-8 * np.linalg.norm(b)
    want, w_msgs = _warned(ref_ecg_solve, lambda v: ref_sparse.csr_spmbv(ra, v), jnp.asarray(b),
                           "auto", tol=tol, max_iters=MAX_ITERS, matrix=ra, machine=RM)
    got, g_msgs = _warned(ecg_solve, lambda v: csr_spmbv(a, v), torch.as_tensor(b), "auto",
                          tol=tol, max_iters=MAX_ITERS, matrix=a, machine=M)
    assert g_msgs == _ported(w_msgs)
    sel, ref_sel = got.selection, want.selection
    assert got.t == want.t == sel.t == ref_sel.t
    assert sel.table.keys() == ref_sel.table.keys()
    for t, row in ref_sel.table.items():
        assert sel.table[t]["est_iters"] == row["est_iters"], t
        for k in ("rate", "avg_active", "iter_cost_s", "total_cost_s"):
            assert sel.table[t][k] == pytest.approx(row[k], rel=1e-9, abs=0.0), (t, k)
    _assert_same_solve(want, got)
    np.testing.assert_array_equal(got.active_hist, np.asarray(want.active_hist))


def test_segmented_resume_equals_monolithic():
    """A b on 2 of the 4 subdomains: under ``reduce`` the width drops, the
    segmented run exits at each drop and resumes from its carry; the result
    equals one run with the same masked operator, bit for bit."""
    from repro_torch.core.ecg import _ecg_solve

    ra = ref_sparse.fd_laplace_2d(16)
    a = _port(ra)
    b = _rhs(ra.shape[0])
    b[ra.shape[0] // 2:] = 0.0
    b = torch.as_tensor(b)
    apply = lambda v: csr_spmbv(a, v)
    masked = lambda v, act: apply(v)
    kw = dict(tol=1e-8 * float(torch.linalg.norm(b)), max_iters=MAX_ITERS, adaptive="reduce",
              a_apply_masked=masked)
    whole = _ecg_solve(apply, b, 4, **kw)
    res, widths = _ecg_solve(apply, b, 4, exit_below_width=4, **kw), [4]
    while not res.converged and not res.breakdown and res.n_iters < MAX_ITERS:
        widths.append(int(res.active_hist[res.n_iters]))
        assert widths[-1] < widths[-2]
        res = _ecg_solve(apply, b, 4, exit_below_width=widths[-1],
                         resume_state=res.final_carry, **kw)
    assert len(widths) > 1 and whole.converged and res.converged
    assert res.n_iters == whole.n_iters and torch.equal(res.x, whole.x)
    np.testing.assert_array_equal(res.active_hist, whole.active_hist)
    want, _ = _warned(ref_ecg_solve, lambda v: ref_sparse.csr_spmbv(ra, v), jnp.asarray(b.numpy()),
                      4, tol=kw["tol"], max_iters=MAX_ITERS, adaptive="reduce")
    assert whole.n_iters == want.n_iters


def test_card_width_refused_before_device_work():
    """On CUDA operands a block over 32 columns is refused before the
    operator or ``b`` is touched (an object with only a device stands in
    for a CUDA ``b`` here); the CPU takes any width."""
    from repro_torch.core.ecg import _ecg_solve, check_card_width

    cuda_b = types.SimpleNamespace(device=torch.device("cuda"))
    untouched = lambda v: pytest.fail("the operator ran")
    for t, kw, match in ((40, {}, "t=40 makes blocks of 40 columns"),
                         (20, dict(method="sstep", s=2), "at s=2"),
                         ("auto", dict(t_candidates=(1, 64)), "candidates up to 64")):
        with pytest.raises(NotImplementedError, match=match):
            _ecg_solve(untouched, cuda_b, t, **kw)
    with pytest.raises(NotImplementedError, match="at most 32"):
        _warned(ecg_solve, untouched, cuda_b, 33)
    check_card_width("cpu", 40)
    check_card_width("cuda", 32)


# --------------------------------------------------------------- cg_solve
def test_cg_solve_matches_reference():
    ra = ref_sparse.fd_laplace_2d(16)
    a = _port(ra)
    b = _rhs(ra.shape[0])
    tol = 1e-8 * np.linalg.norm(b)
    want, w_msgs = _warned(ref_cg_solve, lambda v: ref_sparse.csr_spmv(ra, v), jnp.asarray(b),
                           tol=tol, max_iters=MAX_ITERS)
    got, g_msgs = _warned(cg_solve, lambda v: csr_spmv(a, v), torch.as_tensor(b),
                          tol=tol, max_iters=MAX_ITERS)
    assert g_msgs == _ported(w_msgs) and len(g_msgs) == 1
    assert got.t is None and want.t is None and got.converged
    _assert_same_solve(want, got)


# ------------------------------------------------------------- split_rank
@pytest.mark.parametrize("mapping", ["contiguous", "round_robin"])
@pytest.mark.parametrize("t,m", [(4, 4), (4, 2), (8, 3), (8, 1), (8, 0)])
def test_split_rank_matches_reference(mapping, t, m):
    n = 64
    sub = (np.arange(n) * t) // n if mapping == "contiguous" else np.arange(n) % t
    b = _rhs(n) * (sub < m)
    got = split_rank(torch.as_tensor(b), t, mapping)
    assert got.dim() == 0 and not got.is_floating_point()
    assert int(got) == int(ref_split_rank(jnp.asarray(b), t, mapping)) == m


# --------------------------------------------------------------- Block-ELL
@pytest.mark.parametrize("tile", [8, (8, 16)], ids=["8x8", "8x16"])
@pytest.mark.parametrize("matrix", sorted(MATRICES))
def test_block_ell_arrays_and_apply_match_reference(matrix, tile):
    ra = MATRICES[matrix][0]()
    a = _port(ra)
    br, bc = (tile, tile) if isinstance(tile, int) else tile
    want = ref_bsr_to_block_ell(ref_sparse.csr_to_bsr(ra, br, bc))
    got = bsr_to_block_ell(csr_to_bsr(a, br, bc))
    got2 = block_ell_from_csr(a, br, bc)
    want2 = ref_block_ell_from_csr(ra, br, bc)
    for (gb, gi), (wb, wi) in ((got, want), (got2, want2)):
        assert gi.dtype == torch.int32 and gb.dtype == torch.float64
        np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    # the BSR route gives the handle's arrays too (block_ell_from_csr and
    # make_block_ell_apply are block_ell_arrays; chip_smoke.py phase 45)
    hb, hi, *_ = block_ell_arrays(a, br, bc)
    assert torch.equal(hb, got[0]) and torch.equal(hi, got[1])
    v = np.random.default_rng(1).standard_normal((ra.shape[0], 4))
    w = np.asarray(ref_make_block_ell_apply(ra, tile)(jnp.asarray(v)))
    g = make_block_ell_apply(a, tile, use_pallas=True)(torch.as_tensor(v)).numpy()
    assert np.abs(g - w).max() <= 1e-13 * np.abs(w).max()


def test_block_ell_kmax_and_use_pallas_false():
    ra = ref_sparse.fd_laplace_2d(8)
    a = _port(ra)
    b = csr_to_bsr(a, 8, 8)
    blocks, idx = bsr_to_block_ell(b, kmax=7)
    wb, wi = ref_bsr_to_block_ell(ref_sparse.csr_to_bsr(ra, 8, 8), kmax=7)
    np.testing.assert_array_equal(blocks.numpy(), np.asarray(wb))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(wi))
    with pytest.raises(ValueError, match="overflows kmax=1"):
        bsr_to_block_ell(b, kmax=1)
    with pytest.raises(ValueError, match="csr_spmbv"):
        make_block_ell_apply(a, 8, use_pallas=False)


# ------------------------------------------------------------ distributed
@pytest.fixture(scope="module")
def dist_system():
    ra = ref_sparse.dg_laplace_2d((8, 8), block=2)
    b = _rhs(ra.shape[0])
    return ra, _port(ra), b, 1e-6 * np.linalg.norm(b)


def test_make_distributed_spmbv_warns_and_equals_internal(dist_system):
    from repro_torch.launch.mesh import VirtualMesh
    from repro_torch.sparse.spmbv import _make_distributed_spmbv, make_distributed_spmbv

    ra, a, b, _ = dist_system
    mesh = VirtualMesh(2, 4, device="cpu")
    want = _make_distributed_spmbv(a, mesh, "optimal", t=4, backend="pallas")
    with pytest.warns(DeprecationWarning, match="make_distributed_spmbv\\(\\) is the legacy"):
        got = make_distributed_spmbv(a, mesh, "optimal", t=4, backend="pallas")
    assert got.plan.strategy == want.plan.strategy
    assert got.plan.wire_bytes(8) == want.plan.wire_bytes(8) and len(got.plan.phases) == len(want.plan.phases)
    for gs, ws in zip(got.exchange_arrays(got.plan), want.exchange_arrays(want.plan)):
        assert len(gs) == len(ws) and all(torch.equal(g, w) for g, w in zip(gs, ws))
    assert torch.equal(got.ell["blocks"], want.ell["blocks"])
    assert torch.equal(got.ell["indices"], want.ell["indices"])
    v = got.shard_vector(np.random.default_rng(1).standard_normal((a.shape[0], 4)))
    assert torch.equal(got.matvec_fn()(v), want.matvec_fn()(v))


def test_distributed_ecg_equals_handle_and_reference(dist_system):
    from repro_torch.launch.mesh import VirtualMesh
    from repro_torch.solver import CommConfig, ECGSolver, KernelConfig, SolverConfig
    from repro_torch.sparse.spmbv import distributed_ecg

    ra, a, b, tol = dist_system
    mesh = VirtualMesh(2, 4, device="cpu")
    (res, op), msgs = _warned(distributed_ecg, a, b, mesh, 4, strategy="optimal", tol=tol,
                              max_iters=MAX_ITERS, backend="pallas")
    assert msgs == ["distributed_ecg() is the legacy stringly-typed spelling; build a "
                    "repro_torch.solver.ECGSolver handle (compile-once / solve-many, typed "
                    "SolverConfig) instead"]
    handle = ECGSolver.build(a, VirtualMesh(2, 4, device="cpu"), SolverConfig(
        t=4, tol=tol, max_iters=MAX_ITERS, comm=CommConfig(strategy="optimal"),
        kernel=KernelConfig(backend="pallas")))
    hres = handle.solve(b)
    assert res.converged and res.n_iters == hres.n_iters
    assert torch.equal(res.x, hres.x)
    np.testing.assert_array_equal(res.res_hist.numpy(), hres.res_hist.numpy())
    assert op.plan.strategy == "optimal" and op.unshard(res.x).shape == (a.shape[0],)
    want, _ = _warned(ref_ecg_solve, lambda v: ref_sparse.csr_spmbv(ra, v), jnp.asarray(b), 4,
                      tol=tol, max_iters=MAX_ITERS)
    assert res.n_iters == want.n_iters


def test_legacy_tuned_strategy_maps_to_model_tune(dist_system):
    from repro_torch.launch.mesh import VirtualMesh
    from repro_torch.sparse.spmbv import _build_legacy_solver

    _, a, b, tol = dist_system
    solver = _build_legacy_solver(a, VirtualMesh(2, 4, device="cpu"), 4, strategy="tuned",
                                  tol=tol, backend="pallas")
    assert solver.config.tune.mode == "model" and solver.config.comm.strategy == "standard"
    assert solver.tuned is not None and solver.op.plan.strategy == solver.tuned.strategy


# ---------------------------------------------------------------- the mesh
@pytest.mark.parametrize("n_ranks,ppn,multi_pod", [
    (8, 4, False), (8, 2, False), (16, 16, False), (32, 16, False), (8, 16, True), (6, 16, True)])
def test_make_solver_mesh_follows_reference_rule(monkeypatch, n_ranks, ppn, multi_pod):
    import repro.launch.mesh as ref_mesh

    from repro_torch.launch.mesh import make_solver_mesh

    stub = types.SimpleNamespace(devices=lambda: [None] * n_ranks,
                                 make_mesh=lambda shape, axes: (tuple(shape), axes))
    monkeypatch.setattr(ref_mesh, "jax", stub)
    shape, axes = ref_mesh.make_solver_mesh(multi_pod=multi_pod, ppn=ppn)
    mesh = make_solver_mesh(multi_pod=multi_pod, ppn=ppn, n_ranks=n_ranks, device="cpu")
    assert mesh.shape == shape and axes == ("node", "proc")


@pytest.mark.parametrize("kw", [dict(n_ranks=6, ppn=4), dict(n_ranks=8), dict(n_ranks=3, multi_pod=True)])
def test_make_solver_mesh_refuses_uncovered_rank_counts(kw):
    from repro_torch.launch.mesh import make_solver_mesh

    with pytest.raises(ValueError, match="does not cover"):
        make_solver_mesh(device="cpu", **kw)


# ------------------------------------------------------------ the sweeps
def _keys(rows):
    return [(r["name"], r["derived"].split("=")[0]) for r in rows]


def test_kernel_vs_oracle_rows_match_reference():
    from repro.analysis.ecg_bench import kernel_vs_oracle as ref_kvo

    from repro_torch.analysis.ecg_bench import kernel_vs_oracle

    kw = dict(ts=(2, 4), repeats=1, elements=(4, 4), block=4)
    want, got = ref_kvo(**kw), kernel_vs_oracle(device="cpu", **kw)
    assert _keys(got) == _keys(want) and len(got) == 8
    assert all(np.isfinite(r["us"]) and r["us"] > 0 for r in got)
    nnz = [r["derived"] for r in got if r["name"].startswith("kernel/csr")]
    assert nnz == [r["derived"] for r in want if r["name"].startswith("kernel/csr")]


def test_kernel_operands_draw_in_the_reference_order():
    from repro_torch.analysis.ecg_bench import kernel_operands

    a, blocks, idx, per_t = kernel_operands(ts=(2, 3), elements=(4, 4), block=4, seed=5,
                                            device="cpu")
    ra = ref_sparse.dg_laplace_2d((4, 4), block=4, dtype=jnp.float32)
    wb, wi = ref_bsr_to_block_ell(ref_sparse.csr_to_bsr(ra, 4, 4))
    np.testing.assert_array_equal(blocks.numpy(), np.asarray(wb))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(wi))
    # the reference's kernel_vs_oracle: per t, v, four gram blocks, five
    # tail blocks and three (t, t) coefficients
    rng = np.random.default_rng(5)
    f32 = lambda shape: rng.standard_normal(shape).astype(np.float32)
    assert [t for t, *_ in per_t] == [2, 3]
    for t, v, gram, tail in per_t:
        want = [f32((a.shape[0], t))] + [f32((32768, t)) for _ in range(9)]
        want += [f32((t, t)) for _ in range(3)]
        for g, w in zip((v,) + gram + tail, want, strict=True):
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), w)


def test_overlap_vs_blocking_rows_match_reference():
    from repro.analysis.ecg_bench import overlap_vs_blocking_sweep as ref_sweep

    from repro_torch.analysis.ecg_bench import STRATEGIES, overlap_vs_blocking_sweep
    from repro_torch.launch.mesh import VirtualMesh

    ra = ref_sparse.dg_laplace_2d((4, 4), block=4)
    ref_mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("node", "proc"))
    kw = dict(ts=(2,), strategies=("standard",), repeats=1)
    want, _ = _warned(ref_sweep, ra, ref_mesh, **kw)  # its shard_map import warns
    got = overlap_vs_blocking_sweep(_port(ra), VirtualMesh(1, 1, device="cpu"), **kw)
    assert _keys(got) == _keys(want) and len(got) == 4
    halos = [r["derived"] for r in got if "blocking" in r["name"]]
    assert halos == [r["derived"] for r in want if "blocking" in r["name"]]
    assert STRATEGIES == ("standard", "2step", "3step", "optimal")
    # on the 2 x 4 mesh every strategy's plan moves the same halo
    rows = overlap_vs_blocking_sweep(_port(ra), VirtualMesh(2, 4, device="cpu"), ts=(2,),
                                     backends=("pallas",), repeats=1)
    assert [r["name"] for r in rows] == [f"spmbv/{s}_t2_pallas_{m}" for s in STRATEGIES
                                         for m in ("blocking", "overlap")]


def test_perf_cli_writes_the_sweep(monkeypatch, tmp_path, capsys):
    import repro_torch.analysis.ecg_bench as bench
    from repro_torch.launch import perf

    calls = {}
    sweep, kvo = bench.overlap_vs_blocking_sweep, bench.kernel_vs_oracle

    def small_sweep(a, mesh, ts):
        calls["sweep"] = (a.shape, mesh.shape, ts)
        return sweep(a, mesh, ts=(2,), strategies=("optimal",), backends=("pallas",), repeats=1)

    def small_kvo(device):
        calls["kvo"] = str(device)
        return kvo(ts=(2,), repeats=1, elements=(4, 4), block=4, device=device)

    monkeypatch.setattr(bench, "overlap_vs_blocking_sweep", small_sweep)
    monkeypatch.setattr(bench, "kernel_vs_oracle", small_kvo)
    out = tmp_path / "ecg.json"
    perf.main(["--ecg", "--device", "cpu", "--out", str(out), "--only", "pallas"])
    rows = json.loads(out.read_text())
    assert calls == {"sweep": ((1536, 1536), (2, 4), (4, 8)), "kvo": "cpu"}
    assert [r["name"] for r in rows] == ["spmbv/optimal_t2_pallas_blocking",
                                         "spmbv/optimal_t2_pallas_overlap"]
    printed = capsys.readouterr().out
    assert "ECG spmbv/optimal_t2_pallas_overlap:" in printed and "ecg perf pass done" in printed
    # without --ecg the transformer cells (none matches here; traced in
    # tests/test_torch_dryrun.py)
    perf.main(["--device", "cpu", "--out", str(tmp_path / "lm.json"), "--only", "pallas"])
    assert capsys.readouterr().out.splitlines() == ["perf pass done"]
