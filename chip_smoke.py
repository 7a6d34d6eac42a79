#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which raises on failure (exit code != 0, no result line):

1. setup — the card's name and power limit (nvidia-smi), torch and CUDA
   versions, and the build of every CUDA kernel from ``src/repro_torch``.
2. main-path build — Example 2.1 at full scale (``dg_laplace_2d((320, 256),
   block=16)``: 1 310 720 rows, ~104.5M nonzeros) and an ``ECGSolver`` with
   t = 8, tol = 1e-8·‖b‖, ``backend="pallas"`` on the card.
3. kernel checks — each kernel against its plain torch version at the main
   path's shapes (f64, t = 8) and at t = 1 and in f32; one JSON line each
   with its error, the tolerance, and CUDA-event times of the kernel, the
   plain version and one PyTorch library call of the same function (a
   yardstick only; the port never calls it), beside the least time the card
   could take (bytes over 3.35 TB/s or flops over the peak rate).
4. main path — the solve, with every kernel's launch count set to 0 just
   before it and read just after: ``bsr_spmbv`` must launch n_iters + 1
   times (the width-1 initial residual), ``fused_gram`` and ``ecg_tail``
   n_iters times; the true residual ‖b − A·x‖ (plain CSR SpMV on the card)
   must be ≤ 10·tol.
5. cross-check — a (64, 64)-element solve with ``backend="pallas"`` and
   ``backend="jnp"``: iteration counts within one (the jnp product's
   atomics change its rounding from run to run), x equal to 1e-8
   (relative to max|x|).
6. distributed build — the same operator on a ``VirtualMesh(2, 4)`` (all 8
   ranks on the card), ``strategy="optimal"``, t = 8, ``backend="pallas"``:
   partition, plan and Block-ELL conversion seconds.
7. distributed kernel checks — ``halo_pack`` and ``halo_unpack`` on the
   plan's widest phase (p = 8 ranks) at w = 8 and w = 1 in float64 and at
   w = 8 in float32, which must equal their plain versions exactly (the
   unpack's dump slot aside), and the batched ``fused_gram`` at
   (8, rmax, 8); times as in phase 3, the library calls being advanced
   indexing ``src[rank_ids, idx]`` and ``index_put_``; ``kernel_graph_ms``
   is the kernel's time from a CUDA-graph replay, without the host's
   launch overhead, which dominates at these shapes.
8. distributed main path — the solve on the mesh, with the launch counts
   and the mesh counters set to 0 just before it: ``halo_pack`` and
   ``halo_unpack`` must launch len(plan.phases)·(n_iters + 1) times,
   ``bsr_spmbv`` n_iters + 1, ``fused_gram`` and ``ecg_tail`` n_iters;
   ``mesh.psum`` must run 3·n_iters + 1 times; the true residual of the
   unsharded x must be ≤ 10·tol and n_iters within 1% of phase 4's.
9. strategies — one distributed SpMBV for ``standard``, ``2step``,
   ``3step`` and ``optimal`` with ``col_split=2``, each a ``with_config``
   sibling on the same partition, against the sequential Block-ELL apply
   (1e-12 relative).
10. distributed cross-check — the (64, 64)-element problem on the (2, 4)
    mesh with all four strategies: the four solves bit-identical; against
    the sequential pallas solve, iteration counts within one and x equal to
    1e-8 (relative to max|x|).

"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
# peak flop rate by dtype: f32 outside the tensor cores and f64 on the tensor
# cores are both 67 TFLOP/s on the H100 SXM (NVIDIA data sheet)
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12}
ELEMENTS, BLOCK = (320, 256), 16  # Example 2.1 at full scale
T = 8
MAX_ITERS = 5000
REPS, BATCHES = 10, 5


def log(obj) -> None:
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def time_ms(torch, fn) -> float:
    """Median over BATCHES of the mean CUDA-event time of REPS back-to-back calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(BATCHES):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / REPS)
    return statistics.median(per_call)


def time_graph_ms(torch, fn) -> float:
    """Device time per call: REPS calls captured in one CUDA graph, replayed
    (median over BATCHES), so the host's launch overhead drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(REPS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(BATCHES):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / REPS)
    return statistics.median(per_call)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch import kernels
    from repro_torch.kernels import _build
    from repro_torch.kernels.block_update.ref import ecg_tail_ref
    from repro_torch.kernels.bsr_spmbv.ref import bsr_spmbv_ref
    from repro_torch.core.node_aware import build_exchange_plan
    from repro_torch.kernels.fused_gram.ref import fused_gram_ref
    from repro_torch.kernels.halo_pack.ref import halo_pack_ref, halo_unpack_ref
    from repro_torch.launch.mesh import VirtualMesh
    from repro_torch.solver import CommConfig, ECGSolver, KernelConfig, SolverConfig
    from repro_torch.sparse import csr_spmv, dg_laplace_2d, partition_csr

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 yardsticks in full f32

    # ---------------------------------------------------------------- 1. setup
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    libs = _build.build_all()
    for name in libs:
        _build.load(name)
    log({"phase": "build_kernels", "seconds": time.perf_counter() - t0,
         "libraries": sorted(str(p.relative_to(ROOT)) for p in libs.values())})

    # ------------------------------------------------------ 2. main-path build
    t0 = time.perf_counter()
    a = dg_laplace_2d(ELEMENTS, block=BLOCK, device=dev)
    gen_s = time.perf_counter() - t0
    n = a.shape[0]
    b = np.random.default_rng(0).standard_normal(n)
    tol = 1e-8 * float(np.linalg.norm(b))
    config = SolverConfig(t=T, tol=tol, max_iters=MAX_ITERS, kernel=KernelConfig(backend="pallas"))
    t0 = time.perf_counter()
    solver = ECGSolver.build(a, config=config, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    blocks = solver.conversion["arrays"]["blocks"]
    indices = solver.conversion["arrays"]["indices"]
    log({"phase": "build_solver", "n": n, "nnz": a.nnz, "blocks": list(blocks.shape),
         "meta_kmax": solver.conversion["meta"]["kmax"],
         "generate_s": gen_s, "build_s": build_s})

    # ---------------------------------------------------------- 3. kernel checks
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev, dtype=dtype)

    csr_by_dtype = {}

    def library_csr(dtype):
        if dtype not in csr_by_dtype:
            csr_by_dtype[dtype] = torch.sparse_csr_tensor(
                a.indptr, a.indices, a.data.to(dtype), size=a.shape)
        return csr_by_dtype[dtype]

    # Each check returns (plain function, its operands, the kernel call, one
    # library call, Σ|terms| per output, terms per output, bytes, flops, shape).
    def check_bsr(t, dtype):
        blk = blocks.to(dtype)
        v = randn(n, t, dtype=dtype)
        plain = lambda blk_, v_: bsr_spmbv_ref(blk_, indices, v_)[:n]
        kernel = lambda: kernels.bsr_spmbv(blk, indices, v, n_rows=n)
        csr = library_csr(dtype)
        library = lambda: torch.sparse.mm(csr, v)
        es = blk.element_size()
        return (plain, (blk, v), kernel, library, plain(blk.abs(), v.abs()),
                blk.shape[1] * blk.shape[3],
                blk.numel() * es + indices.numel() * 4 + 2 * n * t * es,
                2 * blk.numel() * t, list(blk.shape) + [t])

    def check_gram(t, dtype):
        ops = tuple(randn(n, t, dtype=dtype) for _ in range(4))
        p, r, ap, apo = ops
        kernel = lambda: kernels.fused_gram(*ops)
        library = lambda: torch.cat([p.T @ r, ap.T @ ap, apo.T @ ap], dim=1)
        return (fused_gram_ref, ops, kernel, library,
                fused_gram_ref(*(o.abs() for o in ops)), n,
                (4 * n * t + 3 * t * t) * p.element_size(), 6 * n * t * t, [n, t])

    def check_tail(t, dtype):
        ops = tuple(randn(n, t, dtype=dtype) for _ in range(5)) + tuple(
            randn(t, t, dtype=dtype) for _ in range(3))
        x, r, p, ap, po, c, d, do = ops
        kernel = lambda: kernels.ecg_tail(*ops)
        pcat, dcat = torch.cat([p, po], dim=1), torch.cat([d, do], dim=0)
        library = lambda: (torch.addmm(x, p, c), torch.addmm(r, ap, c, alpha=-1),
                           torch.addmm(ap, pcat, dcat, alpha=-1))
        bound = (x.abs() + p.abs() @ c.abs(), r.abs() + ap.abs() @ c.abs(),
                 ap.abs() + p.abs() @ d.abs() + po.abs() @ do.abs())
        return (ecg_tail_ref, ops, kernel, library, bound, 2 * t + 1,
                (8 * n * t + 3 * t * t) * x.element_size(), 8 * n * t * t, [n, t])

    def tup(x):
        return x if isinstance(x, tuple) else (x,)

    def max_diff(xs, ys):
        return max(float((x.double() - y.double()).abs().max()) for x, y in zip(xs, ys))

    def run_check(name, make, t, dtype):
        plain_fn, ops, kernel, library, bound, k_sum, bytes_, flops, shape = make(t, dtype)
        plain = lambda: plain_fn(*ops)
        got, want = tup(kernel()), tup(plain())
        torch.cuda.synchronize()
        if not all(bool(torch.isfinite(g).all()) for g in got):
            raise AssertionError(f"{name} t={t} {dtype}: non-finite kernel output")
        err = max_diff(got, want)
        # forward error bound of a k-term sum: both results lie within
        # k·eps·Σ|terms| of the exact value
        eps = torch.finfo(dtype).eps
        scale = max(float(bb.max()) for bb in tup(bound))
        tol = 2 * k_sum * eps * scale
        if not err <= tol:
            raise AssertionError(f"{name} t={t} {dtype}: max_abs_err {err} > tol {tol}")
        dname = str(dtype).removeprefix("torch.")
        row = {"name": name, "shape": shape, "dtype": dname, "max_abs_err": err, "tol": tol}
        if dtype == torch.float32:
            # the n-term bound above is loose in float32, so the kernel is
            # also held to the plain version's own accuracy against a
            # float64 evaluation of the same inputs
            exact = tup(plain_fn(*(o.double() for o in ops)))
            k_err, p_err = max_diff(got, exact), max_diff(want, exact)
            row.update(err_vs_f64=k_err, plain_err_vs_f64=p_err)
            if not k_err <= 2 * p_err + 4 * eps * scale:
                raise AssertionError(f"{name} t={t} float32: kernel error {k_err} vs "
                                     f"float64 exceeds twice the plain version's {p_err}")
        bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
        flops_ms = flops / PEAK_FLOPS[dname] * 1e3
        row.update(
            kernel_ms=time_ms(torch, kernel), plain_ms=time_ms(torch, plain),
            library_ms=time_ms(torch, library), bound_ms=max(bytes_ms, flops_ms),
            bound_by="bytes" if bytes_ms >= flops_ms else "operations",
        )
        log(row)
        return row

    checks = {}
    for name, make in (("bsr_spmbv", check_bsr), ("fused_gram", check_gram), ("ecg_tail", check_tail)):
        checks[name] = run_check(name, make, T, torch.float64)  # the main path's shape
        run_check(name, make, 1, torch.float64)
        run_check(name, make, T, torch.float32)
    csr_by_dtype.clear()
    torch.cuda.empty_cache()

    # ----------------------------------------------------------- 4. main path
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solver.solve(b)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    b_dev = torch.as_tensor(b, device=dev)
    true_res = float(torch.linalg.norm(b_dev - csr_spmv(solver.a, res.x)))
    log({"phase": "main_path", "n": n, "t": T, "dtype": "float64", "tol": tol,
         "max_iters": MAX_ITERS, "converged": res.converged, "breakdown": res.breakdown,
         "n_iters": res.n_iters, "final_rn": float(res.res_hist[res.n_iters]),
         "true_residual": true_res, "build_s": build_s, "solve_s": solve_s,
         "ms_per_iter": solve_s * 1e3 / max(res.n_iters, 1), "launches": launches})
    if not res.converged:
        raise AssertionError(f"main path did not converge in {res.n_iters} iterations")
    want = {"bsr_spmbv": res.n_iters + 1, "fused_gram": res.n_iters, "ecg_tail": res.n_iters,
            "halo_pack": 0, "halo_unpack": 0}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    if not true_res <= 10 * tol:
        raise AssertionError(f"true residual {true_res} > 10·tol {10 * tol}")
    if not torch.isfinite(res.x).all():
        raise AssertionError("non-finite solution")
    seq = {"n_iters": res.n_iters, "ms_per_iter": solve_s * 1e3 / max(res.n_iters, 1),
           "solve_s": solve_s, "build_s": build_s}
    seq_launches = launches
    # the sequential Block-ELL apply of one random block, for phase 9
    v_apply = np.random.default_rng(1).standard_normal((n, T))
    w_seq = kernels.bsr_spmbv(blocks, indices, torch.as_tensor(v_apply, device=dev), n_rows=n).cpu().numpy()
    del solver, blocks, indices, res
    torch.cuda.empty_cache()

    # -------------------------------------------------------- 5. cross-check
    a2 = dg_laplace_2d((64, 64), block=BLOCK, device=dev)
    b2 = np.random.default_rng(0).standard_normal(a2.shape[0])
    cfg2 = SolverConfig(t=T, tol=1e-8 * float(np.linalg.norm(b2)), max_iters=MAX_ITERS)
    out = {}
    for backend in ("pallas", "jnp"):
        s2 = ECGSolver.build(a2, config=cfg2.replace(backend=backend), device=dev)
        out[backend] = s2.solve(b2)
    xp, xj = out["pallas"].x, out["jnp"].x
    x_rel = float((xp - xj).abs().max() / xj.abs().max())
    log({"phase": "cross_check", "n": a2.shape[0], "iters_pallas": out["pallas"].n_iters,
         "iters_jnp": out["jnp"].n_iters, "x_max_rel_diff": x_rel})
    if not (out["pallas"].converged and out["jnp"].converged):
        raise AssertionError("cross-check solves did not converge")
    # The jnp backend's CSR product sums with atomics (index_add_) on the
    # card, so its rounding changes from run to run; on this DG operator at
    # 1e-8·‖b‖ that can move the last threshold crossing by one iteration
    # (468 against 467 in one run; PERF.md §6).  x is held to 1e-8 below.
    if abs(out["pallas"].n_iters - out["jnp"].n_iters) > 1:
        raise AssertionError("pallas and jnp backends differ by more than one iteration")
    if not x_rel <= 1e-8:
        raise AssertionError(f"pallas and jnp solutions differ by {x_rel} (relative)")

    # ------------------------------------------------- 6. distributed build
    mesh = VirtualMesh(2, 4, device=dev)
    t0 = time.perf_counter()
    pm = partition_csr(a, mesh.p)
    partition_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan_only = build_exchange_plan(pm, 2, 4, "optimal", t=T)
    plan_s = time.perf_counter() - t0
    dcfg = config.replace(strategy="optimal")
    t0 = time.perf_counter()
    dsolver = ECGSolver.build(a, mesh, dcfg, pm=pm)
    torch.cuda.synchronize()
    operator_s = time.perf_counter() - t0
    op = dsolver.op
    plan = op.plan
    log({"phase": "build_distributed", "mesh": list(mesh.shape), "strategy": "optimal",
         "partition_s": partition_s, "plan_s": plan_s,
         "operator_s": operator_s, "rmax": op.rmax, "halo_size": plan.halo_size,
         "stage_size": plan.stage_size, "col_split": plan.col_split,
         "phase_widths": [ph.width for ph in plan.phases],
         "rotations": sum(1 for st in plan.steps if st.offset),
         "wire_bytes": plan.wire_bytes(8), "blocks": list(op.ell["blocks"].shape)})
    if plan_only.col_split != plan.col_split or len(plan_only.steps) != len(plan.steps):
        raise AssertionError("the handle's plan differs from build_exchange_plan's")

    # ------------------------------------------ 7. distributed kernel checks
    widest = max(range(len(plan.phases)), key=lambda i: plan.phases[i].width)
    ph = plan.phases[widest]
    g_idx, s_pos = op.gathers[widest], op.scatters[widest]
    p_ranks, c = g_idx.shape
    src_rows = op.rmax * plan.col_split if ph.src == "x" else plan.stage_size + 1
    dst_rows = plan.halo_size + 1 if ph.dst == "halo" else plan.stage_size + 1
    rank_ids = torch.arange(p_ranks, device=dev)[:, None].expand(p_ranks, c)
    g_long, s_long = g_idx.long(), s_pos.long()

    def run_halo_check(name, w, dtype):
        es = torch.finfo(dtype).bits // 8
        if name == "halo_pack":
            src = randn(p_ranks, src_rows, w, dtype=dtype)
            kernel = lambda: kernels.halo_pack(src, g_idx)
            plain = lambda: halo_pack_ref(src, g_idx)
            library = lambda: src[rank_ids, g_long]
            got, want, keep = kernel(), plain(), slice(None)
        else:
            buf = randn(p_ranks, c, w, dtype=dtype)
            dst = randn(p_ranks, dst_rows, w, dtype=dtype)
            d_k, d_p, d_l = dst.clone(), dst.clone(), dst.clone()
            kernel = lambda: kernels.halo_unpack(d_k, buf, s_pos)
            plain = lambda: halo_unpack_ref(d_p, buf, s_pos)
            library = lambda: d_l.index_put_((rank_ids, s_long), buf)
            got, want = kernel(), plain()
            keep = slice(0, dst_rows - 1)  # the dump slot takes any padding row
            untouched = torch.ones(p_ranks, dst_rows, dtype=torch.bool, device=dev)
            untouched.scatter_(1, s_long, False)
            if not torch.equal(got[untouched], dst[untouched]):
                raise AssertionError(f"{name} w={w}: a slot no position names was written")
        torch.cuda.synchronize()
        err = float((got[:, keep].double() - want[:, keep].double()).abs().max())
        if err != 0.0:
            raise AssertionError(f"{name} w={w} {dtype}: max_abs_err {err} != 0")
        bytes_ = 2 * p_ranks * c * w * es + p_ranks * c * 4
        row = {"name": name, "shape": [p_ranks, c, w], "rows": src_rows if name == "halo_pack" else dst_rows,
               "dtype": str(dtype).removeprefix("torch."), "phase": f"{ph.axis}:{ph.src}->{ph.dst}",
               "max_abs_err": err, "tol": 0.0, "kernel_ms": time_ms(torch, kernel),
               # the kernel alone, without the host's launch overhead
               "kernel_graph_ms": time_graph_ms(torch, kernel),
               "plain_ms": time_ms(torch, plain), "library_ms": time_ms(torch, library),
               "bound_ms": bytes_ / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
        log(row)
        return row

    for name in ("halo_pack", "halo_unpack"):
        checks[name] = run_halo_check(name, T // plan.col_split, torch.float64)  # the main path's
        run_halo_check(name, 1, torch.float64)
        run_halo_check(name, T // plan.col_split, torch.float32)

    def check_gram_batched(t, dtype):
        ops = tuple(randn(p_ranks, op.rmax, t, dtype=dtype) for _ in range(4))
        pp, r, ap, apo = ops
        kernel = lambda: kernels.fused_gram(*ops)
        library = lambda: torch.cat([pp.mT @ r, ap.mT @ ap, apo.mT @ ap], dim=-1)
        return (fused_gram_ref, ops, kernel, library,
                fused_gram_ref(*(o.abs() for o in ops)), op.rmax,
                (4 * p_ranks * op.rmax * t + 3 * p_ranks * t * t) * pp.element_size(),
                6 * p_ranks * op.rmax * t * t, [p_ranks, op.rmax, t])

    checks["fused_gram_batched"] = run_check("fused_gram_batched", check_gram_batched, T, torch.float64)
    torch.cuda.empty_cache()

    # --------------------------------------------- 8. distributed main path
    kernels.reset_launch_counts()
    mesh.reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dres = dsolver.solve(b)
    torch.cuda.synchronize()
    dsolve_s = time.perf_counter() - t0
    dlaunches = kernels.launch_counts()
    dcounters = {"psum": mesh.psum_calls, "ppermute": mesh.ppermute_calls,
                 "ppermute_elements": mesh.ppermute_elements}
    x_glob = torch.as_tensor(dsolver.unshard(dres.x), device=dev)
    dtrue_res = float(torch.linalg.norm(b_dev - csr_spmv(a, x_glob)))
    k = dres.n_iters
    log({"phase": "distributed_main_path", "mesh": list(mesh.shape), "strategy": "optimal",
         "n": n, "t": T, "dtype": "float64", "tol": tol, "converged": dres.converged,
         "breakdown": dres.breakdown, "n_iters": k, "final_rn": float(dres.res_hist[k]),
         "true_residual": dtrue_res, "solve_s": dsolve_s, "ms_per_iter": dsolve_s * 1e3 / max(k, 1),
         "build_s": partition_s + operator_s, "sequential": seq, "launches": dlaunches,
         "mesh_counters": dcounters})
    if not dres.converged:
        raise AssertionError(f"distributed main path did not converge in {k} iterations")
    n_phases = len(plan.phases)
    want = {"bsr_spmbv": k + 1, "fused_gram": k, "ecg_tail": k,
            "halo_pack": n_phases * (k + 1), "halo_unpack": n_phases * (k + 1)}
    if dlaunches != want:
        raise AssertionError(f"distributed launch counts {dlaunches} != {want}")
    if dcounters["psum"] != 3 * k + 1:
        raise AssertionError(f"psum ran {dcounters['psum']} times, want 3·{k} + 1")
    n_rot = sum(1 for st in plan.steps if st.offset)
    if dcounters["ppermute"] != n_rot * (k + 1):
        raise AssertionError(f"ppermute ran {dcounters['ppermute']} times, want {n_rot}·({k} + 1)")
    if not dtrue_res <= 10 * tol:
        raise AssertionError(f"distributed true residual {dtrue_res} > 10·tol {10 * tol}")
    # equal in every run so far (2007 both); DG rounding may move it a little
    if not abs(k - seq["n_iters"]) <= max(1, 0.01 * seq["n_iters"]):
        raise AssertionError(f"distributed iterations {k} not within 1% of sequential {seq['n_iters']}")
    del dres, x_glob
    torch.cuda.empty_cache()

    # ------------------------------------------------------ 9. strategies
    scale = float(np.abs(w_seq).max())
    for strategy, cs in (("standard", None), ("2step", None), ("3step", None), ("optimal", 2)):
        sib = dsolver.with_config(strategy=strategy, col_split=cs)
        w = sib.unshard(sib.op.matvec_fn()(sib.op.shard_vector(v_apply)))
        rel = float(np.abs(w - w_seq).max()) / scale
        log({"phase": "strategy_apply", "strategy": strategy, "col_split": sib.op.plan.col_split,
             "phases": len(sib.op.plan.phases), "rotations": sum(1 for st in sib.op.plan.steps if st.offset),
             "wire_bytes": sib.op.plan.wire_bytes(8), "conv_reused": sib.stats.conv_reused,
             "max_rel_diff": rel})
        if not rel <= 1e-12:
            raise AssertionError(f"{strategy} apply differs from the sequential one by {rel}")
    del dsolver, sib, op, a
    torch.cuda.empty_cache()

    # ------------------------------------------ 10. distributed cross-check
    # The exchange moves data exactly and the per-rank products do not
    # depend on the strategy, so the four strategies must agree bit for bit.
    # Against the sequential solve the reductions sum in another order, and
    # on this DG operator at 1e-8·‖b‖ that may move the last threshold
    # crossing by one iteration (ROADMAP.md queue 3; PERF.md §6).
    seq2 = ECGSolver.build(a2, config=cfg2.replace(backend="pallas"), device=dev).solve(b2)
    x_seq = seq2.x.cpu().numpy()
    first = None
    for strategy in ("standard", "2step", "3step", "optimal"):
        s2 = ECGSolver.build(a2, VirtualMesh(2, 4, device=dev), cfg2.replace(backend="pallas", strategy=strategy))
        r2 = s2.solve(b2)
        rel = float(np.abs(s2.unshard(r2.x) - x_seq).max() / np.abs(x_seq).max())
        log({"phase": "distributed_cross_check", "strategy": strategy, "n": a2.shape[0],
             "iters": r2.n_iters, "iters_sequential": seq2.n_iters, "x_max_rel_diff": rel})
        first = first or r2
        if not (r2.converged and r2.n_iters == first.n_iters and torch.equal(r2.x, first.x)):
            raise AssertionError(f"{strategy}: differs from the standard exchange's solve")
        if not abs(r2.n_iters - seq2.n_iters) <= 1:
            raise AssertionError(f"{strategy}: {r2.n_iters} iterations against {seq2.n_iters} sequential")
        if not rel <= 1e-8:
            raise AssertionError(f"{strategy}: x differs from the sequential solve by {rel}")

    # ------------------------------------------------------------------ result
    sources = {
        "bsr_spmbv": ("src/repro_torch/kernels/csrc/bsr_spmbv.cu", "src/repro/kernels/bsr_spmbv/kernel.py:43"),
        "fused_gram": ("src/repro_torch/kernels/csrc/fused_gram.cu", "src/repro/kernels/fused_gram/kernel.py:43"),
        "ecg_tail": ("src/repro_torch/kernels/csrc/ecg_tail.cu", "src/repro/kernels/block_update/kernel.py:68"),
        "halo_pack": ("src/repro_torch/kernels/csrc/halo_pack.cu", "src/repro/kernels/halo_pack/kernel.py:40"),
        "halo_unpack": ("src/repro_torch/kernels/csrc/halo_pack.cu", "src/repro/kernels/halo_pack/kernel.py:63"),
    }
    # launches: the sequential main path's (phase 4) for the kernels it runs,
    # the distributed main path's (phase 8) for the halo kernels
    launches = {**seq_launches, "halo_pack": dlaunches["halo_pack"], "halo_unpack": dlaunches["halo_unpack"]}
    log({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches[name], "max_abs_err": checks[name]["max_abs_err"],
         "ms": checks[name]["kernel_ms"], "plain_ms": checks[name]["plain_ms"],
         "bound_ms": checks[name]["bound_ms"], "bound_by": checks[name]["bound_by"],
         "library_ms": checks[name]["library_ms"]}
        for name, (src, replaces) in sources.items()
    ]})
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
