#!/usr/bin/env python3
"""Where one iteration of the port's ECG solve spends its time on the card.

    PYTHONPATH=src python tools/profile_torch_solve.py [--iters 50] [--elements 320 256]
    PYTHONPATH=src python tools/profile_torch_solve.py --devices 8 --ppn 4 --strategy optimal
    PYTHONPATH=src python tools/profile_torch_solve.py --precondition block_jacobi [--block 16]
    PYTHONPATH=src python tools/profile_torch_solve.py --adaptive reduce --deficient 4 \
        [--devices 8 --ppn 4]
    PYTHONPATH=src python tools/profile_torch_solve.py --method sstep --s 2 [--reorth]
    PYTHONPATH=src python tools/profile_torch_solve.py --method pipelined --devices 8 --ppn 4 \
        --overlap
    PYTHONPATH=src python tools/profile_torch_solve.py --pack 4 --t 4 [--devices 8 --ppn 4]

Builds the main path of ``chip_smoke.py`` (``dg_laplace_2d(elements,
block=16)``, t = 8, float64, ``backend="pallas"``) on the GPU, steps the
solve loop ``--iters`` times on the host clock (wall ms per iteration), then
again under ``torch.profiler`` and prints JSON lines: the card, wall and
device-busy ms per iteration, the device's idle share, and device time per
kernel name, and the host's launch calls per iteration
(``cudaLaunchKernel``, ``cudaGraphLaunch`` and the other calls in
``LAUNCH_APIS``, as the profiler's runtime-API events count them; one
replayed exchange graph is one ``cudaGraphLaunch``).  ``--devices N --ppn
K`` profiles the distributed solve on a
``VirtualMesh(N // K, K)`` with exchange ``--strategy`` instead of the
sequential one.  ``--precondition KIND`` profiles the preconditioned
iteration (``--block`` sets the block-Jacobi block size).  ``--adaptive
POLICY`` profiles the adaptive iteration (``rank_apply`` and ``drop_mask``
in place of the Cholesky and ``chol_apply``); with ``--deficient M`` the
right-hand side is zero outside the first M of the t contiguous subdomains,
so the width drops to M at the first iteration and, on a mesh, the steps
run the narrower segment's runner (its compacted exchange), as the
segmented solve does.  ``--method pipelined|sstep`` (``--s``, ``--reorth``)
profiles another iteration scheme; for s-step one step is a block of s
iterations, and the per-iteration numbers are per block (the line's
``iters_per_step`` says how many).  ``--overlap`` (with ``--devices``)
profiles the interior/boundary SpMBV schedule.  Every run also reads the
device timeline (the profiler's kernel events, by stream): the busy time as
the union of kernel intervals, the kernel time per stream, and how long a
halo kernel or a copy of the exchange on one stream ran while ``bsr_spmbv``
ran on another (``concurrent_ms_per_iter``: the exchange the overlap
schedule hid).  ``--pack G`` profiles one iteration of a packed solve of G
requests (``ECGSolver.solve_packed``'s runner at width G·t, ``--t`` the
per-request width, ``rankrev`` unless ``--adaptive`` says otherwise; the
tolerances are out of reach, so no request retires while it runs) and
times the packed scheme's own passes on the iteration's own (n, G·t)
blocks, each by name (``group_passes_ms``: the per-group reshape-sum of R,
every iteration; the restart, once per retirement), beside the
single-request residual sum the first stands in for (``solo_passes_ms``).  ``--trace PATH`` also writes the Chrome trace.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: the CUDA runtime- and driver-API calls with which the host puts work on a stream
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
               "cudaGraphLaunch", "cuGraphLaunch", "cudaMemsetAsync", "cudaMemcpyAsync")


def launch_calls(averages) -> dict[str, int]:
    """{API name: calls} of the launch calls among ``prof.key_averages()``."""
    return {e.key: e.count for e in averages if e.key in LAUNCH_APIS}


def host_launches(torch, fn) -> dict[str, int]:
    """The launch calls the host makes in one call of ``fn`` (after one
    call to warm up), by API name, with their ``total``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    calls = launch_calls(prof.key_averages())
    return {"total": sum(calls.values()), **calls}


def kernel_events(prof) -> list[dict]:
    """The device kernels and copies of a ``torch.profiler`` run, from its
    Chrome trace: ``{"name", "stream", "ts", "dur"}`` each (µs)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.unlink(path)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [{"name": e.get("name", ""), "stream": e.get("args", {}).get("stream", e.get("tid")),
             "ts": float(e["ts"]), "dur": float(e.get("dur", 0.0))}
            for e in events
            if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def _union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for lo, hi in sorted(intervals):
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return total


def timeline(events) -> dict:
    """Busy time (the union of all kernel intervals), kernel time per
    stream, and the time during which a kernel of the exchange (``halo_*``
    or a copy) on one stream overlapped a ``bsr_spmbv`` on another, in µs."""
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events]
    per_stream: dict = {}
    for e in events:
        per_stream[str(e["stream"])] = per_stream.get(str(e["stream"]), 0.0) + e["dur"]
    spmbv = [e for e in events if "bsr_spmbv" in e["name"]]
    exch = [e for e in events if "halo_" in e["name"] or "Memcpy" in e["name"]
            or "copy" in e["name"].lower()]
    pieces = []
    for x in exch:
        for m in spmbv:
            if m["stream"] != x["stream"]:
                lo, hi = max(x["ts"], m["ts"]), min(x["ts"] + x["dur"], m["ts"] + m["dur"])
                if hi > lo:
                    pieces.append((lo, hi))
    return {"busy_us": _union_us(spans), "per_stream_us": per_stream,
            "concurrent_us": _union_us(pieces)}


def group_passes(torch, carry, g, te, reps) -> dict:
    """CUDA-event ms per call of the packed scheme's own passes on a packed
    iteration's (n, g·te) R block (the ops of ``core/methods/classic.py``,
    each by name): the per-group residual sum of every iteration, and the
    restart of a retirement (each live group's residual split afresh, the
    zero P and AP); and of the single-request residual sum it stands in
    for."""
    from repro_torch.core.enlarging import split_residual

    big_r = carry["R"]
    live = torch.ones(g, dtype=torch.bool, device=big_r.device)
    rsum_g = big_r.reshape(big_r.shape[0], g, te).sum(dim=2)

    def restart():
        fresh = torch.cat([split_residual(rsum_g[:, j], te) for j in range(g)], dim=1)
        fresh = fresh * live.repeat_interleave(te).to(fresh.dtype)[None, :]
        return fresh, torch.zeros_like(big_r), torch.zeros_like(big_r)

    ops = {
        "rsum_per_group": lambda: big_r.reshape(big_r.shape[0], g, te).sum(dim=2),
        "restart_at_retirement": restart,
    }
    solo = {"rsum": lambda: big_r.sum(dim=1)}

    def ms(fn):
        for _ in range(3):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    return {"group_passes_ms": {k: ms(f) for k, f in ops.items()},
            "solo_passes_ms": {k: ms(f) for k, f in solo.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--elements", type=int, nargs=2, default=(320, 256))
    ap.add_argument("--devices", type=int, default=0,
                    help="ranks of a virtual mesh (0: the sequential solve)")
    ap.add_argument("--ppn", type=int, default=4)
    ap.add_argument("--strategy", default="optimal",
                    choices=["standard", "2step", "3step", "optimal"])
    ap.add_argument("--precondition", default="none",
                    choices=["none", "block_jacobi", "chebyshev", "inexact"])
    ap.add_argument("--block", type=int, default=16, help="block-Jacobi block size")
    ap.add_argument("--adaptive", default=None, choices=["rankrev", "reduce", "reduce+restart"])
    ap.add_argument("--deficient", type=int, default=0, metavar="M",
                    help="right-hand side on the first M of the t subdomains only (0: all)")
    ap.add_argument("--method", default="classic", choices=["classic", "pipelined", "sstep"])
    ap.add_argument("--s", type=int, default=1, help="s-step inner steps")
    ap.add_argument("--reorth", action="store_true", help="s-step Cholesky-QR2 second pass")
    ap.add_argument("--overlap", action="store_true",
                    help="the interior/boundary SpMBV schedule (with --devices)")
    ap.add_argument("--t", type=int, default=8, help="enlarging factor (per request with --pack)")
    ap.add_argument("--pack", type=int, default=0, metavar="G",
                    help="profile a packed solve of G requests (width G·t)")
    ap.add_argument("--trace", default=None)
    args = ap.parse_args(argv)
    if args.devices and args.devices % args.ppn:
        ap.error(f"--devices {args.devices} is not a multiple of --ppn {args.ppn}")
    if args.overlap and not args.devices:
        ap.error("--overlap needs a mesh (--devices)")
    if args.pack and (args.method != "classic" or args.deficient or args.precondition != "none"):
        ap.error("--pack profiles the classic scheme's packed solve alone")
    if args.pack and args.adaptive is None:
        args.adaptive = "rankrev"  # solve_packed needs a rank-revealing policy

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_solve: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.adaptive.groups import GroupSpec
    from repro_torch.launch.mesh import VirtualMesh
    from repro_torch.solver import CommConfig, ECGSolver, KernelConfig, SolverConfig
    from repro_torch.sparse import dg_laplace_2d

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    a = dg_laplace_2d(tuple(args.elements), block=16, device=dev)
    n = a.shape[0]
    b = np.random.default_rng(0).standard_normal(n)
    if args.deficient:
        b[(args.deficient * n) // args.t:] = 0.0
    config = SolverConfig(
        t=args.t, tol=0.0, max_iters=10 + 2 * args.iters, kernel=KernelConfig(backend="pallas"),
        comm=CommConfig(strategy=args.strategy, overlap=args.overlap),
        precondition=(dict(kind="block_jacobi", block=args.block)
                      if args.precondition == "block_jacobi" else args.precondition),
        adaptive=args.adaptive, method=args.method,
    ).replace(s=args.s, reorth=args.reorth)
    if args.devices:
        mesh = VirtualMesh(args.devices // args.ppn, args.ppn, device=dev)
        solver = ECGSolver.build(a, mesh, config)
    else:
        solver = ECGSolver.build(a, config=config, device=dev)
    if args.pack:
        # tolerances out of reach: every request stays live, at the full width
        spec = GroupSpec(t_each=args.t, tols=(1e-300,) * args.pack)
        rng = np.random.default_rng(0)
        b = solver._device_block([rng.standard_normal(n) for _ in range(args.pack)])
        runner = solver._packed_runner(spec, spec.width)

        def step(carry):
            return runner.step(carry)

        carry = runner.init(b, torch.zeros_like(b))
    else:
        b = solver._device_vec(b)  # the padded per-rank layout on a mesh

        def step(carry):
            # a segmented solve runs each width's runner: the one of the active width
            width = int(carry["ahist"][carry["k"]]) if solver._segmented else solver.t
            return solver._runner(width).step(carry)

        carry = solver._runner(solver.t).init(b, torch.zeros_like(b))
    for _ in range(10):
        carry = step(carry)
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    for _ in range(args.iters):
        carry = step(carry)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.iters

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            carry = step(carry)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3 / args.iters
    if args.trace:
        prof.export_chrome_trace(args.trace)
    line = timeline(kernel_events(prof))

    def dev_us(e):
        return getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)

    averages = prof.key_averages()
    rows = [
        (e.key, e.count / args.iters, dev_us(e) / 1e3 / args.iters)
        for e in averages if e.device_type == DeviceType.CUDA
    ]
    calls = launch_calls(averages)
    rows.sort(key=lambda r: -r[2])
    busy_ms = sum(r[2] for r in rows)
    passes = group_passes(torch, carry, args.pack, args.t, args.iters) if args.pack else None
    print(smi)
    print(json.dumps({
        "n": a.shape[0], "t": args.t, "iters": args.iters, "pack": args.pack or None,
        "width": args.t * (args.pack or 1),
        "mesh": list(mesh.shape) if args.devices else None,
        "strategy": args.strategy if args.devices else "sequential",
        "precondition": args.precondition, "adaptive": args.adaptive,
        "deficient": args.deficient or None, "method": args.method, "s": args.s,
        "reorth": args.reorth, "overlap": args.overlap,
        "iters_per_step": args.s if args.method == "sstep" else 1,
        "active_width": int(carry["ahist"][carry["k"]]) if args.adaptive else args.t,
        "wall_ms_per_iter": wall_ms,
        "profiled_wall_ms_per_iter": prof_wall_ms, "device_busy_ms_per_iter": busy_ms,
        "device_idle_share": 1.0 - busy_ms / prof_wall_ms if prof_wall_ms else None,
        # the timeline: busy as the union of kernel intervals (streams
        # overlap under --overlap), kernel time per stream, and the exchange
        # time hidden behind bsr_spmbv on another stream
        "device_union_busy_ms_per_iter": line["busy_us"] / 1e3 / args.iters,
        "device_idle_share_union": (1.0 - line["busy_us"] / 1e3 / args.iters / prof_wall_ms
                                    if prof_wall_ms else None),
        "stream_ms_per_iter": {k: v / 1e3 / args.iters for k, v in line["per_stream_us"].items()},
        "concurrent_ms_per_iter": line["concurrent_us"] / 1e3 / args.iters,
        "host_launches_per_iter": sum(calls.values()) / args.iters,
        "host_launch_calls_per_iter": {k: v / args.iters for k, v in sorted(calls.items())},
        "device_ops_per_iter": sum(r[1] for r in rows),
        **(passes or {}),
    }))
    for name, calls, ms in rows:
        print(json.dumps({"kernel": name[:120], "calls_per_iter": calls, "device_ms_per_iter": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
