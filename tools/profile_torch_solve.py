#!/usr/bin/env python3
"""Where one iteration of the port's classic-ECG solve spends its time on the card.

    PYTHONPATH=src python tools/profile_torch_solve.py [--iters 50] [--elements 320 256]
    PYTHONPATH=src python tools/profile_torch_solve.py --devices 8 --ppn 4 --strategy optimal
    PYTHONPATH=src python tools/profile_torch_solve.py --precondition block_jacobi [--block 16]
    PYTHONPATH=src python tools/profile_torch_solve.py --adaptive reduce --deficient 4 \
        [--devices 8 --ppn 4]

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
segmented solve does.  ``--trace PATH`` also writes the Chrome trace.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
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
    ap.add_argument("--trace", default=None)
    args = ap.parse_args(argv)
    if args.devices and args.devices % args.ppn:
        ap.error(f"--devices {args.devices} is not a multiple of --ppn {args.ppn}")

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_solve: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
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
        b[(args.deficient * n) // 8:] = 0.0
    config = SolverConfig(
        t=8, tol=0.0, max_iters=10 + 2 * args.iters, kernel=KernelConfig(backend="pallas"),
        comm=CommConfig(strategy=args.strategy),
        precondition=(dict(kind="block_jacobi", block=args.block)
                      if args.precondition == "block_jacobi" else args.precondition),
        adaptive=args.adaptive,
    )
    if args.devices:
        mesh = VirtualMesh(args.devices // args.ppn, args.ppn, device=dev)
        solver = ECGSolver.build(a, mesh, config)
    else:
        solver = ECGSolver.build(a, config=config, device=dev)
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
    print(smi)
    print(json.dumps({
        "n": a.shape[0], "t": 8, "iters": args.iters,
        "mesh": list(mesh.shape) if args.devices else None,
        "strategy": args.strategy if args.devices else "sequential",
        "precondition": args.precondition, "adaptive": args.adaptive,
        "deficient": args.deficient or None,
        "active_width": int(carry["ahist"][carry["k"]]) if args.adaptive else 8,
        "wall_ms_per_iter": wall_ms,
        "profiled_wall_ms_per_iter": prof_wall_ms, "device_busy_ms_per_iter": busy_ms,
        "device_idle_share": 1.0 - busy_ms / prof_wall_ms if prof_wall_ms else None,
        "host_launches_per_iter": sum(calls.values()) / args.iters,
        "host_launch_calls_per_iter": {k: v / args.iters for k, v in sorted(calls.items())},
        "device_ops_per_iter": sum(r[1] for r in rows),
    }))
    for name, calls, ms in rows:
        print(json.dumps({"kernel": name[:120], "calls_per_iter": calls, "device_ms_per_iter": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
