#!/usr/bin/env python3
"""Measure the port's ``MachineParams`` on the card it runs on.

    PYTHONPATH=src python tools/calibrate_h100.py [--link] [--out PATH]

The paper's models (``repro_torch.core.models``) and the tuner
(``repro_torch.tune``) charge a machine's latencies, transport rates,
memory rate, flop rate and per-dispatch cost.  This script measures each of
them for what the port runs on: one GPU, with the distributed solve's ranks
on a ``VirtualMesh(2, 4)``, whose rotations (``mesh.ppermute``) are
device-local copies, and whose exchanges replay as one CUDA graph each.
It prints one JSON object (and writes it to ``--out`` when given):

* ``dispatch_overhead`` — ``repro_torch.tune.measure_dispatch_overhead`` on
  the mesh: the per-op slope of a captured pack → rotation → unpack chain.
* ``R_b`` / ``R_bl`` — bytes over time of one rotation along the ``node`` /
  ``proc`` axis, the median over buffers of 64 MiB and more (well past the
  latency floor; a sweep of 64 B … 256 MiB is printed beside them).
* ``alpha`` / ``alpha_l`` — the time of one near-empty rotation (8 bytes a
  rank) along ``node`` / ``proc``, from a CUDA graph of many.
* ``R_mem`` — a streaming copy of 1 GiB: bytes read plus bytes written over
  time.
* ``gamma`` — seconds per float64 flop of an 8192² ``torch.matmul``.
* ``matmul_flops`` — the dense-matmul rates the roofline prices a step's
  compute term with (``repro_torch.core.machines.H100_ROOFLINE``): FLOP/s
  of an 8192² ``torch.matmul`` in bfloat16, in float32 with TF32 off and
  in float32 with TF32 on (``"tfloat32"``).
* ``link_bw`` — with ``--link`` only, on a machine with two cards or more:
  the bus bandwidth of an NCCL ``all_reduce`` of 256 MiB of float32 over
  every card (one process a card; bus bytes 2·(n − 1)/n times the buffer,
  NCCL's convention), the median over batches.  Without ``--link`` it is
  None, and so it is on one card, where there is no link.

Two constants have no physical meaning on one card and are derived:

* ``R_N`` (a node's injection rate): the ranks of a node share the card's
  one memory system, so a node injects at the rate one rotation copies at:
  ``R_N = R_b``.
* ``eager_cutoff`` (the §4.3 message size that splits eager from
  rendezvous sends): the message size at which the measured ``node``
  rotation takes twice its latency floor ``alpha``, interpolated
  log-linearly in the sweep, in bytes per rank.

Every time is a CUDA-event time of work on the card, a median over batches.
The script needs a CUDA device and fails without one.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SWEEP_BYTES = tuple(2**k for k in range(6, 29, 2))  # 64 B … 256 MiB per rotation
RATE_MIN_BYTES = 64 * 2**20                         # sizes past the latency floor
BATCHES = 5
MATMUL_N = 8192
LINK_BYTES, LINK_CALLS = 256 * 2**20, 20


def _graph_ms(torch, fn, calls: int) -> float:
    """Device ms per call of ``fn``: ``calls`` calls captured in one CUDA
    graph, replayed, median over BATCHES replays."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
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
        per_call.append(start.elapsed_time(end) / calls)
    del graph
    torch.cuda.empty_cache()
    return statistics.median(per_call)


def _rotation_ms(torch, mesh, axis: str, nbytes: int) -> float:
    """Device ms of one ``mesh.ppermute`` of an ``nbytes`` float64 buffer
    (all ranks together) along ``axis``."""
    rows = max(1, nbytes // (8 * mesh.p))
    buf = torch.ones(mesh.p, rows, 1, dtype=torch.float64, device=mesh.device)
    calls = max(1, min(100, (2 * 2**30) // max(nbytes, 1)))  # at most ~2 GiB of outputs
    return _graph_ms(torch, lambda: mesh.ppermute(buf, axis, 1), calls)


def _eager_cutoff(sweep: list[dict], alpha_s: float, p: int) -> int:
    """Bytes per rank at which a ``node`` rotation takes 2·alpha: log-linear
    interpolation between the two sweep sizes that bracket it."""
    pts = [(row["bytes"], row["node_s"]) for row in sweep]
    target = 2 * alpha_s
    for (b0, s0), (b1, s1) in zip(pts, pts[1:]):
        if s0 < target <= s1:
            x = math.log(b0) + (math.log(b1) - math.log(b0)) * (target - s0) / (s1 - s0)
            return int(round(math.exp(x) / p))
    raise RuntimeError(f"no sweep size reaches twice the latency floor {alpha_s} s: {pts}")


def measure(torch, link: bool = False) -> dict:
    """Every constant of the H100 ``MachineParams``, measured on the current
    card (see the module docstring), with the sweep and the card's name and
    power limit; with ``link``, also the all-reduce bus bandwidth over every
    card (:func:`measure_link`, two cards or more)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.mesh import VirtualMesh
    from repro_torch.tune import measure_dispatch_overhead

    if not torch.cuda.is_available():
        raise RuntimeError("calibrate_h100: CUDA is not available; the constants are the card's")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    mesh = VirtualMesh(2, 4, device=dev)

    dispatch = measure_dispatch_overhead(mesh)
    sweep = []
    for nbytes in SWEEP_BYTES:
        node_ms = _rotation_ms(torch, mesh, "node", nbytes)
        proc_ms = _rotation_ms(torch, mesh, "proc", nbytes)
        sweep.append({"bytes": nbytes, "node_s": node_ms * 1e-3, "proc_s": proc_ms * 1e-3})
    big = [row for row in sweep if row["bytes"] >= RATE_MIN_BYTES]
    r_b = statistics.median(row["bytes"] / row["node_s"] for row in big)
    r_bl = statistics.median(row["bytes"] / row["proc_s"] for row in big)
    alpha, alpha_l = sweep[0]["node_s"], sweep[0]["proc_s"]

    n_copy = 2**30 // 8
    src = torch.ones(n_copy, dtype=torch.float64, device=dev)
    dst = torch.empty_like(src)
    copy_s = _graph_ms(torch, lambda: dst.copy_(src), 10) * 1e-3
    r_mem = 2 * n_copy * 8 / copy_s
    del src, dst

    gamma = 1.0 / _matmul_flops(torch, dev, torch.float64)
    matmul = {"bfloat16": _matmul_flops(torch, dev, torch.bfloat16),
              "float32": _matmul_flops(torch, dev, torch.float32, tf32=False),
              "tfloat32": _matmul_flops(torch, dev, torch.float32, tf32=True)}
    n_cards = torch.cuda.device_count()
    link_bw = measure_link(n_cards) if link and n_cards >= 2 else None

    return {
        "card": smi,
        "device": torch.cuda.get_device_name(0),
        "mesh": list(mesh.shape),
        "alpha": alpha,
        "alpha_l": alpha_l,
        "R_N": r_b,
        "R_b": r_b,
        "R_bl": r_bl,
        "gamma": gamma,
        "eager_cutoff": _eager_cutoff(sweep, alpha, mesh.p),
        "R_mem": r_mem,
        "dispatch_overhead": dispatch,
        "matmul_flops": matmul,
        "link_bw": link_bw,
        "cards": n_cards,
        "sweep": sweep,
    }


def _matmul_flops(torch, dev, dtype, tf32: bool = False) -> float:
    """FLOP/s of an ``MATMUL_N``² ``torch.matmul`` in ``dtype`` (float32
    with TF32 on or off), 2·n³ flops over its graph-replayed time; the
    TF32 setting is restored after."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        x = torch.randn(MATMUL_N, MATMUL_N, dtype=dtype, device=dev)
        y = torch.randn(MATMUL_N, MATMUL_N, dtype=dtype, device=dev)
        mm_s = _graph_ms(torch, lambda: torch.matmul(x, y), 3) * 1e-3
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    del x, y
    torch.cuda.empty_cache()
    return 2.0 * MATMUL_N**3 / mm_s


def measure_link(n_cards: int) -> float:
    """The bus bandwidth (B/s) of an NCCL ``all_reduce`` of ``LINK_BYTES``
    over ``n_cards`` processes, one a card (:func:`_link_worker`), started
    here and joined; rank 0's median."""
    import multiprocessing as mp
    import socket

    with socket.socket() as sock:  # a free port for the rendezvous on this host
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_link_worker, args=(rank, n_cards, port, queue))
             for rank in range(n_cards)]
    for p in procs:
        p.start()
    try:
        results = dict(queue.get(timeout=300) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    failed = {r: v for r, v in results.items() if isinstance(v, str)}
    if failed or any(p.exitcode for p in procs):
        raise RuntimeError(f"measure_link: workers failed: {failed or [p.exitcode for p in procs]}")
    return results[0]


def _link_worker(rank: int, world: int, port: int, queue) -> None:
    """One process of :func:`measure_link`: joins the NCCL world on card
    ``rank``, times ``LINK_CALLS`` all-reduces a batch with CUDA events,
    and puts (rank, bus B/s) on ``queue`` (the error's text on failure)."""
    import datetime

    import torch
    import torch.distributed as dist

    try:
        torch.cuda.set_device(rank)
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=120))
        try:
            buf = torch.ones(LINK_BYTES // 4, dtype=torch.float32, device=torch.device("cuda", rank))
            for _ in range(2):
                dist.all_reduce(buf)
            per_call = []
            for _ in range(BATCHES):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(LINK_CALLS):
                    dist.all_reduce(buf)
                end.record()
                end.synchronize()
                per_call.append(start.elapsed_time(end) * 1e-3 / LINK_CALLS)
            bus_bytes = 2 * (world - 1) / world * LINK_BYTES
            queue.put((rank, bus_bytes / statistics.median(per_call)))
        finally:
            dist.destroy_process_group()
    except Exception as e:  # noqa: BLE001 — reported to the parent, which raises
        queue.put((rank, f"{type(e).__name__}: {e}"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON object here")
    ap.add_argument("--link", action="store_true",
                    help="also measure the NCCL all-reduce bus bandwidth over every card (two or more)")
    args = ap.parse_args(argv)
    import torch

    result = measure(torch, link=args.link)
    text = json.dumps(result)
    print(text, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
