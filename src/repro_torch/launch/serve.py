"""ECG serving driver: replay a synthetic request trace through ECGServer.

Port of ``repro/launch/serve.py``:

    PYTHONPATH=src python -m repro_torch.launch.serve [--requests 32] [--t 4] \
        [--max-batch 8] [--cache-dir DIR] [--devices 8 --ppn 4] [--dups 8] \
        [--pack width --max-pack-width 16 --max-wait-s 0.05] \
        [--backend pallas] [--trace PATH] [--device cpu]

The driver synthesizes a single-RHS request trace over three operators
(2D Laplacian, anisotropic Laplacian, DG block operator) in shuffled
arrival order, with a configurable number of duplicate payloads (the
cross-request dedup case), and replays it through one
:class:`~repro_torch.serve.ECGServer`:

* first sight of each operator registers + builds its session (warm from
  ``--cache-dir`` when a previous run persisted its tuning there);
* requests coalesce per operator and dispatch through the operator's
  session — no runner is rebuilt after the per-operator first solve;
* the summary prints per-request convergence, the registry hit rate, the
  batching layout, and build latencies (cold vs warm).

Run it twice with the same ``--cache-dir`` to see the warm-start restart:
the second run's builds skip tuning/probes entirely.

``--pack width`` turns on cross-request width packing: compatible
requests coalesce into one enlarged block solve with per-request
retirement.  The summary then also prints the pack layouts and each
request's measured true relative residual, plus p50/p95/p99 per-request
latency for whichever policy ran.

``--device`` (default ``cuda``) is the card, or ``cpu`` for the kernels'
plain versions; ``--devices N --ppn K`` serves on a ``VirtualMesh(N // K,
K)`` on that device (no re-exec, unlike the reference's forced host
devices).  ``--backend pallas`` runs the Block-ELL SpMBV, fused Gram and
fused tail kernels (the default ``jnp`` is the reference server's solver
template; ``rank_apply`` and ``drop_mask`` run on the card either way).
``--trace PATH`` writes the replay's spans (``*.json`` Chrome/Perfetto,
``*.jsonl`` an append-only event log).
"""

from __future__ import annotations

import argparse
import time


def build_trace(requests: int, dups: int, scale: int, seed: int = 0, device="cpu"):
    """(operators, [(op_index, rhs)]) — shuffled arrival, seeded dups."""
    import numpy as np

    from repro_torch.sparse import aniso_laplace_2d, dg_laplace_2d, fd_laplace_2d

    ops = [
        ("fd2d", fd_laplace_2d(3 * scale, device=device)),
        ("aniso2d", aniso_laplace_2d(2 * scale, eps=0.01, device=device)),
        ("dg2d", dg_laplace_2d((scale, scale), block=4, device=device)),
    ]
    rng = np.random.default_rng(seed)
    fresh = requests - dups
    trace = [
        (int(i % len(ops)), rng.standard_normal(ops[i % len(ops)][1].shape[0]))
        for i in range(fresh)
    ]
    for i in range(dups):  # duplicate payloads of earlier requests
        trace.append(trace[i % fresh])
    # dedicated shuffle stream: the arrival order (and with it the batch
    # layout every benchmark counter derives from) must not depend on the
    # operator sizes, which shift how much of ``rng`` the draws consume
    order = np.random.default_rng(seed + 1).permutation(len(trace))
    return ops, [trace[i] for i in order]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--dups", type=int, default=8,
                    help="duplicate payloads in the trace (dedup hits)")
    ap.add_argument("--scale", type=int, default=8,
                    help="operator size knob (rows grow ~quadratically)")
    ap.add_argument("--t", default="4",
                    help="enlarging factor of the solver template, or 'auto'")
    ap.add_argument("--tol", type=float, default=1e-8)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-pending", type=int, default=256)
    ap.add_argument("--cache-dir", default=None,
                    help="warm-start cache directory (persists tuning)")
    ap.add_argument("--devices", type=int, default=0,
                    help="ranks of a virtual mesh for a distributed server")
    ap.add_argument("--ppn", type=int, default=4)
    ap.add_argument("--pack", choices=["off", "width"], default="off",
                    help="width-packing policy (off = dispatch batching)")
    ap.add_argument("--max-pack-width", type=int, default=16,
                    help="total packed column budget (requests per pack = "
                         "max-pack-width // t)")
    ap.add_argument("--max-wait-s", type=float, default=0.0,
                    help="packing deadline: close a partial pack once the "
                         "oldest pending request is this old (0 = off)")
    ap.add_argument("--seed", type=int, default=0,
                    help="trace seed (RHS draws + arrival shuffle)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a span trace of the replay: *.json = Chrome/"
                         "Perfetto trace, *.jsonl = append-only event log")
    ap.add_argument("--backend", default="jnp", choices=["jnp", "pallas"],
                    help="local compute formulation of the solver template")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.dups >= args.requests:
        ap.error(f"--dups must be < --requests, got {args.dups} >= {args.requests}")
    if args.devices and args.devices % args.ppn:
        ap.error(f"--devices {args.devices} is not a multiple of --ppn {args.ppn}")

    from repro_torch.kernels.dispatch import resolve_device
    from repro_torch.launch.mesh import VirtualMesh
    from repro_torch.serve import ECGServer, ServeConfig, latency_percentiles
    from repro_torch.solver import KernelConfig, SolverConfig

    device = resolve_device(args.device)
    tracer = None
    if args.trace:
        from repro_torch.observe import Tracer, open_sink

        tracer = Tracer(sinks=[open_sink(args.trace)])

    t = "auto" if args.t == "auto" else int(args.t)
    mesh = None
    if args.devices:
        mesh = VirtualMesh(args.devices // args.ppn, args.ppn, device=device)
    server = ECGServer(
        ServeConfig(
            solver=SolverConfig(t=t, tol=args.tol, adaptive="rankrev",
                                kernel=KernelConfig(backend=args.backend)),
            max_batch=args.max_batch,
            max_pending=args.max_pending,
            cache_dir=args.cache_dir,
            packing=dict(
                pack=args.pack,
                max_pack_width=args.max_pack_width,
                max_wait_s=args.max_wait_s,
            ),
        ),
        mesh=mesh,
        tracer=tracer,
        device=None if mesh is not None else device,
    )

    ops, trace = build_trace(args.requests, args.dups, args.scale,
                             seed=args.seed, device=device)
    names = [name for name, _ in ops]
    print(f"# trace: {len(trace)} requests over {len(ops)} operators "
          f"({', '.join(f'{n}={a.shape[0]} rows' for n, a in ops)}), "
          f"{args.dups} duplicate payloads")

    t0 = time.perf_counter()
    tickets = [(op_i, server.submit(ops[op_i][1], b)) for op_i, b in trace]
    server.flush()
    wall = time.perf_counter() - t0

    for op_i, tk in tickets:
        res = tk.result
        tag = " dedup" if tk.deduped else ""
        if tk.pack_id is not None:
            where = f"pack  {tk.pack_id:>2} (w{tk.pack_width} g{tk.group_index})"
            tag += f" relres={tk.relres:.1e}"
        else:
            where = f"batch {tk.batch_id:>2} (x{tk.batch_size})"
        print(f"  req {tk.request_id:>3} {names[op_i]:<8} {where} "
              f"iters={res.n_iters:>4} conv={bool(res.converged)}{tag}")

    st = server.stats()
    reg, q = st["registry"], st["queue"]
    print(f"\n{len(trace)} requests in {wall:.3f}s "
          f"({len(trace) / wall:.1f} req/s, policy={args.pack})")
    print(f"registry: {reg['hits']} hits / {reg['misses']} misses "
          f"({reg['evictions']} evictions, {reg['resident']} resident)")
    for rec in reg["builds"]:
        kind = "warm" if rec["warm"] else "cold"
        print(f"  build {rec['fingerprint'][:12]} n={rec['n']} t={rec['t']} "
              f"{kind} {rec['build_s']:.3f}s")
    print(f"batching: {q['batches']} batches {q['batch_sizes']}, "
          f"{q['dedup_shared']} requests served by dedup")
    if q["packs"]:
        for lay in q["pack_layouts"]:
            segs = "".join(
                f" {w}x{it}" for w, it in lay["comm_segments"]
            ) or " (unsegmented)"
            print(f"  pack {lay['pack_id']:>2}: width {lay['width']} = "
                  f"{lay['groups']} x t{lay['t_each']}, exchange{segs}")
    lat = latency_percentiles([tk for _, tk in tickets])
    if lat["n"]:
        print(f"latency: p50={lat['p50'] * 1e3:.1f}ms "
              f"p95={lat['p95'] * 1e3:.1f}ms p99={lat['p99'] * 1e3:.1f}ms "
              f"mean={lat['mean'] * 1e3:.1f}ms over {lat['n']} requests")
    else:
        print("latency: no completed requests")
    roll = q.get("rolling") or {}
    if roll.get("n"):
        print(f"rolling[{roll['window_s']:.0f}s]: {roll['rate_rps']:.1f} req/s")
    if args.cache_dir and any(not r["warm"] for r in reg["builds"]):
        print(f"re-run with --cache-dir {args.cache_dir} for warm builds")
    if tracer is not None:
        tracer.close()
        print(f"# trace written to {args.trace}")


if __name__ == "__main__":
    main()
