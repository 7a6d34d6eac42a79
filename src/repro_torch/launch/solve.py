"""ECG solve command line on the port's ECGSolver handle.

    PYTHONPATH=src python -m repro_torch.launch.solve --matrix dg \
        --backend pallas --strategy sequential [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.solve --matrix fd --elements 6 \
        --t 4 --devices 8 --ppn 4 --strategy 3step --backend pallas [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.solve --matrix fd --t 8 \
        --strategy sequential --adaptive reduce [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.solve --matrix dg --backend pallas \
        --strategy optimal --devices 8 --ppn 4 --method sstep --s 2 [--reorth] [--overlap]
    PYTHONPATH=src python -m repro_torch.launch.solve --backend pallas --devices 8 \
        [--strategy tuned] [--tune model|model:structural|measure|off] [--t auto]
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 8 \
        -m repro_torch.launch.solve --devices 8 --ppn 4 --strategy optimal \
        --backend pallas [--device cpu]

The flags and the summary lines are the reference CLI's
(``python -m repro.launch.solve``).  ``--backend pallas`` runs the Block-ELL
SpMBV, fused Gram and fused tail CUDA kernels; ``--backend jnp`` plain torch
ops.  ``--device`` (default ``cuda``) selects the card, or ``cpu`` for the
kernels' plain versions.  ``--devices N --ppn K`` runs the distributed
node-aware solver on a ``VirtualMesh(N // K, K)``: all N ranks on that one
device (no re-exec, unlike the reference's forced host devices).  Under
``torch.distributed.run`` (``WORLD_SIZE`` set, and equal to ``--devices``)
it runs one rank per process on a ``ProcessGroupMesh(N // K, K)``
instead: NCCL on ``cuda:LOCAL_RANK``, or gloo with ``--device cpu``; only
rank 0 prints.  The overlap schedule, ``--tune measure`` and ``--t auto``
raise there (ROADMAP.md queue 1 item 5b, remainder).
``--precondition block_jacobi|chebyshev|inexact`` runs the preconditioned
solve (block-Jacobi through the ``block_trisolve`` CUDA kernel).
``--adaptive rankrev|reduce|reduce+restart`` runs the in-solve width
controller (the ``rank_apply`` and ``drop_mask`` CUDA kernels) and prints
the reference's summary of reduction events, restarts and, on a mesh, the
re-sliced exchange segments.  ``--method pipelined|sstep`` (``--s N``,
``--reorth``) runs the other iteration schemes, and ``--overlap`` the
interior/boundary SpMBV schedule on a mesh.

``--tune model`` (the default with ``--strategy tuned``, itself the
default) hands the strategy, the Block-ELL tile and blocking-vs-overlap to
the setup-time tuner (:mod:`repro_torch.tune`; sequentially the tile alone,
with ``--backend pallas``); ``--tune model:structural`` ranks strategies by
the executor-structural cost; ``--tune measure`` times the candidates on the
mesh (a sequential run uses the model); ``--tune off`` keeps the explicit
``--strategy``/``--ell-block``/``--overlap``.  The models use the H100's
measured parameters on a sequential run and the reference CLI's TPU-v5e set
(with ``--ppn``) on a mesh, so the distributed plans equal the reference's.
``--t auto`` picks the enlarging factor from the iterations-vs-cost model
(:mod:`repro_torch.adaptive.select_t`) and prints its table; it needs the
cost models, so ``--tune off`` refuses it.

``--trace PATH`` installs a :class:`~repro_torch.observe.Tracer` as the
process tracer and writes the run's build and solve spans to ``PATH``: a
Chrome/Perfetto trace, or an append-only event log for ``*.jsonl``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import time


def _parse_t(value: str) -> int | str:
    if value == "auto":
        return "auto"
    try:
        t = int(value)
    except ValueError:
        raise argparse.ArgumentTypeError(f"--t must be a positive int or 'auto', got {value!r}")
    if t < 1:
        raise argparse.ArgumentTypeError(f"--t must be >= 1, got {t}")
    return t


def _print_adaptive_summary(res) -> None:
    """Chosen t, selection table, and reduction events for the run summary."""
    if res.selection is not None:
        print(res.selection.summary())
    events = res.reduction_events()
    if events:
        for k, before, after in events:
            kind = "re-enlarged" if after > before else "reduced"
            print(f"  iter {k}: active width {kind} {before} -> {after}")
        if res.restarts:
            print(f"  restarts: {res.restarts}")
    elif res.active_hist is not None:
        print(f"  active width constant at t={res.t}")
    if res.comm_segments and len(res.comm_segments) > 1:
        trace = ", ".join(f"{it} iters @ width {w}" for w, it in res.comm_segments)
        print(f"  exchange payload re-sliced: {trace}")
    if res.breakdown:
        print("  BREAKDOWN: solver stopped at the last finite iterate")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--matrix", default="dg", choices=["dg", "fd", "random"])
    ap.add_argument("--elements", type=int, default=16)
    ap.add_argument("--block", type=int, default=16)
    ap.add_argument("--t", type=_parse_t, default=8,
                    help="enlarging factor, or 'auto' to pick it from the "
                         "iterations-vs-cost model")
    ap.add_argument("--tol", type=float, default=1e-8)
    ap.add_argument("--strategy", default="tuned",
                    choices=["sequential", "standard", "2step", "3step", "optimal", "tuned"])
    ap.add_argument("--devices", type=int, default=0,
                    help="distributed run over this many ranks of a virtual mesh")
    ap.add_argument("--ppn", type=int, default=4)
    ap.add_argument("--backend", default="jnp", choices=["jnp", "pallas"])
    ap.add_argument("--overlap", action="store_true")
    ap.add_argument("--ell-block", type=int, default=8, help="Block-ELL tile size")
    ap.add_argument("--tune", default=None,
                    choices=["model", "model:structural", "measure", "off"],
                    help="autotune strategy/tile/overlap (default: model when "
                         "--strategy tuned or --t auto, else off)")
    ap.add_argument("--adaptive", default=None,
                    choices=["off", "rankrev", "reduce", "reduce+restart"])
    ap.add_argument("--method", default="classic",
                    choices=["classic", "pipelined", "sstep"])
    ap.add_argument("--s", type=int, default=1)
    ap.add_argument("--reorth", action="store_true")
    ap.add_argument("--precondition", default="none",
                    choices=["none", "block_jacobi", "chebyshev", "inexact"])
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a span trace of the run: *.json = Chrome/"
                         "Perfetto trace, *.jsonl = append-only event log")
    args = ap.parse_args(argv)
    if args.method == "pipelined" and args.precondition == "inexact":
        ap.error("--precondition inexact needs the flexible residual reseed, "
                 "which --method pipelined cannot absorb into its AZ "
                 "recurrence; use --method classic or sstep, or a fixed "
                 "preconditioner")
    if args.method != "sstep":
        if args.s != 1:
            ap.error(f"--s {args.s} only applies to --method sstep")
        if args.reorth:
            ap.error("--reorth only applies to --method sstep")
    if args.devices and args.devices % args.ppn:
        ap.error(f"--devices {args.devices} is not a multiple of --ppn {args.ppn}")
    world = int(os.environ.get("WORLD_SIZE", 0))  # set by torch.distributed.run
    if world and args.devices != world:
        ap.error(f"--devices {args.devices} must equal the WORLD_SIZE {world} of "
                 "torch.distributed.run: one rank per process")
    if world and args.trace:
        ap.error("--trace writes one file: run it without torch.distributed.run")
    if args.t == "auto" and args.tune == "off":
        ap.error("--t auto composes the tuner's cost models and cannot run "
                 "with --tune off; use --tune model (or --tune measure — the "
                 "t ranking itself is always model-based, measured "
                 "calibration applies to the operator tuning)")
    if args.t == "auto" and args.tune == "measure":
        print("note: --t auto ranks candidates with the model-mode cost; "
              "--tune measure calibrates the distributed operator tuning only")
    if args.tune is None:
        args.tune = "model" if (args.strategy == "tuned" or args.t == "auto") else "off"
    if world:
        _run_in_world(args)
        return
    if args.trace is None:
        _run(args)
        return
    # install as the process tracer: the solver's build and solve spans and
    # counters reach the sink without threading a tracer through the handle
    from repro_torch.observe import Tracer, open_sink, set_tracer

    tracer = Tracer(sinks=[open_sink(args.trace)])
    prev = set_tracer(tracer)
    try:
        _run(args)
    finally:
        set_tracer(prev)
        tracer.close()
    print(f"# trace written to {args.trace}")


def _run_in_world(args):
    """One process of a ``torch.distributed.run`` world: join (or reuse) the
    process group, solve on a ``ProcessGroupMesh``, print on rank 0 only."""
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import ProcessGroupMesh

    own_group = not dist.is_initialized()
    if own_group:
        cuda = args.device != "cpu"
        if cuda:  # NCCL: the card before the group
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl" if cuda else "gloo",
                                timeout=datetime.timedelta(seconds=60))
    try:
        mesh = ProcessGroupMesh(args.devices // args.ppn, args.ppn)
        quiet = contextlib.redirect_stdout(io.StringIO()) if mesh.rank else contextlib.nullcontext()
        with quiet:
            _run(args, mesh)
    finally:
        if own_group:
            dist.destroy_process_group()


def _run(args, mesh=None):
    import numpy as np
    import torch

    from repro_torch.core.cg import _cg_solve
    from repro_torch.core.machines import TPU_V5E_POD
    from repro_torch.core.methods import get_method
    from repro_torch.kernels.dispatch import resolve_device
    from repro_torch.launch.mesh import VirtualMesh
    from repro_torch.solver import (
        AdaptiveConfig, CommConfig, ECGSolver, KernelConfig, MethodConfig,
        SolverConfig, TuneConfig,
    )
    from repro_torch.sparse import csr_spmv, dg_laplace_2d, fd_laplace_2d, random_spd

    device = resolve_device(args.device) if mesh is None else mesh.device
    a = {
        "dg": lambda: dg_laplace_2d((args.elements, args.elements), block=args.block,
                                    device=device),
        "fd": lambda: fd_laplace_2d(args.elements * 4, device=device),
        "random": lambda: random_spd(1024, density=0.02, device=device),
    }[args.matrix]()
    rng = np.random.default_rng(0)
    b = rng.standard_normal(a.shape[0])
    print(f"matrix: {a.shape[0]} rows, {a.nnz} nnz; t={args.t}")

    sequential = args.strategy == "sequential" or not args.devices
    if sequential and args.tune == "measure":
        print("note: measured tuning needs a device mesh; using the model "
              "for the sequential run")
        args.tune = "model"
    strategy = args.strategy if args.strategy not in ("sequential", "tuned") else "standard"
    config = SolverConfig(
        t=args.t,
        tol=args.tol,
        max_iters=5000,
        comm=CommConfig(
            strategy=strategy,
            overlap=args.overlap,
            # the reference CLI's model parameters, so the plans are equal
            machine=None if sequential else TPU_V5E_POD.with_ppn(args.ppn),
        ),
        kernel=KernelConfig(backend=args.backend, ell_block=args.ell_block),
        adaptive=AdaptiveConfig(policy=args.adaptive),
        tune=TuneConfig(mode=args.tune),
        method=MethodConfig(name=args.method, s=args.s, reorth=args.reorth),
        precondition=args.precondition,
    )
    if config.precondition.active:
        print(f"preconditioner: {config.precondition.kind}")
    coll = get_method(args.method).collectives_per_iteration(args.s, args.reorth)
    mtag = args.method + (f"[s={args.s}]" if args.method == "sstep" else "")
    print(f"method: {mtag} ({coll:g} psums/iter)")

    if sequential:
        solver = ECGSolver.build(a, config=config, b=b, device=device)
        if solver.tuned is not None:
            print(f"tuned tile: {solver.tuned.ell_block} kmax={solver.tuned.kmax}")
        t0 = time.time()
        res = solver.solve(b)
        print(f"sequential ECG[{mtag}/{args.backend}] t={res.t}: iters={res.n_iters} "
              f"converged={res.converged} {time.time()-t0:.1f}s")
        _print_adaptive_summary(res)
        b_dev = solver.a.data.new_tensor(b)
        res_cg = _cg_solve(lambda v: csr_spmv(solver.a, v), b_dev, tol=args.tol, max_iters=20000)
        print(f"reference CG:  iters={res_cg.n_iters}")
        return

    if mesh is None:
        mesh = VirtualMesh(args.devices // args.ppn, args.ppn, device=device)
    t0 = time.time()
    solver = ECGSolver.build(a, mesh, config, b=b)
    res = solver.solve(b)
    if solver.tuned is not None:
        cfg = solver.tuned
        strategy = cfg.strategy
        print(f"tuned[{cfg.mode}]: strategy={cfg.strategy} tile={cfg.ell_block} "
              f"kmax={cfg.kmax} overlap={cfg.overlap} col_split={cfg.col_split}")
        if "p2p" in cfg.predicted:
            print("  p2p model:",
                  {k: f"{v*1e6:.0f}us" for k, v in cfg.predicted["p2p"].items()})
    x = solver.a.data.new_tensor(solver.unshard(res.x))
    b_dev = solver.a.data.new_tensor(b)
    relres = float(torch.linalg.norm(b_dev - csr_spmv(solver.a, x)) / torch.linalg.norm(b_dev))
    where = "devices" if mesh.capturable else "processes"
    print(
        f"distributed ECG[{mtag}/{strategy}/{args.backend}"
        f"{'/overlap' if solver.op.overlap else ''}] t={res.t} on {mesh.p} {where}: "
        f"iters={res.n_iters} converged={res.converged} relres={relres:.2e} "
        f"{time.time()-t0:.1f}s"
    )
    _print_adaptive_summary(res)


if __name__ == "__main__":
    main()
