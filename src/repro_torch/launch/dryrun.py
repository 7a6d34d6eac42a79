"""Multi-pod dry-run: trace every (arch x shape x mesh) cell on a fake world.

Port of ``repro/launch/dryrun.py``.  The reference lowers and compiles each
cell for 512 forced host devices; the port traces it.  For each cell:

  1. this process is rank 0 of the production mesh (16 × 16, or 2 × 16 × 16
     for ``multi``) in a ``fake`` world of 256 or 512 ranks
     (:func:`fake_world`; ``torch.testing._internal.distributed.fake_pg``,
     whose collectives move nothing), and the cell's step runs once under
     ``FakeTensorMode`` on fake tensors placed on ``--device`` (default
     ``cuda``, the card's dtypes and ops: no tensor is allocated and nothing
     is launched, so no card is needed; this host's torch may refuse to
     index fake CUDA tensors where it is built without CUDA, and then
     ``--device cpu`` traces the same program on the CPU's ops).  The state
     is abstract: the family's ``abstract_params`` (one process's blocks,
     no value drawn), the optimizer's zeros, the batch and the decode cache
     as empty tensors;
  2. ``torch.utils.flop_counter.FlopCounterMode`` counts the FLOPs,
     :class:`~repro_torch.analysis.roofline.OpBytes` the unfused HBM bytes,
     :meth:`~repro_torch.launch.mesh.LMMesh.record_calls` the collectives
     (op, group, bytes), and ``torch.distributed._tools.mem_tracker.
     MemTracker`` the rank's memory peak (the parameters, the optimizer
     state, the batch and the cache registered with it);
  3. the three roofline terms are priced with ``--machine``'s constants
     (:mod:`repro_torch.analysis.roofline`; ``h100``: the card's, measured
     by ``tools/calibrate_h100.py``).

The trace runs every layer (the port loops where the reference scans), so
the costs come from the full-depth trace itself: no 1- and 2-unit
extrapolation is needed.  :func:`_unit_layers` and :func:`_n_units` are
kept, and the tests hold the extrapolation of 1- and 2-layer traces equal
to the full trace.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --mesh both \\
        [--device cuda|cpu] [--machine h100|v5e] --out experiments/dryrun_torch.json
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.analysis.roofline import (
    MACHINES,
    OpBytes,
    cost_from_trace,
    count_collective_ops,
    matmul_dtype,
    model_flops,
    roofline_from_cost,
)
from repro_torch.configs import ARCH_IDS, SHAPE_CELLS, get_config, get_shapes
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.common import MeshAxes
from repro_torch.models.registry import model_api
from repro_torch.train.train_step import build_serve_step, build_train_step

DEFAULT_OUT = "experiments/dryrun_torch.json"


def _unit_layers(cfg, k: int):
    """Config with k layer-units, unrolled (extrapolation pass).  remat is
    preserved so the measured FLOPs include the real recompute cost."""
    kw = dict(n_layers=k, unroll=True)
    if cfg.family == "hybrid" and cfg.attn_period:
        kw["n_layers"] = k * cfg.attn_period  # period-level units
    if cfg.family == "encdec":
        kw["n_enc_layers"] = k
    return cfg.with_(**kw)


def _n_units(cfg) -> float:
    if cfg.family == "hybrid" and cfg.attn_period:
        return cfg.n_layers / cfg.attn_period  # ~1.5% tail correction noted
    return float(cfg.n_layers)


@contextlib.contextmanager
def fake_world(size: int):
    """``torch.distributed`` over a ``fake`` world of ``size`` ranks, this
    process rank 0, for the block; destroyed after.  Its collectives move
    nothing and wait for no one."""
    from torch.testing._internal.distributed.fake_pg import FakeStore  # registers "fake"

    if dist.is_initialized():
        raise RuntimeError("fake_world: torch.distributed is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@dataclasses.dataclass
class Trace:
    """One traced step of a cell, per device (this process)."""

    setup_s: float          # building the step and its abstract state
    trace_s: float          # the step
    flops: float            # FlopCounterMode's total
    hbm_bytes: float        # OpBytes' sum
    records: list           # (op, group ranks, result bytes) a collective
    calls: dict             # the mesh's calls by axis key
    peak_bytes: int         # MemTracker's peak, the registered state included
    argument_bytes: int     # parameters, optimizer state, batch rows or cache blocks
    output_bytes: int       # what the step returns or updates
    alias_bytes: int        # of which updated in place


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _abstract_batch(specs: dict, device) -> dict:
    return {k: torch.empty(shape, dtype=dtype, device=device) for k, (shape, dtype) in specs.items()}


def _batch_shards(mesh, batch: int) -> int:
    """The processes the global batch's rows are spread over (1 where the
    batch axes do not divide it: replicated, the reference's rule)."""
    if mesh is None:
        return 1
    axes = MeshAxes.from_mesh(mesh)
    n = math.prod(axes.size(a) for a in axes.batch)
    return n if batch % n == 0 else 1


def _trace_cell(cfg, mesh, kind: str, seq: int, batch: int, device=None) -> Trace:
    """Trace one cell's step on ``mesh`` (an LM mesh in a fake world; None
    for one device, ``device``): ``train`` the train bundle's ``step_fn``
    on abstract parameters, optimizer state and global batch; ``prefill``
    the family's ``loss_fn`` under ``torch.no_grad()`` on this process's
    rows (the reference models prefill as the loss's forward);
    ``decode`` ``build_serve_step(…, mesh=mesh)`` on an abstract cache."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    api = model_api(cfg)
    dev = mesh.device if mesh is not None else torch.device(device)
    shards = _batch_shards(mesh, batch)
    t0 = time.perf_counter()
    with FakeTensorMode():
        if kind == "train":
            bundle = build_train_step(cfg, batch=batch, seq=seq, mesh=mesh, device=dev)
            model = api.abstract_params(cfg, dev, mesh, bundle.param_specs)
            opt = bundle.init_opt(model)
            data = _abstract_batch(bundle.input_specs, dev)
            state = [*model.parameters(), *opt["mu"].values(), *opt["nu"].values(), opt["step"]]
            inputs, alias = list(data.values()), state

            def run():
                return bundle.step_fn(model, opt, data)
        elif kind == "prefill":
            loss = api.loss_fn(cfg, mesh)
            specs = api.param_specs(cfg, MeshAxes.from_mesh(mesh)) if mesh is not None else None
            model = api.abstract_params(cfg, dev, mesh, specs)
            data = _abstract_batch(api.train_input_specs(cfg, batch // shards, seq), dev)
            state, inputs, alias = list(model.parameters()), list(data.values()), []
            shards = 1  # the rows are this process's already

            def run():
                with torch.no_grad():
                    return loss(model, data)
        elif kind == "decode":
            step_fn, info = build_serve_step(cfg, batch, seq, device=dev, mesh=mesh)
            specs = api.param_specs(cfg, MeshAxes.from_mesh(mesh)) if mesh is not None else None
            model = api.abstract_params(cfg, dev, mesh, specs)
            cache = info["init_cache"]()
            data = {k: torch.empty((batch,), dtype=torch.int32, device=dev) for k in ("token", "pos")}
            state, inputs, alias = [*model.parameters(), *cache.values()], list(data.values()), list(cache.values())

            def run():
                return step_fn(model, cache, data)
        else:
            raise ValueError(f"unknown cell kind {kind!r}")
        setup_s = time.perf_counter() - t0
        tracker = MemTracker()
        tracker.track_external(model, *state[len(list(model.parameters())):], *inputs)
        flops, nbytes = FlopCounterMode(display=False), OpBytes()
        calls = mesh.record_calls() if mesh is not None else contextlib.nullcontext([])
        if mesh is not None:
            mesh.reset_counters()
        t0 = time.perf_counter()
        with tracker, flops, nbytes, calls as records:
            out = run()
        trace_s = time.perf_counter() - t0
        peak = sum(v["Total"] for v in tracker.get_tracker_snapshot("peak").values())
    outs = [t for t in torch.utils._pytree.tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
    arguments = _nbytes(state) + _nbytes(inputs) // shards
    # the decode step returns the cache it wrote in place: count it once
    returned = _nbytes(t for t in outs if not any(t is a for a in alias))
    return Trace(
        setup_s=setup_s, trace_s=trace_s, flops=float(flops.get_total_flops()),
        hbm_bytes=float(nbytes.nbytes), records=list(records),
        calls=dict(mesh.calls) if mesh is not None else {}, peak_bytes=int(peak),
        argument_bytes=int(arguments), output_bytes=int(returned + _nbytes(alias)),
        alias_bytes=int(_nbytes(alias)),
    )


def run_cell(arch: str, shape_name: str, multi_pod: bool, costs: bool = True, device="cuda",
             machine: str = "h100", cfg=None) -> dict:
    """One cell's record (the reference's keys): rank 0 of the production
    mesh over the initialised fake world (:func:`fake_world` of 256 ranks,
    512 under ``multi_pod``) traces the step; ``lower_s`` is the seconds of
    building the step and its abstract state, ``compile_s`` of tracing it.
    ``memory`` maps the tracker onto the reference's figures: the
    arguments (parameters, optimizer state, this process's batch rows or
    cache blocks), the outputs, the part of them updated in place
    (``alias``) and ``temp`` (the peak less the arguments).  With
    ``costs``, ``cost`` and ``roofline`` (priced with ``machine``'s
    constants at the peak of the config's dtype).  ``cfg`` overrides the
    arch's config (perf's levers)."""
    cfg = cfg or get_config(arch)
    kind, seq, batch = SHAPE_CELLS[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    chips = mesh.size
    rec: dict = dict(
        arch=arch, shape=shape_name, kind=kind, seq=seq, batch=batch,
        mesh="multi" if multi_pod else "single", chips=chips,
    )
    tr = _trace_cell(cfg, mesh, kind, seq, batch)
    rec["compile_s"] = round(tr.trace_s, 2)
    rec["lower_s"] = round(tr.setup_s, 2)
    rec["memory"] = dict(
        argument_bytes_per_dev=tr.argument_bytes,
        output_bytes_per_dev=tr.output_bytes,
        temp_bytes_per_dev=max(tr.peak_bytes - tr.argument_bytes, 0),
        alias_bytes_per_dev=tr.alias_bytes,
    )
    rec["collective_ops_schedule"] = count_collective_ops(tr.records)
    rec["collective_calls_by_axis"] = tr.calls
    rec["device"] = str(mesh.device)
    if costs:
        cost = cost_from_trace(tr.flops, tr.hbm_bytes, tr.records)
        rl = roofline_from_cost(cost, chips, model_flops(cfg, kind, seq, batch),
                                machine=MACHINES[machine], dtype=matmul_dtype(cfg.dtype))
        rec["cost"] = dict(
            flops_per_dev=cost.flops,
            hbm_bytes_per_dev=cost.hbm_bytes,
            coll_bytes_per_dev=cost.coll_bytes,
            coll_breakdown=cost.coll_breakdown,
        )
        rec["roofline"] = rl.as_dict()
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--no-costs", action="store_true")
    ap.add_argument("--device", default="cuda", help="the fake tensors' device: cuda (default) or cpu")
    ap.add_argument("--machine", default="h100", choices=sorted(MACHINES),
                    help="the roofline's constants")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPE_CELLS) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    results = []
    if out_path.exists():
        results = json.loads(out_path.read_text())

    done = {(r["arch"], r["shape"], r["mesh"]) for r in results if "error" not in r}
    n_fail = 0
    for mp in meshes:  # one fake world a mesh size
        mesh_name = "multi" if mp else "single"
        todo = [((arch, shape, mesh_name), get_shapes(arch)[shape]) for arch in archs for shape in shapes
                if (arch, shape, mesh_name) not in done]
        world = fake_world(512 if mp else 256) if any(s == "run" for _, s in todo) else contextlib.nullcontext()
        with world:
            for key, status in todo:
                arch, shape, _ = key
                if status.startswith("skip:"):
                    results = [r for r in results if (r["arch"], r["shape"], r["mesh"]) != key]
                    results.append(dict(arch=arch, shape=shape, mesh=key[2], skipped=status[5:]))
                    out_path.write_text(json.dumps(results, indent=1))
                    print(f"SKIP {key}: {status[5:]}", flush=True)
                    continue
                print(f"RUN  {key} ...", flush=True)
                t0 = time.time()
                try:
                    # roofline costs only needed on the single-pod mesh
                    rec = run_cell(arch, shape, mp, costs=not (mp or args.no_costs),
                                   device=args.device, machine=args.machine)
                    print(
                        f"  ok {time.time()-t0:.0f}s compile={rec['compile_s']}s "
                        f"temp={rec['memory']['temp_bytes_per_dev']/2**30:.2f}GiB"
                        + (
                            f" dominant={rec['roofline']['dominant']}"
                            f" frac={rec['roofline']['roofline_fraction']:.3f}"
                            if "roofline" in rec
                            else ""
                        ),
                        flush=True,
                    )
                except Exception as e:  # noqa: BLE001 — record and continue
                    rec = dict(
                        arch=arch, shape=shape, mesh=key[2],
                        error=f"{type(e).__name__}: {e}",
                        trace=traceback.format_exc()[-2000:],
                    )
                    n_fail += 1
                    print(f"  FAIL {type(e).__name__}: {str(e)[:200]}", flush=True)
                results = [r for r in results if (r["arch"], r["shape"], r["mesh"]) != key]
                results.append(rec)
                out_path.write_text(json.dumps(results, indent=1))
    print(f"done: {len(results)} cells, {n_fail} failures", flush=True)
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
