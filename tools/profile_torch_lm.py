#!/usr/bin/env python3
"""Where a train step and a decode token of the port's LM spend their time
on the card.

    PYTHONPATH=src python tools/profile_torch_lm.py [--mode train|decode|both] \
        [--arch stablelm_1_6b] [--layers N] [--batch 8] [--seq 256] [--steps 3] \
        [--slots 32768] [--tokens 8] [--top 20] [--trace PATH] [--mesh D,M]

``train`` builds the config at full width in float32 as ``python -m
repro_torch.launch.train --preset full`` does, warms up one step, times
``--steps`` steps of ``build_train_step`` at ``--batch`` × ``--seq`` on
the host clock around synchronized work, then runs them again under
``torch.profiler``; the batch's frames (``whisper_medium``) or patch
embeddings (``paligemma_3b``) are drawn by ``batch_at`` beside the
tokens, as the trainer draws them.  ``decode`` builds the config in its
own dtype (bfloat16) with a ``--slots`` cache at batch 1 (K/V; for
``mamba2_780m`` the conv and SSM states, which do not grow with it; for
``zamba2_1_2b`` both; for ``whisper_medium`` also the cross K/V, filled by
``prefill_cross_cache`` from one batch's frames), warms up two tokens,
times ``--tokens`` tokens of ``build_serve_step``'s step, then profiles
them.  ``--layers N`` cuts the config to its first N layers at full width
(a MoE config whose whole depth does not fit one card: olmoe-1b-7b trains
on 8 of its 16 layers, phi3.5-moe-42b on 2 and decodes on 16 of its 32).
``--mesh D,M`` (train) then profiles the same step sharded on a
("data", "model") ``LMMesh`` over NCCL, from the same initial values: inside
a ``torch.distributed.run`` world of D·M processes, or, run alone, in a
world of 1 that the tool starts (every collective a real NCCL call of size
1); its line adds the NCCL calls a step by axis, and only rank 0 prints.
Each mode prints one JSON line (the card, wall and device-busy ms
a step or token, the device's idle share, the host's launch calls, peak
memory) and then one line per kernel name, the ``--top`` by device time.
It refuses to run without CUDA.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import tempfile
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def profile_fn(torch, fn, n: int, top: int, trace: str | None) -> tuple[dict, list[dict]]:
    """Wall ms per call of ``fn`` over ``n`` calls, then the same under
    ``torch.profiler``: busy ms per call (the union of kernel intervals),
    the idle share, launch calls and the ``top`` kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, str(ROOT / "tools"))
    from profile_torch_solve import kernel_events, launch_calls, timeline

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3 / n
    if trace:
        prof.export_chrome_trace(trace)
    busy_ms = timeline(kernel_events(prof))["busy_us"] / 1e3 / n
    averages = prof.key_averages()
    dev_us = lambda e: getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
    rows = sorted(({"kernel": e.key[:120], "calls_per_call": e.count / n,
                    "device_ms_per_call": dev_us(e) / 1e3 / n}
                   for e in averages if e.device_type == DeviceType.CUDA),
                  key=lambda r: -r["device_ms_per_call"])
    calls = launch_calls(averages)
    line = {"wall_ms": wall_ms, "profiled_wall_ms": prof_wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / prof_wall_ms,
            "device_kernels_per_call": sum(r["calls_per_call"] for r in rows),
            "host_launches_per_call": sum(calls.values()) / n}
    return line, rows[:top]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=["train", "decode", "both"], default="both")
    ap.add_argument("--arch", default="stablelm_1_6b")
    ap.add_argument("--layers", type=int, default=None, help="cut the config to N layers (full width)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--slots", type=int, default=32768)
    ap.add_argument("--tokens", type=int, default=8)
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--trace", default=None, help="also write the Chrome trace(s) to PATH")
    ap.add_argument("--mesh", default=None, help="train: also the sharded step on a D,M LMMesh")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_lm: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    rank = int(os.environ.get("RANK", 0))
    dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    torch.cuda.set_device(dev)
    gib = 2.0 ** 30
    out = print if rank == 0 else (lambda *a, **k: None)
    out(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    with contextlib.ExitStack() as stack:
        mesh = _lm_mesh(torch, args.mesh, stack) if args.mesh else None
        _profile(torch, args, dev, gib, out, mesh)
    return 0


def _lm_mesh(torch, shape: str, stack):
    """An LMMesh over the torch.distributed.run world, or over a NCCL world
    of 1 started here (file rendezvous in a temporary directory)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import LMMesh

    if "WORLD_SIZE" in os.environ:
        dist.init_process_group("nccl")
    else:
        tmp = stack.enter_context(tempfile.TemporaryDirectory())
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous", rank=0, world_size=1)
    stack.callback(dist.destroy_process_group)
    return LMMesh(tuple(int(n) for n in shape.split(",")), ("data", "model"))


def _profile(torch, args, dev, gib, out, mesh) -> None:
    from repro_torch.launch.train import preset_config
    from repro_torch.models.registry import model_api
    from repro_torch.train import AdamWConfig, DataConfig, batch_at, build_serve_step, build_train_step

    modes = ["train", "decode"] if args.mode == "both" else [args.mode]
    depth = {} if args.layers is None else {"n_layers": args.layers}
    for mode in modes:
        trace = args.trace and args.trace.replace(".json", f".{mode}.json")
        if mode == "train":
            cfg = preset_config(args.arch, "full").with_(dtype=torch.float32, **depth)
            for on in [None] + ([mesh] if mesh is not None else []):
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
                bundle = build_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=10), batch=args.batch,
                                          seq=args.seq, device=dev, mesh=on)
                model = bundle.init(torch.Generator(device=dev).manual_seed(0))
                opt = bundle.init_opt(model)
                step_fn = bundle.step_fn
                extra = {k: v for k, v in bundle.input_specs.items() if k not in ("tokens", "labels")}
                data = batch_at(DataConfig(vocab=cfg.vocab, batch=args.batch, seq=args.seq), 0,
                                extra=extra, device=dev)
                step_fn(model, opt, data)  # warm-up
                if on is not None:
                    on.reset_counters()
                line, rows = profile_fn(torch, lambda: step_fn(model, opt, data), args.steps, args.top,
                                        trace and trace.replace(".json", ".mesh.json") if on else trace)
                line = {"mode": "train", "arch": cfg.name, "layers": cfg.n_layers, "dtype": "float32",
                        "batch": args.batch, "seq": args.seq, "steps": args.steps,
                        "extra": {k: list(v[0]) for k, v in extra.items()},
                        "tokens_per_s": args.batch * args.seq / line["wall_ms"] * 1e3, **line}
                if on is not None:  # two timed passes of args.steps steps each
                    line |= {"mesh": list(on.shape.values()), "world": on.size,
                             "nccl_calls_per_step": {k: v / (2 * args.steps) for k, v in on.calls.items()}}
                del model, opt
                line["max_memory_allocated_gib"] = torch.cuda.max_memory_allocated(dev) / gib
                out(json.dumps(line), flush=True)
                for r in rows:
                    out(json.dumps({"mode": "train", "mesh": line.get("mesh"), **r}), flush=True)
        else:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            cfg = preset_config(args.arch, "full").with_(**depth)
            api = model_api(cfg)
            model = api.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
            serve, info = build_serve_step(cfg, 1, args.slots, device=dev)
            if "prefill" in info:  # the encoder-decoder: cross K/V from one batch's frames
                specs = api.train_input_specs(cfg, 1, 1)
                frames = batch_at(DataConfig(vocab=cfg.vocab, batch=1, seq=1), 0,
                                  extra={"frames": specs["frames"]}, device=dev)["frames"]
                cache = info["prefill"](model, frames)
            else:
                cache = info["init_cache"]()
            token = torch.zeros((1,), dtype=torch.int32, device=dev)
            pos = torch.zeros((1,), dtype=torch.int32, device=dev)

            def decode():
                serve(model, cache, {"token": token, "pos": pos})
                pos.add_(1)

            decode(), decode()  # warm-up
            line, rows = profile_fn(torch, decode, args.tokens, args.top, trace)
            line = {"mode": "decode", "arch": cfg.name, "layers": cfg.n_layers,
                    "dtype": str(cfg.dtype).removeprefix("torch."),
                    "batch": 1, "cache_slots": args.slots, "tokens": args.tokens, **line}
            del model, cache
            line["max_memory_allocated_gib"] = torch.cuda.max_memory_allocated(dev) / gib
            out(json.dumps(line), flush=True)
            for r in rows:
                out(json.dumps({"mode": mode, **r}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
