"""End-to-end training driver, on one device or sharded over a world.

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm_1_6b \
        --preset full --steps 200 [--device cuda] [--ckpt-dir DIR] [--resume]

Port of ``repro/launch/train.py``: the same flags, presets and printed
lines, plus ``--device`` (default ``cuda``; ``cpu`` runs the plain CPU
path and must be asked for) and ``--mesh``.  Presets: ``smoke`` uses the
per-arch reduced config; ``tiny``/``100m`` scale a dense config to the
requested size; ``full`` is the config at its own widths.  Every preset is
cast to float32, as the reference's driver does.  Every family trains (the
VLM's patch embeddings and the encoder-decoder's frames are drawn by
``batch_at`` beside the tokens, as the reference's trainer draws them;
``tiny`` and ``100m`` keep a MoE config's experts and top-k).

Without a ``torch.distributed`` world the step runs on one device.
Inside a world (one the caller initialised, or ``torch.distributed.run``'s:
``WORLD_SIZE`` set; NCCL on ``cuda:LOCAL_RANK``, gloo with ``--device
cpu``) it runs sharded on an LM mesh, as the reference runs ``full`` on
its production mesh: ``--preset full`` on ``make_production_mesh()`` (16 ×
16: a world of 256), any preset on ``--mesh D,M`` or ``--mesh P,D,M``
(("data", "model") or ("pod", "data", "model")); only rank 0 prints.
Every family trains sharded.  ``--ckpt-dir``, ``--ckpt-every`` and
``--resume`` work inside a world too: the checkpoint holds full values
(each leaf gathered by its spec, rank 0 writes), so it resumes onto any
mesh shape or onto one device; a SIGTERM makes every process save at the
next step boundary (:func:`~repro_torch.train.install_preemption_handler`).
The checkpoint directory must be one every process sees.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import io
import os
import signal
import time

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, get_smoke
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.train import (
    AdamWConfig,
    DataConfig,
    batch_at,
    build_train_step,
    install_preemption_handler,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)


def preset_config(arch: str, preset: str):
    if preset == "smoke":
        return get_smoke(arch)
    cfg = get_config(arch)
    if preset == "tiny":  # ~5M params, CI-speed
        return cfg.with_(n_layers=2, d_model=128, n_heads=4, n_kv_heads=max(1, min(4, cfg.n_kv_heads)),
                         d_ff=512, vocab=2048, remat=False)
    if preset == "100m":  # ~100M params
        return cfg.with_(n_layers=12, d_model=768, n_heads=12,
                         n_kv_heads=12 if cfg.n_kv_heads >= cfg.n_heads else 4,
                         d_ff=3072, vocab=32768, remat=False)
    if preset == "full":
        return cfg
    raise ValueError(preset)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm_1_6b")
    ap.add_argument("--preset", default="tiny", choices=["smoke", "tiny", "100m", "full"])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--mesh", default=None,
                    help="inside a world: D,M or P,D,M (default: the production mesh for "
                         "--preset full, else 1,1)")
    args = ap.parse_args(argv)
    in_world = dist.is_available() and (dist.is_initialized() or "WORLD_SIZE" in os.environ)
    if not in_world:
        if args.mesh:
            raise ValueError("--mesh needs a torch.distributed world")
        return _train(args)
    own_group = not dist.is_initialized()
    if own_group:
        cuda = args.device != "cpu"
        if cuda:  # NCCL: the card before the group
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl" if cuda else "gloo", timeout=datetime.timedelta(seconds=120))
    try:
        from repro_torch.launch.mesh import LMMesh, make_production_mesh, make_smoke_mesh

        device = None if args.device == "cuda" else args.device  # None: the process's card
        if args.mesh:
            shape = tuple(int(n) for n in args.mesh.split(","))
            names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
            mesh = LMMesh(shape, names, device=device)
        elif args.preset == "full":
            mesh = make_production_mesh(device=device)
        else:
            mesh = make_smoke_mesh(device=device)
        quiet = contextlib.redirect_stdout(io.StringIO()) if dist.get_rank() else contextlib.nullcontext()
        with quiet:
            _train(args, mesh)
    finally:
        if own_group:
            dist.destroy_process_group()


def _train(args, mesh=None):

    cfg = preset_config(args.arch, args.preset).with_(dtype=torch.float32)
    dev = resolve_device(args.device) if mesh is None else mesh.device
    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M preset={args.preset}")

    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(10, args.steps // 20), total_steps=args.steps)
    bundle = build_train_step(cfg, opt_cfg, batch=args.batch, seq=args.seq, device=dev, mesh=mesh)
    dcfg = DataConfig(vocab=cfg.vocab, batch=args.batch, seq=args.seq)
    extra = {k: v for k, v in bundle.input_specs.items() if k not in ("tokens", "labels")}

    # on a mesh every process draws the same values and keeps its blocks
    params = bundle.init(torch.Generator(device=dev).manual_seed(0))
    opt = bundle.init_opt(params)
    # on a mesh checkpoints gather and cut each leaf by the state's layout
    layout = {} if mesh is None else {"mesh": mesh, "specs": bundle.state_specs}
    start = 0
    if args.resume and args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        state, meta = restore_checkpoint(args.ckpt_dir, {"params": params, "opt": opt}, **layout)
        params, opt, start = state["params"], state["opt"], meta["step"]
        print(f"resumed from step {start}")

    cur = {"step": start}

    def save(step):
        save_checkpoint(args.ckpt_dir, step, {"params": params, "opt": opt}, **layout)

    before = signal.getsignal(signal.SIGTERM)
    poll = install_preemption_handler(lambda: save(cur["step"]), mesh) if args.ckpt_dir else None
    t0 = time.time()
    try:
        for step in range(start, args.steps):
            batch = batch_at(dcfg, step, extra=extra, device=dev)
            metrics = bundle.step_fn(params, opt, batch)
            cur["step"] = step + 1
            if (step + 1) % args.log_every == 0:
                print(
                    f"step {step+1:5d} loss {float(metrics['loss']):.4f} "
                    f"gnorm {float(metrics['grad_norm']):.3f} lr {float(metrics['lr']):.2e} "
                    f"({(time.time()-t0)/(step-start+1)*1e3:.0f} ms/step)",
                    flush=True,
                )
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                save(step + 1)
            if poll:
                poll()
        if args.ckpt_dir:
            save(args.steps)
    finally:
        signal.signal(signal.SIGTERM, before)
    print("done")


if __name__ == "__main__":
    main()
