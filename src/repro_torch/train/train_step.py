"""Train-step builder: loss + grad + AdamW, with microbatch accumulation,
and the decode step.

Port of ``repro/train/train_step.py`` on one device.  Autograd carries
the backward pass; the reference's jit shardings and donation have no
counterpart here (the sharded layout is ROADMAP.md queue 1 item 13's
remainder).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models.common import ArchConfig
from repro_torch.models.registry import model_api
from repro_torch.train.optimizer import AdamWConfig, apply_adamw, named_params


@dataclasses.dataclass(frozen=True)
class TrainStepBundle:
    step_fn: Callable            # (model, opt_state, batch) -> {loss, grad_norm, lr}; in place
    input_specs: dict            # the family's batch: {name: (shape, dtype)}


def build_train_step(
    cfg: ArchConfig,
    opt_cfg: AdamWConfig | None = None,
    batch: int = 8,
    seq: int = 128,
    microbatches: int = 1,
    device="cuda",
) -> TrainStepBundle:
    """``step_fn(model, opt, batch)`` computes the loss and its gradients
    (over ``microbatches`` equal slices of the batch: the loss summed as
    l / mb, the gradients averaged in float32, as the reference), applies
    AdamW to ``model`` and ``opt`` in place and returns ``{loss,
    grad_norm, lr}``.  ``batch`` and ``seq`` are the reference's arguments
    (its jitted step is built for that shape; here they shape
    ``input_specs``, the family's batch keys, from which the trainer draws
    the inputs beyond tokens and labels); this step takes any."""
    opt_cfg = opt_cfg or AdamWConfig()
    api = model_api(cfg)
    dev = resolve_device(device)
    loss = api.loss_fn(cfg)

    def step(model, opt_state, batch_data) -> dict[str, Any]:
        named = named_params(model)
        params = list(named.values())
        if microbatches > 1:
            m = batch_data["tokens"].shape[0] // microbatches
            l = torch.zeros((), dtype=torch.float32, device=dev)
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in params]
            for i in range(microbatches):
                mb = {k: v[i * m:(i + 1) * m] for k, v in batch_data.items()}
                li = loss(model, mb)
                gi = torch.autograd.grad(li, params)
                l = l + li.detach() / microbatches
                grads = [a + b / microbatches for a, b in zip(grads, gi)]
                del gi
        else:
            l = loss(model, batch_data)
            grads = torch.autograd.grad(l, params)
            l = l.detach()
        _, _, stats = apply_adamw(opt_cfg, named, dict(zip(named, grads)), opt_state)
        return {"loss": l, **stats}

    return TrainStepBundle(step_fn=step, input_specs=api.train_input_specs(cfg, batch, seq))


def build_serve_step(cfg: ArchConfig, batch: int, seq: int, device="cuda"):
    """The one-device decode step for a (``batch``, ``seq``) cache (K/V;
    for the SSM families the conv and SSM states, and the hybrid's K/V;
    for the encoder-decoder also the cross K/V):
    ``step_fn(params, cache, {"token", "pos"}) -> (logits, cache)`` (the
    cache written in place), and ``{"cache_shapes", "init_cache"}``; for
    the encoder-decoder also ``"prefill"``: ``(params, frames) -> cache``,
    a fresh cache whose cross K/V come from encoding ``frames``."""
    api = model_api(cfg)
    dev = resolve_device(device)
    f = api.decode_step(cfg)

    def step_fn(params, cache, batch_data):
        return f(params, cache, batch_data["token"], batch_data["pos"])

    info = {
        "cache_shapes": api.cache_shapes(cfg, batch, seq),
        "init_cache": lambda: api.init_cache(cfg, batch, seq, dev),
    }
    if api.prefill_cross_cache is not None:
        info["prefill"] = lambda params, frames: api.prefill_cross_cache(cfg, params, frames, batch, seq)
    return step_fn, info
