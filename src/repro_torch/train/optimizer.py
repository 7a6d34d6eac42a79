"""AdamW on one device.

Port of ``repro/train/optimizer.py``: the reference's math and order, not
``torch.optim.AdamW`` (whose decay and eps placement differ).  Parameters
are a model module (the transformer's or the SSM model's) or a dict of
tensors by name; the moments are float32 dicts by the same names (the
reference's stacked layout through
:func:`~repro_torch.models.transformer.stack_named`).  The ZeRO-1 state
layout (``zero1_specs``, ``opt_state_specs``) is ROADMAP.md queue 1 item
13's remainder.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from repro_torch.models.common import not_ported


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def lr_at(cfg: AdamWConfig, step) -> float:
    """Linear warm-up, then cosine decay to ``min_lr_ratio · lr``."""
    step = float(step)
    warm = min(step / max(cfg.warmup_steps, 1), 1.0)
    prog = min(max((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0), 1.0)
    cos = 0.5 * (1 + math.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def named_params(params) -> dict[str, torch.Tensor]:
    """A module's parameters by name, or a dict of tensors as it is."""
    return dict(params.named_parameters()) if isinstance(params, nn.Module) else params


def init_opt_state(params) -> dict:
    """mu and nu: float32 zeros by parameter name; step: an int32 scalar."""
    named = named_params(params)
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = next(iter(named.values())).device
    return {
        "mu": {n: zeros(p) for n, p in named.items()},
        "nu": {n: zeros(p) for n, p in named.items()},
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def zero1_specs(param_specs, axes, param_shapes):
    not_ported("the ZeRO-1 optimizer-state layout (zero1_specs)")


def opt_state_specs(param_specs, axes, abstract_params):
    not_ported("the ZeRO-1 optimizer-state layout (opt_state_specs)")


@torch.no_grad()
def apply_adamw(cfg: AdamWConfig, params, grads, state):
    """One AdamW step, in place: the global grad norm over all leaves in
    float32 and the clip scale ``min(1, clip / (gnorm + 1e-9))``; the bias
    corrections; ``mhat / (sqrt(nhat) + eps) + wd · p``; the update in
    float32, cast to the parameter's dtype.  ``grads`` is a dict by
    parameter name.  Returns ``(params, state, {"grad_norm", "lr"})``
    (``params`` and ``state`` updated in place)."""
    named = named_params(params)
    state["step"] += 1
    step = int(state["step"])
    gsq = sum(g.float().square().sum() for g in grads.values())
    gnorm = torch.sqrt(gsq)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = lr_at(cfg, step)
    b1c = 1 - cfg.b1 ** step
    b2c = 1 - cfg.b2 ** step
    for name, p in named.items():
        g = grads[name].float() * scale
        mu, nu = state["mu"][name], state["nu"][name]
        mu.copy_(cfg.b1 * mu + (1 - cfg.b1) * g)
        nu.copy_(cfg.b2 * nu + (1 - cfg.b2) * g.square())
        delta = (mu / b1c) / (torch.sqrt(nu / b2c) + cfg.eps) + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    return params, state, {"grad_norm": gnorm, "lr": lr}
