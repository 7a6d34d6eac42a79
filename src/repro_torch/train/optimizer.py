"""AdamW, on one device or on the shards of an LM mesh, with ZeRO-1 state.

Port of ``repro/train/optimizer.py``: the reference's math and order, not
``torch.optim.AdamW`` (whose decay and eps placement differ).  Parameters
are a model module (the transformer's or the SSM model's) or a dict of
tensors by name; the moments are float32 dicts by the same names (the
reference's stacked layout through
:func:`~repro_torch.models.transformer.stack_named`).

ZeRO-1: the moments' specs are the parameter's plus "data" on its largest
free dim that "data" divides (:func:`zero1_specs`, the reference's rule).
On an LM mesh :func:`apply_adamw` runs the step on each process's blocks:
the global grad norm counts each block once (a leaf replicated over an
axis is not counted once per process), and a leaf whose moments are
spread over "data" further than the leaf is updates its own slice and
all-gathers the slice over "data", so its replicas stay bit-identical.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch import nn

from repro_torch.models.common import P, MeshAxes, tree_map_specs


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
    """mu and nu: float32 zeros by parameter name; step: an int32 scalar
    (:func:`step_counter`)."""
    named = named_params(params)
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = next(iter(named.values())).device
    return {
        "mu": {n: zeros(p) for n, p in named.items()},
        "nu": {n: zeros(p) for n, p in named.items()},
        "step": step_counter(device),
    }


def step_counter(device) -> torch.Tensor:
    """The optimizer's step count, an int32 zero on ``device``, with its
    host copy (:func:`advance_step`)."""
    step = torch.zeros((), dtype=torch.int32, device=device)
    step._host_count = (step._version, 0)
    return step


def advance_step(step: torch.Tensor) -> int:
    """Add one to the step count in place and return the new count, read
    from the host copy kept on the tensor beside its version counter: no
    device-to-host read (a sync a step on the card; data-dependent under
    ``FakeTensorMode``).  A count written since its copy was taken (a
    checkpoint restored in place) or made without one is read from the
    device once."""
    host = getattr(step, "_host_count", None)
    count = host[1] if host is not None and host[0] == step._version else int(step)
    step += 1
    step._host_count = (step._version, count + 1)
    return count + 1


def zero1_specs(param_specs, axes: MeshAxes, param_shapes) -> Any:
    """Moment specs: the parameter's spec plus "data" on the largest free
    dim that "data" divides (ZeRO-1), the reference's rule.
    ``param_shapes`` is a tree of shape tuples (or of objects with a
    ``shape``) of the specs' structure."""
    fsdp = axes.fsdp
    fsize = axes.size(fsdp)

    def widen(spec: P, shape) -> P:
        shape = tuple(getattr(shape, "shape", shape))
        if fsdp is None:
            return spec
        entries = list(spec) + [None] * (len(shape) - len(spec))
        if any(e == fsdp or (isinstance(e, tuple) and fsdp in e) for e in entries):
            return spec  # already data-sharded
        best, best_dim = -1, None
        for i, (e, dim) in enumerate(zip(entries, shape)):
            if e is None and dim % fsize == 0 and dim > best:
                best, best_dim = dim, i
        if best_dim is None:
            return spec
        entries[best_dim] = fsdp
        return P(*entries)

    return tree_map_specs(widen, param_specs, param_shapes)


def opt_state_specs(param_specs, axes: MeshAxes, param_shapes) -> dict:
    mom = zero1_specs(param_specs, axes, param_shapes)
    return {"mu": mom, "nu": mom, "step": P()}


@torch.no_grad()
def apply_adamw(cfg: AdamWConfig, params, grads, state, mesh=None, spec_of=None, mom_of=None):
    """One AdamW step, in place: the global grad norm over all leaves in
    float32 and the clip scale ``min(1, clip / (gnorm + 1e-9))``; the bias
    corrections; ``mhat / (sqrt(nhat) + eps) + wd · p``; the update in
    float32, cast to the parameter's dtype.  ``grads`` is a dict by
    parameter name.  Returns ``(params, state, {"grad_norm", "lr"})``
    (``params`` and ``state`` updated in place).

    On an LM ``mesh`` ``params`` and ``state`` hold this process's blocks,
    ``grads`` the blocks' full gradients (summed over every axis the leaf
    is replicated on), and ``spec_of``/``mom_of`` map a name to the
    parameter's and the moments' per-layer :class:`P`.  The grad norm
    divides each leaf's local squares by the number of processes holding
    the same block and psums the sum over the world, so every block counts
    once.  A leaf whose moment spec adds "data" on dim k updates its own
    slice of dim k, then one all-gather over "data" (every such leaf
    packed into it) restores the block."""
    named = named_params(params)
    step = advance_step(state["step"])
    gsq = 0.0
    for name, g in grads.items():
        sq = g.float().square().sum()
        if mesh is not None:  # the processes holding the same block
            have = spec_of(name).mesh_axes()
            sq = sq / math.prod(mesh.shape[a] for a in mesh.axis_names if a not in have)
        gsq = gsq + sq
    gnorm = torch.sqrt(gsq if mesh is None else mesh.psum(gsq, mesh.axis_names))
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = lr_at(cfg, step)
    b1c = 1 - cfg.b1 ** step
    b2c = 1 - cfg.b2 ** step
    fsdp = "data" if mesh is not None and "data" in mesh.axis_names else None
    gather, gather_dims = [], []
    for name, p in named.items():
        dim = zero1_dim(spec_of(name), mom_of(name), fsdp) if fsdp else None
        g, target = grads[name].float() * scale, p
        if dim is not None:  # this process's slice of the moments' data dim
            c = p.shape[dim] // mesh.shape[fsdp]
            j = mesh.axis_index(fsdp)
            g, target = g.narrow(dim, j * c, c), p.narrow(dim, j * c, c)
        mu, nu = state["mu"][name], state["nu"][name]
        mu.copy_(cfg.b1 * mu + (1 - cfg.b1) * g)
        nu.copy_(cfg.b2 * nu + (1 - cfg.b2) * g.square())
        delta = (mu / b1c) / (torch.sqrt(nu / b2c) + cfg.eps) + cfg.weight_decay * target.float()
        new = (target.float() - lr * delta).to(p.dtype)
        if dim is None:
            p.copy_(new)
        else:
            gather.append((p, new))
            gather_dims.append(dim)
    if gather:
        full = mesh.all_gather_many([n for _, n in gather], fsdp, gather_dims)
        for (p, _), f in zip(gather, full):
            p.copy_(f)
    return params, state, {"grad_norm": gnorm, "lr": lr}


def zero1_dim(param_spec: P, moment_spec: P, fsdp: str | None) -> int | None:
    """The dim on which ``moment_spec`` shards over ``fsdp`` and
    ``param_spec`` does not (None when they agree)."""
    if fsdp is None:
        return None
    for i in range(len(moment_spec)):
        if fsdp in moment_spec.axes_of(i) and fsdp not in param_spec.axes_of(i):
            return i
    return None
