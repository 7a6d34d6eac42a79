"""Train-step builder: loss + grad + AdamW, with microbatch accumulation,
and the decode step.

Port of ``repro/train/train_step.py``.  Autograd carries the backward
pass; the reference's donation has no counterpart.  Without a mesh the
step runs on one device.  On an LM mesh
(:class:`~repro_torch.launch.mesh.LMMesh`) every family trains in the
reference's 2-D FSDP("data") × TP("model") layout: every process holds its
block of each parameter and of each ZeRO-1 moment, by the reference's
specs, and the collectives that GSPMD derives from the reference's hints
are written out (:mod:`repro_torch.models.layers`,
:mod:`repro_torch.models.moe`, :mod:`repro_torch.models.ssm`).  Each
process differentiates its share of the global loss (the loss over the
world size: every collective's backward is its exact transpose, so the
shares sum to the loss's gradient), then sums each leaf's gradient over
the axes the leaf is replicated on, one packed collective per set of axes
(over ("pod", "data") by :func:`~repro_torch.collectives.
hierarchical_allreduce`, the paper's node-aware 2-step scheme).  Every
"model" process of a batch shard holds the same loss, and its share
``li / world`` still sums to the loss: the "model" copies of a replicated
leaf's gradient are summed like the "data" copies.

:func:`build_serve_step` on a mesh is the reference's sharded decode step:
the cache's blocks by the family's ``cache_specs``, the token and position
rows by :func:`~repro_torch.models.registry.serve_input_specs`, this
process's block of the logits.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.collectives import hierarchical_allreduce
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models.common import (
    ArchConfig,
    MeshAxes,
    P,
    gather_named,
    local_shape,
    named_shapes,
    named_specs,
)
from repro_torch.models.registry import model_api, serve_input_specs
from repro_torch.train.optimizer import (
    AdamWConfig,
    apply_adamw,
    init_opt_state,
    named_params,
    opt_state_specs,
    step_counter,
)


@dataclasses.dataclass(frozen=True)
class TrainStepBundle:
    step_fn: Callable            # (model, opt_state, batch) -> {loss, grad_norm, lr}; in place
    input_specs: dict            # the family's batch: {name: (shape, dtype)}
    init: Callable               # generator -> the model drawn by the family's rule (blocks on a mesh)
    init_opt: Callable           # model -> optimizer state (the ZeRO-1 moments' blocks on a mesh)
    # on an LM mesh (None without): the mesh, the reference's stacked
    # param and optimizer-state specs, and the blocks' helpers
    mesh: Any = None
    param_specs: Any = None
    opt_specs: Any = None
    shard: Callable | None = None      # full params (module or reference tree) -> blocks
    unshard: Callable | None = None    # blocks -> {name: full tensor}
    # {"params": name -> P, "opt": {"mu": …, "nu": …, "step": P()}}: the
    # layout of the trainer's state, which checkpoints gather and cut by
    state_specs: dict | None = None


def build_train_step(
    cfg: ArchConfig,
    opt_cfg: AdamWConfig | None = None,
    batch: int = 8,
    seq: int = 128,
    microbatches: int = 1,
    device="cuda",
    mesh=None,
) -> TrainStepBundle:
    """``step_fn(model, opt, batch)`` computes the loss and its gradients
    (over ``microbatches`` equal slices of the batch: the loss summed as
    l / mb, the gradients averaged in float32, as the reference), applies
    AdamW to ``model`` and ``opt`` in place and returns ``{loss,
    grad_norm, lr}``.  ``batch`` and ``seq`` are the reference's arguments
    (its jitted step is built for that shape; here they shape
    ``input_specs``, the family's batch keys, from which the trainer draws
    the inputs beyond tokens and labels); this step takes any.

    With ``mesh`` (an LM mesh; ``device`` is then the mesh's) the step runs
    sharded (module docstring): ``model`` and ``opt`` are this process's
    blocks (the bundle's ``shard``/``init`` and ``init_opt`` make them),
    ``batch`` is the global batch, the same on every process, of which
    each takes its rows of every microbatch as the reference's sharded
    batch lays them out, and the metrics are the global ones."""
    opt_cfg = opt_cfg or AdamWConfig()
    api = model_api(cfg)
    loss = api.loss_fn(cfg, mesh)  # refuses an expert count that "model" does not divide
    bundle = {"input_specs": api.train_input_specs(cfg, batch, seq)}
    if mesh is None:
        dev, world, n_batch, j = resolve_device(device), 1, 1, 0
        spec_of = mom_of = None
        bundle |= {"init": lambda generator: api.init_params(cfg, generator, dev),
                   "init_opt": init_opt_state}
    else:
        dev, world = mesh.device, mesh.size
        axes = MeshAxes.from_mesh(mesh)
        n_batch = math.prod(axes.size(a) for a in axes.batch)
        j = mesh.axis_index(axes.batch)
        if batch % (n_batch * microbatches):
            raise ValueError(f"batch {batch} does not divide over {microbatches} microbatches of the "
                             f"batch axes {axes.batch} ({n_batch})")
        shapes = api.param_shapes(cfg)
        pspecs = api.param_specs(cfg, axes)
        ospecs = opt_state_specs(pspecs, axes, shapes)
        spec_of, mom_of = named_specs(pspecs), named_specs(ospecs["mu"], moments=True)
        full_shape = named_shapes(shapes)

        def init_opt(model) -> dict:
            zeros = {n: torch.zeros(local_shape(full_shape(n), mom_of(n), dict(mesh.shape)),
                                    dtype=torch.float32, device=dev)
                     for n, _ in model.named_parameters()}
            return {"mu": zeros, "nu": {n: torch.zeros_like(z) for n, z in zeros.items()},
                    "step": step_counter(dev)}

        bundle |= {
            "init": lambda generator: api.init_params(cfg, generator, mesh=mesh, specs=pspecs),
            "init_opt": init_opt,
            "mesh": mesh, "param_specs": pspecs, "opt_specs": ospecs,
            "shard": lambda full: api.shard_params(full, pspecs, mesh, dtype=cfg.dtype),
            "unshard": lambda model: gather_named(dict(model.named_parameters()), spec_of, mesh),
            "state_specs": {"params": spec_of, "opt": {"mu": mom_of, "nu": mom_of, "step": P()}},
        }

    def step(model, opt_state, batch_data) -> dict[str, Any]:
        named = named_params(model)
        params = list(named.values())
        if batch_data["tokens"].shape[0] % (n_batch * microbatches):
            raise ValueError(f"batch {batch_data['tokens'].shape[0]} does not divide over "
                             f"{microbatches} microbatches of {n_batch} batch shards")
        m = batch_data["tokens"].shape[0] // microbatches
        rows = m // n_batch  # this process's rows of a microbatch
        l = torch.zeros((), dtype=torch.float32, device=dev)
        grads = None
        for i in range(microbatches):
            lo = i * m + j * rows
            li = loss(model, {k: v[lo:lo + rows] for k, v in batch_data.items()})
            # on a mesh this process's share: the shares of all processes sum to the loss
            gi = torch.autograd.grad(li / world, params)
            l = l + li.detach() / microbatches
            if microbatches > 1:  # the reference's a + g / mb, from float32 zeros
                gi = [g / microbatches for g in gi]
                grads = [g.float() for g in gi] if grads is None else [a + g for a, g in zip(grads, gi)]
            else:
                grads = gi
            del gi
        grads = dict(zip(named, grads))
        if mesh is not None:
            grads = _reduce_replicated(mesh, grads, spec_of)
        _, _, stats = apply_adamw(opt_cfg, named, grads, opt_state, mesh, spec_of, mom_of)
        return {"loss": l, **stats}

    return TrainStepBundle(step_fn=step, **bundle)


def build_serve_step(cfg: ArchConfig, batch: int, seq: int, device="cuda", mesh=None):
    """The decode step for a (``batch``, ``seq``) cache (K/V; for the SSM
    families the conv and SSM states, and the hybrid's K/V; for the
    encoder-decoder also the cross K/V):
    ``step_fn(params, cache, {"token", "pos"}) -> (logits, cache)`` (the
    cache written in place), and ``info`` with ``"cache_shapes"`` and
    ``"init_cache"``; for the encoder-decoder also ``"prefill"``:
    ``(params, frames) -> cache``, a fresh cache whose cross K/V come from
    encoding ``frames``.

    With ``mesh`` (an LM mesh; ``device`` is then the mesh's) the step is
    the reference's sharded decode step: ``params`` and ``cache`` are this
    process's blocks, ``token``/``pos`` (and ``prefill``'s ``frames``) the
    global batch, of which it keeps its rows, and the logits its block
    under ``info["logit_spec"]`` (``P(batch axes or None,
    tp(vocab_padded))``).  ``info`` adds ``"cache_specs"``, ``"shard"``
    (full params → blocks, the train bundle's), ``"init_cache"`` (zeros of
    the blocks), ``"unshard_cache"`` and ``"gather_logits"`` (full values
    on every process)."""
    api = model_api(cfg)
    dev, rows, cspecs = resolve_device(device) if mesh is None else mesh.device, slice(None), None
    if mesh is not None:
        axes = MeshAxes.from_mesh(mesh)
        cspecs = api.cache_specs(cfg, axes, batch, seq)
        pspecs = api.param_specs(cfg, axes)
        bspec = serve_input_specs(cfg, mesh, batch)["token"][2]
        if bspec.axes_of(0):  # this process's rows of the batch
            n = batch // mesh.axis_size(bspec.axes_of(0))
            j = mesh.axis_index(bspec.axes_of(0))
            rows = slice(j * n, (j + 1) * n)
    f = api.decode_step(cfg, mesh, cspecs)

    def step_fn(params, cache, batch_data):
        return f(params, cache, batch_data["token"][rows], batch_data["pos"][rows])

    info = {
        "cache_shapes": api.cache_shapes(cfg, batch, seq),
        "init_cache": lambda: api.init_cache(cfg, batch, seq, dev, mesh),
    }
    if api.prefill_cross_cache is not None:
        info["prefill"] = lambda params, frames: api.prefill_cross_cache(
            cfg, params, frames[rows], batch, seq, mesh)
    if mesh is not None:
        logit_spec = P(bspec.axes_of(0) or None, axes.tp(cfg.vocab_padded))

        def gather(tree: dict, spec_of) -> dict:  # leaf by leaf, each in its own dtype
            return {n: gather_named({n: t}, spec_of, mesh)[n] for n, t in tree.items()}

        info |= {
            "cache_specs": cspecs,
            "logit_spec": logit_spec,
            "shard": lambda full: api.shard_params(full, pspecs, mesh, dtype=cfg.dtype),
            "unshard_cache": lambda cache: gather(cache, cspecs.__getitem__),
            "gather_logits": lambda logits: gather({"logits": logits}, lambda _: logit_spec)["logits"],
        }
    return step_fn, info


def _reduce_replicated(mesh, grads: dict, spec_of) -> dict:
    """Each leaf's gradient summed over the mesh axes its spec leaves it
    replicated on: the leaves of one set of axes packed into one
    collective, over ("pod", "data") by the 2-step
    :func:`hierarchical_allreduce` (the other axes of the set first)."""
    groups: dict[tuple, list[str]] = {}
    for name in grads:
        have = spec_of(name).mesh_axes()
        rep = tuple(a for a in mesh.axis_names if a not in have)
        if rep:
            groups.setdefault(rep, []).append(name)
    out = dict(grads)
    for rep, names in groups.items():
        flat = torch.cat([grads[n].reshape(-1) for n in names])
        if "pod" in rep and "data" in rep:
            rest = tuple(a for a in rep if a not in ("pod", "data"))
            if rest:
                flat = mesh.psum(flat, rest)
            pad = -flat.numel() % mesh.shape["data"]  # the 2-step path needs |data| | n
            flat = hierarchical_allreduce(torch.nn.functional.pad(flat, (0, pad)), mesh)
            flat = flat[:flat.numel() - pad]
        else:
            flat = mesh.psum(flat, rep)
        off = 0
        for n in names:
            k = grads[n].numel()
            out[n] = flat[off:off + k].view(grads[n].shape)
            off += k
    return out
