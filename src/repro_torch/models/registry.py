"""Uniform model API dispatch: family -> module functions.

Port of ``repro/models/registry.py``, every family:
``dense``, ``moe`` and ``vlm`` (:mod:`~repro_torch.models.transformer`),
``ssm`` and ``hybrid`` (:mod:`~repro_torch.models.ssm`), ``encdec``
(:mod:`~repro_torch.models.encdec`), each with the reference's
``param_specs`` and ``cache_specs``, each running on one device or on an
LM mesh.  :func:`serve_input_specs` is the reference's decode-step input
layout.  An unknown family is refused before any device work.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import math

import torch

from repro_torch.models import encdec as _ed
from repro_torch.models import ssm as _ssm
from repro_torch.models import transformer as _tf
from repro_torch.models.common import ArchConfig, MeshAxes, P, not_ported


@dataclasses.dataclass(frozen=True)
class ModelApi:
    init_params: Callable         # (cfg, generator, device[, mesh, specs]) -> module
    abstract_params: Callable     # (cfg, device[, mesh, specs]) -> module, no value drawn
    loss_fn: Callable             # (cfg, mesh=None) -> f(params, batch) -> loss
    decode_step: Callable         # (cfg[, mesh, cache_specs]) -> f(params, cache, token, pos)
    cache_shapes: Callable        # (cfg, batch, seq)
    init_cache: Callable          # (cfg, batch, seq, device[, mesh]) -> (blocks of) the cache
    train_input_specs: Callable   # (cfg, batch, seq) -> {name: (shape, dtype)}
    param_shapes: Callable        # (cfg) -> the stacked shapes tree
    param_specs: Callable         # (cfg, axes) -> nested dict of P
    cache_specs: Callable         # (cfg, axes, batch, seq)
    # (full params, stacked specs, mesh, dtype) -> one process's blocks
    shard_params: Callable
    # encdec: (cfg, params, frames, batch, seq[, mesh]) -> a cache with its cross K/V
    prefill_cross_cache: Callable | None = None


_TRANSFORMER = ModelApi(
    init_params=_tf.init_params,
    abstract_params=_tf.abstract_params,
    loss_fn=_tf.loss_fn,
    decode_step=_tf.decode_step,
    cache_shapes=_tf.cache_shapes,
    init_cache=_tf.init_cache,
    train_input_specs=_tf.train_input_specs,
    param_shapes=_tf.param_shapes,
    param_specs=_tf.param_specs,
    cache_specs=_tf.cache_specs,
    shard_params=_tf.shard_params,
)

_SSM = ModelApi(
    init_params=_ssm.init_params,
    abstract_params=_ssm.abstract_params,
    loss_fn=_ssm.loss_fn,
    decode_step=_ssm.decode_step,
    cache_shapes=_ssm.cache_shapes,
    init_cache=_ssm.init_cache,
    train_input_specs=_tf.train_input_specs,  # tokens and labels
    param_shapes=_ssm.param_shapes,
    param_specs=_ssm.param_specs,
    cache_specs=_ssm.cache_specs,
    shard_params=_ssm.shard_params,
)

_ENCDEC = ModelApi(
    init_params=_ed.init_params,
    abstract_params=_ed.abstract_params,
    loss_fn=_ed.loss_fn,
    decode_step=_ed.decode_step,
    cache_shapes=_ed.cache_shapes,
    init_cache=_ed.init_cache,
    train_input_specs=_ed.train_input_specs,
    param_shapes=_ed.param_shapes,
    param_specs=_ed.param_specs,
    cache_specs=_ed.cache_specs,
    shard_params=_ed.shard_params,
    prefill_cross_cache=_ed.prefill_cross_cache,
)

_BY_FAMILY = {
    "dense": _TRANSFORMER,
    "moe": _TRANSFORMER,
    "vlm": _TRANSFORMER,
    "ssm": _SSM,
    "hybrid": _SSM,
    "encdec": _ENCDEC,
}


def model_api(cfg: ArchConfig) -> ModelApi:
    if cfg.family not in _BY_FAMILY:
        not_ported(f"the {cfg.family} family ({cfg.name})")
    return _BY_FAMILY[cfg.family]


def serve_input_specs(cfg: ArchConfig, mesh, batch: int) -> dict[str, tuple]:
    """The decode step's inputs, ``{name: (shape, dtype, spec)}``: one
    token and one position a sequence, their rows sharded over the batch
    axes where the batch divides them, else replicated (the reference's)."""
    axes = MeshAxes.from_mesh(mesh)
    bsz = math.prod(axes.size(a) for a in axes.batch)
    bspec = P(axes.batch) if batch % bsz == 0 else P()
    return {"token": ((batch,), torch.int32, bspec), "pos": ((batch,), torch.int32, bspec)}
