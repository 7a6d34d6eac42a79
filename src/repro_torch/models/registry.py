"""Uniform model API dispatch: family -> module functions.

Port of ``repro/models/registry.py`` for the families that run on one
device: ``dense`` (:mod:`~repro_torch.models.transformer`), ``ssm`` and
``hybrid`` (:mod:`~repro_torch.models.ssm`).  The other families
(``moe``, ``vlm``, ``encdec``) are ROADMAP.md queue 1 item 13's
remainder: :func:`model_api` refuses them before any device work.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.models import ssm as _ssm
from repro_torch.models import transformer as _tf
from repro_torch.models.common import ArchConfig


@dataclasses.dataclass(frozen=True)
class ModelApi:
    init_params: Callable         # (cfg, generator, device) -> module
    loss_fn: Callable             # (cfg) -> f(params, batch) -> loss
    decode_step: Callable         # (cfg) -> f(params, cache, token, pos)
    cache_shapes: Callable        # (cfg, batch, seq)
    init_cache: Callable          # (cfg, batch, seq, device)


_TRANSFORMER = ModelApi(
    init_params=_tf.init_params,
    loss_fn=_tf.loss_fn,
    decode_step=_tf.decode_step,
    cache_shapes=_tf.cache_shapes,
    init_cache=_tf.init_cache,
)

_SSM = ModelApi(
    init_params=_ssm.init_params,
    loss_fn=_ssm.loss_fn,
    decode_step=_ssm.decode_step,
    cache_shapes=_ssm.cache_shapes,
    init_cache=_ssm.init_cache,
)


def model_api(cfg: ArchConfig) -> ModelApi:
    if cfg.family in ("ssm", "hybrid"):
        return _SSM
    _tf.check_dense(cfg)
    return _TRANSFORMER
