"""Synthetic deterministic token pipeline.

Port of ``repro/train/data.py``: the same numpy generator, so tokens and
labels equal the reference's exactly; they come back as int32 tensors on
the asked device.  ``batch_at(seed, step)`` is a pure function, so
resume-after-restart is exact with no dispenser state to checkpoint.  The
token stream is a mixture of Zipf-distributed ids with short Markov
repeats.  ``extra`` inputs (whisper's frames, PaliGemma's patch
embeddings) are drawn after them from the same generator, as the
reference's are.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    batch: int
    seq: int
    seed: int = 0
    zipf_a: float = 1.2
    repeat_p: float = 0.3


def _zipf_probs(cfg: DataConfig) -> np.ndarray:
    ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
    p = ranks ** -cfg.zipf_a
    return p / p.sum()


def batch_at(cfg: DataConfig, step: int, extra: dict | None = None, device="cpu") -> dict:
    """Batch for a given step (pure function of (cfg, step)).  ``extra``
    is ``{name: (shape, dtype)}`` (a train step's ``input_specs`` beyond
    tokens and labels): each is drawn in the dict's order as
    ``standard_normal(shape) · 0.02`` in float64, then cast to ``dtype``."""
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))
    probs = _zipf_probs(cfg)
    toks = rng.choice(cfg.vocab, size=(cfg.batch, cfg.seq + 1), p=probs)
    # Markov repeats: with prob repeat_p, copy the previous token
    rep = rng.random((cfg.batch, cfg.seq + 1)) < cfg.repeat_p
    for j in range(1, cfg.seq + 1):
        toks[:, j] = np.where(rep[:, j], toks[:, j - 1], toks[:, j])
    toks = torch.from_numpy(toks.astype(np.int32))
    out = {"tokens": toks[:, :-1].contiguous().to(device),
           "labels": toks[:, 1:].contiguous().to(device)}
    for name, (shape, dtype) in (extra or {}).items():
        draw = rng.standard_normal([int(d) for d in shape]) * 0.02
        out[name] = torch.from_numpy(draw).to(device=device, dtype=dtype)
    return out
