"""Whisper-style encoder-decoder backbone, on one device or sharded over an
LM mesh.

Port of ``repro/models/encdec.py`` (whisper-medium).  As in the
reference, the conv/mel frontend is a stub: the batch carries precomputed
frame embeddings (B, enc_ctx, D).  The encoder adds learned positions and
attends bidirectionally (no rope); the decoder runs rotary positions (the
reference's departure from Whisper's learned decoder positions), causal
self-attention, then cross-attention over the encoder's output.

As in :mod:`repro_torch.models.transformer`, each layer's weights are one
module in an ``nn.ModuleList`` (``enc_layers``, ``dec_layers``), and
:func:`params_to_reference` and :func:`params_from_reference` convert to
and from the reference's nested dict of stacked arrays.  ``attn_chunk``
must divide every key length it chunks (the 1500 frames among them): the
reference asserts, the port raises ``ValueError``.

On an LM mesh (a :class:`~repro_torch.models.layers.Shard`; the specs
``param_specs`` and ``cache_specs`` are the reference's) the residuals of
both stacks stay whole over "model" (the reference's ``(batch, None,
None)``): the encoder layer is the transformer's decoder layer without
rope or mask, head-sharded and combined over "model"; the decoder layer
adds head-sharded cross-attention, whose ``xk``/``xv`` project the
replicated encoder output onto the local K/V heads; the tied loss is the
transformer's vocab-parallel :func:`~repro_torch.models.transformer.lm_loss`.
Decode holds the self and cross K/V over heads, and
:func:`prefill_cross_cache` encodes sharded and fills each process's
cross-cache block.
"""

from __future__ import annotations

import math
from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.common import P, ArchConfig, MeshAxes, cache_blocks, local_shapes, named_specs
from repro_torch.models.transformer import (
    _Weights,
    _assign,
    _flat_shapes,
    lm_loss,
    logits_from_hidden,
    model_from_reference,
    params_to_reference,
)


# ------------------------------------------------------------------ params
def _attn_shapes(cfg: ArchConfig, n: int, pre=("wq", "wk", "wv", "wo")) -> dict[str, tuple]:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v, o = pre
    return {q: (n, d, h, dh), k: (n, d, kv, dh), v: (n, d, kv, dh), o: (n, h, dh, d)}


def param_shapes(cfg: ArchConfig) -> dict[str, Any]:
    d, f = cfg.d_model, cfg.d_ff
    ne, nd = cfg.n_enc_layers, cfg.n_layers
    enc = {"ln1": (ne, d), "ln2": (ne, d), "wu": (ne, d, f), "wd": (ne, f, d)} | _attn_shapes(cfg, ne)
    dec = ({"ln1": (nd, d), "lnx": (nd, d), "ln2": (nd, d), "wu": (nd, d, f), "wd": (nd, f, d)}
           | _attn_shapes(cfg, nd, ("xq", "xk", "xv", "xo")) | _attn_shapes(cfg, nd))
    shapes = {
        "enc_pos": (cfg.enc_ctx, d),
        "enc_layers": enc,
        "enc_final_ln": (d,),
        "emb": (cfg.vocab_padded, d),
        "dec_layers": dec,
        "final_ln": (d,),
    }
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, cfg.vocab_padded)
    return shapes


class EncoderLayer(_Weights):
    """One encoder layer's ``ln1, wq, wk, wv, wo, ln2, wu, wd``."""


class DecoderLayer(_Weights):
    """One decoder layer's ``ln1, wq, wk, wv, wo`` (self-attention),
    ``lnx, xq, xk, xv, xo`` (cross-attention), ``ln2, wu, wd``."""


class EncDec(_Weights):
    """``enc_pos``, ``enc_final_ln``, ``emb``, ``final_ln``, ``lm_head``
    (unless tied: whisper ties it) and the ``enc_layers`` and
    ``dec_layers`` ``nn.ModuleList``s, from the reference's stacked
    ``shapes`` (:func:`param_shapes`).  Values are uninitialised:
    :func:`init_params` or :func:`params_from_reference` fill them."""

    def __init__(self, shapes: dict[str, Any], device=None, dtype=None):
        groups = {"enc_layers": EncoderLayer, "dec_layers": DecoderLayer}
        super().__init__({k: v for k, v in shapes.items() if k not in groups}, device, dtype)
        for key, cls in groups.items():
            per_layer = {k: s[1:] for k, s in shapes[key].items()}
            n = next(iter(shapes[key].values()))[0]
            setattr(self, key, nn.ModuleList(cls(per_layer, device, dtype) for _ in range(n)))


def _specs_attn(cfg: ArchConfig, axes: MeshAxes, pre=("wq", "wk", "wv", "wo")) -> dict[str, P]:
    d, h, kv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    fs, tp = axes.fs, axes.tp
    q, k, v, o = pre
    return {
        q: P(None, fs(d), tp(h), None),
        k: P(None, fs(d), tp(kv), None),
        v: P(None, fs(d), tp(kv), None),
        o: P(None, tp(h), None, fs(d)),
    }


def param_specs(cfg: ArchConfig, axes: MeshAxes) -> dict[str, Any]:
    """The reference's 2-D FSDP x TP partition specs of the stacked leaves."""
    d, f = cfg.d_model, cfg.d_ff
    fs, tp = axes.fs, axes.tp
    mlp = {"wu": P(None, fs(d), tp(f)), "wd": P(None, tp(f), fs(d))}
    enc = {"ln1": P(None, None), "ln2": P(None, None)} | mlp | _specs_attn(cfg, axes)
    dec = (
        {"ln1": P(None, None), "lnx": P(None, None), "ln2": P(None, None)}
        | mlp
        | _specs_attn(cfg, axes)
        | _specs_attn(cfg, axes, pre=("xq", "xk", "xv", "xo"))
    )
    specs = {
        "enc_pos": P(None, None),
        "enc_layers": enc,
        "enc_final_ln": P(None),
        "emb": P(tp(cfg.vocab_padded), fs(d)),
        "dec_layers": dec,
        "final_ln": P(None),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = P(fs(d), tp(cfg.vocab_padded))
    return specs


@torch.no_grad()
def init_params(cfg: ArchConfig, generator: torch.Generator, device=None, mesh=None,
                specs=None) -> EncDec:
    """The reference's rule on the stacked shapes: every leaf whose name
    holds ``ln`` is ones; every other leaf (``emb`` and ``enc_pos`` among
    them) N(0, fan_in^-1/2) with fan_in = ``shape[-2]`` of the stacked
    shape.  Draws on ``generator``'s device, leaf by leaf in the
    reference's order; the values differ from ``jax.random``'s.  On an LM
    ``mesh`` with the stacked ``specs`` every process draws the same values
    and keeps its block of each (``device`` defaults to the mesh's)."""
    shapes = param_shapes(cfg)
    spec_of = None
    if mesh is not None:
        device = mesh.device if device is None else device
        spec_of = named_specs(specs)
    device = torch.device(device) if device is not None else generator.device
    model = EncDec(shapes if mesh is None else local_shapes(shapes, specs, mesh), device=device,
                   dtype=cfg.dtype)
    for path, shape in _flat_shapes(shapes):
        if "ln" in path[-1]:
            value = torch.ones(shape, device=device, dtype=cfg.dtype)
        else:
            fan_in = shape[-2] if len(shape) > 1 else shape[-1]
            value = torch.randn(shape, generator=generator, device=generator.device)
            value = (value * fan_in ** -0.5).to(device, cfg.dtype)
        _assign(model, path, value, mesh, spec_of)
        del value
    return model


def abstract_params(cfg: ArchConfig, device=None, mesh=None, specs=None) -> EncDec:
    """:func:`init_params`'s model with no value drawn (:func:`~repro_torch.
    models.transformer.abstract_params`)."""
    return T.abstract_model(EncDec, param_shapes(cfg), cfg, device, mesh, specs)


def shard_params(full, specs: dict, mesh, dtype=None) -> EncDec:
    """One process's blocks of full parameters (an :class:`EncDec` or the
    reference's params tree), :func:`~repro_torch.models.transformer.shard_params`."""
    return T.shard_params(full, specs, mesh, dtype, cls=EncDec)


def params_from_reference(tree, device="cpu", dtype=None) -> EncDec:
    """The reference's params tree (numpy or JAX arrays) → an
    :class:`EncDec` on ``device``, in ``dtype`` (default: the arrays')."""
    return model_from_reference(EncDec, tree, device, dtype)


# ---------------------------------------------------------------- forwards
def _run(cfg: ArchConfig, fn, *args):
    """``fn(cfg, *args)``, recomputed in the backward pass under
    ``cfg.remat``."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, cfg, *args, use_reentrant=False)
    return fn(cfg, *args)


#: a decoder layer's weights, in the order the FSDP gather packs those sharded over "data"
DEC_WEIGHTS = ("ln1", "wq", "wk", "wv", "wo", "lnx", "xq", "xk", "xv", "xo", "ln2", "wu", "wd")


def encode(cfg: ArchConfig, params: EncDec, frames, shard=None):
    """frames: (B, enc_ctx, D) stub embeddings → the encoder's states.
    Each layer is the transformer's decoder layer without rope or mask (on
    a mesh head-sharded, its weights gathered over "data")."""
    x = frames.to(cfg.dtype) + params["enc_pos"][None].to(cfg.dtype)
    for layer in params.enc_layers:
        x = _run(cfg, _encoder_layer, x, layer, shard)
    return L.rms_norm(x, params["enc_final_ln"], cfg.norm_eps)


def _encoder_layer(cfg: ArchConfig, x, p, shard):
    return T.decoder_layer(cfg, x, p, None, None, None, shard)[0]  # bidirectional


def cross_attention(cfg: ArchConfig, x, p, xk, xv, shard):
    """``x`` plus the cross-attention block over ``xk``/``xv`` (the encoder
    output's K/V: this process's K/V heads on a mesh where they divide)."""
    h = L.rms_norm(x, p["lnx"], cfg.norm_eps)
    xq = L.einsum("bsd,dhe->bshe", h, p["xq"])
    o = L.attention(cfg, xq, xk, xv, None, h0=shard.h0)
    return x + shard.combine(L.einsum("bshe,hed->bsd", o, p["xo"]), partial=shard.heads_sharded)


def decoder_layer(cfg: ArchConfig, x, p, positions, mask, enc_out, shard=None):
    shard = shard or L.Shard(cfg)
    p = shard.gather_weights(p, DEC_WEIGHTS)
    x = T.self_attention(cfg, x, p, positions, mask, "causal", shard)
    xk = L.einsum("bsd,dhe->bshe", enc_out, p["xk"])
    xv = L.einsum("bsd,dhe->bshe", enc_out, p["xv"])
    x = cross_attention(cfg, x, p, xk, xv, shard)
    return T.ffn(cfg, x, p, shard)[0]


def decode_train(cfg: ArchConfig, params: EncDec, tokens, enc_out, shard=None):
    """Teacher-forced decoder over ``tokens`` (B, S) against ``enc_out``
    → the final hidden states (B, S, D); on a mesh the embedding is
    vocab-parallel over "model"."""
    shard = shard or L.Shard(cfg)
    x = T._embed(cfg, shard, shard.gather_weights(params, ["emb"])["emb"], tokens).to(cfg.dtype)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)[None, :]
    mask = None if cfg.attn_chunk else L.causal_mask(s, device=x.device)
    x = shard.residual(x)
    for layer in params.dec_layers:
        x = shard.residual(_run(cfg, decoder_layer, x, layer, positions, mask, enc_out, shard))
    return L.rms_norm(x, params["final_ln"], cfg.norm_eps)


def loss_fn(cfg: ArchConfig, mesh=None):
    """``f(params, batch) -> loss`` with batch ``{"frames", "tokens",
    "labels"}``.  On an LM ``mesh`` ``params`` are this process's blocks
    and ``batch`` its rows; the loss is the global one (pmean'd over the
    batch axes)."""
    specs = T.mesh_specs(cfg, mesh, param_specs)

    def f(params, batch):
        shard = L.Shard(cfg, mesh, specs, batch["tokens"].shape[1], seq_parallel=False)
        enc_out = encode(cfg, params, batch["frames"], shard)
        x = decode_train(cfg, params, batch["tokens"], enc_out, shard)
        return shard.batch_mean(lm_loss(cfg, params, x, batch["labels"], shard))

    return f


def train_input_specs(cfg: ArchConfig, batch: int, seq: int) -> dict[str, tuple]:
    """The train step's inputs, ``{name: (shape, dtype)}``, frames first
    (``batch_at`` draws them in this order)."""
    return {
        "frames": ((batch, cfg.enc_ctx, cfg.d_model), cfg.dtype),
        "tokens": ((batch, seq), torch.int32),
        "labels": ((batch, seq), torch.int32),
    }


# ------------------------------------------------------------------ decode
def cache_shapes(cfg: ArchConfig, batch: int, seq: int):
    kv, dh, nd = cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    return {
        "k": (nd, batch, seq, kv, dh),
        "v": (nd, batch, seq, kv, dh),
        "xk": (nd, batch, cfg.enc_ctx, kv, dh),
        "xv": (nd, batch, cfg.enc_ctx, kv, dh),
    }



def cache_specs(cfg: ArchConfig, axes: MeshAxes, batch: int, seq: int) -> dict:
    """Self and cross K/V sharded over "model" by heads where they divide,
    the batch over the batch axes where it divides them (the reference's)."""
    kv_tp = axes.tp(cfg.n_kv_heads)
    batch_ax = axes.batch if batch % math.prod(axes.size(a) for a in axes.batch) == 0 else None
    spec = P(None, batch_ax, None, kv_tp, None)
    return {"k": spec, "v": spec, "xk": spec, "xv": spec}

def init_cache(cfg: ArchConfig, batch: int, seq: int, device=None, mesh=None):
    """Zeros of :func:`cache_shapes`; on a ``mesh`` this process's blocks
    (:func:`cache_specs`)."""
    shapes = cache_blocks(cache_shapes(cfg, batch, seq), cache_specs, cfg, batch, seq, mesh)
    return {k: torch.zeros(s, dtype=cfg.dtype, device=device) for k, s in shapes.items()}


@torch.no_grad()
def prefill_cross_cache(cfg: ArchConfig, params: EncDec, frames, batch: int, seq: int, mesh=None):
    """Encode ``frames`` once and return a fresh (``batch``, ``seq``)
    cache whose cross-attention K/V (``xk``, ``xv``) hold each decoder
    layer's projections of the encoder's output.  On an LM ``mesh``
    ``params`` are this process's blocks, ``frames`` its rows: the encoder
    runs sharded and the cache is this process's blocks."""
    shard = T.decode_shard(cfg, mesh, T.mesh_specs(cfg, mesh, param_specs))
    enc_out = encode(cfg, params, frames, shard)
    cache = init_cache(cfg, batch, seq, frames.device, mesh)
    for i, lp in enumerate(params.dec_layers):
        w = shard.gather_weights(lp, ["xk", "xv"])
        cache["xk"][i].copy_(L.einsum("bsd,dhe->bshe", enc_out, w["xk"]))
        cache["xv"][i].copy_(L.einsum("bsd,dhe->bshe", enc_out, w["xv"]))
    return cache


def decode_step(cfg: ArchConfig, mesh=None, cache_specs=None):
    """One-token decoder step: ``f(params, cache, token, pos) -> (logits,
    cache)`` with ``token`` and ``pos`` (B,) integer tensors.  Each layer's
    new self-attention K/V row is written into ``cache`` in place (as the
    dense decode does); cross-attention reads ``xk``/``xv``
    (:func:`prefill_cross_cache`).  On an LM ``mesh`` (with the cache's
    ``cache_specs``) ``params`` and ``cache`` are this process's blocks,
    ``token``/``pos`` its rows and the logits its block."""
    specs = T.mesh_specs(cfg, mesh, param_specs)

    @torch.no_grad()
    def f(params, cache, token, pos):
        shard = T.decode_shard(cfg, mesh, specs, cache_specs and cache_specs["k"])
        slots = L.decode_slots(pos, cache["k"].shape[2], shard)
        x = T._embed(cfg, shard, shard.gather_weights(params, ["emb"])["emb"], token[:, None]).to(cfg.dtype)
        for i, lp in enumerate(params.dec_layers):
            lp = shard.gather_weights(lp, DEC_WEIGHTS)
            x = T.decode_self_attention(cfg, x, lp, cache["k"][i], cache["v"][i], slots, shard)
            x = cross_attention(cfg, x, lp, cache["xk"][i], cache["xv"][i], shard)
            x = T.ffn(cfg, x, lp, shard)[0]
        x = L.rms_norm(x, params["final_ln"], cfg.norm_eps)
        return logits_from_hidden(cfg, params, x, shard)[:, 0], cache

    return f
