"""Decoder-only transformer, the dense, MoE and VLM families, on one device
or sharded over an LM mesh.

Port of ``repro/models/transformer.py`` (phi3-medium-14b, stablelm-1.6b,
granite-20b/8b; phi3.5-moe-42b and olmoe-1b-7b, whose FFN is
:func:`~repro_torch.models.moe.moe_ffn`; paligemma-3b, whose SigLIP tower
is stubbed as precomputed patch embeddings concatenated before the tokens
under a prefix-LM mask).  The reference stacks each
per-layer weight as one ``(n_layers, …)`` array and scans over it; the
port keeps one :class:`DecoderLayer` module a layer in an
``nn.ModuleList`` and loops: a stacked parameter indexed per layer makes
autograd build a full-size zero gradient for every layer it is indexed
in.  :func:`params_to_reference` and :func:`params_from_reference`
convert between the port's module and the reference's nested dict of
stacked arrays (weights carried across in tests, and the checkpoint
layout).

The 2-D FSDP("data") × TP("model") layout: ``param_specs`` and
``cache_specs`` are the reference's rules; :func:`shard_params` and
:func:`init_params` on a mesh hold one process's block of every leaf (the
layer dim never sharded), and :func:`loss_fn` on a mesh runs the same
forward and loss on the blocks through a
:class:`~repro_torch.models.layers.Shard` (on one device a Shard without
a mesh, every method of which is an identity): the embedding and the
output head vocab-parallel over "model" (the pad ids masked to -inf
across the shards), the residual's sequence sharded over "model" under
``seq_parallel``, each layer's weights gathered over "data" just before
use.  :func:`decode_step` on a mesh runs the same layers on the cache's
blocks (:func:`cache_specs`): K/V over heads, or the sequence's slots over
"model" where "model" does not divide the K/V heads (each process attends
its own slots, combined by
:func:`~repro_torch.models.layers.decode_attention`), the batch over the
batch axes where it divides them, and the vocab-parallel head returning
this process's block of the logits.  :func:`self_attention`,
:func:`ffn` and :func:`decode_layer` are the pieces the other families
reuse: the ssm and hybrid families are :mod:`repro_torch.models.ssm`'s and
the encdec family :mod:`repro_torch.models.encdec`'s (this module's
family functions refuse them).
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models.common import (
    STACKED,
    ArchConfig,
    MeshAxes,
    P,
    block_of,
    cache_blocks,
    local_shapes,
    named_specs,
    not_ported,
)
from repro_torch.models.moe import check_experts, moe_ffn


def check_family(cfg: ArchConfig) -> None:
    """Refuse every family but ``dense``, ``moe`` and ``vlm`` before any
    device work."""
    if cfg.family not in ("dense", "moe", "vlm"):
        not_ported(f"the {cfg.family} family ({cfg.name})")


# ------------------------------------------------------------------ params
def layer_shapes(cfg: ArchConfig) -> dict[str, tuple]:
    check_family(cfg)
    d, f, h, kv, dh, n = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    shapes = {
        "ln1": (n, d),
        "wq": (n, d, h, dh),
        "wk": (n, d, kv, dh),
        "wv": (n, d, kv, dh),
        "wo": (n, h, dh, d),
        "ln2": (n, d),
    }
    if cfg.family == "moe":
        e = cfg.n_experts
        shapes |= {"router": (n, d, e), "we_g": (n, e, d, f), "we_u": (n, e, d, f), "we_d": (n, e, f, d)}
        gate = "we_g"
    else:
        shapes |= {"wg": (n, d, f), "wu": (n, d, f), "wd": (n, f, d)}
        gate = "wg"
    if cfg.mlp != "swiglu":
        shapes.pop(gate)
    return shapes


def param_shapes(cfg: ArchConfig) -> dict[str, Any]:
    shapes = {
        "emb": (cfg.vocab_padded, cfg.d_model),
        "final_ln": (cfg.d_model,),
        "layers": layer_shapes(cfg),
    }
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (cfg.d_model, cfg.vocab_padded)
    return shapes


def param_specs(cfg: ArchConfig, axes: MeshAxes) -> dict[str, Any]:
    """2-D FSDP x TP partition specs of the stacked leaves (divisibility-aware),
    the reference's rule."""
    check_family(cfg)
    d, f, h, kv, dh = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    vp = cfg.vocab_padded
    fs, tp = axes.fs, axes.tp
    specs = {
        "emb": P(tp(vp), fs(d)),
        "final_ln": P(None),
        "layers": {
            "ln1": P(None, None),
            "ln2": P(None, None),
            "wq": P(None, fs(d), tp(h), None),
            "wk": P(None, fs(d), tp(kv), None),
            "wv": P(None, fs(d), tp(kv), None),
            "wo": P(None, tp(h), None, fs(d)),
        },
    }
    if cfg.family == "moe":
        e = cfg.n_experts
        specs["layers"] |= {
            "router": P(None, fs(d), None),
            "we_g": P(None, tp(e), fs(d), None),
            "we_u": P(None, tp(e), fs(d), None),
            "we_d": P(None, tp(e), None, fs(d)),
        }
        gate = "we_g"
    else:
        specs["layers"] |= {
            "wg": P(None, fs(d), tp(f)),
            "wu": P(None, fs(d), tp(f)),
            "wd": P(None, tp(f), fs(d)),
        }
        gate = "wg"
    if cfg.mlp != "swiglu":
        specs["layers"].pop(gate)
    if not cfg.tie_embeddings:
        specs["lm_head"] = P(fs(d), tp(vp))
    return specs


def cache_specs(cfg: ArchConfig, axes: MeshAxes, batch: int, seq: int) -> dict:
    """KV sharded over "model" when divisible, else the *sequence* dim is
    sharded over "model"; the batch over the batch axes when it divides
    them (the reference's rule)."""
    check_family(cfg)
    kv_tp = axes.tp(cfg.n_kv_heads)
    seq_tp = None if kv_tp else axes.tp(seq)
    batch_ax = axes.batch if batch % math.prod(axes.size(a) for a in axes.batch) == 0 else None
    spec = P(None, batch_ax, seq_tp, kv_tp, None)
    return {"k": spec, "v": spec}


class _Weights(nn.Module):
    """Parameters by name, read as ``p["name"]`` like the reference's dicts."""

    def __init__(self, shapes: dict[str, tuple], device, dtype):
        super().__init__()
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(torch.empty(shape, device=device, dtype=dtype)))

    def __getitem__(self, name: str) -> torch.Tensor:
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters


class DecoderLayer(_Weights):
    """One layer's ``ln1, wq, wk, wv, wo, ln2`` and its FFN's ``wg, wu, wd``
    (MoE: ``router, we_g, we_u, we_d``) in the reference's per-layer
    shapes."""


class Transformer(_Weights):
    """``emb``, ``final_ln``, ``lm_head`` (unless tied) and ``layers``, an
    ``nn.ModuleList`` of :class:`DecoderLayer`, from the reference's
    stacked ``shapes`` (:func:`param_shapes`).  Values are uninitialised:
    :func:`init_params` or :func:`params_from_reference` fill them."""

    def __init__(self, shapes: dict[str, Any], device=None, dtype=None):
        super().__init__({k: v for k, v in shapes.items() if k != "layers"}, device, dtype)
        per_layer = {k: s[1:] for k, s in shapes["layers"].items()}
        n = next(iter(shapes["layers"].values()))[0]
        self.layers = nn.ModuleList(DecoderLayer(per_layer, device, dtype) for _ in range(n))


def _flat_shapes(tree, prefix=()):
    """(path, shape) in the reference's flatten order (dict keys sorted)."""
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _flat_shapes(tree[key], prefix + (key,))
        else:
            yield prefix + (key,), tree[key]


@torch.no_grad()
def _assign(model: _Weights, path: tuple, value: torch.Tensor, mesh=None, spec_of=None) -> None:
    """Copy a value in the reference's stacked layout into ``model``
    (``("layers", w)`` into every layer, likewise ``enc_layers`` and
    ``dec_layers``; other paths by name); on a ``mesh`` this process's
    block of each (``spec_of``: :func:`~repro_torch.models.common.named_specs`)."""
    if path[0] in STACKED:
        targets = [(f"{path[0]}.{i}.{path[1]}", layer[path[1]], value[i])
                   for i, layer in enumerate(model[path[0]])]
    else:
        node = model
        for key in path[:-1]:
            node = node[key]
        targets = [(".".join(path), node[path[-1]], value)]
    for name, w, v in targets:
        w.copy_(v if mesh is None else block_of(v, spec_of(name), mesh))


@torch.no_grad()
def init_params(cfg: ArchConfig, generator: torch.Generator, device=None, mesh=None,
                specs=None) -> Transformer:
    """The reference's rule on the stacked shapes: norms (and every other
    leaf of at most two dims whose last is ``d_model``, ``emb`` among them)
    are ones; other 2-D weights N(0, 0.02); the rest N(0, fan_in^-1/2) with
    fan_in = ``shape[-2]`` of the stacked shape.  Draws on ``generator``'s
    device, leaf by leaf in the reference's order and a stacked leaf layer
    by layer (the largest float32 temporary is one layer's leaf: an expert
    bank of phi3.5-moe is 1.7 GB); the values differ from
    ``jax.random``'s.  On an LM ``mesh`` with the stacked ``specs``
    (:func:`param_specs`) every process draws the same values and keeps its
    block of each (the model holds the blocks only; ``device`` defaults to
    the mesh's)."""
    shapes = param_shapes(cfg)
    if mesh is not None:
        device = mesh.device if device is None else device
        spec_of = named_specs(specs)
    device = torch.device(device) if device is not None else generator.device
    model = Transformer(shapes if mesh is None else local_shapes(shapes, specs, mesh),
                        device=device, dtype=cfg.dtype)
    for path, shape in _flat_shapes(shapes):
        fan_in = shape[-2] if len(shape) > 1 else shape[-1]
        if path[0] in STACKED:
            targets = [(f"{path[0]}.{i}.{path[1]}", layer[path[1]], shape[1:])
                       for i, layer in enumerate(model[path[0]])]
        else:
            targets = [(path[-1], model[path[-1]], shape)]
        for name, w, full in targets:
            if len(shape) <= 2 and shape[-1] == cfg.d_model:  # norms
                w.fill_(1.0)
                continue
            scale = 0.02 if len(shape) <= 2 else fan_in ** -0.5
            val = torch.randn(full, generator=generator, device=generator.device) * scale
            w.copy_(val if mesh is None else block_of(val, spec_of(name), mesh))
    return model


def abstract_params(cfg: ArchConfig, device=None, mesh=None, specs=None) -> Transformer:
    """:func:`init_params`'s model with no value drawn (the reference's
    ``abstract_params``): uninitialised tensors of the right shapes and
    dtype, under ``FakeTensorMode`` fake ones (the dry-run's state); on an
    LM ``mesh`` with the stacked ``specs`` this process's blocks."""
    return abstract_model(Transformer, param_shapes(cfg), cfg, device, mesh, specs)


def abstract_model(cls, shapes: dict, cfg: ArchConfig, device=None, mesh=None, specs=None):
    """A ``cls`` module of the stacked ``shapes`` (one process's blocks on
    ``mesh`` under ``specs``; ``device`` defaults to the mesh's), in
    ``cfg.dtype``, its values uninitialised."""
    if mesh is not None:
        device = mesh.device if device is None else device
        shapes = local_shapes(shapes, specs, mesh)
    return cls(shapes, device=device, dtype=cfg.dtype)


# ------------------------------------------------- one process's blocks
@torch.no_grad()
def shard_params(full, specs: dict, mesh, dtype=None, cls=None) -> Transformer:
    """One process's blocks of full parameters: ``full`` is a module of
    ``cls`` (default :class:`Transformer`; any device) or the reference's
    params tree (numpy or JAX arrays, stacked); the blocks land on the
    mesh's device in a new ``cls``."""
    cls = cls or Transformer
    if isinstance(full, nn.Module):
        named = {n: p.detach() for n, p in full.named_parameters()}
        shapes = stack_shapes(named)
        dtype = dtype or next(iter(named.values())).dtype
    else:
        named = unstack_named(full)
        shapes = {k: ({n: tuple(np.shape(a)) for n, a in v.items()} if isinstance(v, dict)
                      else tuple(np.shape(v))) for k, v in full.items()}
        dtype = dtype or torch.from_numpy(np.asarray(full["final_ln"])[:1].copy()).dtype
    spec_of = named_specs(specs)
    model = cls(local_shapes(shapes, specs, mesh), device=mesh.device, dtype=dtype)
    for name, p in model.named_parameters():
        blk = block_of(named[name], spec_of(name), mesh)
        p.copy_(blk if isinstance(blk, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(blk)))
    return model


def stack_shapes(named: dict) -> dict:
    """The stacked shapes tree of tensors by parameter name (other dotted
    names nested, as :func:`stack_named`)."""
    out: dict = {}
    for name, t in named.items():
        parts = name.split(".")
        if parts[0] in STACKED:
            grp = out.setdefault(parts[0], {})
            n = max(int(parts[1]) + 1, grp.get(parts[2], (0,))[0])
            grp[parts[2]] = (n,) + tuple(t.shape)
        else:
            node = out
            for key in parts[:-1]:
                node = node.setdefault(key, {})
            node[parts[-1]] = tuple(t.shape)
    return out


def shard_specs(stacked: dict) -> dict:
    """A :class:`~repro_torch.models.layers.Shard`'s ``specs`` from a
    family's stacked ``param_specs``: each per-layer weight's spec without
    the layer entry (the groups of :data:`STACKED` give a name one spec),
    the hybrid's ``shared`` block's, ``emb`` and ``lm_head``."""
    specs = {n: P(*sp[1:]) for g in STACKED if g in stacked for n, sp in stacked[g].items()}
    return specs | stacked.get("shared", {}) | {n: stacked[n] for n in ("emb", "lm_head") if n in stacked}


# -------------------------------------------- the reference's stacked layout
def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def stack_named(named: dict[str, torch.Tensor]) -> dict[str, Any]:
    """Tensors by parameter name (``"emb"``, ``"layers.3.wq"``,
    ``"dec_layers.0.xq"``, ``"shared.wq"``) → the reference's nested dict
    of numpy arrays: the entries of a :data:`STACKED` group stacked to
    ``(n_layers, …)``, any other dotted name nested (``{"shared": {"wq":
    …}}``); bfloat16 as float32 (numpy has no bfloat16)."""
    out, per_layer = {}, {}
    for name, t in named.items():
        parts = name.split(".")
        if parts[0] in STACKED:
            per_layer.setdefault(parts[0], {}).setdefault(parts[2], {})[int(parts[1])] = t
        else:
            node = out
            for key in parts[:-1]:
                node = node.setdefault(key, {})
            node[parts[-1]] = _to_numpy(t)
    for group, weights in per_layer.items():
        out[group] = {k: np.stack([_to_numpy(v[i]) for i in range(len(v))])
                      for k, v in weights.items()}
    return out


def unstack_named(tree: dict[str, Any], prefix: str = "") -> dict[str, np.ndarray]:
    """The inverse of :func:`stack_named`."""
    named = {}
    for key, v in tree.items():
        if key in STACKED and not prefix:
            for w, arr in v.items():
                for i in range(arr.shape[0]):
                    named[f"{key}.{i}.{w}"] = np.asarray(arr[i])
        elif isinstance(v, dict):
            named |= unstack_named(v, f"{prefix}{key}.")
        else:
            named[prefix + key] = np.asarray(v)
    return named


def params_to_reference(model: Transformer) -> dict[str, Any]:
    """The port's module → the reference's params tree (numpy)."""
    return stack_named(dict(model.named_parameters()))


def params_from_reference(tree, device="cpu", dtype=None) -> Transformer:
    """The reference's params tree (numpy or JAX arrays) → a
    :class:`Transformer` on ``device``, in ``dtype`` (default: the arrays')."""
    return model_from_reference(Transformer, tree, device, dtype)


def model_from_reference(cls, tree, device="cpu", dtype=None):
    """A ``cls`` module (built from the reference's stacked shapes) holding
    the values of the reference's params tree, on ``device``, in ``dtype``
    (default: the arrays')."""
    shapes = {k: ({n: tuple(np.shape(a)) for n, a in v.items()} if isinstance(v, dict)
                  else tuple(np.shape(v))) for k, v in tree.items()}
    dtype = dtype or torch.from_numpy(np.asarray(tree["final_ln"])[:1].copy()).dtype
    model = cls(shapes, device=device, dtype=dtype)
    named = unstack_named(tree)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.from_numpy(np.ascontiguousarray(named[name])))
    return model


# ----------------------------------------------------------------- forward
#: a layer's weights, in the order the FSDP gather packs those sharded over "data"
LAYER_WEIGHTS = ("ln1", "wq", "wk", "wv", "wo", "ln2", "wg", "wu", "wd", "router", "we_g", "we_u", "we_d")


def decoder_layer(cfg: ArchConfig, x, p, positions, mask, mask_kind: str | None = "causal", shard=None):
    """One layer: ``(x, aux)``, aux the MoE FFN's load-balance loss (0.0
    for a dense FFN).  On a mesh (``shard``, a
    :class:`~repro_torch.models.layers.Shard`) ``x`` is the residual's
    block (its sequence sharded over "model" under ``seq_parallel``) and
    ``p`` the layer's blocks, gathered over "data" here (inside the remat
    region, so one layer's weights at a time).  The hybrid's shared block
    and whisper's encoder layer are this layer too."""
    shard = shard or L.Shard(cfg)
    p = shard.gather_weights(p, [n for n in LAYER_WEIGHTS if n in p])
    return ffn(cfg, self_attention(cfg, x, p, positions, mask, mask_kind, shard), p, shard)


def self_attention(cfg: ArchConfig, x, p, positions, mask, mask_kind, shard):
    """``x`` plus the attention block over ``x`` (``ln1``, ``wq``, ``wk``,
    ``wv``, ``wo``; head-sharded on a mesh, combined over "model")."""
    h = shard.gather_seq(L.rms_norm(x, p["ln1"], cfg.norm_eps))
    q, k, v = L.qkv(cfg, h, p, positions)
    o = L.attention(cfg, q, k, v, mask, mask_kind=mask_kind, h0=shard.h0)
    return x + shard.combine(L.einsum("bshe,hed->bsd", o, p["wo"]), partial=shard.heads_sharded)


def ffn(cfg: ArchConfig, x, p, shard):
    """``(x + FFN(ln2(x)), aux)``: the MoE's expert FFN (expert-parallel on
    a mesh) or the MLP (column/row-parallel, combined over "model")."""
    h = shard.gather_seq(L.rms_norm(x, p["ln2"], cfg.norm_eps))
    if cfg.family == "moe":
        ff, aux = moe_ffn(cfg, h, p, shard)
    else:
        ff = shard.combine(L.mlp_block(cfg, h, p), partial=shard.axes.tp(cfg.d_ff) is not None,
                           scatter=cfg.dense_scatter_combine)
        aux = 0.0
    return x + ff, aux


def forward(cfg: ArchConfig, params: Transformer, tokens, positions=None, embeds=None):
    """:func:`forward_with_aux`'s hidden states alone."""
    return forward_with_aux(cfg, params, tokens, positions, embeds)[0]


def forward_with_aux(cfg: ArchConfig, params: Transformer, tokens, positions=None, embeds=None,
                     shard=None):
    """Token (and, for the VLM, image-prefix) forward to the final hidden
    states (B, S, D) and the layers' summed MoE aux loss (0.0 for the
    other families), the reference's ``forward``.  ``embeds`` (B, S_img,
    D) is concatenated before the tokens; for the ``vlm`` family the mask
    is then ``prefix:<S_img>`` (bidirectional over the prefix, causal
    after), else causal.  With ``cfg.remat`` each layer is recomputed in
    the backward pass.  As in the reference, ``attn_chunk`` drops the S × S
    mask; a sequence no longer than the chunk then runs the plain path
    unmasked.  On a mesh (``shard``) ``params`` are this process's blocks
    and ``tokens`` its rows; the embedding is vocab-parallel over "model"
    and the hidden states come back whole over the sequence."""
    check_family(cfg)
    shard = shard or L.Shard(cfg)
    x = _embed(cfg, shard, shard.gather_weights(params, ["emb"])["emb"], tokens).to(cfg.dtype)
    if embeds is not None:
        x = torch.cat([embeds.to(cfg.dtype), x], dim=1)
    s = x.shape[1]
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    if cfg.family == "vlm" and embeds is not None:
        mask_kind = f"prefix:{embeds.shape[1]}"
        mask = None if cfg.attn_chunk else L.prefix_lm_mask(s, embeds.shape[1], device=x.device)
    else:
        mask_kind = "causal"
        mask = None if cfg.attn_chunk else L.causal_mask(s, device=x.device)
    x = shard.residual(shard.seq_block(x))
    aux = 0.0
    for layer in params.layers:
        args = (cfg, x, layer, positions, mask, mask_kind, shard)
        if cfg.remat and torch.is_grad_enabled():
            x, a = checkpoint(decoder_layer, *args, use_reentrant=False)
        else:
            x, a = decoder_layer(*args)
        x = shard.residual(x)
        aux = aux + a
    return shard.gather_seq(L.rms_norm(x, params["final_ln"], cfg.norm_eps)), aux


def _embed(cfg: ArchConfig, shard: L.Shard, emb, tokens):
    """The rows of ``tokens``; from a vocab-parallel ``emb`` block (this
    process's rows, every column) summed over "model": (B, S, D),
    replicated over "model"."""
    if not shard.vocab_parallel:
        return emb[tokens]
    vl = emb.shape[0]
    loc = tokens.long() - shard.model_index * vl
    inside = (loc >= 0) & (loc < vl)
    x = emb[loc.clamp(0, vl - 1)] * inside[..., None].to(emb.dtype)
    return shard.mesh.psum(x, shard.axes.model)


def _head(cfg: ArchConfig, params, shard=None):
    """The output head (D, V); on a mesh (``shard``) this process's vocab
    block, gathered over "data"."""
    name = "emb" if cfg.tie_embeddings else "lm_head"
    w = params[name] if shard is None else shard.gather_weights(params, [name])[name]
    return w.T if cfg.tie_embeddings else w


def logits_from_hidden(cfg: ArchConfig, params: Transformer, x, shard=None):
    """The logits (B, S, V) over the padded vocab; on a mesh (``shard``)
    this process's vocab block where "model" divides it."""
    return torch.einsum("bsd,dv->bsv", x, _head(cfg, params, shard).to(x.dtype))


def cross_entropy(cfg: ArchConfig, logits, labels, mask=None, shard=None):
    """Stable CE over the padded vocab (pad ids masked to -inf).  On a mesh
    whose "model" axis divides the padded vocab, ``logits`` are this
    process's (B, S, V/|model|) block: the log-sum-exp and the picked logit
    are summed over "model" (the max taken over "model" first, without a
    gradient)."""
    vl = logits.shape[-1]
    vp = shard is not None and shard.vocab_parallel
    v0 = shard.model_index * vl if vp else 0
    valid = (v0 + torch.arange(vl, device=logits.device) < cfg.vocab)[None, None, :]
    logits = torch.where(valid, logits.float(), float("-inf"))
    if vp:
        mesh, model = shard.mesh, shard.axes.model
        mx = mesh.pmax(logits.amax(dim=-1), model)
        loc = labels.long() - v0
        inside = (loc >= 0) & (loc < vl)
        mine = torch.gather(logits, -1, loc.clamp(0, vl - 1)[..., None])[..., 0]
        # the sum of exponentials and the picked logit in one psum
        sums = mesh.psum(torch.stack([torch.exp(logits - mx[..., None]).sum(-1),
                                      torch.where(inside, mine, 0.0)]), model)
        nll = torch.log(sums[0]) + mx - sums[1]
    else:
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1, labels[..., None].long())[..., 0]
        nll = lse - picked
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1)
    return nll.mean()


def lm_loss(cfg: ArchConfig, params: Transformer, x, labels, shard=None):
    """Projection + CE, optionally over ``loss_chunk``-long sequence
    chunks; under autograd each chunk's logits are recomputed in the
    backward pass, so the fp32 (B, S, V) logits never exist at once.  On a
    mesh (``shard``) the head is vocab-parallel, gathered once."""
    shard = shard or L.Shard(cfg)
    head = _head(cfg, params, shard)

    def chunk_ce(xc, lc):
        return cross_entropy(cfg, torch.einsum("bsd,dv->bsv", xc, head.to(xc.dtype)), lc, shard=shard)

    if not cfg.loss_chunk or x.shape[1] % cfg.loss_chunk:
        return chunk_ce(x, labels)
    c = cfg.loss_chunk
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(x.shape[1] // c):
        xc, lc = x[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c]
        ce = (checkpoint(chunk_ce, xc, lc, use_reentrant=False) if torch.is_grad_enabled()
              else chunk_ce(xc, lc))
        tot = tot + ce * lc.numel()
    return tot / labels.numel()


def loss_fn(cfg: ArchConfig, mesh=None):
    """``f(params, batch) -> loss`` with batch ``{"tokens", "labels"}``
    (the VLM's also ``"patch_embeds"``: the loss is then over the text
    positions only); the MoE's adds 0.01 × its summed aux loss.  On an LM
    ``mesh`` ``params`` are this process's blocks (:func:`shard_params`)
    and ``batch`` its rows of the global batch; the loss is the global one
    (the batch shards' losses pmean'd over the batch axes), the same on
    every process."""
    check_family(cfg)
    specs = mesh_specs(cfg, mesh)

    def f(params, batch):
        embeds = batch.get("patch_embeds") if cfg.family == "vlm" else None
        s = batch["tokens"].shape[1] + (0 if embeds is None else embeds.shape[1])
        shard = L.Shard(cfg, mesh, specs, s)
        x, aux = forward_with_aux(cfg, params, batch["tokens"], embeds=embeds, shard=shard)
        if embeds is not None:
            x = x[:, embeds.shape[1]:]  # loss over text positions only
        loss = shard.batch_mean(lm_loss(cfg, params, x, batch["labels"], shard))
        return loss + 0.01 * aux if cfg.family == "moe" else loss

    return f


def mesh_specs(cfg: ArchConfig, mesh, spec_fn=None) -> dict:
    """The Shard specs on ``mesh`` ({} without one) from the family's
    ``param_specs`` (``spec_fn``, this module's by default); an expert
    count that "model" does not divide is refused."""
    if mesh is None:
        return {}
    axes = MeshAxes.from_mesh(mesh)
    if cfg.family == "moe":
        check_experts(cfg, axes.size(axes.model))
    return shard_specs((spec_fn or param_specs)(cfg, axes))


def train_input_specs(cfg: ArchConfig, batch: int, seq: int) -> dict[str, tuple]:
    """The train step's inputs, ``{name: (shape, dtype)}``: tokens and
    labels, and the VLM's patch embeddings in the config's dtype."""
    out = {"tokens": ((batch, seq), torch.int32), "labels": ((batch, seq), torch.int32)}
    if cfg.family == "vlm":
        out["patch_embeds"] = ((batch, cfg.n_patches, cfg.d_model), cfg.dtype)
    return out


# ------------------------------------------------------------------ decode
def cache_shapes(cfg: ArchConfig, batch: int, seq: int):
    kv, dh = cfg.n_kv_heads, cfg.head_dim
    return {
        "k": (cfg.n_layers, batch, seq, kv, dh),
        "v": (cfg.n_layers, batch, seq, kv, dh),
    }


def init_cache(cfg: ArchConfig, batch: int, seq: int, device=None, mesh=None):
    """Zeros of :func:`cache_shapes`; on a ``mesh`` this process's blocks
    (:func:`cache_specs`)."""
    shapes = cache_blocks(cache_shapes(cfg, batch, seq), cache_specs, cfg, batch, seq, mesh)
    return {k: torch.zeros(s, dtype=cfg.dtype, device=device) for k, s in shapes.items()}


def decode_shard(cfg: ArchConfig, mesh, specs: dict, cache_spec: P | None = None) -> L.Shard:
    """A decode step's :class:`~repro_torch.models.layers.Shard`: no
    sequence parallelism, and the axes that shard the K/V cache's slots
    (``cache_spec``'s dim 2)."""
    seq_axes = cache_spec.axes_of(2) if mesh is not None and cache_spec is not None else ()
    return L.Shard(cfg, mesh, specs, 1, seq_parallel=False, cache_seq=seq_axes)


def decode_self_attention(cfg: ArchConfig, x, p, kc, vc, slots: L.DecodeSlots, shard):
    """One new token's attention block: its K/V row written into ``kc``/
    ``vc`` (this process's cache blocks, in place) at ``slots``, its query
    attending the cache.  Where "model" shards the cache's slots, the query heads are
    gathered over "model" first (every process of the combine attends every
    head over its own slots) and the output cut back to this process's
    heads before ``wo``."""
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = L.qkv(cfg, h, p, slots.pos[:, None])
    L.write_cache_row(kc, k[:, 0], slots)
    L.write_cache_row(vc, v[:, 0], slots)
    gather = shard.heads_sharded and shard.axes.model in shard.cache_seq
    hl = q.shape[2]
    if gather:
        q = shard.mesh.all_gather(q, shard.axes.model, 2)
    o = L.decode_attention(cfg, q, kc, vc, slots, shard, h0=0 if gather else shard.h0)
    if gather:
        o = o.narrow(2, shard.h0, hl)
    return x + shard.combine(L.einsum("bshe,hed->bsd", o, p["wo"]), partial=shard.heads_sharded)


def decode_layer(cfg: ArchConfig, x, p, kc, vc, slots: L.DecodeSlots, shard):
    """One decoder layer on one new token (the hybrid's shared block too):
    the weights gathered over "data", :func:`decode_self_attention`, the
    FFN (the MoE's over the B new tokens together, its aux dropped)."""
    p = shard.gather_weights(p, [n for n in LAYER_WEIGHTS if n in p])
    return ffn(cfg, decode_self_attention(cfg, x, p, kc, vc, slots, shard), p, shard)[0]


def decode_step(cfg: ArchConfig, mesh=None, cache_specs=None):
    """One-token decode against a (B, S_cache) KV cache:
    ``f(params, cache, token, pos) -> (logits, cache)`` with ``token`` and
    ``pos`` (B,) integer tensors.  Each layer's new K/V row is written into
    ``cache`` in place (the reference blends a one-hot row, which equals
    the write for finite values); attention runs over the whole cache with
    the mask ``arange(S) <= pos``.  The MoE FFN routes the B new tokens
    together (capacity from T = B) and its aux loss is dropped.  On an LM
    ``mesh`` (with the cache's ``cache_specs``) ``params`` and ``cache``
    are this process's blocks, ``token``/``pos`` its rows, and the logits
    its block (module docstring)."""
    check_family(cfg)
    specs = mesh_specs(cfg, mesh)

    @torch.no_grad()
    def f(params, cache, token, pos):
        shard = decode_shard(cfg, mesh, specs, cache_specs and cache_specs["k"])
        slots = L.decode_slots(pos, cache["k"].shape[2], shard)
        x = _embed(cfg, shard, shard.gather_weights(params, ["emb"])["emb"], token[:, None]).to(cfg.dtype)
        for i, lp in enumerate(params.layers):
            x = decode_layer(cfg, x, lp, cache["k"][i], cache["v"][i], slots, shard)
        x = L.rms_norm(x, params["final_ln"], cfg.norm_eps)
        return logits_from_hidden(cfg, params, x, shard)[:, 0], cache

    return f
