"""Mamba2 (SSD, state-space duality) and the Zamba2 hybrid, on one device
or sharded over an LM mesh.

Port of ``repro/models/ssm.py``.  Training runs the chunked matmul form of
SSD (the intra-chunk quadratic term and the inter-chunk state recurrence,
a loop over chunks where the reference runs ``lax.scan``); decode is the
O(1) per-token state update.  Zamba2 is a Mamba2 backbone with ONE shared
attention + MLP block applied before every ``attn_period`` layers (its
parameters shared across the applications; the reference omits the
per-application LoRA deltas, and so does the port).

As in :mod:`repro_torch.models.transformer`, each layer's weights are one
module (:class:`SSMLayer`) in an ``nn.ModuleList``, and the hybrid's shared
block is one more (:class:`SharedBlock`, named ``shared``);
:func:`params_to_reference` and :func:`params_from_reference` convert to
and from the reference's nested dict of stacked arrays.  ``jnp.einsum``
and ``jnp.concatenate`` promote mixed dtypes where ``torch`` refuses them
or would not: the port casts at those points, so zamba2's bfloat16 decode
(whose K/V cache is float32 by the reference's cache rule) returns float32
logits and a float32 ``conv`` state, as the reference's does.

On an LM mesh (a :class:`~repro_torch.models.layers.Shard`; the specs
``param_specs``, ``ssm_layer_specs`` and ``cache_specs`` are the
reference's) the residual stays whole over "model" (the reference's
``(batch, None, None)``: no sequence parallelism) and each process runs
the SSD heads ``h0 … h0 + h/|model|`` where "model" divides the heads,
every head otherwise.  ``in_proj``'s spec splits its packed ``[z | x | B |
C | dt]`` columns into |model| contiguous blocks that do not follow the
heads, so each process multiplies its own column block and all-gathers
the (B, S, K) product over "model" (:func:`_in_proj`), then keeps its
heads' ``z``, ``x`` and ``dt`` and the whole of ``B`` and ``C``.  Gathering
the product, not the weight, keeps the stored block's matmul local, and
costs B·S·K values where the weight is d·K: of a size in training, and a
decode token's 6448 values against mamba2's 9.9M.  It also hands every
process the full conv input, which the decode cache's ``conv`` state
(replicated over "model") needs.  ``out_ln``'s gated RMSNorm takes its
variance over all of ``d_inner`` (a ``psum`` of the local sums of squares
over "model"), and ``out_proj`` is row-parallel over ``tp(d_inner)``: its
rows line up with the local heads, or cut the replicated activation where
the heads are not sharded, and the product is combined over "model".  The
hybrid's shared block is the transformer's decoder layer
(:func:`~repro_torch.models.transformer.decoder_layer`), its weights
gathered at each of its applications.  Decode shards the SSM state over
the heads and keeps ``conv`` whole over "model"; the hybrid's K/V is over
the heads, or its slots over "data" where the batch does not divide the
batch axes (the long-context case), combined by
:func:`~repro_torch.models.layers.decode_attention`.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F
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

#: leaves the reference's initialiser sets to ones
_ONES = ("ln", "out_ln", "final_ln", "ln1", "ln2", "conv_b", "D_skip")


# ------------------------------------------------------------------ params
def ssm_layer_shapes(cfg: ArchConfig, n: int) -> dict[str, tuple]:
    d, di, nst, h = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.n_ssm_heads
    conv_dim = di + 2 * nst
    return {
        "ln": (n, d),
        "in_proj": (n, d, 2 * di + 2 * nst + h),
        "conv_w": (n, cfg.conv_width, conv_dim),
        "conv_b": (n, conv_dim),
        "A_log": (n, h),
        "D_skip": (n, h),
        "dt_bias": (n, h),
        "out_ln": (n, di),
        "out_proj": (n, di, d),
    }


def param_shapes(cfg: ArchConfig) -> dict[str, Any]:
    shapes = {
        "emb": (cfg.vocab_padded, cfg.d_model),
        "final_ln": (cfg.d_model,),
        "layers": ssm_layer_shapes(cfg, cfg.n_layers),
    }
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (cfg.d_model, cfg.vocab_padded)
    if cfg.family == "hybrid":
        d, f, h, kv, dh = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        shapes["shared"] = {
            "ln1": (d,), "ln2": (d,),
            "wq": (d, h, dh), "wk": (d, kv, dh), "wv": (d, kv, dh), "wo": (h, dh, d),
            "wg": (d, f), "wu": (d, f), "wd": (f, d),
        }
    return shapes


def ssm_layer_specs(cfg: ArchConfig, axes: MeshAxes, n_dim: bool = True) -> dict[str, P]:
    """One Mamba2 layer's partition specs (with the stacked layer dim
    unless ``n_dim`` is false), the reference's rule."""
    d, di, nst, h = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.n_ssm_heads
    fs = axes.fs
    lead = (None,) if n_dim else ()
    return {
        "ln": P(*lead, None),
        "in_proj": P(*lead, fs(d), axes.tp(2 * di + 2 * nst + h)),
        "conv_w": P(*lead, None, None),
        "conv_b": P(*lead, None),
        "A_log": P(*lead, axes.tp(h)),
        "D_skip": P(*lead, axes.tp(h)),
        "dt_bias": P(*lead, axes.tp(h)),
        "out_ln": P(*lead, None),
        "out_proj": P(*lead, axes.tp(di), fs(d)),
    }


def param_specs(cfg: ArchConfig, axes: MeshAxes) -> dict[str, Any]:
    """The reference's partition specs (the hybrid's shared block
    included)."""
    specs = {
        "emb": P(axes.tp(cfg.vocab_padded), axes.fs(cfg.d_model)),
        "final_ln": P(None),
        "layers": ssm_layer_specs(cfg, axes),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = P(axes.fs(cfg.d_model), axes.tp(cfg.vocab_padded))
    if cfg.family == "hybrid":
        d, f, h, kv = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads
        fs, tp = axes.fs, axes.tp
        specs["shared"] = {
            "ln1": P(None), "ln2": P(None),
            "wq": P(fs(d), tp(h), None), "wk": P(fs(d), tp(kv), None),
            "wv": P(fs(d), tp(kv), None), "wo": P(tp(h), None, fs(d)),
            "wg": P(fs(d), tp(f)), "wu": P(fs(d), tp(f)), "wd": P(tp(f), fs(d)),
        }
    return specs


def cache_specs(cfg: ArchConfig, axes: MeshAxes, batch: int, seq: int) -> dict:
    """The conv, SSM and (hybrid) K/V cache specs, the reference's rule: a
    long-context hybrid cache shards its sequence over "data" when the
    batch cannot occupy it."""
    h = cfg.n_ssm_heads
    bsz = math.prod(axes.size(a) for a in axes.batch)
    batch_ax = axes.batch if batch % bsz == 0 else None
    specs = {
        "conv": P(None, batch_ax, None, None),
        "ssm": P(None, batch_ax, axes.tp(h), None, None),
    }
    if cfg.family == "hybrid" and cfg.attn_period:
        kv_tp = axes.tp(cfg.n_kv_heads)
        seq_data = None
        if batch_ax is None and axes.fsdp and seq % axes.sizes[axes.fsdp] == 0:
            seq_data = axes.fsdp
        specs |= {
            "k": P(None, batch_ax, seq_data, kv_tp, None),
            "v": P(None, batch_ax, seq_data, kv_tp, None),
        }
    return specs


class SSMLayer(_Weights):
    """One Mamba2 layer's ``ln, in_proj, conv_w, conv_b, A_log, D_skip,
    dt_bias, out_ln, out_proj`` in the reference's per-layer shapes."""


class SharedBlock(_Weights):
    """The hybrid's one attention + MLP block (``ln1, wq, wk, wv, wo, ln2,
    wg, wu, wd``), applied before every ``attn_period`` layers."""


class SSMModel(_Weights):
    """``emb``, ``final_ln``, ``lm_head`` (unless tied), ``layers`` (an
    ``nn.ModuleList`` of :class:`SSMLayer`) and, for the hybrid,
    ``shared`` (a :class:`SharedBlock`), from the reference's stacked
    ``shapes`` (:func:`param_shapes`).  Values are uninitialised:
    :func:`init_params` or :func:`params_from_reference` fill them."""

    def __init__(self, shapes: dict[str, Any], device=None, dtype=None):
        super().__init__({k: v for k, v in shapes.items() if k not in ("layers", "shared")},
                         device, dtype)
        per_layer = {k: s[1:] for k, s in shapes["layers"].items()}
        n = next(iter(shapes["layers"].values()))[0]
        self.layers = nn.ModuleList(SSMLayer(per_layer, device, dtype) for _ in range(n))
        self.shared = SharedBlock(shapes["shared"], device, dtype) if "shared" in shapes else None


@torch.no_grad()
def init_params(cfg: ArchConfig, generator: torch.Generator, device=None, mesh=None,
                specs=None) -> SSMModel:
    """The reference's rule on the stacked shapes: ones for the norms,
    ``conv_b`` and ``D_skip``; ``A_log = log(1 … h)``; ``dt_bias = -1``;
    every other leaf (``emb`` among them) N(0, fan_in^-1/2) with fan_in =
    ``shape[-2]`` of the stacked shape.  Draws on ``generator``'s device,
    leaf by leaf in the reference's order; the values differ from
    ``jax.random``'s.  On an LM ``mesh`` with the stacked ``specs`` every
    process draws the same values and keeps its block of each (``device``
    defaults to the mesh's)."""
    shapes = param_shapes(cfg)
    spec_of = None
    if mesh is not None:
        device = mesh.device if device is None else device
        spec_of = named_specs(specs)
    device = torch.device(device) if device is not None else generator.device
    model = SSMModel(shapes if mesh is None else local_shapes(shapes, specs, mesh), device=device,
                     dtype=cfg.dtype)
    for path, shape in _flat_shapes(shapes):
        name = path[-1]
        if name in _ONES:
            value = torch.ones(shape, device=device, dtype=cfg.dtype)
        elif name == "A_log":
            h = torch.arange(1, shape[-1] + 1, dtype=torch.float32, device=device)
            value = torch.log(h.expand(shape)).to(cfg.dtype)
        elif name == "dt_bias":
            value = torch.full(shape, -1.0, device=device, dtype=cfg.dtype)
        else:
            fan_in = shape[-2] if len(shape) > 1 else shape[-1]
            value = torch.randn(shape, generator=generator, device=generator.device)
            value = (value * fan_in ** -0.5).to(device, cfg.dtype)
        _assign(model, path, value, mesh, spec_of)
        del value
    return model


def abstract_params(cfg: ArchConfig, device=None, mesh=None, specs=None) -> SSMModel:
    """:func:`init_params`'s model with no value drawn (:func:`~repro_torch.
    models.transformer.abstract_params`)."""
    return T.abstract_model(SSMModel, param_shapes(cfg), cfg, device, mesh, specs)


def shard_params(full, specs: dict, mesh, dtype=None) -> SSMModel:
    """One process's blocks of full parameters (an :class:`SSMModel` or the
    reference's params tree), :func:`~repro_torch.models.transformer.shard_params`."""
    return T.shard_params(full, specs, mesh, dtype, cls=SSMModel)


def params_from_reference(tree, device="cpu", dtype=None) -> SSMModel:
    """The reference's params tree (numpy or JAX arrays) → an
    :class:`SSMModel` on ``device``, in ``dtype`` (default: the arrays');
    :func:`params_to_reference` is the transformer's."""
    return model_from_reference(SSMModel, tree, device, dtype)


# --------------------------------------------------------------------- SSD
def _state_dtype(dtype: torch.dtype) -> torch.dtype:
    """The scan's precision: float32 for bfloat16 and float32 inputs (the
    reference's), float64 for float64 (where the reference's scan refuses
    a float64 carry)."""
    return torch.promote_types(dtype, torch.float32)


def _softplus(x):
    """``jax.nn.softplus`` (``logaddexp(x, 0)``; ``F.softplus`` returns x
    above its threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_conv(x, w, b):
    """Depthwise causal conv, x (B, S, C), w (W, C)."""
    ww = w.shape[0]
    xp = F.pad(x, (0, 0, ww - 1, 0))
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(ww))
    return out + b


def ssd_chunked(x, dt, A, B, C, chunk: int):
    """Chunked SSD scan.

    x: (b, s, h, p)   dt: (b, s, h)   A: (h,) negative
    B, C: (b, s, n)   returns y (b, s, h, p) and the final state
    (b, h, p, n), both at least float32 (the state's precision; callers
    cast activations back down).  The inter-chunk recurrence is a loop
    over the s / chunk chunks.
    """
    x = x.to(_state_dtype(x.dtype))
    b, s, h, p = x.shape
    n = B.shape[-1]
    nc = s // chunk
    xr = x.reshape(b, nc, chunk, h, p)
    dtr = dt.reshape(b, nc, chunk, h)
    Br = B.reshape(b, nc, chunk, n)
    Cr = C.reshape(b, nc, chunk, n)

    la = dtr * A  # (b, nc, q, h) log-decay per step (negative)
    cum = torch.cumsum(la, dim=2)  # inclusive
    xbar = xr * dtr[..., None]

    # intra-chunk quadratic term.  Mask the EXPONENT, not the result: exp()
    # of the (positive) anti-causal entries overflows, and inf·0 poisons the
    # gradients through the where.  li[q, j] = la[j+1] + … + la[q] is summed
    # as a segment (Mamba2's ``segsum``), not as cum[q] − cum[j]: the same
    # values, rounded to |li|·eps where the difference rounds to |cum|·eps
    # (a float32 cum reaches ~1e3 over a chunk of zamba2's fastest heads).
    ones = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device)
    later = torch.tril(ones, diagonal=-1)[None, None, :, :, None]  # step k after j
    causal = torch.tril(ones)[None, None, :, :, None]
    seg = torch.where(later, la[:, :, :, None, :], 0.0)  # [k, j]: la[k] for k > j
    li = torch.cumsum(seg, dim=2)  # (b, nc, q, j, h): Σ_{j<k≤q} la[k]
    li = torch.where(causal, torch.clamp(li, max=0.0), float("-inf"))
    decay = torch.exp(li)
    cb = L.einsum("bcqn,bcjn->bcqj", Cr, Br)  # (b, nc, q, j)
    y_intra = L.einsum("bcqjh,bcjhp->bcqhp", cb[..., None] * decay, xbar)

    # inter-chunk recurrence over states
    sum_la = cum[:, :, -1, :]  # (b, nc, h)
    # each chunk's contribution to its end-state; sum_la − cum[j] as the
    # segment Σ_{k>j} la[k] (a suffix sum), for the same reason
    to_end = F.pad(torch.flip(torch.cumsum(torch.flip(la[:, :, 1:], [2]), dim=2), [2]), (0, 0, 0, 1))
    chunk_in = L.einsum("bcjhp,bcjn->bchpn", xbar * torch.exp(to_end)[..., None], Br)
    state = torch.zeros((b, h, p, n), dtype=chunk_in.dtype, device=x.device)
    entering = []  # the state *entering* each chunk
    for c in range(nc):
        entering.append(state)
        state = state * torch.exp(sum_la[:, c])[..., None, None] + chunk_in[:, c]
    entering = torch.stack(entering, dim=1)  # (b, nc, h, p, n)
    y_inter = L.einsum("bcqn,bchpn->bcqhp", Cr, entering) * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(b, s, h, p)
    return y, state


#: an SSM layer's weights, in the order the FSDP gather packs those sharded over "data"
SSM_WEIGHTS = ("ln", "in_proj", "conv_w", "conv_b", "A_log", "D_skip", "dt_bias", "out_ln", "out_proj")


def _heads(cfg: ArchConfig, shard) -> tuple[int, int]:
    """(first, count) of the SSD heads this process runs: its block where
    "model" divides the heads, all of them otherwise."""
    h = cfg.n_ssm_heads
    if shard.axes.tp(h) is None:
        return 0, h
    hl = h // shard.n_model
    return shard.model_index * hl, hl


def _in_proj(cfg: ArchConfig, xn, w, shard):
    """``xn @ in_proj`` whole over its K = 2·d_inner + 2·d_state + h
    columns: where "model" shards the columns, this process's column block
    all-gathered over "model" (module docstring)."""
    out = L.einsum("bsd,dk->bsk", xn, w)
    k = 2 * cfg.d_inner + 2 * cfg.d_state + cfg.n_ssm_heads
    if shard.axes.tp(k) is not None:
        out = shard.mesh.all_gather(out, shard.axes.model, out.dim() - 1)
    return out


def _split(cfg: ArchConfig, zxbcdt, h0: int, hl: int):
    """``z`` and ``dt`` of heads ``h0 … h0 + hl`` and the whole ``[x | B |
    C]`` from the packed projection."""
    di, nst, hd = cfg.d_inner, cfg.d_state, cfg.ssm_head_dim
    z = zxbcdt[..., h0 * hd:(h0 + hl) * hd]
    xbc = zxbcdt[..., di:2 * di + 2 * nst]
    dt = zxbcdt[..., 2 * di + 2 * nst + h0:2 * di + 2 * nst + h0 + hl]
    return z, xbc, dt


def _channels(cfg: ArchConfig, t, h0: int, hl: int):
    """The channels of an ``[x | B | C]`` last dim that heads ``h0 … h0 +
    hl`` read: their ``x`` and all of ``B`` and ``C``."""
    di, hd = cfg.d_inner, cfg.ssm_head_dim
    if hl * hd == di:
        return t
    return torch.cat([t[..., h0 * hd:(h0 + hl) * hd], t[..., di:]], dim=-1)


def _gated_norm(cfg: ArchConfig, y, scale, shard, h0: int):
    """``out_ln``'s RMSNorm over all of ``d_inner`` of a block of heads'
    channels: the local sums of squares psum'd over "model"."""
    di, c = cfg.d_inner, y.shape[-1]
    if c == di:
        return L.rms_norm(y, scale, cfg.norm_eps)
    ssq = y.to(torch.promote_types(y.dtype, torch.float32)).square().sum(dim=-1, keepdim=True)
    var = shard.mesh.psum(ssq, shard.axes.model) / di
    c0 = h0 * cfg.ssm_head_dim
    return (y * torch.rsqrt(var + cfg.norm_eps).to(y.dtype)) * scale[c0:c0 + c]


def _out_proj(cfg: ArchConfig, y, w, shard):
    """``y @ out_proj``: row-parallel over "model" where it divides
    ``d_inner`` (the rows of ``w``'s block line up with the local heads'
    channels, or cut the whole ``y`` where the heads are not sharded),
    combined over "model"."""
    rows = w.shape[0]
    if rows == y.shape[-1] and rows == cfg.d_inner:
        return L.einsum("bsk,kd->bsd", y, w)
    if rows != y.shape[-1]:
        y = y.narrow(-1, shard.model_index * rows, rows)
    return shard.combine(L.einsum("bsk,kd->bsd", y, w), partial=True)


def ssm_layer(cfg: ArchConfig, x, p, chunk: int = 128, shard=None):
    """One Mamba2 block (training path).  x: (B, S, D).  The chunk is
    ``min(chunk, S)`` and must divide S (the reference's reshape fails
    otherwise).  On a mesh (``shard``) ``p`` holds the layer's blocks,
    gathered over "data" here, and the layer runs this process's heads
    (module docstring)."""
    shard = shard or L.Shard(cfg)
    b, s, d = x.shape
    hd = cfg.ssm_head_dim
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"the SSD chunk {q} must divide the sequence length {s}")
    sd = _state_dtype(x.dtype)
    p = shard.gather_weights(p, SSM_WEIGHTS)
    h0, hl = _heads(cfg, shard)
    res = x
    xn = L.rms_norm(x, p["ln"], cfg.norm_eps)
    z, xbc, dt = _split(cfg, _in_proj(cfg, xn, p["in_proj"], shard), h0, hl)
    xbc = F.silu(_causal_conv(_channels(cfg, xbc, h0, hl), _channels(cfg, p["conv_w"], h0, hl),
                              _channels(cfg, p["conv_b"], h0, hl)))
    xs, B, C = torch.split(xbc, [hl * hd, cfg.d_state, cfg.d_state], dim=-1)
    xs = xs.reshape(b, s, hl, hd)
    dt = _softplus(dt.to(sd) + p["dt_bias"].to(sd))
    A = -torch.exp(p["A_log"].to(sd))
    y, _ = ssd_chunked(xs, dt, A, B.to(sd), C.to(sd), chunk=q)
    y = y.to(x.dtype) + xs * p["D_skip"].to(x.dtype)[None, None, :, None]
    y = y.reshape(b, s, hl * hd) * F.silu(z)
    y = _gated_norm(cfg, y, p["out_ln"], shard, h0)
    return res + _out_proj(cfg, y, p["out_proj"], shard)


def ssm_decode_layer(cfg: ArchConfig, x, p, state, shard=None):
    """One-token decode.  x: (B, 1, D); ``state`` {conv: (B, W-1, convdim),
    ssm: (B, H, P, N)} → (y, new_state), the new state in new tensors.  On
    a mesh (``shard``) ``ssm`` holds this process's heads and ``conv`` every
    channel (the whole projection is gathered, module docstring)."""
    shard = shard or L.Shard(cfg)
    b = x.shape[0]
    hd = cfg.ssm_head_dim
    sd = _state_dtype(x.dtype)
    p = shard.gather_weights(p, SSM_WEIGHTS)
    h0, hl = _heads(cfg, shard)
    res = x
    xn = L.rms_norm(x, p["ln"], cfg.norm_eps)
    z, xbc, dt = _split(cfg, _in_proj(cfg, xn, p["in_proj"], shard)[:, 0], h0, hl)
    wdt = torch.promote_types(state["conv"].dtype, xbc.dtype)  # jnp.concatenate promotes
    window = torch.cat([state["conv"].to(wdt), xbc[:, None].to(wdt)], dim=1)  # (B, W, convdim)
    xbc = F.silu(L.einsum("bwc,wc->bc", _channels(cfg, window, h0, hl), _channels(cfg, p["conv_w"], h0, hl))
                 + _channels(cfg, p["conv_b"], h0, hl))
    new_conv = window[:, 1:]
    xs, B, C = torch.split(xbc, [hl * hd, cfg.d_state, cfg.d_state], dim=-1)
    xs = xs.reshape(b, hl, hd)
    dt = _softplus(dt.to(sd) + p["dt_bias"].to(sd))
    A = -torch.exp(p["A_log"].to(sd))
    da = torch.exp(dt * A)  # (B, H)
    ssm = state["ssm"]
    s_new = ssm * da[..., None, None].to(ssm.dtype) + L.einsum(
        "bhp,bn,bh->bhpn", xs.to(sd), B.to(sd), dt).to(ssm.dtype)
    y = L.einsum("bn,bhpn->bhp", C.to(s_new.dtype), s_new).to(x.dtype) \
        + xs * p["D_skip"].to(x.dtype)[None, :, None]
    y = y.reshape(b, 1, hl * hd) * F.silu(z)[:, None]
    y = _gated_norm(cfg, y, p["out_ln"], shard, h0)
    out = res + _out_proj(cfg, y, p["out_proj"], shard).to(res.dtype)
    return out, {"conv": new_conv.to(res.dtype), "ssm": s_new}


# ---------------------------------------------------------------- forwards
def _shared_attn_block(cfg: ArchConfig, x, sp, positions, shard=None):
    """The hybrid's shared attention + MLP block: the transformer's decoder
    layer (head-sharded and combined over "model" on a mesh, its weights
    gathered over "data" at each application)."""
    mask = None if cfg.attn_chunk else L.causal_mask(x.shape[1], device=x.device)
    return T.decoder_layer(cfg, x, sp, positions, mask, "causal", shard)[0]


def _segments(cfg: ArchConfig):
    """(start, end) of each run of layers; the hybrid applies its shared
    block before each run of ``attn_period`` layers."""
    n = cfg.n_layers
    if cfg.family == "hybrid" and cfg.attn_period:
        return [(s0, min(s0 + cfg.attn_period, n)) for s0 in range(0, n, cfg.attn_period)]
    return [(0, n)]


def _hybrid(cfg: ArchConfig) -> bool:
    return cfg.family == "hybrid" and bool(cfg.attn_period)


def forward(cfg: ArchConfig, params: SSMModel, tokens, shard=None):
    """Token forward to the final hidden states (B, S, D).  With
    ``cfg.remat`` each layer, and each application of the shared block, is
    recomputed in the backward pass.  On a mesh (``shard``) ``params`` are
    this process's blocks and ``tokens`` its rows; the embedding is
    vocab-parallel over "model"."""
    shard = shard or L.Shard(cfg)
    x = T._embed(cfg, shard, shard.gather_weights(params, ["emb"])["emb"], tokens).to(cfg.dtype)
    x = shard.residual(x)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    remat = cfg.remat and torch.is_grad_enabled()

    def run(fn, *args):
        return checkpoint(fn, cfg, *args, use_reentrant=False) if remat else fn(cfg, *args)

    for s0, e0 in _segments(cfg):
        if _hybrid(cfg):
            x = shard.residual(run(_shared_attn_block, x, params.shared, positions, shard))
        for layer in params.layers[s0:e0]:
            x = shard.residual(run(ssm_layer, x, layer, 128, shard))
    return L.rms_norm(x, params["final_ln"], cfg.norm_eps)


def loss_fn(cfg: ArchConfig, mesh=None):
    """``f(params, batch) -> loss`` with batch ``{"tokens", "labels"}``.
    On an LM ``mesh`` ``params`` are this process's blocks and ``batch``
    its rows; the loss is the global one (pmean'd over the batch axes)."""
    specs = T.mesh_specs(cfg, mesh, param_specs)

    def f(params, batch):
        shard = L.Shard(cfg, mesh, specs, batch["tokens"].shape[1], seq_parallel=False)
        x = forward(cfg, params, batch["tokens"], shard)
        return shard.batch_mean(lm_loss(cfg, params, x, batch["labels"], shard))

    return f


# ------------------------------------------------------------------ decode
def cache_shapes(cfg: ArchConfig, batch: int, seq: int):
    di, nst, h, hd = cfg.d_inner, cfg.d_state, cfg.n_ssm_heads, cfg.ssm_head_dim
    conv_dim = di + 2 * nst
    shapes = {
        "conv": (cfg.n_layers, batch, cfg.conv_width - 1, conv_dim),
        "ssm": (cfg.n_layers, batch, h, hd, nst),
    }
    if _hybrid(cfg):
        n_apps = math.ceil(cfg.n_layers / cfg.attn_period)
        kv, dh = cfg.n_kv_heads, cfg.head_dim
        shapes |= {
            "k": (n_apps, batch, seq, kv, dh),
            "v": (n_apps, batch, seq, kv, dh),
        }
    return shapes


def cache_dtype(cfg: ArchConfig, shape: tuple) -> torch.dtype:
    """The reference's rule: float32 for every 5-D leaf whose last dim is
    ``d_state`` (the SSM state; also zamba2's K/V, whose ``head_dim``
    equals ``d_state``), the config's dtype otherwise."""
    return torch.float32 if len(shape) == 5 and shape[-1] == cfg.d_state else cfg.dtype


def init_cache(cfg: ArchConfig, batch: int, seq: int, device=None, mesh=None):
    """Zeros of :func:`cache_shapes` in :func:`cache_dtype`; on a ``mesh``
    this process's blocks (:func:`cache_specs`)."""
    shapes = cache_blocks(cache_shapes(cfg, batch, seq), cache_specs, cfg, batch, seq, mesh)
    return {k: torch.zeros(s, dtype=cache_dtype(cfg, s), device=device) for k, s in shapes.items()}


def decode_step(cfg: ArchConfig, mesh=None, cache_specs=None):
    """One-token decode: ``f(params, cache, token, pos) -> (logits, cache)``
    with ``token`` and ``pos`` (B,) integer tensors.  Each layer's conv
    window and SSM state, and each shared application's K/V row, are
    written into ``cache`` in place.  Where the hidden state's dtype is not
    the ``conv`` cache's (zamba2 in bfloat16, whose float32 K/V make the
    hidden state float32 from the first shared block on), ``cache["conv"]``
    is first replaced by a copy in that dtype, as the reference's step
    returns it.  On an LM ``mesh`` (with the cache's ``cache_specs``)
    ``params`` and ``cache`` are this process's blocks, ``token``/``pos``
    its rows and the logits its block (module docstring)."""
    specs = T.mesh_specs(cfg, mesh, param_specs)

    @torch.no_grad()
    def f(params, cache, token, pos):
        shard = T.decode_shard(cfg, mesh, specs, cache_specs.get("k") if cache_specs else None)
        slots = L.decode_slots(pos, cache["k"].shape[2], shard) if _hybrid(cfg) else None
        x = T._embed(cfg, shard, shard.gather_weights(params, ["emb"])["emb"], token[:, None]).to(cfg.dtype)
        for app, (s0, e0) in enumerate(_segments(cfg)):
            if _hybrid(cfg):
                x = T.decode_layer(cfg, x, params.shared, cache["k"][app], cache["v"][app], slots, shard)
            for i in range(s0, e0):
                x, ns = ssm_decode_layer(cfg, x, params.layers[i],
                                         {"conv": cache["conv"][i], "ssm": cache["ssm"][i]}, shard)
                if cache["conv"].dtype != ns["conv"].dtype:
                    cache["conv"] = cache["conv"].to(ns["conv"].dtype)
                cache["conv"][i].copy_(ns["conv"])
                cache["ssm"][i].copy_(ns["ssm"])
        x = L.rms_norm(x, params["final_ln"], cfg.norm_eps)
        return logits_from_hidden(cfg, params, x, shard)[:, 0], cache

    return f
