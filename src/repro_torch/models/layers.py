"""Core transformer building blocks.

Port of ``repro/models/layers.py``: the same math in the same order.  ``p``
is any mapping of the layer's weights (a dict of tensors, or a module of
:class:`~repro_torch.models.transformer._Weights`).  Contractions go
through :func:`einsum`, which promotes mixed dtypes as ``jnp.einsum``
does (zamba2's bfloat16 decode attends over a float32 K/V cache).

On an LM mesh the same functions run on one process's blocks, and
:class:`Shard` holds what the reference leaves to GSPMD (a Shard without a
mesh, the one-device case, does none of it): the FSDP gather
of a layer's weights over "data" just before use (one packed all-gather a
layer, whose backward is one reduce-scatter), the residual's sequence
sharded over "model" under ``seq_parallel`` (the transformer's training
forward only: the ssm, hybrid and encdec families and every decode step
keep the residual whole, as the reference's specs do; gathered before the
column-parallel projections), and the combine of the row-parallel
products over "model" (an all-reduce, or a reduce-scatter into the
sequence-sharded residual under ``dense_scatter_combine``).  Attention
runs on the process's query heads (:func:`attention`'s ``h0``): K/V sharded
with them where "model" divides the K/V heads, else the replicated K/V
heads sliced to the local query heads' groups.  A decode step's cache may
instead hold a block of the sequence's slots (:func:`decode_attention`):
each process attends its own slots and the partial softmaxes are combined
by the log-sum-exp rule, in float32.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.common import ArchConfig, MeshAxes, constrain


def einsum(eq: str, *ops):
    """``torch.einsum`` with ``jnp.einsum``'s dtype promotion: operands of
    different float dtypes are cast to the wider one first (``torch.einsum``
    refuses mixed dtypes)."""
    dtype = ops[0].dtype
    for o in ops[1:]:
        dtype = torch.promote_types(dtype, o.dtype)
    return torch.einsum(eq, *(o if o.dtype == dtype else o.to(dtype) for o in ops))


def rms_norm(x, scale, eps):
    """The variance in float32 (float64 for float64 ``x``: the reference
    casts to float32 there too, and a float64 run stays float64 here)."""
    var = x.to(torch.promote_types(x.dtype, torch.float32)).square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * scale


def rope(q, positions, theta, dtype=None):
    """Rotary embedding over the last dim of (..., S, H, dh): half-split
    (not interleaved), angles in float32."""
    dh = q.shape[-1]
    half = dh // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=q.device) / half))
    angles = positions[..., None].float() * freqs  # (..., S, half)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    q1, q2 = q[..., :half].float(), q[..., half:].float()
    out = torch.cat([q1 * cos - q2 * sin, q1 * sin + q2 * cos], dim=-1)
    return out.to(dtype or q.dtype)


def attention(cfg: ArchConfig, q, k, v, mask, mask_kind: str | None = None, h0: int = 0):
    """GQA attention.  q (B, Sq, H, dh), k and v (B, Sk, KV, dh); ``mask``
    broadcastable to (B, H, Sq, Sk) bool, or None; ``mask_kind``
    ("causal", "prefix:<n>" or None) lets the chunked path mask from
    positions.  On a mesh ``q`` holds the query heads ``h0`` onward and
    ``k``/``v`` either their K/V heads (sharded alike) or all K/V heads,
    which are repeated and sliced to the query heads' groups."""
    k, v = _kv_for_queries(cfg, q, k, v, h0)
    if cfg.attn_chunk and q.shape[1] > 1 and k.shape[1] > cfg.attn_chunk:
        return _chunked_attention(cfg, q, k, v, mask_kind or "full")
    scale = cfg.head_dim ** -0.5
    logits = einsum("bqhe,bkhe->bhqk", q, k) * scale
    if cfg.attn_logits_f32:
        logits = logits.float()
    if mask is not None:
        logits = torch.where(mask, logits, torch.finfo(logits.dtype).min)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return einsum("bhqk,bkhe->bqhe", probs, v)


def _kv_for_queries(cfg: ArchConfig, q, k, v, h0: int):
    """K/V repeated to the query heads (GQA) and cut to ``q``'s heads
    ``h0`` onward (:func:`attention`)."""
    rep = cfg.n_heads // cfg.n_kv_heads
    hl, kl = q.shape[2], k.shape[2]
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    if k.shape[2] != hl:
        k0 = 0 if kl == cfg.n_kv_heads else h0 // rep  # the first K/V head held
        k = k.narrow(2, h0 - k0 * rep, hl)
        v = v.narrow(2, h0 - k0 * rep, hl)
    return k, v


@dataclasses.dataclass
class DecodeSlots:
    """Where one decode step's new token sits in a K/V cache, built once a
    step by :func:`decode_slots` and shared by every attention layer: the
    positions ``pos`` (B,), the batch rows, the mask ``slot <= pos`` over
    this process's slots (B, 1, 1, S_loc), the slot each row writes (its
    local index, clamped into the block) and, where the cache holds a block
    of the slots, whether this process owns that slot (else None)."""

    pos: torch.Tensor
    rows: torch.Tensor
    mask: torch.Tensor
    loc: torch.Tensor
    inside: torch.Tensor | None


def decode_slots(pos, s_loc: int, shard=None) -> DecodeSlots:
    """:class:`DecodeSlots` of a cache of ``s_loc`` slots a process: this
    process's block along ``shard.cache_seq`` (all of them without one)."""
    axis = shard.cache_seq if shard is not None else ()
    s0 = shard.mesh.axis_index(axis) * s_loc if axis else 0
    rows = torch.arange(pos.shape[0], device=pos.device)
    mask = torch.arange(s0, s0 + s_loc, device=pos.device)[None, None, None, :] <= pos[:, None, None, None]
    if not axis:
        return DecodeSlots(pos, rows, mask, pos, None)
    loc = pos - s0
    inside = (loc >= 0) & (loc < s_loc)
    return DecodeSlots(pos, rows, mask, loc.clamp(0, s_loc - 1), inside)


def decode_attention(cfg: ArchConfig, q, k, v, slots: DecodeSlots, shard=None, h0: int = 0):
    """One new token's attention over a K/V cache, masked by ``slots``: q
    (B, 1, H, dh), k and v (B, S, KV, dh).  Without a sequence-sharded
    cache (``shard.cache_seq`` empty) it is :func:`attention`.  Otherwise
    ``k``/``v`` hold this process's block of the slots along
    ``shard.cache_seq`` and every process of that axis holds the same query
    heads (``h0`` onward): each attends its own slots, and the partial
    softmaxes are combined in float32 (the row max by ``pmax``, the
    exponent sums and the weighted values in one ``psum``).  A process
    whose slots are all masked adds zero: the global max is finite, slot 0
    being unmasked on the first."""
    axis = shard.cache_seq if shard is not None else ()
    if not axis:
        return attention(cfg, q, k, v, slots.mask, h0=h0)
    k, v = _kv_for_queries(cfg, q, k, v, h0)
    s = einsum("bqhe,bkhe->bhqk", q, k) * cfg.head_dim ** -0.5
    s = torch.where(slots.mask, s.float(), float("-inf"))
    mesh = shard.mesh
    m = mesh.pmax(s.amax(dim=-1), axis)  # (B, H, 1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    acc = einsum("bhqk,bkhe->bqhe", p, v.float())
    both = mesh.psum(torch.cat([l.reshape(-1), acc.reshape(-1)]), axis)
    l, acc = both[:l.numel()].view(l.shape), both[l.numel():].view(acc.shape)
    return (acc / l.transpose(1, 2)[..., None]).to(torch.promote_types(q.dtype, v.dtype))


def write_cache_row(cache, new, slots: DecodeSlots) -> None:
    """``cache`` (B, S, …)'s slot of each row set to ``new`` (B, …), in
    place.  Where the cache holds a block of the slots (``slots.inside``),
    only the process whose block holds the slot writes it (the others
    write back what they hold): no host sync."""
    new = new.to(cache.dtype)
    if slots.inside is None:
        cache[slots.rows, slots.loc] = new
        return
    keep = slots.inside.view((-1,) + (1,) * (new.dim() - 1))
    cache[slots.rows, slots.loc] = torch.where(keep, new, cache[slots.rows, slots.loc])


def _chunk_mask(mask_kind: str, q_pos, k_pos):
    """The (Sq, C) mask of one chunk from positions: causal; ``prefix:<n>``
    causal or among the first n keys; None for "full" (and, as in the
    reference, for "prefix:0")."""
    if mask_kind == "causal":
        return k_pos[None, :] <= q_pos[:, None]
    prefix_len = int(mask_kind.split(":")[1]) if mask_kind.startswith("prefix") else 0
    if prefix_len:
        return (k_pos[None, :] <= q_pos[:, None]) | (k_pos[None, :] < prefix_len)
    return None


def _chunk_step(q, k_i, v_i, m, l, acc, k_pos, q_pos, scale, mask_kind: str):
    """One KV chunk of the online softmax: the new (m, l, acc)."""
    s = einsum("bqhe,bkhe->bhqk", q, k_i).float() * scale
    msk = _chunk_mask(mask_kind, q_pos, k_pos)
    if msk is not None:
        s = torch.where(msk[None, None], s, float("-inf"))
    m_new = torch.maximum(m, s.amax(dim=-1))
    # all--inf rows (fully masked chunk) keep m = -inf; guard the exps
    safe_m = torch.where(torch.isfinite(m_new), m_new, 0.0)
    p = torch.exp(s - safe_m[..., None])
    p = torch.where(torch.isfinite(s), p, 0.0)
    corr = torch.where(torch.isfinite(m), torch.exp(m - safe_m), 0.0)
    l = l * corr + p.sum(dim=-1)
    pv = einsum("bhqk,bkhe->bqhe", p.to(q.dtype), v_i).float()
    acc = acc * corr.transpose(1, 2)[..., None] + pv
    return m_new, l, acc


def _chunked_attention(cfg: ArchConfig, q, k, v, mask_kind: str):
    """Online-softmax attention over ``attn_chunk``-wide KV chunks: the
    (Sq, Sk) score matrix never exists as a whole.  Masked scores are
    -inf here (not ``finfo.min``), with the reference's three ``isfinite``
    guards.  Under autograd each chunk is recomputed in the backward pass,
    so only the running (m, l, acc) are kept between chunks."""
    b, sq, h, dh = q.shape
    sk = k.shape[1]
    c = cfg.attn_chunk
    if sk % c:
        raise ValueError(f"attn_chunk {c} must divide the key length {sk}")
    if mask_kind not in ("causal", "full") and not re.fullmatch(r"prefix:\d+", mask_kind):
        raise ValueError(f"mask_kind {mask_kind!r}")
    scale = dh ** -0.5
    q_pos = torch.arange(sq, device=q.device)
    m = torch.full((b, h, sq), float("-inf"), dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, h, dh), dtype=torch.float32, device=q.device)
    for ci in range(sk // c):
        args = (q, k[:, ci * c:(ci + 1) * c], v[:, ci * c:(ci + 1) * c], m, l, acc,
                ci * c + torch.arange(c, device=q.device), q_pos, scale, mask_kind)
        if torch.is_grad_enabled():
            m, l, acc = checkpoint(_chunk_step, *args, use_reentrant=False)
        else:
            m, l, acc = _chunk_step(*args)
    out = acc / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


def causal_mask(s: int, device=None):
    return torch.tril(torch.ones((s, s), dtype=torch.bool, device=device))[None, None]


def prefix_lm_mask(s: int, prefix_len: int, device=None):
    """Bidirectional over the first ``prefix_len`` positions, causal after
    (PaliGemma-style image-prefix attention)."""
    causal = torch.tril(torch.ones((s, s), dtype=torch.bool, device=device))
    prefix = torch.arange(s, device=device)[None, :] < prefix_len
    return (causal | prefix)[None, None]


def mlp_block(cfg: ArchConfig, x, p):
    if cfg.mlp == "swiglu":
        g = einsum("bsd,df->bsf", x, p["wg"])
        u = einsum("bsd,df->bsf", x, p["wu"])
        h = F.silu(g) * u
    else:  # gelu: jax.nn.gelu's default is the tanh approximation
        h = F.gelu(einsum("bsd,df->bsf", x, p["wu"]), approximate="tanh")
    return einsum("bsf,fd->bsd", h, p["wd"])


def qkv(cfg: ArchConfig, x, p, positions):
    q = einsum("bsd,dhe->bshe", x, p["wq"])
    k = einsum("bsd,dhe->bshe", x, p["wk"])
    v = einsum("bsd,dhe->bshe", x, p["wv"])
    if positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


@dataclasses.dataclass
class Shard:
    """One process's place in a step on an LM ``mesh`` for a sequence of
    ``seq`` positions (module docstring): ``specs`` maps each weight's name
    (``wq``, ``emb``, …) to its per-layer :class:`P`.  Without a mesh (one
    device, ``Shard(cfg)``) every method is an identity and makes no
    call."""

    cfg: ArchConfig
    mesh: Any = None
    specs: dict = dataclasses.field(default_factory=dict)
    seq: int = 0
    #: whether the family shards the residual's sequence (the transformer's
    #: training forward; the others and every decode step keep it whole)
    seq_parallel: bool = True
    #: a decode cache's sequence dim: the mesh axes its slots are sharded
    #: over (:func:`decode_attention`), () where each process holds every slot
    cache_seq: tuple = ()

    def __post_init__(self):
        self.axes = (MeshAxes(batch=(), fsdp=None, model=None, sizes={}) if self.mesh is None
                     else MeshAxes.from_mesh(self.mesh))
        model = self.axes.model
        self.n_model = self.axes.size(model)
        self.model_index = self.mesh.axis_index(model) if model else 0
        # the residual's sequence sharded over "model" (the reference's _residual_spec)
        self.sp = bool(model and self.seq_parallel and self.cfg.seq_parallel
                       and self.seq % self.n_model == 0)
        self.heads_sharded = self.axes.tp(self.cfg.n_heads) is not None
        self.h0 = self.model_index * self.cfg.n_heads // self.n_model if self.heads_sharded else 0
        self.vocab_parallel = self.axes.tp(self.cfg.vocab_padded) is not None

    def gather_weights(self, p, names) -> dict:
        """``{name: weight}`` of ``p``'s weights ``names``, every one sharded
        over "data" gathered along its data dim, all in one all-gather."""
        fsdp = self.axes.fsdp
        out = {n: p[n] for n in names}
        dims = {n: next((i for i in range(len(self.specs[n])) if fsdp in self.specs[n].axes_of(i)), None)
                for n in names if n in self.specs} if fsdp else {}
        sharded = [n for n in names if dims.get(n) is not None]
        if sharded:
            full = self.mesh.all_gather_many([out[n] for n in sharded], fsdp, [dims[n] for n in sharded])
            out |= dict(zip(sharded, full))
        return out

    def gather_seq(self, x):
        """The residual's sequence blocks gathered over "model" (dim 1)."""
        return self.mesh.all_gather(x, self.axes.model, 1) if self.sp else x

    def seq_block(self, x):
        """This process's sequence block of a replicated (B, S, …)."""
        if not self.sp:
            return x
        c = x.shape[1] // self.n_model
        return x.narrow(1, self.model_index * c, c)

    def residual(self, x):
        """Check that ``x`` is the residual's block (batch over the batch
        axes, the sequence over "model" under ``seq_parallel``) and return
        it."""
        if self.mesh is None:
            return x
        n_batch = math.prod(self.axes.size(a) for a in self.axes.batch)
        return constrain(x, self.mesh, self.axes.batch, self.axes.model if self.sp else None, None,
                         full=(x.shape[0] * n_batch, self.seq, x.shape[2]))

    def combine(self, y, partial: bool, scatter: bool = False):
        """A (B, S, D) product into the residual's layout: summed over
        "model" when each process holds a part (an all-reduce, or a
        reduce-scatter along the sequence when ``scatter`` and the residual
        is sequence-sharded), then cut to this process's sequence block."""
        if partial:
            if scatter and self.sp:
                return self.mesh.reduce_scatter(y, self.axes.model, 1)
            y = self.mesh.psum(y, self.axes.model)
        return self.seq_block(y)

    def batch_mean(self, x):
        """The mean of ``x`` over the batch shards."""
        return x if self.mesh is None else self.mesh.pmean(x, self.axes.batch)
