"""Shared model configuration.

Port of ``repro/models/common.py``.  One ``ArchConfig`` covers every
assigned family (dense / moe / ssm / hybrid / encdec / vlm) with the
reference's fields, defaults and counts; ``dtype`` is a torch dtype.  The
port runs every family on one device.
The sharding knobs (``seq_parallel``, ``gqa_shard_fix``, ``attn_seq_shard``,
``dense_scatter_combine``, ``moe_scatter_combine``) stay as fields and change
no value there: the reference's ``constrain`` is a layout hint, and its
row-parallel ``shard_map`` at model size 1 sums one part, as does the MoE's
psum combine over one expert shard.  The 2-D FSDP × TP layout (``MeshAxes``,
the ``*_specs`` rules, ``constrain``, the expert-parallel ``shard_map``) and
``launch/perf.py``'s transformer half are ROADMAP.md queue 1 item 13's
remainder (:data:`LM_ITEM`); what needs them raises :func:`not_ported`.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

#: the ROADMAP.md item that brings what the LM half refuses
LM_ITEM = "queue 1 item 13, remainder"


def not_ported(what: str):
    """Raise ``NotImplementedError`` for a part of the LM half that is not
    ported yet, citing :data:`LM_ITEM`."""
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md {LM_ITEM})")


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int | None = None        # default d_model // n_heads
    mlp: str = "swiglu"              # swiglu | gelu
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    # --- moe ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # --- ssm / hybrid ---
    d_state: int = 0
    expand: int = 2
    ssm_head_dim: int = 64
    conv_width: int = 4
    attn_period: int = 0             # hybrid: shared attn block every N layers
    # --- encdec ---
    n_enc_layers: int = 0
    enc_ctx: int = 1500              # whisper frame positions (frontend stub)
    # --- vlm ---
    n_patches: int = 0               # paligemma image prefix length (stub)
    # --- execution knobs ---
    dtype: Any = torch.bfloat16
    seq_parallel: bool = True        # sharded layout only: no effect on one device
    remat: bool = True               # recompute each layer in the backward pass
    attn_logits_f32: bool = True
    unroll: bool = False             # the reference's scan/loop switch; the port always loops
    attn_chunk: int = 0              # online-softmax attention over KV chunks
    loss_chunk: int = 0              # CE loss computed over sequence chunks
    gqa_shard_fix: bool = False      # sharded layout only
    moe_scatter_combine: bool = False  # sharded layout only
    attn_seq_shard: bool = False     # sharded layout only
    dense_scatter_combine: bool = False  # sharded layout only
    # padding of the vocab to a multiple (for TP divisibility); logits masked
    vocab_pad_multiple: int = 256

    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def vocab_padded(self) -> int:
        m = self.vocab_pad_multiple
        return (self.vocab + m - 1) // m * m

    def with_(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------- counting
    def param_count(self) -> int:
        """Analytic parameter count (the reference's)."""
        d, f, dh = self.d_model, self.d_ff, self.head_dim
        attn = d * self.n_heads * dh * 2 + d * self.n_kv_heads * dh * 2
        mlp = (3 if self.mlp == "swiglu" else 2) * d * f
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        if self.family in ("dense", "vlm"):
            return self.n_layers * (attn + mlp) + emb
        if self.family == "moe":
            router = d * self.n_experts
            return self.n_layers * (attn + self.n_experts * mlp + router) + emb
        if self.family == "ssm":
            return self.n_layers * self._ssm_layer_params() + self.vocab * d
        if self.family == "hybrid":
            shared = attn + mlp
            return self.n_layers * self._ssm_layer_params() + shared + self.vocab * d
        if self.family == "encdec":
            enc = self.n_enc_layers * (attn + mlp)
            dec = self.n_layers * (2 * attn + mlp)
            return enc + dec + self.vocab * d
        raise ValueError(self.family)

    def _ssm_layer_params(self) -> int:
        d, di, n, h = self.d_model, self.d_inner, self.d_state, self.n_ssm_heads
        in_proj = d * (2 * di + 2 * n + h)
        return in_proj + di * d + self.conv_width * (di + 2 * n) + 2 * h + di

    def active_param_count(self) -> int:
        """MoE: params touched per token (for MODEL_FLOPS = 6·N_active·D)."""
        if self.family != "moe":
            return self.param_count()
        d, f = self.d_model, self.d_ff
        attn = d * self.n_heads * self.head_dim * 2 + d * self.n_kv_heads * self.head_dim * 2
        mlp = (3 if self.mlp == "swiglu" else 2) * d * f
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * (attn + self.top_k * mlp + d * self.n_experts) + emb
