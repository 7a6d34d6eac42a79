"""Shared model configuration and the sharding rules.

Port of ``repro/models/common.py``.  One ``ArchConfig`` covers every
assigned family (dense / moe / ssm / hybrid / encdec / vlm) with the
reference's fields, defaults and counts; ``dtype`` is a torch dtype.

The 2-D FSDP("data") × TP("model") layout is the reference's:
:class:`MeshAxes` resolves a mesh's axis names and sizes, and its ``tp`` and
``fs`` rules say which dims a leaf shards over "model" and "data" (None
where the axis does not divide the dim).  :class:`P` is a partition spec
whose entries equal the reference's ``PartitionSpec`` entries as a tuple.
The reference hands its specs to GSPMD and hints layouts with
``constrain``; the port's sharded step (:mod:`repro_torch.train.train_step`
on a :class:`~repro_torch.launch.mesh.LMMesh`) holds each process's own
block of every leaf and writes the collectives out (:func:`named_specs`,
:func:`local_shapes`, :func:`block_of` and :func:`gather_named` map the
reference's stacked specs onto the port's per-layer parameters and their
blocks), and its :func:`constrain` checks a local block's shape against a
spec.  The
sharding knobs (``seq_parallel``, ``dense_scatter_combine``,
``moe_scatter_combine``) choose its collectives; ``gqa_shard_fix`` and
``attn_seq_shard`` change only the reference's hints, and the port runs its
head-sharded attention under them.  What the LM half does not run yet
raises :func:`not_ported`, citing :data:`LM_ITEM`.
"""

from __future__ import annotations

import dataclasses
import math
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
    seq_parallel: bool = True        # shard the residual's sequence over "model"
    remat: bool = True               # recompute each layer in the backward pass
    attn_logits_f32: bool = True
    unroll: bool = False             # the reference's scan/loop switch; the port always loops
    attn_chunk: int = 0              # online-softmax attention over KV chunks
    loss_chunk: int = 0              # CE loss computed over sequence chunks
    gqa_shard_fix: bool = False      # a GSPMD hint in the reference: no effect here
    moe_scatter_combine: bool = False  # EP combine by reduce-scatter into the seq-sharded residual
    attn_seq_shard: bool = False     # a GSPMD hint in the reference: heads stay sharded here
    dense_scatter_combine: bool = False  # row-parallel MLP out by reduce-scatter
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


# ----------------------------------------------------------------- sharding
class P(tuple):
    """A partition spec: one entry a dim, each None, a mesh axis name or a
    tuple of names.  A one-name tuple is its name, as ``PartitionSpec``
    normalises it, so ``tuple(P(...))`` equals the reference's entries."""

    def __new__(cls, *entries):
        norm = []
        for e in entries:
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                e = e[0] if len(e) == 1 else (e or None)
            norm.append(e)
        return super().__new__(cls, norm)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(tuple(self))}"

    def axes_of(self, i: int) -> tuple[str, ...]:
        """The mesh axes dim ``i`` shards over (() past the last entry)."""
        e = self[i] if i < len(self) else None
        return () if e is None else (e if isinstance(e, tuple) else (e,))

    def mesh_axes(self) -> tuple[str, ...]:
        """Every mesh axis the spec shards some dim over, in entry order."""
        return tuple(a for i in range(len(self)) for a in self.axes_of(i))


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """Resolved axis names of the active mesh (pod axis optional)."""

    batch: tuple[str, ...]   # ("pod","data") or ("data",)
    fsdp: str | None         # "data"
    model: str | None        # "model"
    sizes: dict[str, int]

    @classmethod
    def from_mesh(cls, mesh) -> "MeshAxes":
        """From a mesh with ``axis_names`` and ``shape`` (name → size), as
        :class:`~repro_torch.launch.mesh.LMMesh` has."""
        names = tuple(mesh.axis_names)
        batch = tuple(a for a in ("pod", "data") if a in names) or (names[0],)
        return cls(
            batch=batch,
            fsdp="data" if "data" in names else None,
            model="model" if "model" in names else None,
            sizes={n: int(mesh.shape[n]) for n in names},
        )

    def size(self, axis: str | None) -> int:
        return self.sizes.get(axis, 1) if axis else 1

    def tp(self, dim: int) -> str | None:
        """'model' if it divides dim, else None (replicate)."""
        m = self.model
        return m if m and dim % self.sizes[m] == 0 else None

    def fs(self, dim: int) -> str | None:
        f = self.fsdp
        return f if f and dim % self.sizes[f] == 0 else None


def local_shape(shape, spec: P, sizes: dict[str, int]) -> tuple[int, ...]:
    """The block of a ``shape`` leaf that one process holds under ``spec``:
    each sharded dim divided by the product of its axes' sizes."""
    out = []
    for i, dim in enumerate(shape):
        n = math.prod(sizes.get(a, 1) for a in spec.axes_of(i))
        if dim % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not divide over {spec.axes_of(i)} ({n})")
        out.append(dim // n)
    return tuple(out)


def cache_blocks(shapes: dict, specs_fn, cfg: "ArchConfig", batch: int, seq: int, mesh) -> dict:
    """A decode cache's leaf shapes cut to one process's blocks on ``mesh``
    by the family's ``specs_fn`` (its ``cache_specs``); ``shapes`` as they
    are without a mesh."""
    if mesh is None:
        return shapes
    specs, sizes = specs_fn(cfg, MeshAxes.from_mesh(mesh), batch, seq), dict(mesh.shape)
    return {k: local_shape(s, specs[k], sizes) for k, s in shapes.items()}


def constrain(x: torch.Tensor, mesh, *spec, full=None) -> torch.Tensor:
    """Check that ``x`` is one process's block under ``spec`` on ``mesh`` and
    return it.  The reference's ``constrain`` asks GSPMD for a layout; here
    the layout is the code's, so this checks it: the spec names only the
    mesh's axes, has no more entries than ``x`` has dims, and, given the
    leaf's ``full`` shape, ``x`` has the block's shape."""
    spec = P(*spec)
    unknown = set(spec.mesh_axes()) - set(mesh.axis_names)
    if unknown or len(spec) > x.dim():
        raise ValueError(f"spec {spec} does not fit a {x.dim()}-d block on axes {mesh.axis_names}")
    if full is not None and tuple(x.shape) != local_shape(full, spec, dict(mesh.shape)):
        raise ValueError(f"block {tuple(x.shape)} is not the {spec} block of {tuple(full)} on "
                         f"{dict(mesh.shape)}")
    return x


# ------------------------------------------------- one process's blocks
#: the reference's stacked per-layer groups (``(n_layers, …)`` arrays), each
#: an ``nn.ModuleList`` of the same name in the port's modules
STACKED = ("layers", "enc_layers", "dec_layers")


def named_specs(specs: dict, moments: bool = False):
    """``name -> P`` for the port's parameter names from the reference's
    stacked ``specs``: a layer's weight (``layers.3.wq``) takes its stacked
    spec without the layer entry.

    With ``moments`` (the ZeRO-1 moments' specs) a stacked spec that shards
    the layer dim over "data" (the reference's rule picks that dim where it
    is the largest one free, as for the SSM's (n_layers, heads) leaves
    ``A_log``, ``D_skip`` and ``dt_bias``) leaves each layer's moment whole
    over "data": the port keeps one tensor a layer, and these leaves are
    n_layers × heads values.  Their values, gathered, are the reference's.
    Without it such a spec is refused."""

    def spec_of(name: str) -> P:
        parts = name.split(".")
        if parts[0] in STACKED:
            spec = specs[parts[0]][parts[2]]
            if spec and spec[0] is not None and not moments:
                not_ported(f"a layout sharded over the layer dim ({name}: {spec}; no rule makes "
                           "one for these configs)")
            return P(*spec[1:])
        node = specs
        for key in parts:
            node = node[key]
        return node

    return spec_of


def named_shapes(shapes: dict):
    """``name -> shape`` for the port's parameter names from the stacked
    ``shapes`` tree (a layer's weight: its per-layer shape)."""

    def shape_of(name: str) -> tuple:
        parts = name.split(".")
        if parts[0] in STACKED:
            return tuple(shapes[parts[0]][parts[2]][1:])
        node = shapes
        for key in parts:
            node = node[key]
        return tuple(node)

    return shape_of


def local_shapes(shapes: dict, specs: dict, mesh) -> dict:
    """The stacked ``shapes`` tree cut to one process's blocks (a stacked
    leaf keeps its layer dim)."""
    sizes = dict(mesh.shape)
    out = {}
    for key, v in shapes.items():
        if isinstance(v, dict) and key in STACKED:
            out[key] = {w: (s[0],) + local_shape(s[1:], P(*specs[key][w][1:]), sizes)
                        for w, s in v.items()}
        elif isinstance(v, dict):
            out[key] = local_shapes(v, specs[key], mesh)
        else:
            out[key] = local_shape(v, specs[key], sizes)
    return out


def block_of(t, spec: P, mesh):
    """This process's block of a full leaf ``t`` (tensor or array) under
    ``spec``."""
    for i in range(len(spec)):
        axes = spec.axes_of(i)
        if axes:
            c = t.shape[i] // mesh.axis_size(axes)
            j = mesh.axis_index(axes) * c
            t = t.narrow(i, j, c) if isinstance(t, torch.Tensor) else t[(slice(None),) * i + (slice(j, j + c),)]
    return t


@torch.no_grad()
def gather_named(named: dict, spec_of, mesh) -> dict:
    """Full leaves from one process's blocks (for checks; every process
    gets every leaf): each sharded dim all-gathered over its axes, the
    leaves that gather over the same axes along the same dim packed into
    one call."""
    cur = {n: t.detach() for n, t in named.items()}
    todo = {n: [i for i in range(len(spec_of(n))) if spec_of(n).axes_of(i)] for n in cur}
    while any(todo.values()):
        calls: dict[tuple, list[str]] = {}
        for n, dims in todo.items():
            if dims:
                calls.setdefault((spec_of(n).axes_of(dims[0]), dims[0]), []).append(n)
        for (axes, dim), names in calls.items():
            full = mesh.all_gather_many([cur[n] for n in names], axes, [dim] * len(names))
            for n, f in zip(names, full):
                cur[n] = f
                todo[n].pop(0)
    return cur


def tree_map_specs(fn, specs, *trees):
    """``fn(spec, *leaves)`` over a nested dict of :class:`P` and trees of
    the same structure."""
    if isinstance(specs, P):
        return fn(specs, *trees)
    return {k: tree_map_specs(fn, v, *(t[k] for t in trees)) for k, v in specs.items()}
