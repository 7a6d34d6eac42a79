"""Mixture-of-Experts FFN, on one device or expert-parallel over "model".

Port of ``repro/models/moe.py``.  :func:`moe_ffn` is the body of the
reference's ``_moe_local``.  On one device it holds every expert and makes
no collective.  On an LM mesh (its ``shard``) the experts are sharded over
"model": process m runs experts e0 = m·E/|model| onward on every token of
its batch shard (the input is gathered over the sequence, so each expert
shard already holds the tokens it may need and the dispatch is a local
capacity-gather), and one collective combines the shards' outputs, a psum
over "model", or a reduce-scatter into the sequence-sharded residual under
``moe_scatter_combine``.  The capacity counts the local tokens, T_loc =
(B/|batch axes|)·S, so drops depend on the tokens of one shard, and the aux
loss is the pmean over the batch axes of each shard's aux, not the aux of
all tokens.  An expert count that "model" does not divide is refused, as
the reference's assert refuses it.

Routing is top-k over a float32 softmax, ties to the lower expert id, the k
gates renormalised to sum 1.  Each expert has capacity
C = int(max(1, ceil(T·k/E)·capacity_factor)) over the T = B·S tokens in
(b, s) order: it takes its member tokens in token order up to C and drops
the later ones, for that expert only (Switch/GShard semantics,
deterministic and static-shaped).

The reference loops over the experts (a gather, the FFN and a scatter-add
each).  The port routes every expert at once: the queue ranks by one
cumulative sum over the (T, E) membership, one gather of the kept tokens
into (E, C, d) slots (empty slots zero), the FFN as batched matmuls over
E, and a combine that adds each token's gated slot outputs in ascending
expert id, the reference's order of adds.  The dispatch and the combine
are gathers in both directions (:class:`_Gather`: each one's backward is
the other's gather), so no float atomics run and two runs are
bit-identical.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.models.common import ArchConfig

#: while :func:`record_dropped` is active, the dropped picks of each call
_dropped: list | None = None


@contextlib.contextmanager
def record_dropped():
    """Collect the dropped (token, expert) picks of every :func:`moe_ffn`
    call made inside: a list of 0-d int64 tensors, one a call, in call
    order (a layer recomputed under remat counts again)."""
    global _dropped
    before, _dropped = _dropped, []
    try:
        yield _dropped
    finally:
        _dropped = before


def capacity(cfg: ArchConfig, t: int) -> int:
    """Slots per expert for ``t`` tokens routed together (the reference's)."""
    return int(max(1, -(-t * cfg.top_k // cfg.n_experts) * cfg.capacity_factor))


def route(cfg: ArchConfig, xf, router):
    """``xf`` (T, d) → probs (T, E) float32, the top-k expert ids (T, k) in
    descending probability (ties to the lower id, as ``lax.top_k``) and
    their gates renormalised to sum 1."""
    probs = torch.softmax(xf.float() @ router.float(), dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_vals, top_ids = vals[:, : cfg.top_k], ids[:, : cfg.top_k]
    return probs, top_ids, top_vals / top_vals.sum(-1, keepdim=True)


def _dispatch_plan(top_ids, n_experts: int, c: int, e0: int = 0, n_local: int | None = None):
    """The slot of every pick and the pick of every slot, for ``c`` slots
    an expert over the ``n_local`` experts from ``e0`` (default all; slot
    (e - e0)·c + r holds expert e's r-th kept token, and a pick of another
    expert is dropped here).

    Returns ``member`` (T, E) int64 (1 where a token picked the expert),
    ``order`` (T, k) (each token's picks permuted to ascending expert id),
    ``pick_slot`` (T, k) (the slot of each pick in that order; E·c for a
    dropped one), ``slot_token`` (E·c,) (the token a slot holds; T for an
    empty one) and ``slot_pick`` (E·c,) (its pick's index into the (T·k)
    picks in that order; T·k for an empty one)."""
    t, k = top_ids.shape
    dev = top_ids.device
    n_local = n_experts if n_local is None else n_local
    ids, order = torch.sort(top_ids, dim=-1)
    member = torch.zeros((t, n_experts), dtype=torch.int64, device=dev).scatter_(1, top_ids, 1)
    rank = (member.cumsum(0) - 1).gather(1, ids)  # a member's place in its expert's queue
    n = n_local * c
    kept = (rank < c) & (ids >= e0) & (ids < e0 + n_local)
    pick_slot = torch.where(kept, (ids - e0) * c + rank, n)
    flat = pick_slot.view(-1)
    picks = torch.arange(t * k, device=dev)
    # the dropped picks all write the extra last entry, which is cut off
    slot_token = torch.full((n + 1,), t, dtype=torch.int64, device=dev)
    slot_token[flat] = picks // k
    slot_pick = torch.full((n + 1,), t * k, dtype=torch.int64, device=dev)
    slot_pick[flat] = picks
    return member, order, pick_slot, slot_token[:n], slot_pick[:n]


def _gather_rows(src, idx):
    """``src`` (N, d) with a zero row appended, gathered by ``idx`` (index N
    reads the zero row): shape ``idx.shape + (d,)``."""
    return torch.cat([src, src.new_zeros(1, src.shape[-1])])[idx]


def _sum_in_order(g):
    """(N, m, d) → (N, d): g[:, 0] + g[:, 1] + … left to right."""
    out = g[:, 0]
    for j in range(1, g.shape[1]):
        out = out + g[:, j]
    return out


class _Gather(torch.autograd.Function):
    """``_gather_rows(src, idx)`` whose backward is a gather too: the
    gradient's rows (flattened over ``idx``'s shape) gathered by ``back``
    (len(src), m) and summed over m in order.  ``back`` is the transpose
    of ``idx`` (row i of ``src`` went to the gathered rows back[i, :]; the
    index past the last row for none)."""

    @staticmethod
    def forward(ctx, src, idx, back):
        ctx.save_for_backward(back)
        return _gather_rows(src, idx)

    @staticmethod
    def backward(ctx, grad):
        (back,) = ctx.saved_tensors
        return _sum_in_order(_gather_rows(grad.reshape(-1, grad.shape[-1]), back)), None, None


def _expert_ffn(cfg: ArchConfig, xs, p):
    """The experts' FFN on their slots, batched over the expert axis:
    (E, C, d) → (E, C, d)."""
    if cfg.mlp == "swiglu":
        h = F.silu(torch.matmul(xs, p["we_g"])) * torch.matmul(xs, p["we_u"])
    else:  # gelu: jax.nn.gelu's default is the tanh approximation
        h = F.gelu(torch.matmul(xs, p["we_u"]), approximate="tanh")
    return torch.matmul(h, p["we_d"])


def check_experts(cfg: ArchConfig, n_model: int) -> None:
    """Refuse an expert count that the "model" axis does not divide."""
    if cfg.n_experts % n_model:
        raise ValueError(f"{cfg.name}: {cfg.n_experts} experts do not divide over a "
                         f"'model' axis of {n_model} (experts must divide model axis)")


def moe_ffn(cfg: ArchConfig, x, p, shard=None):
    """x: (B, S, D); p: ``router`` (D, E), ``we_g``/``we_u`` (E, D, F),
    ``we_d`` (E, F, D) (no ``we_g`` for gelu).  Returns the (B, S, D) output
    and the Switch load-balance loss E·Σ_e density_e·mean_prob_e in float32
    (density counts every pick, dropped ones too).

    With a :class:`~repro_torch.models.layers.Shard` on a mesh, ``x`` is
    the batch shard's tokens (their whole sequence), ``p``'s expert banks
    hold this process's E/|model| experts, the output comes back combined
    into the residual's layout and the aux loss pmean'd over the batch
    axes (module docstring); a Shard without a mesh is one device."""
    b, s, d = x.shape
    t, e, k = b * s, cfg.n_experts, cfg.top_k
    e0, n_local = 0, e
    if shard is not None:
        check_experts(cfg, shard.n_model)
        n_local = e // shard.n_model
        e0 = shard.model_index * n_local
    c = min(capacity(cfg, t), t)  # a queue never holds more than the T tokens
    xf = x.reshape(t, d)
    probs, top_ids, top_vals = route(cfg, xf, p["router"])
    member, order, pick_slot, slot_token, slot_pick = _dispatch_plan(top_ids, e, c, e0, n_local)
    if _dropped is not None:
        _dropped.append((member.sum(0) - c).clamp(min=0).sum())
    n = n_local * c
    xs = _Gather.apply(xf, slot_token, pick_slot).view(n_local, c, d)
    ye = _expert_ffn(cfg, xs, p)
    rows = _Gather.apply(ye.view(n, d), pick_slot, slot_pick[:, None])  # (T, k, d)
    gate = torch.where(pick_slot < n, top_vals.gather(1, order), 0.0).to(x.dtype)
    out = rows[:, 0] * gate[:, :1]
    for j in range(1, k):
        out = out + rows[:, j] * gate[:, j : j + 1]
    aux = e * torch.sum(member.float().mean(0) * probs.mean(0))
    out = out.view(b, s, d)
    if shard is not None:  # one collective combines the expert shards
        out = shard.combine(out, partial=shard.axes.tp(e) is not None, scatter=cfg.moe_scatter_combine)
        aux = shard.batch_mean(aux)
    return out, aux


def moe_ffn_reference(cfg: ArchConfig, x, p):
    """Dense (no-drop) oracle for tests: every token sees its top-k experts."""
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    _, top_ids, top_vals = route(cfg, xf, p["router"])
    out = torch.zeros_like(xf)
    for e in range(cfg.n_experts):
        if cfg.mlp == "swiglu":
            h = F.silu(xf @ p["we_g"][e]) * (xf @ p["we_u"][e])
        else:
            h = F.gelu(xf @ p["we_u"][e], approximate="tanh")
        gate = torch.where(top_ids == e, top_vals, 0.0).sum(-1)
        out = out + (h @ p["we_d"][e]) * gate[:, None].to(x.dtype)
    return out.view(b, s, d)
