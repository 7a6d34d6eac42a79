"""s-step enlarged CG: two reductions amortized over s SpMBV sweeps.

Each ``step`` (one *block* = s effective iterations) seeds an s-deep
monomial block-Krylov basis from the current split residual and
A-orthonormalizes the whole (n, s·t) candidate block at once (the
residual-seeded MSDO/s-step shape of Moufawad, arXiv:1804.10629):

  per block —
    V  = [R, AR, …, A^{s−1}R],  AV = A·V      s SpMBVs           (exchanges only)
    [VᵀAV ; PᵀAV ; P₂ᵀAV]                     fused gram1        (reduction #1, 3(st)²)
    V −= P a + P₂ b ; AV −= AP a + AP₂ b      project vs the previous two blocks
    G' = G − aᵀa − bᵀb                        (algebraic: no extra reduction)
    P', AP' = rank-revealing A-orthonormalization of (V, AV)   (``rank_apply``)
    c  = P'ᵀR                                 gram1              (reduction #2, st·t)
    X += P'c ; R −= AP'c

The monomial basis is ill-conditioned (like κ(A)^s), so the pivoted
rank-revealing factorization is mandatory: dependent candidate columns come
out zero-masked.  ``reorth=True`` adds a Cholesky-QR2 second pass (one
extra (st)² reduction per block).  Under a policy the stagnant *seed*
columns are dropped (the t-wide mask is scored from the transposed (t, st)
coefficient block against the carried mask, through the ``drop_mask``
kernel), and a restart clears the mask and the carried projection blocks.
``k`` counts blocks; the histories have one entry per block.

The mixed widths do not fit the fixed-shape gram and tail kernels, so the
products and updates are plain torch matmuls, as the reference's plain
products (``repro/core/methods/sstep.py``); the SpMBV keeps the operator's
backend, and the factor apply is the ``rank_apply`` kernel at width s·t
(32 at most).

Port of ``repro/core/methods/sstep.py``; the carry keeps the reference's
keys.  ``k``, ``rn`` and ``bd`` are host values, ``evhist``/``ahist`` host
arrays, and a block makes one device-to-host copy: the residual norm with
the rank(s) and, under a policy, the active count.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.adaptive.rankrev import default_rank_rtol
from repro_torch.adaptive.reduce import plateau_update
from repro_torch.core.cg import EV_RECOVERY
from repro_torch.core.methods.base import MethodContext, MethodSpec, _apply_vec
from repro_torch.kernels.chol_apply.ops import drop_mask, rank_apply


class SStepMethod(MethodSpec):
    """s inner steps per reduction pair, rank-revealing safeguarded."""

    name = "sstep"

    def validate(self, ctx: MethodContext) -> None:
        if ctx.s < 1:
            raise ValueError(f"s must be >= 1, got {ctx.s}")
        if ctx.chol_eps:
            raise ValueError(
                "method 'sstep' always factorizes through the pivoted "
                "rank-revealing Cholesky (the monomial basis demands it); "
                "chol_eps jitter does not apply — tune rank_rtol instead"
            )

    def iters_per_block(self, s: int = 1) -> int:
        return s

    def psums_per_block(self, s: int = 1, reorth: bool = False) -> int:
        return 3 if reorth else 2

    def psum_payload_floats(self, t: int, s: int = 1, reorth: bool = False) -> int:
        st = s * t
        payload = 3 * st * st + st * t  # fused gram1 + projections, then c = PᵀR
        if reorth:
            payload += st * st  # Cholesky-QR2 second gram
        return payload

    def build(self, ctx: MethodContext):
        t, s = ctx.t, ctx.s
        st = s * t
        max_iters = ctx.max_iters
        policy, use_mask, reorth = ctx.policy, ctx.use_mask, ctx.reorth
        a_apply, a_apply_masked, split_fn = ctx.a_apply, ctx.a_apply_masked, ctx.split_fn
        gram1, sqnorm, precond = ctx.gram1, ctx.sqnorm, ctx.precond
        # safeguard threshold: explicit override > policy's > dtype default
        rr_rtol = ctx.rank_rtol
        if rr_rtol is None and policy is not None:
            rr_rtol = policy.rank_rtol

        def iterate(carry):
            big_x, big_r = carry["X"], carry["R"]
            p1, ap1 = carry["P"], carry["AP"]    # previous block
            p2, ap2 = carry["Pp"], carry["APp"]  # block before that
            k = carry["k"]
            rtol = default_rank_rtol(big_r.dtype) if rr_rtol is None else rr_rtol
            act_t = carry["act"] if policy is not None else None

            # residual-seeded monomial basis: s width-t SpMBVs, exchanges
            # only; preconditioned, the M⁻¹A-Krylov sequence with AV exact
            seed = big_r if policy is None else big_r * act_t.to(big_r.dtype)
            vs, avs = [], []
            cur = seed if precond is None else precond(seed, k)
            for _ in range(s):
                nxt = a_apply_masked(cur, act_t) if use_mask else a_apply(cur)
                vs.append(cur)
                avs.append(nxt)
                cur = nxt if precond is None else precond(nxt, k)
            v = torch.cat(vs, dim=1)    # (n, st)
            av = torch.cat(avs, dim=1)  # = A·V

            # reduction #1: the Gram and both projection blocks in one
            # (3st, st) reduction, [VᵀAV ; PᵀAV ; P₂ᵀAV]
            big1 = gram1(torch.cat([v, p1, p2], dim=1), av)
            g, a1, a2 = big1[:st], big1[st:2 * st], big1[2 * st:]
            # in place on the fresh concatenations (an out-of-place addmm
            # first copies its input)
            v.addmm_(p1, a1, alpha=-1).addmm_(p2, a2, alpha=-1)
            av.addmm_(ap1, a1, alpha=-1).addmm_(ap2, a2, alpha=-1)
            # projected Gram, algebraically: PᵀAP = diag(act), PᵀAP₂ = 0
            g = (g - a1.T @ a1 - a2.T @ a2).contiguous()

            # mandatory safeguard: the pivoted rank-revealing apply at s·t
            p, ap, rank, _perm = rank_apply(g, v, av, rtol=rtol)
            ranks = [rank]
            if reorth:
                # Cholesky-QR2 second pass: one extra (st)² reduction
                p, ap, rank2, _perm2 = rank_apply(gram1(p, ap).contiguous(), p, ap, rtol=rtol)
                ranks.append(rank2)

            c = gram1(p, big_r)  # reduction #2: the (st, t) coefficient block PᵀR
            big_x = torch.addmm(big_x, p, c)
            big_r = torch.addmm(big_r, ap, c, alpha=-1)

            rsum = big_r.sum(dim=1)
            rn_dev = torch.sqrt(sqnorm(rsum))
            hist = carry["hist"].clone()  # the guard may still keep the old carry
            hist[k + 1] = rn_dev
            host = [rn_dev.reshape(1)] + [r.reshape(1).to(rn_dev.dtype) for r in ranks]
            if policy is not None:
                # seed-level stagnation: score residual column l by its
                # coefficient column c[:, l] (rows of cᵀ), against the
                # carried mask (which may have holes)
                mask, counts = drop_mask(c.T.contiguous(), rank, carry["rn"], policy, live=act_t)
                host.append(counts[1:])
            # the block's host sync: the residual norm, the rank(s) and the
            # active count in one copy
            rn, *host_rest = torch.cat(host).tolist()
            n_ranks = [int(r) for r in host_rest[:len(ranks)]]
            # live candidate columns: s per live seed column; fewer accepted
            # pivots is a rank loss of the basis the safeguard absorbed
            live = s * (int(carry["ahist"][k]) if policy is not None else t)
            recovered = n_ranks[0] < live or (reorth and n_ranks[1] < n_ranks[0])
            evhist = carry["evhist"].copy()
            evhist[k + 1] = EV_RECOVERY if recovered else 0
            out = dict(
                X=big_x, R=big_r, P=p, AP=ap, Pp=p1, APp=ap1,
                k=k + 1, rn=rn, hist=hist, bd=carry["bd"], evhist=evhist,
            )
            if policy is not None:
                n_active = int(host_rest[-1])
                act_new = mask != 0
                best_rn, since = plateau_update(
                    carry["best_rn"].dtype.type(rn), carry["best_rn"], carry["since"], policy
                )
                restarts = carry["restarts"]
                if policy.restart and since >= policy.plateau_window and n_active < t:
                    # re-enlarge: the seed is rebuilt from the residual every
                    # block, so a restart clears the mask and the carried
                    # projection blocks
                    for key in ("P", "AP", "Pp", "APp"):
                        out[key] = torch.zeros_like(out[key])
                    act_new = torch.ones_like(act_new)
                    n_active, since, restarts = t, 0, restarts + 1
                    best_rn = carry["best_rn"].dtype.type(rn)
                ahist = carry["ahist"].copy()
                ahist[k + 1] = n_active
                out.update(act=act_new, best_rn=best_rn, since=since, restarts=restarts,
                           ahist=ahist)
            return out

        def init(b, x0):
            n = b.shape[0]
            r0 = b - _apply_vec(a_apply, x0, t)
            big_r0 = split_fn(r0, t)
            rn0 = float(torch.sqrt(sqnorm(r0)))
            hist0 = torch.full((max_iters + 1,), float("nan"), dtype=b.dtype, device=b.device)
            hist0[0] = rn0
            zeros_nst = torch.zeros((n, st), dtype=b.dtype, device=b.device)
            evhist = np.full(max_iters + 1, -1, np.int32)
            evhist[0] = 0
            carry = dict(X=torch.zeros((n, t), dtype=b.dtype, device=b.device), R=big_r0,
                         P=zeros_nst, AP=zeros_nst, Pp=zeros_nst, APp=zeros_nst,
                         k=0, rn=rn0, hist=hist0, bd=not math.isfinite(rn0), evhist=evhist)
            if policy is not None:
                ahist = np.full(max_iters + 1, -1, np.int32)
                ahist[0] = t
                carry.update(
                    act=torch.ones(t, dtype=torch.bool, device=b.device),
                    best_rn=np.dtype(str(b.dtype).removeprefix("torch.")).type(rn0),
                    since=0, restarts=0, ahist=ahist,
                )
            return carry

        return init, iterate
