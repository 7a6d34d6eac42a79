"""Global-reduction pipelined ECG (Cools & Ghysels-style overlap).

Same two reductions per iteration as classic, but the SpMBV is moved off
the critical path of the packed Gram reduction.  Carrying AZ across
iterations makes gram1 a function of the carry, and the one SpMBV of the
body acts on AP, whose only dependency is gram1:

  per iteration —
    G     = ZᵀAZ             gram1 on the carry      (t²)
    P, AP = Z C⁻¹, AZ C⁻¹    one ``chol_apply`` launch
    packed = [PᵀR | APᵀAP | AP_oldᵀAP]   gram2       (3t²)  ┐ neither reads
    S     = A · AP           SpMBV                          ┘ the other's output
    X += Pc ; R −= APc ; Z' = AP − Pd − P_old d_old
    AZ'   = S − AP d − AP_old d_old      (A·Z' by linearity: no extra SpMBV)

Init seeds the recurrence with one extra SpMBV (AZ₀ = A·Z₀).  The iterates
are algebraically those of classic; only rounding differs (gram1 consumes
the recurred AZ instead of a fresh product).  Both the reduction and the
SpMBV run on the current stream here, in that order; with
``CommConfig(overlap=True)`` the SpMBV's interior part runs while its halo
exchange replays on a second stream.

Preconditioned, the SpMBV acts on W = M⁻¹AP and the reduction is ``gram2p``
([PᵀR | APᵀW | AP_oldᵀW]); Z' gains W − AP.  Under a policy the factor
apply is ``rank_apply`` and the ``drop_mask`` kernel masks Z' and AZ'
together (A·(Z'·mask) = (A·Z')·mask).  Restart policies are refused: a
plateau re-enlarge reseeds Z from the residual, and rebuilding AZ for it
would need a conditional in-loop SpMBV.

Port of ``repro/core/methods/pipelined.py``; the carry keeps the
reference's keys.  As in the port's classic scheme, ``k``, ``rn`` and ``bd``
are host values and the iteration makes one device-to-host copy (the
residual norm, with the rank and the active count under a policy).  The
AZ recurrence's two (n, t)·(t, t) products are plain ``addmm_`` calls, as
the reference leaves them to XLA.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.adaptive.rankrev import default_rank_rtol
from repro_torch.adaptive.reduce import plateau_update
from repro_torch.core.cg import EV_RECOVERY
from repro_torch.core.methods.base import MethodContext, MethodSpec, _apply_vec, _chol_inv_apply
from repro_torch.kernels.chol_apply.ops import drop_mask, rank_apply


class PipelinedMethod(MethodSpec):
    """Classic reductions, with gram2 independent of the SpMBV."""

    name = "pipelined"
    overlaps_gram = True

    def validate(self, ctx: MethodContext) -> None:
        super().validate(ctx)
        if ctx.policy is not None and ctx.policy.restart:
            raise ValueError(
                "method 'pipelined' cannot run a restart policy: re-enlarging "
                "reseeds Z from the current residual, which would need an "
                "extra in-loop SpMBV to rebuild the AZ recurrence; use "
                "adaptive='reduce' (or method='classic' for restarts)"
            )

    def build(self, ctx: MethodContext):
        t = ctx.t
        max_iters = ctx.max_iters
        policy, use_mask = ctx.policy, ctx.use_mask
        a_apply, a_apply_masked, split_fn = ctx.a_apply, ctx.a_apply_masked, ctx.split_fn
        gram1, gram2, sqnorm, tail = ctx.gram1, ctx.gram2, ctx.sqnorm, ctx.tail
        precond, gram2p = ctx.precond, ctx.gram2p
        chol_eps = ctx.chol_eps

        def iterate(carry):
            big_x, big_r, z, az = carry["X"], carry["R"], carry["Z"], carry["AZ"]
            p_old, ap_old = carry["P"], carry["AP"]
            k = carry["k"]

            g = gram1(z, az)  # reduction #1 (t²); AZ comes from the recurrence
            if policy is None:
                p, ap = _chol_inv_apply(g, z, az, eps=chol_eps)
            else:
                rtol = policy.rank_rtol
                p, ap, rank, _perm = rank_apply(
                    g, z, az, rtol=default_rank_rtol(g.dtype) if rtol is None else rtol
                )
            # reduction #2 (3t²) and the SpMBV read nothing of each other's:
            # packed needs (p, R, ap, ap_old), the product ap (or W)
            if precond is None:
                w = ap
                packed = gram2(p, big_r, ap, ap_old)
            else:
                w = precond(ap, k)
                packed = gram2p(p, big_r, ap, ap_old, w)
            if use_mask:
                s_w = a_apply_masked(w, carry["act"])  # SpMBV, width-compacted
            else:
                s_w = a_apply(w)  # SpMBV
            c, d, d_old = torch.split(packed, t, dim=1)

            big_x, big_r, z_new = tail(big_x, big_r, p, ap, p_old, c, d, d_old)
            if precond is not None:
                z_new = z_new + (w - ap)  # Z' = W − Pd − P_old d_old
            # AZ' = A·Z' = S − AP d − AP_old d_old, in place on S (the
            # SpMBV's fresh output): an out-of-place addmm first copies S
            az_new = s_w.addmm_(ap, d, alpha=-1).addmm_(ap_old, d_old, alpha=-1)
            rsum = big_r.sum(dim=1)
            rn_dev = torch.sqrt(sqnorm(rsum))
            hist = carry["hist"].clone()  # the guard may still keep the old carry
            hist[k + 1] = rn_dev
            if policy is None:
                rn = float(rn_dev)  # the iteration's host sync
            else:
                mask, counts = drop_mask(c, rank, carry["rn"], policy)
                z_new = z_new * mask
                az_new = az_new * mask  # A·(Z'·mask) = (A·Z')·mask
                rn, n_rank, n_active = torch.cat([rn_dev.reshape(1), counts]).tolist()
                n_rank, n_active = int(n_rank), int(n_active)
            out = dict(
                X=big_x, R=big_r, Z=z_new, AZ=az_new, P=p, AP=ap, k=k + 1, rn=rn,
                hist=hist, bd=carry["bd"],
            )
            if policy is not None:
                if use_mask:
                    out["act"] = mask != 0
                best_rn, since = plateau_update(
                    carry["best_rn"].dtype.type(rn), carry["best_rn"], carry["since"], policy
                )
                ahist, evhist = carry["ahist"].copy(), carry["evhist"].copy()
                ahist[k + 1] = n_active
                # pivots accepted below the entering active width: a rank
                # drop the factorization recovered from
                evhist[k + 1] = EV_RECOVERY if n_rank < carry["ahist"][k] else 0
                out.update(best_rn=best_rn, since=since, restarts=carry["restarts"],
                           ahist=ahist, evhist=evhist)
            return out

        def init(b, x0):
            n = b.shape[0]
            zeros_nt = torch.zeros((n, t), dtype=b.dtype, device=b.device)
            r0 = b - _apply_vec(a_apply, x0, t)
            big_r0 = split_fn(r0, t)
            z0 = big_r0 if precond is None else precond(big_r0, 0)
            rn0 = float(torch.sqrt(sqnorm(r0)))
            hist0 = torch.full((max_iters + 1,), float("nan"), dtype=b.dtype, device=b.device)
            hist0[0] = rn0
            carry = dict(X=zeros_nt, R=big_r0, Z=z0,
                         AZ=a_apply(z0),  # seed the recurrence (init-only SpMBV)
                         P=zeros_nt, AP=zeros_nt,
                         k=0, rn=rn0, hist=hist0, bd=not math.isfinite(rn0))
            if policy is not None:
                ahist = np.full(max_iters + 1, -1, np.int32)
                ahist[0] = t
                evhist = np.full(max_iters + 1, -1, np.int32)
                evhist[0] = 0
                carry.update(
                    best_rn=np.dtype(str(b.dtype).removeprefix("torch.")).type(rn0),
                    since=0, restarts=0, ahist=ahist, evhist=evhist,
                )
            if use_mask:
                carry["act"] = torch.ones(t, dtype=torch.bool, device=b.device)
            return carry

        return init, iterate
