"""The paper's §3.1 ECG iteration — two fused reductions per iteration.

  per iteration —
    AZ   = A * Z                          SpMBV
    G    = ZᵀAZ                           gram1             (t²)
    P    = Z C⁻¹ ;  AP = AZ C⁻¹           local chol + TRSMs
    [PᵀR | APᵀAP | AP_oldᵀAP]             gram2             (3t²)
    X   += P c ;  R -= AP c ;  Z = AP − P d − P_old d_old

With a preconditioner M⁻¹ₖ the directions come from W = M⁻¹AP:

    W    = M⁻¹AP                          preconditioner apply
    [PᵀR | APᵀW | AP_oldᵀW]               gram2p            (3t², in place of gram2)
    Z    = W − P d − P_old d_old          (the tail's Z + (W − AP))

and, with ``precond_reseed``, every that-many iterations Z restarts from
M⁻¹R.  The start is Z₀ = M⁻¹T(r₀).

With an adaptive ``policy`` (:class:`~repro_torch.adaptive.ReductionPolicy`)
the factor apply is the rank-revealing one: G is factored with diagonal
pivoting and the dependent directions come out as zero columns of P and AP
instead of NaNs; after the tail, the flexible-ECG stagnation drop retires
directions whose step coefficients stalled and zeroes their Z columns; with
``policy.restart`` a residual plateau on a reduced block rebuilds R and Z
from the full t-wide splitting of the current residual.

Port of ``repro/core/methods/classic.py`` on its single-request path
(``groups=None``; the packed multi-RHS retirement is ROADMAP.md queue 1
item 10); the carry keeps the reference's keys.  ``k`` and ``bd`` are host
ints/bools and ``rn`` a host float (see
:func:`repro_torch.core.cg._guarded_while`); ``evhist`` and ``ahist`` are
host arrays, ``best_rn`` a numpy scalar of the solve's dtype.  The
iteration keeps exactly one device-to-host copy: with a policy the rank and
the active count ride the residual norm's.  The reference evaluates the
reseed apply and the restart every iteration and keeps them where they
fire (``jnp.where``); the port computes them only there, which gives the
same iterates.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.adaptive.rankrev import default_rank_rtol
from repro_torch.adaptive.reduce import plateau_update
from repro_torch.core.cg import EV_RECOVERY, EV_RESEED
from repro_torch.core.methods.base import MethodContext, MethodSpec, _apply_vec, _chol_inv_apply
from repro_torch.kernels.chol_apply.ops import drop_mask, rank_apply


class ClassicMethod(MethodSpec):
    """Two-reduction Grigori–Tissot ECG (Algorithms 1–3)."""

    name = "classic"

    def build(self, ctx: MethodContext):
        t = ctx.t
        max_iters = ctx.max_iters
        policy, use_mask = ctx.policy, ctx.use_mask
        a_apply, a_apply_masked, split_fn = ctx.a_apply, ctx.a_apply_masked, ctx.split_fn
        gram1, gram2, sqnorm, tail = ctx.gram1, ctx.gram2, ctx.sqnorm, ctx.tail
        precond, gram2p = ctx.precond, ctx.gram2p
        reseed = ctx.precond_reseed if precond is not None else None
        # record rank-revealing drops (EV_RECOVERY) and flexible reseeds
        # (EV_RESEED) per iteration whenever either mechanism runs
        track_events = policy is not None or reseed is not None

        def iterate(carry):
            big_x, big_r, z = carry["X"], carry["R"], carry["Z"]
            p_old, ap_old = carry["P"], carry["AP"]
            k = carry["k"]

            if use_mask:
                az = a_apply_masked(z, carry["act"])  # width-compacted SpMBV
            else:
                az = a_apply(z)  # SpMBV
            g = gram1(z, az)  # reduction #1: t² floats
            ev = 0
            if policy is None:
                p, ap = _chol_inv_apply(g, z, az)  # local chol + TRSMs
            else:
                # pivoted rank-revealing factorization: dependent directions
                # come out as zero-masked columns instead of NaNs; the rank
                # stays on the device until the iteration's one host copy
                rtol = policy.rank_rtol
                p, ap, rank, _perm = rank_apply(
                    g, z, az, rtol=default_rank_rtol(g.dtype) if rtol is None else rtol
                )
            if precond is None:
                packed = gram2(p, big_r, ap, ap_old)  # reduction #2: 3t² floats
            else:
                # preconditioned recurrence: d = APᵀW and d_old = AP_oldᵀW
                # ride the same single reduction as c = PᵀR
                w = precond(ap, k)
                packed = gram2p(p, big_r, ap, ap_old, w)  # reduction #2
            c, d, d_old = torch.split(packed, t, dim=1)
            # fused tail: X += Pc, R -= APc, Z = AP − Pd − P_old d_old
            big_x, big_r, z_new = tail(big_x, big_r, p, ap, p_old, c, d, d_old)
            if precond is not None:
                # Z = W − Pd − P_old d_old = tail's Z + (W − AP)
                z_new = z_new + (w - ap)
            if reseed is not None:
                # flexible restart from the preconditioned updated residual
                if (k + 1) % reseed == 0:
                    z_new = precond(big_r, k + 1)
                    ev |= EV_RESEED
            rsum = big_r.sum(dim=1)
            rn_dev = torch.sqrt(sqnorm(rsum))
            hist = carry["hist"].clone()  # the guard may still keep the old carry
            hist[k + 1] = rn_dev  # a device-to-device copy: no host value goes back
            if policy is None:
                rn = float(rn_dev)  # the iteration's host sync
            else:
                # flexible-ECG stagnation drops on the directions the
                # factorization kept; a zeroed Z column stays dead (its G
                # row/column is zero next iteration)
                mask, counts = drop_mask(c, rank, carry["rn"], policy)
                z_new = z_new * mask
                # the iteration's host sync: the residual norm, the rank and
                # the active count in one copy
                rn, n_rank, n_active = torch.cat([rn_dev.reshape(1), counts]).tolist()
                n_rank, n_active = int(n_rank), int(n_active)
                # fewer accepted pivots than live entering directions = a
                # rank drop the factorization just recovered from
                if n_rank < carry["ahist"][k]:
                    ev |= EV_RECOVERY
            out = dict(
                X=big_x, R=big_r, Z=z_new, P=p, AP=ap, k=k + 1, rn=rn, hist=hist,
                bd=carry["bd"],
            )
            if track_events:
                evhist = carry["evhist"].copy()
                evhist[k + 1] = ev
                out["evhist"] = evhist
            if policy is not None:
                if use_mask:
                    out["act"] = mask != 0
                best_rn, since = plateau_update(
                    carry["best_rn"].dtype.type(rn), carry["best_rn"], carry["since"], policy
                )
                restarts = carry["restarts"]
                if policy.restart and since >= policy.plateau_window and n_active < t:
                    # re-enlarge: rebuild the full t-wide splitting from the
                    # current residual when progress plateaus on a reduced block
                    fresh = split_fn(rsum, t)
                    out.update(R=fresh, Z=fresh, P=torch.zeros_like(p), AP=torch.zeros_like(ap))
                    n_active, since, restarts = t, 0, restarts + 1
                    best_rn = carry["best_rn"].dtype.type(rn)
                ahist = carry["ahist"].copy()
                ahist[k + 1] = n_active
                out.update(best_rn=best_rn, since=since, restarts=restarts, ahist=ahist)
            return out

        def init(b, x0):
            n = b.shape[0]
            zeros_nt = torch.zeros((n, t), dtype=b.dtype, device=b.device)
            r0 = b - _apply_vec(a_apply, x0, t)  # initial SpMV (Alg 3 line 1)
            big_r0 = split_fn(r0, t)
            # preconditioned start: Z₀ = M⁻¹T(r₀); R stays the true residual
            z0 = big_r0 if precond is None else precond(big_r0, 0)
            rn0 = float(torch.sqrt(sqnorm(r0)))
            hist0 = torch.full((max_iters + 1,), float("nan"), dtype=b.dtype, device=b.device)
            hist0[0] = rn0
            carry = dict(X=zeros_nt, R=big_r0, Z=z0, P=zeros_nt, AP=zeros_nt,
                         k=0, rn=rn0, hist=hist0, bd=not math.isfinite(rn0))
            if policy is not None:
                ahist = np.full(max_iters + 1, -1, np.int32)
                ahist[0] = t
                carry.update(
                    best_rn=np.dtype(str(b.dtype).removeprefix("torch.")).type(rn0),
                    since=0, restarts=0, ahist=ahist,
                )
            if track_events:
                carry["evhist"] = np.full(max_iters + 1, -1, np.int32)
                carry["evhist"][0] = 0
            if use_mask:
                carry["act"] = torch.ones(t, dtype=torch.bool, device=b.device)
            return carry

        return init, iterate
