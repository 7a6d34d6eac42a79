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

With ``groups`` (a :class:`~repro_torch.adaptive.GroupSpec`) the scheme is
a *packed* multi-RHS solve: request j owns the column slab [j·t′, (j+1)·t′),
each group's residual norm (the sum of its own R slab) rides one
``sqnorm_cols`` reduction in place of ``sqnorm``, and a group that meets
its tolerance retires: its R slab is zeroed (its X freezes) and the pack
restarts at t′ columns per live group (see ``restart_live``).

Retirement departs from the reference.  The reference keeps the search
directions and drops the trailing pivot directions down to a budget of t′
per live group; a dropped direction is never searched again (the direction
chain never re-reads R), so the live requests stall: on
``dg_laplace_2d((16, 12), block=8)`` at t′ = 4 its pack of four requests
(tolerances 1e-4, 1e-6, 1e-8, 1e-8 × ‖b_j‖) retires the first after 35
iterations and leaves the other three unconverged at ``max_iters`` = 400,
where each request alone takes 94–97 and the port's pack retires them
after 48, 73 and 74 (``tests/test_torch_serve.py``).
The port restarts instead, as the reference's ``reduce+restart`` policy
does on a plateau: each live group's residual is split afresh into its
slab of R, Z = R and P = AP = 0; the retired slabs are zero, so the
exchange carries t′ columns per live group from the next iteration on.
Up to and including the first retirement the two agree.

Port of ``repro/core/methods/classic.py``; the carry keeps the reference's
keys.  ``k`` and ``bd`` are host ints/bools and ``rn`` a host float (see
:func:`repro_torch.core.cg._guarded_while`); ``evhist``, ``ahist`` and, in
group mode, ``grp_iter`` (-1 while live, else the retirement iteration)
and ``grp_rn_host`` (the groups' norms) are host arrays, ``best_rn`` a
numpy scalar of the solve's dtype; ``grp_rn``, ``grp_live`` and
``grp_hist`` stay on the device.  The iteration keeps exactly one
device-to-host copy: with a policy the rank and the active count ride the
residual norm's, and in group mode so do the per-group norms and live
flags.  The reference
evaluates the reseed apply and the restart every iteration and keeps them
where they fire (``jnp.where``); the port computes them only there, which
gives the same iterates.
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
        groups, sqnorm_cols = ctx.groups, ctx.sqnorm_cols
        # record rank-revealing drops (EV_RECOVERY) and flexible reseeds
        # (EV_RESEED) per iteration whenever either mechanism runs
        track_events = policy is not None or reseed is not None

        def group_norms(big_r, carry):
            """Per-group convergence of a packed solve (device work only).

            The per-column residual invariant of the splitting makes group
            j's true residual the sum of its own column slab; its norm rides
            ONE reduction of g floats (``sqnorm_cols``) in place of the
            scalar ``sqnorm``.  Returns the groups' residuals (n, g), their
            norms (retired groups carry their retirement-time norm forward),
            their live flags after this iteration's retirements, and the
            stacked norm over groups (the guard and history scalar: a
            breakdown's NaN propagates through it)."""
            g_n, te = groups.n_groups, groups.t_each
            rsum_g = big_r.reshape(big_r.shape[0], g_n, te).sum(dim=2)
            grp_sq = sqnorm_cols(rsum_g)  # the iteration's ONE norm reduction
            live_prev = carry["grp_live"]
            grp_rn = torch.where(live_prev, torch.sqrt(grp_sq), carry["grp_rn"])
            grp_live = live_prev & ~(grp_rn <= tols_of(grp_rn))
            return rsum_g, grp_rn, grp_live, torch.sqrt(torch.sum(grp_rn * grp_rn))

        def restart_live(rsum_g, grp_live, like):
            """The restart at a retirement: each live group's residual split
            afresh into its slab (T_{r,t′}, the start's splitting), the
            retired slabs zero; returns R = Z and zero P, AP.  A retired
            slab stays zero after it (c = PᵀR has zero columns there, so
            R − AP·c keeps them and X + P·c freezes them), and so do the
            directions past the live width (P and AP have zero columns
            there, hence Z = AP − P·d − P_old·d_old too)."""
            g_n, te = groups.n_groups, groups.t_each
            fresh = torch.cat([split_fn(rsum_g[:, j], te) for j in range(g_n)], dim=1)
            fresh = fresh * grp_live.repeat_interleave(te).to(fresh.dtype)[None, :]
            return fresh, fresh, torch.zeros_like(like), torch.zeros_like(like)

        tols_cache = {}

        def tols_of(like):
            """The groups' tolerances on ``like``'s device, in its dtype
            (built once)."""
            key = (like.device, like.dtype)
            if key not in tols_cache:
                tols_cache[key] = torch.tensor(groups.tols, dtype=like.dtype, device=like.device)
            return tols_cache[key]

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
            if groups is None:
                rsum = big_r.sum(dim=1)
                rn_dev = torch.sqrt(sqnorm(rsum))
            else:
                rsum_g, grp_rn, grp_live, rn_dev = group_norms(big_r, carry)
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
                act = mask != 0
                if groups is None:
                    # the iteration's host sync: the residual norm, the rank
                    # and the active count in one copy
                    rn, n_rank, n_active = torch.cat([rn_dev.reshape(1), counts]).tolist()
                else:
                    # the iteration's host sync: the stacked norm, the rank,
                    # the active count, and the groups' norms and live
                    # flags, in one copy
                    g_n = groups.n_groups
                    rn, n_rank, n_active, *vals = torch.cat([
                        rn_dev.reshape(1), counts, grp_rn, grp_live.to(rn_dev.dtype)]).tolist()
                    live_now = np.asarray(vals[g_n:]) != 0
                    newly = (carry["grp_iter"] < 0) & ~live_now
                    grp_iter = carry["grp_iter"].copy()
                    grp_iter[newly] = k + 1
                    grp_hist = carry["grp_hist"].clone()
                    grp_hist[k + 1] = grp_rn
                    if newly.any():  # a retirement: restart at the live width
                        big_r, z_new, p, ap = restart_live(rsum_g, grp_live, p)
                        act = grp_live.repeat_interleave(groups.t_each)
                        n_active = groups.t_each * int(live_now.sum())
                n_rank, n_active = int(n_rank), int(n_active)
                # fewer accepted pivots than live entering directions = a
                # rank drop the factorization just recovered from
                if n_rank < carry["ahist"][k]:
                    ev |= EV_RECOVERY
            out = dict(
                X=big_x, R=big_r, Z=z_new, P=p, AP=ap, k=k + 1, rn=rn, hist=hist,
                bd=carry["bd"],
            )
            if groups is not None:
                out.update(grp_rn=grp_rn, grp_live=grp_live, grp_iter=grp_iter,
                           grp_hist=grp_hist, grp_rn_host=vals[:g_n])
            if track_events:
                evhist = carry["evhist"].copy()
                evhist[k + 1] = ev
                out["evhist"] = evhist
            if policy is not None:
                if use_mask:
                    out["act"] = act
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
            if groups is None:
                r0 = b - _apply_vec(a_apply, x0, t)  # initial SpMV (Alg 3 line 1)
                big_r0 = split_fn(r0, t)
                # preconditioned start: Z₀ = M⁻¹T(r₀); R stays the true residual
                z0 = big_r0 if precond is None else precond(big_r0, 0)
                rn0 = float(torch.sqrt(sqnorm(r0)))
                w0 = t
            else:
                # packed start: b/x0 are (n, g); group j's initial guess rides
                # column j·t′ of one full-width SpMBV (one apply for all k
                # requests), and its residual is split at the per-group width
                # t′ into its own column slab
                g_n, te = groups.n_groups, groups.t_each
                offs = torch.arange(g_n, device=b.device) * te
                x0w = zeros_nt.clone()
                x0w[:, offs] = x0
                r0 = b - a_apply(x0w)[:, offs]  # (n, g) per-request residuals
                big_r0 = torch.cat([split_fn(r0[:, j], te) for j in range(g_n)], dim=1)
                grp_rn0 = torch.sqrt(sqnorm_cols(r0))
                # a request already at its tolerance retires at iteration 0
                grp_live0 = grp_rn0 > tols_of(grp_rn0)
                live_cols0 = grp_live0.repeat_interleave(te)
                colf = live_cols0.to(b.dtype)[None, :]
                big_r0 = big_r0 * colf
                z0 = big_r0 if precond is None else precond(big_r0, 0) * colf
                # the start's one host copy: the stacked norm, the groups'
                # norms and live flags
                rn0, *vals = torch.cat([torch.sqrt(torch.sum(grp_rn0 * grp_rn0)).reshape(1),
                                        grp_rn0, grp_live0.to(b.dtype)]).tolist()
                live0 = np.asarray(vals[g_n:]) != 0
                w0 = te * int(live0.sum())
            hist0 = torch.full((max_iters + 1,), float("nan"), dtype=b.dtype, device=b.device)
            hist0[0] = rn0
            carry = dict(X=zeros_nt, R=big_r0, Z=z0, P=zeros_nt, AP=zeros_nt,
                         k=0, rn=rn0, hist=hist0, bd=not math.isfinite(rn0))
            if groups is not None:
                grp_hist0 = torch.full((max_iters + 1, g_n), float("nan"), dtype=b.dtype,
                                       device=b.device)
                grp_hist0[0] = grp_rn0
                carry.update(grp_rn=grp_rn0, grp_live=grp_live0,
                             grp_iter=np.where(live0, -1, 0).astype(np.int32),
                             grp_hist=grp_hist0, grp_rn_host=vals[:g_n])
            if policy is not None:
                ahist = np.full(max_iters + 1, -1, np.int32)
                ahist[0] = w0
                carry.update(
                    best_rn=np.dtype(str(b.dtype).removeprefix("torch.")).type(rn0),
                    since=0, restarts=0, ahist=ahist,
                )
            if track_events:
                carry["evhist"] = np.full(max_iters + 1, -1, np.int32)
                carry["evhist"][0] = 0
            if use_mask:
                carry["act"] = (torch.ones(t, dtype=torch.bool, device=b.device) if groups is None
                                else live_cols0)
            return carry

        return init, iterate
