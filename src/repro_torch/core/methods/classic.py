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

Port of ``repro/core/methods/classic.py`` on its fixed-width,
single-request path (``policy=None``, ``groups=None``); the carry keeps the
reference's keys.  ``k`` and ``bd`` are host ints/bools and ``rn`` a host
float (see :func:`repro_torch.core.cg._guarded_while`); ``evhist`` is a
host array.  The reference evaluates the reseed apply every iteration and
keeps it on reseed iterations (``jnp.where``); the port applies it only on
reseed iterations, which gives the same iterates.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.cg import EV_RESEED
from repro_torch.core.methods.base import MethodContext, MethodSpec, _apply_vec, _chol_inv_apply


class ClassicMethod(MethodSpec):
    """Two-reduction Grigori–Tissot ECG (Algorithms 1–3)."""

    name = "classic"

    def build(self, ctx: MethodContext):
        t = ctx.t
        max_iters = ctx.max_iters
        a_apply, split_fn = ctx.a_apply, ctx.split_fn
        gram1, gram2, sqnorm, tail = ctx.gram1, ctx.gram2, ctx.sqnorm, ctx.tail
        precond, gram2p = ctx.precond, ctx.gram2p
        reseed = ctx.precond_reseed if precond is not None else None

        def iterate(carry):
            big_x, big_r, z = carry["X"], carry["R"], carry["Z"]
            p_old, ap_old = carry["P"], carry["AP"]
            k = carry["k"]

            az = a_apply(z)  # SpMBV
            g = gram1(z, az)  # reduction #1: t² floats
            p, ap = _chol_inv_apply(g, z, az)  # local chol + TRSMs
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
                do_rs = (k + 1) % reseed == 0
                if do_rs:
                    z_new = precond(big_r, k + 1)
                evhist = carry["evhist"].copy()  # the guard may keep the old carry
                evhist[k + 1] = EV_RESEED if do_rs else 0
            rn = float(torch.sqrt(sqnorm(big_r.sum(dim=1))))  # the iteration's host sync
            hist = carry["hist"].clone()  # the guard may still keep the old carry
            hist[k + 1] = rn
            out = dict(
                X=big_x, R=big_r, Z=z_new, P=p, AP=ap, k=k + 1, rn=rn, hist=hist,
                bd=carry["bd"],
            )
            if reseed is not None:
                out["evhist"] = evhist
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
            if reseed is not None:
                carry["evhist"] = np.full(max_iters + 1, -1, np.int32)
                carry["evhist"][0] = 0
            return carry

        return init, iterate
