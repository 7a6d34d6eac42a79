"""Dynamic search-direction reduction for ECG (flexible-ECG controller).

Port of ``repro/adaptive/reduce.py``.  Mid-solve, two things erode the
value of a large t:

* **rank deficiency** — the t residual columns become numerically dependent
  (detected by the pivoted factorization in :mod:`repro_torch.adaptive.rankrev`);
* **stagnation** — a direction stops contributing to the error decrease.
  With P A-orthonormal, direction i's share of the A-norm² error drop of one
  iteration is ‖c_{i,:}‖² (c = PᵀR); it is retired when ‖c_{i,:}‖ falls
  below ``drop_tol`` relative to the residual norm.

Shapes stay (n, t) and inactive directions are zero-masked columns, which
flow through the kernels and the reductions unchanged.  A zeroed Z column
yields a zero G row/column, which the rank-revealing factorization keeps
dead.  An optional re-enlarge/restart rebuilds the full t-wide splitting
from the current residual when convergence plateaus with a reduced block.

:func:`stagnation_mask` is the plain torch version on t-sized tensors (the
classic scheme runs it through the ``drop_mask`` kernel op on CUDA tensors);
:func:`plateau_update` works on the host scalars the port's loop carry holds.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ReductionPolicy:
    """Configuration of the in-solve width controller.

    rank_rtol:      pivot threshold of the rank-revealing factorization
                    (None = dtype default).
    drop_tol:       stagnation threshold τ — direction i is retired when
                    ‖c_{i,:}‖ ≤ τ·‖r‖ (None = sqrt(eps) of the solve dtype;
                    0.0 disables stagnation drops).
    min_t:          floor on the active width for stagnation drops.
    restart:        re-enlarge to the full t-wide splitting on a plateau.
    plateau_window: iterations without sufficient progress that count as a
                    plateau.
    plateau_ratio:  progress means rn < plateau_ratio · best_rn.
    """

    rank_rtol: float | None = None
    drop_tol: float | None = None
    min_t: int = 1
    restart: bool = False
    plateau_window: int = 25
    plateau_ratio: float = 0.99

    def resolved_drop_tol(self, dtype: torch.dtype) -> float:
        if self.drop_tol is not None:
            return float(self.drop_tol)
        return math.sqrt(float(torch.finfo(dtype).eps))


#: ``adaptive=`` string shorthands accepted by the solvers.
POLICIES = {
    "rankrev": ReductionPolicy(drop_tol=0.0),
    "reduce": ReductionPolicy(),
    "reduce+restart": ReductionPolicy(restart=True),
}


def resolve_policy(adaptive) -> ReductionPolicy | None:
    """Map the solver's ``adaptive`` argument to a policy (or None = off)."""
    if adaptive is None or adaptive == "off":
        return None
    if isinstance(adaptive, ReductionPolicy):
        return adaptive
    if isinstance(adaptive, str):
        try:
            return POLICIES[adaptive]
        except KeyError:
            raise ValueError(
                f"unknown adaptive mode {adaptive!r}; expected one of "
                f"{sorted(POLICIES)}, 'off', None, or a ReductionPolicy"
            ) from None
    raise TypeError(f"adaptive must be str/None/ReductionPolicy, got {type(adaptive)}")


def stagnation_mask(c: torch.Tensor, rn, active: torch.Tensor, policy: ReductionPolicy):
    """Apply the flexible-ECG drop criterion; returns the shrunk column mask.

    c:      (t, t) step coefficients PᵀR of this iteration (rows = directions,
            in the same pivot order as the ``active`` mask).
    rn:     residual norm the scores are compared against (a host float or a
            0-dim tensor).
    active: (t,) bool mask from the rank-revealing factorization.

    At most ``n_active − min_t`` directions are dropped per iteration (the
    lowest-scoring ones first).  The sorts are stable, as ``jnp.argsort``.
    """
    tau = policy.resolved_drop_tol(c.dtype)
    if tau == 0.0:
        return active
    scores = torch.sum(c * c, dim=1)  # ΔE_A² attributable to direction i
    stagnant = scores <= torch.tensor(tau, dtype=c.dtype, device=c.device) ** 2 * rn * rn
    max_drops = torch.clamp(torch.sum(active) - policy.min_t, min=0)
    # ascending rank of each direction's score among the active ones;
    # inactive directions sort last and are never "dropped" again
    order = torch.argsort(torch.where(active, scores, torch.inf), stable=True)
    pos = torch.argsort(order, stable=True)
    drop = active & stagnant & (pos < max_drops)
    return active & ~drop


def plateau_update(rn, best_rn, since_best: int, policy: ReductionPolicy):
    """Track progress for the restart trigger; returns (best_rn, since_best).

    ``rn`` and ``best_rn`` are host scalars; numpy scalars of the solve's
    dtype (as the classic scheme passes) keep the reference's arithmetic in
    that dtype, ``plateau_ratio`` included.
    """
    improved = rn < policy.plateau_ratio * best_rn
    return np.minimum(best_rn, rn), 0 if improved else since_best + 1
