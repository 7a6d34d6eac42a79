"""Adaptive ECG (port of ``repro.adaptive``): breakdown-safe factorization
and the in-solve width controller.

* :mod:`repro_torch.adaptive.rankrev` — pivoted, rank-revealing Cholesky of
  the Gram matrix G = ZᵀAZ; reveals the numerical rank and a column mask so
  the solver drops dependent directions instead of propagating NaNs.
* :mod:`repro_torch.adaptive.reduce` — the reduction controller (static
  (n, t) shapes, zero-masked columns): stagnation drops per the flexible-ECG
  criterion, optional re-enlarge/restart on a residual plateau.
* :mod:`repro_torch.adaptive.groups` — the packed multi-RHS layout.

Entry points: ``ECGSolver.build(..., config=SolverConfig(adaptive="reduce"))``
and ``python -m repro_torch.launch.solve --adaptive reduce``.  ``t="auto"``
(``select_t``) is ROADMAP.md queue 1 item 6b.
"""

from repro_torch.adaptive.groups import GroupSpec
from repro_torch.adaptive.rankrev import (
    default_rank_rtol,
    pivoted_cholesky,
    rank_revealing_apply,
)
from repro_torch.adaptive.reduce import (
    POLICIES,
    ReductionPolicy,
    plateau_update,
    resolve_policy,
    stagnation_mask,
)

__all__ = [
    "GroupSpec",
    "default_rank_rtol",
    "pivoted_cholesky",
    "rank_revealing_apply",
    "POLICIES",
    "ReductionPolicy",
    "plateau_update",
    "resolve_policy",
    "stagnation_mask",
]
