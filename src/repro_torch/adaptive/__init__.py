"""Adaptive ECG (port of ``repro.adaptive``): breakdown-safe factorization
and the in-solve width controller.

* :mod:`repro_torch.adaptive.rankrev` — pivoted, rank-revealing Cholesky of
  the Gram matrix G = ZᵀAZ; reveals the numerical rank and a column mask so
  the solver drops dependent directions instead of propagating NaNs.
* :mod:`repro_torch.adaptive.reduce` — the reduction controller (static
  (n, t) shapes, zero-masked columns): stagnation drops per the flexible-ECG
  criterion, optional re-enlarge/restart on a residual plateau.
* :mod:`repro_torch.adaptive.groups` — the packed multi-RHS layout.
* :mod:`repro_torch.adaptive.select_t` — ``t="auto"``: an
  iterations-to-convergence model (probe- or condition-calibrated) composed
  with :mod:`repro_torch.tune`'s per-iteration cost model to rank candidate
  widths at setup time.

Entry points: ``ECGSolver.build(..., config=SolverConfig(adaptive="reduce"))``,
``SolverConfig(t="auto")`` and ``python -m repro_torch.launch.solve
--adaptive reduce`` / ``--t auto``.
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
from repro_torch.adaptive.select_t import (
    DEFAULT_CANDIDATES,
    TSelection,
    estimate_condition,
    iteration_cost,
    iters_from_condition,
    probe_decay_rate,
    resolve_auto_t,
    select_t,
    tselection_from_dict,
    tselection_to_dict,
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
    "DEFAULT_CANDIDATES",
    "TSelection",
    "estimate_condition",
    "iteration_cost",
    "iters_from_condition",
    "probe_decay_rate",
    "resolve_auto_t",
    "select_t",
    "tselection_from_dict",
    "tselection_to_dict",
]
