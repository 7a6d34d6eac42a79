"""The in-solve width controller's policy type (port of
``repro/adaptive/reduce.py``, configuration half only).

The port carries :class:`ReductionPolicy` and :func:`resolve_policy` so that
:class:`~repro_torch.solver.config.SolverConfig` validates and serialises
exactly like the reference; running a policy (rank-revealing factorization,
stagnation drops, restart) is ROADMAP.md queue 1 item 6.
"""

from __future__ import annotations

import dataclasses


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
