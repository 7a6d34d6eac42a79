"""Performance models from the paper (eqs. 2.5–2.8, 3.1–3.4, 4.2–4.4).

Every function returns seconds.  ``g`` is a :class:`CommGraph` (exact message
statistics measured from a partitioned matrix), ``machine`` a
:class:`MachineParams`, ``t`` the enlarging factor.

Port of ``repro/core/models.py``, line for line: the same formulas in the
same order of operations, so every modeled time equals the reference's.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core.comm_graph import CommGraph, OptimalPlan, build_optimal_plan
from repro_torch.core.ecg import ECGOperationCounts
from repro_torch.core.machines import MachineParams


# ---------------------------------------------------------------- primitives
def postal(alpha: float, rate: float, m: float, s: float) -> float:
    """Standard postal model T = α·m + s/R   (eq. 2.6)."""
    return alpha * m + s / rate


def max_rate(machine: MachineParams, m: float, s: float, ppn: int | None = None) -> float:
    """Max-rate model T = α·m + max(ppn·s/R_N, s/R_b)   (eq. 2.5)."""
    ppn = machine.ppn if ppn is None else ppn
    return machine.alpha * m + max(ppn * s / machine.R_N, s / machine.R_b)


# ------------------------------------------------------- SpMBV p2p exchange
def t_standard_postal(g: CommGraph, t: int, machine: MachineParams) -> float:
    """Postal p2p term of eq. (3.1): α·m + s·t/R_b."""
    s = g.s_standard_rows * g.row_block * machine.f
    return postal(machine.alpha, machine.R_b, g.m_standard, s * t)


def t_standard(g: CommGraph, t: int, machine: MachineParams) -> float:
    """Max-rate p2p term of eq. (3.2): α·m + max(ppn·s·t/R_N, s·t/R_b)."""
    s = g.s_standard_rows * g.row_block * machine.f
    return max_rate(machine, g.m_standard, s * t, ppn=g.ppn)


def t_2step(g: CommGraph, t: int, machine: MachineParams) -> float:
    """2-step node-aware model with block factor t (eq. 4.2)."""
    f = machine.f * g.row_block
    s_node = g.s_node_rows * f
    s_proc = g.s_proc_rows * f
    inter = machine.alpha * g.m_proc_to_node + max(
        t * s_node / machine.R_N, t * s_proc / machine.R_b
    )
    intra = machine.alpha_l * (g.ppn - 1) + t * s_proc / machine.R_bl
    return inter + intra


def t_3step(g: CommGraph, t: int, machine: MachineParams) -> float:
    """3-step node-aware model with block factor t (eq. 4.3)."""
    f = machine.f * g.row_block
    s_node = g.s_node_rows * f
    s_proc = g.s_proc_3step_rows * f
    s_nn = g.s_node_to_node_rows * f
    inter = machine.alpha * g.m_node_to_node / g.ppn + max(
        t * s_node / machine.R_N, t * s_proc / machine.R_b
    )
    intra = 2 * (machine.alpha_l * (g.ppn - 1) + t * s_nn / machine.R_bl)
    return inter + intra


def t_optimal(
    g: CommGraph, t: int, machine: MachineParams, plan: OptimalPlan | None = None
) -> float:
    """Nodal-optimal model (§4.3): plan-derived message counts/sizes, bounded
    by eq. (4.4)."""
    plan = plan or build_optimal_plan(g, t, machine)
    f = machine.f * g.row_block
    s_node = g.s_node_rows * f * t  # bytes injected are dedup'd — same as 2-/3-step
    inter = machine.alpha * plan.max_msgs + max(
        s_node / machine.R_N, plan.max_bytes / machine.R_b
    )
    intra = 2 * (
        machine.alpha_l * (g.ppn - 1) + plan.intra_moved.max(initial=0) / machine.R_bl
    )
    return inter + intra


STRATEGIES = ("standard", "2step", "3step", "optimal")


def t_p2p(g: CommGraph, t: int, machine: MachineParams, strategy: str) -> float:
    return {
        "standard": t_standard,
        "2step": t_2step,
        "3step": t_3step,
        "optimal": t_optimal,
    }[strategy](g, t, machine)


def tune_strategy(g: CommGraph, t: int, machine: MachineParams) -> tuple[str, dict[str, float]]:
    """Paper §4.3 'tuning': evaluate all strategies, return (best, all-times).

    On the real machine this is four trial SpMBVs at communicator-setup time;
    here the same decision is made from the measured comm statistics + model.
    """
    times = {s: t_p2p(g, t, machine, s) for s in STRATEGIES}
    best = min(times, key=times.get)
    return best, times


# ----------------------------------------------------------- ECG iteration
def t_collective_n(
    p: int, machine: MachineParams, n_collectives: float, payload_floats: float
) -> float:
    """Generalized collective term: n·α·log(p) latency legs + f·payload/R_b.

    The classic scheme's eq. (3.1)/(3.2) term is the (2, 4t²) instance; the
    pluggable iteration schemes (:mod:`repro_torch.core.methods`) charge their own
    (psums-per-block, payload) pairs through the same shape — see
    ``repro_torch.tune.method_sync_cost``.
    """
    return (
        n_collectives * machine.alpha * math.log2(max(p, 2))
        + machine.f * payload_floats / machine.R_b
    )


def t_collective(p: int, t: int, machine: MachineParams) -> float:
    """Collective term of eqs. (3.1)/(3.2): 2·α·log(p) + f·4t²/R_b."""
    return t_collective_n(p, machine, 2, 4 * t * t)


def t_computation(counts: ECGOperationCounts, machine: MachineParams) -> float:
    """Computation model, eq. (3.3)."""
    return machine.gamma * counts.total_flops


def t_ecg_iteration(
    g: CommGraph,
    counts: ECGOperationCounts,
    machine: MachineParams,
    strategy: str = "standard",
) -> "ECGIterationModel":
    """Full per-iteration model, eq. (3.4), with selectable p2p strategy."""
    return ECGIterationModel(
        p2p=t_p2p(g, counts.t, machine, strategy),
        collective=t_collective(counts.p, counts.t, machine),
        computation=t_computation(counts, machine),
    )


@dataclasses.dataclass(frozen=True)
class ECGIterationModel:
    p2p: float
    collective: float
    computation: float

    @property
    def total(self) -> float:
        return self.p2p + self.collective + self.computation

    @property
    def p2p_fraction(self) -> float:
        return self.p2p / self.total

    def as_dict(self) -> dict[str, float]:
        return dict(
            p2p=self.p2p,
            collective=self.collective,
            computation=self.computation,
            total=self.total,
            p2p_fraction=self.p2p_fraction,
        )


# -------------------------------------------- ping / split curves (Fig 4.6/4.7)
def ping_time(machine: MachineParams, nbytes: float, where: str, active: int = 1) -> float:
    """Time to move ``nbytes`` between two processes.

    where: 'socket' | 'node' | 'network'.  ``active`` = concurrently
    communicating processes (drives the injection limit, Fig 4.6).
    """
    if where == "socket":
        return machine.alpha_l + nbytes / machine.R_bl
    if where == "node":
        # cross-socket on-node: ~2x the latency, somewhat lower bandwidth
        return 2 * machine.alpha_l + nbytes / (0.6 * machine.R_bl)
    if where == "network":
        return machine.alpha + max(active * nbytes / machine.R_N, nbytes / machine.R_b)
    raise ValueError(where)


def split_send_time(machine: MachineParams, nbytes: float, ppn: int) -> float:
    """Time to move ``nbytes`` node-to-node split across ppn processes (Fig 4.7)."""
    share = nbytes / ppn
    return machine.alpha + max(nbytes / machine.R_N, share / machine.R_b)
