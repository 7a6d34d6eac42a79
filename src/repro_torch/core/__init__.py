"""Core: the ECG engine, node-aware exchange planning and the paper's
performance models (port of ``repro.core``)."""

from repro_torch.core.cg import SolveResult, cg_solve
from repro_torch.core.ecg import (
    ECGOperationCounts,
    ECGRunner,
    ecg_solve,
    finalize_result,
    make_ecg_runner,
)
from repro_torch.core.enlarging import collapse, split_rank, split_residual
from repro_torch.core.machines import H100, MACHINES, MachineParams
from repro_torch.core.methods import METHODS, MethodSpec, get_method
from repro_torch.core.node_aware import ExchangePlan, build_exchange_plan, simulate_plan

__all__ = [
    "cg_solve",
    "ecg_solve",
    "SolveResult",
    "ECGOperationCounts",
    "ECGRunner",
    "finalize_result",
    "make_ecg_runner",
    "METHODS",
    "MethodSpec",
    "get_method",
    "split_residual",
    "split_rank",
    "collapse",
    "H100",
    "MachineParams",
    "MACHINES",
    "ExchangePlan",
    "build_exchange_plan",
    "simulate_plan",
]
