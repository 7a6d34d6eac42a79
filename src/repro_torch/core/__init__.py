"""Core: the ECG engine and node-aware exchange planning (port of ``repro.core``,
classic method)."""

from repro_torch.core.cg import SolveResult
from repro_torch.core.ecg import ECGRunner, finalize_result, make_ecg_runner
from repro_torch.core.enlarging import collapse, split_residual
from repro_torch.core.machines import MACHINES, MachineParams
from repro_torch.core.methods import METHODS, MethodSpec, get_method
from repro_torch.core.node_aware import ExchangePlan, build_exchange_plan, simulate_plan

__all__ = [
    "SolveResult",
    "ECGRunner",
    "finalize_result",
    "make_ecg_runner",
    "METHODS",
    "MethodSpec",
    "get_method",
    "split_residual",
    "collapse",
    "MachineParams",
    "MACHINES",
    "ExchangePlan",
    "build_exchange_plan",
    "simulate_plan",
]
