"""Core: the ECG engine (port of ``repro.core``, sequential classic path)."""

from repro_torch.core.cg import SolveResult
from repro_torch.core.ecg import ECGRunner, finalize_result, make_ecg_runner
from repro_torch.core.enlarging import collapse, split_residual
from repro_torch.core.methods import METHODS, MethodSpec, get_method

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
]
