"""Primary public API: build-once / solve-many ECG solver handles (port of
``repro.solver``, sequential path).

    from repro_torch.solver import ECGSolver, SolverConfig

    solver = ECGSolver.build(a, config=SolverConfig(t=8, tol=1e-8), device="cuda")
    res = solver.solve(b)
"""

from repro_torch.precondition.config import PreconditionConfig
from repro_torch.solver.config import (
    AdaptiveConfig,
    CommConfig,
    KernelConfig,
    MethodConfig,
    SolverConfig,
    TuneConfig,
)
from repro_torch.solver.handle import ECGSolver, SolverStats

__all__ = [
    "AdaptiveConfig",
    "CommConfig",
    "KernelConfig",
    "MethodConfig",
    "PreconditionConfig",
    "SolverConfig",
    "TuneConfig",
    "ECGSolver",
    "SolverStats",
]
