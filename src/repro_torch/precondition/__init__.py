"""Preconditioned + flexible ECG: config, operators, and builders (port of
``repro.precondition``)."""

from repro_torch.precondition.build import (
    build_distributed_preconditioner,
    build_sequential_preconditioner,
)
from repro_torch.precondition.chebyshev import estimate_lambda_max, make_chebyshev_apply
from repro_torch.precondition.config import PRECONDITIONS, PreconditionConfig

__all__ = [
    "PRECONDITIONS",
    "PreconditionConfig",
    "build_sequential_preconditioner",
    "build_distributed_preconditioner",
    "estimate_lambda_max",
    "make_chebyshev_apply",
]
