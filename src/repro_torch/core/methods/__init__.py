"""Pluggable ECG iteration schemes (classic / pipelined / s-step)."""

from __future__ import annotations

from repro_torch.core.methods.base import MethodContext, MethodSpec
from repro_torch.core.methods.classic import ClassicMethod
from repro_torch.core.methods.pipelined import PipelinedMethod
from repro_torch.core.methods.sstep import SStepMethod

METHODS: dict[str, MethodSpec] = {
    "classic": ClassicMethod(),
    "pipelined": PipelinedMethod(),
    "sstep": SStepMethod(),
}


def get_method(name: str) -> MethodSpec:
    """Look up an iteration scheme by name."""
    try:
        return METHODS[name]
    except KeyError:
        raise ValueError(
            f"unknown method {name!r}; expected one of {sorted(METHODS)}"
        ) from None


__all__ = [
    "METHODS",
    "MethodContext",
    "MethodSpec",
    "ClassicMethod",
    "PipelinedMethod",
    "SStepMethod",
    "get_method",
]
