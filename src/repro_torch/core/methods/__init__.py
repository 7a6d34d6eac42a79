"""Pluggable ECG iteration schemes; the port registers ``classic`` so far."""

from __future__ import annotations

from repro_torch.core.methods.base import MethodContext, MethodSpec
from repro_torch.core.methods.classic import ClassicMethod

METHODS: dict[str, MethodSpec] = {
    "classic": ClassicMethod(),
}

#: reference schemes the port does not carry yet, and the ROADMAP item
#: that brings them
NOT_PORTED = {"pipelined": "queue 1 item 7", "sstep": "queue 1 item 7"}


def get_method(name: str) -> MethodSpec:
    """Look up an iteration scheme by name."""
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"method {name!r} is not ported yet (ROADMAP.md {NOT_PORTED[name]})"
        )
    try:
        return METHODS[name]
    except KeyError:
        raise ValueError(
            f"unknown method {name!r}; expected one of {sorted(METHODS)}"
        ) from None


__all__ = ["METHODS", "MethodContext", "MethodSpec", "ClassicMethod", "get_method"]
