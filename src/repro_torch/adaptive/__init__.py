"""Adaptive ECG (port of ``repro.adaptive``): the policy configuration only."""

from repro_torch.adaptive.reduce import POLICIES, ReductionPolicy, resolve_policy

__all__ = ["POLICIES", "ReductionPolicy", "resolve_policy"]
