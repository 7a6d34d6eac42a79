"""Preconditioner configuration (port of ``repro.precondition``; building and
applying a preconditioner is ROADMAP.md queue 1 item 8)."""

from repro_torch.precondition.config import PRECONDITIONS, PreconditionConfig

__all__ = ["PRECONDITIONS", "PreconditionConfig"]
