"""Per-request column groups for packed (multi-RHS) enlarged solves.

Port of ``repro/adaptive/groups.py``.  Width packing coalesces k compatible
right-hand sides into ONE enlarged block solve of width ``k·t′``: request j
owns the contiguous column slab ``[j·t′, (j+1)·t′)`` and converges against
its own tolerance.  :class:`GroupSpec` is the static (hashable) layout; the
packed solve that consumes it (``solve_packed`` and the classic scheme's
group retirement) is ROADMAP.md queue 1 item 10.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    """Static layout of a packed solve: ``n_groups`` requests × ``t_each``
    columns, each group converging against its own absolute tolerance.

    Hashable on purpose — it is part of the solver handle's runner cache
    key, so two packs with the same (k, tolerances) layout share a runner.
    """

    t_each: int
    tols: tuple[float, ...]

    def __post_init__(self):
        if not isinstance(self.t_each, int) or self.t_each < 1:
            raise ValueError(f"t_each must be an int >= 1, got {self.t_each!r}")
        if not self.tols:
            raise ValueError("a packed solve needs at least one group")
        tols = tuple(float(t) for t in self.tols)
        if any(t <= 0 for t in tols):
            raise ValueError(f"group tolerances must be positive, got {tols}")
        object.__setattr__(self, "tols", tols)

    @property
    def n_groups(self) -> int:
        return len(self.tols)

    @property
    def width(self) -> int:
        """Total packed enlargement width k·t′."""
        return self.n_groups * self.t_each
