"""The solver's result type, the breakdown-guarded loop, and plain CG.

Plain CG *is* enlarged CG at t=1 (the splitting is the identity, the block
recurrences collapse to the scalar ones), so :func:`_cg_solve` runs the
classic ECG method at width 1 and inherits its breakdown guard.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

#: ``SolveResult.event_hist`` bitmask values.
EV_RECOVERY = 1  # rank-revealing factorization dropped live directions
EV_RESEED = 2    # flexible restart reseeded Z from the preconditioned residual

#: event-bit -> human-readable code name
EVENT_NAMES = {EV_RECOVERY: "recovery", EV_RESEED: "reseed"}


@dataclasses.dataclass
class SolveResult:
    x: torch.Tensor
    n_iters: int
    res_hist: torch.Tensor  # (max_iters + 1,), padded with NaN past convergence
    converged: bool
    breakdown: bool = False  # a non-finite iterate was produced; the state
    #                          (x, residual norm) froze at the last finite
    #                          iteration instead of NaNs
    t: int | None = None     # enlarging factor used (None for plain CG)
    active_hist: np.ndarray | None = None  # (max_iters + 1,) int32 active
    #                          block width per iteration — the reduction
    #                          trace (adaptive ECG only, -1 past the end)
    restarts: int = 0        # re-enlarge events (adaptive ECG)
    comm_segments: list | None = None  # [(exchange width, iterations)] per
    #                          width segment of the re-sliced solve
    #                          (width-segmented distributed ECG only)
    event_hist: np.ndarray | None = None  # (max_iters + 1,) int32 event
    #                          bitmask per iteration (EV_RECOVERY,
    #                          EV_RESEED), -1 past the recorded end; None
    #                          when no tracked mechanism was active
    selection: object = None  # the TSelection when t was chosen by "auto"
    pack: dict | None = None  # width-packing telemetry when this result came
    #                          out of a packed multi-RHS solve (total width,
    #                          group layout, this request's group index and
    #                          tolerance, retirement iteration, total packed
    #                          iterations); None for solo solves
    final_carry: dict | None = dataclasses.field(default=None, repr=False)

    def reduction_events(self) -> list[tuple[int, int, int]]:
        """[(iteration, width_before, width_after)] from the reduction trace
        — every iteration where the active block width changed.

        Scans the full valid trace (every entry >= 0) rather than slicing at
        ``n_iters``: the trace is -1-padded past the last recorded iteration,
        so a width change recorded on the final iteration is always reported.
        """
        if self.active_hist is None:
            return []
        h = np.asarray(self.active_hist).tolist()
        return [
            (k, h[k - 1], h[k])
            for k in range(1, len(h))
            if h[k] >= 0 and h[k - 1] >= 0 and h[k] != h[k - 1]
        ]

    def _event_iters(self, bit: int) -> list[int]:
        """Iterations whose event-bitmask entry carries ``bit`` (valid
        entries only: the trace is -1-padded past the recorded end)."""
        if self.event_hist is None:
            return []
        h = np.asarray(self.event_hist).tolist()
        return [k for k in range(len(h)) if h[k] >= 0 and int(h[k]) & bit]

    def recovery_events(self) -> list[int]:
        """Iterations where the rank-revealing factorization dropped live
        directions — the breakdown-recovery trace: the factorization accepted
        fewer pivots than the entering active width."""
        return self._event_iters(EV_RECOVERY)

    def reseed_events(self) -> list[int]:
        """Iterations where the flexible restart reseeded the direction
        chain from the preconditioned residual (classic + an
        iteration-varying preconditioner, every ``reseed``-th iteration)."""
        return self._event_iters(EV_RESEED)

    @property
    def n_recoveries(self) -> int:
        return len(self.recovery_events())

    @property
    def n_reseeds(self) -> int:
        return len(self.reseed_events())

    def iter_trace(self) -> list[dict]:
        """Structured per-iteration view over the recorded histories.

        One dict per *recorded* iteration ``k`` (including iteration 0, the
        initial residual): ``dict(k, resnorm, active, events)``.  ``active``
        is the active block width (None when no reduction trace was
        recorded), ``events`` a tuple of event names (``"recovery"`` /
        ``"reseed"``).  The valid prefix is the leading run of finite
        ``res_hist`` entries (the history is NaN-padded past convergence).
        """
        hist = self.res_hist
        hist = np.asarray(hist.detach().cpu() if isinstance(hist, torch.Tensor) else hist, np.float64)
        finite = np.isfinite(hist)
        end = int(np.argmin(finite)) if not finite.all() else hist.size
        act = None if self.active_hist is None else np.asarray(self.active_hist).tolist()
        ev = None if self.event_hist is None else np.asarray(self.event_hist).tolist()
        rows = []
        for k in range(end):
            events = ()
            if ev is not None and k < len(ev) and ev[k] > 0:
                events = tuple(
                    name for bit, name in sorted(EVENT_NAMES.items()) if int(ev[k]) & bit
                )
            active = None
            if act is not None and k < len(act) and act[k] >= 0:
                active = int(act[k])
            rows.append(dict(k=k, resnorm=float(hist[k]), active=active, events=events))
        return rows


def _guarded_while(cond_extra: Callable, body_fn: Callable, init: dict) -> dict:
    """Run ``body_fn`` while ``cond_extra`` holds, with a breakdown guard.

    If an iteration produces a non-finite residual norm (singular Gram
    matrix, zero curvature, ...), the previous — last finite — carry is kept
    and ``bd`` is raised, ending the loop.  The returned state is therefore
    always finite.  The carry's ``rn`` is a host float, so each iteration
    costs one device-to-host sync (the residual norm) and no other.
    Iterations build new tensors and never update the carry in place, which
    is what lets the guard keep the previous one.
    """
    carry = dict(init, bd=not math.isfinite(init["rn"]))
    while not carry["bd"] and cond_extra(carry):
        new = body_fn(carry)
        if math.isfinite(new["rn"]):
            carry = new
        else:
            carry = dict(carry, bd=True)
    return carry


def _cg_solve(
    a_apply: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    tol: float = 1e-8,
    max_iters: int = 1000,
) -> SolveResult:
    """Plain CG = the classic ECG method at t=1 (internal spelling).

    ``a_apply`` is the *vector* SpMV — it is adapted to the engine's width-1
    block shape here.
    """
    from repro_torch.core.ecg import finalize_result, make_ecg_runner  # ecg imports this module

    runner = make_ecg_runner(
        lambda v_block: a_apply(v_block[:, 0])[:, None], 1,
        tol=tol, max_iters=max_iters,
    )
    x0 = torch.zeros_like(b) if x0 is None else x0
    out = runner.run(runner.init(b, x0))
    res = finalize_result(out, x0=x0, t=1, tol=tol)
    return dataclasses.replace(res, t=None)  # plain CG has no enlarging factor
