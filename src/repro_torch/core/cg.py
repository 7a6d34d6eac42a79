"""The solver's result type, the breakdown-guarded loop, and plain CG.

Plain CG *is* enlarged CG at t=1 (the splitting is the identity, the block
recurrences collapse to the scalar ones), so :func:`_cg_solve` runs the
classic ECG method at width 1 and inherits its breakdown guard.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch


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
    final_carry: dict | None = dataclasses.field(default=None, repr=False)


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
