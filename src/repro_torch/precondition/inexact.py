"""Inexact / iteration-varying preconditioner — the flexible-ECG path.

Port of ``repro/precondition/inexact.py``.  Weighted-Jacobi sweeps whose
damping depends on the iteration index: ``ω_k = ω · (1 − 1/16 · (k mod 2))``
— a deliberately *non-constant* M⁻¹ₖ.  Enlarged CG orthogonalizes new
directions only against the last two search blocks, so a preconditioner
that changes every iteration perturbs but does not break the short
recurrence; the classic scheme pairs it with a periodic residual reseed
(``PreconditionConfig.reseed``, Notay, SISC 22(4), 2000).

Each sweep is ``y ← y + ω_k D⁻¹ (x − A y)`` from ``y₀ = ω_k D⁻¹ x``; for
any fixed k the map ``x ↦ y`` is linear with a zero fixed point, and the
padded-slot convention (D = 1 on padding) keeps pads inert.
"""

from __future__ import annotations

import numpy as np
import torch


def extract_diagonal(a, row_of_slot: np.ndarray | None = None) -> np.ndarray:
    """Diagonal of CSR ``a`` — in slot order when ``row_of_slot`` is given
    (1.0 on padding slots so D⁻¹ is inert there).  A row holding its
    diagonal more than once contributes its first entry, as the
    reference's row loop; the lookup here is vectorised."""
    indptr, indices, data = a.numpy()
    n = a.shape[0]
    rows = np.repeat(np.arange(n), np.diff(indptr.astype(np.int64)))
    pos = np.flatnonzero(indices == rows)
    hit_rows, first = np.unique(rows[pos], return_index=True)
    diag = np.zeros(n, dtype=data.dtype)
    diag[hit_rows] = data[pos[first]]
    if np.any(diag <= 0):
        raise ValueError(
            "matrix has a non-positive diagonal entry — weighted Jacobi "
            "needs an SPD matrix"
        )
    if row_of_slot is None:
        return diag
    out = np.ones(row_of_slot.shape[0], dtype=data.dtype)
    live = row_of_slot >= 0
    out[live] = diag[row_of_slot[live]]
    return out


def make_inexact_apply(a_apply, diag, omega: float, sweeps: int):
    """Return ``f(V, k) -> M⁻¹ₖ V``: ``sweeps`` damped-Jacobi sweeps whose
    damping ``ω_k = ω (1 − (k mod 2)/16)`` varies with the iteration.

    ``diag`` is the (slot-order) diagonal as a host array; D⁻¹ is computed
    in its dtype and cast to each applied block's device and dtype once."""
    inv_diag = 1.0 / torch.as_tensor(np.asarray(diag))
    by_key: dict = {}

    def apply(x, k):
        dinv = by_key.get((x.device, x.dtype))
        if dinv is None:
            dinv = by_key[(x.device, x.dtype)] = inv_diag.to(device=x.device, dtype=x.dtype)[:, None]
        # a mild parity wobble that keeps M⁻¹ₖ SPD (0 < ω_k ≤ ω ≤ 1) while
        # making it genuinely non-constant
        om = omega * (1.0 - (int(k) % 2) / 16.0)
        y = om * dinv * x
        for _ in range(sweeps - 1):
            y = y + om * dinv * (x - a_apply(y))
        return y

    return apply
