"""Model-drift telemetry: predicted cost / accounted bytes vs. measured.

Port of ``repro/observe/drift.py``, on the models of
:mod:`repro_torch.tune.autotune`.  For each ``(strategy, t_active)`` a solve
actually ran it compares

* **time drift** — measured wall seconds per iteration against the
  structural per-iteration prediction (:func:`predicted_iteration_seconds`,
  the reference's formula term for term), and
* **bytes drift** — the bytes one SpMBV's exchange *moved* against the
  bytes the :class:`~repro_torch.core.node_aware.ExchangePlan` accounts for.

The reference counts the moved bytes in XLA's compiled text
(``hlo_collective_bytes``: each collective-permute's per-device buffer
times p).  The port has no compiled text; its replacement reads the mesh's
own counter instead: :func:`bytes_drift` applies the width-``w`` operator
once and takes ``VirtualMesh.ppermute_elements`` × itemsize, the elements
every rank handed to a rotation (each rotation buffer whole, padding
included, as the reference's buffer shapes are), against
``plan.at_width(w).wire_bytes``.

:func:`calibrated_drift` normalizes each row's time drift by the median
drift across rows: one scalar (the machine's true speed against the
model's constants) soaks into the median, and what remains is how well the
model ranks and scales configurations.
"""

from __future__ import annotations

import numpy as np
import torch


def _resolve_machine(solver):
    """The MachineParams a drift row prices against: the tuner's
    dtype-resolved machine when the build tuned, else the comm config's,
    else HOST (as the reference)."""
    machine = None
    if solver.tuned is not None:
        machine = solver.tuned.machine
    if machine is None:
        machine = solver.config.comm.machine
    if machine is None:
        from repro_torch.core.machines import HOST

        machine = HOST
    return machine


def predicted_iteration_seconds(solver, width: int | None = None, machine=None) -> float:
    """Structural-model seconds for one iteration of ``solver`` at active
    width ``width`` (default: the handle's ``solver.t``).

    Only the exchange payload and the SpMBV flops shrink with ``width`` —
    the Gram reductions and the dense local updates stay full-``t``-shaped
    (masked columns, not narrower blocks), so their terms are charged at
    full t.
    """
    from repro_torch.core.ecg import ECGOperationCounts
    from repro_torch.tune.autotune import (
        _method_local_flops, method_sync_cost, structural_exchange_cost,
    )

    if solver.op is None:
        raise ValueError("model drift needs a distributed handle (mesh=)")
    t = int(solver.t)
    w = t if width is None else int(width)
    cfg = solver.config
    machine = _resolve_machine(solver) if machine is None else machine
    plan = solver.op.plan
    p = int(solver.op.p)
    exchange = structural_exchange_cost(plan, machine, width=w)
    counts_w = ECGOperationCounts(n=solver.a.shape[0], nnz=solver.a.nnz, p=p, t=w)
    counts_t = ECGOperationCounts(n=solver.a.shape[0], nnz=solver.a.nnz, p=p, t=t)
    spmbv_local = machine.gamma * counts_w.spmbv_flops
    local = machine.gamma * _method_local_flops(
        cfg.method.name, counts_t, s=cfg.method.s, reorth=cfg.method.reorth
    )
    sync = method_sync_cost(
        cfg.method.name, t, p, machine, s=cfg.method.s,
        reorth=cfg.method.reorth, t_spmbv_window=exchange + spmbv_local,
    ) if p > 1 else 0.0
    return spmbv_local + exchange + sync + local


def bytes_drift(solver, width: int | None = None, dtype=torch.float64) -> dict:
    """Plan-accounted vs. moved exchange bytes of one SpMBV apply.

    Applies ``op.matvec_fn(t_active=width)`` once to a zero (n_padded,
    width) block of ``dtype`` and reads what the mesh's ``ppermute_elements``
    counter moved (a replayed exchange graph adds its captured counts, so
    the first and every later apply count the same).  Returns
    ``dict(width, plan_bytes, moved_bytes, ratio)``; ``ratio`` is
    moved/plan, ≥ 1 (a rotation moves its whole buffer, the plan counts
    the halo rows it delivers).
    """
    if solver.op is None:
        raise ValueError("bytes drift needs a distributed handle (mesh=)")
    op, mesh = solver.op, solver.mesh
    w = int(solver.t) if width is None else int(width)
    f = torch.empty((), dtype=dtype).element_size()
    plan_bytes = int(op.plan.at_width(w).wire_bytes(f))
    v = torch.zeros((op.n_padded, w), dtype=dtype, device=op.device)
    before = mesh.ppermute_elements
    op.matvec_fn(t_active=w)(v)
    moved = int(mesh.ppermute_elements - before) * f
    return dict(width=w, plan_bytes=plan_bytes, moved_bytes=moved,
                ratio=(moved / plan_bytes) if plan_bytes else None)


def model_drift(solver, measured_segments, machine=None, tracer=None,
                strategy: str | None = None) -> list[dict]:
    """Drift rows for one solve's measured width segments.

    measured_segments: ``[(width, iters, wall_seconds)]`` — one entry per
        solve segment (the tracer's ``solve/segment`` spans carry exactly
        these three numbers).  Zero-iteration segments are skipped.
    machine: optional calibrated MachineParams override.
    tracer: when given, each row is also emitted as a ``model_drift``
        gauge keyed by ``(strategy, t_active)``.

    Returns rows of ``dict(strategy, t_active, iters, measured_iter_s,
    predicted_iter_s, time_drift, plan_bytes, moved_bytes, bytes_drift)``
    where ``time_drift = measured / predicted`` (> 1: the model is
    optimistic); ``moved_bytes`` stands where the reference has
    ``hlo_bytes``.
    """
    if strategy is None:
        strategy = (
            solver.tuned.strategy if solver.tuned is not None
            else solver.config.comm.strategy
        )
    rows = []
    for width, iters, wall_s in measured_segments:
        if iters <= 0:
            continue
        measured = float(wall_s) / iters
        predicted = predicted_iteration_seconds(solver, width, machine)
        bd = bytes_drift(solver, width)
        row = dict(
            strategy=strategy, t_active=int(width), iters=int(iters),
            measured_iter_s=measured, predicted_iter_s=predicted,
            time_drift=measured / predicted if predicted > 0 else None,
            plan_bytes=bd["plan_bytes"], moved_bytes=bd["moved_bytes"],
            bytes_drift=bd["ratio"],
        )
        rows.append(row)
        if tracer is not None:
            tracer.gauge(
                "model_drift", row["time_drift"], strategy=strategy,
                t_active=int(width), bytes_drift=bd["ratio"],
            )
    return rows


def calibrated_drift(rows) -> list[dict]:
    """Normalize each row's time drift by the median drift across rows;
    adds ``calibrated_time_drift`` to a copy of each row."""
    drifts = [r["time_drift"] for r in rows if r["time_drift"] is not None]
    med = float(np.median(drifts)) if drifts else 1.0
    out = []
    for r in rows:
        r = dict(r)
        r["calibrated_time_drift"] = (
            r["time_drift"] / med if r["time_drift"] is not None and med > 0
            else None
        )
        out.append(r)
    return out
