"""Request queue + batching policy: coalesce single-RHS traffic per operator.

Port of ``repro/serve/batching.py``.  Every serving request is one
``(operator, b)`` pair, and every registered session is an **(n, t)
block** solver — the enlargement already *is* the batch.  By default the
queue does not pack columns (mixing requests into one splitting entangles
their Gram matrices and breaks per-request bit-identity); its job is to:

* group pending requests by operator fingerprint, so consecutive solves
  reuse one session and its cached runner (each request's RHS is split to
  the session's width ``t`` — no shape ever changes);
* deduplicate identical ``(operator, b, x0)`` payloads — concurrent
  clients asking for the same solve share one result, bit-identical by
  construction;
* dispatch each group through ``ECGSolver.solve_many`` (the reference
  enqueues every solve before the first host sync; the port's loop syncs
  once per iteration, so the group's solves run one after another);
* apply backpressure: a bounded pending queue that rejects with the typed
  :class:`ServeOverloaded` instead of growing without bound.

Batches close on three triggers: a per-operator group reaching
``max_batch`` distinct payloads (checked at ``submit``), the oldest
pending request aging past ``max_wait_s`` (checked at ``submit``;
disabled at the default ``0``), or an explicit ``flush()``.

With the **opt-in** width-packing policy
(:class:`~repro_torch.serve.packing.PackingConfig`, ``pack="width"``) the
entanglement trade is made deliberately: per-operator dedup groups are
chunked to the pack capacity and dispatched through
``ECGSolver.solve_packed`` — one enlarged ``(n, k·t)`` solve whose k
requests retire independently against their own tolerances.  Packed
results are *not* bit-identical to solo solves; each ticket instead
carries its measured true relative residual (``Ticket.relres``) and pack
telemetry.  Packs additionally close when a per-operator group reaches
the pack capacity or the oldest pending request ages past the packing
deadline ``PackingConfig.max_wait_s``.  ``pack="off"`` leaves every
code path above byte-for-byte as it was.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from collections import OrderedDict

import numpy as np

from repro_torch.observe.metrics import RollingWindow
from repro_torch.observe.tracer import coerce_tracer
from repro_torch.serve.packing import PackingConfig, WidthPacker, _host


class ServeOverloaded(RuntimeError):
    """Raised by ``submit`` when the pending queue is at ``max_pending``.

    The typed rejection is the backpressure contract: a client sees it
    *before* any device work is enqueued and can retry after a drain —
    nothing about the queue or the registry changed.
    """


def payload_key(fingerprint: str, b, x0=None, tol=None) -> str:
    """Dedup key: operator fingerprint + exact RHS/x0 bytes (+ per-request
    tolerance when one was given — two requests for the same payload at
    different tolerances must not share a solve)."""
    h = hashlib.blake2b(digest_size=16)
    h.update(fingerprint.encode())
    b = _host(b)
    h.update(b.dtype.str.encode())
    h.update(np.ascontiguousarray(b).tobytes())
    if x0 is not None:
        x0 = _host(x0)
        h.update(x0.dtype.str.encode())
        h.update(np.ascontiguousarray(x0).tobytes())
    if tol is not None:  # hashed only when set: default-tol keys are
        h.update(repr(float(tol)).encode())  # unchanged across versions
    return h.hexdigest()


@dataclasses.dataclass
class Ticket:
    """One submitted request and (after dispatch) its outcome.

    ``result`` is the request's own
    :class:`~repro_torch.core.cg.SolveResult` — convergence, iteration count,
    and residual history are per-request even when the solve was shared
    (``deduped``) or dispatched in a group (``batch_id``/``batch_size``).
    """

    request_id: int
    fingerprint: str
    b: np.ndarray
    x0: np.ndarray | None
    key: str
    submitted_s: float
    solver: object = dataclasses.field(repr=False, default=None)
    result: object = None
    batch_id: int | None = None
    batch_size: int = 0
    deduped: bool = False
    # --- width-packing / latency telemetry (None outside pack="width")
    tol: float | None = None          # per-request tolerance (packed only)
    completed_s: float | None = None  # dispatch completion stamp (all
    #                                   policies — latency percentiles)
    pack_id: int | None = None        # which pack solved this request
    pack_width: int | None = None     # total packed column width
    group_index: int | None = None    # this request's column-slab index
    relres: float | None = None       # measured true ‖Ax−b‖/‖b‖ (the packed
    #                                   relres contract; None when unmeasured)

    @property
    def done(self) -> bool:
        return self.result is not None


class RequestQueue:
    """Bounded pending queue with the grouping/dedup/flush policy."""

    def __init__(self, max_batch: int = 8, max_wait_s: float = 0.0,
                 max_pending: int = 256, dedup: bool = True,
                 packing: PackingConfig | None = None, clock=None,
                 tracer=None, window_s: float = 60.0):
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.max_pending = max_pending
        self.dedup = dedup
        self.packing = PackingConfig.coerce(packing)
        self.packer = WidthPacker(self.packing)
        self._tracer = coerce_tracer(tracer)
        # injectable clock (same contract as time.monotonic) — deadline
        # timers become deterministic under a test-controlled clock.  When
        # tracing is on and no clock was injected, the queue adopts the
        # tracer's clock so queue-wait spans (emitted from submit/complete
        # stamps) land on the same timeline as every other span.
        if clock is None:
            clock = (
                self._tracer.clock if self._tracer.enabled
                else time.monotonic
            )
        self._clock = clock
        self.pending: list[Ticket] = []
        self.submitted = 0
        self.rejected = 0
        self.batches = 0
        self.batch_sizes: list[int] = []
        self.dedup_shared = 0
        self.completed = 0
        # per-queue latency time-series: one sample per completed ticket,
        # read as rolling req/s + p50/p95/p99 over the trailing window
        self.window = RollingWindow(window_s=window_s)

    # ------------------------------------------------------------- intake
    def submit(self, fingerprint: str, b, x0=None, solver=None,
               tol=None) -> Ticket:
        if len(self.pending) >= self.max_pending:
            self.rejected += 1
            self._tracer.counter("serve.rejected", self.rejected)
            raise ServeOverloaded(
                f"{len(self.pending)} requests pending (max_pending="
                f"{self.max_pending}); flush or retry after a drain"
            )
        ticket = Ticket(
            request_id=self.submitted,
            fingerprint=fingerprint,
            b=_host(b),
            x0=None if x0 is None else _host(x0),
            key=payload_key(fingerprint, b, x0, tol),
            submitted_s=self._clock(),
            solver=solver,
            tol=None if tol is None else float(tol),
        )
        self.pending.append(ticket)
        self.submitted += 1
        self._tracer.counter("serve.submitted", self.submitted)
        return ticket

    def due(self) -> bool:
        """A batch-closing trigger fired: some operator group holds
        ``max_batch`` distinct payloads (pack capacity under
        ``pack="width"``), or the oldest request aged out."""
        if not self.pending:
            return False
        age = self._clock() - self.pending[0].submitted_s
        if self.max_wait_s > 0 and age >= self.max_wait_s:
            return True
        if (
            self.packing.active
            and self.packing.max_wait_s > 0
            and age >= self.packing.max_wait_s
        ):
            return True  # packing deadline: close a partial pack
        distinct: dict[str, set] = {}
        for tk in self.pending:
            keys = distinct.setdefault(tk.fingerprint, set())
            keys.add(tk.key if self.dedup else tk.request_id)
            close_at = self.max_batch
            if self.packing.active and tk.solver is not None:
                close_at = min(close_at, self.packer.capacity(tk.solver))
            if len(keys) >= close_at:
                return True
        return False

    # ----------------------------------------------------------- dispatch
    def drain(self) -> list[Ticket]:
        """Dispatch every pending request; returns them in submit order.

        Requests are grouped by operator (one session per group),
        deduplicated, chunked to ``max_batch``, and pushed through
        ``solve_many``.  Results are split back out per ticket.
        """
        drained, self.pending = self.pending, []
        tr = self._tracer
        t_start = self._clock()
        with tr.span("serve/drain", cat="serve", requests=len(drained),
                     policy=self.packing.pack):
            if tr.enabled:
                # queue wait per request: submit stamp -> drain start.
                # Both ends are on the queue clock (the tracer's clock
                # unless one was injected), emitted with explicit
                # timestamps since the wait began before this span opened.
                for tk in drained:
                    tr.emit("serve/queue_wait", tk.submitted_s,
                            t_start - tk.submitted_s, cat="serve",
                            request_id=tk.request_id)
            with tr.span("serve/assemble", cat="serve") as spa:
                groups: OrderedDict[str, OrderedDict[str, list[Ticket]]] = (
                    OrderedDict()
                )
                for tk in drained:
                    per_op = groups.setdefault(tk.fingerprint, OrderedDict())
                    key = tk.key if self.dedup else f"req{tk.request_id}"
                    per_op.setdefault(key, []).append(tk)
                spa.args.update(
                    operators=len(groups),
                    payloads=sum(len(g) for g in groups.values()),
                )
            if self.packing.active:
                self._drain_packed(groups)
            else:
                self._drain_batched(groups)
            with tr.span("serve/retire", cat="serve", tickets=len(drained)):
                now = self._clock()
                for tk in drained:
                    tk.completed_s = now
                    self.window.add(now, now - tk.submitted_s)
            tr.counter("serve.completed", self.completed)
        return drained

    def _drain_batched(self, groups) -> None:
        """Dispatch-pipelined batching (the default, bit-identical path)."""
        for per_op in groups.values():
            unique = list(per_op.values())
            for lo in range(0, len(unique), self.max_batch):
                chunk = unique[lo:lo + self.max_batch]
                leads = [tickets[0] for tickets in chunk]
                solver = leads[0].solver
                with self._tracer.span("serve/dispatch", cat="serve",
                                       policy="batch", batch_id=self.batches,
                                       batch_size=len(leads)):
                    results = solver.solve_many(
                        [tk.b for tk in leads], [tk.x0 for tk in leads]
                    )
                batch_id = self.batches
                self.batches += 1
                self.batch_sizes.append(len(leads))
                for tickets, res in zip(chunk, results):
                    for i, tk in enumerate(tickets):
                        tk.result = res
                        tk.batch_id = batch_id
                        tk.batch_size = len(leads)
                        tk.deduped = i > 0
                        self.completed += 1
                    self.dedup_shared += len(tickets) - 1

    def _drain_packed(self, groups) -> None:
        """Width packing: per-operator dedup groups chunked to the pack
        capacity and solved as one enlarged block program each."""
        for per_op in groups.values():
            unique = list(per_op.values())
            solver = unique[0][0].solver
            cap = self.packer.capacity(solver)
            for lo in range(0, len(unique), cap):
                chunk = unique[lo:lo + cap]
                with self._tracer.span("serve/dispatch", cat="serve",
                                       policy="width", pack_id=self.batches,
                                       groups=len(chunk)):
                    self.completed += self.packer.dispatch(chunk)
                self.batches += 1
                self.batch_sizes.append(len(chunk))
                self.dedup_shared += sum(len(ts) - 1 for ts in chunk)

    # -------------------------------------------------------------- state
    def stats(self) -> dict:
        return dict(
            submitted=self.submitted, completed=self.completed,
            pending=len(self.pending), rejected=self.rejected,
            batches=self.batches, batch_sizes=list(self.batch_sizes),
            dedup_shared=self.dedup_shared,
            pack=self.packing.pack,
            packs=self.packer.packs,
            pack_layouts=[dict(d) for d in self.packer.pack_layouts],
            rolling=self.window.snapshot(self._clock()),
        )
