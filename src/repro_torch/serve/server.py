"""The ECG server: registry + warm-start cache + request batching, one API.

Port of ``repro/serve/server.py``.  :class:`ECGServer` is the session layer
over :class:`~repro_torch.solver.ECGSolver` for the many-clients /
few-operators regime: requests name an operator by content (the CSR
itself), the server resolves it to an already-built session via the
:class:`~repro_torch.serve.registry.OperatorRegistry`, coalesces pending
single-RHS requests per operator through the
:class:`~repro_torch.serve.batching.RequestQueue`, and answers each with its
own :class:`~repro_torch.core.cg.SolveResult` — bit-identical to a solo
``ECGSolver.solve`` of the same request.

    from repro_torch.serve import ECGServer, ServeConfig

    server = ECGServer(ServeConfig(cache_dir="ecg-cache"), device="cuda")
    tk = server.submit(a, b)          # registers a on first sight
    server.flush()                    # dispatch pending batches
    x = server.solution(tk)           # global solution vector

The synchronous single-thread model is deliberate: dispatch order is
deterministic (submit order within operator groups), which is what makes
request traces replayable and the bit-identity guarantee testable.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.serve.batching import RequestQueue, Ticket
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.registry import OperatorRegistry


class ECGServer:
    """ECG-as-a-service session layer (see module docstring).

    config: a :class:`~repro_torch.serve.ServeConfig` (or dict / None).
    mesh:   optional :class:`~repro_torch.launch.mesh.VirtualMesh` —
            every registered session then runs the distributed node-aware
            solver.
    tracer: optional :class:`~repro_torch.observe.Tracer` — threads through the
            registry (build spans, hit/miss counters), the queue (request
            lifecycle spans), and every registered solver session (build-
            phase and solve-segment spans).  None uses the ambient tracer
            (:func:`~repro_torch.observe.get_tracer`), which is a no-op unless
            one was installed.
    device: the device every session is built on (``"cuda"`` by default,
            raising without CUDA; ``"cpu"`` runs the plain versions; with a
            mesh, the mesh's device).
    """

    def __init__(self, config: ServeConfig | dict | None = None, mesh=None,
                 tracer=None, device=None):
        self.config = ServeConfig.coerce(config)
        self.mesh = mesh
        self.registry = OperatorRegistry(self.config, mesh=mesh,
                                         tracer=tracer, device=device)
        self.queue = RequestQueue(
            max_batch=self.config.max_batch,
            max_wait_s=self.config.max_wait_s,
            max_pending=self.config.max_pending,
            dedup=self.config.dedup,
            packing=self.config.packing,
            tracer=tracer,
        )

    # ------------------------------------------------------------ requests
    def submit(self, a, b, x0=None, tol=None) -> Ticket:
        """Enqueue one request; may dispatch eagerly.

        Registers (or resolves) the operator, enqueues the request, and —
        when a batch-closing trigger fires (an operator group reached
        ``max_batch`` distinct payloads / the pack capacity, or the oldest
        request aged past a deadline) — drains the queue before returning.
        Raises :class:`~repro_torch.serve.ServeOverloaded` when ``max_pending``
        is hit.

        ``tol`` is a per-request absolute residual-norm tolerance and
        requires the width-packing policy (``ServeConfig(packing="width")``)
        — only a packed solve retires each request against its own
        tolerance; the dispatch-batched path solves every request to the
        session's configured tolerance.
        """
        if tol is not None and not self.config.packing.active:
            raise ValueError(
                "per-request tol requires the width-packing policy "
                "(ServeConfig(packing='width')); the dispatch-batched path "
                "solves every request to the session tolerance"
            )
        key, solver = self.registry.get(a)
        ticket = self.queue.submit(key, b, x0, solver=solver, tol=tol)
        if self.queue.due():
            self.flush()
        return ticket

    def flush(self) -> list[Ticket]:
        """Dispatch every pending request; returns them, all completed."""
        return self.queue.drain()

    def solve(self, a, b, x0=None):
        """Submit + dispatch one request; returns its ``SolveResult``.

        The convenience spelling for sequential traffic — batching across
        requests needs :meth:`submit`/:meth:`flush`.
        """
        ticket = self.submit(a, b, x0)
        return self.result(ticket)

    # ------------------------------------------------------------- results
    def result(self, ticket: Ticket):
        """The ticket's :class:`~repro_torch.core.cg.SolveResult`, dispatching
        pending work first if needed."""
        if not ticket.done:
            self.flush()
        return ticket.result

    def solution(self, ticket: Ticket) -> np.ndarray:
        """Global (n,) solution vector of a request (unsharded on a
        distributed server)."""
        res = self.result(ticket)
        return ticket.solver.unshard(res.x)

    def stream_residuals(self, ticket: Ticket):
        """Yield the request's residual-norm history ``r_0 … r_k`` one
        float at a time (dispatches first if the request is pending).

        Iterating costs one host transfer up front, then pure host reads —
        the shape a chunked/streaming transport encoding wants.
        """
        res = self.result(ticket)
        hist = res.res_hist
        hist = hist.detach().cpu().numpy() if isinstance(hist, torch.Tensor) else np.asarray(hist)
        for k in range(int(res.n_iters) + 1):
            yield float(hist[k])

    # --------------------------------------------------------------- state
    def stats(self) -> dict:
        """JSON-safe counters of both layers: registry hits/misses/
        evictions/builds and queue batches/dedup/backpressure."""
        return dict(
            registry=self.registry.stats(),
            queue=self.queue.stats(),
        )
