"""Cross-request width packing: coalesce serve traffic into ONE enlarged
block solve with per-request retirement.

Port of ``repro/serve/packing.py``.  The dispatch batching in
:mod:`repro_torch.serve.batching` runs k width-``t`` solves; each request
still runs its own full iteration loop and pays its own halo exchanges and
Gram reductions.  Width packing goes
further: k compatible requests (same operator fingerprint, same
:class:`~repro_torch.solver.SolverConfig`) become contiguous column slabs of a
single ``(n, k·t)`` enlarged solve (``ECGSolver.solve_packed``) — every
iteration's two Gram psums and its halo exchange are shared by all k
requests, and the pack converges in far fewer *total* iterations than k
solo solves because the requests search one shared Krylov space.

The price is bit-identity: packed results are coupled through the shared
pivoted directions, so a packed request's iterate sequence differs from
its solo solve.  Packing is therefore **opt-in**
(``PackingConfig(pack="width")``) and the server reports the contract it
*does* enforce instead: every request's true relative residual
``‖A·x − b‖ / ‖b‖`` is measured host-side after the solve and attached to
its ticket (``Ticket.relres``), and each request retires only once its own
residual-norm tolerance is met (per-request retirement inside the packed
loop).  ``pack="off"`` (the default) leaves the dispatch-batching path —
and its bit-identity guarantee — byte-for-byte untouched.
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import torch

_PACK_MODES = ("off", "width")


@dataclasses.dataclass(frozen=True)
class PackingConfig:
    """Width-packing policy of a :class:`~repro_torch.serve.RequestQueue`.

    pack:           ``"off"`` (default — dispatch batching only, bit-identical
                    to solo solves) or ``"width"`` (coalesce compatible
                    requests into one enlarged packed solve).
    max_pack_width: total packed column budget; a pack holds at most
                    ``max(1, max_pack_width // solver.t)`` requests, so the
                    packed Gram stays a small dense factorization.
    max_wait_s:     packing deadline timer — a ``submit`` that finds a
                    pending request older than this closes the pack early
                    (partial packs beat stalled clients).  ``0`` disables
                    the clock: packs close on capacity or ``flush()`` only,
                    keeping request traces deterministic.
    """

    pack: str = "off"
    max_pack_width: int = 16
    max_wait_s: float = 0.0

    def __post_init__(self):
        if self.pack not in _PACK_MODES:
            raise ValueError(
                f"pack must be one of {_PACK_MODES}, got {self.pack!r}"
            )
        if not isinstance(self.max_pack_width, int) or self.max_pack_width < 1:
            raise ValueError(
                f"max_pack_width must be an int >= 1, got {self.max_pack_width!r}"
            )
        if not self.max_wait_s >= 0:
            raise ValueError(f"max_wait_s must be >= 0, got {self.max_wait_s!r}")

    @property
    def active(self) -> bool:
        return self.pack != "off"

    @classmethod
    def coerce(cls, value) -> "PackingConfig":
        if value is None:
            return cls()
        if isinstance(value, cls):
            return value
        if isinstance(value, str):
            return cls(pack=value)
        if isinstance(value, dict):
            return cls(**value)
        raise TypeError(
            "packing must be a PackingConfig, a pack-mode string, or a dict "
            f"of PackingConfig fields, got {type(value)}"
        )


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def host_csr(a):
    """Host (numpy) copies of a CSR's arrays, for repeated
    :func:`true_relres` calls on one operator."""
    return types.SimpleNamespace(indptr=_host(a.indptr), indices=_host(a.indices),
                                 data=_host(a.data), shape=tuple(a.shape))


def true_relres(a, x, b) -> float:
    """Host-side true relative residual ``‖A·x − b‖ / ‖b‖`` of a solution.

    Computed from the raw CSR arrays with numpy (one bincount segment-sum)
    — independent of the solver's kernels and recurrences on purpose: this
    is the *measurement* side of the packed relres contract, so it must not
    share code with the machinery it audits.  Tensors (a CSR on the card
    among them) are copied to the host; :func:`host_csr` makes that copy
    once for many calls.
    """
    x, b = _host(x), _host(b)
    indptr, indices, data = _host(a.indptr), _host(a.indices), _host(a.data)
    n = int(a.shape[0])
    rows = np.repeat(np.arange(n), np.diff(indptr))
    ax = np.bincount(rows, weights=np.asarray(data * x[indices], np.float64),
                     minlength=n)
    nb = float(np.linalg.norm(b))
    return float(np.linalg.norm(ax - b) / (nb if nb > 0 else 1.0))


def latency_percentiles(tickets) -> dict:
    """``dict(n, mean, p50, p95, p99)`` per-request latency (seconds) of
    completed tickets.

    Latency is ``completed_s − submitted_s`` — queue wait *plus* solve, the
    number a client actually experiences.  Tickets without a completion
    stamp are skipped.  An empty or all-incomplete ticket list returns the
    **explicit empty result** ``dict(n=0, mean=None, p50=None, p95=None,
    p99=None)`` — never NaNs (which compare false silently) and never a
    ``np.percentile`` call on an empty array; callers branch on ``n``.
    """
    lats = [
        tk.completed_s - tk.submitted_s
        for tk in tickets
        if tk.completed_s is not None
    ]
    if not lats:
        return dict(n=0, mean=None, p50=None, p95=None, p99=None)
    arr = np.asarray(lats, np.float64)
    return dict(
        n=int(arr.size),
        mean=float(arr.mean()),
        p50=float(np.percentile(arr, 50)),
        p95=float(np.percentile(arr, 95)),
        p99=float(np.percentile(arr, 99)),
    )


class WidthPacker:
    """Dispatch helper that runs one pack through ``solve_packed``.

    Owns the pack counters (``packs``, ``pack_layouts``) and the
    per-request relres measurement; the :class:`~repro_torch.serve.RequestQueue`
    owns grouping, dedup, and chunking-to-capacity.
    """

    def __init__(self, config: PackingConfig):
        self.config = config
        self.packs = 0
        self.pack_layouts: list[dict] = []

    def capacity(self, solver) -> int:
        """Requests per pack for this session's width: each request owns a
        ``solver.t``-column slab under the total ``max_pack_width`` budget
        (always >= 1 — a lone oversized session still packs solo)."""
        return max(1, self.config.max_pack_width // int(solver.t))

    def dispatch(self, chunk: list[list]) -> int:
        """Solve one pack: ``chunk`` is a list of dedup groups (lists of
        tickets sharing a payload); the first ticket of each group leads.
        Fills every ticket's result/pack telemetry; returns the number of
        tickets completed."""
        leads = [tickets[0] for tickets in chunk]
        solver = leads[0].solver
        results = solver.solve_packed(
            [tk.b for tk in leads],
            [tk.x0 for tk in leads],
            [tk.tol for tk in leads],
        )
        pack_id = self.packs
        self.packs += 1
        self.pack_layouts.append(dict(
            pack_id=pack_id,
            width=int(results[0].pack["width"]),
            t_each=int(results[0].pack["t_each"]),
            groups=len(leads),
            comm_segments=[
                [int(w), int(it)] for w, it in (results[0].comm_segments or [])
            ],
        ))
        done = 0
        a_host = host_csr(solver.a)  # one host copy for the pack
        for j, (tickets, res) in enumerate(zip(chunk, results)):
            relres = true_relres(a_host, solver.unshard(res.x), leads[j].b)
            for i, tk in enumerate(tickets):
                tk.result = res
                tk.pack_id = pack_id
                tk.pack_width = int(res.pack["width"])
                tk.group_index = j
                tk.batch_size = len(leads)
                tk.deduped = i > 0
                tk.relres = relres
                done += 1
        return done
