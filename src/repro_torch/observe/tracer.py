"""Low-overhead span tracer for solve/comm/serve instrumentation.

Port of ``repro/observe/tracer.py`` (pure host code; records and files
equal the reference's under the same clock).  The paper's contribution is a *performance analysis* — knowing where ECG
time goes (collectives vs. p2p messages vs. local work) and checking the
byte/latency models against measurements.  :class:`Tracer` is the
substrate that analysis runs on inside this repo: host-side spans around
the phases the models price (build pipeline, per-width solve segments,
serve request lifecycle), each span carrying the structural attributes
the accounting already computes (``wire_bytes``, ``dispatch_count``,
psums/iter) so a trace is self-describing.

Two invariants keep the tracer honest:

* **timers sit at loop boundaries, never inside the iteration** — a span
  may wrap a whole solve loop or the host work around it, but no span
  opens inside an iteration, so the kernels a solve launches and the
  results it returns are the same with tracing on or off (gated in
  ``tests/test_torch_observe.py``).
* **off is free** — the default tracer is the :data:`NULL_TRACER`
  singleton whose ``span()`` returns a shared no-op context manager; no
  clock is read, no object allocated per call, and instrumented code
  never branches on a flag.

Usage::

    from repro_torch.observe import Tracer, ChromeTraceSink

    tracer = Tracer(sinks=[ChromeTraceSink("trace.json")])
    with tracer.span("build/partition", cat="build", p=8):
        ...
    tracer.counter("serve.completed", 17)
    tracer.close()          # flush sinks (writes trace.json)

Non-nesting phases (a queue wait that started before the drain span
opened) use the explicit-timestamp :meth:`Tracer.emit`; paired
``begin``/``end`` cover phases that cannot be expressed as a ``with``
block.
"""

from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class Span:
    """One closed (or still-open) traced phase.

    ``t0``/``dur`` are seconds on the tracer's clock (default
    ``time.perf_counter`` — an arbitrary-origin monotonic timeline, not
    wall time).  ``args`` holds the structural attributes; mutate it
    inside the ``with`` block to attach results computed mid-span.
    """

    name: str
    cat: str = ""
    t0: float = 0.0
    dur: float | None = None  # None while open
    tid: int = 0
    args: dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return dict(name=self.name, cat=self.cat, t0=self.t0,
                    dur=self.dur, tid=self.tid, args=dict(self.args))


class _SpanCtx:
    """Context manager that closes ``span`` on exit — including via an
    exception, so a failing build still produces a well-formed trace."""

    __slots__ = ("_tracer", "span")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self.span = span

    def __enter__(self) -> Span:
        return self.span

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None:
            self.span.args.setdefault("error", exc_type.__name__)
        self._tracer.end(self.span)
        return False  # never swallow


class Tracer:
    """Span + counter/gauge emitter fanning out to pluggable sinks.

    sinks:  objects implementing ``span(Span)`` and
            ``metric(kind, name, value, ts, attrs)`` (see
            :mod:`repro_torch.observe.sinks`); both calls must be cheap — the
            tracer does no buffering of its own.
    clock:  seconds-returning monotonic callable (default
            ``time.perf_counter``).  Injectable so tests — and the serve
            queue, which must share a timeline with its latency stamps —
            control the clock.
    """

    enabled = True

    def __init__(self, sinks=(), clock=None):
        self.sinks = list(sinks)
        self.clock = time.perf_counter if clock is None else clock
        self._open = 0  # open-span depth (nesting sanity, tested)

    # ------------------------------------------------------------- spans
    def span(self, name: str, cat: str = "", **attrs) -> _SpanCtx:
        """Open a span; use as ``with tracer.span(...) as sp:``."""
        return _SpanCtx(self, self.begin(name, cat, **attrs))

    def begin(self, name: str, cat: str = "", **attrs) -> Span:
        """Explicitly open a span (pair with :meth:`end`)."""
        self._open += 1
        return Span(name=name, cat=cat, t0=self.clock(), args=attrs)

    def end(self, span: Span, **attrs) -> Span:
        """Close ``span`` and hand it to every sink."""
        if attrs:
            span.args.update(attrs)
        span.dur = self.clock() - span.t0
        self._open -= 1
        for s in self.sinks:
            s.span(span)
        return span

    def emit(self, name: str, t0: float, dur: float, cat: str = "",
             **attrs) -> Span:
        """Record a span with explicit timestamps (non-nesting phases —
        e.g. a queue wait that began before the enclosing drain span).
        ``t0`` must be on the tracer's clock."""
        span = Span(name=name, cat=cat, t0=t0, dur=float(dur), args=attrs)
        for s in self.sinks:
            s.span(span)
        return span

    @property
    def open_spans(self) -> int:
        return self._open

    # ----------------------------------------------------------- metrics
    def _metric(self, kind: str, name: str, value, attrs: dict):
        ts = self.clock()
        for s in self.sinks:
            s.metric(kind, name, value, ts, attrs)

    def counter(self, name: str, value, **attrs):
        """Sample of a monotonically non-decreasing counter."""
        self._metric("counter", name, value, attrs)

    def gauge(self, name: str, value, **attrs):
        """Sample of a point-in-time value (drift ratio, queue depth)."""
        self._metric("gauge", name, value, attrs)

    def instant(self, name: str, **attrs):
        """Zero-duration event (reseed/recovery/retirement markers)."""
        self._metric("instant", name, 1, attrs)

    # ------------------------------------------------------------- sinks
    def close(self):
        """Flush + close every sink that supports it."""
        for s in self.sinks:
            close = getattr(s, "close", None)
            if close is not None:
                close()


class _NullSpanArgs(dict):
    """Attribute dict that silently drops writes (shared, never grows)."""

    def __setitem__(self, key, value):
        pass

    def update(self, *a, **kw):
        pass

    def setdefault(self, key, default=None):
        return default


class _NullCtx:
    """Shared no-op context manager: ``with NULL_TRACER.span(...)`` costs
    two attribute lookups and no allocation."""

    __slots__ = ()

    def __enter__(self):
        return _NULL_SPAN

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


class NullTracer(Tracer):
    """The default, disabled tracer — every operation is a no-op.

    Instrumented code holds a tracer unconditionally and never branches;
    with this singleton installed the instrumentation is free.
    """

    enabled = False

    def __init__(self):
        super().__init__(sinks=(), clock=lambda: 0.0)

    def span(self, name, cat="", **attrs):
        return _NULL_CTX

    def begin(self, name, cat="", **attrs):
        return _NULL_SPAN

    def end(self, span, **attrs):
        return span

    def emit(self, name, t0, dur, cat="", **attrs):
        return _NULL_SPAN

    def _metric(self, kind, name, value, attrs):
        pass

    def close(self):
        pass


_NULL_SPAN = Span(name="", dur=0.0, args=_NullSpanArgs())
_NULL_CTX = _NullCtx()

#: process-wide disabled tracer; ``tracer or NULL_TRACER`` is the idiom
#: instrumented constructors use to avoid None checks on the hot path.
NULL_TRACER = NullTracer()

_current: Tracer = NULL_TRACER


def get_tracer() -> Tracer:
    """The process-wide default tracer (:data:`NULL_TRACER` unless
    :func:`set_tracer` installed one)."""
    return _current


def set_tracer(tracer: Tracer | None) -> Tracer:
    """Install ``tracer`` as the process-wide default (None resets to the
    null tracer); returns the previous one so callers can restore it."""
    global _current
    prev = _current
    _current = NULL_TRACER if tracer is None else tracer
    return prev


def coerce_tracer(tracer) -> Tracer:
    """``None`` -> the process default; anything else passes through."""
    return _current if tracer is None else tracer
