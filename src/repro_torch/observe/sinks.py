"""Tracer sinks: in-memory (tests), JSONL append, Chrome-trace export.

Port of ``repro/observe/sinks.py``: the same records, lines and files.

A sink is any object with::

    span(span)                            # one closed Span
    metric(kind, name, value, ts, attrs)  # one counter/gauge/instant sample
    close()                               # optional: flush buffers

The three provided sinks cover the matrix the observability docs promise:

=============== ==================== =====================================
sink            destination          consumer
=============== ==================== =====================================
MemorySink      python lists         tests / ad-hoc inspection
JsonlSink       append-only .jsonl   log shippers, ``jq``, pandas
ChromeTraceSink trace.json           ``chrome://tracing`` / Perfetto UI
=============== ==================== =====================================
"""

from __future__ import annotations

import json
import os

from repro_torch.observe.tracer import Span


class MemorySink:
    """Keeps every span and metric sample in Python lists (for tests)."""

    def __init__(self):
        self.spans: list[Span] = []
        self.metrics: list[dict] = []

    def span(self, span: Span):
        self.spans.append(span)

    def metric(self, kind, name, value, ts, attrs):
        self.metrics.append(
            dict(kind=kind, name=name, value=value, ts=ts, attrs=dict(attrs))
        )

    def by_name(self, name: str) -> list[Span]:
        return [s for s in self.spans if s.name == name]

    def counter_value(self, name: str):
        """Latest sample of counter/gauge ``name`` (None if never set)."""
        vals = [m["value"] for m in self.metrics if m["name"] == name]
        return vals[-1] if vals else None


class JsonlSink:
    """One JSON object per line, appended atomically.

    Each record is written with a single ``os.write`` on an
    ``O_APPEND`` descriptor — POSIX guarantees the append offset is
    atomic per write, so concurrent writers (a forked benchmark, a
    second server process sharing the log) interleave whole records,
    never partial lines.
    """

    def __init__(self, path: str):
        self.path = str(path)
        self._fd = os.open(self.path,
                           os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)

    def _write(self, record: dict):
        line = json.dumps(record, separators=(",", ":")) + "\n"
        os.write(self._fd, line.encode())

    def span(self, span: Span):
        self._write(dict(type="span", **span.to_dict()))

    def metric(self, kind, name, value, ts, attrs):
        self._write(dict(type=kind, name=name, value=value, ts=ts,
                         args=dict(attrs)))

    def close(self):
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None


class ChromeTraceSink:
    """Chrome trace event format (the JSON ``chrome://tracing`` and
    Perfetto's legacy importer open directly).

    Spans become complete events (``ph="X"``), counters counter events
    (``ph="C"``), gauges/instants instant events (``ph="i"``).
    Timestamps are microseconds relative to the first event (the viewer
    needs small monotonic numbers, not perf_counter's arbitrary origin);
    events are sorted by timestamp at write time, so out-of-order
    ``emit`` calls (queue waits recorded at drain) still render.
    """

    def __init__(self, path: str, pid: int = 0):
        self.path = str(path)
        self.pid = pid
        self.events: list[dict] = []
        self._origin: float | None = None

    def _us(self, t: float) -> float:
        if self._origin is None:
            self._origin = t
        return (t - self._origin) * 1e6

    def span(self, span: Span):
        self.events.append(dict(
            name=span.name, cat=span.cat or "span", ph="X",
            ts=self._us(span.t0), dur=(span.dur or 0.0) * 1e6,
            pid=self.pid, tid=span.tid, args=dict(span.args),
        ))

    def metric(self, kind, name, value, ts, attrs):
        if kind == "counter":
            self.events.append(dict(
                name=name, cat="metric", ph="C", ts=self._us(ts),
                pid=self.pid, tid=0, args={name: value, **attrs},
            ))
        else:  # gauge / instant -> instant event with the value in args
            self.events.append(dict(
                name=name, cat=kind, ph="i", ts=self._us(ts), s="p",
                pid=self.pid, tid=0, args={"value": value, **attrs},
            ))

    def to_json(self) -> dict:
        # the running origin is the first *closed* event, so an outer span
        # that opened earlier lands at a negative ts; shift once at export
        # so the earliest event sits at 0
        events = sorted(self.events, key=lambda e: e["ts"])
        if events and events[0]["ts"] != 0:
            shift = events[0]["ts"]
            events = [dict(e, ts=e["ts"] - shift) for e in events]
        return dict(traceEvents=events, displayTimeUnit="ms")

    def close(self):
        with open(self.path, "w") as fh:
            json.dump(self.to_json(), fh)


def open_sink(path: str):
    """Sink for ``path`` by extension: ``.jsonl`` appends JSON lines,
    anything else writes a Chrome trace on close (the ``--trace PATH``
    CLI contract)."""
    if str(path).endswith(".jsonl"):
        return JsonlSink(path)
    return ChromeTraceSink(path)
