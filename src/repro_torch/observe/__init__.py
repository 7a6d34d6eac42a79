"""Observability: span tracing, counters/gauges, model-drift telemetry
(port of ``repro.observe``).

    from repro_torch.observe import Tracer, ChromeTraceSink

    tracer = Tracer(sinks=[ChromeTraceSink("trace.json")])
    solver = ECGSolver.build(a, mesh, config, tracer=tracer)
    res = solver.solve(b)
    tracer.close()              # trace.json opens in chrome://tracing

The reference's ``hlo_collective_bytes`` reads XLA's compiled text, which
the port does not have; :func:`bytes_drift` counts the mesh's
``ppermute_elements`` instead (:mod:`repro_torch.observe.drift`).
"""

from repro_torch.observe.bench import timed_median, timed_median_us
from repro_torch.observe.drift import (
    bytes_drift,
    calibrated_drift,
    model_drift,
    predicted_iteration_seconds,
)
from repro_torch.observe.metrics import RollingWindow
from repro_torch.observe.sinks import ChromeTraceSink, JsonlSink, MemorySink, open_sink
from repro_torch.observe.tracer import (
    NULL_TRACER,
    NullTracer,
    Span,
    Tracer,
    coerce_tracer,
    get_tracer,
    set_tracer,
)

__all__ = [
    "ChromeTraceSink",
    "JsonlSink",
    "MemorySink",
    "NULL_TRACER",
    "NullTracer",
    "RollingWindow",
    "Span",
    "Tracer",
    "bytes_drift",
    "calibrated_drift",
    "coerce_tracer",
    "get_tracer",
    "model_drift",
    "open_sink",
    "predicted_iteration_seconds",
    "set_tracer",
    "timed_median",
    "timed_median_us",
]
