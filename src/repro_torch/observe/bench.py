"""The one warmup + median-of-k wall timer, as measured tracer spans.

Port of ``repro/observe/bench.py``: every timed call is one ``bench/<label>``
span, so a sweep run with a tracer installed shows its timing loop in
``chrome://tracing``.  Where the reference blocks on a JAX result
(``block_until_ready``), the port synchronizes the current CUDA stream of
each device the result's tensors lie on: a kernel call returns once its
launches are enqueued, so a host clock without it times the enqueue, not
the work.  Results on the CPU (and host values) need no synchronization.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.observe.tracer import Tracer

#: sink-less tracer whose spans are measured and dropped — the timing
#: backend when the caller installs no (enabled) tracer of their own
_MEASURER = Tracer()


def _cuda_devices(out, found: set) -> set:
    """The CUDA devices of the tensors in ``out`` (nested tuples, lists and
    dict values are walked)."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            found.add(out.device)
    elif isinstance(out, (tuple, list)):
        for o in out:
            _cuda_devices(o, found)
    elif isinstance(out, dict):
        for o in out.values():
            _cuda_devices(o, found)
    return found


def _sync(out):
    """Wait until ``out``'s device work is done: synchronize the current
    stream of every CUDA device its tensors lie on (no-op otherwise)."""
    for dev in _cuda_devices(out, set()):
        torch.cuda.current_stream(dev).synchronize()
    return out


def timed_median(fn, *args, repeats: int = 3, warmup: int = 1,
                 label: str = "timed", tracer=None, sync=True, **kw):
    """``(result, median wall seconds per call)`` over ``repeats`` timed
    calls of ``fn(*args, **kw)``.

    warmup: untimed leading calls (builds and caches; 0 to time cold).
    tracer: each timed call becomes one ``bench/<label>`` span on it; a
            None or disabled tracer falls back to a sink-less measuring
            tracer (pure timing, zero records).
    sync:   synchronize the streams of the result's CUDA tensors inside
            the timed region (set False for host-only callables).
    """
    if repeats < 1:
        raise ValueError(f"repeats must be >= 1, got {repeats}")
    tr = tracer if (tracer is not None and tracer.enabled) else _MEASURER
    out = None
    for _ in range(warmup):
        out = fn(*args, **kw)
        if sync:
            _sync(out)
    ts = []
    for i in range(repeats):
        with tr.span(f"bench/{label}", cat="bench", rep=i) as sp:
            out = fn(*args, **kw)
            if sync:
                _sync(out)
        ts.append(sp.dur)
    return out, float(np.median(ts))


def timed_median_us(fn, *args, **kw) -> float:
    """Median wall **microseconds** per call — the ``_timeit`` signature the
    kernel and exchange sweeps print."""
    _, s = timed_median(fn, *args, **kw)
    return s * 1e6
