"""The warm-up + median wall timer of the ECG benchmarks.

Port of ``repro/analysis/ecg_bench.py``'s ``_timeit`` only: the one timer
that the tuner's measure mode (:mod:`repro_torch.tune.microbench`) uses.
The sweeps of that module are ROADMAP.md queue 1 item 12.
"""

from __future__ import annotations

import torch

from repro_torch.observe import get_tracer, timed_median_us


def _sync() -> None:
    """Wait for the card's queued work, where this process started CUDA: a
    call returns once its launches are enqueued, so a host clock without it
    times the enqueue, not the work."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _timeit(fn, *args, repeats: int = 3) -> float:
    """Median wall **microseconds** per call of ``fn(*args)`` over
    ``repeats`` timed calls, after one untimed warm-up call.

    The warm-up absorbs first-use costs, as the reference's absorbs the
    compile: the kernels' build on the card, and the CUDA-graph capture of
    an exchange whose eager first apply the caller has run (a
    ``HaloExchange`` captures at its second apply,
    :func:`repro_torch.tune.microbench.measure_config`).  Each timed call is
    bracketed by a synchronization, so it times finished device work (the
    reference blocks on the result the same way); on CPU tensors the
    synchronization is a no-op.  The calls go through
    :func:`repro_torch.observe.timed_median_us`, as the reference's, so an
    installed ambient tracer (:func:`repro_torch.observe.set_tracer`) sees
    each timed call as a ``bench/ecg_bench`` span.
    """

    def call(*a):
        out = fn(*a)
        _sync()
        return out

    return timed_median_us(call, *args, repeats=repeats, label="ecg_bench",
                           tracer=get_tracer(), sync=False)
