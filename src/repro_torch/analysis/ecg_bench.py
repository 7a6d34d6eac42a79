"""The warm-up + median wall timer of the ECG benchmarks.

Port of ``repro/analysis/ecg_bench.py``'s ``_timeit`` only: the one timer
that the tuner's measure mode (:mod:`repro_torch.tune.microbench`) uses.
The sweeps of that module are ROADMAP.md queue 1 item 12, and its tracer
hook (``repro.observe.timed_median_us``) comes with item 11.
"""

from __future__ import annotations

import time

import numpy as np
import torch


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
    synchronization is a no-op.
    """
    if repeats < 1:
        raise ValueError(f"repeats must be >= 1, got {repeats}")
    fn(*args)
    _sync()
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e6
