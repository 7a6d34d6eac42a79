"""Windowed time-series over serve tickets: rolling req/s + percentiles.

Port of ``repro/observe/metrics.py``.  ``latency_percentiles``
(:mod:`repro_torch.serve.packing`) collapses a whole
replay into one aggregate; a *server* wants the last-N-seconds view —
request rate and tail latency as they evolve.  :class:`RollingWindow` is
that view: samples carry the timestamp of the clock that stamped them
(the serve queue's injectable clock, so tests drive it deterministically)
and every read is evaluated "as of now", dropping samples older than the
window.
"""

from __future__ import annotations

from collections import deque

import numpy as np


class RollingWindow:
    """Fixed-horizon sample window (timestamp, value) with rate/percentile
    reads.

    window_s: horizon in clock seconds; samples older than ``now −
              window_s`` fall out on the next read or add.
    """

    def __init__(self, window_s: float = 60.0):
        if not window_s > 0:
            raise ValueError(f"window_s must be > 0, got {window_s!r}")
        self.window_s = float(window_s)
        self._samples: deque[tuple[float, float]] = deque()

    def add(self, ts: float, value: float):
        self._samples.append((float(ts), float(value)))
        self._trim(ts)

    def _trim(self, now: float):
        cutoff = now - self.window_s
        q = self._samples
        while q and q[0][0] < cutoff:
            q.popleft()

    def __len__(self) -> int:
        return len(self._samples)

    def rate(self, now: float) -> float:
        """Samples per second over the window ending at ``now``."""
        self._trim(now)
        return len(self._samples) / self.window_s

    def percentiles(self, now: float) -> dict:
        """``dict(n, mean, p50, p95, p99)`` of the windowed values — the
        same shape as :func:`repro_torch.serve.latency_percentiles`, with None
        values when the window is empty (explicit, never NaN-from-empty)."""
        self._trim(now)
        vals = [v for _, v in self._samples]
        if not vals:
            return dict(n=0, mean=None, p50=None, p95=None, p99=None)
        arr = np.asarray(vals, np.float64)
        return dict(
            n=int(arr.size),
            mean=float(arr.mean()),
            p50=float(np.percentile(arr, 50)),
            p95=float(np.percentile(arr, 95)),
            p99=float(np.percentile(arr, 99)),
        )

    def snapshot(self, now: float) -> dict:
        """Rate + percentiles in one JSON-safe dict (the serve ``stats()``
        time-series entry)."""
        return dict(window_s=self.window_s, rate_rps=self.rate(now),
                    **self.percentiles(now))
