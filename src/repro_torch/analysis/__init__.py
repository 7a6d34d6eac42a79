"""Measurement helpers (port of ``repro.analysis``; only the timer that the
tuner's measure mode uses is ported so far)."""
