"""Measurement helpers (port of ``repro.analysis``): the ECG hot-path
benchmarks of :mod:`repro_torch.analysis.ecg_bench`."""
