#!/usr/bin/env python3
"""Time design variants of the CUDA kernels against each other on the card.

    PYTHONPATH=src python tools/kernel_variants.py base chol_lb1 tail_one_element

Each named variant is the kernel sources of ``src/repro_torch/kernels/csrc``
with a few text substitutions (``VARIANTS``), copied under
``build/kernel_variants/<name>/csrc`` (gitignored) and built from there;
``base`` is the sources as they are.  For each variant the script prints the
``ptxas`` line of every kernel that spills, then one JSON line per kernel
and width, Example 2.1's shapes in float64 (n = 1 310 720): the error
against the plain version, the eager op's CUDA-event time, the kernel's
time replayed in a CUDA graph (the device time without the host's launch
path) and the bound (bytes over 3.35 TB/s).  ``chol_apply`` at t <= 2 is
timed on 16-byte aligned blocks (its vector path) and on blocks one value
off (its staged path).  Compare variants within one call: run the
baseline first and last.  It needs an NVIDIA GPU and ``nvcc``.
"""

from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
N = 1_310_720
HBM_BYTES_PER_S = 3.35e12
#: variant -> {source file: [(text, replacement), ...]}
VARIANTS = {
    "base": {},
    # chol_apply above 16 columns without the two-CTA register cap
    "chol_lb1": {"chol_apply.cu": [("__launch_bounds__(repro::kThreads, TT > 16 ? 2 : 1)",
                                    "__launch_bounds__(repro::kThreads)")]},
    # ecg_tail's one-thread-per-element design at every width
    "tail_one_element": {"ecg_tail.cu": [("constexpr int kTiledMinT = 17;",
                                         "constexpr int kTiledMinT = 33;")]},
    # other register tilings of ecg_tail (columns x rows a thread)
    "tail_4x2": {"ecg_tail.cu": [("constexpr int kJ = 2;", "constexpr int kJ = 4;"),
                                 ("constexpr int kRR = 4;", "constexpr int kRR = 2;")]},
    "tail_8x1": {"ecg_tail.cu": [("constexpr int kJ = 2;", "constexpr int kJ = 8;"),
                                 ("constexpr int kRR = 4;", "constexpr int kRR = 1;")]},
}


def use(name: str, build) -> None:
    """Build variant ``name`` and point the kernel loader at it."""
    src = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    dst = ROOT / "build" / "kernel_variants" / name / "csrc"
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(src, dst)
    for fname, subs in VARIANTS[name].items():
        text = (dst / fname).read_text()
        for old, new in subs:
            if old not in text:
                raise ValueError(f"variant {name}: {old!r} not in {fname}")
            text = text.replace(old, new)
        (dst / fname).write_text(text)
    build.CSRC = dst
    build._libs.clear()
    build._fns.clear()
    build.build_all()
    for row in build.ptxas_usage():
        if row.get("spill_stores"):
            print(json.dumps({"variant": name, "ptxas": row}), flush=True)


def event_ms(torch, fn, reps=20, batches=5) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(batches):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return statistics.median(out)


def graph_ms(torch, fn, reps=20, batches=5) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(batches):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return statistics.median(out)


def run(name: str, torch) -> None:
    from repro_torch import kernels
    from repro_torch.kernels import _build
    from repro_torch.kernels.block_update.ref import ecg_tail_ref
    from repro_torch.kernels.chol_apply.ref import chol_apply_ref
    from repro_torch.kernels.fused_gram.ref import fused_gram_ref

    use(name, _build)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev, dtype=torch.float64)

    def err(got, want):
        return max(float((g - w).abs().max()) for g, w in zip(got, want))

    def log(kernel, t, fn, want, bytes_, **extra):
        print(json.dumps({"variant": name, "kernel": kernel, "t": t, "max_abs_err": err(fn(), want),
                          "event_ms": event_ms(torch, fn), "graph_ms": graph_ms(torch, fn),
                          "bound_ms": bytes_ / HBM_BYTES_PER_S * 1e3, **extra}), flush=True)

    for t in (1, 2, 20, 24, 32):
        q = randn(t, t)
        c = torch.linalg.cholesky(q @ q.T / t + torch.eye(t, dtype=torch.float64, device=dev)).T.contiguous()
        z, az = randn(N, t), randn(N, t)
        want = chol_apply_ref(c, z, az)
        extra = {}
        if t <= 2:  # the same blocks one value off a 16-byte boundary: the staged path
            off = [torch.empty(N * t + 1, dtype=torch.float64, device=dev)[1:].view(N, t) for _ in range(2)]
            off[0].copy_(z)
            off[1].copy_(az)
            extra = {"staged_graph_ms": graph_ms(torch, lambda: kernels.chol_apply(c, *off)),
                     "staged_max_abs_err": err(kernels.chol_apply(c, *off), want)}
        log("chol_apply", t, lambda: kernels.chol_apply(c, z, az), want, 4 * N * t * 8, **extra)
        del z, az
    for t in (16, 20, 24, 28, 32):
        ops = tuple(randn(N, t) for _ in range(5)) + tuple(randn(t, t) for _ in range(3))
        log("ecg_tail", t, lambda: kernels.ecg_tail(*ops), ecg_tail_ref(*ops), (8 * N * t + 3 * t * t) * 8)
        del ops
    for t in (20, 24, 28, 32):
        ops = tuple(randn(N, t) for _ in range(4))
        log("fused_gram", t, lambda: (kernels.fused_gram(*ops),), (fused_gram_ref(*ops),),
            (4 * N * t + 3 * t * t) * 8)
        del ops
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    import torch

    names = (argv if argv is not None else sys.argv[1:]) or ["base"]
    unknown = [v for v in names if v not in VARIANTS]
    if unknown:
        print(f"unknown variants {unknown}; known: {sorted(VARIANTS)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_variants: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip(), flush=True)
    for name in names:
        run(name, torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
