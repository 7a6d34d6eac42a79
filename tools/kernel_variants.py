#!/usr/bin/env python3
"""Time design variants of the CUDA kernels against each other on the card.

    PYTHONPATH=src python tools/kernel_variants.py [--kernels ecg_tail] base tail_element base

Each named variant is the kernel sources of ``src/repro_torch/kernels/csrc``
with a few text substitutions (``VARIANTS``), copied under
``build/kernel_variants/<name>/csrc`` (gitignored) and built from there;
``base`` is the sources as they are.  ``--kernels`` picks the kernels to
time (default: all of ``KERNELS``); only their sources are built.  For
each variant the script prints the ``ptxas`` line of every kernel that
spills, then one JSON line per kernel and width, Example 2.1's shapes in
float64 (n = 1 310 720): the error against the plain version, the eager
op's CUDA-event time, the kernel's time replayed in a CUDA graph (the
device time without the host's launch path) and the bound (bytes over
3.35 TB/s); a width the variant's launcher refuses prints its error
instead.  ``chol_apply`` at t <= 2 is timed on 16-byte aligned blocks (its
vector path) and on blocks one value off (its staged path); ``ecg_tail``
at t = 20 also on blocks one value off (8-byte copies), and in float32 at
t = 16 to 32 (rows marked ``"dtype": "float32"``).  Compare variants
within one call: run the baseline first and last.  It needs an NVIDIA GPU
and ``nvcc``.
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
#: kernels the script can time, and the source of each
KERNELS = {"chol_apply": "chol_apply", "ecg_tail": "ecg_tail", "fused_gram": "fused_gram"}
#: ecg_tail's mma k loop, and the same D fragments on the CUDA cores:
#: B[m][8nt + 2q + j] is value (m / 4 · NT + nt)·32 + (2q + j)·4 + m % 4 of
#: its matrix's staged fragments
_TAIL_MMA_LOOP = """#pragma unroll
      for (int k = 0; k < KS; ++k) {
        const int at = srow * LS + 4 * k + q;
        const double a_p = sp[at], a_ap = sap[at], a_po = spo[at];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const double* f = frag + (k * NT + nt) * 32 + lane;
          repro::mma_f64(ax[nt], a_p, f[0]);
          repro::mma_f64(ar[nt], a_ap, f[0]);
          repro::mma_f64(az[nt], a_p, f[S::kFrag]);
          repro::mma_f64(az[nt], a_po, f[2 * S::kFrag]);
        }
      }
"""
_TAIL_FMA_LOOP = """#pragma unroll 4
      for (int m = 0; m < TT; ++m) {
        const int at = srow * LS + m;
        const double a_p = sp[at], a_ap = sap[at], a_po = spo[at];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const double* f = frag + (m / 4 * NT + nt) * 32 + (2 * q + j) * 4 + m % 4;
            ax[nt][j] = fma(a_p, f[0], ax[nt][j]);
            ar[nt][j] = fma(a_ap, f[0], ar[nt][j]);
            az[nt][j] = fma(a_p, f[S::kFrag], az[nt][j]);
            az[nt][j] = fma(a_po, f[2 * S::kFrag], az[nt][j]);
          }
        }
      }
"""
#: variant -> {source file: [(text, replacement), ...]}
VARIANTS = {
    "base": {},
    # chol_apply above 16 columns without the two-CTA register cap
    "chol_lb1": {"chol_apply.cu": [("__launch_bounds__(repro::kThreads, TT > 16 ? 2 : 1)",
                                    "__launch_bounds__(repro::kThreads)")]},
    # ecg_tail's previous float64 design up to 16 columns, one thread an
    # element, at every width
    "tail_element": {"ecg_tail.cu": [("constexpr int kMmaMinT = 9;", "constexpr int kMmaMinT = 33;")]},
    # the mma kernel at every width, t = 1..8 too (the crossover)
    "tail_mma_all": {"ecg_tail.cu": [
        ("constexpr int kMmaMinT = 9;", "constexpr int kMmaMinT = 1;"),
        ("REPRO_TAIL_T(9) ", "".join(f"REPRO_TAIL_T({t}) " for t in range(1, 10)))]},
    # the same staging with CUDA-core FMAs instead of the tensor cores
    "tail_fma": {"ecg_tail.cu": [(_TAIL_MMA_LOOP, _TAIL_FMA_LOOP)]},
    # other tiles, stages and warps a CTA
    "tail_rows64_stages2": {"ecg_tail.cu": [("constexpr int kTileRows = 32;", "constexpr int kTileRows = 64;"),
                                            ("constexpr int kStages = 4;", "constexpr int kStages = 2;")]},
    "tail_rows128_stages2": {"ecg_tail.cu": [("constexpr int kTileRows = 32;", "constexpr int kTileRows = 128;"),
                                             ("constexpr int kStages = 4;", "constexpr int kStages = 2;")]},
    "tail_stages2": {"ecg_tail.cu": [("constexpr int kStages = 4;", "constexpr int kStages = 2;")]},
    "tail_stages3": {"ecg_tail.cu": [("constexpr int kStages = 4;", "constexpr int kStages = 3;")]},
    "tail_warps4": {"ecg_tail.cu": [("constexpr int kMmaWarps = 8;", "constexpr int kMmaWarps = 4;")]},
    # staged rows of 4·cdiv(t, 4) values, unpadded: A fragments meet on banks
    "tail_unpadded": {"ecg_tail.cu": [("return (t + 3) / 8 * 8 + 4;", "return (t + 3) / 4 * 4;")]},
}


CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"


def variant_sources(name: str) -> dict[str, str]:
    """The source files variant ``name`` changes, as it changes them."""
    out = {}
    for fname, subs in VARIANTS[name].items():
        text = (CSRC / fname).read_text()
        for old, new in subs:
            if old not in text:
                raise ValueError(f"variant {name}: {old!r} not in {fname}")
            text = text.replace(old, new)
        out[fname] = text
    return out


def use(name: str, build, sources) -> None:
    """Build variant ``name`` of ``sources`` and point the kernel loader at it."""
    dst = ROOT / "build" / "kernel_variants" / name / "csrc"
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(CSRC, dst)
    for fname, text in variant_sources(name).items():
        (dst / fname).write_text(text)
    build.CSRC = dst
    build.SOURCES = {k: v for k, v in build.SOURCES.items() if v in sources}
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


def run(name: str, torch, kernel_names) -> None:
    from repro_torch import kernels
    from repro_torch.kernels import _build
    from repro_torch.kernels.block_update.ref import ecg_tail_ref
    from repro_torch.kernels.chol_apply.ref import chol_apply_ref
    from repro_torch.kernels.fused_gram.ref import fused_gram_ref

    use(name, _build, {KERNELS[k] for k in kernel_names})
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float64):
        return torch.randn(*shape, generator=gen, device=dev, dtype=dtype)

    def off(m):
        """A copy of ``m`` one value off a 16-byte boundary."""
        v = torch.empty(m.numel() + 1, dtype=m.dtype, device=dev)[1:].view(m.shape)
        return v.copy_(m)

    def err(got, want):
        return max(float((g - w).abs().max()) for g, w in zip(got, want))

    def log(kernel, t, fn, want, bytes_, **extra):
        try:
            row = {"max_abs_err": err(fn(), want), "event_ms": event_ms(torch, fn), "graph_ms": graph_ms(torch, fn)}
        except RuntimeError as e:  # a launch the variant's launcher refuses
            row = {"error": str(e)}
        print(json.dumps({"variant": name, "kernel": kernel, "t": t, **row,
                          "bound_ms": bytes_ / HBM_BYTES_PER_S * 1e3, **extra}), flush=True)

    if "chol_apply" in kernel_names:
        for t in (1, 2, 20, 24, 32):
            q = randn(t, t)
            c = torch.linalg.cholesky(q @ q.T / t + torch.eye(t, dtype=torch.float64, device=dev)).T.contiguous()
            z, az = randn(N, t), randn(N, t)
            want = chol_apply_ref(c, z, az)
            extra = {}
            if t <= 2:  # the same blocks one value off a 16-byte boundary: the staged path
                shifted = [off(z), off(az)]
                extra = {"staged_graph_ms": graph_ms(torch, lambda: kernels.chol_apply(c, *shifted)),
                         "staged_max_abs_err": err(kernels.chol_apply(c, *shifted), want)}
            log("chol_apply", t, lambda: kernels.chol_apply(c, z, az), want, 4 * N * t * 8, **extra)
            del z, az
    if "ecg_tail" in kernel_names:
        for t in (1, 2, 4, 5, 6, 8, 9, 10, 11, 12, 16, 20, 24, 28, 32):
            ops = tuple(randn(N, t) for _ in range(5)) + tuple(randn(t, t) for _ in range(3))
            want = ecg_tail_ref(*ops)
            extra = {}
            if t == 20:
                shifted = tuple(off(m) for m in ops[:5]) + ops[5:]
                extra = {"offset_graph_ms": graph_ms(torch, lambda: kernels.ecg_tail(*shifted)),
                         "offset_max_abs_err": err(kernels.ecg_tail(*shifted), want)}
            log("ecg_tail", t, lambda: kernels.ecg_tail(*ops), want, (8 * N * t + 3 * t * t) * 8, **extra)
            del ops, want
            torch.cuda.empty_cache()
        for t in (16, 17, 20, 24, 28, 32):
            ops = tuple(randn(N, t, dtype=torch.float32) for _ in range(5)) + tuple(
                randn(t, t, dtype=torch.float32) for _ in range(3))
            log("ecg_tail", t, lambda: kernels.ecg_tail(*ops), ecg_tail_ref(*ops), (8 * N * t + 3 * t * t) * 4,
                dtype="float32")
            del ops
            torch.cuda.empty_cache()
    if "fused_gram" in kernel_names:
        for t in (20, 24, 28, 32):
            ops = tuple(randn(N, t) for _ in range(4))
            log("fused_gram", t, lambda: (kernels.fused_gram(*ops),), (fused_gram_ref(*ops),),
                (4 * N * t + 3 * t * t) * 8)
            del ops
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", default=",".join(KERNELS), help="kernels to time, comma-separated")
    ap.add_argument("variants", nargs="*", default=["base"])
    args = ap.parse_args(argv)
    kernel_names = args.kernels.split(",")
    unknown = [v for v in args.variants if v not in VARIANTS] + [k for k in kernel_names if k not in KERNELS]
    if unknown:
        print(f"unknown variants or kernels {unknown}; known: {sorted(VARIANTS)}, {sorted(KERNELS)}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_variants: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip(), flush=True)
    for name in args.variants:
        run(name, torch, kernel_names)
    return 0


if __name__ == "__main__":
    sys.exit(main())
