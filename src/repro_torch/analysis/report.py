"""Render dry-run JSON into roofline tables.

    PYTHONPATH=src python -m repro_torch.analysis.report experiments/dryrun_torch.json

Port of ``repro/analysis/report.py``: on the reference's JSON the same
text, byte for byte.  The roofline table's caption names the machine the
records were priced with (their ``roofline["machine"]``; "v5e constants"
where the key is absent, as in the reference's records).  Where the
machine's link rate is unmeasured the collective column says so, and a
line under the table says that the memory term is an unfused upper bound.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path


def fmt_bytes(b: float) -> str:
    return f"{b/2**30:.2f}"


def _hint(r: dict) -> str:
    """One sentence on what would move the dominant term down."""
    rl = r["roofline"]
    dom = rl["dominant"]
    kind = r.get("kind", "")
    if dom == "memory":
        if kind in ("train", "prefill"):
            return "fuse/chunk attention + chunked CE loss to kill S×S and fp32-logit HBM traffic"
        return "widen per-chip batch or quantize KV cache; decode is bandwidth-bound by design"
    if dom == "collective":
        if r.get("arch", "").endswith("moe_42b") or "moe" in r.get("arch", ""):
            return "cast TP/EP combine psums to bf16 and overlap expert all-reduce with attention"
        return "reshard: bf16 psums, fold pod-axis gradient allreduce into hierarchical 2-step schedule"
    return "increase per-chip arithmetic intensity (larger microbatch) or reduce remat recompute"


def _machine(singles: list[dict]) -> str:
    """The caption's constants: the records' machine, or the reference's."""
    return next((r["roofline"]["machine"] for r in singles if "machine" in r["roofline"]), "v5e")


def _collective(rl: dict) -> str:
    c = rl["collective_s"]
    return "link rate unmeasured" if c is None else f"{c:.3g}"


def render(path: str) -> str:
    rs = json.loads(Path(path).read_text())
    singles = [r for r in rs if r.get("mesh") == "single" and "roofline" in r]
    multis = [r for r in rs if r.get("mesh") == "multi" and "memory" in r]
    skips = [r for r in rs if "skipped" in r]
    errors = [r for r in rs if "error" in r]

    out = []
    out.append("### Dry-run summary\n")
    out.append(
        f"- compiled cells: {len([r for r in rs if 'memory' in r])} "
        f"(single-pod {len(singles)} with roofline costs, multi-pod {len(multis)}); "
        f"skipped {len(skips)} (documented long_500k/full-attention cells); errors {len(errors)}\n"
    )

    out.append(f"\n### Roofline table (single-pod 16x16 = 256 chips, {_machine(singles)} constants)\n")
    out.append(
        "| arch | shape | compute s | memory s | collective s | dominant | "
        "MODEL/HLO flops | roofline frac | temp GiB/dev | hint |"
    )
    out.append("|---|---|---|---|---|---|---|---|---|---|")
    order = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2, "long_500k": 3}
    for r in sorted(singles, key=lambda r: (r["arch"], order.get(r["shape"], 9))):
        rl = r["roofline"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {rl['compute_s']:.3g} | {rl['memory_s']:.3g} "
            f"| {_collective(rl)} | **{rl['dominant']}** | {rl['useful_flops_ratio']:.2f} "
            f"| {rl['roofline_fraction']:.3f} | {fmt_bytes(r['memory']['temp_bytes_per_dev'])} "
            f"| {_hint(r)} |"
        )
    if any("machine" in r["roofline"] for r in singles):
        out.append(
            "\nmemory s: every aten op's input and output bytes over the HBM rate, an unfused "
            "upper bound; collective s: the recorded calls' bytes over the link rate"
            + (" (link rate unmeasured: not priced)"
               if any(r["roofline"]["collective_s"] is None for r in singles) else "")
        )

    out.append("\n### Multi-pod (2x16x16 = 512 chips) compile matrix\n")
    out.append("| arch | shape | compiled | temp GiB/dev | collective schedule |")
    out.append("|---|---|---|---|---|")
    for r in sorted(multis, key=lambda r: (r["arch"], order.get(r["shape"], 9))):
        sched = ", ".join(f"{k}:{v}" for k, v in r["collective_ops_schedule"].items() if v)
        out.append(
            f"| {r['arch']} | {r['shape']} | yes ({r['compile_s']}s) "
            f"| {fmt_bytes(r['memory']['temp_bytes_per_dev'])} | {sched} |"
        )

    out.append("\n### Skipped cells\n")
    for r in sorted(skips, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        if r["mesh"] == "single":
            out.append(f"- {r['arch']} × {r['shape']}: {r['skipped']}")
    if errors:
        out.append("\n### Errors\n")
        for r in errors:
            out.append(f"- {r['arch']} × {r['shape']} × {r['mesh']}: {r['error'][:200]}")
    return "\n".join(out)


if __name__ == "__main__":
    print(render(sys.argv[1] if len(sys.argv) > 1 else "experiments/dryrun_torch.json"))
