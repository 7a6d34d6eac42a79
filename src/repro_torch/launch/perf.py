"""Performance sweeps, ECG mode: the kernel-vs-oracle and overlap-vs-blocking
sweeps of :mod:`repro_torch.analysis.ecg_bench` into one JSON file.

    PYTHONPATH=src python -m repro_torch.launch.perf --ecg [--device cpu] \
        [--out experiments/ecg_perf_torch.json] [--only SUBSTRING]

Port of the ``--ecg`` half of ``repro/launch/perf.py``: the same operator
(``dg_laplace_2d((16, 12), block=8)``, float64), the same 2 × 4
("node", "proc") mesh (a :class:`~repro_torch.launch.mesh.VirtualMesh`, all
eight ranks on ``--device``), the same sweeps and the same printed lines.
``--device`` defaults to ``cuda`` (the kernels) and takes ``cpu`` (their
plain versions).  The reference's other half re-lowers its transformer
cells; it is not ported (ROADMAP.md queue 1 item 13, remainder: part 6).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

DEFAULT_OUT = "experiments/ecg_perf_torch.json"


def run_ecg_sweep(out_path: Path, only: str | None = None, device="cuda") -> list[dict]:
    """ECG hot-path measurements on an 8-rank (2, 4) virtual mesh: 32
    overlap-vs-blocking rows and 12 kernel-vs-oracle rows, filtered by
    ``only`` (a substring of the row name), printed and written to
    ``out_path`` as JSON.  Returns the rows."""
    from repro_torch.analysis.ecg_bench import kernel_vs_oracle, overlap_vs_blocking_sweep
    from repro_torch.launch.mesh import make_solver_mesh
    from repro_torch.sparse import dg_laplace_2d

    mesh = make_solver_mesh(n_ranks=8, ppn=4, device=device)
    a = dg_laplace_2d((16, 12), block=8, device=mesh.device)
    rows = (overlap_vs_blocking_sweep(a, mesh, ts=(4, 8))
            + kernel_vs_oracle(device=mesh.device))
    if only:
        rows = [r for r in rows if only in r["name"]]
    for r in rows:
        print(f"ECG {r['name']}: {r['us']:.1f}us  {r['derived']}", flush=True)
    Path(out_path).write_text(json.dumps(rows, indent=1))
    print("ecg perf pass done", flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help=f"output JSON (default: {DEFAULT_OUT})")
    ap.add_argument("--only", default=None, help="substring filter on the row names")
    ap.add_argument("--ecg", action="store_true",
                    help="run the ECG kernel/overlap sweep (the only mode ported)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if not args.ecg:
        raise NotImplementedError(
            "the transformer-cell perf pass is not ported yet (ROADMAP.md queue 1 "
            "item 13, remainder: part 6); run with --ecg"
        )
    out_path = Path(args.out or DEFAULT_OUT)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    run_ecg_sweep(out_path, args.only, device=args.device)


if __name__ == "__main__":
    main()
