#!/usr/bin/env python3
"""Seconds of the CSR -> Block-ELL conversion of Example 2.1.

    PYTHONPATH=src python tools/time_block_ell.py [--elements 320,256] \
        [--block 16] [--tile 8,8] [--reps 2] [--device cuda|cpu] [--mesh 2,4]

Builds ``dg_laplace_2d(elements, block)`` on ``--device`` (the paper's
Example 2.1 at full scale by default, ~104.5M nonzeros), then times
``block_ell_meta`` (the tile analysis) and ``csr_arrays_to_block_ell``
(the fill) ``--reps`` times each on the host clock; the arrays cross to
the host inside each call, as in ``ECGSolver.build``.  Prints one JSON
line per repetition and one with the medians.  With ``--mesh N,PPN`` it
times instead the distributed build of ``chip_smoke.py`` phase 6
(``ECGSolver.build`` on a ``VirtualMesh(N, PPN)`` on ``--device``,
``optimal``, t = 8, pallas, the partition made once beforehand): the
per-rank conversions, the plan and the exchange arrays, synchronized.  Run
it with ``src`` of two checkouts on ``PYTHONPATH`` to compare their
conversions on one machine.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--elements", default="320,256")
    ap.add_argument("--block", type=int, default=16)
    ap.add_argument("--tile", default="8,8")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default=None, help="N,PPN: time the distributed build instead")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.kernels.bsr_spmbv import ops
    from repro_torch.sparse import dg_laplace_2d

    elements = tuple(int(x) for x in args.elements.split(","))
    br, bc = (int(x) for x in args.tile.split(","))
    t0 = time.perf_counter()
    a = dg_laplace_2d(elements, block=args.block, device=args.device)
    gen_s = time.perf_counter() - t0
    if args.mesh:
        return time_distributed(torch, a, args, (br, bc), gen_s)
    rows = []
    for rep in range(args.reps):
        t0 = time.perf_counter()
        meta = ops.block_ell_meta(a, br, bc)
        meta_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        blocks, indices = ops.csr_arrays_to_block_ell(a.indptr, a.indices, a.data, a.shape[0], a.shape[1],
                                                      br, bc, nbr=meta["nbr"], kmax=meta["kmax"])
        fill_s = time.perf_counter() - t0
        rows.append({"rep": rep, "meta_s": meta_s, "fill_s": fill_s, "total_s": meta_s + fill_s})
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({
        "module": str(Path(ops.__file__).resolve()), "elements": list(elements), "block": args.block,
        "tile": [br, bc], "n": a.shape[0], "nnz": a.nnz, "kmax": meta["kmax"], "device": args.device,
        "torch_threads": torch.get_num_threads(), "gen_s": gen_s,
        "blocks_checksum": float(blocks.sum()), "indices_checksum": int(indices.astype("int64").sum()),
        **{f"median_{k}": statistics.median(r[k] for r in rows) for k in ("meta_s", "fill_s", "total_s")},
    }), flush=True)
    return 0


def time_distributed(torch, a, args, tile, gen_s) -> int:
    from repro_torch.launch.mesh import VirtualMesh
    from repro_torch.solver import CommConfig, ECGSolver, KernelConfig, SolverConfig
    from repro_torch.sparse.partition import partition_csr

    n_nodes, ppn = (int(x) for x in args.mesh.split(","))
    mesh = VirtualMesh(n_nodes, ppn, device=args.device)
    t0 = time.perf_counter()
    pm = partition_csr(a, mesh.p)
    partition_s = time.perf_counter() - t0
    cfg = SolverConfig(t=8, comm=CommConfig(strategy="optimal"),
                       kernel=KernelConfig(backend="pallas", ell_block=tile))
    rows = []
    for rep in range(args.reps):
        if args.device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        op = ECGSolver.build(a, mesh, cfg, pm=pm).op
        if args.device == "cuda":
            torch.cuda.synchronize()
        rows.append({"rep": rep, "operator_s": time.perf_counter() - t0})
        print(json.dumps(rows[-1]), flush=True)
    blocks, indices = op.ell["blocks"], op.ell["indices"]
    print(json.dumps({
        "module": str(Path(sys.modules[ECGSolver.__module__].__file__).resolve()), "mesh": [n_nodes, ppn],
        "elements": args.elements, "block": args.block, "tile": list(tile), "n": a.shape[0], "nnz": a.nnz,
        "device": args.device, "ell_device": str(blocks.device), "gen_s": gen_s, "partition_s": partition_s,
        "blocks_shape": list(blocks.shape), "blocks_checksum": float(blocks.double().sum()),
        "indices_checksum": int(indices.long().sum()),
        "median_operator_s": statistics.median(r["operator_s"] for r in rows),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
