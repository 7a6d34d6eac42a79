#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which raises on failure (exit code != 0, no result line):

1. setup — the card's name and power limit (nvidia-smi), torch and CUDA
   versions, and the build of every CUDA kernel from ``src/repro_torch``,
   with each kernel's registers, static shared memory and spill bytes as
   ``nvcc -Xptxas -v`` reported them (one ``ptxas`` line each).
2. main-path build — Example 2.1 at full scale (``dg_laplace_2d((320, 256),
   block=16)``: 1 310 720 rows, ~104.5M nonzeros) and an ``ECGSolver`` with
   t = 8, tol = 1e-8·‖b‖, ``backend="pallas"`` on the card.
3. kernel checks — each kernel against its plain torch version at the main
   path's shapes (f64, t = 8) and at t = 1 and in f32, ``bsr_spmbv``,
   ``fused_gram`` and ``ecg_tail`` also at t = 4 and 16 in f64 (the serve
   phases' solves and packs); one JSON line each with the kernel path
   its wrapper chose (where it has two), its error, the tolerance, and
   CUDA-event times of the kernel, the plain version and one PyTorch library
   call of the same function (a yardstick only; the port never calls it),
   beside the least time the card could take (bytes over 3.35 TB/s or flops
   over the peak rate).  Two calls of ``bsr_spmbv`` and ``fused_gram`` at
   the main path's shapes must be bit-identical.
   ``chol_apply`` (P = Z·C⁻¹ and AP = AZ·C⁻¹ in one launch) on the factor
   C of a real gram1 ZᵀAZ of this operator, at (n, 8) float64, at t = 1 and
   in float32: within 2·t·eps·κ(C)·max|y| (the forward error bound of a
   t-term substitution) of the ``solve_triangular`` plain version, whose
   two calls are the library yardstick; a NaN factor must give NaN blocks.
4. main path — the solve, with every kernel's launch count set to 0 just
   before it and read just after: ``bsr_spmbv`` must launch n_iters + 1
   times (the width-1 initial residual), ``fused_gram``, ``ecg_tail`` and
   ``chol_apply`` n_iters times; the true residual ‖b − A·x‖ (plain CSR
   SpMV on the card) must be ≤ 10·tol.
5. cross-check — a (64, 64)-element solve with ``backend="pallas"`` and
   twice with ``backend="jnp"``: the two jnp solves bit-identical (the CSR
   product sums without atomics); pallas against jnp, iteration counts
   within one (the two sum in different orders, and this DG operator at
   1e-8·‖b‖ amplifies rounding), x equal to 1e-8 (relative to max|x|).
6. distributed build — the same operator on a ``VirtualMesh(2, 4)`` (all 8
   ranks on the card), ``strategy="optimal"``, t = 8, ``backend="pallas"``:
   partition, plan and Block-ELL conversion seconds.
7. distributed kernel checks — ``halo_pack`` and ``halo_unpack`` on the
   plan's widest phase (p = 8 ranks) at w = 8 and w = 1 in float64 and at
   w = 8 in float32 (the pack also into a given buffer), which must equal
   their plain versions exactly (the unpack's dump slot aside), the
   batched ``fused_gram`` at (8, rmax, 8), bit-identical over two calls,
   and ``chol_apply`` on the stacked (8·rmax, 8) rows;
   times as in phase 3, the library calls being advanced indexing
   ``src[rank_ids, idx]`` and ``index_put_``: ``kernel_ms`` is the public
   op's eager time, ``kernel_graph_ms`` its time from a CUDA-graph replay,
   without the host's launch overhead.  One ``exchange`` line times a whole
   exchange of the main path's width, eager against its CUDA graph, with
   the host's launch calls of each (``torch.profiler``); the replay must
   equal the eager exchange bit for bit, and over a few replays the halo
   kernels the profiler sees on the device must equal the counts the
   replays added and len(plan.phases) per replay.
8. distributed main path — the solve on the mesh, with the launch counts
   and the mesh counters set to 0 just before it: ``halo_pack`` and
   ``halo_unpack`` must launch len(plan.phases)·(n_iters + 1) times,
   ``bsr_spmbv`` n_iters + 1, ``fused_gram``, ``ecg_tail`` and
   ``chol_apply`` n_iters;
   ``mesh.psum`` must run 3·n_iters + 1 times; the true residual of the
   unsharded x must be ≤ 10·tol and n_iters within 1% of phase 4's.
9. strategies — one distributed SpMBV for ``standard``, ``2step``,
   ``3step`` and ``optimal`` with ``col_split=2``, each a ``with_config``
   sibling on the same partition, against the sequential Block-ELL apply
   (1e-12 relative); the same apply twice more, through the exchange's
   CUDA graph (captured at the second apply), must equal the first, eager
   one bit for bit.
10. distributed cross-check — the (64, 64)-element problem on the (2, 4)
    mesh with all four strategies: the four solves bit-identical; against
    the sequential pallas solve, iteration counts within one and x equal to
    1e-8 (relative to max|x|).
11. block-Jacobi build — the full-scale handle's ``with_config(precondition=
    dict(kind="block_jacobi", block=16))`` sibling (the operator reused):
    extract / factor / transfer seconds and the factors' bytes.
12. ``block_trisolve`` checks — the kernel against its plain version (two
    batched triangular solves) at the main path's shape (81 920 blocks of
    16, t = 8, f64, the real factors), at t = 1, in f32, and at bs = 32 and
    64 (random SPD blocks): error within 2·bs·eps·κ·max|y| (the forward
    error bound of two triangular solves, κ the worst block's condition
    number), times as in phase 3 (the plain version and the library call
    ``torch.cholesky_solve`` at every size);
    and ``block_update`` (which no path launches, as in the reference) at
    (n, 8) f64, t = 1 and f32, the library call two ``addmm``.
13. preconditioned main path — the full-scale block-Jacobi solve at block
    16 and at the default block, 32 (``PreconditionConfig.block``; 40 960
    factors of 32×32), each with the launch counts set to 0 just before it:
    ``block_trisolve`` and ``bsr_spmbv`` n_iters + 1 launches (the start
    Z₀ = M⁻¹T(r₀)), ``ecg_tail`` and ``chol_apply`` n_iters, ``fused_gram``
    0 (the preconditioned recurrence reduces [PᵀR | APᵀW | AP_oldᵀW] with
    plain products, as the reference's ``gram2p``); true residual ≤ 10·tol
    and fewer iterations than phase 4.
14. distributed preconditioned main path — the same two solves on the
    (2, 4) mesh (``optimal``), held to the same gates and besides:
    iterations within 1% of phase 13's at the same block, one
    ``block_trisolve`` launch per apply for all 8 ranks (n_iters + 1),
    ``mesh.psum`` 3·n_iters + 1 (the preconditioner adds none), the
    exchange counts of phase 8.  One helper, ``bj_solve``, runs all four
    solves and holds every gate.
15. Chebyshev — the (64, 64)-element problem sequential and with the four
    strategies: ``bsr_spmbv`` degree·(n_iters + 1) launches per solve, the
    four distributed solves bit-identical, against the sequential one
    iterations within one and x to 1e-8.
16. inexact — ``fd_laplace_2d(256)`` (65 536 rows; the DG operator does not
    converge under it) at t = 1 (the flexible recurrence breaks down at
    t = 4 and 8 there, in the reference too) sequential and on the mesh:
    converged, true residual ≤ 10·tol, at least one flexible reseed.
17. ``rank_apply_check`` — the adaptive solver's rank-revealing apply (the
    pivoted factorization of G and its apply to Z and AZ, one launch)
    against its substitution-form plain version ``rank_apply_dense`` at
    (1 310 720, 8) ×2 f64, on three Gs: a full-rank gram1, one of rank 4
    (four columns of Z combinations of the other four) and one holding NaN
    (rank 0, zero blocks); rank and pivot order must be equal, the blocks
    within 2·t·eps·κ(L)·max|y|; times as in phase 3, the library call being
    the reference's route in torch (the factor loop, ``solve_triangular``,
    ``.contiguous()`` and the mask); also t = 4 and f32.  ``drop_mask`` (the
    stagnation drop, one warp) against its plain version: mask and counts
    equal; no library call computes it.
18. ``adaptive_sequential`` — Example 2.1 at full scale, t = 8, with the
    right-hand side random on the first 4 of 8 contiguous subdomains, zero
    elsewhere (the reference test's ``deficient_rhs``): without a policy
    the solve breaks down; with ``adaptive="reduce"`` (a ``with_config``
    sibling) it converges, true residual ≤ 10·tol, ``active_hist`` starting
    [8, 4], first reduction event (1, 8, 4), ``rank_apply`` and
    ``drop_mask`` one launch per iteration and ``chol_apply`` none, and one
    iteration makes exactly one host sync (``torch.profiler``'s runtime
    calls); ms and host launches per iteration.
19. ``adaptive_distributed`` — the same on the (2, 4) mesh (``optimal``):
    ``comm_segments`` [(8, 1), (4, k − 1)], iterations within 1% (or 2) of
    phase 18's and ``active_hist`` equal over the common prefix, ``psum``
    3·k + 1, the halo kernels counted in both widths' exchanges (the
    width-4 graph is captured mid-solve), and the mesh's exchanged elements
    equal to one width-1, one width-8 and k − 1 width-4 exchanges, a width-4
    exchange moving exactly 4/8 of a width-8 one.  Then the width-4
    segment's kernels at its own shapes, each against its plain version at
    phase 3's and phase 7's tolerances: ``bsr_spmbv`` at t = 4 in the ranked
    layout (the library call: the same tiles as one CSR matrix), the halo
    kernels on the widest phase of ``plan.at_width(4)``, and the width-4
    exchange graph the solve captured, equal to the eager exchange bit for
    bit.
20. ``adaptive_full_rank`` — phase 4's system under ``rankrev``, ``reduce``
    and ``reduce+restart``: each converges within phase 4's iterations + 2
    (no spurious drops), with its reduction events and restarts.

Phases 21-28 run the pipelined and s-step schemes and the overlapped SpMBV
at the same full scale.  Each solve sets the launch counts (and the mesh's
counters) to 0 just before it, must converge with the true residual ≤
10·tol, and logs its iterations (blocks for s-step) and ms per iteration:

21. ``pipelined_sequential`` — ``method="pipelined"``: within 1% of phase
    4's iterations; ``bsr_spmbv`` n_iters + 2 launches (r₀ and the AZ₀
    seed), ``fused_gram``, ``ecg_tail`` and ``chol_apply`` n_iters; one
    host synchronization per iteration.
22. ``pipelined_block_jacobi_32_sequential`` — with block-Jacobi 32: within
    1% of phase 13's; ``block_trisolve`` n_iters + 1, ``bsr_spmbv`` n_iters + 2.
23. ``distributed_overlap_main_path`` — classic on the (2, 4) mesh with
    ``CommConfig(overlap=True)`` (the interior/boundary split built on the
    same partition): x, ``res_hist`` and the count equal to phase 8's bit for
    bit, ``bsr_spmbv`` two launches per SpMBV (interior and boundary); one
    SpMBV blocking against overlapped in turns (b, o, o, b), and the device
    timeline of five overlapped SpMBVs (streams, and how long the exchange
    ran beside ``bsr_spmbv`` on the other stream).
24. ``pipelined_distributed`` and ``pipelined_distributed_overlap`` — the
    mesh, blocking and overlapped: ``psum`` 3·k + 1, k + 2 exchanges, within
    1% of phase 21's; the overlapped solve equal to the blocking one bit for
    bit.
25. ``sstep_s2_sequential``, ``sstep_s4_sequential`` — s-step at s = 2 and 4:
    s·k ≤ 2 × phase 4's iterations (the reference sweep's gate),
    ``rank_apply`` k launches at width s·t, ``bsr_spmbv`` s·k + 1, one host
    synchronization per block.
26. ``sstep_s2_distributed`` — s = 2 on the mesh: ``psum`` 3·k + 1, s·k + 1
    exchanges, within 1% of phase 25's blocks.
27. adaptive, on phase 18's deficient b: ``pipelined`` ``reduce``
    sequential and on the mesh (segments [(8, 1), (4, k − 1)]), s-step s = 2
    ``reduce`` and ``reduce+restart`` sequential; each ends with fewer than
    8 active directions, ``rank_apply`` and ``drop_mask`` one launch per
    step, ``chol_apply`` none.
28. the kernels at this slice's shapes, as phase 3: ``rank_apply`` at
    (n, 16) and (n, 32) ×2 in float64 on the first s-step block's monomial
    basis (rank and pivot order equal to the plain version's), with a rank
    deficit, with a NaN in G, and at (n, 32) in float32; ``drop_mask`` on
    (8, 16) and (8, 32) coefficient blocks with a live mask that has holes
    (exact); ``bsr_spmbv`` on the overlap split's interior and boundary
    arrays.  The ``kernels`` line's ``rank_apply`` row gains its times at
    s·t = 16 and 32.

Phases 29-33 run the paper's performance models and the setup-time tuner
on the card, at the same full scale:

29. ``calibrate`` — ``tools/calibrate_h100.py``'s measurements (latencies
    and rates of a ``VirtualMesh(2, 4)`` rotation, the streaming copy, the
    f64 matmul rate, the per-dispatch cost of a captured halo chain) beside
    the committed ``repro_torch.core.machines.H100`` constants, one JSON
    line; every value must be finite and positive.
30. ``bsr_spmbv_tiles`` — ``bsr_spmbv`` at every tile of the tuner's
    ``DEFAULT_TILES`` on Example 2.1 (sequential Block-ELL, f64, t = 8), in
    phase 3's format: the path (mma/fma), the error against the plain
    version and its tolerance, ms against the bound (the stored tiles and V
    over 3.35 TB/s) and against ``torch.sparse.mm``, kmax, the fill (stored
    elements over nonzeros) and the conversion's seconds.  The ``kernels``
    line's ``bsr_spmbv`` row gains these times.
31. ``tuned_sequential`` — the handle with ``tune="model"`` (the H100's
    constants): the chosen tile and kmax, the build's seconds, the model's
    local time per tile, and the solve: converged, true residual ≤ 10·tol,
    ``bsr_spmbv`` n_iters + 1 launches on the tuned tile; ms per iteration
    beside phase 4's.
32. ``tuned_distributed`` — on the (2, 4) mesh, ``tune(mode=
    "model:structural")`` and ``tune(mode="measure")`` (H100 constants):
    the measured grid (µs per config), the model's grid, both choices and
    ``tune``'s seconds; the measured choice must be the least of its own
    grid.  It then solves (true residual ≤ 10·tol, ``bsr_spmbv`` one launch
    per SpMBV, two with overlap, ``psum`` 3·k + 1), and its ``TunedConfig``,
    through ``to_json``/``from_json``, rebuilds the same operator: strategy,
    tile, overlap, col_split and the plan's wire bytes.
33. ``auto_t`` — ``SolverConfig(t="auto")`` sequential: the ``TSelection``
    table, ``probe_iters_used``, the chosen t and tile, the build's seconds;
    the solve converges to ≤ 10·tol at the chosen t, with the launch counts
    of a ``rankrev`` solve at that t (``rank_apply`` and ``drop_mask`` one
    per iteration, ``chol_apply`` none).  Phase 32's measured descent times
    phase 5's (64, 64)-element operator; its choice then solves at full
    scale.

Phases 34-39 run the serving layer (``repro_torch.serve``) on Example 2.1
at full scale, the reference server's template at t = 4 under ``rankrev``
with ``backend="pallas"``, tol = phase 4's:

34. ``serve_build`` — an ``ECGServer`` with a warm-start cache in a temporary
    directory: the fingerprint's seconds, the cold build's seconds and
    ``conv_analyzed``/``conv_reused``.
35. ``serve_batched`` — ``pack="off"``, 4 distinct requests and 1 duplicate
    payload: one ``solve_many`` batch of 4, ``dedup_shared == 1``; two
    results bit-identical (x, ``res_hist``) to solo ``solver.solve(b)``;
    launches ``bsr_spmbv`` Σ(n_iters + 1), ``fused_gram``, ``ecg_tail``,
    ``rank_apply`` and ``drop_mask`` Σ n_iters; true residual ≤ 10·tol;
    seconds per submit, req/s, latency p50/p95.
36. ``serve_packed`` — ``pack="width"``, ``max_pack_width=16``: the first 4
    requests with absolute tolerances (1e-4, 1e-6, 1e-8, 1e-8)·‖b_j‖ in one
    width-16 pack: each host ``true_relres`` ≤ its tolerance × 1.01,
    retirements ordered by tolerance, ``packed_iters`` ≤ phase 35's slowest
    solve, the kernels launched ``packed_iters`` times (``bsr_spmbv`` once
    more: the full-width initial residual); req/s beside phase 35's.
37. ``serve_packed_distributed`` — the same on ``VirtualMesh(2, 4)``,
    ``optimal``, 3 requests at (1e-4, 1e-6, 1e-8)·‖b_j‖, width 12: segment
    widths strictly decreasing from 12, ``psum`` 3·packed_iters + 1, the
    elements per exchange dropping at each retirement width (and summing to
    the mesh's count), the halo kernels ``len(plan.at_width(w).phases)``
    times per SpMBV of each segment, each relres ≤ tolerance × 1.01.
38. ``serve_restart`` — a second server on the same cache directory with a
    byte budget below both operators: a warm build (``conv_analyzed``
    False), eviction by phase 5's operator, re-admission of Example 2.1
    with ``conv_reused``; cold, warm and re-admitted build seconds.
39. ``serve_trace`` — phases 35-36's traffic again under a
    ``Tracer([ChromeTraceSink])``: the trace holds ``serve/drain``,
    ``serve/dispatch``, ``serve/queue_wait``, ``solve_many/dispatch`` and
    ``solve_packed/dispatch`` spans, the traced results equal the untraced
    ones bit for bit, and the traced over untraced wall time.

The ``kernels`` line's ``bsr_spmbv``, ``fused_gram``, ``ecg_tail`` and
``rank_apply`` rows carry ``widths`` entries for t = 4 and 16 with their
launches in phases 35 and 36.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
# peak flop rate by dtype: f32 outside the tensor cores and f64 on the tensor
# cores are both 67 TFLOP/s on the H100 SXM (NVIDIA data sheet)
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12}
ELEMENTS, BLOCK = (320, 256), 16  # Example 2.1 at full scale
T = 8
T_SERVE = 4  # the serving layer's solver template (phases 34-39)
MAX_ITERS = 5000
REPS, BATCHES = 10, 5
SLOW_MS, SLOW_REPS, SLOW_BATCHES = 2.0, 2, 3


def log(obj) -> None:
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def time_ms(torch, fn) -> float:
    """Median over BATCHES of the mean CUDA-event time of REPS back-to-back
    calls.  A call that takes over SLOW_MS (the host-bound plain and library
    chains) is timed over SLOW_BATCHES batches of SLOW_REPS calls instead:
    its spread is the host's, and more repeats only lengthen the run."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    reps, batches = (SLOW_REPS, SLOW_BATCHES) if start.elapsed_time(end) > SLOW_MS else (REPS, BATCHES)
    per_call = []
    for _ in range(batches):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / reps)
    return statistics.median(per_call)


def time_graph_ms(torch, fn) -> float:
    """Device time per call: REPS calls captured in one CUDA graph, replayed
    (median over BATCHES), so the host's launch overhead drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(REPS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(BATCHES):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / REPS)
    return statistics.median(per_call)


def device_kernel_counts(torch, fn, names) -> dict[str, int]:
    """{name: the device kernels whose symbol contains ``name``} in one call
    of ``fn``, as ``torch.profiler`` records them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counts = dict.fromkeys(names, 0)
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            for name in names:
                if name in e.key:
                    counts[name] += e.count
    return counts


def iteration_calls(torch, fn) -> dict:
    """The host's calls in one call of ``fn`` (after one to warm up), as
    ``torch.profiler`` records them: the launch calls (``LAUNCH_APIS`` of
    ``tools/profile_torch_solve.py``) and the synchronizations, each by API
    name, with their totals; the calls of an empty profiled window (the
    profiler's own synchronization) are subtracted."""
    from profile_torch_solve import launch_calls
    from torch.profiler import ProfilerActivity, profile

    def record(f):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            f()
        torch.cuda.synchronize()
        averages = prof.key_averages()
        return launch_calls(averages) | {
            e.key: e.count for e in averages
            if e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")}

    fn()
    torch.cuda.synchronize()
    empty = record(lambda: None)
    calls = {k: v - empty.get(k, 0) for k, v in record(fn).items()}
    calls = {k: v for k, v in calls.items() if v}
    launches = {k: v for k, v in calls.items() if not k.endswith("Synchronize")}
    syncs = {k: v for k, v in calls.items() if k.endswith("Synchronize")}
    return {"launches": sum(launches.values()), "launch_calls": launches,
            "syncs": sum(syncs.values()), "sync_calls": syncs}


def demangle(names: list[str]) -> list[str]:
    """C++ symbol names as ``c++filt`` prints them (as given without it)."""
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                             text=True, check=True, timeout=60).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        return names
    return out if len(out) == len(names) else names


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch import kernels
    from repro_torch.kernels import _build
    from repro_torch.kernels.block_trisolve.ref import block_trisolve_ref
    from repro_torch.kernels.block_update.ref import block_update_ref, ecg_tail_ref
    from repro_torch.kernels.bsr_spmbv.ops import spmbv_plan
    from repro_torch.kernels.bsr_spmbv.ref import bsr_spmbv_ref
    from repro_torch.adaptive import (
        ReductionPolicy,
        default_rank_rtol,
        pivoted_cholesky,
        resolve_policy,
    )
    from repro_torch.kernels.chol_apply.ref import (
        chol_apply_dense,
        chol_apply_ref,
        drop_mask_ref,
        rank_apply_dense,
        rank_apply_ref,
    )
    from repro_torch.core.node_aware import build_exchange_plan
    from repro_torch.kernels.fused_gram.ops import gram_plan
    from repro_torch.kernels.fused_gram.ref import fused_gram_ref
    from repro_torch.kernels.halo_pack.ops import halo_plan
    from repro_torch.kernels.halo_pack.ref import halo_pack_ref, halo_unpack_ref
    from repro_torch.launch.mesh import VirtualMesh
    from repro_torch.solver import CommConfig, ECGSolver, KernelConfig, SolverConfig
    from repro_torch.sparse import csr_spmv, dg_laplace_2d, fd_laplace_2d, partition_csr

    sys.path.insert(0, str(ROOT / "tools"))
    from profile_torch_solve import host_launches

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 yardsticks in full f32

    # ---------------------------------------------------------------- 1. setup
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    libs = _build.build_all()
    for name in libs:
        _build.load(name)
    log({"phase": "build_kernels", "seconds": time.perf_counter() - t0,
         "libraries": sorted(str(p.relative_to(ROOT)) for p in libs.values())})
    usage = _build.ptxas_usage()
    names = demangle([row["kernel"] for row in usage])
    for row, name in zip(usage, names):
        log({"phase": "ptxas", **row, "kernel": name})

    # ------------------------------------------------------ 2. main-path build
    t0 = time.perf_counter()
    a = dg_laplace_2d(ELEMENTS, block=BLOCK, device=dev)
    gen_s = time.perf_counter() - t0
    n = a.shape[0]
    b = np.random.default_rng(0).standard_normal(n)
    tol = 1e-8 * float(np.linalg.norm(b))
    config = SolverConfig(t=T, tol=tol, max_iters=MAX_ITERS, kernel=KernelConfig(backend="pallas"))
    t0 = time.perf_counter()
    solver = ECGSolver.build(a, config=config, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    blocks = solver.conversion["arrays"]["blocks"]
    indices = solver.conversion["arrays"]["indices"]
    log({"phase": "build_solver", "n": n, "nnz": a.nnz, "blocks": list(blocks.shape),
         "meta_kmax": solver.conversion["meta"]["kmax"],
         "generate_s": gen_s, "build_s": build_s})

    # ---------------------------------------------------------- 3. kernel checks
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev, dtype=dtype)

    csr_by_dtype = {}

    def library_csr(dtype):
        if dtype not in csr_by_dtype:
            csr_by_dtype[dtype] = torch.sparse_csr_tensor(
                a.indptr, a.indices, a.data.to(dtype), size=a.shape)
        return csr_by_dtype[dtype]

    # Each check returns (plain function, its operands, the kernel call, one
    # library call, Σ|terms| per output, terms per output, bytes, flops, shape,
    # the kernel path the wrapper's plan chose or None).
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def check_bsr(t, dtype):
        blk = blocks.to(dtype)
        v = randn(n, t, dtype=dtype)
        plain = lambda blk_, v_: bsr_spmbv_ref(blk_, indices, v_)[:n]
        kernel = lambda: kernels.bsr_spmbv(blk, indices, v, n_rows=n)
        csr = library_csr(dtype)
        library = lambda: torch.sparse.mm(csr, v)
        es = blk.element_size()
        nbr, _, br, bc = blk.shape
        return (plain, (blk, v), kernel, library, plain(blk.abs(), v.abs()),
                blk.shape[1] * blk.shape[3],
                blk.numel() * es + indices.numel() * 4 + 2 * n * t * es,
                2 * blk.numel() * t, list(blk.shape) + [t],
                spmbv_plan(nbr, br, bc, t, n, dtype, sms).path)

    def check_gram(t, dtype):
        ops = tuple(randn(n, t, dtype=dtype) for _ in range(4))
        p, r, ap, apo = ops
        kernel = lambda: kernels.fused_gram(*ops)
        library = lambda: torch.cat([p.T @ r, ap.T @ ap, apo.T @ ap], dim=1)
        return (fused_gram_ref, ops, kernel, library,
                fused_gram_ref(*(o.abs() for o in ops)), n,
                (4 * n * t + 3 * t * t) * p.element_size(), 6 * n * t * t, [n, t],
                gram_plan(1, n, t, dtype, sms).path)

    def check_tail(t, dtype):
        ops = tuple(randn(n, t, dtype=dtype) for _ in range(5)) + tuple(
            randn(t, t, dtype=dtype) for _ in range(3))
        x, r, p, ap, po, c, d, do = ops
        kernel = lambda: kernels.ecg_tail(*ops)
        pcat, dcat = torch.cat([p, po], dim=1), torch.cat([d, do], dim=0)
        library = lambda: (torch.addmm(x, p, c), torch.addmm(r, ap, c, alpha=-1),
                           torch.addmm(ap, pcat, dcat, alpha=-1))
        bound = (x.abs() + p.abs() @ c.abs(), r.abs() + ap.abs() @ c.abs(),
                 ap.abs() + p.abs() @ d.abs() + po.abs() @ do.abs())
        return (ecg_tail_ref, ops, kernel, library, bound, 2 * t + 1,
                (8 * n * t + 3 * t * t) * x.element_size(), 8 * n * t * t, [n, t], None)

    def tup(x):
        return x if isinstance(x, tuple) else (x,)

    def max_diff(xs, ys):
        return max(float((x.double() - y.double()).abs().max()) for x, y in zip(xs, ys))

    def run_check(name, make, t, dtype):
        plain_fn, ops, kernel, library, bound, k_sum, bytes_, flops, shape, path = make(t, dtype)
        plain = lambda: plain_fn(*ops)
        got, want = tup(kernel()), tup(plain())
        torch.cuda.synchronize()
        if not all(bool(torch.isfinite(g).all()) for g in got):
            raise AssertionError(f"{name} t={t} {dtype}: non-finite kernel output")
        err = max_diff(got, want)
        # forward error bound of a k-term sum: both results lie within
        # k·eps·Σ|terms| of the exact value
        eps = torch.finfo(dtype).eps
        scale = max(float(bb.max()) for bb in tup(bound))
        tol = 2 * k_sum * eps * scale
        if not err <= tol:
            raise AssertionError(f"{name} t={t} {dtype}: max_abs_err {err} > tol {tol}")
        dname = str(dtype).removeprefix("torch.")
        row = {"name": name, "shape": shape, "dtype": dname, "path": path, "max_abs_err": err, "tol": tol}
        if dtype == torch.float32:
            # the n-term bound above is loose in float32, so the kernel is
            # also held to the plain version's own accuracy against a
            # float64 evaluation of the same inputs
            exact = tup(plain_fn(*(o.double() for o in ops)))
            k_err, p_err = max_diff(got, exact), max_diff(want, exact)
            row.update(err_vs_f64=k_err, plain_err_vs_f64=p_err)
            if not k_err <= 2 * p_err + 4 * eps * scale:
                raise AssertionError(f"{name} t={t} float32: kernel error {k_err} vs "
                                     f"float64 exceeds twice the plain version's {p_err}")
        bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
        flops_ms = flops / PEAK_FLOPS[dname] * 1e3
        row.update(
            kernel_ms=time_ms(torch, kernel), plain_ms=time_ms(torch, plain),
            library_ms=time_ms(torch, library), bound_ms=max(bytes_ms, flops_ms),
            bound_by="bytes" if bytes_ms >= flops_ms else "operations",
        )
        log(row)
        return row

    def repeat_check(name, make, t):
        # the kernels sum in a fixed order without atomics: two calls on the
        # same inputs must agree bit for bit
        made = make(t, torch.float64)
        kernel, shape = made[2], made[8]
        same = torch.equal(kernel(), kernel())
        log({"phase": "repeat_check", "name": name, "shape": shape, "bit_identical": same})
        if not same:
            raise AssertionError(f"{name}: two calls on the same inputs differ")

    checks = {}
    # the serve phases' widths (34-39): t = 4 solves and width-16 packs
    width_rows = {}
    for name, make in (("bsr_spmbv", check_bsr), ("fused_gram", check_gram), ("ecg_tail", check_tail)):
        checks[name] = run_check(name, make, T, torch.float64)  # the main path's shape
        run_check(name, make, 1, torch.float64)
        run_check(name, make, T, torch.float32)
        width_rows[name] = {w: run_check(name, make, w, torch.float64) for w in (T_SERVE, 16)}
        if name != "ecg_tail":
            repeat_check(name, make, T)
    csr_by_dtype.clear()
    torch.cuda.empty_cache()

    def run_chol_check(z, az, what):
        """``chol_apply`` against ``solve_triangular`` on the upper factor C
        of a gram1, G = ZᵀAZ, formed as the main path forms it."""
        dtype, (rows, t) = z.dtype, z.shape
        g = z.double().mT @ az.double()
        c = torch.linalg.cholesky((g + g.mT) / 2).mT.contiguous().to(dtype)
        kernel = lambda: kernels.chol_apply(c, z, az)
        got, want = kernel(), chol_apply_ref(c, z, az)
        torch.cuda.synchronize()
        kappa = float(torch.linalg.cond(c.double()))
        eps = torch.finfo(dtype).eps
        err = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want))
        # forward error bound of a t-term substitution against C
        tol = 2 * t * eps * kappa * max(float(w.abs().max()) for w in want)
        if not (all(bool(torch.isfinite(g).all()) for g in got) and err <= tol):
            raise AssertionError(f"chol_apply {what}: max_abs_err {err} > tol {tol}")
        nan_c = torch.full_like(c, float("nan"))
        if not all(bool(torch.isnan(y).all()) for y in kernels.chol_apply(nan_c, z, az)):
            raise AssertionError(f"chol_apply {what}: a NaN factor did not give NaN blocks")
        bytes_ = 4 * rows * t * z.element_size() + t * t * c.element_size()
        flops = 2 * rows * t * t  # two blocks, t(t-1)/2 multiply-adds and t divisions a row
        dname = str(dtype).removeprefix("torch.")
        bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
        flops_ms = flops / PEAK_FLOPS[dname] * 1e3
        row = {"name": "chol_apply", "what": what, "shape": [rows, t], "dtype": dname,
               "kappa": kappa, "max_abs_err": err, "tol": tol, "nan_factor_gives_nan": True,
               "kernel_ms": time_ms(torch, kernel),
               "plain_ms": time_ms(torch, lambda: chol_apply_dense(c, z, az)),
               "library_ms": time_ms(torch, lambda: chol_apply_ref(c, z, az)),
               "bound_ms": max(bytes_ms, flops_ms),
               "bound_by": "bytes" if bytes_ms >= flops_ms else "operations"}
        log(row)
        return row

    def chol_operands(t, dtype):
        z = randn(n, t, dtype=torch.float64)
        az = kernels.bsr_spmbv(blocks, indices, z, n_rows=n)
        return z.to(dtype), az.to(dtype)

    checks["chol_apply"] = run_chol_check(*chol_operands(T, torch.float64), "main path")
    run_chol_check(*chol_operands(1, torch.float64), "t=1")
    run_chol_check(*chol_operands(T, torch.float32), "float32")
    torch.cuda.empty_cache()

    # ----------------------------------------------------------- 4. main path
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solver.solve(b)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    b_dev = torch.as_tensor(b, device=dev)
    true_res = float(torch.linalg.norm(b_dev - csr_spmv(solver.a, res.x)))
    log({"phase": "main_path", "n": n, "t": T, "dtype": "float64", "tol": tol,
         "max_iters": MAX_ITERS, "converged": res.converged, "breakdown": res.breakdown,
         "n_iters": res.n_iters, "final_rn": float(res.res_hist[res.n_iters]),
         "true_residual": true_res, "build_s": build_s, "solve_s": solve_s,
         "ms_per_iter": solve_s * 1e3 / max(res.n_iters, 1), "launches": launches})
    if not res.converged:
        raise AssertionError(f"main path did not converge in {res.n_iters} iterations")
    want = {"bsr_spmbv": res.n_iters + 1, "fused_gram": res.n_iters, "ecg_tail": res.n_iters,
            "halo_pack": 0, "halo_unpack": 0, "block_trisolve": 0, "block_update": 0,
            "chol_apply": res.n_iters, "rank_apply": 0, "drop_mask": 0}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    if not true_res <= 10 * tol:
        raise AssertionError(f"true residual {true_res} > 10·tol {10 * tol}")
    if not torch.isfinite(res.x).all():
        raise AssertionError("non-finite solution")
    seq = {"n_iters": res.n_iters, "ms_per_iter": solve_s * 1e3 / max(res.n_iters, 1),
           "solve_s": solve_s, "build_s": build_s}
    seq_launches = launches
    # the sequential Block-ELL apply of one random block, for phase 9
    v_apply = np.random.default_rng(1).standard_normal((n, T))
    w_seq = kernels.bsr_spmbv(blocks, indices, torch.as_tensor(v_apply, device=dev), n_rows=n).cpu().numpy()
    del blocks, indices, res  # the handle stays: phase 11 derives a sibling
    torch.cuda.empty_cache()

    # -------------------------------------------------------- 5. cross-check
    a2 = dg_laplace_2d((64, 64), block=BLOCK, device=dev)
    b2 = np.random.default_rng(0).standard_normal(a2.shape[0])
    cfg2 = SolverConfig(t=T, tol=1e-8 * float(np.linalg.norm(b2)), max_iters=MAX_ITERS)
    out = {}
    for backend in ("pallas", "jnp"):
        s2 = ECGSolver.build(a2, config=cfg2.replace(backend=backend), device=dev)
        out[backend] = s2.solve(b2)
    again = s2.solve(b2)  # the jnp handle once more
    jnp_repeat_equal = torch.equal(again.x, out["jnp"].x) and again.n_iters == out["jnp"].n_iters
    xp, xj = out["pallas"].x, out["jnp"].x
    x_rel = float((xp - xj).abs().max() / xj.abs().max())
    log({"phase": "cross_check", "n": a2.shape[0], "iters_pallas": out["pallas"].n_iters,
         "iters_jnp": out["jnp"].n_iters, "x_max_rel_diff": x_rel,
         "jnp_repeat_bit_identical": jnp_repeat_equal})
    if not (out["pallas"].converged and out["jnp"].converged):
        raise AssertionError("cross-check solves did not converge")
    # The jnp backend's CSR product sums each row in storage order without
    # atomics, so two jnp solves agree bit for bit.
    if not jnp_repeat_equal:
        raise AssertionError("two jnp-backend solves of the same system differ")
    # The two backends sum in different orders; on this DG operator at
    # 1e-8·‖b‖ that can move the last threshold crossing by one iteration
    # (468 against 467 in one run; PERF.md §6).  x is held to 1e-8 below.
    if abs(out["pallas"].n_iters - out["jnp"].n_iters) > 1:
        raise AssertionError("pallas and jnp backends differ by more than one iteration")
    if not x_rel <= 1e-8:
        raise AssertionError(f"pallas and jnp solutions differ by {x_rel} (relative)")

    # ------------------------------------------------- 6. distributed build
    mesh = VirtualMesh(2, 4, device=dev)
    t0 = time.perf_counter()
    pm = partition_csr(a, mesh.p)
    partition_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan_only = build_exchange_plan(pm, 2, 4, "optimal", t=T)
    plan_s = time.perf_counter() - t0
    dcfg = config.replace(strategy="optimal")
    t0 = time.perf_counter()
    dsolver = ECGSolver.build(a, mesh, dcfg, pm=pm)
    torch.cuda.synchronize()
    operator_s = time.perf_counter() - t0
    op = dsolver.op
    plan = op.plan
    log({"phase": "build_distributed", "mesh": list(mesh.shape), "strategy": "optimal",
         "partition_s": partition_s, "plan_s": plan_s,
         "operator_s": operator_s, "rmax": op.rmax, "halo_size": plan.halo_size,
         "stage_size": plan.stage_size, "col_split": plan.col_split,
         "phase_widths": [ph.width for ph in plan.phases],
         "rotations": sum(1 for st in plan.steps if st.offset),
         "wire_bytes": plan.wire_bytes(8), "blocks": list(op.ell["blocks"].shape)})
    if plan_only.col_split != plan.col_split or len(plan_only.steps) != len(plan.steps):
        raise AssertionError("the handle's plan differs from build_exchange_plan's")

    # ------------------------------------------ 7. distributed kernel checks
    def widest_phase(plan_):
        """The widest phase of ``plan_`` (the operator's plan or one of its
        width re-slices): the phase, its index tensors as the exchange uses
        them and the row counts of the buffers they index."""
        i = max(range(len(plan_.phases)), key=lambda j: plan_.phases[j].width)
        ph_ = plan_.phases[i]
        gathers_, scatters_ = op.exchange_arrays(plan_)
        return (ph_, gathers_[i], scatters_[i],
                op.rmax * plan_.col_split if ph_.src == "x" else plan_.stage_size + 1,
                plan_.halo_size + 1 if ph_.dst == "halo" else plan_.stage_size + 1)

    main_phase = widest_phase(plan)
    p_ranks = main_phase[1].shape[0]

    def run_halo_check(name, w, dtype, at=main_phase):
        ph, g_idx, s_pos, src_rows, dst_rows = at
        c = g_idx.shape[1]
        rank_ids = torch.arange(p_ranks, device=dev)[:, None].expand(p_ranks, c)
        g_long, s_long = g_idx.long(), s_pos.long()
        es = torch.finfo(dtype).bits // 8
        if name == "halo_pack":
            src = randn(p_ranks, src_rows, w, dtype=dtype)
            out = torch.empty(p_ranks, c, w, dtype=dtype, device=dev)
            kernel = lambda: kernels.halo_pack(src, g_idx)
            plain = lambda: halo_pack_ref(src, g_idx)
            library = lambda: src[rank_ids, g_long]
            got, want, keep = [kernel(), kernels.halo_pack(src, g_idx, out=out)], plain(), slice(None)
            aligned = (src.data_ptr() | got[0].data_ptr()) % 16 == 0
        else:
            buf = randn(p_ranks, c, w, dtype=dtype)
            dst = randn(p_ranks, dst_rows, w, dtype=dtype)
            d_k, d_p, d_l = dst.clone(), dst.clone(), dst.clone()
            kernel = lambda: kernels.halo_unpack(d_k, buf, s_pos)
            plain = lambda: halo_unpack_ref(d_p, buf, s_pos)
            library = lambda: d_l.index_put_((rank_ids, s_long), buf)
            got, want = [kernel()], plain()
            aligned = (d_k.data_ptr() | buf.data_ptr()) % 16 == 0
            keep = slice(0, dst_rows - 1)  # the dump slot takes any padding row
            untouched = torch.ones(p_ranks, dst_rows, dtype=torch.bool, device=dev)
            untouched.scatter_(1, s_long, False)
            if not torch.equal(got[0][untouched], dst[untouched]):
                raise AssertionError(f"{name} w={w}: a slot no position names was written")
        torch.cuda.synchronize()
        err = max(float((g[:, keep].double() - want[:, keep].double()).abs().max()) for g in got)
        if err != 0.0:
            raise AssertionError(f"{name} w={w} {dtype}: max_abs_err {err} != 0")
        bytes_ = 2 * p_ranks * c * w * es + p_ranks * c * 4
        row = {"name": name, "shape": [p_ranks, c, w], "rows": src_rows if name == "halo_pack" else dst_rows,
               "dtype": str(dtype).removeprefix("torch."), "phase": f"{ph.axis}:{ph.src}->{ph.dst}",
               "path": halo_plan(p_ranks, c, w, dtype, aligned, sms).path,
               "max_abs_err": err, "tol": 0.0, "kernel_ms": time_ms(torch, kernel),
               # the kernel alone, without the host's launch overhead
               "kernel_graph_ms": time_graph_ms(torch, kernel),
               "plain_ms": time_ms(torch, plain), "library_ms": time_ms(torch, library),
               "bound_ms": bytes_ / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
        log(row)
        return row

    for name in ("halo_pack", "halo_unpack"):
        checks[name] = run_halo_check(name, T // plan.col_split, torch.float64)  # the main path's
        run_halo_check(name, 1, torch.float64)
        run_halo_check(name, T // plan.col_split, torch.float32)

    def graph_equals_eager(width):
        """The width's exchange (captured by an earlier apply or here) run by
        its CUDA graph and eagerly on the same rows must agree bit for bit."""
        ex_ = op.exchange(op.plan.at_width(width), width, torch.float64)
        ex_.run(randn(p_ranks, op.rmax, width, dtype=torch.float64))
        ex_.run(ex_.own.clone())  # captured here unless an earlier run did
        ex_.exchange()
        eager_ = ex_.xfull.clone()
        ex_.replay()
        if not torch.equal(ex_.xfull, eager_):
            raise AssertionError(f"the width-{width} exchange's CUDA graph differs from the eager exchange")
        return ex_

    # one whole exchange at the main path's width: eager, then its CUDA graph
    ex = graph_equals_eager(T)
    # the counts a replay adds are bookkeeping: hold them against the kernels
    # the device ran in a few replays, as torch.profiler sees them
    kernels.reset_launch_counts()
    replays = 5
    on_device = device_kernel_counts(torch, lambda: [ex.replay() for _ in range(replays)],
                                     ("halo_pack_kernel", "halo_unpack_kernel"))
    counted = kernels.launch_counts()
    for name in ("halo_pack", "halo_unpack"):
        if not on_device[f"{name}_kernel"] == counted[name] == replays * len(plan.phases):
            raise AssertionError(f"{replays} replays: {name} counted {counted[name]}, the device "
                                 f"ran {on_device[f'{name}_kernel']}, the plan says "
                                 f"{replays * len(plan.phases)}")
    log({"phase": "exchange", "strategy": "optimal", "t": T, "phases": len(plan.phases),
         "rotations": sum(1 for st in plan.steps if st.offset), "graph_equals_eager": True,
         "eager_ms": time_ms(torch, ex.exchange), "graph_ms": time_ms(torch, ex.replay),
         "host_launches_eager": host_launches(torch, ex.exchange),
         "host_launches_graph": host_launches(torch, ex.replay),
         "replays": replays, "device_kernels": on_device,
         "counted": {k: counted[k] for k in ("halo_pack", "halo_unpack")}})
    del ex

    def check_gram_batched(t, dtype):
        ops = tuple(randn(p_ranks, op.rmax, t, dtype=dtype) for _ in range(4))
        pp, r, ap, apo = ops
        kernel = lambda: kernels.fused_gram(*ops)
        library = lambda: torch.cat([pp.mT @ r, ap.mT @ ap, apo.mT @ ap], dim=-1)
        return (fused_gram_ref, ops, kernel, library,
                fused_gram_ref(*(o.abs() for o in ops)), op.rmax,
                (4 * p_ranks * op.rmax * t + 3 * p_ranks * t * t) * pp.element_size(),
                6 * p_ranks * op.rmax * t * t, [p_ranks, op.rmax, t],
                gram_plan(p_ranks, op.rmax, t, dtype, sms).path)

    checks["fused_gram_batched"] = run_check("fused_gram_batched", check_gram_batched, T, torch.float64)
    repeat_check("fused_gram_batched", check_gram_batched, T)
    zr = randn(p_ranks * op.rmax, T, dtype=torch.float64)
    run_chol_check(zr, op.matvec_fn()(zr), "distributed (p·rmax, t)")
    del zr
    torch.cuda.empty_cache()

    # --------------------------------------------- 8. distributed main path
    kernels.reset_launch_counts()
    mesh.reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dres = dsolver.solve(b)
    torch.cuda.synchronize()
    dsolve_s = time.perf_counter() - t0
    dlaunches = kernels.launch_counts()
    dcounters = {"psum": mesh.psum_calls, "ppermute": mesh.ppermute_calls,
                 "ppermute_elements": mesh.ppermute_elements}
    x_glob = torch.as_tensor(dsolver.unshard(dres.x), device=dev)
    dtrue_res = float(torch.linalg.norm(b_dev - csr_spmv(a, x_glob)))
    k = dres.n_iters
    log({"phase": "distributed_main_path", "mesh": list(mesh.shape), "strategy": "optimal",
         "n": n, "t": T, "dtype": "float64", "tol": tol, "converged": dres.converged,
         "breakdown": dres.breakdown, "n_iters": k, "final_rn": float(dres.res_hist[k]),
         "true_residual": dtrue_res, "solve_s": dsolve_s, "ms_per_iter": dsolve_s * 1e3 / max(k, 1),
         "build_s": partition_s + operator_s, "sequential": seq, "launches": dlaunches,
         "mesh_counters": dcounters})
    if not dres.converged:
        raise AssertionError(f"distributed main path did not converge in {k} iterations")
    n_phases = len(plan.phases)
    want = {"bsr_spmbv": k + 1, "fused_gram": k, "ecg_tail": k,
            "halo_pack": n_phases * (k + 1), "halo_unpack": n_phases * (k + 1),
            "block_trisolve": 0, "block_update": 0, "chol_apply": k, "rank_apply": 0, "drop_mask": 0}
    if dlaunches != want:
        raise AssertionError(f"distributed launch counts {dlaunches} != {want}")
    if dcounters["psum"] != 3 * k + 1:
        raise AssertionError(f"psum ran {dcounters['psum']} times, want 3·{k} + 1")
    n_rot = sum(1 for st in plan.steps if st.offset)
    if dcounters["ppermute"] != n_rot * (k + 1):
        raise AssertionError(f"ppermute ran {dcounters['ppermute']} times, want {n_rot}·({k} + 1)")
    if not dtrue_res <= 10 * tol:
        raise AssertionError(f"distributed true residual {dtrue_res} > 10·tol {10 * tol}")
    # equal in every run so far (2007 both); DG rounding may move it a little
    if not abs(k - seq["n_iters"]) <= max(1, 0.01 * seq["n_iters"]):
        raise AssertionError(f"distributed iterations {k} not within 1% of sequential {seq['n_iters']}")
    # phase 24 holds the overlap schedule's solve to this one
    d8 = {"n_iters": k, "x": dres.x.clone(), "res_hist": dres.res_hist.clone(),
          "ms_per_iter": dsolve_s * 1e3 / max(k, 1)}
    del dres, x_glob
    torch.cuda.empty_cache()

    # ------------------------------------------------------ 9. strategies
    scale = float(np.abs(w_seq).max())
    for strategy, cs in (("standard", None), ("2step", None), ("3step", None), ("optimal", 2)):
        sib = dsolver.with_config(strategy=strategy, col_split=cs)
        apply, v_sh = sib.op.matvec_fn(), sib.op.shard_vector(v_apply)
        w_dev = apply(v_sh)  # the first apply of this width: the eager exchange
        graph_equal = all(torch.equal(apply(v_sh), w_dev) for _ in range(2))  # capture, replay
        w = sib.unshard(w_dev)
        rel = float(np.abs(w - w_seq).max()) / scale
        log({"phase": "strategy_apply", "strategy": strategy, "col_split": sib.op.plan.col_split,
             "phases": len(sib.op.plan.phases), "rotations": sum(1 for st in sib.op.plan.steps if st.offset),
             "wire_bytes": sib.op.plan.wire_bytes(8), "conv_reused": sib.stats.conv_reused,
             "max_rel_diff": rel, "graph_equals_eager": graph_equal})
        if not rel <= 1e-12:
            raise AssertionError(f"{strategy} apply differs from the sequential one by {rel}")
        if not graph_equal:
            raise AssertionError(f"{strategy}: the apply through the exchange's CUDA graph "
                                 "differs from the eager one")
    del sib, op  # the handle and the operator stay for phases 11-14
    torch.cuda.empty_cache()

    # ------------------------------------------ 10. distributed cross-check
    # The exchange moves data exactly and the per-rank products do not
    # depend on the strategy, so the four strategies must agree bit for bit.
    # Against the sequential solve the reductions sum in another order, and
    # on this DG operator at 1e-8·‖b‖ that may move the last threshold
    # crossing by one iteration (ROADMAP.md queue 3; PERF.md §6).
    seq2 = ECGSolver.build(a2, config=cfg2.replace(backend="pallas"), device=dev).solve(b2)
    x_seq = seq2.x.cpu().numpy()
    first = None
    for strategy in ("standard", "2step", "3step", "optimal"):
        s2 = ECGSolver.build(a2, VirtualMesh(2, 4, device=dev), cfg2.replace(backend="pallas", strategy=strategy))
        r2 = s2.solve(b2)
        rel = float(np.abs(s2.unshard(r2.x) - x_seq).max() / np.abs(x_seq).max())
        log({"phase": "distributed_cross_check", "strategy": strategy, "n": a2.shape[0],
             "iters": r2.n_iters, "iters_sequential": seq2.n_iters, "x_max_rel_diff": rel})
        first = first or r2
        if not (r2.converged and r2.n_iters == first.n_iters and torch.equal(r2.x, first.x)):
            raise AssertionError(f"{strategy}: differs from the standard exchange's solve")
        if not abs(r2.n_iters - seq2.n_iters) <= 1:
            raise AssertionError(f"{strategy}: {r2.n_iters} iterations against {seq2.n_iters} sequential")
        if not rel <= 1e-8:
            raise AssertionError(f"{strategy}: x differs from the sequential solve by {rel}")

    # ------------------------------------------------ 11. block-Jacobi build
    prec_bj = dict(kind="block_jacobi", block=BLOCK)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    psolver = solver.with_config(precondition=prec_bj)
    torch.cuda.synchronize()
    pbuild_s = time.perf_counter() - t0
    bj = psolver._precond
    factors = bj.factors
    log({"phase": "build_block_jacobi", "block": BLOCK, "factors": list(factors.shape),
         "factor_bytes": bj.factor_bytes, "op_reused": psolver.stats.op_reused,
         "build_s": pbuild_s, **bj.build_s})
    if not psolver.stats.op_reused or tuple(factors.shape) != (n // BLOCK, BLOCK, BLOCK):
        raise AssertionError("the block-Jacobi sibling did not reuse the operator or has wrong factors")

    # ------------------------------------------------ 12. block_trisolve checks
    def spd_factors(nb, bs, dtype):
        q = randn(nb, bs, bs, dtype=torch.float64)
        low = torch.linalg.cholesky(q @ q.mT / (4 * bs) + torch.eye(bs, dtype=torch.float64, device=dev))
        return low.to(dtype).contiguous()

    def run_trisolve_check(l, t, dtype, what):
        l = l.to(dtype).contiguous()
        nb, bs, _ = l.shape
        x = randn(nb * bs, t, dtype=dtype)
        x3 = x.reshape(nb, bs, t)
        kernel = lambda: kernels.block_trisolve(l, x)
        plain = lambda: block_trisolve_ref(l, x3)
        library = lambda: torch.cholesky_solve(x3, l)
        got, want = kernel().reshape(nb, bs, t), plain()
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"block_trisolve {what}: non-finite kernel output")
        err = float((got.double() - want.double()).abs().max())
        # forward error bound of two triangular solves: both results lie
        # within bs·eps·κ(LLᵀ)·max|y| of the exact one (κ of the worst block,
        # from the eigenvalues of LLᵀ on the host: batched eigensolvers on
        # the card loop over blocks larger than 32)
        lc = l.double().cpu()
        ev = torch.linalg.eigvalsh(lc @ lc.mT)
        kappa = float((ev[:, -1] / ev[:, 0]).max())
        eps = torch.finfo(dtype).eps
        tol = 2 * bs * eps * kappa * float(want.abs().max())
        if not err <= tol:
            raise AssertionError(f"block_trisolve {what}: max_abs_err {err} > tol {tol}")
        es = l.element_size()
        bytes_ = (l.numel() + 2 * x.numel()) * es
        flops = 2 * nb * t * bs * bs
        dname = str(dtype).removeprefix("torch.")
        bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
        flops_ms = flops / PEAK_FLOPS[dname] * 1e3
        row = {"name": "block_trisolve", "what": what, "shape": [nb, bs, t], "dtype": dname,
               "max_abs_err": err, "tol": tol, "kappa_max": kappa,
               "kernel_ms": time_ms(torch, kernel), "plain_ms": time_ms(torch, plain),
               "library_ms": time_ms(torch, library), "bound_ms": max(bytes_ms, flops_ms),
               "bound_by": "bytes" if bytes_ms >= flops_ms else "operations"}
        log(row)
        return row

    checks["block_trisolve"] = run_trisolve_check(factors, T, torch.float64, "main path")
    run_trisolve_check(factors, 1, torch.float64, "t=1")
    run_trisolve_check(factors, T, torch.float32, "float32")
    for bs in (32, 64):
        run_trisolve_check(spd_factors(n // bs, bs, torch.float64), T, torch.float64, f"bs={bs}")
    torch.cuda.empty_cache()

    def check_update(t, dtype):
        ops = tuple(randn(n, t, dtype=dtype) for _ in range(4)) + (randn(t, t, dtype=dtype),)
        x, r, p, ap, c = ops
        kernel = lambda: kernels.block_update(*ops)
        library = lambda: (torch.addmm(x, p, c), torch.addmm(r, ap, c, alpha=-1))
        bound = (x.abs() + p.abs() @ c.abs(), r.abs() + ap.abs() @ c.abs())
        return (block_update_ref, ops, kernel, library, bound, t + 1,
                (6 * n * t + t * t) * x.element_size(), 4 * n * t * t, [n, t], None)

    checks["block_update"] = run_check("block_update", check_update, T, torch.float64)
    run_check("block_update", check_update, 1, torch.float64)
    run_check("block_update", check_update, T, torch.float32)
    torch.cuda.empty_cache()

    # ---------------------- 13./14. preconditioned main path, sequential and distributed
    def bj_solve(handle, phase, block, mesh_=None, sequential=None, **extra):
        """One block-Jacobi solve at full scale with the launch counts (and
        the mesh's counters) set to 0 just before it, held to every gate of
        the preconditioned main path: converged, the launch counts, true
        residual ≤ 10·tol, fewer iterations than the unpreconditioned solve
        (phase 4), and on the mesh the psum/ppermute counts and the
        iterations within 1% of the sequential solve at the same block."""
        kernels.reset_launch_counts()
        if mesh_ is not None:
            mesh_.reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = handle.solve(b)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        got, k_ = kernels.launch_counts(), r.n_iters
        x_ = torch.as_tensor(handle.unshard(r.x), device=dev) if mesh_ is not None else r.x
        true_ = float(torch.linalg.norm(b_dev - csr_spmv(a, x_)))
        row = {"phase": phase, "n": n, "t": T, "block": block, "tol": tol,
               "factors": list(handle._precond.factors.shape), **extra,
               "converged": r.converged, "breakdown": r.breakdown, "n_iters": k_,
               "final_rn": float(r.res_hist[k_]), "true_residual": true_, "solve_s": solve_s,
               "ms_per_iter": solve_s * 1e3 / max(k_, 1), "unpreconditioned": seq, "launches": got}
        if mesh_ is not None:
            counters = {"psum": mesh_.psum_calls, "ppermute": mesh_.ppermute_calls}
            row |= {"mesh": list(mesh_.shape), "strategy": "optimal", "sequential": sequential,
                    "mesh_counters": counters}
        log(row)
        want_ = {"bsr_spmbv": k_ + 1, "fused_gram": 0, "ecg_tail": k_, "halo_pack": 0,
                 "halo_unpack": 0, "block_trisolve": k_ + 1, "block_update": 0, "chol_apply": k_,
                 "rank_apply": 0, "drop_mask": 0}
        if mesh_ is not None:
            want_ |= {"halo_pack": n_phases * (k_ + 1), "halo_unpack": n_phases * (k_ + 1)}
        if not r.converged:
            raise AssertionError(f"{phase} did not converge in {k_} iterations")
        if got != want_:
            raise AssertionError(f"{phase}: launch counts {got} != {want_}")
        if not true_ <= 10 * tol:
            raise AssertionError(f"{phase}: true residual {true_} > 10·tol {10 * tol}")
        if not k_ < seq["n_iters"]:
            raise AssertionError(f"{phase}: {k_} iterations, unpreconditioned {seq['n_iters']}")
        if mesh_ is not None:
            if counters["psum"] != 3 * k_ + 1:
                raise AssertionError(f"{phase}: psum ran {counters['psum']} times, want 3·{k_} + 1")
            if counters["ppermute"] != n_rot * (k_ + 1):
                raise AssertionError(f"{phase}: ppermute ran {counters['ppermute']} times, "
                                     f"want {n_rot}·({k_} + 1)")
            if not abs(k_ - sequential["n_iters"]) <= max(1, 0.01 * sequential["n_iters"]):
                raise AssertionError(f"{phase}: {k_} iterations not within 1% of {sequential['n_iters']}")
        return {"n_iters": k_, "ms_per_iter": solve_s * 1e3 / max(k_, 1), "solve_s": solve_s,
                "launches": got}

    # 13. sequentially, at block 16 (phase 11's handle) and at the default
    # block, 32 (PreconditionConfig.block)
    prec_bj32 = dict(kind="block_jacobi", block=32)
    pseq = {BLOCK: bj_solve(psolver, "block_jacobi_main_path", BLOCK)}
    del psolver
    torch.cuda.empty_cache()
    pseq[32] = bj_solve(solver.with_config(precondition=prec_bj32), "block_jacobi_32_main_path", 32)
    torch.cuda.empty_cache()  # the handle stays: phases 18 and 20 derive siblings

    # 14. on the (2, 4) mesh (``optimal``), at both blocks
    for block, prec, phase in ((BLOCK, prec_bj, "distributed_block_jacobi_main_path"),
                               (32, prec_bj32, "distributed_block_jacobi_32_main_path")):
        t0 = time.perf_counter()
        handle = dsolver.with_config(precondition=prec)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        bj_solve(handle, phase, block, mesh, pseq[block], build_s=build_s, **handle._precond.build_s)
        del handle
        torch.cuda.empty_cache()
    # the operator and both handles stay: phases 17-20

    # ------------------------------------------------------- 15. Chebyshev
    cheb_cfg = cfg2.replace(backend="pallas", precondition="chebyshev")
    degree = cheb_cfg.precondition.degree

    def cheb_solve(solver_):
        kernels.reset_launch_counts()
        r = solver_.solve(b2)
        got = kernels.launch_counts()["bsr_spmbv"]
        if got != degree * (r.n_iters + 1):
            raise AssertionError(f"Chebyshev solve: bsr_spmbv {got} != {degree}·({r.n_iters} + 1)")
        if not r.converged:
            raise AssertionError("Chebyshev solve did not converge")
        return r

    cseq = cheb_solve(ECGSolver.build(a2, config=cheb_cfg, device=dev))
    xc_seq = cseq.x.cpu().numpy()
    log({"phase": "chebyshev", "n": a2.shape[0], "strategy": "sequential", "degree": degree,
         "iters": cseq.n_iters, "iters_unpreconditioned": seq2.n_iters})
    first = None
    for strategy in ("standard", "2step", "3step", "optimal"):
        cmesh = VirtualMesh(2, 4, device=dev)
        s2 = ECGSolver.build(a2, cmesh, cheb_cfg.replace(strategy=strategy))
        cmesh.reset_counters()
        r2 = cheb_solve(s2)
        rel = float(np.abs(s2.unshard(r2.x) - xc_seq).max() / np.abs(xc_seq).max())
        log({"phase": "chebyshev", "n": a2.shape[0], "strategy": strategy, "iters": r2.n_iters,
             "iters_sequential": cseq.n_iters, "psum": cmesh.psum_calls, "x_max_rel_diff": rel})
        first = first or r2
        if not (r2.n_iters == first.n_iters and torch.equal(r2.x, first.x)):
            raise AssertionError(f"Chebyshev {strategy}: differs from the standard exchange's solve")
        if cmesh.psum_calls != 3 * r2.n_iters + 1:
            raise AssertionError(f"Chebyshev {strategy}: psum {cmesh.psum_calls} != 3·{r2.n_iters} + 1")
        if not abs(r2.n_iters - cseq.n_iters) <= 1:
            raise AssertionError(f"Chebyshev {strategy}: {r2.n_iters} iterations against {cseq.n_iters}")
        if not rel <= 1e-8:
            raise AssertionError(f"Chebyshev {strategy}: x differs from the sequential solve by {rel}")

    # --------------------------------------------------------- 16. inexact
    a3 = fd_laplace_2d(256, device=dev)
    b3 = np.random.default_rng(0).standard_normal(a3.shape[0])
    tol3 = 1e-8 * float(np.linalg.norm(b3))
    # t = 1: at t = 4 and 8 the flexible classic recurrence breaks down on
    # FD operators of this size (a Gram matrix that is not positive
    # definite), in the reference as in the port; at t = 1 the Gram matrix
    # is a positive number
    inx_cfg = SolverConfig(t=1, tol=tol3, max_iters=2 * MAX_ITERS,
                           kernel=KernelConfig(backend="pallas"), precondition="inexact")
    b3_dev = torch.as_tensor(b3, device=dev)
    for where in ("sequential", "optimal"):
        if where == "sequential":
            s3 = ECGSolver.build(a3, config=inx_cfg, device=dev)
        else:
            s3 = ECGSolver.build(a3, VirtualMesh(2, 4, device=dev), inx_cfg.replace(strategy=where))
        t0 = time.perf_counter()
        r3 = s3.solve(b3)
        torch.cuda.synchronize()
        x3 = torch.as_tensor(s3.unshard(r3.x), device=dev)
        true3 = float(torch.linalg.norm(b3_dev - csr_spmv(a3, x3)))
        log({"phase": "inexact", "n": a3.shape[0], "strategy": where, "converged": r3.converged,
             "n_iters": r3.n_iters, "n_reseeds": r3.n_reseeds, "true_residual": true3, "tol": tol3,
             "solve_s": time.perf_counter() - t0})
        if not (r3.converged and true3 <= 10 * tol3 and r3.n_reseeds >= 1):
            raise AssertionError(f"inexact {where}: converged={r3.converged}, true residual {true3}, "
                                 f"{r3.n_reseeds} reseeds")


    # ------------------------------------------------- 17. rank_apply checks
    def run_rank_check(z, az, what, rank=None, nan=False):
        """``rank_apply`` against its substitution form on G = ZᵀAZ (gram1
        as the main path forms it), or that G with a NaN on its diagonal."""
        dtype, (rows, t) = z.dtype, z.shape
        g = (z.mT @ az).contiguous()
        if nan:
            g[t // 2, t // 2] = float("nan")
        rtol = default_rank_rtol(dtype)
        kernel = lambda: kernels.rank_apply(g, z, az, rtol=rtol)
        *got, k_rank, k_perm = kernel()
        *want, w_rank, w_perm = rank_apply_dense(g, z, az, rtol=rtol)
        torch.cuda.synchronize()
        r = int(k_rank)
        if r != int(w_rank) or not torch.equal(k_perm, w_perm) or (rank is not None and r != rank):
            raise AssertionError(f"rank_apply {what}: rank {r} perm {k_perm.tolist()}, plain "
                                 f"{int(w_rank)} {w_perm.tolist()}, want rank {rank}")
        l, _, _ = pivoted_cholesky(g.double(), rtol=rtol)
        kappa = float(torch.linalg.cond(l[:r, :r])) if r else 1.0
        eps = torch.finfo(dtype).eps
        err = max(float((y.double() - w.double()).abs().max()) for y, w in zip(got, want))
        tol = 2 * t * eps * kappa * max(float(w.abs().max()) for w in want)
        if not (all(bool(torch.isfinite(y).all()) for y in got) and err <= tol):
            raise AssertionError(f"rank_apply {what}: max_abs_err {err} > tol {tol}")
        if any(bool(y[:, r:].any()) for y in got):
            raise AssertionError(f"rank_apply {what}: a column past the rank is not zero")
        es = z.element_size()
        bytes_ = 4 * rows * t * es + t * t * es + 4 * (t + 1)
        flops = 2 * rows * t * (t + 1)  # two blocks: t(t-1)/2 multiply-adds, t divisions, t masks a row
        dname = str(dtype).removeprefix("torch.")
        bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
        flops_ms = flops / PEAK_FLOPS[dname] * 1e3
        row = {"name": "rank_apply", "what": what, "shape": [rows, t], "dtype": dname, "rank": r,
               "perm": k_perm.tolist(), "kappa": kappa, "max_abs_err": err, "tol": tol,
               "kernel_ms": time_ms(torch, kernel),
               "plain_ms": time_ms(torch, lambda: rank_apply_dense(g, z, az, rtol=rtol)),
               "library_ms": time_ms(torch, lambda: rank_apply_ref(g, z, az, rtol=rtol)),
               "bound_ms": max(bytes_ms, flops_ms),
               "bound_by": "bytes" if bytes_ms >= flops_ms else "operations"}
        log(row)
        return row

    def rank_operands(t, dtype, dependent=0):
        """Z random (n, t) with its last ``dependent`` columns combinations of
        the others, and AZ = A·Z by the main path's Block-ELL apply."""
        z = randn(n, t, dtype=torch.float64)
        if dependent:
            z[:, t - dependent:] = z[:, : t - dependent] @ randn(t - dependent, dependent,
                                                                dtype=torch.float64)
        az = solver._apply(z)
        return z.to(dtype).contiguous(), az.to(dtype).contiguous()

    zr, azr = rank_operands(T, torch.float64)
    checks["rank_apply"] = run_rank_check(zr, azr, "main path, full rank", rank=T)
    run_rank_check(*rank_operands(T, torch.float64, dependent=4), "rank 4", rank=4)
    run_rank_check(zr, azr, "NaN in G", rank=0, nan=True)
    width_rows["rank_apply"] = {T_SERVE: run_rank_check(*rank_operands(T_SERVE, torch.float64),
                                                       f"t={T_SERVE}", rank=T_SERVE)}
    run_rank_check(*rank_operands(T, torch.float32), "float32")
    del zr, azr
    torch.cuda.empty_cache()

    def run_drop_check(policy, what):
        """``drop_mask`` on step coefficients whose row norms spread over
        10^-4 … 10^2 (a column slice of a packed (t, 3t) payload, as the
        solver passes), rank 7 of 8, rn = 1."""
        gen_c = torch.Generator().manual_seed(11)
        c3 = torch.randn(T, 3 * T, generator=gen_c, dtype=torch.float64)
        c3 /= c3[:, :T].norm(dim=1, keepdim=True)
        c3 *= 10.0 ** torch.linspace(-4, 2, T)[torch.randperm(T, generator=gen_c)][:, None]
        c = c3.to(dev)[:, :T]
        rank = torch.tensor(T - 1, dtype=torch.int32, device=dev)
        kernel = lambda: kernels.drop_mask(c, rank, 1.0, policy)
        (mask, counts), (w_mask, w_counts) = kernel(), drop_mask_ref(c, rank, 1.0, policy)
        if not (torch.equal(mask, w_mask) and torch.equal(counts, w_counts)):
            raise AssertionError(f"drop_mask {what}: {mask.tolist()} {counts.tolist()} against "
                                 f"{w_mask.tolist()} {w_counts.tolist()}")
        bytes_ = T * T * 8 + 4 + (T + 2) * 8
        flops = 2 * T * T
        bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
        flops_ms = flops / PEAK_FLOPS["float64"] * 1e3
        row = {"name": "drop_mask", "what": what, "shape": [T, T], "dtype": "float64",
               "mask": mask.tolist(), "counts": counts.tolist(), "max_abs_err": 0.0, "tol": 0.0,
               "kernel_ms": time_ms(torch, kernel),
               # the kernel alone, without the host's launch overhead
               "kernel_graph_ms": time_graph_ms(torch, kernel),
               "plain_ms": time_ms(torch, lambda: drop_mask_ref(c, rank, 1.0, policy)),
               "library_ms": None, "bound_ms": max(bytes_ms, flops_ms),
               "bound_by": "bytes" if bytes_ms >= flops_ms else "operations"}
        log(row)
        return row

    checks["drop_mask"] = run_drop_check(resolve_policy("reduce"), "reduce")
    run_drop_check(ReductionPolicy(drop_tol=0.3, min_t=3), "drop_tol=0.3, min_t=3")

    # --------------------------------------------- 18. adaptive, sequential
    # the reference test's deficient_rhs: random on the first 4 of 8
    # contiguous subdomains, zero elsewhere
    m_sub = 4
    b_def = np.zeros(n)
    b_def[: (m_sub * n) // T] = np.random.default_rng(7).standard_normal((m_sub * n) // T)
    tol_def = 1e-8 * float(np.linalg.norm(b_def))
    b_def_dev = torch.as_tensor(b_def, device=dev)
    fixed_def = solver.with_config(tol=tol_def).solve(b_def)
    if not fixed_def.breakdown:
        raise AssertionError(f"the deficient solve without a policy did not break down "
                             f"({fixed_def.n_iters} iterations, converged={fixed_def.converged})")
    asolver = solver.with_config(tol=tol_def, adaptive="reduce")

    def adaptive_solve(handle, phase, mesh_=None, **extra):
        """One adaptive solve of the deficient system with the launch counts
        (and the mesh's counters) set to 0 just before it; returns the
        result, the launch counts, the counters, the true residual and the
        solve's seconds."""
        kernels.reset_launch_counts()
        if mesh_ is not None:
            mesh_.reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = handle.solve(b_def)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        got = kernels.launch_counts()
        counters = None if mesh_ is None else {
            "psum": mesh_.psum_calls, "ppermute": mesh_.ppermute_calls,
            "ppermute_elements": mesh_.ppermute_elements}
        x_ = torch.as_tensor(handle.unshard(r.x), device=dev) if mesh_ is not None else r.x
        true_ = float(torch.linalg.norm(b_def_dev - csr_spmv(a, x_)))
        k_ = r.n_iters
        if not (r.converged and true_ <= 10 * tol_def):
            raise AssertionError(f"{phase}: converged={r.converged} breakdown={r.breakdown} in "
                                 f"{k_} iterations, true residual {true_} (10·tol {10 * tol_def})")
        ah = np.asarray(r.active_hist)
        if list(ah[:2]) != [T, m_sub] or r.reduction_events()[0] != (1, T, m_sub):
            raise AssertionError(f"{phase}: active_hist {ah[:4].tolist()}, events "
                                 f"{r.reduction_events()[:3]}")
        if not (got["rank_apply"] == got["drop_mask"] == k_ and got["chol_apply"] == 0):
            raise AssertionError(f"{phase}: launch counts {got}, {k_} iterations")
        row = {"phase": phase, "n": n, "t": T, "m": m_sub, "tol": tol_def, "adaptive": "reduce",
               **extra, "converged": r.converged, "n_iters": k_, "final_rn": float(r.res_hist[k_]),
               "true_residual": true_, "reduction_events": r.reduction_events(),
               "recovery_events": r.recovery_events()[:8], "restarts": r.restarts,
               "comm_segments": r.comm_segments, "solve_s": solve_s,
               "ms_per_iter": solve_s * 1e3 / max(k_, 1), "launches": got, "mesh_counters": counters,
               "fixed_width": {"breakdown": fixed_def.breakdown, "n_iters": fixed_def.n_iters}}
        return r, got, counters, row

    ares, alaunches, _, row = adaptive_solve(asolver, "adaptive_sequential")
    ka = ares.n_iters
    if alaunches != {**dict.fromkeys(alaunches, 0), "bsr_spmbv": ka + 1, "fused_gram": ka,
                     "ecg_tail": ka, "rank_apply": ka, "drop_mask": ka}:
        raise AssertionError(f"adaptive_sequential: launch counts {alaunches}")
    # one steady-state iteration: its host launches and its syncs (one: the
    # residual norm, the rank and the active count in one copy)
    runner = asolver._runner(T)
    carry = runner.init(b_def_dev, torch.zeros_like(b_def_dev))
    for _ in range(3):
        carry = runner.step(carry)
    calls = iteration_calls(torch, lambda: runner.step(carry))
    row["iteration_host_calls"] = calls
    log(row)
    if calls["syncs"] != 1 or calls["sync_calls"].get("cudaStreamSynchronize") != 1:
        raise AssertionError(f"adaptive_sequential: one iteration synchronized {calls['sync_calls']}")
    aseq = {"n_iters": ka, "ms_per_iter": row["ms_per_iter"], "active_hist": np.asarray(ares.active_hist)}
    del ares, carry, runner
    torch.cuda.empty_cache()

    # ------------------------------------------ 19. adaptive, distributed
    adsolver = dsolver.with_config(tol=tol_def, adaptive="reduce")
    op = adsolver.op
    plan4 = op.plan.at_width(m_sub)
    dres_a, dal, dac, row = adaptive_solve(adsolver, "adaptive_distributed", mesh, mesh=list(mesh.shape),
                                           strategy="optimal", sequential={
                                               k_: v for k_, v in aseq.items() if k_ != "active_hist"})
    kd = dres_a.n_iters
    if op.exchange(plan4, m_sub, torch.float64).graph is None:
        raise AssertionError(f"adaptive_distributed: the solve captured no width-{m_sub} exchange graph")
    # what one exchange moves at each width, measured after the solve (whose
    # width-4 exchange was captured mid-solve)
    per_exchange = {}
    for w in (1, T, m_sub):  # the solve applies widths 1 and T through the full plan
        mesh.reset_counters()
        apply_w = op.matvec_fn() if w in (1, T) else op.matvec_fn(t_active=w)
        apply_w(torch.zeros(op.n_padded, w, dtype=torch.float64, device=dev))
        torch.cuda.synchronize()
        per_exchange[w] = mesh.ppermute_elements
    row["ppermute_elements_per_exchange"] = per_exchange
    ph8, ph4 = len(op.plan.phases), len(plan4.phases)
    row["phases"] = {T: ph8, m_sub: ph4}
    log(row)
    if dres_a.comm_segments != [(T, 1), (m_sub, kd - 1)]:
        raise AssertionError(f"adaptive_distributed: segments {dres_a.comm_segments}, {kd} iterations")
    if not abs(kd - aseq["n_iters"]) <= max(2, 0.01 * aseq["n_iters"]):
        raise AssertionError(f"adaptive_distributed: {kd} iterations, sequential {aseq['n_iters']}")
    common = min(kd, aseq["n_iters"]) + 1
    if not np.array_equal(np.asarray(dres_a.active_hist)[:common], aseq["active_hist"][:common]):
        raise AssertionError("adaptive_distributed: active_hist differs from the sequential one")
    if dac["psum"] != 3 * kd + 1:
        raise AssertionError(f"adaptive_distributed: psum ran {dac['psum']} times, want 3·{kd} + 1")
    if per_exchange[m_sub] * T != per_exchange[T] * m_sub:
        raise AssertionError(f"adaptive_distributed: a width-{m_sub} exchange moves "
                             f"{per_exchange[m_sub]} elements, width {T} {per_exchange[T]}")
    want_el = per_exchange[1] + per_exchange[T] + per_exchange[m_sub] * (kd - 1)
    if dac["ppermute_elements"] != want_el:
        raise AssertionError(f"adaptive_distributed: {dac['ppermute_elements']} elements exchanged, "
                             f"want {want_el}")
    want_halo = 2 * ph8 + ph4 * (kd - 1)
    if not (dal["halo_pack"] == dal["halo_unpack"] == want_halo and dal["bsr_spmbv"] == kd + 1):
        raise AssertionError(f"adaptive_distributed: launch counts {dal}, halo want {want_halo}")

    # the width-4 segment's kernels at the shapes it gives them, each against
    # its plain version: bsr_spmbv at t = 4 in the ranked layout, the halo
    # kernels on the widest phase of the width-4 plan, and the exchange graph
    # the solve captured against the eager exchange, bit for bit
    def check_bsr_ranked(t, dtype):
        """``bsr_spmbv`` as the distributed local product calls it: the p
        ranks' Block-ELL rows stacked, V the (p·m_pad, t) operands."""
        blk, idx = op.ell["blocks"].to(dtype), op.ell["indices"]
        nbr, kmax, br, bc = blk.shape
        v = randn(p_ranks * op.m_pad, t, dtype=dtype)
        plain = lambda blk_, v_: bsr_spmbv_ref(blk_, idx, v_)
        kernel = lambda: kernels.bsr_spmbv(blk, idx, v)
        # the library: the same tiles as one CSR matrix, explicit zeros dropped
        vals = blk.permute(0, 2, 1, 3).reshape(nbr * br, kmax * bc)
        cols = (idx.long()[:, None, :, None] * bc + torch.arange(bc, device=dev)).expand(
            nbr, br, kmax, bc).reshape(nbr * br, kmax * bc)
        nz = vals != 0
        crow = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), nz.sum(1).cumsum(0)])
        csr = torch.sparse_csr_tensor(crow, cols[nz], vals[nz], size=(nbr * br, v.shape[0]))
        library = lambda: torch.sparse.mm(csr, v)
        es = blk.element_size()
        return (plain, (blk, v), kernel, library, plain(blk.abs(), v.abs()), kmax * bc,
                blk.numel() * es + idx.numel() * 4 + (v.shape[0] + nbr * br) * t * es,
                2 * blk.numel() * t, list(blk.shape) + [t],
                spmbv_plan(nbr, br, bc, t, nbr * br, dtype, sms).path)

    run_check("bsr_spmbv_ranked", check_bsr_ranked, m_sub, torch.float64)
    at4 = widest_phase(plan4)
    for name in ("halo_pack", "halo_unpack"):
        run_halo_check(name, m_sub // plan4.col_split, torch.float64, at=at4)
    graph_equals_eager(m_sub)
    log({"phase": "exchange", "strategy": "optimal", "t": m_sub, "phases": ph4,
         "captured_in_solve": True, "graph_equals_eager": True})
    torch.cuda.empty_cache()
    # one steady-state iteration of the width-4 segment
    carry = adsolver._runner(T).init(adsolver._device_vec(b_def), torch.zeros(op.n_padded, dtype=torch.float64,
                                                                              device=dev))
    carry = adsolver._runner(T).step(carry)
    runner4 = adsolver._runner(m_sub)
    for _ in range(3):
        carry = runner4.step(carry)
    calls = iteration_calls(torch, lambda: runner4.step(carry))
    log({"phase": "adaptive_distributed_iteration", "width": m_sub,
         "active_width": int(carry["ahist"][carry["k"]]), "iteration_host_calls": calls})
    del dres_a, carry, runner4, adsolver, op
    torch.cuda.empty_cache()

    # ------------------------------------------- 20. adaptive, full rank
    for pol in ("rankrev", "reduce", "reduce+restart"):
        handle = solver.with_config(adaptive=pol)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = handle.solve(b)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        log({"phase": "adaptive_full_rank", "adaptive": pol, "n": n, "t": T, "tol": tol,
             "converged": r.converged, "n_iters": r.n_iters, "fixed_width_iters": seq["n_iters"],
             "reduction_events": r.reduction_events()[:20], "restarts": r.restarts,
             "solve_s": solve_s, "ms_per_iter": solve_s * 1e3 / max(r.n_iters, 1)})
        if not (r.converged and r.n_iters <= seq["n_iters"] + 2):
            raise AssertionError(f"adaptive_full_rank {pol}: converged={r.converged} in {r.n_iters} "
                                 f"iterations, fixed width {seq['n_iters']}")
        del handle, r
    torch.cuda.empty_cache()

    # ---------------------------- 21.-27. the pipelined and s-step schemes, overlap
    def scheme_solve(handle, phase, b_=None, tol_=None, mesh_=None, **extra):
        """One full-scale solve with the launch counts (and the mesh's
        counters) set to 0 just before it: converged and true residual ≤
        10·tol, else it raises.  Returns the result, the launch counts, the
        counters and the logged row (extended by the caller's gates)."""
        b_ = b if b_ is None else b_
        tol_ = tol if tol_ is None else tol_
        kernels.reset_launch_counts()
        if mesh_ is not None:
            mesh_.reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = handle.solve(b_)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        got = kernels.launch_counts()
        counters = None if mesh_ is None else {
            "psum": mesh_.psum_calls, "ppermute": mesh_.ppermute_calls}
        x_ = torch.as_tensor(handle.unshard(r.x), device=dev) if mesh_ is not None else r.x
        true_ = float(torch.linalg.norm(torch.as_tensor(b_, device=dev) - csr_spmv(a, x_)))
        k_ = r.n_iters
        mcfg = handle.config.method
        row = {"phase": phase, "n": n, "t": T, "method": mcfg.name, "s": mcfg.s,
               "reorth": mcfg.reorth, "overlap": handle.config.comm.overlap, "tol": tol_, **extra,
               "converged": r.converged, "breakdown": r.breakdown, "n_iters": k_,
               "iterations": mcfg.s * k_, "final_rn": float(r.res_hist[k_]), "true_residual": true_,
               "solve_s": solve_s, "ms_per_iter": solve_s * 1e3 / max(mcfg.s * k_, 1),
               "ms_per_step": solve_s * 1e3 / max(k_, 1), "launches": got, "mesh_counters": counters}
        if r.active_hist is not None:
            ah = np.asarray(r.active_hist)
            row.update(active_hist_head=ah[:4].tolist(), active_final=int(ah[k_]),
                       reduction_events=r.reduction_events()[:8], restarts=r.restarts,
                       comm_segments=r.comm_segments)
        if not (r.converged and true_ <= 10 * tol_):
            log(row)
            raise AssertionError(f"{phase}: converged={r.converged} breakdown={r.breakdown} in {k_} "
                                 f"steps, true residual {true_} (10·tol {10 * tol_})")
        return r, got, counters, row

    def want_launches(**named):
        return dict.fromkeys(seq_launches, 0) | named

    def gate(phase, ok, what):
        if not ok:
            raise AssertionError(f"{phase}: {what}")

    def one_sync_per_step(handle, phase, b_):
        """The host calls of one steady-state step (iteration or block):
        exactly one synchronization."""
        runner = handle._runner(handle.t)
        b_d = torch.as_tensor(b_, device=dev)
        carry = runner.init(b_d, torch.zeros_like(b_d))
        for _ in range(2):
            carry = runner.step(carry)
        calls = iteration_calls(torch, lambda: runner.step(carry))
        gate(phase, calls["syncs"] == 1 and calls["sync_calls"].get("cudaStreamSynchronize") == 1,
             f"one step synchronized {calls['sync_calls']}")
        return calls

    schemes = {}

    # 21. pipelined, sequential
    h = solver.with_config(method="pipelined")
    r, got, _, row = scheme_solve(h, "pipelined_sequential", classic=seq["n_iters"])
    k_ = r.n_iters
    row["step_host_calls"] = one_sync_per_step(h, "pipelined_sequential", b)
    log(row)
    gate("pipelined_sequential", got == want_launches(bsr_spmbv=k_ + 2, fused_gram=k_, ecg_tail=k_,
                                                      chol_apply=k_), f"launch counts {got}")
    gate("pipelined_sequential", abs(k_ - seq["n_iters"]) <= max(1, 0.01 * seq["n_iters"]),
         f"{k_} iterations not within 1% of classic's {seq['n_iters']}")
    schemes["pipelined_sequential"] = row
    del h, r
    torch.cuda.empty_cache()

    # 22. pipelined with block-Jacobi at the default block (32), sequential
    h = solver.with_config(method="pipelined", precondition=prec_bj32)
    r, got, _, row = scheme_solve(h, "pipelined_block_jacobi_32_sequential",
                                  classic=pseq[32]["n_iters"])
    k_ = r.n_iters
    log(row)
    gate("pipelined_block_jacobi_32_sequential",
         got == want_launches(bsr_spmbv=k_ + 2, ecg_tail=k_, chol_apply=k_, block_trisolve=k_ + 1),
         f"launch counts {got}")
    gate("pipelined_block_jacobi_32_sequential",
         abs(k_ - pseq[32]["n_iters"]) <= max(1, 0.01 * pseq[32]["n_iters"]),
         f"{k_} iterations not within 1% of classic's {pseq[32]['n_iters']}")
    schemes["pipelined_block_jacobi_32_sequential"] = row
    del h, r
    torch.cuda.empty_cache()

    # 23. the overlap schedule's operator (the same partition): classic
    # with overlap, phase 8's solve bit for bit
    t0 = time.perf_counter()
    osolver = dsolver.with_config(overlap=True)
    torch.cuda.synchronize()
    overlap_build_s = time.perf_counter() - t0
    oop = osolver.op
    n_int, n_bnd = (int(oop.split[f"{p_}_rows"].shape[1]) for p_ in ("int", "bnd"))
    per_spmbv = (n_int > 0) + (n_bnd > 0)
    log({"phase": "build_overlap", "build_s": overlap_build_s, "interior_rows_max": n_int,
         "boundary_rows_max": n_bnd,
         "interior_blocks": list(oop.split["int_blocks"].shape),
         "boundary_blocks": list(oop.split["bnd_blocks"].shape)})

    def mesh_gates(phase, k_, got, counters, spmbvs, psums, **named):
        gate(phase, counters["psum"] == psums, f"psum ran {counters['psum']} times, want {psums}")
        gate(phase, counters["ppermute"] == n_rot * spmbvs,
             f"ppermute ran {counters['ppermute']} times, want {n_rot}·{spmbvs}")
        halo = n_phases * spmbvs
        gate(phase, got == want_launches(halo_pack=halo, halo_unpack=halo, **named),
             f"launch counts {got}")

    r, got, counters, row = scheme_solve(osolver, "distributed_overlap_main_path", mesh_=mesh,
                                         strategy="optimal", blocking=d8["ms_per_iter"])
    k_ = r.n_iters
    same = k_ == d8["n_iters"] and torch.equal(r.x, d8["x"]) and np.array_equal(
        r.res_hist.cpu().numpy(), d8["res_hist"].cpu().numpy(), equal_nan=True)
    row["equals_blocking"] = same
    # one SpMBV blocking against overlapped, in turns (b, o, o, b)
    v_sh = dsolver.op.shard_vector(v_apply)
    apply_b, apply_o = dsolver.op.matvec_fn(), oop.matvec_fn()
    apply_times = [time_ms(torch, lambda: f(v_sh)) for f in (apply_b, apply_o, apply_o, apply_b)]
    row["spmbv_ms"] = {"blocking": [apply_times[0], apply_times[3]],
                       "overlap": [apply_times[1], apply_times[2]]}
    from profile_torch_solve import kernel_events, timeline
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            apply_o(v_sh)
        torch.cuda.synchronize()
    line = timeline(kernel_events(prof))
    row["overlap_timeline_us_per_spmbv"] = {"busy": line["busy_us"] / 5,
                                            "concurrent": line["concurrent_us"] / 5,
                                            "streams": len(line["per_stream_us"])}
    log(row)
    mesh_gates("distributed_overlap_main_path", k_, got, counters, k_ + 1, 3 * k_ + 1,
               bsr_spmbv=per_spmbv * (k_ + 1), fused_gram=k_, ecg_tail=k_, chol_apply=k_)
    gate("distributed_overlap_main_path", same, f"{k_} iterations, x and res_hist differ from "
                                                f"the blocking solve's ({d8['n_iters']})")
    schemes["distributed_overlap_main_path"] = row
    del r
    torch.cuda.empty_cache()

    # 24. pipelined on the mesh, blocking then overlapped
    pdist = {}
    for handle, phase in ((dsolver.with_config(method="pipelined"), "pipelined_distributed"),
                          (osolver.with_config(method="pipelined"), "pipelined_distributed_overlap")):
        r, got, counters, row = scheme_solve(handle, phase, mesh_=mesh, strategy="optimal",
                                             sequential=schemes["pipelined_sequential"]["n_iters"])
        k_ = r.n_iters
        per = per_spmbv if handle.config.comm.overlap else 1
        if phase == "pipelined_distributed_overlap":
            first = pdist["pipelined_distributed"]
            row["equals_blocking"] = (k_ == first.n_iters and torch.equal(r.x, first.x)
                                      and np.array_equal(r.res_hist.cpu().numpy(),
                                                         first.res_hist.cpu().numpy(), equal_nan=True))
        log(row)
        mesh_gates(phase, k_, got, counters, k_ + 2, 3 * k_ + 1, bsr_spmbv=per * (k_ + 2),
                   fused_gram=k_, ecg_tail=k_, chol_apply=k_)
        pk = schemes["pipelined_sequential"]["n_iters"]
        gate(phase, abs(k_ - pk) <= max(1, 0.01 * pk), f"{k_} iterations not within 1% of {pk}")
        if phase == "pipelined_distributed_overlap":
            gate(phase, row["equals_blocking"], "x and res_hist differ from the blocking solve's")
        pdist[phase] = r
        schemes[phase] = row
        del handle
    del pdist, r
    torch.cuda.empty_cache()

    # 25. s-step, sequential, s = 2 and 4
    for s_, reorth in ((2, False), (4, False)):
        phase = f"sstep_s{s_}_sequential" + ("_reorth" if reorth else "")
        h = solver.with_config(method="sstep", s=s_, reorth=reorth)
        r, got, _, row = scheme_solve(h, phase, classic=seq["n_iters"])
        k_ = r.n_iters
        row["step_host_calls"] = one_sync_per_step(h, phase, b)
        log(row)
        gate(phase, got == want_launches(bsr_spmbv=s_ * k_ + 1, rank_apply=(1 + reorth) * k_),
             f"launch counts {got}")
        gate(phase, s_ * k_ <= 2 * seq["n_iters"],
             f"s·k = {s_ * k_} effective iterations, over twice classic's {seq['n_iters']}")
        schemes[phase] = row
        del h, r
        torch.cuda.empty_cache()

    # 26. s-step s = 2 on the mesh
    phase = "sstep_s2_distributed"
    r, got, counters, row = scheme_solve(dsolver.with_config(method="sstep", s=2), phase, mesh_=mesh,
                                         strategy="optimal",
                                         sequential=schemes["sstep_s2_sequential"]["n_iters"])
    k_ = r.n_iters
    log(row)
    mesh_gates(phase, k_, got, counters, 2 * k_ + 1, 3 * k_ + 1, bsr_spmbv=2 * k_ + 1,
               rank_apply=k_)
    sk = schemes["sstep_s2_sequential"]["n_iters"]
    gate(phase, abs(k_ - sk) <= max(1, 0.01 * sk), f"{k_} blocks not within 1% of {sk}")
    gate(phase, 2 * k_ <= 2 * seq["n_iters"], f"s·k = {2 * k_} over twice {seq['n_iters']}")
    schemes[phase] = row
    del r
    torch.cuda.empty_cache()

    # 27. adaptive on the deficient b (phase 18's): pipelined reduce,
    # sequential and on the mesh; s-step s = 2 reduce and reduce+restart
    for handle, phase, mesh_ in (
            (solver.with_config(tol=tol_def, adaptive="reduce", method="pipelined"),
             "pipelined_adaptive_sequential", None),
            (dsolver.with_config(tol=tol_def, adaptive="reduce", method="pipelined"),
             "pipelined_adaptive_distributed", mesh),
            (solver.with_config(tol=tol_def, adaptive="reduce", method="sstep", s=2),
             "sstep_s2_adaptive_sequential", None),
            (solver.with_config(tol=tol_def, adaptive="reduce+restart", method="sstep", s=2),
             "sstep_s2_adaptive_restart_sequential", None)):
        r, got, counters, row = scheme_solve(handle, phase, b_def, tol_def, mesh_)
        k_ = r.n_iters
        log(row)
        gate(phase, row["active_final"] < T and row["active_hist_head"][:2] == [T, m_sub],
             f"active_hist {row['active_hist_head']} … {row['active_final']}")
        gate(phase, got["rank_apply"] == got["drop_mask"] == k_ and got["chol_apply"] == 0,
             f"launch counts {got}, {k_} steps")
        if mesh_ is not None:
            gate(phase, r.comm_segments == [(T, 1), (m_sub, k_ - 1)], f"segments {r.comm_segments}")
            gate(phase, counters["psum"] == 3 * k_ + 1, f"psum ran {counters['psum']} times")
        schemes[phase] = row
        del handle, r
        torch.cuda.empty_cache()

    # ------------------------- 28. the kernels at the s-step and overlap shapes
    from repro_torch.core.enlarging import split_residual

    def sstep_operands(s_, dtype, dependent=0):
        """V = [R, AR, …, A^{s−1}R] of the main path's split residual and AV
        = A·V by the sequential Block-ELL apply: the first block's monomial
        basis (its last ``dependent`` columns replaced by combinations of
        the others: a rank deficit)."""
        cur = split_residual(b_dev, T)
        vs, avs = [], []
        for _ in range(s_):
            nxt = solver._apply(cur)
            vs.append(cur)
            avs.append(nxt)
            cur = nxt
        v, av = torch.cat(vs, dim=1), torch.cat(avs, dim=1)
        if dependent:
            mix = randn(s_ * T - dependent, dependent, dtype=torch.float64)
            v[:, -dependent:] = v[:, :-dependent] @ mix
            av[:, -dependent:] = av[:, :-dependent] @ mix
        return v.to(dtype).contiguous(), av.to(dtype).contiguous()

    rank_rows = {}
    for st_, dtype, dep, nan, what in ((16, torch.float64, 0, False, "s-step gram, s=2"),
                                       (32, torch.float64, 0, False, "s-step gram, s=4"),
                                       (32, torch.float64, 8, False, "s-step gram, s=4, rank deficit"),
                                       (32, torch.float64, 0, True, "s-step gram, s=4, NaN in G"),
                                       (32, torch.float32, 0, False, "s-step gram, s=4, float32")):
        zr, azr = sstep_operands(st_ // T, dtype, dep)
        row = run_rank_check(zr, azr, what, rank=0 if nan else None, nan=nan)
        if dep:
            gate("rank_apply_check", row["rank"] <= st_ - dep, f"rank {row['rank']} with {dep} "
                                                                f"dependent columns")
        if dtype == torch.float64 and not dep and not nan:
            rank_rows[st_] = row
            if st_ == 16:  # also the width of phase 36's packs
                width_rows["rank_apply"][16] = row
        del zr, azr
        torch.cuda.empty_cache()

    def run_drop_check_live(k, live, policy, what):
        """``drop_mask`` on a (t, k) transposed coefficient block with a
        live mask that has holes (s-step's carried seed mask): mask and
        counts equal to the plain version's."""
        gen_c = torch.Generator().manual_seed(13 + k)
        ct = torch.randn(T, k, generator=gen_c, dtype=torch.float64)
        ct /= ct.norm(dim=1, keepdim=True)
        ct *= 10.0 ** torch.linspace(-4, 2, T)[torch.randperm(T, generator=gen_c)][:, None]
        c = ct.to(dev)
        act = torch.tensor(live, dtype=torch.bool, device=dev)
        rank = torch.tensor(k - 1, dtype=torch.int32, device=dev)
        kernel = lambda: kernels.drop_mask(c, rank, 1.0, policy, live=act)
        (mask, counts), (w_mask, w_counts) = kernel(), drop_mask_ref(c, rank, 1.0, policy, live=act)
        gate("drop_mask_check", torch.equal(mask, w_mask) and torch.equal(counts, w_counts),
             f"{what}: {mask.tolist()} {counts.tolist()} against {w_mask.tolist()} {w_counts.tolist()}")
        bytes_ = T * k * 8 + 4 + T + (T + 2) * 8
        flops = 2 * T * k
        bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
        flops_ms = flops / PEAK_FLOPS["float64"] * 1e3
        row = {"name": "drop_mask", "what": what, "shape": [T, k], "dtype": "float64",
               "live": list(live), "mask": mask.tolist(), "counts": counts.tolist(),
               "max_abs_err": 0.0, "tol": 0.0, "kernel_ms": time_ms(torch, kernel),
               "kernel_graph_ms": time_graph_ms(torch, kernel),
               "plain_ms": time_ms(torch, lambda: drop_mask_ref(c, rank, 1.0, policy, live=act)),
               "library_ms": None, "bound_ms": max(bytes_ms, flops_ms),
               "bound_by": "bytes" if bytes_ms >= flops_ms else "operations"}
        log(row)
        return row

    for k, live in ((16, (1, 0, 1, 1, 0, 1, 1, 1)), (32, (0, 1, 1, 1, 1, 1, 0, 1))):
        run_drop_check_live(k, live, resolve_policy("reduce"), f"s-step (t, {k}), holes")
        run_drop_check_live(k, live, ReductionPolicy(drop_tol=0.3, min_t=3),
                            f"s-step (t, {k}), holes, drop_tol=0.3, min_t=3")

    def check_bsr_part(part):
        """``bsr_spmbv`` on the overlap split's interior (V the own rows)
        or boundary (V [own ‖ halo]) arrays, as ``_part_spmbv`` calls it."""
        def make(t, dtype):
            view = oop._split_views()[part]
            blk, idx = view["blocks"].to(dtype), view["indices"]
            nbr, kmax, br, bc = blk.shape
            v = randn(p_ranks * view["operand_rows"], t, dtype=dtype)
            plain = lambda blk_, v_: bsr_spmbv_ref(blk_, idx, v_)
            kernel = lambda: kernels.bsr_spmbv(blk, idx, v)
            es = blk.element_size()
            csr = torch.sparse_csr_tensor(*part_csr[part], size=(nbr * br, v.shape[0]))
            # V's bytes: the rows the tiles reference (the boundary rows
            # touch the halo and a few own rows, not all of V)
            v_rows = int(torch.unique(idx).numel()) * bc
            return (plain, (blk, v), kernel, lambda: torch.sparse.mm(csr, v),
                    plain(blk.abs(), v.abs()), kmax * bc,
                    blk.numel() * es + idx.numel() * 4 + (v_rows + nbr * br) * t * es,
                    2 * blk.numel() * t, list(blk.shape) + [t],
                    spmbv_plan(nbr, br, bc, t, nbr * br, dtype, sms).path)
        return make

    # the library yardstick: the same tiles as one CSR matrix (explicit zeros dropped)
    part_csr = {}
    for part in ("int", "bnd"):
        view = oop._split_views()[part]
        blk, idx = view["blocks"], view["indices"]
        nbr, kmax, br, bc = blk.shape
        vals = blk.permute(0, 2, 1, 3).reshape(nbr * br, kmax * bc)
        cols = (idx.long()[:, None, :, None] * bc + torch.arange(bc, device=dev)).expand(
            nbr, br, kmax, bc).reshape(nbr * br, kmax * bc)
        nz = vals != 0
        crow = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), nz.sum(1).cumsum(0)])
        part_csr[part] = (crow, cols[nz], vals[nz])
    if n_int:
        run_check("bsr_spmbv_interior", check_bsr_part("int"), T, torch.float64)
    run_check("bsr_spmbv_boundary", check_bsr_part("bnd"), T, torch.float64)
    del part_csr, osolver, oop, apply_b, apply_o, v_sh
    log({"phase": "schemes", "summary": {
        ph: {k_: row.get(k_) for k_ in ("n_iters", "iterations", "ms_per_iter", "ms_per_step",
                                        "true_residual")} for ph, row in schemes.items()}})
    del solver, dsolver, mesh, pm
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- 29. calibrate
    from calibrate_h100 import measure as calibrate
    from repro_torch.core.machines import H100

    t0 = time.perf_counter()
    cal = calibrate(torch)
    keys = ("alpha", "alpha_l", "R_N", "R_b", "R_bl", "gamma", "eager_cutoff", "R_mem",
            "dispatch_overhead")
    committed = {k: getattr(H100, k) for k in keys}
    log({"phase": "calibrate", "seconds": time.perf_counter() - t0, "card": cal["card"],
         "measured": {k: cal[k] for k in keys}, "committed": committed,
         "measured_over_committed": {k: cal[k] / committed[k] for k in keys}})
    gate("calibrate", all(math.isfinite(v) and v > 0 for v in [cal[k] for k in keys] + list(committed.values())),
         f"a constant is not finite and positive: {cal} / {committed}")

    # ------------------------------- 30. bsr_spmbv at every tile the tuner weighs
    from repro_torch.tune import DEFAULT_TILES, TunedConfig, tile_stats, tune
    from repro_torch.kernels.bsr_spmbv.ops import block_ell_arrays
    from repro_torch.sparse.spmbv import _make_distributed_spmbv

    tile_rows = []
    for br, bc in DEFAULT_TILES:
        t0 = time.perf_counter()
        tblk, tidx, _, tmeta, _ = block_ell_arrays(a, br, bc)
        torch.cuda.synchronize()
        convert_s = time.perf_counter() - t0

        def check_tile(t, dtype, tblk=tblk, tidx=tidx):
            blk = tblk.to(dtype)
            v = randn(n, t, dtype=dtype)
            nbr, kmax, br_, bc_ = blk.shape
            plain = lambda blk_, v_: bsr_spmbv_ref(blk_, tidx, torch.nn.functional.pad(
                v_, (0, 0, 0, tmeta["m_pad"] - n)))[:n]
            es = blk.element_size()
            return (plain, (blk, v), lambda: kernels.bsr_spmbv(blk, tidx, v, n_rows=n),
                    lambda: torch.sparse.mm(library_csr(dtype), v), plain(blk.abs(), v.abs()),
                    kmax * bc_, blk.numel() * es + tidx.numel() * 4 + 2 * n * t * es,
                    2 * blk.numel() * t, list(blk.shape) + [t],
                    spmbv_plan(nbr, br_, bc_, t, n, dtype, sms).path)

        row = run_check("bsr_spmbv", check_tile, T, torch.float64)
        row.update(phase="bsr_spmbv_tiles", tile=[br, bc], kmax=tmeta["kmax"],
                   fill=tblk.numel() / a.nnz, convert_s=convert_s)
        log(row)
        tile_rows.append(row)
        del tblk, tidx, check_tile
        torch.cuda.empty_cache()
    csr_by_dtype.clear()
    best_tile = min(tile_rows, key=lambda r_: r_["kernel_ms"])["tile"]
    log({"phase": "bsr_spmbv_tiles", "summary": {f"{r_['tile'][0]}x{r_['tile'][1]}": {
        k_: r_[k_] for k_ in ("path", "kernel_ms", "bound_ms", "library_ms", "kmax", "fill")}
        for r_ in tile_rows}, "fastest": best_tile})

    # ------------------------------------------- 31. tuned, sequential (model)
    t0 = time.perf_counter()
    tsolver = ECGSolver.build(a, config=config.replace(tune_mode="model"), device=dev)
    torch.cuda.synchronize()
    tuned_build_s = time.perf_counter() - t0
    tcfg = tsolver.tuned
    r, got, _, row = scheme_solve(tsolver, "tuned_sequential", tile=list(tcfg.ell_block),
                                  kmax=tcfg.kmax, machine=tcfg.machine.name, build_s=tuned_build_s,
                                  model_local_us={k_: v_ * 1e6 for k_, v_ in tcfg.predicted["local"].items()},
                                  untuned_ms_per_iter=seq["ms_per_iter"], untuned_n_iters=seq["n_iters"])
    k_ = r.n_iters
    log(row)
    gate("tuned_sequential", tuple(tsolver.conversion["arrays"]["blocks"].shape[-2:]) == tcfg.ell_block,
         f"the solve's tiles are not the tuned {tcfg.ell_block}")
    gate("tuned_sequential", got == want_launches(bsr_spmbv=k_ + 1, fused_gram=k_, ecg_tail=k_,
                                                  chol_apply=k_), f"launch counts {got}")
    tuned_launches = got
    del tsolver, r
    torch.cuda.empty_cache()

    # ---------------------- 32. tuned, distributed: structural model, measured
    # The structural model ranks the full-scale operator; the measured
    # descent (10 operator builds, each a Block-ELL conversion on the host)
    # times phase 5's (64, 64)-element operator, and its choice then runs at
    # full scale.
    tmesh = VirtualMesh(2, 4, device=dev)
    tpm = partition_csr(a, tmesh.p)
    tpm2 = partition_csr(a2, tmesh.p)
    t0 = time.perf_counter()
    cfg_s = tune(a, t=T, mesh=tmesh, pm=tpm, mode="model:structural")
    struct_s = time.perf_counter() - t0
    cfg_s2 = tune(a2, t=T, mesh=tmesh, pm=tpm2, mode="model:structural")
    t0 = time.perf_counter()
    cfg_m = tune(a2, t=T, mesh=tmesh, pm=tpm2, mode="measure")
    torch.cuda.synchronize()
    measure_s = time.perf_counter() - t0

    def key(c):
        return f"{c.strategy}/{c.br}x{c.bc}/{'overlap' if c.overlap else 'blocking'}"

    measured = cfg_m.predicted["measured_us"]
    modeled = {k_: v_ * 1e6 for k_, v_ in cfg_s.predicted["grid"].items()}
    modeled2 = {k_: v_ * 1e6 for k_, v_ in cfg_s2.predicted["grid"].items()}
    log({"phase": "tuned_distributed_grid", "machine": cfg_s.machine.name,
         "structural_choice": key(cfg_s), "measured_choice": key(cfg_m),
         "measured_n": a2.shape[0], "structural_choice_measured_operator": key(cfg_s2),
         "structural_s": struct_s, "measure_s": measure_s, "measured_us": measured,
         "modeled_us": {k_: modeled2[k_] for k_ in measured},
         "modeled_us_full_grid": modeled,
         "structural_choice_measured_us": measured.get(key(cfg_s2)),
         "tile_stats": {f"{br}x{bc}": dict(kmax=ts_.kmax, stored=ts_.stored, fill=ts_.fill)
                        for br, bc in DEFAULT_TILES for ts_ in [tile_stats(tpm, br, bc)]}})
    gate("tuned_distributed", key(cfg_m) in measured and measured[key(cfg_m)] == min(
        measured[k_] for k_ in measured if k_.startswith(f"{cfg_m.strategy}/{cfg_m.br}x{cfg_m.bc}/")),
         f"the measured choice {key(cfg_m)} is not the least of its own grid {measured}")
    msolver = ECGSolver.build(a, tmesh, config.replace(tuned=cfg_m), pm=tpm)
    r, got, counters, row = scheme_solve(msolver, "tuned_distributed", mesh_=tmesh, choice=key(cfg_m),
                                         col_split=cfg_m.col_split)
    k_ = r.n_iters
    log(row)
    spmbv_per = 2 if msolver.op.overlap else 1
    gate("tuned_distributed", got["bsr_spmbv"] == spmbv_per * (k_ + 1) and counters["psum"] == 3 * k_ + 1,
         f"launch counts {got}, counters {counters}")
    back = TunedConfig.from_json(cfg_m.to_json())
    again = _make_distributed_spmbv(a, tmesh, t=T, pm=tpm, backend="pallas", tune=back)
    same = (key(again.tuned) == key(msolver.op.tuned) and again.tuned.col_split == msolver.op.tuned.col_split
            and again.plan.strategy == msolver.op.plan.strategy and again.overlap == msolver.op.overlap
            and again.plan.col_split == msolver.op.plan.col_split
            and again.plan.wire_bytes(8) == msolver.op.plan.wire_bytes(8))
    log({"phase": "tuned_distributed_json", "round_trip_same_operator": same,
         "wire_bytes": again.plan.wire_bytes(8)})
    gate("tuned_distributed", same, "the TunedConfig's JSON did not rebuild the same operator")
    del msolver, again, r, tmesh, tpm, tpm2
    torch.cuda.empty_cache()

    # ------------------------------------------------- 33. t="auto", sequential
    t0 = time.perf_counter()
    asolver = ECGSolver.build(a, config=config.replace(t="auto"), b=b, device=dev)
    torch.cuda.synchronize()
    auto_build_s = time.perf_counter() - t0
    sel = asolver.selection
    log({"phase": "auto_t_selection", "t": sel.t, "build_s": auto_build_s,
         "probe_iters_used": {str(t_): v_ for t_, v_ in sel.probe_iters_used.items()},
         "table": {str(t_): row_ for t_, row_ in sel.table.items()}, "tile": list(asolver.tuned.ell_block),
         "summary": sel.summary()})
    r, got, _, row = scheme_solve(asolver, "auto_t", t=sel.t, tile=list(asolver.tuned.ell_block),
                                  est_iters=sel.table[sel.t]["est_iters"], build_s=auto_build_s)
    k_ = r.n_iters
    log(row)
    gate("auto_t", r.t == sel.t == asolver.t and r.selection is sel, f"solved at t={r.t}, chose {sel.t}")
    gate("auto_t", got == want_launches(bsr_spmbv=k_ + 1, fused_gram=k_, ecg_tail=k_, rank_apply=k_,
                                        drop_mask=k_), f"launch counts {got}")
    del asolver, r
    torch.cuda.empty_cache()

    # ----------------------------------------------------------- 34. serve_build
    # The serving layer (repro_torch.serve) on Example 2.1: the reference's
    # server template at t = 4 under rankrev, on the Block-ELL kernels.
    import tempfile

    from repro_torch.observe import ChromeTraceSink, Tracer
    from repro_torch.serve import (
        ECGServer, ServeConfig, fingerprint_csr, latency_percentiles, operator_nbytes,
    )

    serve_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_serve_")
    cache_dir = str(Path(serve_tmp.name) / "cache")
    scfg = SolverConfig(t=T_SERVE, tol=tol, max_iters=MAX_ITERS, adaptive="rankrev",
                        kernel=KernelConfig(backend="pallas"))
    server = ECGServer(ServeConfig(solver=scfg, cache_dir=cache_dir), device=dev)
    t0 = time.perf_counter()
    fp = fingerprint_csr(a)
    fingerprint_s = time.perf_counter() - t0
    key_, ssolver = server.registry.get(a, fingerprint=fp)
    torch.cuda.synchronize()
    cold = server.registry.build_records[-1]
    log({"phase": "serve_build", "n": n, "t": T_SERVE, "operator_nbytes": operator_nbytes(a),
         "fingerprint": fp, "fingerprint_s": fingerprint_s, "cold_build_s": cold["build_s"],
         "warm": cold["warm"], "conv_analyzed": cold["conv_analyzed"],
         "conv_reused": cold["conv_reused"], "cache_files": len(list(Path(cache_dir).iterdir()))})
    gate("serve_build", key_ == fp and not cold["warm"] and cold["conv_analyzed"]
         and not cold["conv_reused"], f"build record {cold}")

    def serve_traffic(srv, reqs, mesh_=None):
        """Submit ``reqs`` [(b, tol)] to ``srv`` with the launch counts (and
        the mesh's counters) set to 0 just before, flush; returns the
        tickets, the seconds of each submit, the traffic's wall seconds, the
        launch counts and the mesh counters."""
        kernels.reset_launch_counts()
        if mesh_ is not None:
            mesh_.reset_counters()
        torch.cuda.synchronize()
        submit_s, tickets = [], []
        t0 = time.perf_counter()
        for b_, tol_ in reqs:
            t1 = time.perf_counter()
            tickets.append(srv.submit(a, b_, tol=tol_))
            submit_s.append(time.perf_counter() - t1)
        srv.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counters = None if mesh_ is None else {
            "psum": mesh_.psum_calls, "ppermute": mesh_.ppermute_calls,
            "ppermute_elements": mesh_.ppermute_elements}
        return tickets, submit_s, wall, kernels.launch_counts(), counters

    def true_residual(handle, x_, b_):
        x_ = torch.as_tensor(handle.unshard(x_), device=dev) if handle.mesh is not None else x_
        return float(torch.linalg.norm(torch.as_tensor(b_, device=dev) - csr_spmv(a, x_)))

    def same_result(r1, r2):
        h1, h2 = r1.res_hist, r2.res_hist
        return (r1.n_iters == r2.n_iters and torch.equal(r1.x, r2.x) and h1.shape == h2.shape
                and bool(((h1 == h2) | (h1.isnan() & h2.isnan())).all()))

    # --------------------------------------------------------- 35. serve_batched
    serve_b = [np.random.default_rng(100 + j).standard_normal(n) for j in range(4)]
    batched_reqs = [(b_, None) for b_ in serve_b] + [(serve_b[1].copy(), None)]  # one duplicate
    tickets, submit_s, batched_wall, got, _ = serve_traffic(server, batched_reqs)
    q = server.stats()["queue"]
    lat = latency_percentiles(tickets)
    iters = [tk.result.n_iters for tk in tickets[:4]]
    k_sum = sum(iters)
    solo = [ssolver.solve(b_) for b_ in serve_b[:2]]
    true_b = [true_residual(ssolver, tk.result.x, b_) for tk, b_ in zip(tickets, serve_b)]
    row = {"phase": "serve_batched", "n": n, "t": T_SERVE, "tol": tol, "requests": len(tickets),
           "n_iters": iters, "converged": [bool(tk.result.converged) for tk in tickets[:4]],
           "true_residual": true_b, "batches": q["batches"], "batch_sizes": q["batch_sizes"],
           "dedup_shared": q["dedup_shared"], "submit_s": submit_s, "wall_s": batched_wall,
           "req_per_s": len(tickets) / batched_wall,
           "ms_per_iter": batched_wall * 1e3 / k_sum, "latency_s": lat,
           "launches": got, "solo_bit_identical": [same_result(tk.result, r_)
                                                   for tk, r_ in zip(tickets[:2], solo)]}
    log(row)
    gate("serve_batched", q["dedup_shared"] == 1 and q["batches"] == 1 and q["batch_sizes"] == [4]
         and tickets[4].deduped and tickets[4].result is tickets[1].result,
         f"batches {q['batch_sizes']}, dedup {q['dedup_shared']}")
    gate("serve_batched", all(row["solo_bit_identical"]), "a batched result differs from its solo solve")
    gate("serve_batched", got == want_launches(bsr_spmbv=k_sum + 4, fused_gram=k_sum, ecg_tail=k_sum,
                                               rank_apply=k_sum, drop_mask=k_sum),
         f"launch counts {got} for {iters} iterations")
    gate("serve_batched", all(tk.result.converged for tk in tickets)
         and all(r_ <= 10 * tol for r_ in true_b), f"true residuals {true_b} (10·tol {10 * tol})")
    batched = {"tickets": tickets, "launches": got, "wall": batched_wall, "max_iters": max(iters)}
    del solo

    # ---------------------------------------------------------- 36. serve_packed
    # the same registered session, width-packed: one registry serves both
    # policies, so the session is not built twice
    pserver = ECGServer(ServeConfig(solver=scfg, cache_dir=cache_dir,
                                    packing=dict(pack="width", max_pack_width=16)), device=dev)
    pserver.registry = server.registry
    pack_c = (1e-4, 1e-6, 1e-8, 1e-8)
    packed_reqs = [(b_, c_ * float(np.linalg.norm(b_))) for b_, c_ in zip(serve_b, pack_c)]
    tickets, submit_s, packed_wall, got, _ = serve_traffic(pserver, packed_reqs)
    res0 = tickets[0].result
    k_ = res0.pack["packed_iters"]
    iters = [tk.result.n_iters for tk in tickets]
    row = {"phase": "serve_packed", "n": n, "t_each": T_SERVE, "width": res0.pack["width"],
           "tols_rel": pack_c, "n_iters": iters, "retired_iter": [tk.result.pack["retired_iter"]
                                                                 for tk in tickets],
           "packed_iters": k_, "relres": [tk.relres for tk in tickets],
           "pack_layouts": pserver.stats()["queue"]["pack_layouts"], "submit_s": submit_s,
           "wall_s": packed_wall, "req_per_s": len(tickets) / packed_wall,
           "batched_req_per_s": len(batched["tickets"]) / batched["wall"],
           "ms_per_iter": packed_wall * 1e3 / k_, "batched_max_iters": batched["max_iters"],
           "launches": got}
    log(row)
    gate("serve_packed", res0.pack["width"] == 16 and all(tk.pack_id == 0 for tk in tickets),
         f"pack {res0.pack}")
    gate("serve_packed", all(tk.result.converged and tk.relres <= c_ * 1.01
                             for tk, c_ in zip(tickets, pack_c)), f"relres {row['relres']}")
    # a looser tolerance retires no later (equal tolerances in either order)
    gate("serve_packed", all(iters[i] <= iters[j] for i in range(4) for j in range(4)
                             if pack_c[i] > pack_c[j]), f"retirements {iters} not ordered by tolerance")
    gate("serve_packed", k_ <= batched["max_iters"],
         f"{k_} packed iterations over the slowest solo solve's {batched['max_iters']}")
    gate("serve_packed", got == want_launches(bsr_spmbv=k_ + 1, fused_gram=k_, ecg_tail=k_,
                                              rank_apply=k_, drop_mask=k_), f"launch counts {got}")
    packed = {"tickets": tickets, "launches": got, "wall": packed_wall}

    # ---------------------------------------------- 37. serve_packed_distributed
    smesh = VirtualMesh(2, 4, device=dev)
    dserver = ECGServer(ServeConfig(solver=scfg.replace(strategy="optimal"),
                                    packing=dict(pack="width", max_pack_width=12)), mesh=smesh)
    t0 = time.perf_counter()
    _, dssolver = dserver.registry.get(a)
    torch.cuda.synchronize()
    dist_build_s = time.perf_counter() - t0
    dist_c = (1e-4, 1e-6, 1e-8)
    dist_reqs = [(b_, c_ * float(np.linalg.norm(b_))) for b_, c_ in zip(serve_b, dist_c)]
    tickets, submit_s, dist_wall, got, counters = serve_traffic(dserver, dist_reqs, smesh)
    res0 = tickets[0].result
    k_ = res0.pack["packed_iters"]
    segs = res0.comm_segments
    widths = [w_ for w_, _ in segs]
    plan_ = dssolver.op.plan

    def exchange_elements(w_):
        """Elements one exchange of the width-``w_`` plan rotates (its
        captured counts)."""
        ex = dssolver.op.exchange(plan_.at_width(w_), w_, torch.float64)
        return ex.deltas[-1]

    per_width = {w_: exchange_elements(w_) for w_ in widths}
    applies = {w_: it_ for w_, it_ in segs}
    applies[widths[0]] += 1  # the full-width initial residual of the pack
    halo = sum(len(plan_.at_width(w_).phases) * c_ for w_, c_ in applies.items())
    row = {"phase": "serve_packed_distributed", "mesh": list(smesh.shape), "strategy": "optimal",
           "width": res0.pack["width"], "tols_rel": dist_c, "build_s": dist_build_s,
           "n_iters": [tk.result.n_iters for tk in tickets], "packed_iters": k_,
           "comm_segments": segs, "relres": [tk.relres for tk in tickets],
           "elements_per_exchange": per_width, "mesh_counters": counters, "wall_s": dist_wall,
           "ms_per_iter": dist_wall * 1e3 / k_, "submit_s": submit_s, "launches": got}
    log(row)
    gate("serve_packed_distributed", res0.pack["width"] == 12 and widths[0] == 12
         and all(w1 > w2 for w1, w2 in zip(widths, widths[1:])), f"segments {segs}")
    gate("serve_packed_distributed", counters["psum"] == 3 * k_ + 1,
         f"psum ran {counters['psum']} times, want 3·{k_} + 1")
    gate("serve_packed_distributed", all(per_width[w1] > per_width[w2]
                                         for w1, w2 in zip(widths, widths[1:]))
         and counters["ppermute_elements"] == sum(per_width[w_] * c_ for w_, c_ in applies.items()),
         f"elements per exchange {per_width}, counted {counters['ppermute_elements']}")
    gate("serve_packed_distributed", got == want_launches(
        bsr_spmbv=k_ + 1, fused_gram=k_, ecg_tail=k_, rank_apply=k_, drop_mask=k_,
        halo_pack=halo, halo_unpack=halo), f"launch counts {got}, halo want {halo}")
    gate("serve_packed_distributed", all(tk.result.converged and tk.relres <= c_ * 1.01
                                         for tk, c_ in zip(tickets, dist_c)),
         f"relres {row['relres']}")
    del dserver, dssolver, tickets, smesh
    torch.cuda.empty_cache()

    # --------------------------------------------------------- 38. serve_restart
    # a restarted server on the same cache directory, under a byte budget
    # below both operators: warm build, eviction, re-admission
    rserver = ECGServer(ServeConfig(solver=scfg, cache_dir=cache_dir, registry_bytes=1), device=dev)
    reg = rserver.registry
    reg.get(a)
    warm = reg.build_records[-1]
    reg.get(a2)
    evicted = fp not in reg
    reg.get(a)
    readmit = reg.build_records[-1]
    st = reg.stats()
    log({"phase": "serve_restart", "cold_build_s": cold["build_s"], "warm_build_s": warm["build_s"],
         "readmitted_build_s": readmit["build_s"], "warm": warm["warm"],
         "warm_conv_analyzed": warm["conv_analyzed"], "evicted": evicted,
         "readmitted_conv_reused": readmit["conv_reused"], "evictions": st["evictions"],
         "resident": reg.fingerprints(), "small_operator_nbytes": operator_nbytes(a2)})
    gate("serve_restart", warm["warm"] and not warm["conv_analyzed"], f"warm build {warm}")
    gate("serve_restart", evicted and st["evictions"] == 2 and readmit["conv_reused"]
         and not readmit["conv_analyzed"], f"re-admission {readmit}, evictions {st['evictions']}")
    del rserver, reg
    torch.cuda.empty_cache()

    # ----------------------------------------------------------- 39. serve_trace
    trace_path = Path(serve_tmp.name) / "serve_trace.json"
    tracer = Tracer([ChromeTraceSink(str(trace_path))])
    tserver = ECGServer(ServeConfig(solver=scfg, cache_dir=cache_dir), tracer=tracer, device=dev)
    tpserver = ECGServer(ServeConfig(solver=scfg, cache_dir=cache_dir,
                                     packing=dict(pack="width", max_pack_width=16)),
                         tracer=tracer, device=dev)
    tserver.registry.get(a)  # a warm build, traced, before the timed traffic
    tpserver.registry = tserver.registry
    t_tickets, _, t_batched_wall, _, _ = serve_traffic(tserver, batched_reqs)
    tp_tickets, _, t_packed_wall, _, _ = serve_traffic(tpserver, packed_reqs)
    tracer.close()
    events = json.loads(trace_path.read_text())["traceEvents"]
    names = sorted({e["name"] for e in events if e["ph"] == "X"})
    want_names = {"serve/drain", "serve/dispatch", "serve/queue_wait", "solve_many/dispatch",
                  "solve_packed/dispatch"}
    equal = (all(same_result(u.result, v.result) for u, v in zip(t_tickets, batched["tickets"]))
             and all(same_result(u.result, v.result) and u.relres == v.relres
                     for u, v in zip(tp_tickets, packed["tickets"])))
    ratio = (t_batched_wall + t_packed_wall) / (batched["wall"] + packed["wall"])
    # the traced spans' seconds: the dispatch (the solves) by policy, the
    # registry lookups (fingerprints) are the rest of each submit
    dispatch_s = {pol: sum(e["dur"] for e in events if e["name"] == "serve/dispatch"
                           and e["args"].get("policy") == pol) * 1e-6 for pol in ("batch", "width")}
    log({"phase": "serve_trace", "events": len(events), "span_names": names,
         "traced_equal_untraced": equal, "traced_wall_s": [t_batched_wall, t_packed_wall],
         "untraced_wall_s": [batched["wall"], packed["wall"]], "traced_over_untraced": ratio,
         "dispatch_s": dispatch_s,
         "solve_ms_per_iter": {"batch": dispatch_s["batch"] * 1e3 / sum(
             tk.result.n_iters for tk in t_tickets[:4]),
             "width": dispatch_s["width"] * 1e3 / tp_tickets[0].result.pack["packed_iters"]}})
    gate("serve_trace", want_names <= set(names), f"span names {names}")
    gate("serve_trace", equal, "the traced results differ from the untraced ones")
    del server, pserver, tserver, tpserver, ssolver, t_tickets, tp_tickets
    serve_tmp.cleanup()
    torch.cuda.empty_cache()

    # ------------------------------------------------------------------ result
    sources = {
        "bsr_spmbv": ("src/repro_torch/kernels/csrc/bsr_spmbv.cu", "src/repro/kernels/bsr_spmbv/kernel.py:43"),
        "fused_gram": ("src/repro_torch/kernels/csrc/fused_gram.cu", "src/repro/kernels/fused_gram/kernel.py:43"),
        "ecg_tail": ("src/repro_torch/kernels/csrc/ecg_tail.cu", "src/repro/kernels/block_update/kernel.py:68"),
        "halo_pack": ("src/repro_torch/kernels/csrc/halo_pack.cu", "src/repro/kernels/halo_pack/kernel.py:40"),
        "halo_unpack": ("src/repro_torch/kernels/csrc/halo_pack.cu", "src/repro/kernels/halo_pack/kernel.py:63"),
        "block_trisolve": ("src/repro_torch/kernels/csrc/block_trisolve.cu",
                           "src/repro/kernels/block_trisolve/kernel.py:58"),
        "block_update": ("src/repro_torch/kernels/csrc/ecg_tail.cu", "src/repro/kernels/block_update/kernel.py:32"),
        "chol_apply": ("src/repro_torch/kernels/csrc/chol_apply.cu",
                       "src/repro/core/methods/base.py:38 (no Pallas kernel: the reference's TRSMs)"),
        "rank_apply": ("src/repro_torch/kernels/csrc/chol_apply.cu",
                       "src/repro/adaptive/rankrev.py:76 (no Pallas kernel: the reference's XLA ops)"),
        "drop_mask": ("src/repro_torch/kernels/csrc/chol_apply.cu",
                      "src/repro/adaptive/reduce.py:93 (no Pallas kernel: the reference's XLA ops)"),
    }
    # launches: the sequential main path's (phase 4) for the kernels it runs
    # (chol_apply among them), the distributed main path's (phase 8) for the
    # halo kernels, the block-Jacobi main path's (phase 13) for
    # block_trisolve, the adaptive sequential path's (phase 18) for rank_apply
    # and drop_mask; no path runs block_update
    launches = {**seq_launches, "halo_pack": dlaunches["halo_pack"], "halo_unpack": dlaunches["halo_unpack"],
                "block_trisolve": pseq[BLOCK]["launches"]["block_trisolve"], "block_update": 0,
                "rank_apply": alaunches["rank_apply"], "drop_mask": alaunches["drop_mask"]}
    rows = [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches[name], "max_abs_err": checks[name]["max_abs_err"],
         "ms": checks[name]["kernel_ms"], "plain_ms": checks[name]["plain_ms"],
         "bound_ms": checks[name]["bound_ms"], "bound_by": checks[name]["bound_by"],
         "library_ms": checks[name]["library_ms"]}
        for name, (src, replaces) in sources.items()
    ]
    # rank_apply also at the s-step scheme's widths s·t (phase 28), with its
    # launches in the s = 2 and s = 4 solves (phase 25)
    # bsr_spmbv also at every tile the tuner weighs (phase 30), with its
    # launches in the tuned sequential solve (phase 31) at the tuned tile
    rows[0]["tiles"] = [
        {"tile": r_["tile"], "path": r_["path"], "kmax": r_["kmax"], "fill": r_["fill"],
         "launches": tuned_launches["bsr_spmbv"] if tuple(r_["tile"]) == tcfg.ell_block else 0,
         **{k_: r_[k_] for k_ in ("max_abs_err", "plain_ms", "bound_ms", "bound_by", "library_ms")},
         "ms": r_["kernel_ms"]} for r_ in tile_rows]
    rows[list(sources).index("rank_apply")]["widths"] = [
        {"t": st_, "launches_in": f"sstep_s{st_ // T}_sequential",
         "launches": schemes[f"sstep_s{st_ // T}_sequential"]["launches"]["rank_apply"],
         **{k_: rank_rows[st_][k_] for k_ in ("max_abs_err", "plain_ms", "bound_ms", "bound_by",
                                              "library_ms")}, "ms": rank_rows[st_]["kernel_ms"]}
        for st_ in (16, 32)]
    # bsr_spmbv, fused_gram, ecg_tail and rank_apply also at the serve
    # phases' widths (phase 3, phase 17, phase 28's s·t = 16), with their
    # launches in the batched t = 4 traffic (phase 35) and the width-16
    # pack (phase 36)
    for name in ("bsr_spmbv", "fused_gram", "ecg_tail", "rank_apply"):
        rows[list(sources).index(name)].setdefault("widths", []).extend(
            {"t": w_, "launches_in": where, "launches": traffic["launches"][name],
             **{k_: width_rows[name][w_][k_] for k_ in ("max_abs_err", "plain_ms", "bound_ms",
                                                        "bound_by", "library_ms")},
             "ms": width_rows[name][w_]["kernel_ms"]}
            for w_, where, traffic in ((T_SERVE, "serve_batched", batched),
                                       (16, "serve_packed", packed)))
    log({"kernels": rows})
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
