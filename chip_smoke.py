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
   phases' solves and packs) and at t = 20 and 32 (phases 40-44's solves
   and pack; the kernels' widest); one JSON line each with the kernel path
   its wrapper chose (where it has two), its error, the tolerance, and
   CUDA-event times of the kernel, the plain version and one PyTorch library
   call of the same function (a yardstick only; the port never calls it),
   beside the least time the card could take (bytes over 3.35 TB/s or flops
   over the peak rate).  Two calls of ``bsr_spmbv``, ``fused_gram`` and
   ``ecg_tail`` at the main path's shapes and at t = 20 (``ecg_tail`` also
   at 32) must be bit-identical; ``ecg_tail`` also runs at t = 20 on blocks
   one value off a 16-byte boundary (its 8-byte copies) and in f32 at
   t = 1, 4, 16, 20 and 32.
   ``chol_apply`` (P = Z·C⁻¹ and AP = AZ·C⁻¹ in one launch) on the factor
   C of a real gram1 ZᵀAZ of this operator, at (n, 8) float64, at t = 1 and
   in float32: within 2·t·eps·κ(C)·max|y| (the forward error bound of a
   t-term substitution) of the ``solve_triangular`` plain version, whose
   two calls are the library yardstick; a NaN factor must give NaN blocks;
   also at t = 2 and at t = 20 and 32.  Each ``chol_apply`` row also times
   the kernel replayed in a CUDA graph (``kernel_graph_ms``): at t ≤ 2 the
   eager op's time is the host's launch path, not the kernel's; one
   ``chol_apply_vector_path`` line gives the share of the bound the vector
   path reaches at t = 1 and 2 by each.
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
    64 (random SPD blocks), and at bs = 32 with t = 20 and 32 (two chunks of
    16 right-hand sides): error within 2·bs·eps·κ·max|y| (the forward
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
    converged, true residual ≤ 10·tol, at least one flexible reseed; the
    sequential solve's launch counts (``chol_apply`` at t = 1, its vector
    path).
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
    the committed ``repro_torch.core.machines.H100`` constants, and the
    bf16 / f32 / TF32 matmul rates beside ``H100_ROOFLINE``'s, one JSON
    line; every value must be finite and positive.  (The link rate is
    ``calibrate_h100.py --link``'s, not run here.)
30. ``bsr_spmbv_tiles`` — ``bsr_spmbv`` at every tile of the tuner's
    ``DEFAULT_TILES`` (sequential Block-ELL, f64, t = 8), in phase 3's
    format: the path (mma/fma), the error against the plain version and
    its tolerance, ms against the bound (the stored tiles and V over 3.35
    TB/s) and against ``torch.sparse.mm``, kmax, the fill (stored elements
    over nonzeros) and the conversion's seconds (null at (8, 8): phase 2's
    handle's arrays are reused).  The tiles a solve runs, (8, 8), (16, 16)
    and (8, 16), run on Example 2.1; the three no default solve runs, (4,
    4), (16, 8) and (32, 32), on phase 5's (64, 64)-element operator (each
    full-scale conversion takes 11–20 s of host time).  Each row names its
    operator; the ``kernels`` line's ``bsr_spmbv`` row gains these times.
31. ``tuned_sequential`` — the handle with ``tune="model"`` (the H100's
    constants), handed phase 30's (16, 16) arrays (used where the model
    picks that tile, ``conv_reused``; ignored otherwise): the chosen tile
    and kmax, the build's seconds, the model's
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
33. ``auto_t`` — ``SolverConfig(t="auto")`` sequential, handed phase
    30's (16, 16) arrays as phase 31: the ``TSelection``
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

Phases 40-44 run every width to 32 columns through the kernels at full
scale (the card took no block wider than 16 before), each with the launch
counts (and the mesh's counters) set to 0 just before its solve:

40. ``wide_main_path`` — phase 2's handle ``with_config(t=20)`` (the paper's
    widest t; the Block-ELL conversion reused): converged, true residual ≤
    10·tol, ``bsr_spmbv`` n_iters + 1 launches, ``fused_gram``, ``ecg_tail``
    and ``chol_apply`` n_iters; iterations and ms per iteration beside
    phase 4's t = 8.
41. ``wide_cross_check`` — phase 5's (64, 64)-element operator at t = 20,
    pallas against jnp: iteration counts within one, x equal to 1e-8
    (relative to max|x|).
42. ``wide_distributed`` — ``with_config(t=20)`` of phase 6's mesh handle
    (``optimal``): ``psum`` 3·n_iters + 1, ``ppermute`` rotations·(n_iters
    + 1), the elements of one width-20 exchange equal to those the plan's
    exchange at width 20 rotates (its padded buffers; the plan's wire
    elements, the rows that cross, logged beside) and the solve's to one
    width-1 and n_iters width-20 exchanges,
    the halo kernels len(plan.phases)·(n_iters + 1) launches at width 20,
    iterations within 1% of phase 40's.
43. ``wide_block_jacobi_32`` — phase 40's handle with block-Jacobi at the
    default block (32), held to ``bj_solve``'s gates (``block_trisolve``
    n_iters + 1 launches, fewer iterations than phase 40).
44. ``wide_pack`` — phase 35's first four right-hand sides at t = 8 in one
    width-32 ``solve_packed`` on phase 2's handle with ``rankrev`` (no
    server), at (1e-4, 1e-6, 1e-8, 1e-8)·‖b_j‖: each converged with its
    true relative residual ≤ its tolerance × 1.01, retirements ordered by
    tolerance, the kernels launched ``packed_iters`` times (``bsr_spmbv``
    once more).
45. ``oneshot_sequential`` — the reference's one-shot spelling at full
    scale: ``ecg_solve(make_block_ell_apply(a, 8), b, 8, backend="pallas")``
    (the conversion's host seconds logged), its ``DeprecationWarning``
    caught; phase 4's launch gates and iterations, x equal to phase 4's bit
    for bit (the one-shot apply converts with the handle's
    ``block_ell_arrays``), true residual ≤ 10·tol; then one
    ``mapping="round_robin"`` and one ``chol_eps=1e-12`` solve (converged,
    true residual ≤ 10·tol, launches per iteration as phase 4).
46. ``oneshot_cg`` — ``cg_solve`` through the same apply as a width-1 SpMV:
    converged, true residual ≤ 10·tol, ``bsr_spmbv`` n_iters + 1 and
    ``chol_apply`` (its t = 1 vector path) n_iters launches.
47. ``oneshot_distributed`` — ``distributed_ecg`` on
    ``make_solver_mesh(n_ranks=8, ppn=4)`` (``optimal``, t = 8, pallas):
    phase 8's gates (halo launches len(phases)·(n_iters + 1), psum
    3·n_iters + 1) and iterations, true residual ≤ 10·tol.
48. ``ecg_sweep`` — ``repro_torch.launch.perf.run_ecg_sweep`` as the
    reference runs it (44 rows, each time finite and > 0, one JSON line
    each; ``bsr_spmbv``, ``fused_gram``, ``ecg_tail`` and the halo kernels
    launched), then ``kernel_vs_oracle(ts=(8, 20))`` at Example 2.1's full
    width in float32 (each kernel row beside its bound, as phase 3).  Before
    each ``kernel_vs_oracle`` is timed, its float32 ``bsr_spmbv`` (the
    (16, 16) FMA tile), ``fused_gram`` and ``ecg_tail`` are held to their
    plain versions on its own operands (``kernel_operands``, same seed) with
    phase 3's tolerance and float64 comparison; then
    ``overlap_vs_blocking_sweep`` on phase 4's operator (``optimal``, t = 8,
    pallas).

49. ``process_mesh`` — the process-group mesh, one rank per process over
    ``torch.distributed`` (NCCL; a ``file://`` rendezvous in a temporary
    directory; each process is this script started with
    ``--process-mesh-worker``, under a timeout, and each builds Example 2.1
    from the same seed and keeps its own rank's rows).  (i) A world of 1 on
    ``cuda:0``: the solve (``optimal``, t = 8, pallas, f64, tol 1e-8·‖b‖)
    on ``ProcessGroupMesh(1, 1)`` against ``VirtualMesh(1, 1)`` on the same
    card (the conversion reused): equal iterations, x equal bit for bit,
    ``psum`` 3·n_iters + 1 (each one NCCL ``all_reduce``), the launch counts
    of phase 4, true residual ≤ 10·tol; ms per iteration of both and the
    exchange's share of an iteration.  (ii) With two cards or more, the
    largest even world up to min(cards, 8), one process per card, on
    ``ProcessGroupMesh(2, world/2)`` with ``standard`` and ``optimal``,
    against ``VirtualMesh(2, world/2)`` on card 0: iterations within 1%,
    ``psum`` 3·k + 1 and ``ppermute`` rotations·(k + 1) on every process,
    the halo kernels len(plan.phases)·(k + 1) launches, true residual ≤
    10·tol; ms per iteration and the share of an iteration the exchange
    takes across cards.  On one card a line says that (ii) did not run and
    why.
50. ``lm`` — the LM half's dense decoder, stablelm-1.6b at full width
    (24 layers, d = 2048, vocab 100352) in float32, on ``cuda:0``, through
    ``repro_torch.launch.train`` and ``repro_torch.train``: (1) the
    trainer's CLI at ``--preset full`` for 2 steps (its printed lines, loss
    and gnorm finite), then the model built as the trainer builds it, its
    parameter elements beside ``param_count()``; (2) three trainer steps
    at batch 8 × seq 256: loss, grad_norm and lr finite, synchronized ms a
    step, tokens/s, peak memory; (3) one step at batch 1 × seq 4096 plain
    and one with ``attn_chunk = loss_chunk = 512`` on the same parameters
    (lr 0): losses and grad norms within 1e-4 relative, the peak memory of
    each; (4) f32 decode of 16 tokens from position 0 into a 4096-slot
    cache, each position's logits within 1e-3 relative of one forward over
    those tokens, on the same model with every weight of two dims or more
    redrawn from N(0, 0.02) (the initialiser's rule saturates attention, so
    float32 rounding grows over the layers: its errors are logged beside);
    (5) a 2-layer model of the full width (N(0, 0.02) weights), batch 1 ×
    seq 64, one step on the card and one on the CPU from the same weights:
    loss and grad_norm within 1e-4 relative, the first moments (0.1 × the
    clipped gradients) within 1e-4 of each leaf's max, updated parameters
    within 1e-5 of max|p| wherever the two gradients agree to a tenth of
    themselves (AdamW's first step is sign(g) for |g| >> eps, so where
    rounding sets the sign the two may differ by the largest step-1 move,
    2·lr·(1 + wd·max|p|), which is the bound there); (6) bf16 decode (the config's own dtype, N(0, 0.02)
    weights) at batch 1 with a 32768-slot cache: ms a token, peak memory.
    The LM half has no
    Pallas kernel, so no port kernel runs here: every row's
    ``lm_launches`` is 0.  The phase prints its seconds.
51. ``ssm`` — the LM half's SSM families at full width in float32 on
    ``cuda:0``, for mamba2-780m (48 layers, d = 1536, d_state 128) and
    then zamba2-1.2b (38 layers, d = 2048, one shared attention block
    before every 6 layers: 7 applications): (1) the trainer's CLI at
    ``--preset full`` for 2 steps (its first line names the arch and
    ``param_count()``, the last ``done``, loss and gnorm finite); (2) the
    model built as the trainer builds it: 780 382 464 and 1 104 937 856
    elements, ``param_count()`` plus the leaves it leaves out (the padded
    vocab rows, ``conv_b``, ``dt_bias``, the norms); (3) two trainer steps
    at batch 1 × seq 4096 (train_4k's sequence: 32 SSD chunks a layer):
    loss, grad_norm and lr finite, ms a step, tokens/s, peak memory; (4)
    f32 decode of 16 tokens from position 0 (zamba2 into a 4096-slot
    cache), each position's logits within 1e-3 relative of one forward over
    those tokens (zamba2's shared block redrawn from N(0, 0.02) as in phase
    50, the initialiser's own errors logged beside); (5) a 2-layer model of
    the full width (zamba2: one shared application), batch 1 × seq 128 (one
    chunk), one step on the card and one on the CPU from the same weights,
    held to phase 50 (5)'s gates (``card_vs_cpu``); (6) bf16 decode (the
    config's own dtype) at batch 1, zamba2 with a 32768-slot cache (its
    K/V float32 by the reference's cache rule): ms a token, peak memory,
    and the cache's and the logits' dtypes as the reference's rule makes
    them (mamba2: bf16 logits and ``conv``; zamba2: float32 logits and a
    float32 ``conv`` after the step).  No port kernel runs here either.
    The phase prints its seconds.
52. ``encdec_vlm`` — the encoder-decoder and VLM-prefix LMs at full width
    in float32 on ``cuda:0``: whisper-medium (24 + 24 layers, d = 1024,
    1500 encoder frames) and then paligemma-3b (18 layers, d = 2048, MQA,
    d_head 256, vocab 257 216, 256 image patches): (1) the trainer's CLI at
    ``--preset full`` for 2 steps (frames and patch embeddings drawn by
    ``batch_at``; loss finite, gnorm finite or, where the initialiser's
    gradients overflow float32's sum of squares as the reference's do,
    +inf, never NaN); (2) the model built as the trainer builds it:
    759 519 232 and 2 508 793 856 elements, ``param_count()`` plus the
    padded vocab rows, the norms and whisper's ``enc_pos``; (3) on its
    weights redrawn from N(0, 0.02), two trainer steps at
    batch 1 × seq 4096 (whisper: 4096 decoder tokens against 1500 frames;
    paligemma: 256 patches + 4096 text tokens, 4352 positions): loss,
    grad_norm and lr finite, ms a step, tokens/s, peak memory; for
    paligemma one step plain and one with ``attn_chunk = 256`` (the
    ``prefix:256`` chunked path) and ``loss_chunk = 512`` on the same
    parameters (lr 0): losses and grad norms within 1e-4 relative; (4) f32
    decode of 16 tokens from position 0 into a 4096-slot cache (whisper's
    cross K/V from ``prefill_cross_cache`` of the step's frames), each
    position's logits within 1e-3 relative of one forward over those
    tokens, on those weights (a fresh model's under the initialiser's rule
    logged beside); (5) a 2-layer model of the full width (whisper 2 + 2
    layers, 1500 frames; paligemma 256 patches), batch 1 × 64 tokens, held
    to phase 50 (5)'s gates (``card_vs_cpu``); (6) bf16 decode (the
    config's own dtype) at batch 1 with a 32768-slot cache: ms a token,
    peak memory, every cache leaf and the logits bfloat16 (the reference's
    ``abstract_cache`` and ``jnp`` promotion).  No port kernel runs here.
    The phase prints its seconds.
53. ``moe`` — the MoE LMs at full width on ``cuda:0``: olmoe-1b-7b (16
    layers, d = 2048, 64 experts of d_ff 1024, top-8) and then
    phi3.5-moe-42b (32 layers, d = 4096, GQA 32/8, 16 experts of d_ff
    6400, top-2), neither of which trains whole on one card: (1) the
    trainer's CLI at ``--preset tiny`` for 2 steps (their experts and top-k
    kept: the real routing; loss and gnorm finite; ``--preset full`` would
    need 111 / 670 GB); (2) the model built as the trainer builds it, in
    float32, on 8 of olmoe's layers (3 563 096 064 elements, 57.0 GB of
    training state) and 2 of phi3.5-moe's (2 864 861 184, 45.8 GB):
    ``param_count()`` plus the padded vocab rows of ``emb`` and ``lm_head``
    and the norms; ``active_param_count()`` logged; (3) on N(0, 0.02)
    weights, two trainer steps at batch 1 × seq 4096 (capacity 640 slots an
    expert): loss, grad_norm, lr and the summed aux loss finite, the
    dropped (token, expert) picks per layer out of T·k, ms a step,
    tokens/s, peak memory; (4) f32 decode of 16 tokens from position 0
    into a 4096-slot cache, with ``capacity_factor = E/k`` (the forward
    over the 16 tokens then drops nothing, as a one-token step never
    does), each position's logits within 1e-3 relative of one forward over
    those tokens (at the config's own factor the forward drops picks and
    differs by design: logged beside); (5) the card against the CPU at
    batch 1 × seq 64: olmoe on 2 layers held to phase 50 (5)'s gates
    (``card_vs_cpu``), phi3.5-moe on 1 layer its loss and gradient norm
    within 1e-4 relative (its optimizer state on the CPU would be ~25 GB);
    (6) bf16 decode (the config's own dtype) at batch 1 with a 32768-slot
    cache, olmoe at its full 16 layers, phi3.5-moe on 16 of its 32 (84 GB
    of bf16 weights fit no one card): ms a token, the host's launches a
    token, the expert bank's bytes and the least time to read them once
    (every slot runs, gate 0 or not, so a token reads every expert), every
    cache leaf, the weights and the logits bfloat16.  No port kernel runs
    here.  The phase prints its seconds.
54. ``lm_mesh`` — the LM half's 2-D FSDP × TP layout over NCCL, in worlds
    the script starts as phase 49 does (``--lm-mesh-worker``, one process
    a card).  (i) A world of 1 on ``cuda:0``: the mesh's ``all_gather``,
    ``reduce_scatter`` and ``psum`` and ``hierarchical_allreduce`` (2-step
    on a (1, 1, 1) pod mesh, no-pod on (1, 1)) each equal to x, their
    definition on one process, and the ms of one psum of an 8 × 256 × 2048
    residual; the trainer's CLI at ``--preset smoke --mesh 1,1``: 2 steps
    with ``--ckpt-dir`` (its lines as phase 50's, the smoke config's first
    line), ``--resume`` to 4, and 4 uninterrupted steps, the resumed loss
    lines equal to the uninterrupted run's; then stablelm-1.6b,
    mamba2-780m, zamba2-1.2b and whisper-medium at full width and depth
    (whisper's 8 × 1500 frames beside its tokens) and olmoe-1b-7b at full
    width on 2 of its 16 layers (reduced in depth; capacity factor E/k, so
    nothing drops), f32, batch 8 × 256, AdamW with eps 1e-3: two sharded
    steps on the (1, 1) ``LMMesh`` and two one-device steps from the same
    N(0, 0.02) weights, in turns (sharded, one device, one device,
    sharded): loss and grad norm within 1e-5 relative, the gathered first
    moments within 1e-4 of their max, the gathered parameters within 1e-5
    of max |p|; ms a step of each, the NCCL calls and elements a step by
    axis (at least one call), peak memory.  Then the sharded decode step
    (``build_serve_step(mesh=…)``) of stablelm-1.6b, mamba2-780m,
    zamba2-1.2b, whisper-medium (after ``prefill``) and olmoe-1b-7b (16 of
    16 layers) in bf16 at batch 1 with a 32768-slot cache: 8 greedy tokens
    against 8 through the one-device step on the same N(0, 0.02) weights,
    the tokens equal and the logits within ``DECODE_GATE`` of the largest
    |logit|; ms a token of each (the median from the third token), the
    NCCL calls of a token.  (ii) With two cards or more a world of 2 on
    (1, 2): two steps of stablelm-1.6b and of mamba2-780m, loss and grad
    norm within 1e-4 relative of rank 0's one-device steps; with four or
    more a world of 4 on (2, 2): two steps of granite-8b at full depth
    (132 GB of f32 state) and of zamba2-1.2b at full depth (against rank
    0's one-device steps), and phi3-medium-14b's decode on (1, 4) at full
    width on 10 of its 40 layers (reduced in depth: rank 0 holds the f32
    model beside its block) with a 32768-slot cache (its 10 K/V heads do
    not divide 4, so the cache's slots are sharded over "model" and each
    token's attention is combined across the cards): 8 greedy f32 tokens
    against rank 0's one-device f32 decode, the tokens equal and the
    logits within ``F32_DECODE_GATE`` of the largest |logit|; then both
    paths in bf16 on the same weights rounded, fed the f32 tokens, the
    sharded logits' largest error against the f32 one-device logits at
    most ``BF16_ACROSS_CARDS`` times the one-device bf16 logits'; all with
    the metrics and tokens equal on every rank, ms by rank and peak memory
    by rank.  On fewer cards a
    line says that (ii) did not run and why.  No port kernel runs here.
    The phase prints its seconds.
55. ``dryrun`` — the LM dry-run (``repro_torch.launch.dryrun``), which
    traces a step under ``FakeTensorMode`` and launches nothing.  (a) A
    process of its own (``--dryrun-worker``; its fake worlds never meet
    phase 54's NCCL ones) traces stablelm-1.6b's train_4k (256 × 4096) and
    decode_32k as rank 0 of a fake 16 × 16 world and its decode_32k as rank
    0 of a fake 2 × 16 × 16 world (the multi-pod compile matrix, no costs),
    on fake CUDA tensors, priced with ``H100_ROOFLINE``: train_4k must make
    ``DRYRUN_TRAIN_CALLS`` collective calls on rank 0 (the NCCL calls of
    the same step on phase 54's world of 1); the records are printed.  (b)
    Meanwhile stablelm-1.6b's f32 step at 8 × 256 (phase 50's) is traced
    on one device at full depth and then run on the card from a fresh
    model: the ``FlopCounterMode`` total of the card's step must equal the
    trace's exactly, and the traced memory peak (``MemTracker``, the
    parameters, moments and batch registered) must be within
    ``DRYRUN_PEAK_GATE`` of ``max_memory_allocated`` over what was
    resident before the model; a second step's time against the H100
    bound (f32 matmul peak, TF32 off) is printed, a reading and not a
    gate.  No port kernel runs here.  The phase prints its seconds.

The ``kernels`` line's ``bsr_spmbv``, ``fused_gram``, ``ecg_tail`` and
``rank_apply`` rows carry ``widths`` entries for t = 4 and 16 with their
launches in phases 35 and 36; ``bsr_spmbv``, ``fused_gram``, ``ecg_tail``,
``chol_apply`` and ``block_trisolve`` (bs = 32) entries for t = 20 and 32
with their launches in phases 40, 43 and 44 (0 where no solve runs the
width), and ``chol_apply`` one for t = 1 with its launches in phase 16.
Every row also carries ``oneshot_launches``: its launches in each of phases
45-48, ``process_mesh_launches``: its launches in phase 49's solves on
the process-group mesh (rank 0's), and ``lm_launches``: its launches in
phases 50-55.

``python3 chip_smoke.py --process-mesh-worker DIR RANK WORLD`` is one rank
of phase 49's world, ``--lm-mesh-worker DIR RANK WORLD`` one of phase 54's,
``--dryrun-worker OUT`` phase 55 (a)'s process (the script starts these
itself).
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
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
T_WIDE = 20  # the paper's widest t (benchmarks/paper_figures.py), phases 40-44
WIDE = (T_WIDE, 32)  # and the kernels' widest, checked in phases 3 and 12
MAX_ITERS = 5000
REPS, BATCHES = 10, 5
SLOW_MS, SLOW_REPS, SLOW_BATCHES = 2.0, 2, 3
# phase 54 (i)'s bf16 decode on a world of 1: sharded against one-device
# logits within this share of the largest |logit| (two bfloat16 roundings
# at 2^-8 each)
DECODE_GATE = 2 * 2.0 ** -8
# (ii)'s decode across four cards: in f32 the sharded logits within this share
# of the largest |logit| of the one-device decode's; in bf16 the sharded
# logits' error against the f32 one-device logits at most this many times the
# one-device bf16 decode's (each card's row-parallel partial product is
# rounded to bf16 before the sum: one rounding more a product)
F32_DECODE_GATE = 1e-4
BF16_ACROSS_CARDS = 4.0
# phase 55: the cells the dry-run worker traces (a), the collective calls
# stablelm's train_4k makes on rank 0 (the card's NCCL calls a step on a
# world of 1, phase 54), the share by which the traced memory peak may miss
# the card's (b), and how long (a) may take
DRYRUN_SINGLE = (("stablelm_1_6b", "train_4k"), ("stablelm_1_6b", "decode_32k"))
DRYRUN_MULTI = (("stablelm_1_6b", "decode_32k"),)
DRYRUN_TRAIN_CALLS = 352
DRYRUN_PEAK_GATE = 0.03  # the parameters alone are ~22% of the peak
DRYRUN_WORKER_TIMEOUT_S = 300


def gate(phase, ok, what) -> None:
    """A phase's check: raise with the phase's name and ``what`` unless ``ok``."""
    if not ok:
        raise AssertionError(f"{phase}: {what}")


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


def tup(x):
    return x if isinstance(x, tuple) else (x,)


def max_diff(xs, ys) -> float:
    return max(float((x.double() - y.double()).abs().max()) for x, y in zip(xs, ys))


def hold_to_plain(torch, what, plain_fn, ops, kernel, bound, k_sum) -> dict:
    """Run ``kernel()`` and ``plain_fn(*ops)`` on the same inputs and fail
    unless the kernel's outputs are finite and within twice the k-term
    forward error bound (``k_sum`` terms, Σ|terms| ``bound``) of the plain
    version's; in float32 the kernel is also held to the plain version's own
    error against a float64 evaluation.  Returns the row's error fields."""
    got, want = tup(kernel()), tup(plain_fn(*ops))
    torch.cuda.synchronize()
    dtype = got[0].dtype
    if not all(bool(torch.isfinite(g).all()) for g in got):
        raise AssertionError(f"{what} {dtype}: non-finite kernel output")
    err = max_diff(got, want)
    # forward error bound of a k-term sum: both results lie within
    # k·eps·Σ|terms| of the exact value
    eps = torch.finfo(dtype).eps
    scale = max(float(bb.max()) for bb in tup(bound))
    tol = 2 * k_sum * eps * scale
    if not err <= tol:
        raise AssertionError(f"{what} {dtype}: max_abs_err {err} > tol {tol}")
    row = {"max_abs_err": err, "tol": tol}
    if dtype == torch.float32:
        # the n-term bound above is loose in float32, so the kernel is
        # also held to the plain version's own accuracy against a
        # float64 evaluation of the same inputs
        exact = tup(plain_fn(*(o.double() for o in ops)))
        k_err, p_err = max_diff(got, exact), max_diff(want, exact)
        row.update(err_vs_f64=k_err, plain_err_vs_f64=p_err)
        if not k_err <= 2 * p_err + 4 * eps * scale:
            raise AssertionError(f"{what} float32: kernel error {k_err} vs "
                                 f"float64 exceeds twice the plain version's {p_err}")
    return row


def oneshot_phases(torch, dev, a, b, tol, seq_iters, x4, dist_iters) -> dict:
    """Phases 45-48: the reference's one-shot API and the ``--ecg`` sweep on
    the card.  ``a``, ``b`` and ``tol`` are phase 4's system, ``seq_iters``
    and ``x4`` its iterations and solution, ``dist_iters`` phase 8's
    iterations.  Returns {phase: kernel launches} for the ``kernels`` line."""
    import tempfile
    import warnings

    from repro_torch import kernels
    from repro_torch.analysis.ecg_bench import (
        kernel_operands,
        kernel_vs_oracle,
        overlap_vs_blocking_sweep,
    )
    from repro_torch.kernels.block_update.ops import tail_plan
    from repro_torch.kernels.block_update.ref import ecg_tail_ref
    from repro_torch.kernels.bsr_spmbv.ops import spmbv_plan
    from repro_torch.kernels.bsr_spmbv.ref import bsr_spmbv_ref
    from repro_torch.kernels.fused_gram.ops import gram_plan
    from repro_torch.kernels.fused_gram.ref import fused_gram_ref
    from repro_torch.core import cg_solve, ecg_solve
    from repro_torch.launch.mesh import make_solver_mesh
    from repro_torch.launch.perf import run_ecg_sweep
    from repro_torch.sparse import csr_spmv
    from repro_torch.sparse.spmbv import distributed_ecg

    def want_launches(**named):
        return dict.fromkeys(kernels.launch_counts(), 0) | named

    def warned(fn, *args, **kw):
        """``fn(*args, **kw)``, its seconds and its DeprecationWarnings,
        with every launch count set to 0 just before and read just after."""
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        msgs = [str(w.message) for w in caught if w.category is DeprecationWarning]
        return out, secs, msgs, kernels.launch_counts()

    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def check_kernel_operands(phase, **kw):
        """Hold bsr_spmbv, fused_gram and ecg_tail to their plain versions,
        as phase 3 does, on kernel_vs_oracle's own float32 operands (the
        same seed and draw order, ``kernel_operands``) before it times
        them: the (16, 16) FMA tile, the float32 gram and tail at its
        widths."""
        a_, blk, idx, per_t = kernel_operands(device=dev, **kw)
        nbr, kmax, br, bc = blk.shape
        plain_bsr = lambda blk_, v_: bsr_spmbv_ref(blk_, idx, v_)
        for t, v, gram, tail in per_t:
            x, r, p, ap, po, c, d, do = tail
            checks_ = (
                ("bsr_spmbv", plain_bsr, (blk, v), lambda: kernels.bsr_spmbv(blk, idx, v),
                 plain_bsr(blk.abs(), v.abs()), kmax * bc,
                 spmbv_plan(nbr, br, bc, t, a_.shape[0], torch.float32, sms).path),
                ("fused_gram", fused_gram_ref, gram, lambda: kernels.fused_gram(*gram),
                 fused_gram_ref(*(o.abs() for o in gram)), gram[0].shape[0],
                 gram_plan(1, gram[0].shape[0], t, torch.float32, sms).path),
                ("ecg_tail", ecg_tail_ref, tail, lambda: kernels.ecg_tail(*tail),
                 (x.abs() + p.abs() @ c.abs(), r.abs() + ap.abs() @ c.abs(),
                  ap.abs() + p.abs() @ d.abs() + po.abs() @ do.abs()), 2 * t + 1,
                 tail_plan(t, torch.float32, True, sms).path),
            )
            for name, plain_fn, ops, kernel, bound, k_sum, path in checks_:
                log({"phase": phase, "name": name, "t": t, "dtype": "float32", "path": path,
                     "shape": list(ops[0].shape),
                     **hold_to_plain(torch, f"{phase} {name} t={t}", plain_fn, ops, kernel,
                                     bound, k_sum)})
        del a_, blk, idx, per_t
        torch.cuda.empty_cache()

    b_dev = torch.as_tensor(b, device=dev)
    true_res = lambda x_: float(torch.linalg.norm(b_dev - csr_spmv(a, x_)))
    launches = {}

    # ---------------------------------- 45. one-shot ecg_solve at full scale
    # make_block_ell_apply converts with the handle's block_ell_arrays, so
    # the solve must equal phase 4's bit for bit
    t0 = time.perf_counter()
    apply = kernels.make_block_ell_apply(a, 8)
    torch.cuda.synchronize()
    conv_s = time.perf_counter() - t0
    kw = dict(tol=tol, max_iters=MAX_ITERS, backend="pallas")
    res, secs, msgs, got = warned(ecg_solve, apply, b_dev, T, **kw)
    k = res.n_iters
    row = {"phase": "oneshot_sequential", "n": a.shape[0], "t": T, "dtype": "float64", "tol": tol,
           "backend": "pallas", "conversion_s": conv_s, "converged": res.converged, "n_iters": k,
           "main_path_iters": seq_iters, "true_residual": true_res(res.x), "solve_s": secs,
           "ms_per_iter": secs * 1e3 / max(k, 1), "bit_identical_to_main_path": torch.equal(res.x, x4),
           "why": "the one-shot apply converts with the handle's block_ell_arrays",
           "warnings": msgs, "launches": got}
    log(row)
    gate("oneshot_sequential", len(msgs) == 1 and msgs[0].startswith("ecg_solve() is the legacy"),
         f"DeprecationWarnings {msgs}")
    gate("oneshot_sequential", res.converged and k == seq_iters,
         f"converged={res.converged} in {k} iterations, phase 4 {seq_iters}")
    gate("oneshot_sequential", got == want_launches(bsr_spmbv=k + 1, fused_gram=k, ecg_tail=k,
                                                    chol_apply=k), f"launch counts {got}")
    gate("oneshot_sequential", row["true_residual"] <= 10 * tol, f"true residual {row['true_residual']}")
    gate("oneshot_sequential", row["bit_identical_to_main_path"], "x differs from phase 4's")
    launches["oneshot_sequential"] = got
    for name, extra in (("oneshot_round_robin", dict(mapping="round_robin")),
                        ("oneshot_chol_eps", dict(chol_eps=1e-12))):
        r, secs, _, got = warned(ecg_solve, apply, b_dev, T, **kw, **extra)
        rr = true_res(r.x)
        log({"phase": name, **extra, "converged": r.converged, "n_iters": r.n_iters,
             "true_residual": rr, "solve_s": secs, "ms_per_iter": secs * 1e3 / max(r.n_iters, 1),
             "launches": got})
        gate(name, r.converged and rr <= 10 * tol, f"converged={r.converged}, true residual {rr}")
        gate(name, got == want_launches(bsr_spmbv=r.n_iters + 1, fused_gram=r.n_iters,
                                        ecg_tail=r.n_iters, chol_apply=r.n_iters), f"launch counts {got}")
    del res, r

    # --------------------------------------------- 46. cg_solve at full scale
    spmv = lambda v: apply(v[:, None])[:, 0]  # the same apply as a width-1 SpMV
    res, secs, msgs, got = warned(cg_solve, spmv, b_dev, tol=tol, max_iters=MAX_ITERS)
    k = res.n_iters
    row = {"phase": "oneshot_cg", "n": a.shape[0], "t": res.t, "converged": res.converged,
           "n_iters": k, "true_residual": true_res(res.x), "solve_s": secs,
           "ms_per_iter": secs * 1e3 / max(k, 1), "warnings": msgs, "launches": got}
    log(row)
    gate("oneshot_cg", len(msgs) == 1 and msgs[0].startswith("cg_solve() now runs"), f"warnings {msgs}")
    gate("oneshot_cg", res.converged and res.t is None and row["true_residual"] <= 10 * tol,
         f"converged={res.converged} in {k}, true residual {row['true_residual']}")
    gate("oneshot_cg", got == want_launches(bsr_spmbv=k + 1, chol_apply=k), f"launch counts {got}")
    launches["oneshot_cg"] = got
    del res, apply, spmv
    torch.cuda.empty_cache()

    # ------------------------------- 47. distributed_ecg at full scale, (2, 4)
    mesh = make_solver_mesh(n_ranks=8, ppn=4, device=dev)
    mesh.reset_counters()
    (res, op), secs, msgs, got = warned(distributed_ecg, a, b, mesh, T, strategy="optimal",
                                        tol=tol, max_iters=MAX_ITERS, backend="pallas")
    k, plan = res.n_iters, op.plan
    n_ph, n_rot = len(plan.phases), sum(1 for st in plan.steps if st.offset)
    rr = true_res(torch.as_tensor(op.unshard(res.x), device=dev))
    row = {"phase": "oneshot_distributed", "mesh": list(mesh.shape), "strategy": "optimal", "t": T,
           "converged": res.converged, "n_iters": k, "distributed_main_path_iters": dist_iters,
           "true_residual": rr, "build_and_solve_s": secs, "psum": mesh.psum_calls,
           "ppermute": mesh.ppermute_calls, "warnings": msgs, "launches": got}
    log(row)
    gate("oneshot_distributed", len(msgs) == 1 and msgs[0].startswith("distributed_ecg() is the"),
         f"warnings {msgs}")
    gate("oneshot_distributed", res.converged and k == dist_iters,
         f"converged={res.converged} in {k} iterations, phase 8 {dist_iters}")
    gate("oneshot_distributed", got == want_launches(
        bsr_spmbv=k + 1, fused_gram=k, ecg_tail=k, chol_apply=k,
        halo_pack=n_ph * (k + 1), halo_unpack=n_ph * (k + 1)), f"launch counts {got}")
    gate("oneshot_distributed", mesh.psum_calls == 3 * k + 1, f"psum ran {mesh.psum_calls} times")
    gate("oneshot_distributed", mesh.ppermute_calls == n_rot * (k + 1),
         f"ppermute ran {mesh.ppermute_calls} times, want {n_rot}·({k} + 1)")
    gate("oneshot_distributed", rr <= 10 * tol, f"true residual {rr}")
    launches["oneshot_distributed"] = got
    del res, op
    torch.cuda.empty_cache()

    # ------------------------------------------------------ 48. the sweeps
    check_kernel_operands("ecg_sweep_check")  # run_ecg_sweep's kernel_vs_oracle()
    with tempfile.TemporaryDirectory() as tmp:
        rows, secs, _, got = warned(run_ecg_sweep, Path(tmp) / "ecg_perf.json", device=dev)
        written = json.loads((Path(tmp) / "ecg_perf.json").read_text())
    for r_ in rows:
        log({"phase": "ecg_sweep", **r_})
    log({"phase": "ecg_sweep_summary", "rows": len(rows), "seconds": secs, "launches": got})
    # 4 strategies x 2 widths x 2 backends x {blocking, overlap} + 3 widths x
    # 4 kernel rows: 44 (the reference's count)
    gate("ecg_sweep", len(rows) == 44 and written == rows, f"{len(rows)} rows, {len(written)} written")
    gate("ecg_sweep", all(math.isfinite(r_["us"]) and r_["us"] > 0 for r_ in rows), "a time is not > 0")
    gate("ecg_sweep", all(got[k_] > 0 for k_ in ("bsr_spmbv", "fused_gram", "ecg_tail", "halo_pack",
                                                  "halo_unpack")), f"launch counts {got}")
    launches["ecg_sweep"] = got

    # the same sweeps at full width, each kernel row beside its bound (bytes
    # over HBM_BYTES_PER_S, or flops over the peak rate, as phase 3)
    ts_full, n_loc, es = (8, 20), 32768, 4
    check_kernel_operands("kernel_vs_oracle_full_check", ts=ts_full, elements=ELEMENTS, block=BLOCK)
    kvo, secs, _, got = warned(kernel_vs_oracle, ts=ts_full, elements=ELEMENTS, block=BLOCK, device=dev)
    n = a.shape[0]
    kmax = kernels.count_block_ell_tiles(a.indptr, a.indices, n, n, BLOCK, BLOCK)
    nbr = n // BLOCK
    for r_ in kvo:
        kind, t = r_["name"].split("/")[1].rsplit("_t", 1)
        t = int(t)
        bytes_, flops = {
            "block_ell_spmbv": ((nbr * kmax * BLOCK * BLOCK) * es + nbr * kmax * 4 + 2 * n * t * es,
                                2 * nbr * kmax * BLOCK * BLOCK * t),
            "fused_gram": ((4 * n_loc * t + 3 * t * t) * es, 6 * n_loc * t * t),
            "ecg_tail": ((8 * n_loc * t + 3 * t * t) * es, 8 * n_loc * t * t),
        }.get(kind, (None, None))
        if bytes_ is not None:
            bound_ms = max(bytes_ / HBM_BYTES_PER_S, flops / PEAK_FLOPS["float32"]) * 1e3
            r_.update(bound_ms=bound_ms, share_of_bound=bound_ms / (r_["us"] * 1e-3),
                      bound_by="bytes" if bytes_ / HBM_BYTES_PER_S >= flops / PEAK_FLOPS["float32"]
                      else "operations")
        log({"phase": "kernel_vs_oracle_full", "dtype": "float32", "kmax": kmax, **r_})
    log({"phase": "kernel_vs_oracle_full_summary", "rows": len(kvo), "seconds": secs, "launches": got})
    gate("kernel_vs_oracle_full", len(kvo) == 4 * len(ts_full)
         and all(math.isfinite(r_["us"]) and r_["us"] > 0 for r_ in kvo), f"rows {kvo}")
    gate("kernel_vs_oracle_full", all(got[k_] > 0 for k_ in ("bsr_spmbv", "fused_gram", "ecg_tail")),
         f"launch counts {got}")
    launches["kernel_vs_oracle_full"] = got
    ovb, secs, _, got = warned(overlap_vs_blocking_sweep, a, mesh, ts=(T,), strategies=("optimal",),
                               backends=("pallas",))
    for r_ in ovb:
        log({"phase": "overlap_vs_blocking_full", **r_})
    log({"phase": "overlap_vs_blocking_full_summary", "seconds": secs, "launches": got})
    gate("overlap_vs_blocking_full", len(ovb) == 2 and all(r_["us"] > 0 for r_ in ovb), f"rows {ovb}")
    launches["overlap_vs_blocking_full"] = got
    torch.cuda.empty_cache()
    return launches


def process_mesh_worker(out_dir: Path, rank: int, world: int) -> int:
    """One rank of phase 49's NCCL world, on card ``rank``: Example 2.1's
    solve on ``ProcessGroupMesh`` (a world of 1: (1, 1) with ``optimal``;
    else (2, world/2) with ``standard`` and ``optimal``), each with the
    launch counts and the mesh's counters set to 0 just before it, and the
    SpMBV and the exchange alone timed after it.  Rank 0 then, with the
    group gone, solves the same systems on ``VirtualMesh`` on its card.
    Writes ``rank<r>.json``."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import kernels
    from repro_torch.launch.mesh import ProcessGroupMesh, VirtualMesh
    from repro_torch.solver import CommConfig, ECGSolver, KernelConfig, SolverConfig
    from repro_torch.sparse import csr_spmv, dg_laplace_2d

    torch.cuda.set_device(rank)  # NCCL: the card before the group
    dev = torch.device("cuda", rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("nccl", init_method=f"file://{out_dir / 'rendezvous'}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))
    shape = (1, 1) if world == 1 else (2, world // 2)
    strategies = ("optimal",) if world == 1 else ("standard", "optimal")
    t0 = time.perf_counter()
    a = dg_laplace_2d(ELEMENTS, block=BLOCK, device=dev)
    b = np.random.default_rng(0).standard_normal(a.shape[0])
    tol = 1e-8 * float(np.linalg.norm(b))
    b_dev = torch.as_tensor(b, device=dev)
    gen_s = time.perf_counter() - t0

    def counted_solve(solver, mesh):
        kernels.reset_launch_counts()
        mesh.reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solver.solve(b)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        run = {"n_iters": res.n_iters, "converged": res.converged, "solve_s": secs,
               "ms_per_iter": secs * 1e3 / max(res.n_iters, 1), "launches": kernels.launch_counts(),
               "psum": mesh.psum_calls, "ppermute": mesh.ppermute_calls,
               "ppermute_elements": mesh.ppermute_elements}
        x = solver.unshard(res.x)  # every process: one all_gather
        run["true_residual"] = float(torch.linalg.norm(
            b_dev - csr_spmv(a, torch.as_tensor(x, device=dev))))
        return run, x

    def apply_and_exchange_ms(solver, mesh, reps=50):
        """ms of one SpMBV, of its exchange alone and of one psum of the
        packed Gram payload, (t, 3t) (mean of ``reps``)."""
        op = solver.op
        v = torch.randn(op.n_padded, T, dtype=torch.float64, device=dev)
        apply, ex = op.matvec_fn(), op.exchange(op.plan, T, torch.float64)
        v3 = v.reshape(mesh.local_ranks, op.rmax, T)
        g = torch.randn(mesh.local_ranks, T, 3 * T, dtype=torch.float64, device=dev)
        out = {}
        for name, fn in (("spmbv_ms", lambda: apply(v)), ("exchange_ms", lambda: ex.run(v3)),
                         ("psum_ms", lambda: mesh.psum(g))):
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            out[name] = (time.perf_counter() - t0) * 1e3 / reps
        return out

    rows, keep, pm, conversion = [], [], None, None
    try:
        mesh = ProcessGroupMesh(*shape)
        for strategy in strategies:
            cfg = SolverConfig(t=T, tol=tol, max_iters=MAX_ITERS, comm=CommConfig(strategy=strategy),
                               kernel=KernelConfig(backend="pallas"))
            t0 = time.perf_counter()
            # the second strategy reuses the first's partition and own tiles
            solver = ECGSolver.build(a, mesh, cfg, pm=pm, conversion=conversion)
            pm, conversion = solver.partition, solver.conversion
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            run, x = counted_solve(solver, mesh)
            plan = solver.op.plan
            rows.append({"strategy": strategy, "mesh": list(shape), "rank": rank, "device": str(dev),
                         "backend": mesh.backend, "tol": tol, "generate_s": gen_s, "build_s": build_s,
                         "blocks": list(solver.op.ell["blocks"].shape), "n_phases": len(plan.phases),
                         "rotations": sum(1 for st in plan.steps if st.offset), **run,
                         **apply_and_exchange_ms(solver, mesh)})
            keep.append((cfg, x))
            del solver
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    # the same solves with every rank stacked on this card; a world of 1
    # reuses its own tiles (one rank's layout is the stacked one)
    conversion = conversion if world == 1 else None
    if rank == 0:
        for row, (cfg, x) in zip(rows, keep):
            vm = VirtualMesh(*shape, device=dev)
            vsolver = ECGSolver.build(a, vm, cfg, pm=pm, conversion=conversion)
            conversion = vsolver.conversion
            vrun, vx = counted_solve(vsolver, vm)
            row["virtual"] = {**vrun, **apply_and_exchange_ms(vsolver, vm),
                              "conversion_reused": vsolver.stats.conv_reused}
            row["bit_identical_to_virtual"] = bool(np.array_equal(x, vx))
            row["max_abs_diff_to_virtual"] = float(np.abs(x - vx).max())
            del vsolver
            torch.cuda.empty_cache()
    (out_dir / f"rank{rank}.json").write_text(json.dumps(rows))
    return 0


def spawn_world(world: int, timeout_s: float, flag: str = "--process-mesh-worker",
                phase: str = "process_mesh") -> list:
    """Start ``world`` processes of the worker that ``flag`` names
    (:func:`process_mesh_worker`, :func:`lm_mesh_worker`), one per card, and
    return each rank's rows.  A process that fails or outlives
    ``timeout_s`` fails the phase; every process is stopped before this
    returns."""
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        env = dict(os.environ, NCCL_SOCKET_IFNAME=os.environ.get("NCCL_SOCKET_IFNAME", "lo"))
        logs = [open(d / f"rank{r}.log", "w") for r in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), flag, str(d), str(r),
             str(world)], env=env | {"RANK": str(r), "LOCAL_RANK": str(r), "WORLD_SIZE": str(world)},
            stdout=logs[r], stderr=subprocess.STDOUT) for r in range(world)]
        try:
            deadline = time.monotonic() + timeout_s
            for p in procs:
                p.wait(timeout=max(deadline - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        failed = {r: (p.returncode, (d / f"rank{r}.log").read_text()[-3000:])
                  for r, p in enumerate(procs) if p.returncode != 0}
        gate(phase, not failed, f"world of {world}: ranks failed or timed out: {failed}")
        return [json.loads((d / f"rank{r}.json").read_text()) for r in range(world)]


def process_mesh_phases(torch, seq_iters: int) -> dict:
    """Phase 49: the process-group mesh on the card(s).  ``seq_iters`` is
    phase 4's iteration count (logged beside).  Returns rank 0's launch
    counts of each solve for the ``kernels`` line."""
    launches = {}
    count = torch.cuda.device_count()
    world_ii = min(count, 8) // 2 * 2
    for world, phase in ((1, "process_mesh_world1"), (world_ii, "process_mesh_multi_card")):
        if world < 2 and phase == "process_mesh_multi_card":
            log({"phase": phase, "ran": False, "cards": count,
                 "why": f"torch.cuda.device_count() is {count}: NCCL puts at most one rank of a "
                        "communicator on a card, so a 2 × k mesh needs two cards or more; "
                        "(ii) did not run"})
            continue
        t0 = time.perf_counter()
        per_rank = spawn_world(world, timeout_s=400)
        secs = time.perf_counter() - t0
        for i, row in enumerate(per_rank[0]):
            k = row["n_iters"]
            v = row["virtual"]
            ranks = [r_[i] for r_ in per_rank]
            n_ph, n_rot = row["n_phases"], row["rotations"]
            want = {"bsr_spmbv": k + 1, "fused_gram": k, "ecg_tail": k, "chol_apply": k,
                    "halo_pack": n_ph * (k + 1), "halo_unpack": n_ph * (k + 1),
                    "block_trisolve": 0, "block_update": 0, "rank_apply": 0, "drop_mask": 0}
            summary = {
                "phase": phase, "ran": True, "world": world, "mesh": row["mesh"],
                "strategy": row["strategy"], "backend": row["backend"], "n_iters": k,
                "virtual_n_iters": v["n_iters"], "main_path_iters": seq_iters,
                "ms_per_iter": row["ms_per_iter"], "virtual_ms_per_iter": v["ms_per_iter"],
                "ms_per_iter_by_rank": [r_["ms_per_iter"] for r_ in ranks],
                "spmbv_ms": row["spmbv_ms"], "exchange_ms": row["exchange_ms"],
                "exchange_share": row["exchange_ms"] / row["ms_per_iter"],
                "psum_ms": row["psum_ms"], "virtual_psum_ms": v["psum_ms"],
                "virtual_spmbv_ms": v["spmbv_ms"], "virtual_exchange_ms": v["exchange_ms"],
                "virtual_exchange_share": v["exchange_ms"] / v["ms_per_iter"],
                "true_residual": row["true_residual"], "virtual_true_residual": v["true_residual"],
                "tol": row["tol"],
                "bit_identical_to_virtual": row["bit_identical_to_virtual"],
                "max_abs_diff_to_virtual": row["max_abs_diff_to_virtual"],
                "psum": [r_["psum"] for r_ in ranks], "ppermute": [r_["ppermute"] for r_ in ranks],
                "ppermute_elements": sum(r_["ppermute_elements"] for r_ in ranks),
                "virtual_ppermute_elements": v["ppermute_elements"],
                "blocks": row["blocks"], "build_s": row["build_s"], "generate_s": row["generate_s"],
                "conversion_reused_by_virtual": v["conversion_reused"],
                "launches": row["launches"], "seconds": secs}
            log(summary)
            name = f"{phase} {row['strategy']}"
            gate(name, all(r_["converged"] for r_ in ranks) and v["converged"],
                 "a solve did not converge")
            gate(name, all(r_["n_iters"] == k for r_ in ranks), "the ranks' iterations differ")
            gate(name, all(r_["psum"] == 3 * k + 1 for r_ in ranks), f"psum {summary['psum']}, want 3·{k} + 1")
            gate(name, all(r_["ppermute"] == n_rot * (k + 1) for r_ in ranks),
                 f"ppermute {summary['ppermute']}, want {n_rot}·({k} + 1)")
            gate(name, all(r_["launches"] == want for r_ in ranks), f"launch counts {row['launches']} != {want}")
            gate(name, summary["ppermute_elements"] == v["ppermute_elements"],
                 "the ranks' exchanged elements do not sum to the virtual mesh's")
            gate(name, all(r_["true_residual"] <= 10 * r_["tol"] for r_ in ranks)
                 and v["true_residual"] <= 10 * row["tol"], "a true residual over 10·tol")
            if world == 1:
                gate(name, k == v["n_iters"] and row["bit_identical_to_virtual"],
                     f"{k} iterations, VirtualMesh(1, 1) {v['n_iters']}; x bit-identical: "
                     f"{row['bit_identical_to_virtual']}")
            else:
                gate(name, abs(k - v["n_iters"]) <= max(1, 0.01 * v["n_iters"]),
                     f"{k} iterations, VirtualMesh {v['n_iters']}")
            launches[f"{phase}_{row['strategy']}"] = row["launches"]
    return launches


def lm_mesh_worker(out_dir: Path, rank: int, world: int) -> int:
    """One rank of phase 54's NCCL world, on card ``rank`` (module
    docstring): a world of 1 runs (i), a world of 2 the (1, 2) step of
    (ii), a world of 4 its (2, 2) granite-8b step.  Writes ``rank<r>.json``."""
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import kernels
    from repro_torch.collectives import hierarchical_allreduce
    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.mesh import LMMesh
    from repro_torch.models import moe as M
    from repro_torch.models.common import gather_named
    from repro_torch.models.registry import model_api
    from repro_torch.train import (AdamWConfig, DataConfig, batch_at, build_serve_step, build_train_step,
                                   init_opt_state)

    torch.cuda.set_device(rank)  # NCCL: the card before the group
    dev = torch.device("cuda", rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    gib = 2.0 ** 30
    dist.init_process_group("nccl", init_method=f"file://{out_dir / 'rendezvous'}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    opt_cfg = AdamWConfig(lr=1e-3, eps=1e-3, warmup_steps=2, total_steps=10)

    def n002(mdl, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        with torch.no_grad():
            for p_ in mdl.parameters():
                if p_.dim() >= 2:
                    p_.normal_(0.0, 0.02, generator=gen)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def full_n002(arch, dtype, seed=0, **kw):
        """The config at full width (``kw`` its cuts) and its model on the
        card, every weight of two dims or more from N(0, 0.02) (the
        initialiser's rule saturates attention, as in phase 50)."""
        cfg = get_config(arch).with_(dtype=dtype, **kw)
        full = model_api(cfg).init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
        n002(full, 29)
        return cfg, full

    def batch_of(cfg, bundle, batch, seq, step):
        extra = {k: v for k, v in bundle.input_specs.items() if k not in ("tokens", "labels")}
        return batch_at(DataConfig(vocab=cfg.vocab, batch=batch, seq=seq), step, extra=extra, device=dev)

    def sharded_steps(cfg, shape, batch, seq, full=None, seed=0):
        """Two sharded steps on ``shape`` from ``full`` (or, without it, the
        initialiser's weights): the metrics, ms, NCCL calls and elements by
        axis, launches per step."""
        names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
        mesh = LMMesh(shape, names)
        bundle = build_train_step(cfg, opt_cfg, batch=batch, seq=seq, mesh=mesh)
        # without full weights every process draws the initialiser's values
        # and keeps its blocks
        model = bundle.init(torch.Generator(device=dev).manual_seed(seed)) if full is None \
            else bundle.shard(full)
        opt = bundle.init_opt(model)
        torch.cuda.reset_peak_memory_stats(dev)
        rows = []
        for step in range(2):
            data = batch_of(cfg, bundle, batch, seq, step)
            mesh.reset_counters()
            kernels.reset_launch_counts()
            with M.record_dropped() as drops:
                m, ms = timed(lambda: bundle.step_fn(model, opt, data))
            rows.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]), "lr": m["lr"],
                         "ms": ms, "nccl_calls": dict(mesh.calls), "nccl_elements": dict(mesh.elements),
                         "dropped": sum(int(n) for n in drops), "launches": kernels.launch_counts()})
        return mesh, bundle, model, opt, rows, torch.cuda.max_memory_allocated(dev) / gib

    def against_one_device(arch, kw, batch, seq):
        """(i): two sharded steps on (1, 1) and two one-device steps from the
        same N(0, 0.02) weights, in turns (sharded, one device, one device,
        sharded)."""
        cfg, full = full_n002(arch, torch.float32, **kw)
        torch.cuda.reset_peak_memory_stats(dev)
        mesh = LMMesh((1, 1), ("data", "model"))
        bundle = build_train_step(cfg, opt_cfg, batch=batch, seq=seq, mesh=mesh)
        model = bundle.shard(full)
        opt = bundle.init_opt(model)
        one_fn = build_train_step(cfg, opt_cfg, batch=batch, seq=seq, device=dev).step_fn
        one_opt = init_opt_state(full)
        sharded, one = [], []
        for step in range(2):
            data = batch_of(cfg, bundle, batch, seq, step)

            def run_sharded():
                mesh.reset_counters()
                kernels.reset_launch_counts()
                m, ms = timed(lambda: bundle.step_fn(model, opt, data))
                sharded.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]), "ms": ms,
                                "nccl_calls": dict(mesh.calls), "nccl_elements": dict(mesh.elements),
                                "launches": kernels.launch_counts()})

            def run_one():
                m, ms = timed(lambda: one_fn(full, one_opt, data))
                one.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]), "ms": ms})

            for fn in ((run_sharded, run_one) if step == 0 else (run_one, run_sharded)):
                fn()
        spec_of = bundle.state_specs["params"]
        mom_of = bundle.state_specs["opt"]["mu"]
        p_max = mu_max = dp = dmu = 0.0
        full_p = dict(full.named_parameters())
        for name, p_ in model.named_parameters():  # gathered leaf by leaf
            g = gather_named({name: p_}, spec_of, mesh)[name]
            gm = gather_named({name: opt["mu"][name]}, mom_of, mesh)[name]
            ref_p, ref_mu = full_p[name].detach(), one_opt["mu"][name]
            p_max, mu_max = max(p_max, float(ref_p.abs().max())), max(mu_max, float(ref_mu.abs().max()))
            dp, dmu = max(dp, float((g - ref_p).abs().max())), max(dmu, float((gm - ref_mu).abs().max()))
            del g, gm
        rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
        row = {"arch": cfg.name, "layers": cfg.n_layers, "batch": batch, "seq": seq, "mesh": [1, 1],
               "kw": kw, "extra_inputs": {k: list(v[0]) for k, v in bundle.input_specs.items()
                                          if k not in ("tokens", "labels")},
               "sharded": sharded, "one_device": one,
               "loss_rel": max(rel(a["loss"], b["loss"]) for a, b in zip(sharded, one)),
               "grad_norm_rel": max(rel(a["grad_norm"], b["grad_norm"]) for a, b in zip(sharded, one)),
               "max_dmu_over_max_mu": dmu / mu_max, "max_dp_over_max_p": dp / p_max,
               "peak_gib": torch.cuda.max_memory_allocated(dev) / gib}
        del model, opt, full, full_p, one_opt
        torch.cuda.empty_cache()
        return row

    def greedy(cfg, step_fn, info, params, frames, slots, n_tokens, mesh=None, feed=None):
        """``n_tokens`` greedy tokens at batch 1 from token 1 at slot 0 (the
        encoder-decoder after ``prefill`` of ``frames``): the tokens, the
        logits (float32, gathered on a mesh), ms of each token, NCCL calls
        of the last token.  With ``feed`` the step after token t is fed
        ``feed[t]`` in place of the token it picked."""
        cache = info["prefill"](params, frames) if "prefill" in info else info["init_cache"]()
        tok = torch.ones(1, dtype=torch.int32, device=dev)
        toks, logits, ms, calls = [], [], [], {}
        for t in range(n_tokens):
            if mesh is not None:
                mesh.reset_counters()
            lg, ms_t = timed(lambda: step_fn(params, cache, {
                "token": tok, "pos": torch.full((1,), t, dtype=torch.int32, device=dev)})[0])
            if mesh is not None:
                calls = dict(mesh.calls)
                lg = info["gather_logits"](lg)
            logits.append(lg.float())
            tok = lg[:, :cfg.vocab].argmax(dim=-1).to(torch.int32)
            toks.append(int(tok))
            if feed is not None:
                tok = torch.full((1,), feed[t], dtype=torch.int32, device=dev)
            ms.append(ms_t)
        del cache
        return toks, torch.stack(logits), ms, calls

    def decode_against_one_device(arch, slots, n_tokens=8, **kw):
        """(i): ``n_tokens`` greedy bf16 tokens through
        ``build_serve_step(mesh=…)`` on (1, 1) and through the one-device
        step on the same N(0, 0.02) weights, batch 1, ``slots`` cache
        slots."""
        cfg, full = full_n002(arch, get_config(arch).dtype, seed=3, **kw)
        frames = None
        if cfg.family == "encdec":
            frames = (torch.randn((1, cfg.enc_ctx, cfg.d_model), generator=torch.Generator(device=dev)
                                  .manual_seed(5), device=dev) * 0.02).to(cfg.dtype)
        torch.cuda.reset_peak_memory_stats(dev)
        mesh = LMMesh((1, 1), ("data", "model"))
        step_s, info_s = build_serve_step(cfg, 1, slots, mesh=mesh)
        params = info_s["shard"](full)
        kernels.reset_launch_counts()
        s_toks, s_logits, s_ms, calls = greedy(cfg, step_s, info_s, params, frames, slots, n_tokens, mesh)
        row = {"arch": cfg.name, "layers": cfg.n_layers, "dtype": str(cfg.dtype).removeprefix("torch."),
               "batch": 1, "cache_slots": slots, "mesh": [1, 1], "tokens": n_tokens,
               "cache_specs": {k: list(v) for k, v in info_s["cache_specs"].items()},
               "tokens_sharded": s_toks, "ms_per_token": statistics.median(s_ms[2:]),
               "ms_first_token": s_ms[0], "nccl_calls_per_token": calls,
               "launches": kernels.launch_counts(),
               "logits_finite": bool(torch.isfinite(s_logits).all())}
        del params
        torch.cuda.empty_cache()
        step_1, info_1 = build_serve_step(cfg, 1, slots, device=dev)
        o_toks, o_logits, o_ms, _ = greedy(cfg, step_1, info_1, full, frames, slots, n_tokens)
        row |= {"tokens_one_device": o_toks, "tokens_equal": s_toks == o_toks,
                "one_device_ms_per_token": statistics.median(o_ms[2:]),
                "max_abs_dlogit": float((s_logits - o_logits).abs().max()),
                "max_abs_logit": float(o_logits.abs().max())}
        row["peak_gib"] = torch.cuda.max_memory_allocated(dev) / gib
        full = None
        torch.cuda.empty_cache()
        return row

    def decode_across_cards(arch, slots, shape, n_layers, n_tokens=8):
        """(ii): the slot-sharded decode on ``shape`` at full width on
        ``n_layers`` layers, batch 1, against rank 0's one-device decode on
        the same N(0, 0.02) weights: in f32 the greedy tokens and logits;
        then in bf16 (the same weights rounded) both paths fed the f32
        sharded run's tokens, each path's logits against the f32 one-device
        logits."""
        cfg, full = full_n002(arch, torch.float32, seed=3, n_layers=n_layers)
        torch.cuda.reset_peak_memory_stats(dev)
        mesh = LMMesh(shape, ("data", "model"))
        row = {"arch": cfg.name, "layers": cfg.n_layers, "of_layers": get_config(arch).n_layers, "batch": 1,
               "cache_slots": slots, "mesh": list(shape), "tokens": n_tokens}
        ref = feed = None
        for dtype in (torch.float32, torch.bfloat16):
            c, tag = cfg.with_(dtype=dtype), str(dtype).removeprefix("torch.")
            full = full.to(dtype)
            step_s, info_s = build_serve_step(c, 1, slots, mesh=mesh)
            params = info_s["shard"](full)
            s_toks, s_logits, s_ms, calls = greedy(c, step_s, info_s, params, None, slots, n_tokens, mesh, feed)
            del params
            torch.cuda.empty_cache()
            row[tag] = {"fed": feed is not None, "tokens_sharded": s_toks,
                        "ms_per_token": statistics.median(s_ms[2:]), "ms_first_token": s_ms[0],
                        "nccl_calls_per_token": calls, "logits_finite": bool(torch.isfinite(s_logits).all())}
            if rank == 0:
                step_1, info_1 = build_serve_step(c, 1, slots, device=dev)
                o_toks, o_logits, o_ms, _ = greedy(c, step_1, info_1, full, None, slots, n_tokens, feed=feed)
                ref = o_logits if ref is None else ref
                row[tag] |= {"tokens_one_device": o_toks, "one_device_ms_per_token": statistics.median(o_ms[2:]),
                             "max_abs_dlogit": float((s_logits - o_logits).abs().max()),
                             "max_abs_logit": float(o_logits.abs().max()),
                             "sharded_err_vs_f32": float((s_logits - ref).abs().max()),
                             "one_device_err_vs_f32": float((o_logits - ref).abs().max())}
                torch.cuda.empty_cache()
            feed = s_toks if feed is None else feed
        row["peak_gib"] = torch.cuda.max_memory_allocated(dev) / gib
        del full
        torch.cuda.empty_cache()
        return row

    def one_device_steps(cfg, full, batch, seq):
        """Rank 0's two one-device steps on the sharded run's weights and
        data, for (ii)'s comparison."""
        bundle = build_train_step(cfg, opt_cfg, batch=batch, seq=seq, device=dev)
        one_opt = init_opt_state(full)
        one = []
        for step in range(2):
            m, ms = timed(lambda: bundle.step_fn(full, one_opt, batch_of(cfg, bundle, batch, seq, step)))
            one.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]), "ms": ms})
        return one

    out = {}
    try:
        if world == 1:
            # collectives against their definitions (a world of 1: each is x)
            flat, pod = LMMesh((1, 1), ("data", "model")), LMMesh((1, 1, 1), ("pod", "data", "model"))
            x = torch.randn(8, 256, 2048, device=dev)
            checks = {"all_gather": flat.all_gather(x, "data", 1), "reduce_scatter": flat.reduce_scatter(x, "model", 1),
                      "psum": flat.psum(x, ("data", "model")), "hierarchical_two_step": hierarchical_allreduce(x, pod),
                      "hierarchical_no_pod": hierarchical_allreduce(x, flat)}
            _, psum_ms = timed(lambda: [flat.psum(x, "model") for _ in range(50)])
            out["collectives"] = {"equal": {k: bool(torch.equal(v, x)) for k, v in checks.items()},
                                  "calls": dict(flat.calls) | {"pod_mesh": dict(pod.calls)},
                                  "psum_ms_residual_8x256x2048": psum_ms / 50}
            # the trainer's CLI inside the world on its (1, 1) mesh, at the smoke
            # preset (the full width runs below, against the one-device step):
            # 2 steps with checkpoints, resumed to 4, and 4 uninterrupted
            ckpt = out_dir / "cli_ckpt"
            for tag, extra in (("cli", ["--steps", "2", "--ckpt-dir", str(ckpt)]),
                               ("cli_resumed", ["--steps", "4", "--ckpt-dir", str(ckpt), "--resume"]),
                               ("cli_uninterrupted", ["--steps", "4"])):
                buf = __import__("io").StringIO()
                t0 = time.perf_counter()
                with __import__("contextlib").redirect_stdout(buf):
                    train_cli.main(["--arch", "stablelm_1_6b", "--preset", "smoke", "--mesh", "1,1",
                                    "--log-every", "1"] + extra)
                out[tag] = {"lines": buf.getvalue().splitlines(), "seconds": time.perf_counter() - t0}
            torch.cuda.empty_cache()
            out["stablelm"] = against_one_device("stablelm_1_6b", {}, 8, 256)
            # olmoe: 2 of 16 layers; capacity_factor E/k: no pick drops
            out["olmoe"] = against_one_device("olmoe_1b_7b", {"n_layers": 2, "capacity_factor": 8.0}, 8, 256)
            # the ssm, hybrid and encdec families at full width and depth
            # (whisper's 8 x 1500 frames beside its 8 x 256 tokens)
            for arch in ("mamba2_780m", "zamba2_1_2b", "whisper_medium"):
                out[arch] = against_one_device(arch, {}, 8, 256)
            # the sharded decode step of every family, bf16, 32768 slots
            out["decode"] = [decode_against_one_device(arch, 32768) for arch in
                             ("stablelm_1_6b", "mamba2_780m", "zamba2_1_2b", "whisper_medium", "olmoe_1b_7b")]
        elif world == 2:  # stablelm and mamba2 on (1, 2), each against rank 0's one-device steps
            for arch in ("stablelm_1_6b", "mamba2_780m"):
                cfg, full = full_n002(arch, torch.float32)
                *_, rows, peak = sharded_steps(cfg, (1, 2), 8, 256, full=full)
                out[arch] = {"arch": cfg.name, "mesh": [1, 2], "steps": rows, "peak_gib": peak}
                if rank == 0:  # the same weights and data on one card
                    out[arch]["one_device"] = one_device_steps(cfg, full, 8, 256)
                del full
                torch.cuda.empty_cache()
        else:
            # granite-8b at full depth: 132 GB of f32 state over four cards
            cfg = get_config("granite_8b").with_(dtype=torch.float32)
            *_, rows, peak = sharded_steps(cfg, (2, 2), 8, 256, seed=31)
            out["granite_8b"] = {"arch": cfg.name, "mesh": [2, 2], "steps": rows, "peak_gib": peak}
            torch.cuda.empty_cache()
            # zamba2 at full depth on (2, 2), against rank 0's one-device steps
            cfg, full = full_n002("zamba2_1_2b", torch.float32)
            *_, rows, peak = sharded_steps(cfg, (2, 2), 8, 256, full=full)
            out["zamba2_1_2b"] = {"arch": cfg.name, "mesh": [2, 2], "steps": rows, "peak_gib": peak}
            if rank == 0:
                out["zamba2_1_2b"]["one_device"] = one_device_steps(cfg, full, 8, 256)
            del full
            torch.cuda.empty_cache()
            # phi3-medium's 10 K/V heads do not divide 4: the cache's slots
            # go over "model", and each token's attention is combined across
            # the cards; rank 0 also decodes on one card, in f32 on 10 of
            # the 40 layers (it then holds the f32 model beside its block)
            out["decode"] = decode_across_cards("phi3_medium_14b", 32768, (1, 4), 10)
    finally:
        dist.destroy_process_group()
    (out_dir / f"rank{rank}.json").write_text(json.dumps(out))
    return 0


def lm_mesh_phases(torch) -> dict:
    """Phase 54: the LM half's 2-D layout over NCCL (module docstring).
    Returns rank 0's kernel launches in (i)'s sharded steps (the LM half
    has no Pallas kernel: all 0)."""
    t_phase = time.perf_counter()
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    out = spawn_world(1, timeout_s=700, flag="--lm-mesh-worker", phase="lm_mesh")[0]
    col = out["collectives"]
    log({"phase": "lm_mesh_collectives", "world": 1, **col})
    gate("lm_mesh_collectives", all(col["equal"].values()), f"a collective differs from x: {col['equal']}")
    lines = out["cli"]["lines"]
    steps = [ln.split() for ln in lines if ln.startswith("step ")]
    log({"phase": "lm_mesh_cli", "world": 1, "mesh": [1, 1], **out["cli"]})
    gate("lm_mesh_cli", lines[0] == "arch=stablelm-smoke params=0.5M preset=smoke" and lines[-1] == "done"
         and len(steps) == 2 and all(math.isfinite(float(s_[3])) and math.isfinite(float(s_[5]))
                                     for s_ in steps), f"printed {lines}")
    # the CLI stopped after 2 steps with --ckpt-dir, resumed to 4: the loss
    # lines (without the ms) equal the uninterrupted 4-step run's
    fields = lambda ls: [ln.split()[:8] for ln in ls if ln.startswith("step ")]
    resumed, whole = out["cli_resumed"]["lines"], out["cli_uninterrupted"]["lines"]
    log({"phase": "lm_mesh_checkpoint", "world": 1, "mesh": [1, 1], "first": lines, "resumed": resumed,
         "uninterrupted": whole, "seconds": out["cli_resumed"]["seconds"]})
    gate("lm_mesh_checkpoint", "resumed from step 2" in resumed and len(fields(whole)) == 4
         and fields(lines) == fields(whole)[:2] and fields(resumed) == fields(whole)[2:],
         f"first {lines}, resumed {resumed}, uninterrupted {whole}")
    launches = {}
    reduced = {"olmoe": "depth: 2 of 16 layers at full width (the f32 state of 16 is 111 GB)"}
    for arch in ("stablelm", "olmoe", "mamba2_780m", "zamba2_1_2b", "whisper_medium"):
        row = out[arch]
        sh, one = row["sharded"], row["one_device"]
        summary = {"phase": "lm_mesh_world1", "card": smi, "world": 1, **row,
                   "ms_per_step": [r_["ms"] for r_ in sh], "one_device_ms_per_step": [r_["ms"] for r_ in one],
                   "nccl_calls_per_step": sh[-1]["nccl_calls"],
                   "nccl_calls_total_per_step": sum(sh[-1]["nccl_calls"].values())}
        if arch in reduced:
            summary["reduced"] = reduced[arch]
        log(summary)
        gate(f"lm_mesh_world1 {row['arch']}", row["loss_rel"] <= 1e-5 and row["grad_norm_rel"] <= 1e-5
             and row["max_dmu_over_max_mu"] <= 1e-4 and row["max_dp_over_max_p"] <= 1e-5
             and all(math.isfinite(r_["loss"]) for r_ in sh) and sum(sh[-1]["nccl_calls"].values()) > 0,
             f"loss_rel {row['loss_rel']}, grad_norm_rel {row['grad_norm_rel']}, mu "
             f"{row['max_dmu_over_max_mu']}, p {row['max_dp_over_max_p']}")
        for r_ in sh:
            for k, v in r_["launches"].items():
                launches[k] = launches.get(k, 0) + v
    for row in out["decode"]:
        log({"phase": "lm_mesh_decode_world1", "card": smi, "world": 1, **row})
        gate(f"lm_mesh_decode_world1 {row['arch']}", row["tokens_equal"] and row["logits_finite"]
             and row["max_abs_dlogit"] <= DECODE_GATE * row["max_abs_logit"],
             f"tokens {row['tokens_sharded']} against {row['tokens_one_device']}, max |dlogit| "
             f"{row['max_abs_dlogit']} of {row['max_abs_logit']}")
        for k, v in row["launches"].items():
            launches[k] = launches.get(k, 0) + v
    worlds = ((2, "(1, 2): stablelm-1.6b and mamba2-780m"),
              (4, "(2, 2): granite-8b and zamba2-1.2b at full depth; (1, 4): phi3-medium-14b decode"))
    for world, what in worlds:
        phase = f"lm_mesh_{'x'.join(map(str, (1, 2) if world == 2 else (2, 2)))}"
        if count < world:
            log({"phase": phase, "ran": False, "cards": count,
                 "why": f"torch.cuda.device_count() is {count}: NCCL puts at most one rank of a "
                        f"communicator on a card, so the {what} world needs {world} cards; (ii) did "
                        "not run"})
            continue
        t0 = time.perf_counter()
        per_rank = spawn_world(world, timeout_s=700, flag="--lm-mesh-worker", phase=phase)
        for arch in ("stablelm_1_6b", "mamba2_780m") if world == 2 else ("granite_8b", "zamba2_1_2b"):
            rows = [r_[arch] for r_ in per_rank]
            summary = {"phase": phase, "ran": True, "world": world, "card": smi, "mesh": rows[0]["mesh"],
                       "arch": rows[0]["arch"], "steps": rows[0]["steps"],
                       "ms_per_step_by_rank": [[s_["ms"] for s_ in r_["steps"]] for r_ in rows],
                       "peak_gib_by_rank": [r_["peak_gib"] for r_ in rows],
                       "seconds": time.perf_counter() - t0}
            ok = all(math.isfinite(s_["loss"]) and math.isfinite(s_["grad_norm"])
                     for r_ in rows for s_ in r_["steps"])
            same = all(abs(s_["loss"] - t_["loss"]) == 0
                       for r_ in rows for s_, t_ in zip(r_["steps"], rows[0]["steps"]))
            summary["metrics_equal_on_every_rank"] = same
            if "one_device" in rows[0]:
                one = rows[0]["one_device"]
                summary["one_device"] = one
                summary["loss_rel"] = max(abs(s_["loss"] - o["loss"]) / abs(o["loss"])
                                          for s_, o in zip(rows[0]["steps"], one))
                summary["grad_norm_rel"] = max(abs(s_["grad_norm"] - o["grad_norm"]) / abs(o["grad_norm"])
                                               for s_, o in zip(rows[0]["steps"], one))
                ok = ok and summary["loss_rel"] <= 1e-4 and summary["grad_norm_rel"] <= 1e-4
            log(summary)
            gate(f"{phase} {arch}", ok and same, f"steps {rows[0]['steps']}")
        if world == 4:
            rows = [r_["decode"] for r_ in per_rank]
            row, f32, b16 = rows[0], rows[0]["float32"], rows[0]["bfloat16"]
            log({"phase": "lm_mesh_decode_1x4", "ran": True, "world": 4, "card": smi, **row,
                 "reduced": f"depth: {row['layers']} of {row['of_layers']} layers at full width (rank 0 "
                            "holds the f32 model beside its block)",
                 "ms_per_token_by_rank": {t: [r_[t]["ms_per_token"] for r_ in rows]
                                          for t in ("float32", "bfloat16")},
                 "peak_gib_by_rank": [r_["peak_gib"] for r_ in rows]})
            same = all(r_[t]["tokens_sharded"] == row[t]["tokens_sharded"]
                       for r_ in rows for t in ("float32", "bfloat16"))
            # f32: the combine across cards against one card, the tokens equal
            # and the logits within F32_DECODE_GATE of the largest; bf16 (both
            # paths fed the f32 tokens): the sharded path's error against the
            # f32 one-device logits at most BF16_ACROSS_CARDS times the
            # one-device bf16 path's
            gate("lm_mesh_decode_1x4", same and f32["tokens_sharded"] == f32["tokens_one_device"]
                 and f32["logits_finite"] and b16["logits_finite"]
                 and f32["max_abs_dlogit"] <= F32_DECODE_GATE * f32["max_abs_logit"]
                 and b16["sharded_err_vs_f32"] <= BF16_ACROSS_CARDS * b16["one_device_err_vs_f32"],
                 f"tokens by rank {[r_['float32']['tokens_sharded'] for r_ in rows]} against "
                 f"{f32['tokens_one_device']}; f32 max |dlogit| {f32['max_abs_dlogit']} of "
                 f"{f32['max_abs_logit']}; bf16 error against f32: sharded {b16['sharded_err_vs_f32']}, "
                 f"one device {b16['one_device_err_vs_f32']}")
    log({"phase": "lm_mesh", "seconds": time.perf_counter() - t_phase, "launches": launches})
    return launches



def card_vs_cpu(torch, phase, cfg, gpu, cpu, data, opt_cfg, **logged) -> None:
    """One trainer step of ``cfg`` on ``cuda:0`` (model ``gpu``) and on the
    CPU (``cpu``, the same weights) on ``data``, held to phase 50 (5)'s
    gates.  After one step mu = 0.1·scale·g: the moments compare the
    gradients.  An entry whose gradient differs between the two by over a
    tenth of itself is rounding noise, and its step-1 update
    lr·g/(|g| + eps) has a sign set by rounding (AdamW's first step is
    sign(g) for |g| >> eps): there the two may differ by up to the largest
    step-1 move, 2·lr·(1 + wd·max|p|); everywhere else within 1e-5 of
    max|p|.  Loss and grad_norm within 1e-4 relative, the moments within
    1e-4 of each leaf's max."""
    from repro_torch.train import build_train_step, init_opt_state

    rel = lambda a, b: abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)
    dev = torch.device("cuda", 0)
    seq = data["tokens"].shape[1]
    res, opts = {}, {}
    for name, mdl, d in (("cuda", gpu, dev), ("cpu", cpu, torch.device("cpu"))):
        opts[name] = init_opt_state(mdl)
        t0 = time.perf_counter()
        m = build_train_step(cfg, opt_cfg, batch=1, seq=seq, device=d).step_fn(
            mdl, opts[name], {k: v.to(d) for k, v in data.items()})
        res[name] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                     "seconds": time.perf_counter() - t0}
    lr1 = opt_cfg.lr / opt_cfg.warmup_steps
    p_max = max(float(p_.detach().abs().max()) for p_ in cpu.parameters())
    per_leaf, worst = {}, {"mu_rel": 0.0, "p_conditioned": 0.0, "p_rest": 0.0, "rest_entries": 0}
    for (pname, pc), pg in zip(cpu.named_parameters(), gpu.parameters()):
        mu_c, mu_g = opts["cpu"]["mu"][pname], opts["cuda"]["mu"][pname].cpu()
        d_mu = (mu_g - mu_c).abs()
        dp = (pg.detach().cpu() - pc.detach()).abs()
        well = d_mu <= 0.1 * mu_c.abs()
        row = {"mu_rel": float(d_mu.max()) / max(float(mu_c.abs().max()), 1e-30),
               "p_conditioned": float(dp[well].max()) if bool(well.any()) else 0.0,
               "p_rest": float(dp[~well].max()) if not bool(well.all()) else 0.0,
               "rest_entries": int((~well).sum())}
        per_leaf[pname] = row
        worst = {k: worst[k] + row[k] if k == "rest_entries" else max(worst[k], row[k]) for k in worst}
        del mu_g, d_mu, dp, well
    r_loss, r_gn = (rel(res["cuda"][k], res["cpu"][k]) for k in ("loss", "grad_norm"))
    log({"phase": phase, "arch": cfg.name, "layers": cfg.n_layers, "batch": 1, "seq": seq, **logged,
         **res, "loss_rel_diff": r_loss, "grad_norm_rel_diff": r_gn, "max_abs_p": p_max,
         "lr_step1": lr1, "worst": worst, "per_leaf": per_leaf})
    gate(phase, r_loss <= 1e-4 and r_gn <= 1e-4 and worst["mu_rel"] <= 1e-4
         and worst["p_conditioned"] <= 1e-5 * p_max
         and worst["p_rest"] <= 2 * lr1 * (1 + opt_cfg.weight_decay * p_max),
         f"card {res['cuda']}, CPU {res['cpu']}, worst {worst}")


def lm_phases(torch) -> dict:
    """Phase 50: stablelm-1.6b at full width on ``cuda:0`` (module
    docstring).  Returns the kernel launch counts of the phase."""
    import contextlib
    import io

    from repro_torch import kernels
    from repro_torch.launch import train as train_cli
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import model_api
    from repro_torch.train import (
        AdamWConfig,
        DataConfig,
        batch_at,
        build_serve_step,
        build_train_step,
        init_opt_state,
    )

    dev = torch.device("cuda", 0)
    gib = 2.0 ** 30
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    resident = torch.cuda.memory_allocated(dev)

    def rel(a, b) -> float:
        return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)

    def peak_reset():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    # ---------------------- 50.1 the trainer's CLI, then its model on the card
    argv = ["--arch", "stablelm_1_6b", "--preset", "full", "--steps", "2", "--log-every", "1"]
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        train_cli.main(argv)
    cli_s = time.perf_counter() - t0
    lines = out.getvalue().splitlines()
    steps = [ln.split() for ln in lines if ln.startswith("step ")]
    log({"phase": "lm_cli", "argv": argv, "lines": lines, "seconds": cli_s})
    gate("lm_cli", lines[0] == "arch=stablelm-1.6b params=1644.2M preset=full" and lines[-1] == "done"
         and len(steps) == 2 and all(math.isfinite(float(s[3])) and math.isfinite(float(s[5]))
                                     for s in steps), f"printed {lines}")
    peak_reset()

    cfg = train_cli.preset_config("stablelm_1_6b", "full").with_(dtype=torch.float32)
    api = model_api(cfg)
    t0 = time.perf_counter()
    model = api.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    opt = init_opt_state(model)
    torch.cuda.synchronize()
    elements = sum(p.numel() for p in model.parameters())
    # param_count() leaves out the norms and the padded vocab rows
    want = (cfg.param_count() + 2 * (cfg.vocab_padded - cfg.vocab) * cfg.d_model
            + (2 * cfg.n_layers + 1) * cfg.d_model)
    log({"phase": "lm_build", "arch": cfg.name, "dtype": "float32", "param_elements": elements,
         "param_count": cfg.param_count(), "norm_and_pad_elements": elements - cfg.param_count(),
         "layers": len(model.layers), "build_s": time.perf_counter() - t0,
         "resident_before_gib": resident / gib,
         "params_and_state_gib": torch.cuda.memory_allocated(dev) / gib - resident / gib})
    gate("lm_build", cfg.param_count() == 1_644_167_168 and elements == want,
         f"{elements} elements, want {want}")

    # ------------------------------------- 50.2 three steps at batch 8 x seq 256
    batch, seq, n_steps = 8, 256, 3
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=n_steps)  # the trainer's
    step_fn = build_train_step(cfg, opt_cfg, batch=batch, seq=seq, device=dev).step_fn
    dcfg = DataConfig(vocab=cfg.vocab, batch=batch, seq=seq)
    rows = []
    for step in range(n_steps):
        data = batch_at(dcfg, step, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step_fn(model, opt, data)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        rows.append({"step": step + 1, "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                     "lr": m["lr"], "ms": ms, "tokens_per_s": batch * seq / ms * 1e3})
        log({"phase": "lm_train_step", "batch": batch, "seq": seq, **rows[-1]})
    peak = torch.cuda.max_memory_allocated(dev)
    log({"phase": "lm_train", "batch": batch, "seq": seq, "steps": rows,
         "ms_per_step_after_first": statistics.mean(r_["ms"] for r_ in rows[1:]),
         "tokens_per_s_after_first": statistics.mean(r_["tokens_per_s"] for r_ in rows[1:]),
         "max_memory_allocated_gib": peak / gib})
    gate("lm_train", all(math.isfinite(r_[k]) for r_ in rows for k in ("loss", "grad_norm", "lr"))
         and int(opt["step"]) == n_steps, f"steps {rows}")

    # ------------------- 50.3 batch 1 x seq 4096: plain against the two levers
    seq_long = 4096
    data = batch_at(DataConfig(vocab=cfg.vocab, batch=1, seq=seq_long), 0, device=dev)
    long_rows = {}
    for name, c in (("plain", cfg), ("chunked", cfg.with_(attn_chunk=512, loss_chunk=512))):
        # lr 0 (no weight decay either): both steps start from the same parameters
        fn = build_train_step(c, AdamWConfig(lr=0.0, weight_decay=0.0), batch=1, seq=seq_long,
                              device=dev).step_fn
        peak_reset()
        t0 = time.perf_counter()
        m = fn(model, opt, data)
        torch.cuda.synchronize()
        long_rows[name] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                           "ms": (time.perf_counter() - t0) * 1e3,
                           "max_memory_allocated_gib": torch.cuda.max_memory_allocated(dev) / gib}
    r_loss = rel(long_rows["chunked"]["loss"], long_rows["plain"]["loss"])
    r_gn = rel(long_rows["chunked"]["grad_norm"], long_rows["plain"]["grad_norm"])
    log({"phase": "lm_train_4k", "batch": 1, "seq": seq_long, **long_rows,
         "loss_rel_diff": r_loss, "grad_norm_rel_diff": r_gn})
    gate("lm_train_4k", all(math.isfinite(v["loss"]) and math.isfinite(v["grad_norm"])
                            for v in long_rows.values()) and r_loss <= 1e-4 and r_gn <= 1e-4,
         f"plain against chunked: {long_rows}")

    # ----------------------------- 50.4 f32 decode against one forward (16 tokens)
    del opt, fn, step_fn
    peak_reset()
    gen = torch.Generator(device=dev).manual_seed(1)

    def n002(mdl):
        """Every weight of two dims or more from N(0, 0.02), norms kept: the
        initialiser's rule makes wq/wk/wv N(0, n_heads^-1/2) and wo
        N(0, d_head^-1/2), so attention saturates and float32 rounding
        grows from layer to layer (``init_rule_rel_err``)."""
        with torch.no_grad():
            for p_ in mdl.parameters():
                if p_.dim() >= 2:
                    p_.normal_(0.0, 0.02, generator=gen)

    n_tok, slots = 16, 4096
    toks = torch.randint(0, cfg.vocab, (1, n_tok), generator=gen, device=dev, dtype=torch.int32)
    serve, info = build_serve_step(cfg, 1, slots, device=dev)

    def decode_errs(mdl):
        with torch.no_grad():
            full = T.logits_from_hidden(cfg, mdl, T.forward(cfg, mdl, toks))
        cache = info["init_cache"]()
        errs = []
        for i in range(n_tok):
            pos = torch.full((1,), i, dtype=torch.int32, device=dev)
            logits, cache = serve(mdl, cache, {"token": toks[:, i], "pos": pos})
            errs.append(float((logits - full[:, i]).abs().max() / full[:, i].abs().max()))
        return errs

    with torch.no_grad():  # the initialiser's embedding is all ones
        model.emb.normal_(0.0, 0.02, generator=gen)
    rule_errs = decode_errs(model)
    n002(model)
    errs = decode_errs(model)
    log({"phase": "lm_decode_f32", "tokens": n_tok, "cache_slots": slots, "weights": "N(0, 0.02)",
         "max_rel_err": max(errs), "rel_err": errs, "init_rule_rel_err": rule_errs,
         "max_memory_allocated_gib": torch.cuda.max_memory_allocated(dev) / gib})
    gate("lm_decode_f32", max(errs) <= 1e-3, f"decode against forward: {errs}")
    del model

    # ------------- 50.5 the card against the CPU: 2 layers of the full width
    peak_reset()
    cfg2 = cfg.with_(n_layers=2)
    gpu = api.init_params(cfg2, torch.Generator(device=dev).manual_seed(2), dev)
    n002(gpu)  # under the rule's weights wq/wk gradients are ~1e-8, rounding noise
    cpu = T.params_from_reference(T.params_to_reference(gpu), device="cpu")
    data = batch_at(DataConfig(vocab=cfg.vocab, batch=1, seq=64), 0)
    opt_cfg2 = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=n_steps)
    card_vs_cpu(torch, "lm_card_vs_cpu", cfg2, gpu, cpu, data, opt_cfg2, weights="N(0, 0.02)")
    del gpu, cpu

    # -------------------------- 50.6 bf16 decode, batch 1, a 32768-slot cache
    peak_reset()
    cfg16 = train_cli.preset_config("stablelm_1_6b", "full")  # the config's own bfloat16
    model = api.init_params(cfg16, torch.Generator(device=dev).manual_seed(3), dev)
    n002(model)
    slots, n_warm, n_timed = 32768, 2, 16
    serve, info = build_serve_step(cfg16, 1, slots, device=dev)
    cache = info["init_cache"]()
    toks = torch.randint(0, cfg.vocab, (n_warm + n_timed,), generator=gen, device=dev, dtype=torch.int32)

    def decode(i):
        return serve(model, cache, {"token": toks[i:i + 1],
                                    "pos": torch.full((1,), i, dtype=torch.int32, device=dev)})[0]

    for i in range(n_warm):
        decode(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_warm, n_warm + n_timed):
        logits = decode(i)
    torch.cuda.synchronize()
    ms_tok = (time.perf_counter() - t0) * 1e3 / n_timed
    kv_gib = sum(v.numel() * v.element_size() for v in cache.values()) / gib
    log({"phase": "lm_decode_bf16", "cache_slots": slots, "batch": 1, "ms_per_token": ms_tok,
         "tokens_timed": n_timed, "kv_cache_gib": kv_gib,
         "weights_gib": sum(p.numel() * p.element_size() for p in model.parameters()) / gib,
         "max_memory_allocated_gib": torch.cuda.max_memory_allocated(dev) / gib,
         "logits_finite": bool(torch.isfinite(logits).all())})
    gate("lm_decode_bf16", bool(torch.isfinite(logits).all()), "non-finite logits")
    del model, cache, logits
    torch.cuda.empty_cache()
    launches = kernels.launch_counts()
    log({"phase": "lm", "seconds": time.perf_counter() - t_phase, "launches": launches})
    return launches


def ssm_phases(torch) -> dict:
    """Phase 51: mamba2-780m and zamba2-1.2b at full width on ``cuda:0``
    (module docstring).  Returns the kernel launch counts of the phase."""
    import contextlib
    import io

    from repro_torch import kernels
    from repro_torch.launch import train as train_cli
    from repro_torch.models import ssm as S
    from repro_torch.models.registry import model_api
    from repro_torch.train import (
        AdamWConfig,
        DataConfig,
        batch_at,
        build_serve_step,
        build_train_step,
        init_opt_state,
    )

    dev = torch.device("cuda", 0)
    gib = 2.0 ** 30
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    resident = torch.cuda.memory_allocated(dev)
    gen = torch.Generator(device=dev).manual_seed(11)

    def peak_reset():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    def shared_n002(mdl):
        """The hybrid's shared block: every weight of two dims or more from
        N(0, 0.02), norms kept (the initialiser's rule makes wq/wk/wv
        N(0, n_heads^-1/2) and saturates attention, as in phase 50)."""
        if mdl.shared is not None:
            with torch.no_grad():
                for p_ in mdl.shared.parameters():
                    if p_.dim() >= 2:
                        p_.normal_(0.0, 0.02, generator=gen)

    want = {"mamba2_780m": ("mamba2-780m", "779.9M", 780_382_464),
            "zamba2_1_2b": ("zamba2-1.2b", "1104.7M", 1_104_937_856)}
    dtypes = {"mamba2_780m": ("bfloat16", {"conv": "bfloat16", "ssm": "float32"}),
              "zamba2_1_2b": ("float32", {"conv": "float32", "ssm": "float32", "k": "float32",
                                          "v": "float32"})}
    name_of = lambda d: str(d).removeprefix("torch.")
    for arch, (label, shown, n_elements) in want.items():
        # ------------------------------------------------------- 51.1 the CLI
        argv = ["--arch", arch, "--preset", "full", "--steps", "2", "--log-every", "1"]
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            train_cli.main(argv)
        lines = out.getvalue().splitlines()
        steps = [ln.split() for ln in lines if ln.startswith("step ")]
        log({"phase": "ssm_cli", "argv": argv, "lines": lines, "seconds": time.perf_counter() - t0})
        gate("ssm_cli", lines[0] == f"arch={label} params={shown} preset=full" and lines[-1] == "done"
             and len(steps) == 2 and all(math.isfinite(float(s_[3])) and math.isfinite(float(s_[5]))
                                         for s_ in steps), f"printed {lines}")
        peak_reset()

        # ------------------------------------------------------ 51.2 the build
        cfg = train_cli.preset_config(arch, "full").with_(dtype=torch.float32)
        api = model_api(cfg)
        t0 = time.perf_counter()
        model = api.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        opt = init_opt_state(model)
        torch.cuda.synchronize()
        elements = sum(p_.numel() for p_ in model.parameters())
        # param_count() leaves out the padded vocab rows, conv_b, dt_bias and
        # the norms (ln, final_ln; the hybrid's ln1, ln2)
        gap = {"vocab_padded": (cfg.vocab_padded - cfg.vocab) * cfg.d_model,
               "conv_b": cfg.n_layers * (cfg.d_inner + 2 * cfg.d_state),
               "dt_bias": cfg.n_layers * cfg.n_ssm_heads,
               "ln": cfg.n_layers * cfg.d_model, "final_ln": cfg.d_model,
               "ln1_ln2": 2 * cfg.d_model if cfg.family == "hybrid" else 0}
        log({"phase": "ssm_build", "arch": cfg.name, "dtype": "float32", "param_elements": elements,
             "param_count": cfg.param_count(), "gap": gap, "layers": len(model.layers),
             "shared_block": model.shared is not None, "build_s": time.perf_counter() - t0,
             "resident_before_gib": resident / gib,
             "params_and_state_gib": (torch.cuda.memory_allocated(dev) - resident) / gib})
        gate("ssm_build", elements == n_elements == cfg.param_count() + sum(gap.values()),
             f"{elements} elements, want {n_elements} = {cfg.param_count()} + {gap}")

        # ------------------------------------- 51.3 two steps at batch 1 x seq 4096
        seq_long, n_steps = 4096, 2
        opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=n_steps)  # the trainer's
        step_fn = build_train_step(cfg, opt_cfg, batch=1, seq=seq_long, device=dev).step_fn
        dcfg = DataConfig(vocab=cfg.vocab, batch=1, seq=seq_long)
        peak_reset()
        rows = []
        for step in range(n_steps):
            data = batch_at(dcfg, step, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = step_fn(model, opt, data)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            rows.append({"step": step + 1, "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                         "lr": m["lr"], "ms": ms, "tokens_per_s": seq_long / ms * 1e3})
        log({"phase": "ssm_train_4k", "arch": cfg.name, "batch": 1, "seq": seq_long,
             "ssd_chunks_a_layer": seq_long // 128, "steps": rows,
             "max_memory_allocated_gib": torch.cuda.max_memory_allocated(dev) / gib})
        gate("ssm_train_4k", all(math.isfinite(r_[k]) for r_ in rows for k in ("loss", "grad_norm", "lr"))
             and int(opt["step"]) == n_steps, f"steps {rows}")
        del opt, step_fn, data
        peak_reset()

        # ----------------------------- 51.4 f32 decode against one forward (16 tokens)
        n_tok, slots = 16, 4096
        toks = torch.randint(0, cfg.vocab, (1, n_tok), generator=gen, device=dev, dtype=torch.int32)
        serve, info = build_serve_step(cfg, 1, slots, device=dev)

        def decode_errs(mdl):
            with torch.no_grad():
                full = S.logits_from_hidden(cfg, mdl, S.forward(cfg, mdl, toks))
            cache = info["init_cache"]()
            errs = []
            for i in range(n_tok):
                pos = torch.full((1,), i, dtype=torch.int32, device=dev)
                logits, cache = serve(mdl, cache, {"token": toks[:, i], "pos": pos})
                errs.append(float((logits - full[:, i]).abs().max() / full[:, i].abs().max()))
            return errs

        rule_errs = decode_errs(model) if model.shared is not None else None
        shared_n002(model)
        errs = decode_errs(model)
        log({"phase": "ssm_decode_f32", "arch": cfg.name, "tokens": n_tok, "cache_slots": slots,
             "weights": "the initialiser's" + (", shared block N(0, 0.02)" if model.shared is not None else ""),
             "max_rel_err": max(errs), "rel_err": errs, "init_rule_rel_err": rule_errs,
             "max_memory_allocated_gib": torch.cuda.max_memory_allocated(dev) / gib})
        gate("ssm_decode_f32", max(errs) <= 1e-3, f"decode against forward: {errs}")
        del model

        # ------------- 51.5 the card against the CPU: 2 layers of the full width
        peak_reset()
        cfg2 = cfg.with_(n_layers=2)  # the hybrid: one shared application
        gpu = api.init_params(cfg2, torch.Generator(device=dev).manual_seed(2), dev)
        shared_n002(gpu)
        cpu = S.params_from_reference(S.params_to_reference(gpu), device="cpu")
        card_vs_cpu(torch, "ssm_card_vs_cpu", cfg2, gpu, cpu,
                    batch_at(DataConfig(vocab=cfg.vocab, batch=1, seq=128), 0),
                    AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=2),
                    weights="the initialiser's" + (", shared block N(0, 0.02)" if gpu.shared is not None else ""))
        del gpu, cpu

        # ------------------------------------ 51.6 bf16 decode at batch 1
        peak_reset()
        cfg16 = train_cli.preset_config(arch, "full")  # the config's own bfloat16
        model = api.init_params(cfg16, torch.Generator(device=dev).manual_seed(3), dev)
        shared_n002(model)
        slots, n_warm, n_timed = 32768, 2, 16  # decode_32k's length (the hybrid's K/V)
        serve, info = build_serve_step(cfg16, 1, slots, device=dev)
        cache = info["init_cache"]()
        before = {k: name_of(v.dtype) for k, v in cache.items()}
        toks = torch.randint(0, cfg.vocab, (n_warm + n_timed,), generator=gen, device=dev, dtype=torch.int32)

        def decode(i):
            return serve(model, cache, {"token": toks[i:i + 1],
                                        "pos": torch.full((1,), i, dtype=torch.int32, device=dev)})

        for i in range(n_warm):
            logits, cache = decode(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n_warm, n_warm + n_timed):
            logits, cache = decode(i)
        torch.cuda.synchronize()
        ms_tok = (time.perf_counter() - t0) * 1e3 / n_timed
        after = {k: name_of(v.dtype) for k, v in cache.items()}
        log({"phase": "ssm_decode_bf16", "arch": cfg16.name, "cache_slots": slots, "batch": 1,
             "ms_per_token": ms_tok, "tokens_timed": n_timed,
             "cache_gib": sum(v.numel() * v.element_size() for v in cache.values()) / gib,
             "cache_dtypes_before": before, "cache_dtypes_after": after,
             "logits_dtype": name_of(logits.dtype),
             "weights_gib": sum(p_.numel() * p_.element_size() for p_ in model.parameters()) / gib,
             "max_memory_allocated_gib": torch.cuda.max_memory_allocated(dev) / gib,
             "logits_finite": bool(torch.isfinite(logits).all())})
        want_before = {k: "float32" if k != "conv" else "bfloat16" for k in after}
        gate("ssm_decode_bf16", bool(torch.isfinite(logits).all()) and before == want_before
             and (name_of(logits.dtype), after) == dtypes[arch],
             f"logits {name_of(logits.dtype)}, cache {before} -> {after}, want {dtypes[arch]}")
        del model, cache, logits
        torch.cuda.empty_cache()
    launches = kernels.launch_counts()
    log({"phase": "ssm", "seconds": time.perf_counter() - t_phase, "launches": launches})
    return launches


def encdec_vlm_phases(torch) -> dict:
    """Phase 52: whisper-medium and paligemma-3b at full width on
    ``cuda:0`` (module docstring).  Returns the kernel launch counts of the
    phase."""
    import contextlib
    import io

    from repro_torch import kernels
    from repro_torch.launch import train as train_cli
    from repro_torch.models import encdec as E
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import model_api
    from repro_torch.train import (
        AdamWConfig,
        DataConfig,
        batch_at,
        build_serve_step,
        build_train_step,
        init_opt_state,
    )

    dev = torch.device("cuda", 0)
    gib = 2.0 ** 30
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    resident = torch.cuda.memory_allocated(dev)
    gen = torch.Generator(device=dev).manual_seed(21)

    def rel(a, b) -> float:
        return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)

    def peak_reset():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    def n002(mdl):
        """Every weight of two dims or more from N(0, 0.02), norms kept: the
        initialiser's rule makes wq/wk/wv N(0, n_heads^-1/2) and saturates
        attention, as in phase 50."""
        with torch.no_grad():
            for p_ in mdl.parameters():
                if p_.dim() >= 2:
                    p_.normal_(0.0, 0.02, generator=gen)

    def extra_of(specs):
        return {k: v for k, v in specs.items() if k not in ("tokens", "labels")}

    # label, param_count() as the CLI prints it, elements, and the elements
    # param_count() leaves out (the padded vocab rows, the norms; whisper's
    # learned encoder positions)
    want = {"whisper_medium": ("whisper-medium", "757.8M", 759_519_232),
            "paligemma_3b": ("paligemma-3b", "2508.6M", 2_508_793_856)}
    name_of = lambda d: str(d).removeprefix("torch.")
    for arch, (label, shown, n_elements) in want.items():
        encdec = arch == "whisper_medium"
        mod = E if encdec else T
        # ------------------------------------------------------- 52.1 the CLI
        argv = ["--arch", arch, "--preset", "full", "--steps", "2", "--log-every", "1"]
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            train_cli.main(argv)
        lines = out.getvalue().splitlines()
        steps = [ln.split() for ln in lines if ln.startswith("step ")]
        # under the reference's initialiser (wq/wk/wv N(0, n_heads^-1/2))
        # attention saturates and the gradients grow layer by layer: at
        # whisper's 24 + 24 layers their float32 sum of squares overflows,
        # in the reference as here (ROADMAP §3), so the clip scale is 0 and
        # the step only decays the weights; a NaN would be a fault
        overflow = [s_[1] for s_ in steps if float(s_[5]) == math.inf]
        log({"phase": "encdec_vlm_cli", "argv": argv, "lines": lines, "gnorm_overflow_steps": overflow,
             "seconds": time.perf_counter() - t0})
        gate("encdec_vlm_cli", lines[0] == f"arch={label} params={shown} preset=full" and lines[-1] == "done"
             and len(steps) == 2 and all(math.isfinite(float(s_[3])) and not math.isnan(float(s_[5]))
                                         for s_ in steps), f"printed {lines}")
        peak_reset()

        # ------------------------------------------------------ 52.2 the build
        cfg = train_cli.preset_config(arch, "full").with_(dtype=torch.float32)
        api = model_api(cfg)
        t0 = time.perf_counter()
        model = api.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        opt = init_opt_state(model)
        torch.cuda.synchronize()
        elements = sum(p_.numel() for p_ in model.parameters())
        gap = {"vocab_padded": (cfg.vocab_padded - cfg.vocab) * cfg.d_model,
               "norms": ((2 * cfg.n_enc_layers + 3 * cfg.n_layers + 2) if encdec
                         else (2 * cfg.n_layers + 1)) * cfg.d_model,
               "enc_pos": cfg.enc_ctx * cfg.d_model if encdec else 0}
        log({"phase": "encdec_vlm_build", "arch": cfg.name, "dtype": "float32", "param_elements": elements,
             "param_count": cfg.param_count(), "gap": gap, "build_s": time.perf_counter() - t0,
             "resident_before_gib": resident / gib,
             "params_and_state_gib": (torch.cuda.memory_allocated(dev) - resident) / gib})
        gate("encdec_vlm_build", elements == n_elements == cfg.param_count() + sum(gap.values()),
             f"{elements} elements, want {n_elements} = {cfg.param_count()} + {gap}")

        # ------------------------------------- 52.3 two steps at batch 1 x seq 4096
        # on N(0, 0.02) weights: under the initialiser's the gradient norm
        # overflows (52.1)
        n002(model)
        seq_long, n_steps = 4096, 2
        opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=n_steps)  # the trainer's
        bundle = build_train_step(cfg, opt_cfg, batch=1, seq=seq_long, device=dev)
        extra = extra_of(bundle.input_specs)
        dcfg = DataConfig(vocab=cfg.vocab, batch=1, seq=seq_long)
        positions = seq_long + (0 if encdec else cfg.n_patches)
        peak_reset()
        rows = []
        for step in range(n_steps):
            data = batch_at(dcfg, step, extra=extra, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = bundle.step_fn(model, opt, data)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            rows.append({"step": step + 1, "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                         "lr": m["lr"], "ms": ms, "tokens_per_s": seq_long / ms * 1e3})
        log({"phase": "encdec_vlm_train_4k", "arch": cfg.name, "batch": 1, "seq": seq_long,
             "weights": "N(0, 0.02)", "positions": positions, "extra": {k: list(v[0]) for k, v in extra.items()}, "steps": rows,
             "max_memory_allocated_gib": torch.cuda.max_memory_allocated(dev) / gib})
        gate("encdec_vlm_train_4k", all(math.isfinite(r_[k]) for r_ in rows for k in ("loss", "grad_norm", "lr"))
             and int(opt["step"]) == n_steps, f"steps {rows}")
        if not encdec:
            # the prefix:<n> chunked path on the card: 17 chunks of 256 over
            # the 4352 positions, the loss over 8 chunks of 512 text tokens;
            # lr 0 (no weight decay either): both steps on the same parameters
            long_rows = {}
            for name, c in (("plain", cfg), ("chunked", cfg.with_(attn_chunk=256, loss_chunk=512))):
                fn = build_train_step(c, AdamWConfig(lr=0.0, weight_decay=0.0), batch=1, seq=seq_long,
                                      device=dev).step_fn
                peak_reset()
                t0 = time.perf_counter()
                m = fn(model, opt, data)
                torch.cuda.synchronize()
                long_rows[name] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                                   "ms": (time.perf_counter() - t0) * 1e3,
                                   "max_memory_allocated_gib": torch.cuda.max_memory_allocated(dev) / gib}
                del fn
            r_loss = rel(long_rows["chunked"]["loss"], long_rows["plain"]["loss"])
            r_gn = rel(long_rows["chunked"]["grad_norm"], long_rows["plain"]["grad_norm"])
            log({"phase": "encdec_vlm_train_4k_chunked", "arch": cfg.name, "positions": positions,
                 **long_rows, "loss_rel_diff": r_loss, "grad_norm_rel_diff": r_gn})
            gate("encdec_vlm_train_4k_chunked",
                 all(math.isfinite(v["loss"]) and math.isfinite(v["grad_norm"]) for v in long_rows.values())
                 and r_loss <= 1e-4 and r_gn <= 1e-4, f"plain against chunked: {long_rows}")
        frames = data.get("frames")
        del opt, bundle, m
        peak_reset()

        # ----------------------------- 52.4 f32 decode against one forward (16 tokens)
        n_tok, slots = 16, 4096
        toks = torch.randint(0, cfg.vocab, (1, n_tok), generator=gen, device=dev, dtype=torch.int32)
        serve, info = build_serve_step(cfg, 1, slots, device=dev)

        def decode_errs(mdl):
            with torch.no_grad():
                if encdec:
                    x = E.decode_train(cfg, mdl, toks, E.encode(cfg, mdl, frames))
                else:
                    x = T.forward(cfg, mdl, toks)
                full = T.logits_from_hidden(cfg, mdl, x)
            cache = info["prefill"](mdl, frames) if encdec else info["init_cache"]()
            errs = []
            for i in range(n_tok):
                pos = torch.full((1,), i, dtype=torch.int32, device=dev)
                logits, cache = serve(mdl, cache, {"token": toks[:, i], "pos": pos})
                errs.append(float((logits - full[:, i]).abs().max() / full[:, i].abs().max()))
            return errs

        errs = decode_errs(model)
        del model
        model = api.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        rule_errs = decode_errs(model)
        log({"phase": "encdec_vlm_decode_f32", "arch": cfg.name, "tokens": n_tok, "cache_slots": slots,
             "cross_cache": "prefill_cross_cache of the step's frames" if encdec else None,
             "weights": "N(0, 0.02), after the two steps", "max_rel_err": max(errs), "rel_err": errs,
             "init_rule_rel_err": rule_errs,
             "max_memory_allocated_gib": torch.cuda.max_memory_allocated(dev) / gib})
        gate("encdec_vlm_decode_f32", max(errs) <= 1e-3, f"decode against forward: {errs}")
        del model

        # ------------- 52.5 the card against the CPU: 2 layers of the full width
        peak_reset()
        cfg2 = cfg.with_(n_layers=2, n_enc_layers=2) if encdec else cfg.with_(n_layers=2)
        gpu = api.init_params(cfg2, torch.Generator(device=dev).manual_seed(2), dev)
        n002(gpu)
        cpu = mod.params_from_reference(mod.params_to_reference(gpu), device="cpu")
        seq2 = 64
        data2 = batch_at(DataConfig(vocab=cfg.vocab, batch=1, seq=seq2), 0,
                         extra=extra_of(api.train_input_specs(cfg2, 1, seq2)))
        card_vs_cpu(torch, "encdec_vlm_card_vs_cpu", cfg2, gpu, cpu, data2,
                    AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=2), weights="N(0, 0.02)",
                    extra={k: list(v.shape) for k, v in data2.items() if k not in ("tokens", "labels")})
        del gpu, cpu, data2

        # ------------------------------------ 52.6 bf16 decode at batch 1
        peak_reset()
        cfg16 = train_cli.preset_config(arch, "full")  # the config's own bfloat16
        model = api.init_params(cfg16, torch.Generator(device=dev).manual_seed(3), dev)
        n002(model)
        slots, n_warm, n_timed = 32768, 2, 16  # decode_32k's length
        serve, info = build_serve_step(cfg16, 1, slots, device=dev)
        cache = info["prefill"](model, frames.to(cfg16.dtype)) if encdec else info["init_cache"]()
        before = {k: name_of(v.dtype) for k, v in cache.items()}
        toks = torch.randint(0, cfg.vocab, (n_warm + n_timed,), generator=gen, device=dev, dtype=torch.int32)

        def decode(i):
            return serve(model, cache, {"token": toks[i:i + 1],
                                        "pos": torch.full((1,), i, dtype=torch.int32, device=dev)})

        for i in range(n_warm):
            logits, cache = decode(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n_warm, n_warm + n_timed):
            logits, cache = decode(i)
        torch.cuda.synchronize()
        ms_tok = (time.perf_counter() - t0) * 1e3 / n_timed
        after = {k: name_of(v.dtype) for k, v in cache.items()}
        log({"phase": "encdec_vlm_decode_bf16", "arch": cfg16.name, "cache_slots": slots, "batch": 1,
             "ms_per_token": ms_tok, "tokens_timed": n_timed,
             "cache_gib": sum(v.numel() * v.element_size() for v in cache.values()) / gib,
             "cache_dtypes_before": before, "cache_dtypes_after": after,
             "logits_dtype": name_of(logits.dtype),
             "weights_gib": sum(p_.numel() * p_.element_size() for p_ in model.parameters()) / gib,
             "max_memory_allocated_gib": torch.cuda.max_memory_allocated(dev) / gib,
             "logits_finite": bool(torch.isfinite(logits).all())})
        # the reference's abstract_cache: every leaf in the config's dtype;
        # jnp promotion keeps the logits bfloat16
        want_dtypes = {k: "bfloat16" for k in info["cache_shapes"]}
        gate("encdec_vlm_decode_bf16", bool(torch.isfinite(logits).all()) and before == after == want_dtypes
             and name_of(logits.dtype) == "bfloat16",
             f"logits {name_of(logits.dtype)}, cache {before} -> {after}, want {want_dtypes}")
        del model, cache, logits, frames, data
        torch.cuda.empty_cache()
    launches = kernels.launch_counts()
    log({"phase": "encdec_vlm", "seconds": time.perf_counter() - t_phase, "launches": launches})
    return launches


def moe_phases(torch) -> dict:
    """Phase 53: olmoe-1b-7b and phi3.5-moe-42b at full width on ``cuda:0``
    (module docstring).  Returns the kernel launch counts of the phase."""
    import contextlib
    import io

    from repro_torch import kernels
    from repro_torch.launch import train as train_cli
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import model_api
    from repro_torch.train import (
        AdamWConfig,
        DataConfig,
        batch_at,
        build_serve_step,
        build_train_step,
        init_opt_state,
    )

    dev = torch.device("cuda", 0)
    gib = 2.0 ** 30
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    resident = torch.cuda.memory_allocated(dev)
    gen = torch.Generator(device=dev).manual_seed(23)
    name_of = lambda d: str(d).removeprefix("torch.")

    def rel(a, b) -> float:
        return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)

    def peak_reset():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    def n002(mdl):
        """Every weight of two dims or more from N(0, 0.02), norms kept: the
        initialiser's rule saturates attention (as in phase 50) and makes
        the embedding all ones, so that every token routes alike."""
        with torch.no_grad():
            for p_ in mdl.parameters():
                if p_.dim() >= 2:
                    p_.normal_(0.0, 0.02, generator=gen)

    def routing(c, mdl, tokens):
        """The summed aux loss and the dropped (token, expert) picks per
        layer of one no-grad forward over ``tokens``."""
        with torch.no_grad(), M.record_dropped() as drops:
            _, aux = T.forward_with_aux(c, mdl, tokens)
        return float(aux), [int(n) for n in drops]

    # arch: (training depth in f32, bf16 decode depth, the build's elements:
    # param_count() at that depth plus the padded vocab rows of emb and
    # lm_head and the norms); the CPU check's depth (phi3.5: loss and
    # gradient norm only, its f32 CPU state would be ~25 GB)
    plan = {"olmoe_1b_7b": (8, 16, 3_563_096_064, 2), "phi35_moe_42b": (2, 16, 2_864_861_184, 1)}
    for arch, (train_layers, decode_layers, n_elements, cpu_layers) in plan.items():
        # -------------------------------------- 53.1 the CLI at --preset tiny
        tiny = train_cli.preset_config(arch, "tiny")
        argv = ["--arch", arch, "--preset", "tiny", "--steps", "2", "--log-every", "1"]
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            train_cli.main(argv)
        lines = out.getvalue().splitlines()
        steps = [ln.split() for ln in lines if ln.startswith("step ")]
        log({"phase": "moe_cli", "argv": argv, "experts": tiny.n_experts, "top_k": tiny.top_k, "lines": lines,
             "seconds": time.perf_counter() - t0})
        gate("moe_cli", lines[0] == f"arch={tiny.name} params={tiny.param_count() / 1e6:.1f}M preset=tiny"
             and lines[-1] == "done" and len(steps) == 2
             and all(math.isfinite(float(s_[3])) and math.isfinite(float(s_[5])) for s_ in steps),
             f"printed {lines}")
        peak_reset()

        # ------------------------------ 53.2 the build at the training depth
        cfg = train_cli.preset_config(arch, "full").with_(dtype=torch.float32, n_layers=train_layers)
        api = model_api(cfg)
        t0 = time.perf_counter()
        model = api.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        opt = init_opt_state(model)
        torch.cuda.synchronize()
        elements = sum(p_.numel() for p_ in model.parameters())
        gap = {"vocab_padded": 2 * (cfg.vocab_padded - cfg.vocab) * cfg.d_model,
               "norms": (2 * cfg.n_layers + 1) * cfg.d_model}
        log({"phase": "moe_build", "arch": cfg.name, "dtype": "float32", "layers": cfg.n_layers,
             "of_layers": train_cli.preset_config(arch, "full").n_layers, "experts": cfg.n_experts,
             "top_k": cfg.top_k, "param_elements": elements, "param_count": cfg.param_count(),
             "active_param_count": cfg.active_param_count(), "gap": gap,
             "build_s": time.perf_counter() - t0, "resident_before_gib": resident / gib,
             "params_and_state_gib": (torch.cuda.memory_allocated(dev) - resident) / gib})
        gate("moe_build", elements == n_elements == cfg.param_count() + sum(gap.values()),
             f"{elements} elements, want {n_elements} = {cfg.param_count()} + {gap}")

        # ------------------ 53.3 two steps at batch 1 x seq 4096, N(0, 0.02)
        n002(model)
        seq_long, n_steps = 4096, 2
        opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=n_steps)  # the trainer's
        step_fn = build_train_step(cfg, opt_cfg, batch=1, seq=seq_long, device=dev).step_fn
        dcfg = DataConfig(vocab=cfg.vocab, batch=1, seq=seq_long)
        peak_reset()
        rows = []
        for step in range(n_steps):
            data = batch_at(dcfg, step, device=dev)
            aux, dropped = routing(cfg, model, data["tokens"])  # at the step's parameters
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = step_fn(model, opt, data)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            rows.append({"step": step + 1, "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                         "lr": m["lr"], "aux": aux, "dropped_per_layer": dropped,
                         "picks_per_layer": seq_long * cfg.top_k, "ms": ms,
                         "tokens_per_s": seq_long / ms * 1e3})
        log({"phase": "moe_train_4k", "arch": cfg.name, "layers": cfg.n_layers, "batch": 1, "seq": seq_long,
             "weights": "N(0, 0.02)", "capacity": M.capacity(cfg, seq_long), "steps": rows,
             "max_memory_allocated_gib": torch.cuda.max_memory_allocated(dev) / gib})
        gate("moe_train_4k", all(math.isfinite(r_[k]) for r_ in rows for k in ("loss", "grad_norm", "lr", "aux"))
             and int(opt["step"]) == n_steps, f"steps {rows}")
        del opt, step_fn, m, data
        peak_reset()

        # ------------- 53.4 f32 decode against one forward (16 tokens), cf = E/k
        # capacity_factor E/k makes the capacity at least T: the forward over
        # 16 tokens drops nothing, as a one-token decode step never does.  At
        # the config's own factor (capacity 2) the forward drops picks and
        # the two differ by design (logged beside).
        n_tok, slots = 16, 4096
        nodrop = cfg.with_(capacity_factor=cfg.n_experts / cfg.top_k)
        toks = torch.randint(0, cfg.vocab, (1, n_tok), generator=gen, device=dev, dtype=torch.int32)
        serve, info = build_serve_step(nodrop, 1, slots, device=dev)
        with torch.no_grad(), M.record_dropped() as nodrop_dropped:
            full = T.logits_from_hidden(nodrop, model, T.forward(nodrop, model, toks))
        with torch.no_grad(), M.record_dropped() as own_dropped:
            own = T.logits_from_hidden(cfg, model, T.forward(cfg, model, toks))
        nodrop_dropped, own_dropped = ([int(n) for n in d_] for d_ in (nodrop_dropped, own_dropped))
        cache = info["init_cache"]()
        errs, own_errs = [], []
        for i in range(n_tok):
            pos = torch.full((1,), i, dtype=torch.int32, device=dev)
            with M.record_dropped() as drops:
                logits, cache = serve(model, cache, {"token": toks[:, i], "pos": pos})
            gate("moe_decode_f32", sum(int(n) for n in drops) == 0, f"a one-token step dropped {drops}")
            errs.append(float((logits - full[:, i]).abs().max() / full[:, i].abs().max()))
            own_errs.append(float((logits - own[:, i]).abs().max() / own[:, i].abs().max()))
        log({"phase": "moe_decode_f32", "arch": cfg.name, "layers": cfg.n_layers, "tokens": n_tok,
             "cache_slots": slots, "capacity_factor": nodrop.capacity_factor,
             "capacity": M.capacity(nodrop, n_tok), "forward_dropped_per_layer": nodrop_dropped,
             "weights": "N(0, 0.02), after the two steps", "max_rel_err": max(errs), "rel_err": errs,
             "own_factor": {"capacity_factor": cfg.capacity_factor, "capacity": M.capacity(cfg, n_tok),
                            "forward_dropped_per_layer": own_dropped, "max_rel_err": max(own_errs)},
             "max_memory_allocated_gib": torch.cuda.max_memory_allocated(dev) / gib})
        gate("moe_decode_f32", max(errs) <= 1e-3 and sum(nodrop_dropped) == 0, f"decode against forward: {errs}")
        del model, cache, full, own

        # ------------- 53.5 the card against the CPU at the full width
        peak_reset()
        cfg_c = cfg.with_(n_layers=cpu_layers)
        gpu = api.init_params(cfg_c, torch.Generator(device=dev).manual_seed(2), dev)
        n002(gpu)
        cpu = T.params_from_reference(T.params_to_reference(gpu), device="cpu")
        data_c = batch_at(DataConfig(vocab=cfg.vocab, batch=1, seq=64), 0)
        if arch == "olmoe_1b_7b":
            card_vs_cpu(torch, "moe_card_vs_cpu", cfg_c, gpu, cpu, data_c,
                        AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=2), weights="N(0, 0.02)",
                        capacity=M.capacity(cfg_c, 64))
        else:
            # loss and the gradients' norm (the trainer's: float32 sum of
            # squares) on each device, no optimizer state
            res = {}
            for name, mdl, d in (("cuda", gpu, dev), ("cpu", cpu, torch.device("cpu"))):
                t0 = time.perf_counter()
                loss = T.loss_fn(cfg_c)(mdl, {k: v.to(d) for k, v in data_c.items()})
                grads = torch.autograd.grad(loss, list(mdl.parameters()))
                gnorm = torch.sqrt(sum(g.float().square().sum() for g in grads))
                res[name] = {"loss": float(loss.detach()), "grad_norm": float(gnorm),
                             "seconds": time.perf_counter() - t0}
                del loss, grads
            r_loss, r_gn = (rel(res["cuda"][k], res["cpu"][k]) for k in ("loss", "grad_norm"))
            log({"phase": "moe_card_vs_cpu", "arch": cfg_c.name, "layers": cfg_c.n_layers, "batch": 1, "seq": 64,
                 "weights": "N(0, 0.02)", "capacity": M.capacity(cfg_c, 64), "checked": "loss and grad_norm",
                 **res, "loss_rel_diff": r_loss, "grad_norm_rel_diff": r_gn})
            gate("moe_card_vs_cpu", r_loss <= 1e-4 and r_gn <= 1e-4, f"card {res['cuda']}, CPU {res['cpu']}")
        del gpu, cpu, data_c

        # ------------------ 53.6 bf16 decode at batch 1, a 32768-slot cache
        peak_reset()
        cfg16 = train_cli.preset_config(arch, "full").with_(n_layers=decode_layers)  # its own bfloat16
        model = api.init_params(cfg16, torch.Generator(device=dev).manual_seed(3), dev)
        n002(model)
        slots, n_warm, n_timed = 32768, 2, 16  # decode_32k's length
        serve, info = build_serve_step(cfg16, 1, slots, device=dev)
        cache = info["init_cache"]()
        before = {k: name_of(v.dtype) for k, v in cache.items()}
        toks = torch.randint(0, cfg.vocab, (n_warm + n_timed + 2,), generator=gen, device=dev, dtype=torch.int32)

        def decode(i):
            return serve(model, cache, {"token": toks[i:i + 1],
                                        "pos": torch.full((1,), i, dtype=torch.int32, device=dev)})[0]

        for i in range(n_warm):
            decode(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n_warm, n_warm + n_timed):
            logits = decode(i)
        torch.cuda.synchronize()
        ms_tok = (time.perf_counter() - t0) * 1e3 / n_timed
        calls = iteration_calls(torch, lambda: decode(n_warm + n_timed))  # and one to warm up
        after = {k: name_of(v.dtype) for k, v in cache.items()}
        weight_dtypes = sorted({name_of(p_.dtype) for p_ in model.parameters()})
        expert_bytes = sum(layer[w].numel() * layer[w].element_size()
                           for layer in model.layers for w in ("we_g", "we_u", "we_d"))
        log({"phase": "moe_decode_bf16", "arch": cfg16.name, "layers": cfg16.n_layers,
             "of_layers": train_cli.preset_config(arch, "full").n_layers, "cache_slots": slots, "batch": 1,
             "ms_per_token": ms_tok, "tokens_timed": n_timed, "launches_per_token": calls["launches"],
             "syncs_per_token": calls["syncs"],
             "expert_bank_gib": expert_bytes / gib, "expert_read_bound_ms": expert_bytes / HBM_BYTES_PER_S * 1e3,
             "cache_gib": sum(v.numel() * v.element_size() for v in cache.values()) / gib,
             "cache_dtypes_before": before, "cache_dtypes_after": after, "weight_dtypes": weight_dtypes,
             "logits_dtype": name_of(logits.dtype),
             "weights_gib": sum(p_.numel() * p_.element_size() for p_ in model.parameters()) / gib,
             "max_memory_allocated_gib": torch.cuda.max_memory_allocated(dev) / gib,
             "logits_finite": bool(torch.isfinite(logits).all())})
        # the reference's abstract_cache: every leaf in the config's dtype;
        # jnp promotion keeps the logits bfloat16; the experts stay bfloat16
        want_dtypes = {k: "bfloat16" for k in info["cache_shapes"]}
        gate("moe_decode_bf16", bool(torch.isfinite(logits).all()) and before == after == want_dtypes
             and name_of(logits.dtype) == "bfloat16" and weight_dtypes == ["bfloat16"],
             f"logits {name_of(logits.dtype)}, cache {before} -> {after}, weights {weight_dtypes}")
        del model, cache, logits
        torch.cuda.empty_cache()
    launches = kernels.launch_counts()
    log({"phase": "moe", "seconds": time.perf_counter() - t_phase, "launches": launches})
    return launches


def dryrun_worker(out_path: Path) -> int:
    """Phase 55 (a)'s process (``--dryrun-worker OUT``): production cells
    traced by ``repro_torch.launch.dryrun.run_cell`` on fake CUDA tensors
    and priced with the H100's constants: stablelm-1.6b's train_4k and
    decode_32k as rank 0 of a fake 16 × 16 world, its decode_32k as rank 0
    of a fake 2 × 16 × 16 world (the multi-pod compile matrix: no costs).
    Writes the records to ``out_path``; nothing is launched on the card."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.dryrun import fake_world, run_cell

    recs = []
    for size, multi, cells in ((256, False, DRYRUN_SINGLE), (512, True, DRYRUN_MULTI)):
        with fake_world(size):
            for arch, shape in cells:
                t0 = time.perf_counter()
                rec = run_cell(arch, shape, multi, costs=not multi, device="cuda", machine="h100")
                recs.append(rec | {"seconds": time.perf_counter() - t0})
    out_path.write_text(json.dumps(recs))
    return 0


def dryrun_phases(torch) -> dict:
    """Phase 55: the dry-run's traces, in production and against the card
    (module docstring).  Returns the kernel launch counts of the phase."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import kernels
    from repro_torch.analysis.roofline import cost_from_trace, model_flops, roofline_from_cost
    from repro_torch.core.machines import H100_ROOFLINE
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.dryrun import _trace_cell
    from repro_torch.models.registry import model_api
    from repro_torch.train import AdamWConfig, DataConfig, batch_at, build_train_step, init_opt_state

    dev = torch.device("cuda", 0)
    t_phase = time.perf_counter()
    kernels.reset_launch_counts()
    # (a) runs in its own process beside (b): its fake world never meets
    # phase 54's NCCL worlds
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_")
    out_path, log_path = Path(tmp.name) / "cells.json", Path(tmp.name) / "worker.log"
    log_file = open(log_path, "w")
    worker = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--dryrun-worker",
                               str(out_path)], stdout=log_file, stderr=subprocess.STDOUT)
    try:
        # (b) stablelm's f32 step at 8 x 256 on one device: traced, then run
        cfg = train_cli.preset_config("stablelm_1_6b", "full").with_(dtype=torch.float32)
        batch, seq = 8, 256
        opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=3)  # phase 50's
        t0 = time.perf_counter()
        tr = _trace_cell(cfg, None, "train", seq, batch, device=dev)
        trace_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated(dev)
        model = model_api(cfg).init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        opt = init_opt_state(model)
        step_fn = build_train_step(cfg, opt_cfg, batch=batch, seq=seq, device=dev).step_fn
        data = [batch_at(DataConfig(vocab=cfg.vocab, batch=batch, seq=seq), s, device=dev)
                for s in range(2)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        with FlopCounterMode(display=False) as counter:
            step_fn(model, opt, data[0])
        torch.cuda.synchronize()
        card_peak = torch.cuda.max_memory_allocated(dev) - resident
        t0 = time.perf_counter()
        m = step_fn(model, opt, data[1])
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        card_flops = counter.get_total_flops()
        cost = cost_from_trace(tr.flops, tr.hbm_bytes, tr.records)
        rl = roofline_from_cost(cost, 1, model_flops(cfg, "train", seq, batch), machine=H100_ROOFLINE,
                                dtype="float32")
        ideal_s = rl.model_flops_global / rl.peak_flops
        peak_rel = abs(tr.peak_bytes - card_peak) / card_peak
        log({"phase": "dryrun_vs_card", "arch": cfg.name, "dtype": "float32", "batch": batch,
             "seq": seq, "trace_s": trace_s, "trace_flops": tr.flops, "card_flops": card_flops,
             "trace_peak_bytes": tr.peak_bytes, "card_peak_bytes": card_peak,
             "trace_argument_bytes": tr.argument_bytes,
             "peak_rel_diff": peak_rel, "step_s": step_s, "loss": float(m["loss"]),
             "roofline": rl.as_dict(), "bound_s": rl.bound_s,
             "measured_roofline_fraction": ideal_s / step_s, "bound_over_measured": rl.bound_s / step_s})
        gate("dryrun_vs_card", card_flops == tr.flops and card_flops > 0,
             f"traced {tr.flops} FLOPs, the card's step {card_flops}")
        gate("dryrun_vs_card", peak_rel <= DRYRUN_PEAK_GATE,
             f"traced peak {tr.peak_bytes} B against the card's {card_peak} B")
        del model, opt, data, m
        torch.cuda.empty_cache()

        # (a) the production cells
        try:
            worker.wait(timeout=DRYRUN_WORKER_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            pass
    finally:
        if worker.poll() is None:
            worker.kill()
            worker.wait()
        log_file.close()
    try:
        gate("dryrun_cells", worker.returncode == 0,
             f"the worker exited {worker.returncode}: {log_path.read_text()[-3000:]}")
        recs = json.loads(out_path.read_text())
    finally:
        tmp.cleanup()
    for rec in recs:
        log({"phase": "dryrun_cell", **rec})
    train = recs[0]
    n_calls = sum(train["collective_calls_by_axis"].values())
    gate("dryrun_cells", n_calls == DRYRUN_TRAIN_CALLS and train["roofline"]["machine"] == "H100"
         and all(math.isfinite(rec["memory"]["temp_bytes_per_dev"]) for rec in recs)
         and all(rec["roofline"]["compute_s"] > 0 for rec in recs if "roofline" in rec),
         f"{n_calls} collective calls (want {DRYRUN_TRAIN_CALLS}): {recs}")
    launches = kernels.launch_counts()
    log({"phase": "dryrun", "seconds": time.perf_counter() - t_phase, "launches": launches})
    return launches


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
    from repro_torch.kernels.block_update.ops import tail_plan
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
    from repro_torch.kernels.chol_apply.ops import chol_plan
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

    def check_tail(t, dtype, offset=False):
        def block():
            m = randn(n, t, dtype=dtype)
            if not offset:
                return m
            return torch.empty(n * t + 1, dtype=dtype, device=dev)[1:].view(n, t).copy_(m)

        ops = tuple(block() for _ in range(5)) + tuple(randn(t, t, dtype=dtype) for _ in range(3))
        x, r, p, ap, po, c, d, do = ops
        kernel = lambda: kernels.ecg_tail(*ops)
        pcat, dcat = torch.cat([p, po], dim=1), torch.cat([d, do], dim=0)
        library = lambda: (torch.addmm(x, p, c), torch.addmm(r, ap, c, alpha=-1),
                           torch.addmm(ap, pcat, dcat, alpha=-1))
        bound = (x.abs() + p.abs() @ c.abs(), r.abs() + ap.abs() @ c.abs(),
                 ap.abs() + p.abs() @ d.abs() + po.abs() @ do.abs())
        return (ecg_tail_ref, ops, kernel, library, bound, 2 * t + 1,
                (8 * n * t + 3 * t * t) * x.element_size(), 8 * n * t * t,
                [n, t] + (["offset by one value"] if offset else []),
                tail_plan(t, dtype, not offset, sms).path)

    def run_check(name, make, t, dtype):
        plain_fn, ops, kernel, library, bound, k_sum, bytes_, flops, shape, path = make(t, dtype)
        plain = lambda: plain_fn(*ops)
        dname = str(dtype).removeprefix("torch.")
        row = {"name": name, "shape": shape, "dtype": dname, "path": path,
               **hold_to_plain(torch, f"{name} t={t}", plain_fn, ops, kernel, bound, k_sum)}
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
        same = all(torch.equal(a, b) for a, b in zip(tup(kernel()), tup(kernel())))
        log({"phase": "repeat_check", "name": name, "shape": shape, "bit_identical": same})
        if not same:
            raise AssertionError(f"{name}: two calls on the same inputs differ")

    checks = {}
    # the serve phases' widths (34-39): t = 4 solves and width-16 packs; and
    # the wide ones (40-44): t = 20 solves and the width-32 pack
    width_rows = {}
    for name, make in (("bsr_spmbv", check_bsr), ("fused_gram", check_gram), ("ecg_tail", check_tail)):
        checks[name] = run_check(name, make, T, torch.float64)  # the main path's shape
        run_check(name, make, 1, torch.float64)
        run_check(name, make, T, torch.float32)
        width_rows[name] = {w: run_check(name, make, w, torch.float64) for w in (T_SERVE, 16) + WIDE}
        repeat_check(name, make, T)
        repeat_check(name, make, T_WIDE)
        torch.cuda.empty_cache()
    repeat_check("ecg_tail", check_tail, 32)
    run_check("ecg_tail", lambda t, dtype: check_tail(t, dtype, offset=True), T_WIDE, torch.float64)
    for w in (1, T_SERVE, 16) + WIDE:  # float32 at the float64 rows' widths
        run_check("ecg_tail", check_tail, w, torch.float32)
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
               "path": chol_plan(t, dtype, all(m.data_ptr() % 16 == 0 for m in (z, az))).path,
               "kernel_ms": time_ms(torch, kernel),
               # the kernel alone: at t <= 2 the eager op is the host's launch path
               "kernel_graph_ms": time_graph_ms(torch, kernel),
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
    # t = 1 and 2 take the vector path; t = 1 is held to half its bound by
    # its device time (logged: a time is not a gate)
    width_rows["chol_apply"] = {1: run_chol_check(*chol_operands(1, torch.float64), "t=1")}
    row = run_chol_check(*chol_operands(2, torch.float64), "t=2")
    log({"phase": "chol_apply_vector_path", "share_of_bound_graph": {
        w: r_["bound_ms"] / r_["kernel_graph_ms"] for w, r_ in ((1, width_rows["chol_apply"][1]), (2, row))},
        "share_of_bound_eager": {
        w: r_["bound_ms"] / r_["kernel_ms"] for w, r_ in ((1, width_rows["chol_apply"][1]), (2, row))},
        "t1_at_least_half_of_bound": width_rows["chol_apply"][1]["kernel_graph_ms"]
        <= 2 * width_rows["chol_apply"][1]["bound_ms"]})
    run_chol_check(*chol_operands(T, torch.float32), "float32")
    for w in WIDE:
        width_rows["chol_apply"][w] = run_chol_check(*chol_operands(w, torch.float64), f"t={w}")
        torch.cuda.empty_cache()
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
    x4 = res.x.clone()  # phase 45's one-shot solve must equal it bit for bit
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
    l32 = spd_factors(n // 32, 32, torch.float64)
    run_trisolve_check(l32, T, torch.float64, "bs=32")
    run_trisolve_check(spd_factors(n // 64, 64, torch.float64), T, torch.float64, "bs=64")
    # the wide widths at the default block: two chunks of 16 right-hand sides
    width_rows["block_trisolve"] = {w: run_trisolve_check(l32, w, torch.float64, f"bs=32, t={w}")
                                    for w in WIDE}
    del l32
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
    def bj_solve(handle, phase, block, mesh_=None, sequential=None, unpre=None, **extra):
        """One block-Jacobi solve at full scale with the launch counts (and
        the mesh's counters) set to 0 just before it, held to every gate of
        the preconditioned main path: converged, the launch counts, true
        residual ≤ 10·tol, fewer iterations than the unpreconditioned solve
        (phase 4's, or ``unpre``'s at another t), and on the mesh the
        psum/ppermute counts and the iterations within 1% of the sequential
        solve at the same block."""
        unpre = seq if unpre is None else unpre
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
        row = {"phase": phase, "n": n, "t": handle.t, "block": block, "tol": tol,
               "factors": list(handle._precond.factors.shape), **extra,
               "converged": r.converged, "breakdown": r.breakdown, "n_iters": k_,
               "final_rn": float(r.res_hist[k_]), "true_residual": true_, "solve_s": solve_s,
               "ms_per_iter": solve_s * 1e3 / max(k_, 1), "unpreconditioned": unpre, "launches": got}
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
        if not k_ < unpre["n_iters"]:
            raise AssertionError(f"{phase}: {k_} iterations, unpreconditioned {unpre['n_iters']}")
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
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        r3 = s3.solve(b3)
        torch.cuda.synchronize()
        inexact_launches = kernels.launch_counts()
        if where == "sequential":  # chol_apply at t = 1, its vector path
            chol_t1_launches = inexact_launches["chol_apply"]
        x3 = torch.as_tensor(s3.unshard(r3.x), device=dev)
        true3 = float(torch.linalg.norm(b3_dev - csr_spmv(a3, x3)))
        log({"phase": "inexact", "n": a3.shape[0], "strategy": where, "converged": r3.converged,
             "n_iters": r3.n_iters, "n_reseeds": r3.n_reseeds, "true_residual": true3, "tol": tol3,
             "solve_s": time.perf_counter() - t0, "launches": inexact_launches})
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
    torch.cuda.empty_cache()  # solver, dsolver, mesh and pm stay: phases 40-44

    # ---------------------------------------------------------- 29. calibrate
    from calibrate_h100 import measure as calibrate
    from repro_torch.core.machines import H100, H100_ROOFLINE

    t0 = time.perf_counter()
    cal = calibrate(torch)
    keys = ("alpha", "alpha_l", "R_N", "R_b", "R_bl", "gamma", "eager_cutoff", "R_mem",
            "dispatch_overhead")
    committed = {k: getattr(H100, k) for k in keys}
    matmul = H100_ROOFLINE.matmul_flops  # the roofline's rates (phase 55)
    log({"phase": "calibrate", "seconds": time.perf_counter() - t0, "card": cal["card"],
         "measured": {k: cal[k] for k in keys}, "committed": committed,
         "measured_over_committed": {k: cal[k] / committed[k] for k in keys},
         "matmul_flops": cal["matmul_flops"], "matmul_flops_committed": matmul,
         "matmul_measured_over_committed": {k: cal["matmul_flops"][k] / matmul[k] for k in matmul},
         "cards": cal["cards"]})
    gate("calibrate", all(math.isfinite(v) and v > 0 for v in [cal[k] for k in keys] + list(committed.values())
                          + list(cal["matmul_flops"].values()) + list(matmul.values())),
         f"a constant is not finite and positive: {cal} / {committed} / {matmul}")

    # ------------------------------- 30. bsr_spmbv at every tile the tuner weighs
    from repro_torch.tune import DEFAULT_TILES, TunedConfig, tile_stats, tune
    from repro_torch.kernels.bsr_spmbv.ops import block_ell_arrays
    from repro_torch.sparse.spmbv import _make_distributed_spmbv

    # The tiles no default solve runs (PERF.md §6: launches 0) are held to
    # their plain version on phase 5's (64, 64)-element operator; their
    # full-scale times stay in PERF.md §6.  Example 2.1 is converted at the two
    # tiles the tuner picks, beside phase 2's (8, 8) arrays.
    small_tiles = {(4, 4), (16, 8), (32, 32)}
    # the H100 model's tile (PERF.md §6): phases 31 and 33 build on it and
    # are handed its arrays (a handle ignores arrays of another tile)
    tile_rows, model_tile = [], {}
    main_arrays = solver.conversion["arrays"]
    for br, bc in DEFAULT_TILES:
        op = a2 if (br, bc) in small_tiles else a
        nt_ = op.shape[0]
        t0 = time.perf_counter()
        if (br, bc) == (main_arrays["br"], main_arrays["bc"]):  # phase 2's tile: its arrays
            tblk, tidx, tmeta = main_arrays["blocks"], main_arrays["indices"], main_arrays["meta"]
            convert_s = None
        else:
            tblk, tidx, _, tmeta, _ = block_ell_arrays(op, br, bc)
            torch.cuda.synchronize()
            convert_s = time.perf_counter() - t0
            if (br, bc) == (16, 16):
                model_tile["arrays"] = dict(main_arrays, blocks=tblk, indices=tidx, m_pad=tmeta["m_pad"],
                                            br=br, bc=bc, meta=tmeta)

        def check_tile(t, dtype, tblk=tblk, tidx=tidx, op=op, n=nt_, tmeta=tmeta):
            blk = tblk.to(dtype)
            v = randn(n, t, dtype=dtype)
            nbr, kmax, br_, bc_ = blk.shape
            plain = lambda blk_, v_: bsr_spmbv_ref(blk_, tidx, torch.nn.functional.pad(
                v_, (0, 0, 0, tmeta["m_pad"] - n)))[:n]
            es = blk.element_size()
            csr = library_csr(dtype) if op is a else torch.sparse_csr_tensor(
                op.indptr, op.indices, op.data.to(dtype), size=op.shape)
            return (plain, (blk, v), lambda: kernels.bsr_spmbv(blk, tidx, v, n_rows=n),
                    lambda: torch.sparse.mm(csr, v), plain(blk.abs(), v.abs()),
                    kmax * bc_, blk.numel() * es + tidx.numel() * 4 + 2 * n * t * es,
                    2 * blk.numel() * t, list(blk.shape) + [t],
                    spmbv_plan(nbr, br_, bc_, t, n, dtype, sms).path)

        row = run_check("bsr_spmbv", check_tile, T, torch.float64)
        row.update(phase="bsr_spmbv_tiles", tile=[br, bc], kmax=tmeta["kmax"],
                   fill=tblk.numel() / op.nnz, convert_s=convert_s,
                   operator="Example 2.1" if op is a else "(64, 64) elements (phase 5)")
        log(row)
        tile_rows.append(row)
        del tblk, tidx, check_tile
        torch.cuda.empty_cache()
    csr_by_dtype.clear()
    best_tile = min((r_ for r_ in tile_rows if r_["operator"] == "Example 2.1"),
                    key=lambda r_: r_["kernel_ms"])["tile"]
    log({"phase": "bsr_spmbv_tiles", "summary": {f"{r_['tile'][0]}x{r_['tile'][1]}": {
        k_: r_[k_] for k_ in ("operator", "path", "kernel_ms", "bound_ms", "library_ms", "kmax", "fill")}
        for r_ in tile_rows}, "fastest_at_full_scale": best_tile})

    # ------------------------------------------- 31. tuned, sequential (model)
    t0 = time.perf_counter()
    tsolver = ECGSolver.build(a, config=config.replace(tune_mode="model"), device=dev,
                              conversion=model_tile)
    torch.cuda.synchronize()
    tuned_build_s = time.perf_counter() - t0
    tcfg = tsolver.tuned
    r, got, _, row = scheme_solve(tsolver, "tuned_sequential", tile=list(tcfg.ell_block),
                                  kmax=tcfg.kmax, machine=tcfg.machine.name, build_s=tuned_build_s,
                                  conv_reused=tsolver.stats.conv_reused,
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
    asolver = ECGSolver.build(a, config=config.replace(t="auto"), b=b, device=dev,
                              conversion=model_tile)
    torch.cuda.synchronize()
    auto_build_s = time.perf_counter() - t0
    sel = asolver.selection
    log({"phase": "auto_t_selection", "t": sel.t, "build_s": auto_build_s,
         "conv_reused": asolver.stats.conv_reused,
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
    del asolver, r, model_tile
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

    # ---------------------------------------------- 40. wide_main_path (t = 20)
    # The paper's widest t (Fig 3.2 solves Example 2.1 at t = 20) through the
    # kernels' wide instances: phase 2's handle at t = 20, the conversion reused
    t0 = time.perf_counter()
    h20 = solver.with_config(t=T_WIDE)
    torch.cuda.synchronize()
    h20_build_s = time.perf_counter() - t0
    r, got, _, row = scheme_solve(h20, "wide_main_path", t=T_WIDE, build_s=h20_build_s,
                                  conv_reused=h20.stats.conv_reused, t8=seq)
    k20 = r.n_iters
    log(row)
    gate("wide_main_path", h20.t == T_WIDE and r.t == T_WIDE and h20.stats.conv_reused,
         f"t={r.t}, conversion reused {h20.stats.conv_reused}")
    gate("wide_main_path", got == want_launches(bsr_spmbv=k20 + 1, fused_gram=k20, ecg_tail=k20,
                                                chol_apply=k20), f"launch counts {got}")
    wide = {"main": row}
    del r
    torch.cuda.empty_cache()

    # --------------------------------------------- 41. wide_cross_check (t = 20)
    out = {}
    for backend in ("pallas", "jnp"):
        s2 = ECGSolver.build(a2, config=cfg2.replace(t=T_WIDE, backend=backend), device=dev)
        out[backend] = s2.solve(b2)
    xp, xj = out["pallas"].x, out["jnp"].x
    x_rel = float((xp - xj).abs().max() / xj.abs().max())
    log({"phase": "wide_cross_check", "n": a2.shape[0], "t": T_WIDE,
         "iters_pallas": out["pallas"].n_iters, "iters_jnp": out["jnp"].n_iters,
         "x_max_rel_diff": x_rel})
    gate("wide_cross_check", out["pallas"].converged and out["jnp"].converged, "did not converge")
    gate("wide_cross_check", abs(out["pallas"].n_iters - out["jnp"].n_iters) <= 1,
         f"{out['pallas'].n_iters} pallas against {out['jnp'].n_iters} jnp iterations")
    gate("wide_cross_check", x_rel <= 1e-8, f"x differs by {x_rel} (relative)")
    del out, s2

    # ---------------------------------------- 42. wide_distributed (t = 20, mesh)
    t0 = time.perf_counter()
    d20 = dsolver.with_config(t=T_WIDE)  # the partition and the Block-ELL arrays reused
    torch.cuda.synchronize()
    d20_build_s = time.perf_counter() - t0
    plan20 = d20.op.plan
    ph20, rot20 = len(plan20.phases), sum(1 for st in plan20.steps if st.offset)
    r, got, counters, row = scheme_solve(d20, "wide_distributed", mesh_=mesh, t=T_WIDE,
                                         strategy="optimal", build_s=d20_build_s,
                                         conv_reused=d20.stats.conv_reused, sequential=k20)
    k_ = r.n_iters
    counters["ppermute_elements"] = mesh.ppermute_elements
    # one exchange at width 1 and at width 20, each counted alone: the width-20
    # one against the elements the plan's exchange at that width rotates (its
    # buffers, padded to the widest rank) and the solve's against one width-1
    # and n_iters width-20 exchanges; the plan's wire elements (the rows that
    # cross, without the padding) are logged beside
    per = {}
    for w in (1, T_WIDE):
        mesh.reset_counters()
        d20.op.matvec_fn()(torch.zeros(d20.op.n_padded, w, dtype=torch.float64, device=dev))
        torch.cuda.synchronize()
        per[w] = mesh.ppermute_elements
    plan_el = d20.op.exchange(plan20, T_WIDE, torch.float64).deltas[-1]
    row.update(col_split=plan20.col_split, phases=ph20, rotations=rot20,
               elements_per_exchange=per, plan_exchange_elements=plan_el,
               plan_wire_elements=plan20.wire_bytes(8) // 8,
               ppermute_elements=counters["ppermute_elements"])
    log(row)
    gate("wide_distributed", counters["psum"] == 3 * k_ + 1, f"psum ran {counters['psum']} times")
    gate("wide_distributed", counters["ppermute"] == rot20 * (k_ + 1),
         f"ppermute ran {counters['ppermute']} times, want {rot20}·({k_} + 1)")
    gate("wide_distributed", per[T_WIDE] == plan_el
         and counters["ppermute_elements"] == per[1] + k_ * per[T_WIDE],
         f"{per} elements an exchange, the plan's exchange {plan_el}; "
         f"{counters['ppermute_elements']} in the solve, want {per[1]} + {k_}·{per[T_WIDE]}")
    gate("wide_distributed", got == want_launches(
        bsr_spmbv=k_ + 1, fused_gram=k_, ecg_tail=k_, chol_apply=k_,
        halo_pack=ph20 * (k_ + 1), halo_unpack=ph20 * (k_ + 1)), f"launch counts {got}")
    gate("wide_distributed", abs(k_ - k20) <= max(1, 0.01 * k20),
         f"{k_} iterations not within 1% of the sequential {k20}")
    wide["distributed"] = row
    del r, d20, plan20
    torch.cuda.empty_cache()

    # ---------------------------------- 43. wide_block_jacobi (t = 20, block 32)
    t0 = time.perf_counter()
    b20 = h20.with_config(precondition=prec_bj32)
    torch.cuda.synchronize()
    wide["block_jacobi"] = bj_solve(b20, "wide_block_jacobi_32", 32, unpre={
        k2: wide["main"][k2] for k2 in ("n_iters", "ms_per_iter", "solve_s")},
                                    build_s=time.perf_counter() - t0, **b20._precond.build_s)
    del b20, h20
    torch.cuda.empty_cache()

    # ----------------------------------------------- 44. wide_pack (width 32)
    # four requests at t = 8 in one width-32 pack on phase 2's handle
    # (rankrev), no server: the retirement and true-residual gates of phase 36
    psolver = solver.with_config(adaptive="rankrev")
    wide_c = (1e-4, 1e-6, 1e-8, 1e-8)
    wide_tols = [c_ * float(np.linalg.norm(b_)) for b_, c_ in zip(serve_b, wide_c)]
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = psolver.solve_packed(serve_b, tols=wide_tols)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    got = kernels.launch_counts()
    k_ = res[0].pack["packed_iters"]
    relres = [true_residual(psolver, r_.x, b_) / float(np.linalg.norm(b_)) for r_, b_ in zip(res, serve_b)]
    iters = [r_.n_iters for r_ in res]
    row = {"phase": "wide_pack", "n": n, "t_each": T, "width": res[0].pack["width"],
           "tols_rel": wide_c, "n_iters": iters, "retired_iter": [r_.pack["retired_iter"] for r_ in res],
           "packed_iters": k_, "true_relres": relres, "solve_s": pack_s,
           "ms_per_iter": pack_s * 1e3 / max(k_, 1), "launches": got}
    log(row)
    gate("wide_pack", res[0].pack["width"] == 4 * T, f"pack {res[0].pack}")
    gate("wide_pack", all(r_.converged and rr <= c_ * 1.01 for r_, rr, c_ in zip(res, relres, wide_c)),
         f"converged {[r_.converged for r_ in res]}, true relres {relres}")
    gate("wide_pack", all(iters[i] <= iters[j] for i in range(4) for j in range(4)
                          if wide_c[i] > wide_c[j]), f"retirements {iters} not ordered by tolerance")
    gate("wide_pack", got == want_launches(bsr_spmbv=k_ + 1, fused_gram=k_, ecg_tail=k_,
                                           rank_apply=k_, drop_mask=k_), f"launch counts {got}")
    wide["pack"] = row
    log({"phase": "wide", "summary": {
        ph: {k2: r2.get(k2) for k2 in ("n_iters", "packed_iters", "ms_per_iter", "solve_s",
                                       "true_residual", "true_relres")} for ph, r2 in wide.items()},
        "t8": seq})
    del psolver, res, solver, dsolver, mesh, pm
    torch.cuda.empty_cache()

    # ------------------------------------------ 45.-48. the one-shot API, the sweeps
    oneshot = oneshot_phases(torch, dev, a, b, tol, seq["n_iters"], x4, d8["n_iters"])

    # --------------------------------------------- 49. the process-group mesh
    process_mesh = process_mesh_phases(torch, seq["n_iters"])

    # ----------------------------------------------------------- 50. the LM
    lm_launches = lm_phases(torch)

    # ------------------------------------------------------ 51. the SSM LMs
    ssm_launches = ssm_phases(torch)

    # ------------------------------- 52. the encoder-decoder and VLM-prefix LMs
    ed_launches = encdec_vlm_phases(torch)

    # ------------------------------------------------------ 53. the MoE LMs
    moe_launches = moe_phases(torch)

    # ------------------------------- 54. the LM's 2-D layout over NCCL
    mesh_launches = lm_mesh_phases(torch)

    # ------------------------------- 55. the dry-run, traced and on the card
    dryrun_launches = dryrun_phases(torch)

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
        {"tile": r_["tile"], "operator": r_["operator"], "path": r_["path"], "kmax": r_["kmax"],
         "fill": r_["fill"],
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
    # the wide widths (phases 3 and 12), with their launches in the t = 20
    # solves (phases 40 and 43) and the width-32 pack (phase 44); chol_apply
    # also at t = 1 (its vector path), launched by the sequential inexact
    # solve (phase 16); no solve runs chol_apply or block_trisolve at 32
    wide_launches = {
        "bsr_spmbv": {T_WIDE: ("wide_main_path", wide["main"]), 32: ("wide_pack", wide["pack"])},
        "fused_gram": {T_WIDE: ("wide_main_path", wide["main"]), 32: ("wide_pack", wide["pack"])},
        "ecg_tail": {T_WIDE: ("wide_main_path", wide["main"]), 32: ("wide_pack", wide["pack"])},
        "chol_apply": {1: ("inexact_sequential", {"launches": {"chol_apply": chol_t1_launches}}),
                       T_WIDE: ("wide_main_path", wide["main"]), 32: (None, None)},
        "block_trisolve": {T_WIDE: ("wide_block_jacobi_32", wide["block_jacobi"]), 32: (None, None)},
    }
    for name, by_width in wide_launches.items():
        rows[list(sources).index(name)].setdefault("widths", []).extend(
            {"t": w_, "launches_in": where, "launches": run_["launches"][name] if run_ else 0,
             **{k_: width_rows[name][w_][k_] for k_ in ("max_abs_err", "plain_ms", "bound_ms",
                                                        "bound_by", "library_ms")},
             "ms": width_rows[name][w_]["kernel_ms"],
             **({"graph_ms": width_rows[name][w_]["kernel_graph_ms"]}
                if "kernel_graph_ms" in width_rows[name][w_] else {})}
            for w_, (where, run_) in by_width.items())
    # and each kernel's launches in the one-shot and sweep phases (45-48)
    for row in rows:
        row["oneshot_launches"] = {ph: counts[row["name"]] for ph, counts in oneshot.items()}
        row["process_mesh_launches"] = {ph: counts[row["name"]] for ph, counts in process_mesh.items()}
        row["lm_launches"] = (lm_launches[row["name"]] + ssm_launches[row["name"]]
                              + ed_launches[row["name"]] + moe_launches[row["name"]]
                              + mesh_launches[row["name"]]
                              + dryrun_launches[row["name"]])  # phases 50-55
    log({"kernels": rows})
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--process-mesh-worker"]:
        sys.exit(process_mesh_worker(Path(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])))
    if sys.argv[1:2] == ["--lm-mesh-worker"]:
        sys.exit(lm_mesh_worker(Path(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])))
    if sys.argv[1:2] == ["--dryrun-worker"]:
        sys.exit(dryrun_worker(Path(sys.argv[2])))
    sys.exit(main())
