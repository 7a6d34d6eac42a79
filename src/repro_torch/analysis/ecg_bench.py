"""Measured ECG hot-path benchmarks: kernel-vs-oracle and overlap-vs-blocking.

Port of ``repro/analysis/ecg_bench.py``, used by ``repro_torch.launch.perf
--ecg`` (JSON) and by the tuner's measure mode (the timer).  Two families:

* :func:`overlap_vs_blocking_sweep` — distributed SpMBV wall time over
  strategies x t x backend x {blocking, overlap}, so the comm-hiding win of
  the interior/boundary schedule is *measured*, not asserted.  On a
  :class:`~repro_torch.launch.mesh.VirtualMesh` every rank lies on one
  device and the rotations are device copies, so overlap gains are modest.
* :func:`kernel_vs_oracle` — local hot-spot formulations head to head, in
  float32: the Block-ELL SpMBV (the ``bsr_spmbv`` CUDA kernel on the card,
  its plain version on the CPU) against the scalar-gather CSR product, and
  the fused gram / fused tail against their unfused torch forms.

Row names and ``derived`` strings are the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.dispatch import resolve_device
from repro_torch.observe import get_tracer, timed_median_us

STRATEGIES = ("standard", "2step", "3step", "optimal")


def _sync() -> None:
    """Wait for the card's queued work, where this process started CUDA: a
    call returns once its launches are enqueued, so a host clock without it
    times the enqueue, not the work."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _timeit(fn, *args, repeats: int = 3) -> float:
    """Median wall **microseconds** per call of ``fn(*args)`` over
    ``repeats`` timed calls, after one untimed warm-up call.

    The warm-up absorbs first-use costs, as the reference's absorbs the
    compile: the kernels' build on the card, and the CUDA-graph capture of
    an exchange whose eager first apply the caller has run (a
    ``HaloExchange`` captures at its second apply,
    :func:`repro_torch.tune.microbench.measure_config`).  Each timed call is
    bracketed by a synchronization, so it times finished device work (the
    reference blocks on the result the same way); on CPU tensors the
    synchronization is a no-op.  The calls go through
    :func:`repro_torch.observe.timed_median_us`, as the reference's, so an
    installed ambient tracer (:func:`repro_torch.observe.set_tracer`) sees
    each timed call as a ``bench/ecg_bench`` span.
    """

    def call(*a):
        out = fn(*a)
        _sync()
        return out

    return timed_median_us(call, *args, repeats=repeats, label="ecg_bench",
                           tracer=get_tracer(), sync=False)


def overlap_vs_blocking_sweep(
    a,
    mesh,
    ts=(4, 8),
    strategies=STRATEGIES,
    backends=("jnp", "pallas"),
    repeats: int = 5,
    machine=None,
    ell_block: int = 8,
    seed: int = 0,
):
    """Distributed SpMBV timings; returns rows of dicts (name/us/derived).

    ``seed`` fixes the operand RNG and ``repeats`` the median-of-k timing.
    Each operator's first apply (the exchange's eager run) comes before the
    timer, whose warm-up call then captures the exchange's CUDA graph.
    """
    from repro_torch.sparse.spmbv import _make_distributed_spmbv

    rng = np.random.default_rng(seed)
    rows = []
    for strategy in strategies:
        for t in ts:
            big_v = rng.standard_normal((a.shape[0], t))
            for backend in backends:
                base_us = None
                for overlap in (False, True):
                    op = _make_distributed_spmbv(
                        a, mesh, strategy, t=t, machine=machine,
                        backend=backend, overlap=overlap, ell_block=ell_block,
                    )
                    f = op.matvec_fn()
                    v = op.shard_vector(big_v)
                    f(v)
                    us = _timeit(f, v, repeats=repeats)
                    if overlap:
                        derived = f"speedup_vs_blocking={base_us / us:.2f}"
                    else:
                        base_us = us
                        derived = f"halo={op.plan.halo_size}"
                    mode = "overlap" if overlap else "blocking"
                    rows.append(dict(
                        name=f"spmbv/{strategy}_t{t}_{backend}_{mode}",
                        us=us, derived=derived,
                    ))
    return rows


def kernel_operands(ts=(2, 4, 8), elements=(16, 16), block: int = 16, seed: int = 2,
                    device="cuda"):
    """:func:`kernel_vs_oracle`'s float32 operands: ``(a, blocks, idx, per_t)``,
    the operator, its Block-ELL arrays and, for each t of ``ts``, ``(t, v,
    gram, tail)``: the SpMBV block, the fused gram's four (32 768, t) blocks
    and the tail's eight operands, drawn from ``np.random.default_rng(seed)``
    in the reference's order.  A caller holding the kernels to their plain
    versions gets the very inputs the timings use."""
    from repro_torch.kernels import bsr_to_block_ell
    from repro_torch.sparse import csr_to_bsr, dg_laplace_2d

    dev = resolve_device(device)
    a = dg_laplace_2d(elements, block=block, dtype=torch.float32, device=dev)
    blocks, idx = bsr_to_block_ell(csr_to_bsr(a, block, block))
    rng = np.random.default_rng(seed)

    def f32(shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev)

    n_loc = 32768
    per_t = []
    for t in ts:
        v = f32((a.shape[0], t))
        gram = tuple(f32((n_loc, t)) for _ in range(4))
        tail = tuple(f32((n_loc, t)) for _ in range(5)) + tuple(f32((t, t)) for _ in range(3))
        per_t.append((t, v, gram, tail))
    return a, blocks, idx, per_t


def kernel_vs_oracle(ts=(2, 4, 8), repeats: int = 5, elements=(16, 16), block: int = 16,
                     seed: int = 2, device="cuda"):
    """Local hot-spot timings in float32 on ``device`` (fixed ``seed`` +
    median-of-``repeats``) over :func:`kernel_operands`; the fused gram and
    tail run on (32 768, t) blocks, as the reference's."""
    from repro_torch.kernels import bsr_spmbv, ecg_tail, fused_gram
    from repro_torch.sparse import csr_spmbv

    a, blocks, idx, per_t = kernel_operands(ts, elements, block, seed, device)
    rows = []
    for t, v, mats, (x, r, p, ap, po, c, d, do) in per_t:
        us_csr = _timeit(lambda vv: csr_spmbv(a, vv), v, repeats=repeats)
        us_ell = _timeit(lambda vv: bsr_spmbv(blocks, idx, vv), v, repeats=repeats)
        rows.append(dict(name=f"kernel/csr_spmbv_t{t}", us=us_csr, derived=f"nnz={a.nnz}"))
        rows.append(dict(
            name=f"kernel/block_ell_spmbv_t{t}", us=us_ell,
            derived=f"csr/ell={us_csr / us_ell:.2f}",
        ))

        us_fused = _timeit(lambda *m: fused_gram(*m), *mats, repeats=repeats)
        us_sep = _timeit(
            lambda p, r, ap, apo: (p.T @ r, ap.T @ ap, apo.T @ ap),
            *mats, repeats=repeats,
        )
        rows.append(dict(
            name=f"kernel/fused_gram_t{t}", us=us_fused,
            derived=f"unfused/fused={us_sep / us_fused:.2f}",
        ))

        us_tail = _timeit(
            lambda *args: ecg_tail(*args), x, r, p, ap, po, c, d, do,
            repeats=repeats,
        )
        us_unf = _timeit(
            lambda x, r, p, ap, po, c, d, do: (
                x + p @ c, r - ap @ c, ap - p @ d - po @ do
            ),
            x, r, p, ap, po, c, d, do, repeats=repeats,
        )
        rows.append(dict(
            name=f"kernel/ecg_tail_t{t}", us=us_tail,
            derived=f"unfused/fused={us_unf / us_tail:.2f}",
        ))
    return rows
