"""Measured microbenchmark mode for the setup-time autotuner.

When the :class:`~repro_torch.core.machines.MachineParams` constants are in
doubt (new machine, virtualized hosts, unknown NIC contention), the tuner can
*measure* instead of model: build the candidate distributed SpMBV operators
on the real mesh, time a few applications of each, and take the argmin.
This is the paper's "four trial SpMBVs at communicator-setup time" tuning,
extended to the tile-shape and overlap axes.

To keep setup cost bounded the search is coordinate descent rather than the
full grid: strategies first (blocking, reference tile), then tile shapes
under the winning strategy, then blocking-vs-overlap for the winning pair —
4 + |tiles| + 2 operator builds instead of 4·|tiles|·2.

Port of ``repro/tune/microbench.py``.  Departures in form: the operators
are built by :func:`repro_torch.sparse.spmbv._make_distributed_spmbv` (the
engine of ``make_distributed_spmbv``) on a
:class:`~repro_torch.launch.mesh.VirtualMesh`; the four strategy candidates
share one Block-ELL conversion (it depends on the partition and the tile
alone), and each candidate is dropped before the next is built, since at
full scale one conversion holds gigabytes on the card.  The dispatch
microbenchmark captures its chain in one CUDA graph, as ``HaloExchange``
runs an exchange, where the reference times one compiled program.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.analysis.ecg_bench import _timeit
from repro_torch.kernels.halo_pack.ops import halo_pack, halo_unpack
from repro_torch.sparse.partition import PartitionedMatrix, partition_csr
from repro_torch.sparse.spmbv import _make_distributed_spmbv


def _time_operator(op, n: int, t: int, repeats: int, seed: int) -> float:
    """Median wall microseconds of ``op``'s apply on a seeded (n, t) block.
    The first apply (the exchange's eager run) happens before the timer,
    whose own warm-up call then captures the exchange's CUDA graph."""
    f = op.matvec_fn()
    rng = np.random.default_rng(seed)
    v = op.shard_vector(rng.standard_normal((n, t)))
    f(v)
    return _timeit(f, v, repeats=repeats)


def measure_config(
    a,
    mesh,
    t: int,
    strategy: str,
    ell_block,
    overlap: bool,
    backend: str = "pallas",
    machine=None,
    pm: PartitionedMatrix | None = None,
    repeats: int = 3,
    seed: int = 0,
) -> float:
    """Wall microseconds per distributed SpMBV application for one config
    (fixed operand ``seed``, median of ``repeats`` — reproducible on hosts)."""
    op = _make_distributed_spmbv(
        a, mesh, strategy, t=t, machine=machine, pm=pm,
        backend=backend, overlap=overlap, ell_block=ell_block,
    )
    return _time_operator(op, a.shape[0], t, repeats, seed)


def measure_dispatch_overhead(
    mesh,
    rows: int = 64,
    width: int = 4,
    chain: tuple[int, int] = (2, 16),
    repeats: int = 7,
    dtype=None,
) -> float:
    """Measured seconds per executor dispatch (one pack / ppermute / unpack
    op), the constant the structural cost model charges as
    ``MachineParams.dispatch_overhead``.

    Times two programs that chain the packed executor's primitive triple —
    ``halo_pack`` → ``mesh.ppermute`` → ``halo_unpack`` — ``chain[0]`` and
    ``chain[1]`` times over a tiny (rows, width) buffer per rank, with a
    data dependency between links (each link packs from the stage buffer the
    previous one unpacked into).  On the card each chain is captured in one
    CUDA graph, as ``HaloExchange`` replays an exchange; on CPU tensors it
    runs eagerly.  The buffer is deliberately small: the byte terms are
    negligible, so the wall-time *slope* over the extra links is pure
    per-op dispatch cost.  Returns the slope divided by 3 ops per link
    (clamped to a tiny positive floor so a noisy host never yields a
    non-positive constant).

    Feed the result back with
    ``dataclasses.replace(machine, dispatch_overhead=measured)`` to
    calibrate ``tune="model:structural"``.
    """
    dtype = dtype or torch.float64
    p, dev = mesh.local_ranks, mesh.device
    idx = torch.arange(rows, dtype=torch.int32, device=dev).expand(p, rows).contiguous()
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((p, rows, width)), dtype=dtype, device=dev)

    def chain_fn(m):
        stages = [torch.zeros(p, rows + 1, width, dtype=dtype, device=dev) for _ in range(m)]

        def run():
            src = x
            for stage in stages:
                buf = mesh.ppermute(halo_pack(src, idx), "flat", 1)
                stage.zero_()
                halo_unpack(stage, buf, idx)
                src = stage  # dependency: the next link packs what this one unpacked
            return src

        if not x.is_cuda:
            return run
        run()  # eager first run: builds the kernels, nothing is built under capture
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            run()
        return graph.replay

    m_lo, m_hi = chain
    us_lo = _timeit(chain_fn(m_lo), repeats=repeats)
    us_hi = _timeit(chain_fn(m_hi), repeats=repeats)
    per_op_s = (us_hi - us_lo) * 1e-6 / ((m_hi - m_lo) * 3)
    return max(per_op_s, 1e-9)


def tune_measured(
    a,
    mesh,
    t: int,
    backend: str = "pallas",
    tiles=None,
    machine=None,
    pm: PartitionedMatrix | None = None,
    repeats: int = 3,
):
    """Coordinate-descent measured tuning; returns a TunedConfig."""
    from repro_torch.core.models import STRATEGIES
    from repro_torch.tune.autotune import DEFAULT_TILES, TunedConfig, tile_stats

    tiles = tiles or DEFAULT_TILES
    n_nodes, ppn = mesh.shape
    pm = pm or partition_csr(a, n_nodes * ppn)
    rmax = pm.part.max_local_rows
    measured: dict[str, float] = {}
    ref_tile = (8, 8) if rmax >= 8 else (rmax, rmax)
    ref_ell = {}  # the reference tile's Block-ELL arrays, shared by the strategies

    def probe(strategy, tile, overlap):
        key = f"{strategy}/{tile[0]}x{tile[1]}/{'overlap' if overlap else 'blocking'}"
        if key not in measured:
            share = backend == "pallas" and not overlap and tile == ref_tile
            op = _make_distributed_spmbv(
                a, mesh, strategy, t=t, machine=machine, pm=pm, backend=backend,
                overlap=overlap, ell_block=tile, ell=ref_ell.get("ell") if share else None,
            )
            if share:
                ref_ell["ell"] = op.ell
            measured[key] = _time_operator(op, a.shape[0], t, repeats, seed=0)
        return measured[key]

    strategy = min(STRATEGIES, key=lambda s: probe(s, ref_tile, False))

    tile = ref_tile
    if backend == "pallas":
        cand = [(br, bc) for br, bc in tiles if br <= rmax and bc <= rmax] or [ref_tile]
        tile = min(cand, key=lambda tl: probe(strategy, tl, False))
    ref_ell.clear()

    overlap = min((False, True), key=lambda ov: probe(strategy, tile, ov))

    ts = tile_stats(pm, *tile)
    return TunedConfig(
        strategy=strategy,
        br=tile[0],
        bc=tile[1],
        kmax=ts.kmax,
        overlap=overlap,
        backend=backend,
        t=t,
        mode="measure",
        machine=machine,
        predicted={"measured_us": dict(measured)},
    )
