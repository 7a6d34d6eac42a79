"""Model-driven joint selection of (strategy, tile shape, overlap).

All quantities are derived at setup time from the partitioned matrix — the
same host-side phase that builds the MPI-analogue communicator — so tuning
adds no device work:

* **Exchange strategy** — ``repro_torch.core.models.t_p2p`` over the exact Table-1
  communication statistics of :class:`repro_torch.core.comm_graph.CommGraph`,
  including the §4.3 nodal-optimal byte model.
* **Block-ELL tile** — for each candidate (br, bc), the block-structure
  histogram of the per-rank [own ‖ halo] CSR gives the stacked kernel's grid
  (nbr x kmax).  The model charges every stored tile, sublane-padded to the
  hardware's 8-element granularity, so it captures both failure modes: small
  tiles waste alignment padding, large tiles waste zero fill.
* **Overlap** — the busiest rank's nonzeros split into interior/boundary at
  block-row granularity; overlap wins when hiding the exchange behind the
  interior product (``max(T_int, T_exch) + T_bnd + overhead``) beats the
  blocking schedule (``T_exch + T_local``).

The selection is a joint argmin over the full (strategy x tile x overlap)
grid — the interaction matters because a faster exchange shrinks the window
the interior compute must cover.

Two exchange-cost models are selectable (``mode=``):

* ``"model"`` — the paper's analytic max-rate terms (eqs. 3.1–3.4, 4.2–4.4)
  over Table-1 message statistics.  Right on an MPI cluster whose
  :class:`MachineParams` are calibrated.
* ``"model:structural"`` — the *executor-structural* model: each strategy's
  actual :class:`~repro_torch.core.node_aware.ExchangePlan` is compiled and charged
  ``dispatches × dispatch_overhead + wire_bytes/R_b + local_bytes/R_bl``.
  This is what the shard_map executor really costs on host/TPU backends,
  where ppermute is a memcpy/ICI hop and per-op dispatch overhead — not NIC
  injection — dominates; the max-rate model mis-ranks strategies there.

Port of ``repro/tune/autotune.py``.  Both models are kept exactly as the
reference has them — the tile model's 8-element sublane padding
(``_pad8``) and the structural model's ``dispatch_count(packed=True)``
included — so that, given the same machine, every choice and every
predicted time equals the reference's.  Where they describe a TPU rather
than the H100 that the port runs on (the halo kernels run inside one CUDA
graph here), ``mode="measure"`` is the check, and the two are reported
side by side (PERF.md).  Departures in form only: ``tune()`` reads
``mesh.shape`` (the port's :class:`~repro_torch.launch.mesh.VirtualMesh`)
for the reference's ``mesh.devices.shape``; with ``machine=None`` it
defaults to the H100's parameters (:data:`~repro_torch.core.machines.H100`,
measured on the card) where the reference defaults to its TPU's; and
:func:`tile_stats` is cached on the partition (it does not depend on t,
and ``select_t`` tunes once per candidate t).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.comm_graph import CommGraph, build_comm_graph
from repro_torch.core.machines import H100, MachineParams
from repro_torch.core.models import STRATEGIES, t_p2p
from repro_torch.kernels.bsr_spmbv.ops import count_block_ell_tiles
from repro_torch.sparse.partition import (
    PartitionedMatrix,
    interior_boundary_split,
    partition_csr,
    rebased_local_csr,
)

#: Candidate Block-ELL tile shapes swept by default.  (8, 8) is the DG/FE
#: sweet spot; rectangular shapes trade MXU feed width against fill.  On the
#: H100, (8, 8), (16, 16), (8, 16) and (16, 8) take ``bsr_spmbv``'s f64
#: tensor-core path, (4, 4) and (32, 32) its FMA path (``spmbv_plan``).
DEFAULT_TILES = ((4, 4), (8, 8), (16, 16), (8, 16), (16, 8), (32, 32))


def _pad8(x: int) -> int:
    """Sublane-align a tile dimension (8-element granularity on TPU)."""
    return -(-x // 8) * 8


@dataclasses.dataclass(frozen=True)
class TileStats:
    """Stacked-kernel geometry for one candidate (br, bc) tile shape."""

    br: int
    bc: int
    nbr: int   # block rows in the per-rank grid (rmax, padded)
    kmax: int  # tiles per block row the stacked layout must budget
    nnz: int   # true nonzeros of the busiest rank's local block

    @property
    def stored(self) -> int:
        """Elements the stacked kernel multiplies per rank, with each tile
        dimension sublane-padded — the zero-fill x alignment cost."""
        return self.nbr * self.kmax * _pad8(self.br) * _pad8(self.bc)

    @property
    def fill(self) -> float:
        """stored / nnz — 1.0 is a perfectly tiled matrix."""
        return self.stored / max(self.nnz, 1)


@dataclasses.dataclass(frozen=True)
class TunedConfig:
    """A jointly selected (strategy, tile, overlap) execution config."""

    strategy: str
    br: int
    bc: int
    kmax: int        # per-tile budget the Block-ELL stacking will use
    overlap: bool
    backend: str
    t: int
    mode: str        # "model" | "measure"
    col_split: int = 1  # §4.3 wide-halo split factor (nodal-optimal only)
    # the resolved MachineParams the decision was made with — forwarded to
    # the plan builder so the applied plan matches the modeled one
    machine: object = dataclasses.field(default=None, compare=False, repr=False)
    predicted: dict = dataclasses.field(
        default_factory=dict, compare=False, repr=False
    )
    # the TSelection when t itself was chosen by t="auto" (None otherwise)
    selection: object = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def ell_block(self) -> tuple[int, int]:
        return (self.br, self.bc)

    def to_json(self) -> str:
        """Serialize to a JSON string (lossless round trip via
        :meth:`from_json`), so a tuned config can be cached on disk and fed
        back through ``SolverConfig(tune=TunedConfig.from_json(...))``
        without re-running the tuner.  The resolved ``machine`` parameters,
        the full ``predicted`` table, and a ``selection`` (when t itself was
        chosen by ``t="auto"``) all round-trip."""
        import json

        return json.dumps(tunedconfig_to_dict(self))

    @classmethod
    def from_json(cls, data) -> "TunedConfig":
        """Inverse of :meth:`to_json`; accepts the JSON string or the
        already-parsed dict."""
        import json

        if isinstance(data, (str, bytes)):
            data = json.loads(data)
        return tunedconfig_from_dict(data)


def _jsonify(obj):
    """Recursively convert numpy scalars / tuples to JSON-native values."""
    if isinstance(obj, dict):
        return {k: _jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonify(v) for v in obj]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.bool_):
        return bool(obj)
    return obj


def tunedconfig_to_dict(cfg: TunedConfig) -> dict:
    """JSON-safe dict form of a TunedConfig (see ``TunedConfig.to_json``)."""
    d = dict(
        strategy=cfg.strategy,
        br=int(cfg.br),
        bc=int(cfg.bc),
        kmax=int(cfg.kmax),
        overlap=bool(cfg.overlap),
        backend=cfg.backend,
        t=int(cfg.t),
        mode=cfg.mode,
        col_split=int(cfg.col_split),
        machine=(
            _jsonify(dataclasses.asdict(cfg.machine))
            if cfg.machine is not None else None
        ),
        predicted=_jsonify(cfg.predicted),
        selection=None,
    )
    if cfg.selection is not None:
        from repro_torch.adaptive.select_t import tselection_to_dict

        d["selection"] = tselection_to_dict(cfg.selection)
    return d


def tunedconfig_from_dict(d: dict) -> TunedConfig:
    """Inverse of :func:`tunedconfig_to_dict`."""
    sel = d.get("selection")
    if sel is not None:
        from repro_torch.adaptive.select_t import tselection_from_dict

        sel = tselection_from_dict(sel)
    m = d.get("machine")
    return TunedConfig(
        strategy=str(d["strategy"]),
        br=int(d["br"]),
        bc=int(d["bc"]),
        kmax=int(d["kmax"]),
        overlap=bool(d["overlap"]),
        backend=str(d["backend"]),
        t=int(d["t"]),
        mode=str(d["mode"]),
        col_split=int(d.get("col_split", 1)),
        machine=MachineParams(**m) if m is not None else None,
        predicted=d.get("predicted") or {},
        selection=sel,
    )


# --------------------------------------------------------------- tile model
def _rebased_local(pm: PartitionedMatrix):
    """Per-rank (indptr, indices, n_local) with halo columns rebased to rmax
    — exactly the operand :func:`repro_torch.sparse.spmbv.make_distributed_spmbv`
    converts to Block-ELL
    (same helper, so the layouts cannot drift apart)."""
    return [(ptr, ix, n_local) for ptr, ix, _dat, n_local in rebased_local_csr(pm)]


def tile_stats(pm: PartitionedMatrix, br: int, bc: int) -> TileStats:
    """Block-structure histogram of the per-rank [own ‖ halo] blocks for one
    candidate tile shape; mirrors the stacked Block-ELL conversion, so
    ``TileStats.kmax`` equals the kmax
    :func:`repro_torch.sparse.spmbv.make_distributed_spmbv` will pad to.
    Cached on the partition: the stats do not depend on t, and ``select_t``
    tunes once per candidate t (O(nnz) host work per tile).
    """
    _fill_tile_stats(pm, [(br, bc)])
    return pm.__dict__["_tile_stats_cache"][(br, bc)]


def _fill_tile_stats(pm: PartitionedMatrix, tiles) -> None:
    """Compute the :func:`tile_stats` of every tile in ``tiles`` not cached
    on ``pm`` yet, rebasing each rank's block once for all of them."""
    cache = pm.__dict__.setdefault("_tile_stats_cache", {})
    todo = [tuple(tile) for tile in tiles if tuple(tile) not in cache]
    if not todo:
        return
    rmax = pm.part.max_local_rows
    halo_max = max((len(h) for h in pm.halo_sources), default=0)
    n_cols = rmax + halo_max
    kmax, nnz_max = dict.fromkeys(todo, 1), 0
    for ptr, ix, n_local in _rebased_local(pm):
        for br, bc in todo:
            kmax[(br, bc)] = max(kmax[(br, bc)],
                                 count_block_ell_tiles(ptr, ix, n_local, n_cols, br, bc))
        nnz_max = max(nnz_max, len(ix))
    for br, bc in todo:
        nbr = max(1, (rmax + br - 1) // br)
        cache[(br, bc)] = TileStats(br=br, bc=bc, nbr=nbr, kmax=kmax[(br, bc)], nnz=nnz_max)


def tile_time(ts: TileStats, t: int, machine: MachineParams) -> float:
    """Modeled seconds for one local Block-ELL SpMBV on the busiest rank.

    Flop term: 2·stored·t at the machine's γ.  Memory term (when the machine
    declares ``R_mem``): one pass over the stored tiles, one (bc, t) slice of
    V per tile, one output write — the kernel's streaming traffic.
    """
    t_flop = machine.gamma * 2.0 * ts.stored * t
    if machine.R_mem:
        f = machine.f
        nbytes = (
            ts.stored * f
            + ts.nbr * ts.kmax * _pad8(ts.bc) * t * f
            + ts.nbr * _pad8(ts.br) * t * f
        )
        return max(t_flop, nbytes / machine.R_mem)
    return t_flop


def _csr_time(nnz_max: int, t: int, machine: MachineParams) -> float:
    """Modeled seconds for the scalar-gather CSR local SpMBV (jnp backend):
    2·nnz·t flops; per-nonzero traffic of one value, one int32 index, and one
    t-wide gathered row."""
    t_flop = machine.gamma * 2.0 * nnz_max * t
    if machine.R_mem:
        nbytes = nnz_max * (machine.f + 4 + t * machine.f)
        return max(t_flop, nbytes / machine.R_mem)
    return t_flop


# ------------------------------------------------------------ overlap model
def _interior_fraction(pm: PartitionedMatrix, block_row: int) -> float:
    """Interior share of the busiest rank's nonzeros under the block-row
    split the overlapped schedule will actually use.  Cached on the
    partition: the grid argmin probes each block_row many times and the
    split is O(p·nnz) host work."""
    cache = pm.__dict__.setdefault("_interior_frac_cache", {})
    if block_row in cache:
        return cache[block_row]
    io = interior_boundary_split(pm, block_row=block_row)
    worst_nnz, worst_frac = -1, 1.0
    for r, (int_rows, _bnd_rows) in enumerate(io):
        counts = np.diff(np.asarray(pm.local_indptr[r]))
        nnz = int(counts.sum())
        frac = float(counts[int_rows].sum()) / max(nnz, 1)
        if nnz > worst_nnz:
            worst_nnz, worst_frac = nnz, frac
    cache[block_row] = worst_frac
    return worst_frac


def _split_overhead(pm: PartitionedMatrix, t: int, machine: MachineParams) -> float:
    """Cost of the interior/boundary schedule itself: the output block vector
    is assembled through two scatter-adds instead of one contiguous write,
    plus one extra kernel-launch latency."""
    rmax = pm.part.max_local_rows
    extra = 2.0 * machine.alpha_l
    if machine.R_mem:
        extra += 2.0 * rmax * t * machine.f / machine.R_mem
    return extra


# ------------------------------------------------------- structural model
def structural_exchange_cost(
    plan, machine: MachineParams, width: int | None = None
) -> float:
    """Executor-structural seconds for one halo exchange of ``plan``.

    cost = dispatches × dispatch_overhead + wire_bytes/R_b + local_bytes/R_bl
    — the ROADMAP model of what the shard_map executor actually does: a
    fixed number of pack/ppermute/unpack ops (the packed executor's
    O(phases) dispatch count) plus the bytes they move.  ``width`` evaluates
    the byte terms at a reduced active width (``plan.at_width`` payloads).
    """
    disp = plan.dispatch_count(packed=True) * machine.dispatch_overhead
    wire = plan.wire_bytes(machine.f, width=width) / machine.R_b
    local = plan.local_bytes(machine.f, width=width) / machine.R_bl
    return disp + wire + local


def structural_exchange_costs(
    pm: PartitionedMatrix,
    t: int,
    machine: MachineParams,
    n_nodes: int,
    ppn: int,
    strategies=STRATEGIES,
) -> tuple[dict[str, float], dict]:
    """Compile each strategy's actual plan and charge the structural model.

    Returns ``(seconds per strategy, plans per strategy)`` — the plans are
    reused so the winning config's ``col_split`` matches what the builder
    will produce.
    """
    from repro_torch.core.node_aware import build_exchange_plan

    plans = {
        s: build_exchange_plan(pm, n_nodes, ppn, s, t=t, machine=machine)
        for s in strategies
    }
    costs = {s: structural_exchange_cost(p, machine) for s, p in plans.items()}
    return costs, plans


# --------------------------------------------------------------- prediction
def predict_config(
    pm: PartitionedMatrix,
    g: CommGraph,
    t: int,
    machine: MachineParams,
    strategy: str,
    ts: TileStats,
    overlap: bool,
    backend: str = "pallas",
    t_exch: float | None = None,
) -> float:
    """Modeled seconds for one distributed SpMBV under a full config.

    ``t_exch`` overrides the exchange term (e.g. with the structural model's
    plan-derived cost); default is the analytic max-rate p2p model.
    """
    if t_exch is None:
        t_exch = t_p2p(g, t, machine, strategy)
    if backend == "pallas":
        t_local = tile_time(ts, t, machine)
        block_row = ts.br
    else:
        t_local = _csr_time(ts.nnz, t, machine)
        block_row = 1
    if not overlap:
        return t_exch + t_local
    frac = _interior_fraction(pm, block_row)
    t_int, t_bnd = t_local * frac, t_local * (1.0 - frac)
    return max(t_int, t_exch) + t_bnd + _split_overhead(pm, t, machine)


def _resolve_machine(
    machine: MachineParams | None, ppn: int, dtype: np.dtype | None
) -> MachineParams:
    machine = machine or H100
    updates: dict = {"ppn": ppn}
    if dtype is not None:
        updates["f"] = np.dtype(dtype).itemsize
    return dataclasses.replace(machine, **updates)


def tune(
    a,
    t: int,
    machine: MachineParams | None = None,
    n_nodes: int | None = None,
    ppn: int | None = None,
    *,
    pm: PartitionedMatrix | None = None,
    mesh=None,
    backend: str = "pallas",
    mode: str = "model",
    tiles=DEFAULT_TILES,
    dtype=None,
) -> TunedConfig:
    """Jointly select (strategy, tile shape, overlap) for ``a`` at width t.

    ``mode="model"`` is pure host work over the paper's analytic performance
    models; ``mode="model:structural"`` replaces the exchange term with the
    executor-structural model (compiles each strategy's actual plan and
    charges dispatches + moved bytes — the right ranking on host/TPU
    backends, see module docstring); ``mode="measure"`` times the candidate
    configs on ``mesh`` (required) with setup-time microbenchmarks — the
    calibration path when the machine constants are in doubt.  ``machine``
    defaults to the H100 parameter set (the reference's to its TPU-v5e
    set); its byte width ``f`` is re-derived from the matrix dtype.
    """
    if mesh is not None and (n_nodes is None or ppn is None):
        n_nodes, ppn = mesh.shape
    if n_nodes is None or ppn is None:
        raise ValueError("tune() needs a mesh or explicit (n_nodes, ppn)")
    p = n_nodes * ppn
    pm = pm or partition_csr(a, p)
    if dtype is None:
        dtype = pm.comms[0].dtype if pm.comms else None
    machine = _resolve_machine(machine, ppn, dtype)

    if mode == "measure":
        from repro_torch.tune.microbench import tune_measured

        if mesh is None:
            raise ValueError('tune(mode="measure") needs a mesh to time on')
        return tune_measured(
            a, mesh, t, backend=backend, tiles=tiles, machine=machine, pm=pm
        )
    if mode not in ("model", "model:structural"):
        raise ValueError(f"unknown tune mode {mode!r}")
    structural = mode == "model:structural"

    g = build_comm_graph(pm, ppn=ppn)
    rmax = pm.part.max_local_rows
    if backend == "pallas":
        cand_tiles = [(br, bc) for br, bc in tiles if br <= rmax and bc <= rmax]
        cand_tiles = cand_tiles or [(8, 8)]
    else:
        cand_tiles = [(8, 8)]  # tile shape is irrelevant for the CSR backend
    _fill_tile_stats(pm, cand_tiles)
    stats = {tile: tile_stats(pm, *tile) for tile in cand_tiles}

    plans = None
    if structural:
        exch, plans = structural_exchange_costs(pm, t, machine, n_nodes, ppn)
    else:
        exch = {s: t_p2p(g, t, machine, s) for s in STRATEGIES}

    grid: dict[str, float] = {}
    best, best_time = None, math.inf
    for strategy in STRATEGIES:
        for tile in cand_tiles:
            for overlap in (False, True):
                sec = predict_config(
                    pm, g, t, machine, strategy, stats[tile], overlap,
                    backend, t_exch=exch[strategy],
                )
                grid[f"{strategy}/{tile[0]}x{tile[1]}/"
                     f"{'overlap' if overlap else 'blocking'}"] = sec
                if sec < best_time:
                    best, best_time = (strategy, tile, overlap), sec
    strategy, tile, overlap = best

    col_split = 1
    if strategy == "optimal":
        if plans is not None:
            col_split = plans["optimal"].col_split
        else:
            from repro_torch.core.node_aware import _auto_col_split, to_node_rows

            col_split = _auto_col_split(to_node_rows(pm, ppn), t, machine, ppn)

    predicted = {
        "p2p": dict(exch),
        "local": {
            f"{br}x{bc}": tile_time(st, t, machine)
            for (br, bc), st in stats.items()
        },
        "grid": grid,
        "best": best_time,
    }
    if structural:
        predicted["plan_stats"] = {
            s: dict(
                dispatches=pl.dispatch_count(packed=True),
                wire_bytes=pl.wire_bytes(machine.f),
                local_bytes=pl.local_bytes(machine.f),
            )
            for s, pl in plans.items()
        }
    return TunedConfig(
        strategy=strategy,
        br=tile[0],
        bc=tile[1],
        kmax=stats[tile].kmax,
        overlap=overlap,
        backend=backend,
        t=t,
        mode=mode,
        col_split=col_split,
        machine=machine,
        predicted=predicted,
    )


# ------------------------------------------------- iteration-scheme ranking
def method_sync_cost(
    method: str,
    t: int,
    p: int,
    machine: MachineParams,
    *,
    s: int = 1,
    reorth: bool = False,
    t_spmbv_window: float = 0.0,
) -> float:
    """Synchronization seconds charged per *effective* iteration of a scheme.

    Reads the collective accounting the :class:`~repro_torch.core.methods.
    MethodSpec` itself declares (psums per block, payload floats, iterations
    per block), so the cost model and the mesh's ``psum`` counter count the
    same collectives:

    * classic   — 2 psums of t² + 3t² floats; exactly the paper's eq. (3.1)
      collective term (``t_collective``), by construction.
    * pipelined — psum #1 (t²) stays on the critical path; psum #2 (3t²) is
      data-independent of the SpMBV, so only its spill past the exchange +
      interior-compute window (``t_spmbv_window``) is charged.
    * sstep     — 2 (+1 with reorth) psums of (st)²-sized payloads amortized
      over s iterations.
    """
    from repro_torch.core.methods import get_method
    from repro_torch.core.models import t_collective_n

    spec = get_method(method)
    if spec.overlaps_gram:
        hidden = t_collective_n(p, machine, 1, 3 * t * t)
        return t_collective_n(p, machine, 1, t * t) + max(
            0.0, hidden - t_spmbv_window
        )
    return t_collective_n(
        p, machine, spec.psums_per_block(s, reorth),
        spec.psum_payload_floats(t, s, reorth),
    ) / spec.iters_per_block(s)


def _method_local_flops(method: str, counts, *, s: int = 1, reorth: bool = False) -> float:
    """Non-SpMBV local flops per effective iteration of a scheme.

    classic is eq. (3.3) minus its SpMBV term; pipelined adds the AZ
    recurrence (two (t, t) products against (n/p, t) blocks); sstep charges
    the (st)-wide Gram/projection/factorization work of one block — the
    classic terms at width st, plus the two-block A-projection (four
    (n/p, st)·(st, st) products) and the wider fused gram1 — divided by s.
    """
    from repro_torch.core.ecg import ECGOperationCounts

    base = counts.total_flops - counts.spmbv_flops
    npp = counts.n / counts.p
    if method == "classic":
        return base
    if method == "pipelined":
        return base + 4 * npp * counts.t**2
    if method == "sstep":
        st = s * counts.t
        wide = ECGOperationCounts(n=counts.n, nnz=counts.nnz, p=counts.p, t=st)
        per_block = (
            wide.total_flops - wide.spmbv_flops
            + 8 * npp * st**2  # V/AV -= P a + P₂ b  (two-block A-projection)
            + 2 * npp * st**2  # gram1 is (3st, st), not (st, st)
        )
        if reorth:
            per_block += 6 * npp * st**2  # second gram + two TRSMs
        return per_block / s
    raise ValueError(f"unknown method {method!r}")


def rank_methods(
    a,
    t: int,
    machine: MachineParams | None = None,
    n_nodes: int = 1,
    ppn: int = 1,
    *,
    s: int = 2,
    reorth: bool = False,
    pm: PartitionedMatrix | None = None,
    backend: str = "jnp",
    mode: str = "model:structural",
    methods: tuple[str, ...] = ("classic", "pipelined", "sstep"),
) -> tuple[str, dict[str, dict[str, float]]]:
    """Rank the iteration schemes by modeled per-effective-iteration seconds.

    Runs :func:`tune` once for the SpMBV term (exchange + local product under
    the winning (strategy, tile, overlap) config — also the overlap window
    the pipelined scheme hides its packed Gram reduction in), then charges
    each scheme its :func:`method_sync_cost` and :func:`_method_local_flops`.
    Returns ``(best, table)`` with per-method ``{sync_s, spmbv_s, local_s,
    iter_s, s}`` rows.  The ranking is per effective iteration: convergence
    per iteration is method-independent to first order (all three schemes
    walk the same enlarged Krylov space), so the cheapest iteration wins —
    the caveat being s-step's slightly weaker A-orthogonality at large s.
    """
    from repro_torch.core.ecg import ECGOperationCounts

    tuned = tune(
        a, t, machine=machine, n_nodes=n_nodes, ppn=ppn, pm=pm,
        backend=backend, mode=mode,
    )
    machine = tuned.machine
    p = n_nodes * ppn
    counts = ECGOperationCounts(n=a.shape[0], nnz=a.nnz, p=p, t=t)
    spmbv_s = float(tuned.predicted["best"])
    table: dict[str, dict[str, float]] = {}
    for m in methods:
        ms = s if m == "sstep" else 1
        mro = reorth if m == "sstep" else False
        sync = method_sync_cost(
            m, t, p, machine, s=ms, reorth=mro, t_spmbv_window=spmbv_s
        )
        local = machine.gamma * _method_local_flops(m, counts, s=ms, reorth=mro)
        table[m] = dict(
            sync_s=sync, spmbv_s=spmbv_s, local_s=local,
            iter_s=sync + spmbv_s + local, s=ms,
        )
    best = min(table, key=lambda m: table[m]["iter_s"])
    return best, table
