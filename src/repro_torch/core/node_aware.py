"""Static exchange plans for node-aware SpMBV communication.

Port of ``repro/core/node_aware.py`` (host numpy; every plan array is equal
to the reference's).  Each strategy (standard / 2-step / 3-step /
nodal-optimal) compiles, at setup time, into a common IR — a sequence of
:class:`ExchangeStep` rounds — that the executor in
``repro_torch.sparse.spmbv`` replays with the mesh's ``ppermute``.  The
communication *schedule* is decided once from the matrix partition (the
analogue of building the MPI node-aware communicator), and the device
program is a fixed pipeline of gather → permute → scatter rounds.

Topology mapping: device grid = ("node", "proc") = (slow-tier groups,
fast-tier peers).

Round semantics, per device d with local vector x (rows it owns):
    src buffer  = x | stage
    buf         = src[gather_idx[d]]                  (c rows)
    buf         = ppermute(buf, axis, rotation offset)
    dst buffer  = dst[scatter_pos[d]] = buf           (halo | stage)
Padding rows use gather index 0 and scatter into a trailing dump slot, so
every device executes identical static shapes.

Wide-halo payload splitting (``col_split``): with enlarging factor t each
halo row is a t·f-byte payload, so for large t a single row can exceed the
§4.3 chunking granularity.  The nodal-optimal strategy may therefore compile
its plan in *column segments*: every row is split into ``col_split`` equal
column slices, indices address (row, segment) slots, and the executor
reshapes ``(rows, t) -> (rows·col_split, t/col_split)`` around the exchange.

Width-aware slicing (``plan.at_width``): a cached sub-plan whose row/column
segments are recomputed for exactly ``t_active`` columns (used by the
width-1 initial residual here, and by adaptive width later).

Phase grouping (``plan.phases``): consecutive steps sharing
``(axis, src, dst)`` form one *phase* — the unit the packed-buffer executor
dispatches: one ``halo_pack`` into a contiguous send buffer, one ppermute
per nonzero rotation offset, one ``halo_unpack``.  Grouping is validated at
build time: within a phase no gathered slot is also written, so hoisting all
gathers ahead of all scatters is equivalent to the per-step replay.

:func:`simulate_plan` replays any plan on the host in numpy — the bit-exact
oracle used by the tests.
"""

from __future__ import annotations

import dataclasses
import math
from collections import defaultdict

import numpy as np

from repro_torch.core.machines import MachineParams
from repro_torch.sparse.partition import PartitionedMatrix


@dataclasses.dataclass
class ExchangeStep:
    axis: str        # "node" | "proc" | "flat" (both axes, node-major)
    offset: int      # rotation offset along `axis` (0 = local move, no comm)
    src: str         # "x" | "stage"
    dst: str         # "halo" | "stage"
    gather_idx: np.ndarray   # (p, c) int32
    scatter_pos: np.ndarray  # (p, c) int32

    @property
    def width(self) -> int:
        return self.gather_idx.shape[1]


@dataclasses.dataclass
class ExchangePhase:
    """Consecutive steps sharing (axis, src, dst) — one packed-buffer round.

    The packed executor gathers all of a phase's segments into ONE contiguous
    send buffer (``gather_idx``), ppermutes each step's slice (``bounds``
    delimit them; ``offsets[i] == 0`` slices move locally), and scatters the
    whole buffer once (``scatter_pos``).
    """

    axis: str
    src: str
    dst: str
    offsets: tuple[int, ...]      # per constituent step
    bounds: tuple[int, ...]       # cumulative widths; step i = [bounds[i], bounds[i+1])
    gather_idx: np.ndarray        # (p, W) — concatenated step gathers
    scatter_pos: np.ndarray       # (p, W) — concatenated step scatters

    @property
    def width(self) -> int:
        return self.gather_idx.shape[1]


@dataclasses.dataclass
class ExchangePlan:
    strategy: str
    n_nodes: int
    ppn: int
    steps: list[ExchangeStep]
    halo_size: int   # max halo slots over devices (excl. dump slot), in segments
    stage_size: int  # max stage slots over devices (excl. dump slot), in segments
    col_split: int = 1  # column segments per row (1 = whole-row exchange)
    t: int = 1          # block width the plan was compiled for
    # width-slicing machinery: rebuild closure attached by build_exchange_plan
    # (captures the partition-derived structures) + per-width sub-plan cache
    _rebuild: object = dataclasses.field(default=None, repr=False, compare=False)
    _width_cache: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False
    )
    _phases: list = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def p(self) -> int:
        return self.n_nodes * self.ppn

    @property
    def halo_rows(self) -> int:
        """Halo size in *row* units (halo_size counts column segments)."""
        return self.halo_size // self.col_split

    # ----------------------------------------------------- width slicing
    def at_width(self, t_active: int) -> "ExchangePlan":
        """Bit-exact sub-plan for ``t_active`` active columns (cached).

        Row/column segments are recomputed so one exchange moves exactly
        ``t_active`` columns per halo row.  When the existing ``col_split``
        divides ``t_active`` the index arrays are already exact at that
        width and are shared (a re-slice is then just bookkeeping); otherwise
        the segment expansion is re-derived at ``t_active`` via the rebuild
        closure — reusing the partition structures, never re-partitioning.
        """
        t_active = int(t_active)
        if t_active < 1:
            raise ValueError(f"t_active must be >= 1, got {t_active}")
        if t_active == self.t:
            return self
        hit = self._width_cache.get(t_active)
        if hit is not None:
            return hit
        if t_active % self.col_split == 0:
            # segments now carry t_active/col_split columns each; every
            # gather/scatter index is unchanged, so share the step arrays
            # (and the computed phases — executors detect the identity and
            # reuse their device-resident copies)
            sub = dataclasses.replace(
                self, t=t_active, _rebuild=self._rebuild, _width_cache={},
                _phases=self.phases,
            )
        elif self._rebuild is not None:
            sub = self._rebuild(t_active)
        else:
            raise ValueError(
                f"cannot slice a col_split={self.col_split} plan to width "
                f"{t_active} without its rebuild closure (plan not built by "
                "build_exchange_plan?)"
            )
        self._width_cache[t_active] = sub
        return sub

    # ----------------------------------------------------- phase grouping
    @property
    def phases(self) -> list[ExchangePhase]:
        """Steps grouped into packed-buffer phases (computed once, validated).

        Consecutive steps sharing (axis, src, dst) merge: their gather and
        scatter arrays concatenate along the width axis.  Validation asserts
        the within-phase hazard-freedom the packed executor relies on: for
        stage-writing phases, no slot gathered by the phase is also written
        by it, so gathering everything before scattering anything replays
        identically to the per-step order.
        """
        if self._phases is not None:
            return self._phases
        groups: list[tuple[tuple, list[ExchangeStep]]] = []
        for s in self.steps:
            key = (s.axis, s.src, s.dst)
            if groups and groups[-1][0] == key:
                groups[-1][1].append(s)
            else:
                groups.append((key, [s]))
        phases = []
        for (axis, src, dst), ss in groups:
            bounds = [0]
            for s in ss:
                bounds.append(bounds[-1] + s.width)
            gather = np.concatenate([s.gather_idx for s in ss], axis=1)
            scatter = np.concatenate([s.scatter_pos for s in ss], axis=1)
            if src == dst == "stage":
                dump = self.stage_size
                for d in range(self.p):
                    written = set(scatter[d][scatter[d] < dump].tolist())
                    read = set(gather[d].tolist())
                    assert not (written & read), (
                        f"phase ({axis},{src}->{dst}) has a within-phase "
                        f"read/write hazard on device {d}; packed execution "
                        "would reorder it"
                    )
            phases.append(
                ExchangePhase(
                    axis=axis, src=src, dst=dst,
                    offsets=tuple(s.offset for s in ss),
                    bounds=tuple(bounds),
                    gather_idx=gather, scatter_pos=scatter,
                )
            )
        self._phases = phases
        return phases

    # ------------------------------------------------- structural accounting
    def wire_bytes(self, f: int = 8, width: int | None = None) -> int:
        """Bytes one exchange moves over links (nonzero-offset rounds).

        ``width`` defaults to the plan's compiled width; the executor pads
        the applied width up to a multiple of ``col_split``, and so does
        this count — the number a sliced plan reports is exactly what its
        ppermute buffers carry.
        """
        width = self.t if width is None else width
        segw = -(-width // self.col_split)
        total = 0
        for s in self.steps:
            if s.offset == 0:
                continue
            total += int((s.scatter_pos < self._dump(s)).sum()) * segw * f
        return total

    def local_bytes(self, f: int = 8, width: int | None = None) -> int:
        """Bytes moved by offset-0 (local staging) rounds of one exchange."""
        width = self.t if width is None else width
        segw = -(-width // self.col_split)
        total = 0
        for s in self.steps:
            if s.offset != 0:
                continue
            total += int((s.scatter_pos < self._dump(s)).sum()) * segw * f
        return total

    def dispatch_count(self, packed: bool = True) -> int:
        """Executor dispatches per exchange.

        The packed executor issues one ``halo_pack`` + one ``halo_unpack``
        per *phase* plus one ppermute per nonzero rotation offset; the
        historical per-step executor issued a gather and a scatter per
        *step* on top of the same ppermutes.
        """
        n_perm = sum(1 for s in self.steps if s.offset)
        if packed:
            return 2 * len(self.phases) + n_perm
        return 2 * len(self.steps) + n_perm

    def comm_rows(self) -> dict[str, int]:
        """Rows moved per tier (for tests vs CommGraph invariants).

        Counts are in row units: segment moves of a col-split plan are
        divided back by ``col_split`` (totals per tier are always whole rows
        even when an individual split chunk carries partial rows).
        """
        inter = intra = 0
        for s in self.steps:
            if s.offset == 0:
                continue
            moved = int((s.scatter_pos < self._dump(s)).sum())
            if s.axis == "proc":
                intra += moved
            elif s.axis == "node":
                inter += moved
            else:  # flat rotation: offset decides if it crosses nodes
                src = np.arange(self.p)
                dst = (src + s.offset) % self.p
                crosses = (src // self.ppn) != (dst // self.ppn)
                per_dev = (s.scatter_pos < self._dump(s)).sum(axis=1)
                inter += int(per_dev[crosses].sum())
                intra += int(per_dev[~crosses].sum())
        cs = self.col_split
        return dict(inter=int(round(inter / cs)), intra=int(round(intra / cs)))

    def _dump(self, s: ExchangeStep) -> int:
        return self.halo_size if s.dst == "halo" else self.stage_size


# --------------------------------------------------------------------------
# message construction helpers
# --------------------------------------------------------------------------
class _Msg:
    """One logical message: rows moving src_dev -> dst_dev in a given phase."""

    __slots__ = ("src_dev", "dst_dev", "src_kind", "dst_kind", "rows", "stage_keys")

    def __init__(self, src_dev, dst_dev, src_kind, dst_kind, rows, stage_keys=None):
        self.src_dev = src_dev
        self.dst_dev = dst_dev
        self.src_kind = src_kind
        self.dst_kind = dst_kind
        self.rows = rows                       # global row ids (np.ndarray)
        self.stage_keys = stage_keys           # per-row stage keys when src/dst is stage


def to_node_rows(pm: PartitionedMatrix, ppn: int) -> list[dict[int, np.ndarray]]:
    """Per owner process, the dedup'd row sets destined for each *other* node
    — the 2-step message units that drive every node-aware strategy and the
    §4.3 byte model."""
    node_of = lambda d: d // ppn
    out: list[dict[int, np.ndarray]] = []
    for i in range(pm.p):
        acc: dict[int, set] = defaultdict(set)
        for q, rows in pm.comms[i].send_rows.items():
            if node_of(q) != node_of(i):
                acc[node_of(q)].update(rows.tolist())
        out.append({b: np.array(sorted(s), dtype=np.int64) for b, s in acc.items()})
    return out


def _auto_col_split(to_node, t: int, machine: MachineParams, ppn: int) -> int:
    """§4.3 byte model at sub-row granularity.

    A (owner proc → dst node) unit larger than the rendezvous cutoff is split
    into ~cutoff-sized chunks across the fast tier; with row granularity the
    smallest chunk is one t·f-byte row, so a unit with few-but-wide rows may
    have fewer rows than its chunk target.  Return the smallest column-split
    factor (a divisor of t) that restores enough grains for every unit.
    """
    unit = t * machine.f
    cs = 1
    for d in to_node:
        for rows in d.values():
            size = len(rows) * unit
            if len(rows) and size >= machine.eager_cutoff:
                n_chunks = min(math.ceil(size / machine.eager_cutoff), ppn)
                cs = max(cs, math.ceil(n_chunks / len(rows)))
    cs = min(cs, t)
    while t % cs:
        cs += 1
    return cs


def build_exchange_plan(
    pm: PartitionedMatrix,
    n_nodes: int,
    ppn: int,
    strategy: str = "standard",
    t: int = 1,
    machine: MachineParams | None = None,
    col_split: int | None = None,
) -> ExchangePlan:
    """Compile the halo exchange of ``pm`` into rounds for ``strategy``.

    ``t`` and ``machine`` matter only for the nodal-optimal strategy (its
    conglomerate/split cutoff is byte-based, per §4.3).  ``col_split``
    overrides the byte-model decision to split every t-wide row into column
    segments (nodal-optimal only; must divide t; ``None`` = automatic).
    """
    p = pm.p
    assert p == n_nodes * ppn, (p, n_nodes, ppn)
    node_of = lambda d: d // ppn
    lrank = lambda d: d % ppn

    starts = pm.part.starts
    halo_sources = pm.halo_sources

    # dedup'd (owner proc -> dst node) row sets — drives both the node-aware
    # message construction and the col-split byte model (standard needs none)
    to_node = to_node_rows(pm, ppn) if strategy != "standard" else []

    cs = 1
    if strategy == "optimal":
        machine = machine or _default_machine()
        cs = col_split if col_split else _auto_col_split(to_node, t, machine, ppn)
        assert t % cs == 0, f"col_split {cs} must divide t={t}"

    # All indices are in *segment* units: global row r splits into segments
    # r·cs + j, j in [0, cs); contiguous segments of a row stay adjacent in
    # the halo so the executor can reshape back to rows.  cs == 1 degenerates
    # to the plain row-granular plan.
    def expand(rows) -> np.ndarray:
        rows = np.asarray(rows, dtype=np.int64)
        if cs == 1:
            return rows
        return (rows[:, None] * cs + np.arange(cs, dtype=np.int64)).reshape(-1)

    def local_index(dev, seg):
        return int(seg - starts[dev] * cs)

    def halo_slot(dev, seg):
        r, j = divmod(int(seg), cs)
        return int(np.searchsorted(halo_sources[dev], r)) * cs + j

    stage_maps: list[dict] = [dict() for _ in range(p)]

    def stage_slot(dev, key, create):
        m = stage_maps[dev]
        if key not in m:
            if not create:
                raise KeyError(f"stage key {key} missing on dev {dev}")
            m[key] = len(m)
        return m[key]

    # ---- per-strategy message lists (phases in execution order) -------------
    phases: list[tuple[str, list[_Msg]]] = []

    if strategy == "standard":
        msgs = []
        for i in range(p):
            for q, rows in pm.comms[i].send_rows.items():
                msgs.append(_Msg(i, q, "x", "halo", rows))
        phases.append(("flat", msgs))

    else:
        # on-node direct exchange (common to all node-aware strategies)
        onnode = []
        for i in range(p):
            for q, rows in pm.comms[i].send_rows.items():
                if node_of(q) == node_of(i):
                    onnode.append(_Msg(i, q, "x", "halo", expand(rows)))

        # which procs on node B need row r (for final redistribution)
        def dest_procs(b_node, row, owner):
            res = []
            for q in range(b_node * ppn, (b_node + 1) * ppn):
                if owner in pm.comms[q].recv_rows and row in _recv_sets[q][owner]:
                    res.append(q)
            return res

        _recv_sets = [
            {src: set(rows.tolist()) for src, rows in pm.comms[q].recv_rows.items()}
            for q in range(p)
        ]

        if strategy == "2step":
            inter, redist = [], []
            for i in range(p):
                a = node_of(i)
                for b, rows in to_node[i].items():
                    j = b * ppn + lrank(i)  # paired process
                    keys = [("s", int(r)) for r in rows]
                    inter.append(_Msg(i, j, "x", "stage", rows, stage_keys=keys))
                    # local redistribution from j's stage to final halos
                    per_dst: dict[int, list[int]] = defaultdict(list)
                    for r in rows:
                        for q in dest_procs(b, int(r), i):
                            per_dst[q].append(int(r))
                    for q, rr in per_dst.items():
                        rr = np.array(rr, dtype=np.int64)
                        kk = [("s", int(r)) for r in rr]
                        redist.append(_Msg(j, q, "stage", "halo", rr, stage_keys=kk))
            phases = [("proc", onnode), ("node", inter), ("proc", redist)]

        elif strategy == "3step":
            gather_msgs, inter, redist = [], [], []
            for a in range(n_nodes):
                dsts = sorted(
                    {b for i in range(a * ppn, (a + 1) * ppn) for b in to_node[i]}
                )
                for bi, b in enumerate(dsts):
                    h = a * ppn + bi % ppn            # gathering proc on A for dst B
                    g = b * ppn + lrank(h)            # receiving proc on B (paired)
                    rows_all, owners = [], []
                    for i in range(a * ppn, (a + 1) * ppn):
                        if b in to_node[i]:
                            rows_all.extend(int(r) for r in to_node[i][b])
                            owners.extend([i] * len(to_node[i][b]))
                    keys = [("g", b, r) for r in rows_all]
                    # phase 0: owners stage rows on the handler h
                    per_owner: dict[int, tuple[list, list]] = defaultdict(lambda: ([], []))
                    for r, o, k in zip(rows_all, owners, keys):
                        per_owner[o][0].append(r)
                        per_owner[o][1].append(k)
                    for o, (rr, kk) in per_owner.items():
                        gather_msgs.append(
                            _Msg(o, h, "x", "stage", np.array(rr), stage_keys=kk)
                        )
                    # phase 1: handler -> paired receiver on B
                    keys_r = [("r", r) for r in rows_all]
                    inter.append(
                        _Msg(h, g, "stage", "stage", np.array(rows_all), stage_keys=list(zip(keys, keys_r)))
                    )
                    # phase 2: receiver redistributes on B
                    per_dst: dict[int, tuple[list, list]] = defaultdict(lambda: ([], []))
                    for r, o in zip(rows_all, owners):
                        for q in dest_procs(b, r, o):
                            per_dst[q][0].append(r)
                            per_dst[q][1].append(("r", r))
                    for q, (rr, kk) in per_dst.items():
                        redist.append(_Msg(g, q, "stage", "halo", np.array(rr), stage_keys=kk))
            phases = [("proc", onnode), ("proc", gather_msgs), ("node", inter), ("proc", redist)]

        elif strategy == "optimal":
            cutoff = machine.eager_cutoff
            unit = t * machine.f // cs  # bytes per column segment
            gather_msgs, inter, redist = [], [], []
            for a in range(n_nodes):
                procs = list(range(a * ppn, (a + 1) * ppn))
                # 2-step units in segment grains: (owner, dst node, segs)
                units = [
                    (i, b, expand(to_node[i][b])) for i in procs for b in to_node[i]
                ]
                by_dst: dict[int, list[tuple[int, np.ndarray]]] = defaultdict(list)
                for i, b, segs in units:
                    by_dst[b].append((i, segs))
                buffers = []  # (size_bytes, dst_node, [(owner, segs)])
                for b, owners in by_dst.items():
                    small = [(i, s) for i, s in owners if len(s) * unit < cutoff]
                    large = [(i, s) for i, s in owners if len(s) * unit >= cutoff]
                    if small:
                        buffers.append(
                            (sum(len(s) for _, s in small) * unit, b, small)
                        )
                    for i, s in large:
                        # split across ~cutoff-sized chunks; with cs > 1 the
                        # grains are sub-row, so chunks of one wide buffer
                        # ride different fast-tier senders
                        n_chunks = min(math.ceil(len(s) * unit / cutoff), ppn)
                        for ch in np.array_split(s, n_chunks):
                            if len(ch):
                                buffers.append((len(ch) * unit, b, [(i, ch)]))
                buffers.sort(key=lambda x: -x[0])
                loads = {i: 0 for i in procs}
                counts = {i: 0 for i in procs}
                for size, b, parts in buffers:
                    s_dev = min(procs, key=lambda q: (loads[q], counts[q]))
                    loads[s_dev] += size
                    counts[s_dev] += 1
                    g_dev = b * ppn + lrank(s_dev)  # paired receiver (Fig 4.8 step 2)
                    segs_all, owners = [], []
                    for i, ss in parts:
                        segs_all.extend(int(x) for x in ss)
                        owners.extend([i] * len(ss))
                    keys = [("o", b, s) for s in segs_all]
                    per_owner: dict[int, tuple[list, list]] = defaultdict(lambda: ([], []))
                    for s, o, k in zip(segs_all, owners, keys):
                        per_owner[o][0].append(s)
                        per_owner[o][1].append(k)
                    for o, (ss, kk) in per_owner.items():
                        # owner == s_dev stages locally (offset-0 round, no comm)
                        gather_msgs.append(_Msg(o, s_dev, "x", "stage", np.array(ss), stage_keys=kk))
                    keys_r = [("r", s) for s in segs_all]
                    inter.append(
                        _Msg(s_dev, g_dev, "stage", "stage", np.array(segs_all), stage_keys=list(zip(keys, keys_r)))
                    )
                    per_dst: dict[int, tuple[list, list]] = defaultdict(lambda: ([], []))
                    for s, o in zip(segs_all, owners):
                        for q in dest_procs(b, s // cs, o):
                            per_dst[q][0].append(s)
                            per_dst[q][1].append(("r", s))
                    for q, (ss, kk) in per_dst.items():
                        redist.append(_Msg(g_dev, q, "stage", "halo", np.array(ss), stage_keys=kk))
            phases = [("proc", onnode), ("proc", gather_msgs), ("node", inter), ("proc", redist)]
        else:
            raise ValueError(f"unknown strategy {strategy!r}")

    # ---- compile phases; _compile_phase_stage_aware resolves the
    # (src_key, dst_key) pairs carried by stage->stage messages -------------
    steps: list[ExchangeStep] = []
    for axis, msgs in phases:
        msgs = [m for m in msgs if len(m.rows)]
        if not msgs:
            continue
        steps.extend(
            _compile_phase_stage_aware(
                msgs, axis, n_nodes, ppn, local_index, halo_slot, stage_slot
            )
        )

    halo_size = max((len(h) for h in halo_sources), default=0) * cs
    stage_size = max((len(m) for m in stage_maps), default=0)
    # fix dump slots: scatter_pos == -1 -> dump index
    for s in steps:
        dump = halo_size if s.dst == "halo" else stage_size
        s.scatter_pos = np.where(s.scatter_pos < 0, dump, s.scatter_pos)
    # width-slicing rebuild closure: reuses the partition (pm) and machine —
    # at_width only falls back to it when the existing segment granularity
    # cannot express the requested width exactly
    rebuild = lambda w: build_exchange_plan(
        pm, n_nodes, ppn, strategy, t=w, machine=machine, col_split=None
    )
    return ExchangePlan(
        strategy=strategy,
        n_nodes=n_nodes,
        ppn=ppn,
        steps=steps,
        halo_size=halo_size,
        stage_size=stage_size,
        col_split=cs,
        t=t,
        _rebuild=rebuild,
    )


def _compile_phase_stage_aware(msgs, axis, n_nodes, ppn, local_index, halo_slot, stage_slot):
    """Like _compile_phase but handles (src_key, dst_key) pairs for
    stage->stage messages."""
    p = n_nodes * ppn

    def rotation(src, dst):
        if axis == "proc":
            return (dst % ppn - src % ppn) % ppn
        if axis == "node":
            return (dst // ppn - src // ppn) % n_nodes
        return (dst - src) % p

    by_off = defaultdict(list)
    for m in msgs:
        by_off[rotation(m.src_dev, m.dst_dev)].append(m)

    steps = []
    for off in sorted(by_off):
        group = by_off[off]
        per_src = defaultdict(list)
        for m in group:
            per_src[m.src_dev].append(m)
        width = max(sum(len(m.rows) for m in ms) for ms in per_src.values())
        gather = np.zeros((p, width), dtype=np.int32)
        scatter = np.full((p, width), -1, dtype=np.int32)
        for src_dev, ms in per_src.items():
            pos = 0
            for m in ms:
                k = len(m.rows)
                pair_keys = (
                    m.src_kind == "stage"
                    and m.dst_kind == "stage"
                    and m.stage_keys
                    and isinstance(m.stage_keys[0][0], tuple)
                )
                if m.src_kind == "x":
                    gather[src_dev, pos : pos + k] = [
                        local_index(src_dev, int(r)) for r in m.rows
                    ]
                else:
                    src_keys = [kk[0] for kk in m.stage_keys] if pair_keys else m.stage_keys
                    gather[src_dev, pos : pos + k] = [
                        stage_slot(src_dev, key, create=False) for key in src_keys
                    ]
                if m.dst_kind == "halo":
                    scatter[m.dst_dev, pos : pos + k] = [
                        halo_slot(m.dst_dev, int(r)) for r in m.rows
                    ]
                else:
                    dst_keys = [kk[1] for kk in m.stage_keys] if pair_keys else m.stage_keys
                    scatter[m.dst_dev, pos : pos + k] = [
                        stage_slot(m.dst_dev, key, create=True) for key in dst_keys
                    ]
                pos += k
        steps.append(
            ExchangeStep(
                axis=axis,
                offset=off,
                src=group[0].src_kind,
                dst=group[0].dst_kind,
                gather_idx=gather,
                scatter_pos=scatter,
            )
        )
    return steps


def simulate_plan(
    plan: ExchangePlan,
    pm: PartitionedMatrix,
    x: np.ndarray,
    at_width: int | None = None,
) -> list[np.ndarray]:
    """Host-side numpy replay of an ExchangePlan — the bit-exact oracle.

    ``x`` is the global ``(n,)`` or ``(n, t)`` array being exchanged.
    Returns, per device, the halo block ``(len(halo_sources[d]), t)`` the
    device executor's gather → permute → scatter rounds would deliver; a
    correct plan satisfies ``out[d] == x[pm.halo_sources[d]]`` exactly.
    Handles col-split plans (the reshape the executor performs around the
    exchange) and runs without any devices, so tests can verify plans for
    meshes larger than the host.  ``at_width`` replays
    ``plan.at_width(at_width)`` instead — the round-trip check for
    width-sliced sub-plans (``x`` should then carry ``at_width`` columns).
    """
    if at_width is not None:
        plan = plan.at_width(at_width)
    x = np.asarray(x)
    if x.ndim == 1:
        x = x[:, None]
    p, cs = plan.p, plan.col_split
    rmax = pm.part.max_local_rows
    t = x.shape[1]
    tp = -(-t // cs) * cs  # pad width up to a multiple of cs
    w = tp // cs
    xs = np.zeros((p, rmax * cs, w), x.dtype)
    for d in range(p):
        lo, hi = pm.part.local_range(d)
        xl = np.zeros((rmax, tp), x.dtype)
        xl[: hi - lo, :t] = x[lo:hi]
        xs[d] = xl.reshape(rmax * cs, w)
    halo = np.zeros((p, plan.halo_size + 1, w), x.dtype)
    stage = np.zeros((p, plan.stage_size + 1, w), x.dtype)
    ppn, n_nodes = plan.ppn, plan.n_nodes
    for step in plan.steps:
        src = xs if step.src == "x" else stage
        buf = np.stack([src[d][step.gather_idx[d]] for d in range(p)])
        if step.offset:
            recv = np.empty_like(buf)
            for d in range(p):  # device d receives from its rotation source
                if step.axis == "proc":
                    s_dev = (d // ppn) * ppn + (d % ppn - step.offset) % ppn
                elif step.axis == "node":
                    s_dev = ((d // ppn - step.offset) % n_nodes) * ppn + d % ppn
                else:
                    s_dev = (d - step.offset) % p
                recv[d] = buf[s_dev]
            buf = recv
        dst = halo if step.dst == "halo" else stage
        for d in range(p):
            dst[d][step.scatter_pos[d]] = buf[d]
    out = []
    for d in range(p):
        h = halo[d][: plan.halo_size].reshape(-1, tp)[:, :t]
        out.append(h[: len(pm.halo_sources[d])])
    return out


def _default_machine():
    from repro_torch.core.machines import BLUE_WATERS

    return BLUE_WATERS
