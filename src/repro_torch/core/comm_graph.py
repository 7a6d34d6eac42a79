"""Communication-graph statistics for node-aware SpMBV strategies.

Computes, from a row-partitioned sparse matrix and a (p, ppn) process layout,
the exact per-strategy quantities of the paper's Table 1:

    m, s                      — standard (per-process msgs / bytes)
    m_proc→node, s_proc       — 2-step
    m_node→node, s_node→node  — 3-step
    s_node                    — node-injected bytes (equal for 2-/3-step)
    n_opt, s_proc_opt         — nodal-optimal plan (§4.3, Fig 4.8)

Row counts are stored t-independently; byte sizes scale as
``rows * t * f * row_block`` (``row_block`` lets stats be computed on an
element-level graph and scaled to dof-level rows).

This is setup-phase (host/numpy) code, the analogue of building the MPI
communicator; it feeds the performance models (:mod:`repro_torch.core.models`)
and the autotuner (:mod:`repro_torch.tune`).

Port of ``repro/core/comm_graph.py``, line for line: every statistic and
every plan array is equal to the reference's.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.machines import MachineParams
from repro_torch.sparse.partition import PartitionedMatrix


@dataclasses.dataclass
class CommGraph:
    """Raw communication quantities in *row* units (t- and f-independent)."""

    p: int
    ppn: int
    n_nodes: int
    row_block: int  # dof rows per graph row (byte scaling factor)

    # standard (per process): duplicates included
    std_msgs: np.ndarray          # (p,) number of destination processes
    std_rows: np.ndarray          # (p,) rows sent (with duplication)

    # node-deduplicated (per process, per destination node)
    # rows_to_node[i] = {dst_node: n_rows}  (dedup'd across dst procs)
    rows_to_node: list[dict[int, int]]

    # per-node aggregates
    node_pair_rows: dict[tuple[int, int], int]  # (src_node, dst_node) -> rows
    node_injected_rows: np.ndarray              # (n_nodes,) dedup'd inter-node rows

    # ---- derived: standard ----
    @property
    def m_standard(self) -> int:
        return int(self.std_msgs.max()) if self.p > 1 else 0

    @property
    def s_standard_rows(self) -> int:
        return int(self.std_rows.max()) if self.p > 1 else 0

    @property
    def total_standard_rows(self) -> int:
        """Total rows crossing the network (with duplicates) — inter-node only."""
        return self._total_standard_internode

    # ---- derived: 2-step ----
    @property
    def m_proc_to_node(self) -> int:
        return max((len(d) for d in self.rows_to_node), default=0)

    @property
    def s_proc_rows(self) -> int:
        return max((sum(d.values()) for d in self.rows_to_node), default=0)

    # ---- derived: 3-step ----
    @property
    def m_node_to_node(self) -> int:
        """Max number of inter-node buffers sent by any node (one per dst)."""
        per_node: dict[int, int] = {}
        for (a, _b), r in self.node_pair_rows.items():
            if r:
                per_node[a] = per_node.get(a, 0) + 1
        return max(per_node.values(), default=0)

    @property
    def s_node_to_node_rows(self) -> int:
        return max(self.node_pair_rows.values(), default=0)

    @property
    def s_node_rows(self) -> int:
        """Max rows injected by a node (deduplicated — equal for 2-/3-step)."""
        return int(self.node_injected_rows.max()) if len(self.node_injected_rows) else 0

    @property
    def s_proc_3step_rows(self) -> int:
        """Busiest process under 3-step pairing (dst nodes round-robin over
        local ranks)."""
        worst = 0
        for a in range(self.n_nodes):
            dsts = sorted(b for (aa, b), r in self.node_pair_rows.items() if aa == a and r)
            loads = [0] * self.ppn
            for j, b in enumerate(dsts):
                loads[j % self.ppn] += self.node_pair_rows[(a, b)]
            worst = max(worst, max(loads, default=0))
        return worst

    @property
    def total_node_aware_rows(self) -> int:
        """Total deduplicated rows crossing the network (2-step == 3-step)."""
        return sum(self.node_pair_rows.values())


def build_comm_graph(pm: PartitionedMatrix, ppn: int, row_block: int = 1) -> CommGraph:
    p = pm.p
    n_nodes = (p + ppn - 1) // ppn
    node_of = np.arange(p) // ppn

    std_msgs = np.zeros(p, dtype=np.int64)
    std_rows = np.zeros(p, dtype=np.int64)
    rows_to_node: list[dict[int, int]] = []
    node_pair_rows: dict[tuple[int, int], int] = {}
    node_injected = np.zeros(n_nodes, dtype=np.int64)
    total_std_internode = 0

    for i in range(p):
        send = pm.comms[i].send_rows
        std_msgs[i] = len(send)
        std_rows[i] = sum(len(v) for v in send.values())
        a = node_of[i]
        per_node_rows: dict[int, set] = {}
        for q, rows in send.items():
            b = node_of[q]
            if b == a:
                continue
            total_std_internode += len(rows)
            per_node_rows.setdefault(int(b), set()).update(rows.tolist())
        counts = {b: len(s) for b, s in per_node_rows.items()}
        rows_to_node.append(counts)
        for b, c in counts.items():
            node_pair_rows[(int(a), b)] = node_pair_rows.get((int(a), b), 0) + c
            node_injected[a] += c

    g = CommGraph(
        p=p,
        ppn=ppn,
        n_nodes=n_nodes,
        row_block=row_block,
        std_msgs=std_msgs,
        std_rows=std_rows,
        rows_to_node=rows_to_node,
        node_pair_rows=node_pair_rows,
        node_injected_rows=node_injected,
    )
    g._total_standard_internode = total_std_internode  # type: ignore[attr-defined]
    return g


@dataclasses.dataclass
class OptimalPlan:
    """Static nodal-optimal plan (paper §4.3, Fig 4.8) for one (t, cutoff)."""

    t: int
    cutoff: int
    # per-node: list of (dst_node, bytes, kind) buffers; kind in
    # {"conglomerate", "retained", "split"}
    buffers_per_node: list[list[tuple[int, int, str]]]
    # per-process stats
    n_opt: np.ndarray        # (p,) messages injected by each process
    s_proc_opt: np.ndarray   # (p,) bytes injected by each process
    intra_moved: np.ndarray  # (p,) bytes moved on-node to stage buffers

    @property
    def max_msgs(self) -> int:
        return int(self.n_opt.max()) if len(self.n_opt) else 0

    @property
    def max_bytes(self) -> int:
        return int(self.s_proc_opt.max()) if len(self.s_proc_opt) else 0


def build_optimal_plan(g: CommGraph, t: int, machine: MachineParams) -> OptimalPlan:
    """Greedy per-node plan: conglomerate small per-proc messages per dst node,
    split very large node-pair buffers, assign buffers to processes in
    descending size order (least-loaded-first), bounded by eq. (4.4)."""
    f = machine.f
    cutoff = machine.eager_cutoff
    unit = t * f * g.row_block  # bytes per graph row
    p, ppn = g.p, g.ppn
    n_opt = np.zeros(p, dtype=np.int64)
    s_proc = np.zeros(p, dtype=np.int64)
    intra = np.zeros(p, dtype=np.int64)
    buffers_per_node: list[list[tuple[int, int, str]]] = []

    for a in range(g.n_nodes):
        procs = list(range(a * ppn, min((a + 1) * ppn, p)))
        local_ppn = len(procs)
        # 2-step message units from this node: (dst_node, owner_proc, bytes)
        units: list[tuple[int, int, int]] = [
            (b, i, rows * unit)
            for i in procs
            for b, rows in g.rows_to_node[i].items()
        ]
        # group by destination node
        by_dst: dict[int, list[tuple[int, int]]] = {}
        for b, i, size in units:
            by_dst.setdefault(b, []).append((i, size))

        buffers: list[tuple[int, int, str]] = []  # (dst, bytes, kind)
        for b, owners in by_dst.items():
            small = [(i, s) for i, s in owners if s < cutoff]
            large = [(i, s) for i, s in owners if s >= cutoff]
            if small:
                tot = sum(s for _, s in small)
                buffers.append((b, tot, "conglomerate"))
            for i, s in large:
                if s > cutoff:
                    # split across up to local_ppn chunks of >= cutoff bytes
                    n_chunks = min(math.ceil(s / cutoff), local_ppn)
                    chunk = math.ceil(s / n_chunks)
                    left = s
                    while left > 0:
                        buffers.append((b, min(chunk, left), "split"))
                        left -= chunk
                else:
                    buffers.append((b, s, "retained"))
        buffers.sort(key=lambda x: -x[1])
        buffers_per_node.append(buffers)

        # assign descending-size to least-loaded process (Fig 4.8 step 1)
        loads = {i: 0 for i in procs}
        counts = {i: 0 for i in procs}
        moved = {i: 0 for i in procs}
        for b, size, kind in buffers:
            i = min(procs, key=lambda q: (loads[q], counts[q]))
            loads[i] += size
            counts[i] += 1
            # staging: conglomerated/split buffers carry data owned by other
            # procs — count it as intra-node movement to the sender
            if kind in ("conglomerate", "split"):
                moved[i] += size
        for i in procs:
            n_opt[i] = counts[i]
            s_proc[i] = loads[i]
            intra[i] = moved[i]

    return OptimalPlan(
        t=t,
        cutoff=cutoff,
        buffers_per_node=buffers_per_node,
        n_opt=n_opt,
        s_proc_opt=s_proc,
        intra_moved=intra,
    )
