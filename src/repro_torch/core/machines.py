"""Machine parameter sets for the paper's communication models.

Port of ``repro/core/machines.py``, copied value for value.  These are
*inputs* to the paper's models (Table 1): Blue Waters and Lassen constants
are estimates consistent with the published max-rate literature, the
TPU-v5e mapping (chip = process, pod = node) uses public v5e specs, and
``HOST`` describes forced host devices.  None of them is a measurement of
the H100 this port runs on; they matter here because the nodal-optimal
exchange plan's byte model (``eager_cutoff``, ``f``) decides its message
splitting and ``col_split``, so plans equal the reference's only if these
values do.  H100 parameters come with tuning (ROADMAP.md queue 1 item 9).
All rates in bytes/second, latencies in seconds.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MachineParams:
    name: str
    alpha: float        # inter-node latency (s)
    alpha_l: float      # intra-node latency (s)
    R_N: float          # NIC injection rate (B/s) per node
    R_b: float          # per-process network transport rate (B/s)
    R_bl: float         # intra-node (shared-memory) transport rate (B/s)
    ppn: int            # default processes per node
    gamma: float        # seconds per flop (inverse per-core flop rate)
    eager_cutoff: int   # rendezvous-protocol switch (B) — §4.3 cutoff
    f: int = 8          # bytes per float
    R_mem: float = 0.0  # local memory bandwidth (B/s) per process; 0 = flop-bound model
    dispatch_overhead: float = 0.0  # seconds per executor dispatch (pack /
    #                                 unpack / ppermute op)

    def with_ppn(self, ppn: int) -> "MachineParams":
        return dataclasses.replace(self, ppn=ppn)


#: Cray XE6, 3D-torus Gemini, 2 AMD Interlagos/node (paper §3).
BLUE_WATERS = MachineParams(
    name="BlueWaters",
    alpha=2.0e-6,
    alpha_l=6.0e-7,
    R_N=5.8e9,
    R_b=2.7e9,
    R_bl=5.0e9,
    ppn=16,
    gamma=1.0 / 10.4e9,
    eager_cutoff=8192,
    R_mem=4.0e9,
    dispatch_overhead=2.0e-6,
)

#: IBM Power9 + EDR InfiniBand (paper §4.3).
LASSEN = MachineParams(
    name="Lassen",
    alpha=1.1e-6,
    alpha_l=3.5e-7,
    R_N=12.5e9,
    R_b=3.1e9,
    R_bl=14.0e9,
    ppn=40,
    gamma=1.0 / 15.0e9,
    eager_cutoff=16384,
    R_mem=8.0e9,
    dispatch_overhead=1.5e-6,
)

#: TPU v5e mapping of the paper's hierarchy: chip ↔ process, pod ↔ node.
TPU_V5E_POD = MachineParams(
    name="TPUv5e",
    alpha=1.0e-5,
    alpha_l=1.0e-6,
    R_N=2.5e10,
    R_b=1.25e10,
    R_bl=4.5e10,
    ppn=256,
    gamma=1.0 / 197e12,
    eager_cutoff=65536,
    f=4,
    R_mem=819e9,
    dispatch_overhead=2.0e-6,
)

#: Forced-host-device executor (tests, laptops).
HOST = MachineParams(
    name="Host",
    alpha=5.0e-7,
    alpha_l=2.0e-7,
    R_N=8.0e9,
    R_b=4.0e9,
    R_bl=8.0e9,
    ppn=4,
    gamma=1.0 / 5.0e9,
    eager_cutoff=8192,
    R_mem=8.0e9,
    dispatch_overhead=1.5e-5,
)

MACHINES = {m.name: m for m in (BLUE_WATERS, LASSEN, TPU_V5E_POD, HOST)}
