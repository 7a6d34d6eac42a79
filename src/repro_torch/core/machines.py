"""Machine parameter sets for the paper's communication models.

Port of ``repro/core/machines.py``, copied value for value, plus
:data:`H100`.  The copied sets are *inputs* to the paper's models (Table
1): Blue Waters and Lassen constants are estimates consistent with the
published max-rate literature, the TPU-v5e mapping (chip = process, pod =
node) uses public v5e specs, and ``HOST`` describes forced host devices.
None of them is a measurement of the H100 this port runs on; they matter
here because the nodal-optimal exchange plan's byte model
(``eager_cutoff``, ``f``) decides its message splitting and ``col_split``,
so plans equal the reference's only if these values do.  :data:`H100` holds
the card's own constants, measured by ``tools/calibrate_h100.py``; the
tuner defaults to it.  All rates in bytes/second, latencies in seconds.

The roofline's constants (:mod:`repro_torch.analysis.roofline`): the
reference's ``V5E_*`` (TPU v5e targets, copied so that the port can price
a cell the reference's way) and :data:`H100_ROOFLINE`, the card's dense
matmul rates by dtype, its memory rate and its link rate, each measured by
``tools/calibrate_h100.py``.
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

#: The reference's four sets, by name (:data:`H100` is the port's own).
MACHINES = {m.name: m for m in (BLUE_WATERS, LASSEN, TPU_V5E_POD, HOST)}


#: One NVIDIA H100 running the port's distributed solve on a
#: ``VirtualMesh(2, 4)``: a rank is a slice of the card, a "node" a group of
#: 4 slices; a rotation (``mesh.ppermute``) is a device-local copy, and an
#: exchange replays as one CUDA graph.  Every constant was measured by
#: ``tools/calibrate_h100.py`` on an "NVIDIA H100 80GB HBM3, 700.00 W" card
#: (``nvidia-smi --query-gpu=name,power.limit``); a second run on the same
#: card agreed within 2%.  Later runs, each on a fresh machine with such a
#: card, read the rates within 1%, alpha and dispatch_overhead up to 30%
#: higher and eager_cutoff up to 55% higher.  No TPU or data-sheet number
#: stands in for one.
H100 = MachineParams(
    name="H100",
    alpha=1.23e-6,          # a near-empty "node" rotation in a CUDA graph (8 B a rank)
    alpha_l=1.40e-6,        # the same along "proc"
    R_N=1.314e12,           # derived: a node's ranks share the card's memory, R_N = R_b
    R_b=1.314e12,           # "node" rotation bytes / time, median over 64 MiB and 256 MiB
    R_bl=1.311e12,          # the same along "proc"
    ppn=4,                  # ranks per "node" of the VirtualMesh(2, 4)
    gamma=1.79e-14,         # s per f64 flop of an 8192² torch.matmul (55.8 TFLOP/s)
    eager_cutoff=207_419,   # derived: bytes a rank at which a "node" rotation takes 2·alpha
    f=8,                    # float64 solver data
    R_mem=2.443e12,         # 1 GiB device copy: bytes read + written / time
    dispatch_overhead=1.52e-6,  # measure_dispatch_overhead: per-op slope of a captured chain
)


#: The H100's dense-matmul rates (FLOP/s) of an 8192² ``torch.matmul`` in
#: bfloat16, in float32 with TF32 off and with it on, measured by
#: ``tools/calibrate_h100.py`` (``matmul_flops``) on the card of
#: :data:`H100`'s note.
H100_BF16_FLOPS = 7.754e+14
H100_F32_FLOPS = 5.137e+13
H100_TF32_FLOPS = 4.02e+14
#: The NCCL all-reduce bus bandwidth between cards (``link_bw``): not measured
#: (one card has no link).
H100_LINK_BW = None

# Roofline hardware constants (per chip): the reference's TPU v5e targets.
V5E_PEAK_FLOPS = 197e12       # bf16 FLOP/s
V5E_HBM_BW = 819e9            # B/s
V5E_ICI_BW = 5.0e10           # B/s per link


@dataclasses.dataclass(frozen=True)
class RooflineMachine:
    """One chip's roofline constants: the dense-matmul peak in FLOP/s by
    the dtype the matmuls run in (``"bfloat16"``, ``"float32"`` with TF32
    off, ``"tfloat32"``), the memory rate (bytes read + written a second)
    and the link rate (B/s; None where it is not measured)."""

    name: str
    matmul_flops: dict
    hbm_bw: float
    link_bw: float | None

    def peak_flops(self, dtype: str = "bfloat16") -> float:
        if dtype not in self.matmul_flops:
            raise ValueError(f"{self.name} has no measured matmul rate for {dtype!r} "
                             f"(has {sorted(self.matmul_flops)})")
        return self.matmul_flops[dtype]


#: The reference's roofline machine: one peak (bf16), the v5e's HBM and
#: ICI rates.
V5E_ROOFLINE = RooflineMachine("v5e", {"bfloat16": V5E_PEAK_FLOPS}, V5E_HBM_BW, V5E_ICI_BW)

#: The H100's roofline constants, measured by ``tools/calibrate_h100.py``
#: (an 8192² ``torch.matmul`` in each dtype, replayed in a CUDA graph;
#: ``R_mem`` is :data:`H100`'s 1 GiB copy) on an "NVIDIA H100 80GB HBM3,
#: 700.00 W" card.  The link rate is an NCCL all-reduce's bus bandwidth,
#: which needs two cards or more; None until such a machine measures it.
H100_ROOFLINE = RooflineMachine(
    name="H100",
    matmul_flops={
        "bfloat16": H100_BF16_FLOPS,
        "float32": H100_F32_FLOPS,
        "tfloat32": H100_TF32_FLOPS,
    },
    hbm_bw=H100.R_mem,
    link_bw=H100_LINK_BW,
)
