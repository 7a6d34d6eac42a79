"""Roofline analysis from traced dry-run cells.

Port of ``repro/analysis/roofline.py``.  Three terms per (arch x shape x
mesh) cell, in seconds, priced with one machine's constants
(:class:`~repro_torch.core.machines.RooflineMachine`: the reference's TPU
v5e targets, or the H100's own, measured by ``tools/calibrate_h100.py``)::

    compute    = FLOPs_dev / peak_FLOP/s (the peak of the matmuls' dtype)
    memory     = HBM_bytes_dev / HBM_bw
    collective = collective_bytes_dev / link_bw (None: link rate unmeasured)

The reference reads a compiled XLA program (``cost_analysis()`` and the HLO
text).  The port traces one process's step instead
(:mod:`repro_torch.launch.dryrun`), and :func:`cost_from_trace` reads what
the trace counted:

  * FLOPs: ``torch.utils.flop_counter.FlopCounterMode``'s total (matmuls,
    attention, convolutions; elementwise work is not counted, as in XLA's
    figure for the dot-dominated steps);
  * HBM bytes: the sum of every aten op's input and output bytes (views
    excluded, :class:`OpBytes`), an unfused upper bound: each op reads and
    writes its tensors once, as if nothing were fused, as the reference's
    CPU-backend "bytes accessed" is;
  * collective bytes: the calls :meth:`~repro_torch.launch.mesh.LMMesh.
    record_calls` collected, each mapped onto the reference's five names
    and counted by its rule (the larger of the result's and the operand's
    bytes).

The memory term is therefore a cost estimate and no lower bound on time
(a fused or chunked step moves fewer bytes), and so is ``bound_s``: a
share of it can pass 1.  All figures are per device (the traced rank's);
global figures multiply by the chip count.  A trace counts every layer, so the port needs no
extrapolation; :meth:`CellCost.extrapolate` is kept for the reference's
1- and 2-unit method and for the tests that hold the two equal.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.core.machines import H100_ROOFLINE, V5E_ROOFLINE, RooflineMachine

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2, "f8e4m3": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}

_COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

#: the LM mesh's ops (``LMMesh._raw``) by the reference's names
_OP_NAMES = {
    "all_gather": "all-gather",
    "all_reduce": "all-reduce",
    "reduce_scatter": "reduce-scatter",
    "all_to_all": "all-to-all",
    "ppermute": "collective-permute",
}

#: the roofline machines by the dry-run's ``--machine`` names
MACHINES = {"h100": H100_ROOFLINE, "v5e": V5E_ROOFLINE}


def _shape_bytes(dtype: str, dims: str) -> int:
    b = _DTYPE_BYTES.get(dtype)
    if b is None:
        return 0
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * b


def _payload(op: str, ranks, result_bytes: int) -> tuple[str, int]:
    """A recorded call's reference name and its bytes by the reference's
    rule, max(result bytes, operand bytes): a tiled all-gather's operand is
    its result over the group, a reduce-scatter's its result times the
    group, the others' their result."""
    name = _OP_NAMES.get(op)
    if name is None:
        raise ValueError(f"unknown collective {op!r} (known: {sorted(_OP_NAMES)})")
    n = len(ranks)
    operand = {"all-gather": result_bytes // n, "reduce-scatter": result_bytes * n}.get(name, result_bytes)
    return name, max(int(result_bytes), int(operand))


def collective_bytes(records) -> dict[str, int]:
    """Per-collective payload bytes (per device) of the recorded calls
    (op, the group's global ranks, result bytes), by the reference's rule
    (:func:`_payload`): exact for all-reduce, the gathered result for
    all-gather, the full operand for reduce-scatter."""
    out = {k: 0 for k in _COLLECTIVES}
    for op, ranks, nbytes in records:
        name, b = _payload(op, ranks, nbytes)
        out[name] += b
    return out


def count_collective_ops(records) -> dict[str, int]:
    """Calls by the reference's collective names."""
    out = {k: 0 for k in _COLLECTIVES}
    for op, ranks, nbytes in records:
        out[_payload(op, ranks, nbytes)[0]] += 1
    return out


@dataclasses.dataclass
class CellCost:
    """Per-device costs for one dry-run cell."""

    flops: float
    hbm_bytes: float
    coll_bytes: float
    coll_breakdown: dict[str, float]

    @staticmethod
    def extrapolate(c1: "CellCost", c2: "CellCost", n_units: float) -> "CellCost":
        """cost(L) = c1 + (n_units - 1) * (c2 - c1)   (1- and 2-unit traces)."""
        d = lambda a, b: a + (n_units - 1) * (b - a)
        return CellCost(
            flops=d(c1.flops, c2.flops),
            hbm_bytes=d(c1.hbm_bytes, c2.hbm_bytes),
            coll_bytes=d(c1.coll_bytes, c2.coll_bytes),
            coll_breakdown={
                k: d(c1.coll_breakdown.get(k, 0), c2.coll_breakdown.get(k, 0))
                for k in set(c1.coll_breakdown) | set(c2.coll_breakdown)
            },
        )


class OpBytes(TorchDispatchMode):
    """Inside, ``nbytes`` adds every aten op's input and output tensor
    bytes (ops that return a view of an input move nothing and are not
    counted): the memory term's unfused upper bound."""

    def __init__(self):
        super().__init__()
        self.nbytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace == "aten" and not func.is_view:
            self.nbytes += sum(t.numel() * t.element_size()
                               for t in tree_flatten((args, kwargs, out))[0]
                               if isinstance(t, torch.Tensor))
        return out


def cost_from_trace(flops: float, hbm_bytes: float, records) -> CellCost:
    """A traced step's costs: ``flops`` the FLOP counter's total,
    ``hbm_bytes`` :class:`OpBytes`' sum, ``records`` the collective calls
    (module docstring)."""
    cb = collective_bytes(records)
    return CellCost(
        flops=float(flops),
        hbm_bytes=float(hbm_bytes),
        coll_bytes=float(sum(cb.values())),
        coll_breakdown={k: float(v) for k, v in cb.items()},
    )


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float | None   # None: the machine's link rate is unmeasured
    model_flops_global: float
    hlo_flops_global: float
    chips: int
    peak_flops: float = V5E_ROOFLINE.peak_flops()
    machine: RooflineMachine = V5E_ROOFLINE

    @property
    def dominant(self) -> str:
        terms = dict(compute=self.compute_s, memory=self.memory_s, collective=self.collective_s)
        terms = {k: v for k, v in terms.items() if v is not None}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(t for t in (self.compute_s, self.memory_s, self.collective_s) if t is not None)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / traced FLOPs — remat/padding/redundancy waste detector."""
        return self.model_flops_global / self.hlo_flops_global if self.hlo_flops_global else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline achieved if the cell ran at its
        bound: (useful compute time) / (time the dominant term costs)."""
        ideal = self.model_flops_global / (self.chips * self.peak_flops)
        return ideal / self.bound_s if self.bound_s else 0.0

    def as_dict(self):
        out = dict(
            compute_s=self.compute_s,
            memory_s=self.memory_s,
            collective_s=self.collective_s,
            dominant=self.dominant,
            model_flops_global=self.model_flops_global,
            hlo_flops_global=self.hlo_flops_global,
            useful_flops_ratio=self.useful_flops_ratio,
            roofline_fraction=self.roofline_fraction,
            chips=self.chips,
        )
        if self.machine is not V5E_ROOFLINE:  # the reference's records name no machine
            out |= dict(machine=self.machine.name, peak_flops=self.peak_flops,
                        hbm_bw=self.machine.hbm_bw,
                        link_bw=self.machine.link_bw if self.machine.link_bw else "unmeasured")
        return out


def roofline_from_cost(cost: CellCost, chips: int, model_flops_global: float,
                       machine: RooflineMachine = V5E_ROOFLINE, dtype: str = "bfloat16") -> Roofline:
    """The three terms of ``cost`` priced with ``machine``'s constants, the
    compute term at its matmul peak for ``dtype`` (``"bfloat16"``,
    ``"float32"`` with TF32 off, ``"tfloat32"``); with no link rate the
    collective term is None."""
    peak = machine.peak_flops(dtype)
    return Roofline(
        compute_s=cost.flops / peak,
        memory_s=cost.hbm_bytes / machine.hbm_bw,
        collective_s=cost.coll_bytes / machine.link_bw if machine.link_bw else None,
        model_flops_global=model_flops_global,
        hlo_flops_global=cost.flops * chips,
        chips=chips,
        peak_flops=peak,
        machine=machine,
    )


def matmul_dtype(dtype: torch.dtype) -> str:
    """The peak a step in ``dtype`` runs its matmuls at: ``"bfloat16"`` or
    ``"float32"`` (the port's matmuls run with TF32 off)."""
    names = {torch.bfloat16: "bfloat16", torch.float32: "float32"}
    if dtype not in names:
        raise ValueError(f"no roofline peak for {dtype}")
    return names[dtype]


def model_flops(cfg, kind: str, seq: int, batch: int) -> float:
    """MODEL_FLOPS: 6·N·D for training, 2·N·D for inference (per step over
    ``batch`` tokens for decode), with N_active for MoE."""
    n = cfg.active_param_count()
    if kind == "train":
        return 6.0 * n * seq * batch
    if kind == "prefill":
        return 2.0 * n * seq * batch
    if kind == "decode":
        return 2.0 * n * batch  # one token per sequence
    raise ValueError(kind)
