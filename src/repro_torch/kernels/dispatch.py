"""Device rules shared by the kernel ops and the entry points.

A kernel op launches its hand-written CUDA kernel when its operands are
CUDA tensors and runs its plain torch version when they are CPU tensors.
There is no third case and no fallback: a CUDA operand that the kernel
cannot take raises, it is never quietly sent to the plain version.

Entry points (generators, ``CSRMatrix.from_numpy``, ``ECGSolver.build``, the
CLI) take a ``device`` that defaults to ``"cuda"`` and raise when CUDA is
missing, so a CPU run is always one the caller asked for.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Validate an entry point's ``device`` argument."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be a CUDA device or 'cpu', got {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port's plain "
            "torch versions on the CPU"
        )
    return dev


def use_kernel(op_name: str, *tensors: torch.Tensor) -> bool:
    """True when every operand is a CUDA tensor (launch the kernel), False
    when every operand is a CPU tensor (run the plain version)."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(
        f"{op_name}: operands must all be CUDA tensors or all CPU tensors, "
        f"got devices {sorted(kinds)}"
    )
