"""Hand-written CUDA kernels for the ECG hot spots (port of ``repro.kernels``).

Each kernel ships as ``csrc/<name>.cu`` (CUDA C++ for sm_90a, built by
:mod:`repro_torch.kernels._build`), ``<dir>/ops.py`` (the wrapper: kernel on
CUDA tensors, plain version on CPU tensors, a ``launches`` counter) and
``<dir>/ref.py`` (the plain torch version).
"""

from repro_torch.kernels.block_trisolve.ops import block_trisolve
from repro_torch.kernels.block_update.ops import block_update, ecg_tail
from repro_torch.kernels.bsr_spmbv.ops import (
    block_ell_arrays,
    block_ell_from_csr,
    block_ell_meta,
    bsr_spmbv,
    bsr_to_block_ell,
    count_block_ell_tiles,
    csr_arrays_to_block_ell,
    make_block_ell_apply,
    make_block_ell_apply_from_arrays,
)
from repro_torch.kernels.chol_apply.ops import chol_apply, drop_mask, rank_apply
from repro_torch.kernels.fused_gram.ops import fused_gram
from repro_torch.kernels.halo_pack.ops import halo_pack, halo_unpack

#: the kernel ops, each with its ``launches`` counter
KERNEL_OPS = (bsr_spmbv, fused_gram, ecg_tail, halo_pack, halo_unpack, block_trisolve,
              block_update, chol_apply, rank_apply, drop_mask)


def launch_counts() -> dict[str, int]:
    """{op name: kernel launches since the last reset}."""
    return {op.__name__: op.launches for op in KERNEL_OPS}


def reset_launch_counts() -> None:
    for op in KERNEL_OPS:
        op.launches = 0


__all__ = [
    "KERNEL_OPS",
    "block_ell_arrays",
    "block_ell_from_csr",
    "block_ell_meta",
    "block_trisolve",
    "block_update",
    "bsr_spmbv",
    "bsr_to_block_ell",
    "chol_apply",
    "count_block_ell_tiles",
    "csr_arrays_to_block_ell",
    "drop_mask",
    "ecg_tail",
    "fused_gram",
    "halo_pack",
    "halo_unpack",
    "launch_counts",
    "make_block_ell_apply",
    "make_block_ell_apply_from_arrays",
    "rank_apply",
    "reset_launch_counts",
]
