"""Sparse-matrix substrate: containers, partitioning, generators (port of
``repro.sparse``; the distributed SpMBV lives in ``repro_torch.sparse.spmbv``)."""

from repro_torch.sparse.csr import BSRMatrix, CSRMatrix, csr_spmbv, csr_spmv, csr_to_bsr
from repro_torch.sparse.matrices import (
    EXAMPLE_2_1,
    SUITE_MATRICES,
    aniso_laplace_2d,
    dg_laplace_2d,
    fd_laplace_2d,
    fd_laplace_3d,
    random_spd,
    scaled_laplace_2d,
    suite_surrogate,
)
from repro_torch.sparse.partition import PartitionedMatrix, RowPartition, partition_csr

__all__ = [
    "CSRMatrix",
    "BSRMatrix",
    "csr_to_bsr",
    "csr_spmv",
    "csr_spmbv",
    "RowPartition",
    "PartitionedMatrix",
    "partition_csr",
    "dg_laplace_2d",
    "fd_laplace_2d",
    "fd_laplace_3d",
    "random_spd",
    "aniso_laplace_2d",
    "scaled_laplace_2d",
    "suite_surrogate",
    "SUITE_MATRICES",
    "EXAMPLE_2_1",
]
