"""Sparse-matrix substrate: containers and generators (port of ``repro.sparse``)."""

from repro_torch.sparse.csr import BSRMatrix, CSRMatrix, csr_spmbv, csr_spmv, csr_to_bsr
from repro_torch.sparse.matrices import (
    EXAMPLE_2_1,
    dg_laplace_2d,
    fd_laplace_2d,
    fd_laplace_3d,
    random_spd,
)

__all__ = [
    "CSRMatrix",
    "BSRMatrix",
    "csr_to_bsr",
    "csr_spmv",
    "csr_spmbv",
    "dg_laplace_2d",
    "fd_laplace_2d",
    "fd_laplace_3d",
    "random_spd",
    "EXAMPLE_2_1",
]
