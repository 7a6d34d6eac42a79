"""CSR and BSR sparse-matrix containers backed by torch tensors.

Port of ``repro/sparse/csr.py``.  The containers are plain frozen dataclasses
of tensors; :meth:`CSRMatrix.from_numpy` carries an operator built by the
reference (or anything else holding CSR arrays) onto a device.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.kernels.dispatch import resolve_device


@dataclasses.dataclass(frozen=True)
class CSRMatrix:
    """Compressed-sparse-row matrix.

    indptr:  (n_rows + 1,) int32
    indices: (nnz,) int32 column ids
    data:    (nnz,) values
    shape:   (n_rows, n_cols)
    """

    indptr: torch.Tensor
    indices: torch.Tensor
    data: torch.Tensor
    shape: tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def device(self) -> torch.device:
        return self.data.device

    @functools.cached_property
    def offsets(self) -> torch.Tensor:
        """``indptr`` as int64, the segment offsets of the row sums."""
        return self.indptr.long()

    @functools.cached_property
    def row_ids(self) -> torch.Tensor:
        """Per-nonzero row index (int32), expanded once and kept."""
        return _expand_rows(self.indptr, self.nnz)

    def to(self, device) -> "CSRMatrix":
        device = torch.device(device)
        if device == self.device:
            return self
        return CSRMatrix(
            self.indptr.to(device), self.indices.to(device),
            self.data.to(device), self.shape,
        )

    def numpy(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Host copies of (indptr, indices, data)."""
        return (
            self.indptr.cpu().numpy(), self.indices.cpu().numpy(),
            self.data.cpu().numpy(),
        )

    def todense(self) -> torch.Tensor:
        """Dense materialization (tests / small problems only)."""
        n, m = self.shape
        dense = torch.zeros(n * m, dtype=self.data.dtype, device=self.device)
        flat = self.row_ids.long() * m + self.indices.long()
        return dense.index_add_(0, flat, self.data).reshape(n, m)

    @classmethod
    def from_numpy(cls, indptr, indices, data, shape, device="cuda") -> "CSRMatrix":
        """CSR arrays (numpy, or anything ``np.asarray`` takes) -> device.

        Index arrays become int32; ``data`` keeps its dtype.  The arrays
        are copied, so the matrix never aliases the caller's buffers.
        """
        dev = resolve_device(device)
        return cls(
            indptr=torch.as_tensor(np.array(indptr, np.int32), device=dev),
            indices=torch.as_tensor(np.array(indices, np.int32), device=dev),
            data=torch.as_tensor(np.array(data), device=dev),
            shape=(int(shape[0]), int(shape[1])),
        )


def _expand_rows(indptr: torch.Tensor, nnz: int) -> torch.Tensor:
    """indptr -> per-nonzero row index (int32)."""
    n = indptr.shape[0] - 1
    rows = torch.arange(n, dtype=torch.int32, device=indptr.device)
    return torch.repeat_interleave(rows, torch.diff(indptr), output_size=nnz)


def csr_spmv(a: CSRMatrix, v: torch.Tensor) -> torch.Tensor:
    """w = A @ v for a single vector: gather, multiply, row sums."""
    return csr_spmbv(a, v[:, None])[:, 0]


def csr_spmbv(a: CSRMatrix, v: torch.Tensor) -> torch.Tensor:
    """W = A @ V for a block vector V of shape (n, t).

    One gather of t-wide rows per nonzero, then a segment sum over each
    row's nonzeros in storage order.  The sum uses no atomics (on CUDA one
    thread owns an output and walks its row), so two calls on the same
    inputs are bit-identical on the card as on the CPU.
    """
    prod = a.data[:, None] * v.index_select(0, a.indices)  # (nnz, t)
    # indptr is monotone by construction, so the op's own checks (a host
    # sync per call on CUDA) are skipped
    return torch.segment_reduce(prod, "sum", offsets=a.offsets, axis=0, unsafe=True)


@dataclasses.dataclass(frozen=True)
class BSRMatrix:
    """Block-sparse-row matrix with fixed (br x bc) dense tiles.

    block_indptr:  (n_block_rows + 1,) int32
    block_indices: (n_blocks,) int32 block-column ids
    blocks:        (n_blocks, br, bc) values
    shape:         (n_rows, n_cols) — multiples of (br, bc)
    """

    block_indptr: torch.Tensor
    block_indices: torch.Tensor
    blocks: torch.Tensor
    shape: tuple[int, int]


def csr_to_bsr(a: CSRMatrix, br: int, bc: int, pad_rows: bool = True) -> BSRMatrix:
    """Convert CSR -> BSR with (br x bc) tiles (host-side, numpy).

    Zero-pads the matrix up to tile multiples; tiles with any nonzero become
    dense blocks.  The result lies on ``a``'s device.
    """
    indptr, indices, data = a.numpy()
    indices = indices.astype(np.int64)
    n, m = a.shape
    n_pad = (n + br - 1) // br * br if pad_rows else n
    m_pad = (m + bc - 1) // bc * bc
    nbr, nbc = n_pad // br, m_pad // bc

    # bucket nonzeros by (block_row, block_col)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    key = (rows // br) * nbc + indices // bc
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    first = np.ones(len(key_s), dtype=bool)
    first[1:] = key_s[1:] != key_s[:-1]
    uniq = key_s[first]
    tile_of = np.cumsum(first) - 1  # tile id of every sorted nonzero
    blocks = np.zeros((len(uniq), br, bc), dtype=data.dtype)
    blocks[tile_of, (rows % br)[order], (indices % bc)[order]] = data[order]

    block_indptr = np.zeros(nbr + 1, dtype=np.int64)
    np.add.at(block_indptr[1:], uniq // nbc, 1)
    dev = a.device
    return BSRMatrix(
        block_indptr=torch.as_tensor(np.cumsum(block_indptr).astype(np.int32), device=dev),
        block_indices=torch.as_tensor((uniq % nbc).astype(np.int32), device=dev),
        blocks=torch.as_tensor(blocks, device=dev),
        shape=(n_pad, m_pad),
    )
