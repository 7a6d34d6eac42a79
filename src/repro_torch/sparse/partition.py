"""Row-wise partitioning of CSR matrices + communication-graph extraction.

Port of ``repro/sparse/partition.py``; every array is equal to the
reference's.  The n x n matrix is partitioned row-wise across p processes,
contiguous rows per process; vectors share the row distribution (paper §3).
The local matrix splits into *on-process* and *off-process* blocks (§2.2,
Fig 2.2); the off-process block induces the point-to-point communication
pattern (who needs which remote vector rows).

All of this is host-side numpy, run once: :func:`partition_csr` takes the
port's :class:`~repro_torch.sparse.csr.CSRMatrix` on any device and works on
host copies of its arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.sparse.csr import CSRMatrix


@dataclasses.dataclass(frozen=True)
class RowPartition:
    """Contiguous row partition of n rows over p processes."""

    n: int
    p: int

    def __post_init__(self):
        assert self.p >= 1

    @property
    def starts(self) -> np.ndarray:
        # paper: "each process contains at most ceil(n/p) contiguous rows"
        base, rem = divmod(self.n, self.p)
        counts = np.full(self.p, base, dtype=np.int64)
        counts[:rem] += 1
        return np.concatenate([[0], np.cumsum(counts)])

    def owner_of(self, rows: np.ndarray) -> np.ndarray:
        return np.searchsorted(self.starts, rows, side="right") - 1

    def local_range(self, rank: int) -> tuple[int, int]:
        s = self.starts
        return int(s[rank]), int(s[rank + 1])

    @property
    def max_local_rows(self) -> int:
        return int(np.max(np.diff(self.starts)))


@dataclasses.dataclass
class ProcessComm:
    """Per-process communication metadata for the halo exchange.

    recv_rows[q]: global row ids this process needs from process q
    send_rows[q]: global row ids this process must send to process q
    """

    rank: int
    recv_rows: dict[int, np.ndarray]
    send_rows: dict[int, np.ndarray]
    dtype: np.dtype = np.dtype(np.float64)  # value dtype of the matrix/vectors

    @property
    def n_recv_msgs(self) -> int:
        return len(self.recv_rows)

    @property
    def n_send_msgs(self) -> int:
        return len(self.send_rows)

    def send_bytes(self, t: int = 1, f: int | None = None) -> int:
        """Total bytes this process sends for a block vector of width t
        (``f``, bytes per scalar, defaults to the matrix's value itemsize)."""
        f = self.dtype.itemsize if f is None else f
        return sum(len(v) for v in self.send_rows.values()) * t * f


@dataclasses.dataclass
class PartitionedMatrix:
    """A CSR matrix partitioned row-wise with halo-exchange metadata."""

    a: CSRMatrix
    part: RowPartition
    comms: list[ProcessComm]
    # per-rank local CSR pieces (host numpy arrays):
    local_indptr: list[np.ndarray]
    local_indices: list[np.ndarray]  # remapped: [0, n_local) local, >= n_local halo
    local_data: list[np.ndarray]
    halo_sources: list[np.ndarray]  # global row ids backing the halo slots, ordered

    @property
    def p(self) -> int:
        return self.part.p


def interior_boundary_split(
    pm: PartitionedMatrix, block_row: int = 1
) -> list[tuple[np.ndarray, np.ndarray]]:
    """Per rank, (interior_rows, boundary_rows) — local row ids in [0, n_local).

    A row is *interior* when every nonzero column is on-process (< n_local in
    the remapped local ids), i.e. its SpMBV output never waits on the halo
    exchange.  ``block_row > 1`` classifies whole block rows (groups of
    ``block_row`` consecutive local rows): a block row is boundary as soon as
    any of its rows touches the halo, which keeps the split aligned with the
    Block-ELL tile rows.  The two sets partition [0, n_local) exactly.
    """
    out = []
    for r in range(pm.p):
        lo, hi = pm.part.local_range(r)
        n_local = hi - lo
        ptr = np.asarray(pm.local_indptr[r])
        ix = np.asarray(pm.local_indices[r])
        has_halo = np.zeros(n_local, dtype=bool)
        rows_of_nnz = np.repeat(np.arange(n_local, dtype=np.int64), np.diff(ptr))
        np.logical_or.at(has_halo, rows_of_nnz, ix >= n_local)
        if block_row > 1 and n_local:
            blocks = np.arange(n_local) // block_row
            block_has_halo = np.zeros(int(blocks[-1]) + 1, dtype=bool)
            np.logical_or.at(block_has_halo, blocks, has_halo)
            has_halo = block_has_halo[blocks]
        out.append((np.nonzero(~has_halo)[0], np.nonzero(has_halo)[0]))
    return out


def rebased_local_csr(
    pm: PartitionedMatrix,
) -> list[tuple[np.ndarray, np.ndarray, np.ndarray, int]]:
    """Per rank, (indptr, indices, data, n_local) with halo columns rebased
    from n_local-relative to rmax-relative ids — the [own ‖ halo] operand
    layout the distributed executor pads vectors to."""
    rmax = pm.part.max_local_rows
    out = []
    for r in range(pm.p):
        lo, hi = pm.part.local_range(r)
        n_local = hi - lo
        ix = np.asarray(pm.local_indices[r], dtype=np.int64)
        ix = np.where(ix >= n_local, ix - n_local + rmax, ix)
        out.append(
            (np.asarray(pm.local_indptr[r]), ix, np.asarray(pm.local_data[r]), n_local)
        )
    return out


def partition_csr(a: CSRMatrix, p: int) -> PartitionedMatrix:
    """Partition ``a`` row-wise over p processes; extract the comm graph.

    The halo (off-process) columns of each local block are remapped to local
    ids ``n_local + k`` where k indexes the (sorted, deduplicated) remote rows
    this process receives — the standard "ghost" layout.
    """
    indptr, indices, data = a.numpy()
    indptr = indptr.astype(np.int64)
    indices = indices.astype(np.int64)
    part = RowPartition(a.shape[0], p)
    starts = part.starts

    recv_rows_per_rank: list[dict[int, np.ndarray]] = []
    halo_sources: list[np.ndarray] = []
    local_indptr, local_indices, local_data = [], [], []
    for r in range(p):
        lo, hi = starts[r], starts[r + 1]
        s, e = indptr[lo], indptr[hi]
        cols = indices[s:e]
        vals = data[s:e]
        lptr = indptr[lo : hi + 1] - s
        off_mask = (cols < lo) | (cols >= hi)
        remote = np.unique(cols[off_mask])
        owners = part.owner_of(remote)
        recv: dict[int, np.ndarray] = {}
        for q in np.unique(owners):
            recv[int(q)] = remote[owners == q]
        recv_rows_per_rank.append(recv)
        halo_sources.append(remote)  # sorted by global id

        # remap columns: local -> [0, n_local); remote -> n_local + halo slot
        n_local = hi - lo
        remap = np.empty(len(cols), dtype=np.int32)
        remap[~off_mask] = (cols[~off_mask] - lo).astype(np.int32)
        remap[off_mask] = (n_local + np.searchsorted(remote, cols[off_mask])).astype(np.int32)
        local_indptr.append(lptr.astype(np.int64))
        local_indices.append(remap)
        local_data.append(vals)

    # send side: transpose the recv graph
    send_rows_per_rank: list[dict[int, np.ndarray]] = [dict() for _ in range(p)]
    for r in range(p):
        for q, rows in recv_rows_per_rank[r].items():
            send_rows_per_rank[q][r] = rows

    val_dtype = np.dtype(data.dtype)
    comms = [
        ProcessComm(
            rank=r,
            recv_rows=recv_rows_per_rank[r],
            send_rows=send_rows_per_rank[r],
            dtype=val_dtype,
        )
        for r in range(p)
    ]
    return PartitionedMatrix(
        a=a,
        part=part,
        comms=comms,
        local_indptr=local_indptr,
        local_indices=local_indices,
        local_data=local_data,
        halo_sources=halo_sources,
    )
