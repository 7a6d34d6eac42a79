"""Content fingerprinting of CSR operators — the registry key.

Port of ``repro/serve/fingerprint.py``: the digest is byte-equal to the
reference's for the same matrix.  It hashes the mathematical content:

* shape and data dtype;
* the row pointer (row lengths);
* column indices and values **canonicalized within each row** — two
  assemblies of the same matrix that emit a row's entries in different
  orders fingerprint identically, while perturbing any single stored value
  changes the key.

blake2b (128-bit digest) over the raw array bytes, with the reference's
widths (int64 row pointer and indices, the data's own dtype).  The port's
CSR may live on the card: the check whether every row's indices are
already non-decreasing runs where the arrays live, and only then are they
copied to the host (the indices widened to int64 first, on the card).
When they are (every operator the repo's generators build), the
within-row sort is the identity and is skipped; the bytes hashed are the
same.  The hash reads the host arrays' buffers directly.  What remains is
blake2b itself, one pass over ~16 bytes per nonzero on one host core.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _rows_sorted(indptr: torch.Tensor, indices: torch.Tensor) -> bool:
    """True when the indices of every row are non-decreasing (a stable
    within-row sort would then leave them in place)."""
    nnz = indices.shape[0]
    if nnz < 2:
        return True
    ok = indices[1:] >= indices[:-1]
    # a decrease across a row boundary is allowed: position p−1 → p where
    # p is a row start
    starts = indptr[1:-1].long()
    starts = starts[(starts > 0) & (starts < nnz)]
    ok[starts - 1] = True
    return bool(ok.all())


def fingerprint_csr(a) -> str:
    """Hex content fingerprint of a :class:`~repro_torch.sparse.csr.CSRMatrix`."""
    sorted_rows = _rows_sorted(a.indptr, a.indices)
    indptr = np.ascontiguousarray(_host(a.indptr).astype(np.int64, copy=False))
    # widened where the indices live (on the card, before the copy)
    indices = _host(a.indices.to(torch.int64))
    data = _host(a.data)
    if not sorted_rows:
        # within-row canonical column order (stable for the unlikely
        # duplicate-entry case: lexsort keys are (secondary, primary))
        n_rows = len(indptr) - 1
        row_of = np.repeat(np.arange(n_rows, dtype=np.int64), np.diff(indptr))
        order = np.lexsort((indices, row_of))
        indices, data = indices[order], data[order]
    # the arrays' own buffers, not byte copies: the same bytes in the same
    # order as the reference's ``tobytes()``
    h = hashlib.blake2b(digest_size=16)
    h.update(np.asarray(a.shape, dtype=np.int64).tobytes())
    h.update(data.dtype.str.encode())
    h.update(memoryview(indptr))
    h.update(memoryview(np.ascontiguousarray(indices)))
    h.update(memoryview(np.ascontiguousarray(data)))
    return h.hexdigest()


def operator_nbytes(a) -> int:
    """Byte footprint of the CSR arrays — the registry's eviction currency
    (the reference's count: int32 row pointer and indices, the data)."""
    return int(sum(x.numel() * x.element_size() for x in (a.indptr, a.indices, a.data)))
