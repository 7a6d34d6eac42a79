"""Port parity: sparse containers and generators (repro_torch.sparse vs repro.sparse).

Generators and conversions are host-side numpy work, so they are held to
exact equality; the CSR products sum in another order than XLA's
segment_sum and are held to rtol 1e-13 (float64).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.sparse as ref
import repro_torch.sparse as port
from repro_torch.sparse.csr import CSRMatrix


def _assert_csr_equal(pa, ra):
    assert pa.shape == tuple(ra.shape)
    np.testing.assert_array_equal(pa.indptr.numpy(), np.asarray(ra.indptr))
    np.testing.assert_array_equal(pa.indices.numpy(), np.asarray(ra.indices))
    assert pa.indptr.dtype == torch.int32 and pa.indices.dtype == torch.int32
    np.testing.assert_array_equal(pa.data.numpy(), np.asarray(ra.data))
    assert pa.data.numpy().dtype == np.asarray(ra.data).dtype


GENERATORS = [
    ("fd2d", lambda m, dt, **kw: m.fd_laplace_2d(7, 5, dtype=dt, **kw)),
    ("fd3d", lambda m, dt, **kw: m.fd_laplace_3d(4, 3, 5, dtype=dt, **kw)),
    ("dg_b4", lambda m, dt, **kw: m.dg_laplace_2d((4, 3), block=4, dtype=dt, **kw)),
    ("dg_b16", lambda m, dt, **kw: m.dg_laplace_2d((3, 5), block=16, dtype=dt, **kw)),
    ("random", lambda m, dt, **kw: m.random_spd(40, density=0.1, seed=3, dtype=dt, **kw)),
]


@pytest.mark.parametrize("name,gen", GENERATORS, ids=[g[0] for g in GENERATORS])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_generators_array_equal(name, gen, dtype):
    ra = gen(ref, getattr(jnp, dtype))
    pa = gen(port, getattr(torch, dtype), device="cpu")
    _assert_csr_equal(pa, ra)


def test_example_2_1_spec_matches():
    assert port.EXAMPLE_2_1 == ref.EXAMPLE_2_1


@pytest.mark.parametrize("tile", [(8, 8), (4, 8), (16, 16), (3, 5)])
@pytest.mark.parametrize("pad_rows", [True, False])
def test_csr_to_bsr_array_equal(tile, pad_rows):
    for ra in (ref.dg_laplace_2d((4, 3), block=8), ref.random_spd(48, density=0.15, seed=9)):
        pa = CSRMatrix.from_numpy(ra.indptr, ra.indices, ra.data, ra.shape, device="cpu")
        rb = ref.csr_to_bsr(ra, *tile, pad_rows=pad_rows)
        pb = port.csr_to_bsr(pa, *tile, pad_rows=pad_rows)
        assert pb.shape == tuple(rb.shape)
        np.testing.assert_array_equal(pb.block_indptr.numpy(), np.asarray(rb.block_indptr))
        np.testing.assert_array_equal(pb.block_indices.numpy(), np.asarray(rb.block_indices))
        np.testing.assert_array_equal(pb.blocks.numpy(), np.asarray(rb.blocks))


@pytest.mark.parametrize("t", [1, 3, 8])
def test_csr_spmbv_agrees(t):
    ra = ref.dg_laplace_2d((5, 4), block=4)
    pa = CSRMatrix.from_numpy(ra.indptr, ra.indices, ra.data, ra.shape, device="cpu")
    v = np.random.default_rng(t).standard_normal((ra.shape[0], t))
    want = np.asarray(ref.csr_spmbv(ra, jnp.asarray(v)))
    got = port.csr_spmbv(pa, torch.as_tensor(v)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13)
    got_vec = port.csr_spmv(pa, torch.as_tensor(v[:, 0])).numpy()
    want_vec = np.asarray(ref.csr_spmv(ra, jnp.asarray(v[:, 0])))
    np.testing.assert_allclose(got_vec, want_vec, rtol=1e-13, atol=1e-13)


def test_todense_equal():
    ra = ref.random_spd(30, density=0.2, seed=1)
    pa = CSRMatrix.from_numpy(ra.indptr, ra.indices, ra.data, ra.shape, device="cpu")
    np.testing.assert_array_equal(pa.todense().numpy(), np.asarray(ra.todense()))


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.fd_laplace_2d(4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CSRMatrix.from_numpy([0, 1], [0], [1.0], (1, 1))
