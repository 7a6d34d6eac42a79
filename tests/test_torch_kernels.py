"""Port parity: the kernels' host side and plain versions against the reference.

* Block-ELL conversion (arrays and meta) is host numpy work: exactly equal.
* Each plain torch version agrees with the reference's Pallas kernel run in
  interpret mode, as ``tests/test_kernels.py`` runs it, over f32/f64 and
  t ∈ {1, 2, 4, 8, 16} with n not a multiple of the Pallas row block (512).
  Tolerances: rtol/atol 1e-12 in float64 (only the summation order differs),
  2e-5 in float32 (sums of up to ~100 products of O(1) values).
* On CPU tensors the wrappers run the plain versions and never count a launch.
* The CUDA kernels themselves are held against these plain versions on the
  card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.sparse as ref_sparse
from repro.kernels.block_update.kernel import ecg_tail_pallas
from repro.kernels.bsr_spmbv.kernel import bsr_spmbv_pallas
from repro.kernels.fused_gram.kernel import fused_gram_pallas

import repro_torch.kernels as kernels
from repro_torch.kernels.block_update.ref import ecg_tail_ref
from repro_torch.kernels.bsr_spmbv.ref import bsr_spmbv_ref
from repro_torch.kernels.fused_gram.ref import fused_gram_ref
from repro_torch.sparse.csr import CSRMatrix

# ``<pkg>.kernels.bsr_spmbv`` is shadowed by the op of that name in both
# packages' ``kernels/__init__``, so the ops modules are imported by path
ref_ops = importlib.import_module("repro.kernels.bsr_spmbv.ops")
port_ops = importlib.import_module("repro_torch.kernels.bsr_spmbv.ops")

DTYPES = ["float32", "float64"]
WIDTHS = [1, 2, 4, 8, 16]


def _tol(dtype):
    return dict(rtol=1e-12, atol=1e-12) if dtype == "float64" else dict(rtol=2e-5, atol=2e-5)


def _matrices():
    return {
        "dg": ref_sparse.dg_laplace_2d((4, 3), block=8),
        "random": ref_sparse.random_spd(48, density=0.15, seed=9),  # irregular rows
    }


def _port(ra):
    return CSRMatrix.from_numpy(ra.indptr, ra.indices, ra.data, ra.shape, device="cpu")


# ------------------------------------------------------------ conversion
@pytest.mark.parametrize("tile", [(8, 8), (4, 8), (16, 16)])
@pytest.mark.parametrize("name", ["dg", "random"])
def test_block_ell_arrays_and_meta_equal(name, tile):
    ra = _matrices()[name]
    pa = _port(ra)
    want_meta = ref_ops.block_ell_meta(ra, *tile)
    assert port_ops.block_ell_meta(pa, *tile) == want_meta
    rb, ri, rm, _, ran = ref_ops.block_ell_arrays(ra, *tile)
    pb, pi, pm, pmeta, pan = port_ops.block_ell_arrays(pa, *tile)
    assert (pm, pmeta, pan) == (rm, want_meta, ran)
    np.testing.assert_array_equal(pb.numpy(), np.asarray(rb))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    assert pi.dtype == torch.int32
    # persisted meta skips the analysis and fills the same layout
    pb2, pi2, _, _, analyzed = port_ops.block_ell_arrays(pa, *tile, meta=want_meta)
    assert analyzed is False
    np.testing.assert_array_equal(pb2.numpy(), pb.numpy())
    np.testing.assert_array_equal(pi2.numpy(), pi.numpy())


def test_csr_arrays_to_block_ell_and_tile_count_equal():
    ra = _matrices()["random"]
    args = (np.asarray(ra.indptr), np.asarray(ra.indices), np.asarray(ra.data), 48, 48, 4, 4)
    kmax = ref_ops.count_block_ell_tiles(*args[:2], *args[3:])
    assert port_ops.count_block_ell_tiles(*args[:2], *args[3:]) == kmax
    rb, ri = ref_ops.csr_arrays_to_block_ell(*args, nbr=13, kmax=kmax + 1)
    pb, pi = port_ops.csr_arrays_to_block_ell(*args, nbr=13, kmax=kmax + 1)
    np.testing.assert_array_equal(pb, rb)
    np.testing.assert_array_equal(pi, ri)
    with pytest.raises(ValueError, match="overflows kmax"):
        port_ops.csr_arrays_to_block_ell(*args, nbr=12, kmax=kmax - 1)


# -------------------------------------------- plain versions vs Pallas
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t", WIDTHS)
def test_bsr_spmbv_plain_matches_pallas(t, dtype):
    ra = _matrices()["dg"]
    blocks, indices = ref_ops.bsr_to_block_ell(ref_sparse.csr_to_bsr(ra, 8, 8))
    blocks = blocks.astype(getattr(jnp, dtype))
    v = np.random.default_rng(t).standard_normal((ra.shape[1], t)).astype(dtype)
    want = np.asarray(bsr_spmbv_pallas(blocks, indices, jnp.asarray(v), interpret=True))
    pb, pi = torch.as_tensor(np.array(blocks)), torch.as_tensor(np.array(indices))
    got = bsr_spmbv_ref(pb, pi, torch.as_tensor(v))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.numpy(), want, **_tol(dtype))
    # the op reads V unpadded (rows past its end are zero) and trims W
    n = 90
    w = kernels.bsr_spmbv(pb, pi, torch.as_tensor(v[:n]), n_rows=n)
    vz = v.copy()
    vz[n:] = 0
    want_z = np.asarray(bsr_spmbv_pallas(blocks, indices, jnp.asarray(vz), interpret=True))
    np.testing.assert_allclose(w.numpy(), want_z[:n], **_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t", WIDTHS)
def test_fused_gram_plain_matches_pallas(t, dtype):
    n = 700  # not a multiple of the Pallas row block
    mats = [np.random.default_rng(10 * t + i).standard_normal((n, t)).astype(dtype) for i in range(4)]
    want = np.asarray(fused_gram_pallas(*map(jnp.asarray, mats), interpret=True))
    got = kernels.fused_gram(*map(torch.as_tensor, mats))
    assert got.shape == (t, 3 * t) and got.dtype == getattr(torch, dtype)
    tol = dict(rtol=1e-12, atol=1e-11) if dtype == "float64" else dict(rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got.numpy(), want, **tol)
    np.testing.assert_allclose(fused_gram_ref(*map(torch.as_tensor, mats)).numpy(), want, **tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t", WIDTHS)
def test_ecg_tail_plain_matches_pallas(t, dtype):
    n = 530
    rng = np.random.default_rng(t)
    rows = [rng.standard_normal((n, t)).astype(dtype) for _ in range(5)]
    coeffs = [rng.standard_normal((t, t)).astype(dtype) for _ in range(3)]
    want = ecg_tail_pallas(*map(jnp.asarray, rows + coeffs), interpret=True)
    got = kernels.ecg_tail(*map(torch.as_tensor, rows + coeffs))
    for g, w in zip(got, want):
        assert g.shape == (n, t) and g.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **_tol(dtype))


def test_cpu_tensors_never_count_launches():
    kernels.reset_launch_counts()
    t = 4
    pa = _port(_matrices()["dg"])
    blocks, indices, _, _, _ = port_ops.block_ell_arrays(pa, 8, 8)
    v = torch.randn(pa.shape[0], t, dtype=torch.float64)
    kernels.bsr_spmbv(blocks, indices, v)
    kernels.fused_gram(v, v, v, v)
    c = torch.eye(t, dtype=torch.float64)
    kernels.ecg_tail(v, v, v, v, v, c, c, c)
    idx = torch.zeros(2, 3, dtype=torch.int32)
    buf = kernels.halo_pack(v.reshape(2, -1, t), idx)
    kernels.halo_unpack(v.reshape(2, -1, t), buf, idx)
    assert kernels.launch_counts() == {"bsr_spmbv": 0, "fused_gram": 0, "ecg_tail": 0,
                                       "halo_pack": 0, "halo_unpack": 0}


def test_mixed_devices_rejected():
    meta = torch.zeros(1, 1, 1, 1, device="meta")
    with pytest.raises(ValueError, match="must all be CUDA tensors or all CPU tensors"):
        kernels.bsr_spmbv(meta, torch.zeros(1, 1, dtype=torch.int32), torch.zeros(1, 1))
