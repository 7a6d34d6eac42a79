"""Port parity: the packed halo-buffer plain versions against the reference.

``halo_pack`` / ``halo_unpack`` move data only, so the port's plain
versions must equal the reference's Pallas kernels (interpret mode, as
``tests/test_comm.py`` runs them on the CPU) and its ``ref.py`` exactly, in
float32 and float64 and at every exchange width w = t/col_split the solver
uses.  The port's ops take a leading rank axis; each rank is compared with
the reference's per-device call.  Unpack positions include padding entries
clamped to the trailing dump slot: every other slot must be bit-exact, and
slots no position names must keep their contents.  The CUDA kernels are
held against these plain versions by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.halo_pack.kernel import halo_pack_pallas, halo_unpack_pallas
from repro.kernels.halo_pack.ref import halo_pack_ref as jax_pack_ref
from repro.kernels.halo_pack.ref import halo_unpack_ref as jax_unpack_ref

import repro_torch.kernels as kernels
from repro_torch.kernels.halo_pack.ref import halo_pack_ref, halo_unpack_ref

DTYPES = ["float32", "float64"]
WIDTHS = [1, 2, 4, 8]
P, M, C = 3, 29, 13  # ranks, rows per rank (the last one the dump slot), packed rows


def _case(dtype, w, seed=0):
    """Per-rank gather indices and scatter positions as a plan builds them:
    positions name distinct slots, padding entries name the dump slot."""
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((P, M, w)).astype(dtype)
    dst = rng.standard_normal((P, M, w)).astype(dtype)
    buf = rng.standard_normal((P, C, w)).astype(dtype)
    idx = rng.integers(0, M, size=(P, C)).astype(np.int32)
    pos = np.stack([rng.choice(M - 1, size=C, replace=False) for _ in range(P)]).astype(np.int32)
    pos[:, -3:] = M - 1  # padding, clamped to the dump slot
    pos[1, :] = np.where(np.arange(C) < 5, pos[1, :], M - 1)  # a mostly padded rank
    return src, dst, buf, idx, pos


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_pack_equals_reference(dtype, w):
    src, _, _, idx, _ = _case(dtype, w)
    got = halo_pack_ref(torch.as_tensor(src), torch.as_tensor(idx)).numpy()
    assert got.dtype == src.dtype and got.shape == (P, C, w)
    for r in range(P):
        want = np.asarray(halo_pack_pallas(jnp.asarray(src[r]), jnp.asarray(idx[r]), interpret=True))
        assert np.array_equal(got[r], want)
        assert np.array_equal(got[r], np.asarray(jax_pack_ref(jnp.asarray(src[r]), jnp.asarray(idx[r]))))
    # the wrapper on CPU tensors, stacked and per-device, runs the plain version
    stacked = kernels.halo_pack(torch.as_tensor(src), torch.as_tensor(idx)).numpy()
    assert np.array_equal(stacked, got)
    flat = kernels.halo_pack(torch.as_tensor(src[2]), torch.as_tensor(idx[2])).numpy()
    assert np.array_equal(flat, got[2])


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_unpack_equals_reference_outside_the_dump_slot(dtype, w):
    _, dst, buf, _, pos = _case(dtype, w, seed=1)
    dst_t = torch.as_tensor(dst.copy())
    out = halo_unpack_ref(dst_t, torch.as_tensor(buf), torch.as_tensor(pos))
    assert out is dst_t  # in place, as the reference's donated operand
    got = out.numpy()
    for r in range(P):
        want = np.asarray(halo_unpack_pallas(
            jnp.asarray(dst[r]), jnp.asarray(buf[r]), jnp.asarray(pos[r]), interpret=True))
        want_ref = np.asarray(jax_unpack_ref(jnp.asarray(dst[r]), jnp.asarray(buf[r]),
                                             jnp.asarray(pos[r])))
        assert np.array_equal(got[r, : M - 1], want[: M - 1])
        assert np.array_equal(got[r, : M - 1], want_ref[: M - 1])
        # every named slot holds its buffer row; every other slot is untouched
        named = pos[r][pos[r] < M - 1]
        untouched = np.setdiff1d(np.arange(M - 1), named)
        assert np.array_equal(got[r, named], buf[r][pos[r] < M - 1])
        assert np.array_equal(got[r, untouched], dst[r, untouched])
        # the dump slot holds one of the padding rows written there
        assert any(np.array_equal(got[r, M - 1], row) for row in buf[r][pos[r] == M - 1])


@pytest.mark.parametrize("dtype", DTYPES)
def test_unpack_wrapper_stacked_and_per_device(dtype):
    _, dst, buf, _, pos = _case(dtype, 4, seed=2)
    stacked = torch.as_tensor(dst.copy())
    kernels.halo_unpack(stacked, torch.as_tensor(buf), torch.as_tensor(pos))
    per_dev = torch.as_tensor(dst[0].copy())
    assert kernels.halo_unpack(per_dev, torch.as_tensor(buf[0]), torch.as_tensor(pos[0])) is per_dev
    assert torch.equal(per_dev[: M - 1], stacked[0, : M - 1])


def test_wrapper_rejects_mismatched_ranks():
    with pytest.raises(ValueError, match="expected"):
        kernels.halo_pack(torch.zeros(2, 5, 3), torch.zeros(4, dtype=torch.int32))
