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

The kernels' launch geometry (``halo_plan``, the mirror of the C
launcher's choice: vector or scalar path, units per row, grid) and their
thread mapping are replayed here in Python against the plain versions; the
public ops' operand check and the executor's build-time index check are
held to refuse what the kernels do not take.
"""

import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.halo_pack.kernel import halo_pack_pallas, halo_unpack_pallas
from repro.kernels.halo_pack.ref import halo_pack_ref as jax_pack_ref
from repro.kernels.halo_pack.ref import halo_unpack_ref as jax_unpack_ref

import repro_torch.kernels as kernels
from repro_torch.kernels import _build
from repro_torch.kernels.halo_pack import ops
from repro_torch.kernels.halo_pack.ops import halo_plan
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


# ------------------------------------------------- launch plan and records
F32, F64 = torch.float32, torch.float64


@pytest.mark.parametrize("w,dtype,aligned,path,upr", [
    (8, F64, True, "vec", 4), (8, F32, True, "vec", 2), (2, F64, True, "vec", 1),
    (16, F64, True, "vec", 8), (4, F32, True, "vec", 1), (6, F64, True, "vec", 3),
    (1, F64, True, "scalar", 1), (3, F64, True, "scalar", 3), (2, F32, True, "scalar", 2),
    (8, F64, False, "scalar", 8), (4, F32, False, "scalar", 4),
])
def test_halo_plan_path_by_row_bytes_and_alignment(w, dtype, aligned, path, upr):
    plan = halo_plan(8, 8192, w, dtype, aligned, 132)
    assert (plan.path, plan.upr, plan.units) == (path, upr, 8 * 8192 * upr)


@pytest.mark.parametrize("p,c,w,sms", [(8, 8192, 8, 132), (8, 4096, 1, 132), (1, 1, 3, 132),
                                      (3, 1000, 16, 1), (8, 70000, 8, 132)])
def test_halo_plan_grid_fills_one_wave_and_strides_past_it(p, c, w, sms):
    threads = int(re.search(r"constexpr int kThreads = (\d+);",
                            (Path(_build.CSRC) / "common.cuh").read_text()).group(1))
    plan = halo_plan(p, c, w, F64, True, sms)
    wave = sms * 8  # resident 256-thread CTAs
    if plan.units <= wave * threads:
        # one unit per thread, and no CTA without a unit
        assert plan.grid * threads >= plan.units > (plan.grid - 1) * threads
    else:
        # a full wave, each thread striding over ceil(units / (wave·threads)) units at most
        assert plan.grid == wave
    with pytest.raises(ValueError, match="units"):
        halo_plan(8, 1 << 27, 8, F64, False, 132)


def _kernel_replay(name, rows, idx, buf, upr):
    """What csrc/halo_pack.cu's thread mapping does, unit by unit: unit u is
    unit k of packed row u // upr of rank row // c."""
    p, m, w = rows.shape
    c = idx.shape[1]
    r_units = rows.reshape(p * m * upr, -1).clone()
    b_units = buf.reshape(p * c * upr, -1).clone()
    u = np.arange(p * c * upr)
    row, k = u // upr, u % upr
    r = row // c
    slot = (r * m + idx.reshape(-1).numpy()[row]) * upr + k
    if name == "halo_pack":
        b_units[u] = r_units[slot]
        return b_units.reshape(p, c, w)
    r_units[slot] = b_units[u]  # the dump slot: one of its writers lands
    return r_units.reshape(p, m, w)


@pytest.mark.parametrize("w", [1, 2, 3, 4, 8, 16])
@pytest.mark.parametrize("dtype", DTYPES)
def test_thread_mapping_replayed_equals_plain(dtype, w):
    src, dst, buf, idx, pos = (torch.as_tensor(x) for x in _case(dtype, w, seed=3))
    for aligned in (True, False):
        plan = halo_plan(P, C, w, src.dtype, aligned, 132)
        got = _kernel_replay("halo_pack", src, idx, torch.zeros_like(buf), plan.upr)
        assert torch.equal(got, halo_pack_ref(src, idx))
        got = _kernel_replay("halo_unpack", dst, pos, buf, plan.upr)
        assert torch.equal(got[:, : M - 1], halo_unpack_ref(dst.clone(), buf, pos)[:, : M - 1])


def test_pack_into_a_given_buffer():
    src, _, buf, idx, _ = (torch.as_tensor(x) for x in _case("float64", 4, seed=4))
    out = torch.full_like(buf, np.nan)
    assert kernels.halo_pack(src, idx, out=out) is out
    assert torch.equal(out, halo_pack_ref(src, idx))
    src[:] = 1.0  # the buffer is written anew at each call
    kernels.halo_pack(src, idx, out=out)
    assert (out == 1.0).all()
    flat = torch.zeros(C, 4, dtype=torch.float64)  # the single-rank form
    kernels.halo_pack(src[2], idx[2], out=flat)
    assert torch.equal(flat, out[2])
    kernels.reset_launch_counts()
    kernels.halo_pack(src, idx[:, :0], out=out[:, :0])  # an empty phase
    assert kernels.halo_pack.launches == 0  # CPU operands launch nothing


def _check_cases():
    src, _, buf, idx, pos = (torch.as_tensor(x) for x in _case("float64", 4, seed=5))
    return [
        ("halo_pack", (src.float(), idx, buf), TypeError, "float32/float64 and share one dtype"),
        ("halo_pack", (src.int(), idx, buf.int()), TypeError, "float32/float64"),
        ("halo_pack", (src, idx.long(), buf), TypeError, "int32"),
        ("halo_unpack", (src, pos.long(), buf), TypeError, "int32"),
        ("halo_pack", (src.transpose(1, 2).contiguous().transpose(1, 2), idx, buf), ValueError, "contiguous"),
        ("halo_unpack", (src, pos, buf.transpose(0, 1).contiguous().transpose(0, 1)), ValueError, "contiguous"),
        ("halo_pack", (src, idx[:, ::2], None), ValueError, "contiguous"),
        ("halo_pack", (src, idx, buf[:, 1:]), ValueError, "buffer shape"),
        ("halo_pack", (src, idx[1:], buf[1:]), ValueError, "index rows"),
    ]


@pytest.mark.parametrize("case", range(len(_check_cases())))
def test_check_refuses_what_the_kernels_do_not_take(case):
    name, args, error, match = _check_cases()[case]
    with pytest.raises(error, match=match):
        ops._check(name, *args)


def test_check_passes_what_the_kernels_take():
    src, _, buf, idx, pos = (torch.as_tensor(x) for x in _case("float32", 8, seed=6))
    assert ops._check("halo_pack", src, idx) == (P, M, 8, C)
    assert ops._check("halo_unpack", src, pos, buf) == (P, M, 8, C)


@pytest.mark.parametrize("what", ["gather", "scatter"])
@pytest.mark.parametrize("bad", [-1, "bound"])
def test_phase_arrays_refuse_indices_outside_their_buffers(what, bad):
    """The executor checks every plan index against the buffer it addresses
    once, when it builds the plan's arrays; the kernels do not check."""
    from types import SimpleNamespace

    from repro_torch.sparse.spmbv import _phase_arrays

    rmax = 6
    plan = SimpleNamespace(col_split=2, halo_size=5, stage_size=3, phases=[SimpleNamespace(
        axis="proc", src="x", dst="halo",
        gather_idx=np.array([[0, 11], [3, 4]]), scatter_pos=np.array([[0, 5], [1, 2]]))])
    gathers, scatters = _phase_arrays(plan, rmax, "cpu")  # bounds 12 (x: rmax·cs) and 6 (halo + dump)
    assert gathers[0].dtype == scatters[0].dtype == torch.int32
    ph = plan.phases[0]
    arr = ph.gather_idx if what == "gather" else ph.scatter_pos
    arr[1, 0] = -1 if bad == -1 else (rmax * 2 if what == "gather" else plan.halo_size + 1)
    with pytest.raises(ValueError, match=f"{what} index outside"):
        _phase_arrays(plan, rmax, "cpu")


def test_halo_plan_constants_mirror_the_cuda_source():
    common = (Path(_build.CSRC) / "common.cuh").read_text()
    src = (Path(_build.CSRC) / "halo_pack.cu").read_text()
    assert f"constexpr int kThreads = {ops._THREADS};" in common
    assert f"constexpr int kCtasPerSm = {ops._CTAS_PER_SM};" in src
    assert f"constexpr long long kMaxUnits = 1LL << {ops._MAX_UNITS.bit_length() - 1};" in src
    assert "__launch_bounds__(repro::kThreads)" in src
