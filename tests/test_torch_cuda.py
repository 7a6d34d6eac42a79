"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU (a CUDA
kernel has no CPU mode).  On the GPU machine, which has no JAX, run them
without the suite's conftest (it imports JAX for the reference tests):

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: float64 rtol/atol 1e-12 (1e-11/1e-10 for the n-term Gram sums);
float32 2e-5 (1e-4/1e-3 for the Gram sums) — only the summation order differs.
The halo kernels move data only and must equal their plain versions exactly.
"""

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import block_ell_arrays
from repro_torch.kernels.block_update.ref import ecg_tail_ref
from repro_torch.kernels.fused_gram.ref import fused_gram_ref
from repro_torch.kernels.halo_pack.ref import halo_pack_ref, halo_unpack_ref
from repro_torch.launch.mesh import VirtualMesh
from repro_torch.solver import CommConfig, ECGSolver, SolverConfig
from repro_torch.sparse import dg_laplace_2d, fd_laplace_2d, random_spd

pytestmark = pytest.mark.cuda

DTYPES = [torch.float32, torch.float64]
WIDTHS = [1, 2, 3, 4, 8, 16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _tol(dtype, gram=False):
    if dtype == torch.float64:
        return dict(rtol=1e-11, atol=1e-10) if gram else dict(rtol=1e-12, atol=1e-12)
    return dict(rtol=1e-4, atol=1e-3) if gram else dict(rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t", WIDTHS)
def test_bsr_spmbv_matches_plain(cuda, t, dtype):
    for a in (random_spd(48, density=0.15, seed=9, device="cpu"),
              dg_laplace_2d((4, 3), block=8, device="cpu")):
        n = a.shape[0]
        for tile in ((8, 8), (4, 8), (8, 4), (16, 16)):
            blocks, indices, _, _, _ = block_ell_arrays(a, *tile)
            blocks = blocks.to(dtype)
            v = torch.randn(n, t, dtype=dtype)
            want = kernels.bsr_spmbv(blocks, indices, v, n_rows=n)
            got = kernels.bsr_spmbv(blocks.to(cuda), indices.to(cuda), v.to(cuda), n_rows=n)
            torch.testing.assert_close(got.cpu(), want, **_tol(dtype))
            # short V (missing rows read as zero), full padded output
            got = kernels.bsr_spmbv(blocks.to(cuda), indices.to(cuda), v[: n - 5].to(cuda))
            want = kernels.bsr_spmbv(blocks, indices, v[: n - 5])
            torch.testing.assert_close(got.cpu(), want, **_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t", WIDTHS)
@pytest.mark.parametrize("n", [1, 37, 3001, 70001])
def test_fused_gram_matches_plain_and_is_deterministic(cuda, n, t, dtype):
    mats = [torch.randn(n, t, dtype=dtype, device=cuda) for _ in range(4)]
    got = kernels.fused_gram(*mats)
    want = fused_gram_ref(*(m.cpu() for m in mats))
    torch.testing.assert_close(got.cpu(), want, **_tol(dtype, gram=True))
    assert torch.equal(kernels.fused_gram(*mats), got)  # fixed summation order


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t", WIDTHS)
@pytest.mark.parametrize("n", [1, 530, 70001])
def test_ecg_tail_matches_plain_and_leaves_inputs(cuda, n, t, dtype):
    rows = [torch.randn(n, t, dtype=dtype, device=cuda) for _ in range(5)]
    packed = torch.randn(t, 3 * t, dtype=dtype, device=cuda)
    coeffs = list(torch.split(packed, t, dim=1))  # column slices, as in the solver
    before = [m.clone() for m in rows]
    got = kernels.ecg_tail(*rows, *coeffs)
    want = ecg_tail_ref(*(m.cpu() for m in rows + coeffs))
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, **_tol(dtype))
    for m, m0 in zip(rows, before):
        assert torch.equal(m, m0)


def test_launch_counters_and_input_checks(cuda):
    kernels.reset_launch_counts()
    a = fd_laplace_2d(8, device="cpu")
    blocks, indices, _, _, _ = block_ell_arrays(a, 8, 8)
    blocks, indices = blocks.to(cuda), indices.to(cuda)
    v = torch.randn(64, 4, dtype=torch.float64, device=cuda)
    kernels.bsr_spmbv(blocks, indices, v)
    kernels.fused_gram(v, v, v, v)
    c = torch.eye(4, dtype=torch.float64, device=cuda)
    kernels.ecg_tail(v, v, v, v, v, c, c, c)
    assert kernels.launch_counts() == {"bsr_spmbv": 1, "fused_gram": 1, "ecg_tail": 1,
                                       "halo_pack": 0, "halo_unpack": 0}
    with pytest.raises(TypeError, match="int32"):
        kernels.bsr_spmbv(blocks, indices.long(), v)
    with pytest.raises(TypeError):
        kernels.bsr_spmbv(blocks, indices, v.float())
    with pytest.raises(ValueError, match="contiguous"):
        kernels.fused_gram(v.T.contiguous().T, v, v, v)
    with pytest.raises(ValueError, match="t <= 16"):
        w = torch.randn(64, 17, dtype=torch.float64, device=cuda)
        kernels.fused_gram(w, w, w, w)
    assert kernels.launch_counts() == {"bsr_spmbv": 1, "fused_gram": 1, "ecg_tail": 1,
                                       "halo_pack": 0, "halo_unpack": 0}


@pytest.mark.parametrize("t", [1, 4, 8])
def test_solve_on_card_matches_cpu(cuda, t):
    a = fd_laplace_2d(24, device="cpu")
    b = np.random.default_rng(0).standard_normal(a.shape[0])
    tol = 1e-8 * np.linalg.norm(b)
    cfg = SolverConfig(t=t, tol=tol, max_iters=2000, kernel="pallas")
    kernels.reset_launch_counts()
    gpu = ECGSolver.build(a, config=cfg, device=cuda).solve(b)
    counts = kernels.launch_counts()
    cpu = ECGSolver.build(a, config=cfg, device="cpu").solve(b)
    assert gpu.converged and gpu.n_iters == cpu.n_iters
    assert counts == {"bsr_spmbv": gpu.n_iters + 1, "fused_gram": gpu.n_iters,
                      "ecg_tail": gpu.n_iters, "halo_pack": 0, "halo_unpack": 0}
    x_g, x_c = gpu.x.cpu(), cpu.x
    assert float((x_g - x_c).abs().max()) <= 1e-8 * float(x_c.abs().max())


def _halo_case(p, m, c, w, dtype, device, seed=0):
    gen = torch.Generator().manual_seed(seed)
    src = torch.randn(p, m, w, generator=gen, dtype=dtype)
    idx = torch.randint(0, m, (p, c), generator=gen, dtype=torch.int32)
    # distinct positions below the dump slot m - 1, then padding clamped to it
    pos = torch.stack([torch.randperm(m - 1, generator=gen)[:c] for _ in range(p)]).to(torch.int32)
    pos[:, -max(1, c // 8):] = m - 1
    buf = torch.randn(p, c, w, generator=gen, dtype=dtype)
    return [x.to(device) for x in (src, idx, pos, buf)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("w", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("p,m,c", [(1, 40, 17), (8, 1100, 700), (8, 9000, 8192)])
def test_halo_pack_and_unpack_equal_plain(cuda, p, m, c, w, dtype):
    src, idx, pos, buf = _halo_case(p, m, c, w, dtype, cuda)
    assert torch.equal(kernels.halo_pack(src, idx).cpu(), halo_pack_ref(src.cpu(), idx.cpu()))
    assert torch.equal(kernels.halo_pack(src[0], idx[0]).cpu(), halo_pack_ref(src.cpu(), idx.cpu())[0])
    dst = src.clone()
    assert kernels.halo_unpack(dst, buf, pos) is dst  # in place
    want = halo_unpack_ref(src.cpu().clone(), buf.cpu(), pos.cpu())
    assert torch.equal(dst[:, : m - 1].cpu(), want[:, : m - 1])  # all but the dump slot
    named = torch.zeros(p, m, dtype=torch.bool)
    named.scatter_(1, pos.cpu().long(), True)
    untouched = ~named
    untouched[:, m - 1] = False
    assert torch.equal(dst.cpu()[untouched], src.cpu()[untouched])


def test_halo_kernels_count_and_check(cuda):
    kernels.reset_launch_counts()
    src, idx, pos, buf = _halo_case(2, 30, 10, 4, torch.float64, cuda)
    kernels.halo_pack(src, idx)
    kernels.halo_unpack(src, buf, pos)
    assert (kernels.halo_pack.launches, kernels.halo_unpack.launches) == (1, 1)
    with pytest.raises(TypeError, match="int32"):
        kernels.halo_pack(src, idx.long())
    with pytest.raises(TypeError):
        kernels.halo_unpack(src, buf.float(), pos)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.halo_pack(src.transpose(1, 2).contiguous().transpose(1, 2), idx)
    assert (kernels.halo_pack.launches, kernels.halo_unpack.launches) == (1, 1)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ranks,n,t", [(8, 1000, 8), (8, 37, 3), (3, 70001, 4)])
def test_batched_fused_gram_matches_per_rank(cuda, ranks, n, t, dtype):
    mats = [torch.randn(ranks, n, t, dtype=dtype, device=cuda) for _ in range(4)]
    got = kernels.fused_gram(*mats)
    assert got.shape == (ranks, t, 3 * t)
    torch.testing.assert_close(got.cpu(), fused_gram_ref(*(m.cpu() for m in mats)), **_tol(dtype, gram=True))
    assert torch.equal(kernels.fused_gram(*mats), got)  # fixed summation order


@pytest.mark.parametrize("strategy", ["standard", "2step", "3step", "optimal"])
def test_distributed_solve_on_card_matches_cpu(cuda, strategy):
    a = fd_laplace_2d(24, device="cpu")
    b = np.random.default_rng(0).standard_normal(a.shape[0])
    cfg = SolverConfig(t=4, tol=1e-8 * np.linalg.norm(b), max_iters=2000, kernel="pallas",
                       comm=CommConfig(strategy=strategy))
    mesh = VirtualMesh(2, 4, device=cuda)
    solver = ECGSolver.build(a, mesh, cfg)
    kernels.reset_launch_counts()
    mesh.reset_counters()
    gpu = solver.solve(b)
    counts = kernels.launch_counts()
    cpu = ECGSolver.build(a, VirtualMesh(2, 4, device="cpu"), cfg).solve(b)
    k = gpu.n_iters
    assert gpu.converged and k == cpu.n_iters
    phases = len(solver.op.plan.phases)
    assert counts == {"bsr_spmbv": k + 1, "fused_gram": k, "ecg_tail": k,
                      "halo_pack": phases * (k + 1), "halo_unpack": phases * (k + 1)}
    assert mesh.psum_calls == 3 * k + 1
    x_g, x_c = solver.unshard(gpu.x), solver.unshard(cpu.x)
    assert np.abs(x_g - x_c).max() <= 1e-8 * np.abs(x_c).max()
