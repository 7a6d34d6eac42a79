"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU (a CUDA
kernel has no CPU mode).  On the GPU machine, which has no JAX, run them
without the suite's conftest (it imports JAX for the reference tests):

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: float64 rtol/atol 1e-12 (1e-11/1e-10 for the n-term Gram sums);
float32 2e-5 (1e-4/1e-3 for the Gram sums) — only the summation order differs.
``block_trisolve`` substitutes where the plain version calls LAPACK-style
triangular solves: 1e-11 in float64, 1e-4 in float32, on factors of
blocks with condition number below 10.  ``chol_apply`` substitutes where its
plain version calls ``solve_triangular``: within 2·t·eps·κ(C)·max|y| (the
forward error bound of a t-term substitution); ``rank_apply`` factors G in
the plain version's order, so its rank and pivot order must equal the plain
version's, its blocks within that bound; ``drop_mask``'s mask and counts
must equal its plain version's.  The halo kernels move data only and
must equal their plain versions exactly, and two CSR products on the same
inputs must be bit-identical (no atomics).
"""

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import block_ell_arrays
from repro_torch.kernels.block_trisolve.ref import block_trisolve_ref
from repro_torch.kernels.block_update.ref import block_update_ref, ecg_tail_ref
from repro_torch.adaptive import ReductionPolicy, default_rank_rtol, pivoted_cholesky
from repro_torch.kernels.chol_apply.ref import (
    chol_apply_dense,
    chol_apply_ref,
    drop_mask_ref,
    rank_apply_dense,
    rank_apply_ref,
)
from repro_torch.kernels.fused_gram.ref import fused_gram_ref
from repro_torch.kernels.halo_pack.ref import halo_pack_ref, halo_unpack_ref
from repro_torch.launch.mesh import VirtualMesh
from repro_torch.solver import CommConfig, ECGSolver, SolverConfig
from repro_torch.sparse import csr_spmbv, dg_laplace_2d, fd_laplace_2d, random_spd

pytestmark = pytest.mark.cuda

DTYPES = [torch.float32, torch.float64]
WIDTHS = [1, 2, 3, 4, 8, 16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _counts(**launched):
    """launch_counts() with every kernel not named at 0."""
    return dict.fromkeys(kernels.launch_counts(), 0) | launched


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


#: tiles of the float64 tensor-core path (MMA_BR x MMA_BC) and tiles it does
#: not take, which run on the FMA path in both dtypes
SPMBV_TILES = [(8, 8), (8, 4), (8, 16), (16, 4), (16, 8), (16, 16), (4, 8), (5, 3), (12, 8)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t", [1, 3, 5, 8, 12, 16])
@pytest.mark.parametrize("tile", SPMBV_TILES)
def test_bsr_spmbv_paths_match_plain_and_are_deterministic(cuda, tile, t, dtype):
    from repro_torch.kernels.bsr_spmbv.ops import spmbv_plan

    a = dg_laplace_2d((5, 4), block=8, device="cpu")
    n = a.shape[0]
    blocks, indices, _, _, _ = block_ell_arrays(a, *tile)
    blocks = blocks.to(dtype)
    nbr, _, br, _ = blocks.shape
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    want_path = "mma" if dtype == torch.float64 and tile[0] in (8, 16) and tile[1] in (4, 8, 16) else "fma"
    assert spmbv_plan(nbr, br, tile[1], t, n, dtype, sms).path == want_path
    v = torch.randn(n, t, dtype=dtype)
    bd, idd = blocks.to(cuda), indices.to(cuda)
    # V short of nbc·bc (rows past its end read as zero), and an output cut
    # below nbr·br (n_rows) as well as the full padded one
    for rows_v, n_rows in ((n, n), (n - 7, None), (n - 3, n - 11)):
        vv = v[:rows_v].contiguous()
        want = kernels.bsr_spmbv(blocks, indices, vv, n_rows=n_rows)
        got = kernels.bsr_spmbv(bd, idd, vv.to(cuda), n_rows=n_rows)
        assert got.shape == want.shape
        torch.testing.assert_close(got.cpu(), want, **_tol(dtype))
        assert torch.equal(kernels.bsr_spmbv(bd, idd, vv.to(cuda), n_rows=n_rows), got)


@pytest.mark.parametrize("t", [1, 8, 16])
def test_bsr_spmbv_ranked_layout_of_the_virtual_mesh(cuda, t):
    # the distributed apply runs one launch over the p stacked local products
    a = dg_laplace_2d((8, 8), block=4, device="cpu")
    cfg = SolverConfig(t=t, tol=1e-8, max_iters=10, kernel="pallas", comm=CommConfig(strategy="optimal"))
    ops = {dev: ECGSolver.build(a, VirtualMesh(2, 4, device=dev), cfg).op for dev in ("cpu", cuda)}
    v = np.random.default_rng(3).standard_normal((a.shape[0], t))
    kernels.reset_launch_counts()
    got = [ops[cuda].matvec_fn()(ops[cuda].shard_vector(v)) for _ in range(2)]
    assert kernels.launch_counts()["bsr_spmbv"] == 2
    want = ops["cpu"].matvec_fn()(ops["cpu"].shard_vector(v))
    torch.testing.assert_close(got[0].cpu(), want, **_tol(torch.float64))
    assert torch.equal(got[0], got[1])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ranks", [1, 3, 8])
@pytest.mark.parametrize("t", [1, 3, 8, 12, 16])
@pytest.mark.parametrize("n", [1, 3, 37, 70001])
def test_fused_gram_paths_match_plain_and_are_deterministic(cuda, n, t, ranks, dtype):
    shape = (n, t) if ranks == 1 else (ranks, n, t)
    mats = [torch.randn(*shape, dtype=dtype, device=cuda) for _ in range(4)]
    got = kernels.fused_gram(*mats)
    assert got.shape == shape[:-2] + (t, 3 * t)
    torch.testing.assert_close(got.cpu(), fused_gram_ref(*(m.cpu() for m in mats)), **_tol(dtype, gram=True))
    assert torch.equal(kernels.fused_gram(*mats), got)  # fixed summation order
    if ranks == 1:  # the ranked layout sums in the same order
        assert torch.equal(kernels.fused_gram(*(m[None] for m in mats))[0], got)


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
    assert kernels.launch_counts() == _counts(bsr_spmbv=1, fused_gram=1, ecg_tail=1)
    with pytest.raises(TypeError, match="int32"):
        kernels.bsr_spmbv(blocks, indices.long(), v)
    with pytest.raises(TypeError):
        kernels.bsr_spmbv(blocks, indices, v.float())
    with pytest.raises(ValueError, match="contiguous"):
        kernels.fused_gram(v.T.contiguous().T, v, v, v)
    with pytest.raises(ValueError, match="t <= 16"):
        w = torch.randn(64, 17, dtype=torch.float64, device=cuda)
        kernels.fused_gram(w, w, w, w)
    assert kernels.launch_counts() == _counts(bsr_spmbv=1, fused_gram=1, ecg_tail=1)


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
    assert counts == _counts(bsr_spmbv=gpu.n_iters + 1, fused_gram=gpu.n_iters,
                             ecg_tail=gpu.n_iters, chol_apply=gpu.n_iters)
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
@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("p,m,c", [(1, 40, 17), (3, 500, 333), (8, 1100, 700), (8, 9000, 8192)])
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


def _offset_view(x, shift):
    """A contiguous copy of ``x`` that starts ``shift`` elements into its storage."""
    flat = torch.empty(x.numel() + shift, dtype=x.dtype, device=x.device)
    view = flat[shift:].view(x.shape)
    view.copy_(x)
    return view


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("w", [2, 4, 8, 16])
@pytest.mark.parametrize("p", [1, 3, 8])
def test_halo_kernels_on_offset_views_choose_their_path(cuda, p, w, dtype):
    from repro_torch.kernels.halo_pack.ops import halo_plan

    m, c = 301, 257
    src, idx, pos, buf = _halo_case(p, m, c, w, dtype, cuda, seed=1)
    want_pack = halo_pack_ref(src.cpu(), idx.cpu())
    want_unpack = halo_unpack_ref(src.cpu().clone(), buf.cpu(), pos.cpu())
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    paths = set()
    for shift in (0, 1, 2, 3):
        s_off = _offset_view(src, shift)
        out = _offset_view(torch.zeros_like(buf), shift)
        aligned = (s_off.data_ptr() | out.data_ptr()) % 16 == 0
        paths.add(halo_plan(p, c, w, dtype, aligned, sms).path)
        assert kernels.halo_pack(s_off, idx, out=out) is out
        assert torch.equal(out.cpu(), want_pack)
        assert torch.equal(kernels.halo_pack(s_off, idx).cpu(), want_pack)
        dst = _offset_view(src, shift)
        kernels.halo_unpack(dst, _offset_view(buf, shift), pos)
        assert torch.equal(dst[:, : m - 1].cpu(), want_unpack[:, : m - 1])
    # the shifts cover the scalar path, and the vector path where rows allow it
    es = torch.finfo(dtype).bits // 8
    assert paths == ({"vec", "scalar"} if (w * es) % 16 == 0 else {"scalar"})


@pytest.mark.parametrize("strategy,col_split", [("standard", None), ("2step", None), ("3step", None),
                                                ("optimal", None), ("optimal", 2)])
def test_exchange_graph_replay_equals_the_eager_exchange(cuda, strategy, col_split):
    a = dg_laplace_2d((12, 10), block=4, device="cpu")
    cfg = SolverConfig(t=8, tol=1e-8, max_iters=10, kernel="pallas",
                       comm=CommConfig(strategy=strategy, col_split=col_split))
    mesh = VirtualMesh(2, 4, device=cuda)
    op = ECGSolver.build(a, mesh, cfg).op
    rng = np.random.default_rng(4)
    for t in (8, 1):
        ex = op.exchange(op.plan, t, torch.float64)
        vs = [op.shard_vector(rng.standard_normal((a.shape[0], t))).reshape(8, op.rmax, t)
              for _ in range(4)]
        eager = []
        for v in vs:
            ex.own.copy_(v)
            ex.exchange()
            eager.append(ex.xfull.clone())
        kernels.reset_launch_counts()
        mesh.reset_counters()
        ex.exchange()
        one = (kernels.launch_counts(), mesh.ppermute_calls, mesh.ppermute_elements)
        kernels.reset_launch_counts()
        mesh.reset_counters()
        got = [ex.run(v).clone() for v in vs]  # eager (first run), capture + replay, replays
        assert ex.graph is not None and ex.runs == 4
        assert all(torch.equal(g, e) for g, e in zip(got, eager))
        n = len(vs)
        counts = kernels.launch_counts()
        assert counts == {k: n * v for k, v in one[0].items()}
        assert (mesh.ppermute_calls, mesh.ppermute_elements) == (n * one[1], n * one[2])
        assert counts["halo_pack"] == n * len(op.plan.phases) and mesh.psum_calls == 0
    # the apply through the graph equals the CPU operator's
    cpu_op = ECGSolver.build(a, VirtualMesh(2, 4, device="cpu"), cfg).op
    v = rng.standard_normal((a.shape[0], 8))
    apply = op.matvec_fn()
    got = [apply(op.shard_vector(v)) for _ in range(3)]
    assert all(torch.equal(g, got[0]) for g in got)
    torch.testing.assert_close(got[0].cpu(), cpu_op.matvec_fn()(cpu_op.shard_vector(v)),
                               **_tol(torch.float64))


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
    assert counts == _counts(bsr_spmbv=k + 1, fused_gram=k, ecg_tail=k,
                             halo_pack=phases * (k + 1), halo_unpack=phases * (k + 1),
                             chol_apply=k)
    assert mesh.psum_calls == 3 * k + 1
    x_g, x_c = solver.unshard(gpu.x), solver.unshard(cpu.x)
    assert np.abs(x_g - x_c).max() <= 1e-8 * np.abs(x_c).max()


def _factors(nb, bs, dtype, seed=0):
    """Lower Cholesky factors of well-conditioned SPD blocks (κ < 10)."""
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn(nb, bs, bs, generator=gen, dtype=torch.float64)
    low = torch.linalg.cholesky(q @ q.mT / (4 * bs) + torch.eye(bs, dtype=torch.float64))
    return low.to(dtype).contiguous()  # batched cholesky returns column-major blocks


def _trisolve_tol(dtype):
    return dict(rtol=1e-11, atol=1e-11) if dtype == torch.float64 else dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t", [1, 3, 8, 16])
@pytest.mark.parametrize("bs", [4, 5, 8, 16, 32, 64])
def test_block_trisolve_matches_plain(cuda, bs, t, dtype):
    nb = 300
    l = _factors(nb, bs, dtype)
    x = torch.randn(nb, bs, t, dtype=dtype)
    got = kernels.block_trisolve(l.to(cuda), x.to(cuda))
    torch.testing.assert_close(got.cpu(), block_trisolve_ref(l, x), **_trisolve_tol(dtype))
    # row layout: 3 ranks of rmax rows, the last block of each ragged
    ranks, nb_rank = 3, nb // 3
    for rmax in (nb_rank * bs, nb_rank * bs - bs // 2 - 1):
        rows = torch.randn(ranks * rmax, t, dtype=dtype)
        got = kernels.block_trisolve(l.to(cuda), rows.to(cuda), ranks=ranks)
        want = kernels.block_trisolve(l, rows, ranks=ranks)
        assert got.shape == (ranks * rmax, t)
        torch.testing.assert_close(got.cpu(), want, **_trisolve_tol(dtype))
        assert torch.equal(kernels.block_trisolve(l.to(cuda), rows.to(cuda), ranks=ranks), got)


def test_block_trisolve_counts_and_checks(cuda):
    kernels.reset_launch_counts()
    l = _factors(8, 4, torch.float64).to(cuda)
    x = torch.randn(32, 2, dtype=torch.float64, device=cuda)
    kernels.block_trisolve(l, x, ranks=2)
    kernels.block_trisolve(l.float(), x)  # factors cast to x's dtype
    assert kernels.block_trisolve.launches == 2
    with pytest.raises(ValueError, match="bs <= 64"):
        kernels.block_trisolve(_factors(2, 65, torch.float64).to(cuda), torch.zeros(130, 1, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError, match="exceed"):
        kernels.block_trisolve(l, torch.zeros(40, 2, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        kernels.block_trisolve(l.mT, x)
    assert kernels.block_trisolve.launches == 2


@pytest.mark.parametrize("bs", [1, 2, 7, 17, 33, 48])
def test_block_trisolve_odd_blocks_and_row_pairs(cuda, bs):
    """Blocks of one row, blocks that fill part of a warp's segment, two
    rows a lane (bs > 32), odd widths (t below the width the kernel is built
    for) and a ragged last task."""
    for t, dtype in ((5, torch.float64), (3, torch.float32), (16, torch.float64)):
        nb = 2 * 33 + 1
        l = _factors(nb, bs, dtype, seed=bs)
        x = torch.randn(nb, bs, t, dtype=dtype)
        got = kernels.block_trisolve(l.to(cuda), x.to(cuda))
        torch.testing.assert_close(got.cpu(), block_trisolve_ref(l, x), **_trisolve_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bs", [16, 32, 64])
def test_block_trisolve_unaligned_operands(cuda, bs, dtype):
    """Factors and rows at base addresses that are not 16-byte aligned take
    the value-by-value copies and row loads, and give the same result."""
    nb, t = 70, 8
    l = _factors(nb, bs, dtype, seed=3)
    x = torch.randn(nb * bs, t, dtype=dtype)
    want = block_trisolve_ref(l, x.reshape(nb, bs, t)).reshape(nb * bs, t)
    l_off = torch.zeros(l.numel() + 1, dtype=dtype, device=cuda)[1:]
    l_off.copy_(l.reshape(-1).to(cuda))
    x_off = torch.zeros(x.numel() + 1, dtype=dtype, device=cuda)[1:]
    x_off.copy_(x.reshape(-1).to(cuda))
    got = kernels.block_trisolve(l_off.view(nb, bs, bs), x_off.view(nb * bs, t))
    torch.testing.assert_close(got.cpu(), want, **_trisolve_tol(dtype))
    aligned = kernels.block_trisolve(l.to(cuda), x.to(cuda))
    torch.testing.assert_close(got, aligned, **_trisolve_tol(dtype))


def _upper(t, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn(t, t, generator=gen, dtype=torch.float64)
    return torch.linalg.cholesky(q @ q.T / t + torch.eye(t, dtype=torch.float64)).T.to(dtype).contiguous()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t", [1, 2, 3, 4, 5, 8, 12, 16])
@pytest.mark.parametrize("rows", [1, 530, 70001])
def test_chol_apply_matches_plain(cuda, rows, t, dtype):
    c = _upper(t, dtype, seed=t)
    mats = [torch.randn(rows, t, dtype=dtype) for _ in range(2)]
    kappa = float(torch.linalg.cond(c.double()))
    eps = torch.finfo(dtype).eps
    for n_mats in (1, 2):
        kernels.reset_launch_counts()
        got = kernels.chol_apply(c.to(cuda), *(m.to(cuda) for m in mats[:n_mats]))
        assert kernels.launch_counts() == _counts(chol_apply=1)
        want = chol_apply_ref(c, *mats[:n_mats])
        dense = chol_apply_dense(c, *mats[:n_mats])
        for g, w, d in zip(got, want, dense):
            assert g.shape == (rows, t) and g.dtype == dtype and g.is_contiguous()
            tol = 2 * t * eps * kappa * float(w.abs().max())
            assert float((g.cpu().double() - w.double()).abs().max()) <= tol
            # the kernel's own order of operations: only FMA contraction differs
            assert float((g.cpu().double() - d.double()).abs().max()) <= tol
    # deterministic
    ops = [c.to(cuda)] + [m.to(cuda) for m in mats]
    assert all(torch.equal(a, b) for a, b in zip(kernels.chol_apply(*ops), kernels.chol_apply(*ops)))


def test_chol_apply_nan_factor_counts_and_checks(cuda):
    c = _upper(8, torch.float64).to(cuda)
    z, az = (torch.randn(1000, 8, dtype=torch.float64, device=cuda) for _ in range(2))
    kernels.reset_launch_counts()
    p, ap = kernels.chol_apply(torch.full_like(c, float("nan")), z, az)
    assert bool(torch.isnan(p).all()) and bool(torch.isnan(ap).all())
    # an offset view: a base address that is not 16-byte aligned gives the same result
    zz = torch.randn(1000 * 8 + 1, dtype=torch.float64, device=cuda)[1:].view(1000, 8)
    got = kernels.chol_apply(c, zz)[0]
    torch.testing.assert_close(got.cpu(), chol_apply_ref(c.cpu(), zz.cpu())[0], rtol=1e-12, atol=1e-12)
    assert kernels.launch_counts() == _counts(chol_apply=2)
    with pytest.raises(ValueError, match="t <= 16"):
        w = torch.randn(10, 17, dtype=torch.float64, device=cuda)
        kernels.chol_apply(torch.eye(17, dtype=torch.float64, device=cuda), w)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.chol_apply(c.T, z)
    with pytest.raises(TypeError, match="one dtype"):
        kernels.chol_apply(c, z, az.float())
    assert kernels.launch_counts() == _counts(chol_apply=2)


def _gram_case(rows, t, rank, dtype, seed=0):
    """(G, Z, AZ) on the CPU: Z with t − rank zero columns, AZ = A·Z on a
    1-D Laplacian stencil, G = ZᵀAZ (its dead rows and columns exactly 0)."""
    gen = torch.Generator().manual_seed(seed)
    z = torch.randn(rows, t, generator=gen, dtype=torch.float64)
    z[:, torch.randperm(t, generator=gen)[rank:]] = 0.0
    az = 2.0 * z
    az[1:] -= z[:-1]
    az[:-1] -= z[1:]
    g = z.T @ az
    return tuple(x.to(dtype).contiguous() for x in ((g + g.T) / 2, z, az))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t,rank", [(1, 1), (1, 0), (2, 1), (4, 4), (4, 2), (8, 8), (8, 4),
                                    (8, 0), (12, 7), (16, 16), (16, 9)])
@pytest.mark.parametrize("rows", [1, 530, 70001])
def test_rank_apply_matches_plain(cuda, rows, t, rank, dtype):
    g, z, az = _gram_case(max(rows, 64), t, rank, dtype, seed=t + rank)
    z, az = z[:rows].contiguous(), az[:rows].contiguous()
    rtol = default_rank_rtol(dtype)
    eps = torch.finfo(dtype).eps
    l, _, _ = pivoted_cholesky(g.double(), rtol=rtol)
    kappa = float(torch.linalg.cond(l[:rank, :rank])) if rank else 1.0
    for n_mats in (1, 2):
        kernels.reset_launch_counts()
        *got, k_rank, k_perm = kernels.rank_apply(g.to(cuda), *(m.to(cuda) for m in (z, az)[:n_mats]),
                                                  rtol=rtol)
        assert kernels.launch_counts() == _counts(rank_apply=1)
        *want, w_rank, w_perm = rank_apply_ref(g, *(z, az)[:n_mats], rtol=rtol)
        *dense, _, _ = rank_apply_dense(g, *(z, az)[:n_mats], rtol=rtol)
        assert int(k_rank) == int(w_rank) == rank and k_perm.cpu().tolist() == w_perm.tolist()
        for y, w, d in zip(got, want, dense):
            assert y.shape == (rows, t) and y.dtype == dtype and y.is_contiguous()
            tol = 2 * t * eps * kappa * float(w.abs().max())
            assert float((y.cpu().double() - w.double()).abs().max()) <= tol
            assert float((y.cpu().double() - d.double()).abs().max()) <= tol
            assert not y[:, rank:].any()
    ops = [g.to(cuda), z.to(cuda), az.to(cuda)]
    assert all(torch.equal(a, b) for a, b in zip(kernels.rank_apply(*ops, rtol=rtol),
                                                 kernels.rank_apply(*ops, rtol=rtol)))


def test_rank_apply_nan_gram_empty_block_and_checks(cuda):
    g, z, az = (x.to(cuda) for x in _gram_case(1000, 8, 8, torch.float64))
    g_nan = g.clone()
    g_nan[3, 3] = float("nan")
    kernels.reset_launch_counts()
    p, ap, rank, perm = kernels.rank_apply(g_nan, z, az, rtol=1e-10)
    _, _, w_rank, w_perm = rank_apply_ref(g_nan.cpu(), z.cpu(), az.cpu(), rtol=1e-10)
    assert int(rank) == int(w_rank) == 0 and perm.cpu().tolist() == w_perm.tolist()
    assert not p.any() and not ap.any()
    # an empty block still gets the rank and the pivot order
    _, rank0, perm0 = kernels.rank_apply(g, z[:0], rtol=1e-10)
    _, w_rank0, w_perm0 = rank_apply_ref(g.cpu(), z[:0].cpu(), rtol=1e-10)
    assert int(rank0) == int(w_rank0) == 8 and perm0.cpu().tolist() == w_perm0.tolist()
    assert kernels.launch_counts() == _counts(rank_apply=2)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.rank_apply(g, z.T.contiguous().T, rtol=1e-10)
    with pytest.raises(TypeError, match="one dtype"):
        kernels.rank_apply(g, z, az.float(), rtol=1e-10)
    assert kernels.launch_counts() == _counts(rank_apply=2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("policy", [{}, {"drop_tol": 0.0}, {"drop_tol": 0.3, "min_t": 3}],
                         ids=["default", "rankrev", "tau0.3-min3"])
@pytest.mark.parametrize("t,rank", [(1, 1), (4, 4), (8, 5), (8, 8), (16, 9), (16, 0)])
def test_drop_mask_matches_plain(cuda, t, rank, policy, dtype):
    gen = torch.Generator().manual_seed(t + rank)
    c = torch.randn(t, 3 * t, generator=gen, dtype=torch.float64)
    c /= c[:, :t].norm(dim=1, keepdim=True)
    c *= 10.0 ** torch.linspace(-4, 2, t)[torch.randperm(t, generator=gen)][:, None]
    c = c.to(dtype)[:, :t]  # a column slice of the packed payload, as the solver passes
    pol = ReductionPolicy(**policy)
    r = torch.tensor(rank, dtype=torch.int32)
    kernels.reset_launch_counts()
    mask, counts = kernels.drop_mask(c.to(cuda), r.to(cuda), 1.0, pol)
    assert kernels.launch_counts() == _counts(drop_mask=1)
    w_mask, w_counts = drop_mask_ref(c, r, 1.0, pol)
    assert mask.dtype == counts.dtype == dtype
    assert torch.equal(mask.cpu(), w_mask) and torch.equal(counts.cpu(), w_counts)


@pytest.mark.parametrize("adaptive", ["rankrev", "reduce", "reduce+restart"])
def test_adaptive_solve_on_card_matches_cpu(cuda, adaptive):
    """A right-hand side on half of 8 subdomains: the dependent directions
    drop at iteration 1, on the card as on the CPU; one ``rank_apply`` and
    one ``drop_mask`` launch per iteration, no ``chol_apply``."""
    a = fd_laplace_2d(24, device="cpu")
    n = a.shape[0]
    b = np.zeros(n)
    b[: n // 2] = np.random.default_rng(0).standard_normal(n // 2)
    cfg = SolverConfig(t=8, tol=1e-8 * np.linalg.norm(b), max_iters=2000, kernel="pallas",
                       adaptive=adaptive)
    kernels.reset_launch_counts()
    gpu = ECGSolver.build(a, config=cfg, device=cuda).solve(b)
    counts = kernels.launch_counts()
    cpu = ECGSolver.build(a, config=cfg, device="cpu").solve(b)
    k = gpu.n_iters
    assert gpu.converged and k == cpu.n_iters
    assert np.array_equal(gpu.active_hist, cpu.active_hist) and gpu.active_hist[1] == 4
    assert gpu.reduction_events() == cpu.reduction_events() and gpu.restarts == cpu.restarts
    assert counts == _counts(bsr_spmbv=k + 1, fused_gram=k, ecg_tail=k, rank_apply=k, drop_mask=k)
    x_g, x_c = gpu.x.cpu(), cpu.x
    assert float((x_g - x_c).abs().max()) <= 1e-8 * float(x_c.abs().max())


@pytest.mark.parametrize("strategy", ["3step", "optimal"])
def test_distributed_adaptive_solve_on_card_matches_cpu(cuda, strategy):
    a = fd_laplace_2d(24, device="cpu")
    n = a.shape[0]
    b = np.zeros(n)
    b[: n // 2] = np.random.default_rng(0).standard_normal(n // 2)
    cfg = SolverConfig(t=8, tol=1e-8 * np.linalg.norm(b), max_iters=2000, kernel="pallas",
                       comm=CommConfig(strategy=strategy), adaptive="reduce")
    mesh = VirtualMesh(2, 4, device=cuda)
    solver = ECGSolver.build(a, mesh, cfg)
    kernels.reset_launch_counts()
    mesh.reset_counters()
    gpu = solver.solve(b)
    counts = kernels.launch_counts()
    cpu = ECGSolver.build(a, VirtualMesh(2, 4, device="cpu"), cfg).solve(b)
    k = gpu.n_iters
    assert gpu.converged and k == cpu.n_iters and gpu.comm_segments == cpu.comm_segments
    assert gpu.comm_segments[0] == (8, 1) and gpu.comm_segments[-1][0] == 4
    assert np.array_equal(gpu.active_hist, cpu.active_hist)
    assert counts["rank_apply"] == counts["drop_mask"] == k and counts["chol_apply"] == 0
    assert mesh.psum_calls == 3 * k + 1
    x_g, x_c = solver.unshard(gpu.x), solver.unshard(cpu.x)
    assert np.abs(x_g - x_c).max() <= 1e-8 * np.abs(x_c).max()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t", WIDTHS)
@pytest.mark.parametrize("n", [1, 530, 70001])
def test_block_update_matches_plain_and_leaves_inputs(cuda, n, t, dtype):
    rows = [torch.randn(n, t, dtype=dtype, device=cuda) for _ in range(4)]
    c = torch.randn(t, 3 * t, dtype=dtype, device=cuda)[:, :t]  # a column slice
    before = [m.clone() for m in rows]
    kernels.reset_launch_counts()
    got = kernels.block_update(*rows, c)
    assert kernels.launch_counts() == _counts(block_update=1)
    want = block_update_ref(*(m.cpu() for m in rows), c.cpu())
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, **_tol(dtype))
    for m, m0 in zip(rows, before):
        assert torch.equal(m, m0)


@pytest.mark.parametrize("t", [1, 8])
def test_csr_product_is_bit_identical_run_to_run(cuda, t):
    a = dg_laplace_2d((24, 24), block=16, device=cuda)
    v = torch.randn(a.shape[0], t, dtype=torch.float64, device=cuda)
    w1, w2 = csr_spmbv(a, v), csr_spmbv(a, v)
    assert torch.equal(w1, w2)
    want = csr_spmbv(a.to("cpu"), v.cpu())
    torch.testing.assert_close(w1.cpu(), want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("kind", ["block_jacobi", "chebyshev", "inexact"])
@pytest.mark.parametrize("mesh_shape", [None, (2, 4)])
def test_preconditioned_solve_on_card_matches_cpu(cuda, kind, mesh_shape):
    a = fd_laplace_2d(24, device="cpu")
    b = np.random.default_rng(0).standard_normal(a.shape[0])
    prec = dict(kind="block_jacobi", block=16) if kind == "block_jacobi" else kind
    cfg = SolverConfig(t=4, tol=1e-8 * np.linalg.norm(b), max_iters=2000, kernel="pallas",
                       precondition=prec)

    def build(device):
        if mesh_shape is None:
            return ECGSolver.build(a, config=cfg, device=device)
        return ECGSolver.build(a, VirtualMesh(*mesh_shape, device=device), cfg)

    solver = build(cuda)
    kernels.reset_launch_counts()
    gpu = solver.solve(b)
    counts = kernels.launch_counts()
    cpu = build("cpu").solve(b)
    k = gpu.n_iters
    assert gpu.converged and cpu.converged
    assert counts["fused_gram"] == 0 and counts["ecg_tail"] == k
    assert counts["block_trisolve"] == (k + 1 if kind == "block_jacobi" else 0)
    assert counts["chol_apply"] == k
    x_g, x_c = solver.unshard(gpu.x), solver.unshard(cpu.x)
    if kind != "inexact":
        assert k == cpu.n_iters
        assert np.abs(x_g - x_c).max() <= 1e-8 * np.abs(x_c).max()
    else:
        # the iteration-varying apply and its reseeds amplify the summation
        # order's rounding, so the card's iteration count may differ from
        # the CPU's by a few percent (chip_smoke.py's sequential and
        # distributed inexact solves part by more); both solves reach
        # 1e-8·‖b‖, so x agrees to κ(A)·1e-8 (κ ≈ 240)
        assert abs(k - cpu.n_iters) <= 0.1 * cpu.n_iters
        assert gpu.reseed_events() == list(range(8, k + 1, 8))
        assert np.abs(x_g - x_c).max() <= 1e-5 * np.abs(x_c).max()


# ------------------------------------- s-step widths, schemes and overlap
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t,rank", [(17, 17), (24, 24), (24, 13), (31, 30), (32, 32), (32, 20),
                                    (32, 0)])
@pytest.mark.parametrize("rows", [1, 530, 70001])
def test_rank_apply_wide_matches_plain(cuda, rows, t, rank, dtype):
    """``rank_apply`` at the s-step scheme's widths s·t (17-32 columns, the
    dynamic shared memory past 48 KB at t >= 22 in float64): rank and
    pivot order equal to the plain version's, blocks within the bound."""
    test_rank_apply_matches_plain(cuda, rows, t, rank, dtype)


@pytest.mark.parametrize("s", [2, 4])
def test_rank_apply_on_an_sstep_gram(cuda, s):
    """The first s-step block's monomial Gram at s·t = 16 and 32 (t = 8):
    rank and pivot order equal to the plain version's."""
    a = dg_laplace_2d((8, 8), block=2, device="cpu")
    from repro_torch.core.enlarging import split_residual

    cur = split_residual(torch.as_tensor(np.random.default_rng(5).standard_normal(a.shape[0])), 8)
    vs, avs = [], []
    for _ in range(s):
        nxt = csr_spmbv(a, cur)
        vs.append(cur)
        avs.append(nxt)
        cur = nxt
    v, av = torch.cat(vs, dim=1), torch.cat(avs, dim=1)
    g = (v.T @ av).contiguous()
    rtol = default_rank_rtol(torch.float64)
    *got, rank, perm = kernels.rank_apply(g.to(cuda), v.to(cuda), av.to(cuda), rtol=rtol)
    *want, w_rank, w_perm = rank_apply_dense(g, v, av, rtol=rtol)
    assert int(rank) == int(w_rank) and perm.cpu().tolist() == w_perm.tolist()
    for y, w in zip(got, want):
        assert torch.allclose(y.cpu(), w, rtol=1e-9, atol=1e-9 * float(w.abs().max()))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("policy", [{}, {"drop_tol": 0.0}, {"drop_tol": 0.3, "min_t": 3}],
                         ids=["default", "rankrev", "tau0.3-min3"])
@pytest.mark.parametrize("t,k,live", [(8, 16, (1, 0, 1, 1, 0, 1, 1, 1)),
                                      (8, 32, (0, 1, 1, 1, 1, 1, 0, 1)),
                                      (8, 32, (1,) * 8), (32, 32, (1, 0) * 16)])
def test_drop_mask_with_a_live_mask_matches_plain(cuda, t, k, live, policy, dtype):
    """``drop_mask`` on a (t, k) c (s-step's transposed coefficient block)
    with a live mask that has holes: mask and counts equal."""
    gen = torch.Generator().manual_seed(t + k)
    c = torch.randn(t, k, generator=gen, dtype=torch.float64)
    c /= c.norm(dim=1, keepdim=True)
    c *= 10.0 ** torch.linspace(-4, 2, t)[torch.randperm(t, generator=gen)][:, None]
    c = c.to(dtype)
    act = torch.tensor(live, dtype=torch.bool)
    r = torch.tensor(k - 1, dtype=torch.int32)
    pol = ReductionPolicy(**policy)
    kernels.reset_launch_counts()
    mask, counts = kernels.drop_mask(c.to(cuda), r.to(cuda), 1.0, pol, live=act.to(cuda))
    assert kernels.launch_counts() == _counts(drop_mask=1)
    w_mask, w_counts = drop_mask_ref(c, r, 1.0, pol, live=act)
    assert torch.equal(mask.cpu(), w_mask) and torch.equal(counts.cpu(), w_counts)
    with pytest.raises(TypeError, match="bool live mask"):
        kernels.drop_mask(c.to(cuda), r.to(cuda), 1.0, pol, live=act.to(cuda, torch.int32))
    with pytest.raises(ValueError, match="t, k <= 32"):
        kernels.drop_mask(torch.zeros(8, 33, dtype=dtype, device=cuda), r.to(cuda), 1.0, pol)


METHOD_CASES = [("pipelined", 1, False, None), ("sstep", 2, False, None), ("sstep", 4, True, None),
                ("pipelined", 1, False, "reduce"), ("sstep", 2, False, "reduce")]


@pytest.mark.parametrize("method,s,reorth,adaptive", METHOD_CASES)
def test_method_solve_on_card_matches_cpu(cuda, method, s, reorth, adaptive):
    """pipelined: ``fused_gram``/``ecg_tail`` and ``chol_apply`` (or
    ``rank_apply`` + ``drop_mask``) once per iteration, ``bsr_spmbv`` once
    more for the AZ₀ seed; s-step: s SpMBVs and one ``rank_apply`` (two
    with reorth) per block, no Gram or tail kernel."""
    a = fd_laplace_2d(24, device="cpu")
    n = a.shape[0]
    b = np.random.default_rng(0).standard_normal(n)
    if adaptive:
        b[n // 2:] = 0.0
    cfg = SolverConfig(t=8, tol=1e-8 * np.linalg.norm(b), max_iters=2000, kernel="pallas",
                       method=method, adaptive=adaptive).replace(s=s, reorth=reorth)
    kernels.reset_launch_counts()
    gpu = ECGSolver.build(a, config=cfg, device=cuda).solve(b)
    counts = kernels.launch_counts()
    cpu = ECGSolver.build(a, config=cfg, device="cpu").solve(b)
    k = gpu.n_iters
    assert gpu.converged and k == cpu.n_iters
    if adaptive:
        assert np.array_equal(gpu.active_hist, cpu.active_hist)
    if method == "pipelined":
        factor = dict(rank_apply=k, drop_mask=k) if adaptive else dict(chol_apply=k)
        assert counts == _counts(bsr_spmbv=k + 2, fused_gram=k, ecg_tail=k, **factor)
    else:
        assert counts == _counts(bsr_spmbv=s * k + 1, rank_apply=(2 if reorth else 1) * k,
                                 drop_mask=k if adaptive else 0)
    x_g, x_c = gpu.x.cpu(), cpu.x
    assert float((x_g - x_c).abs().max()) <= 1e-8 * float(x_c.abs().max())


@pytest.mark.parametrize("method,s,overlap", [("classic", 1, True), ("pipelined", 1, True),
                                              ("sstep", 2, False), ("sstep", 2, True)])
def test_distributed_method_and_overlap_on_card_matches_cpu(cuda, method, s, overlap):
    """On the mesh, with the overlap schedule the interior and boundary
    products are two ``bsr_spmbv`` launches per SpMBV and the exchange
    graph replays on a side stream; x and the count equal the CPU solve's
    and the card's blocking solve's, bit for bit against the latter."""
    a = fd_laplace_2d(24, device="cpu")
    b = np.random.default_rng(0).standard_normal(a.shape[0])
    cfg = SolverConfig(t=8, tol=1e-8 * np.linalg.norm(b), max_iters=2000, kernel="pallas",
                       comm=CommConfig(strategy="optimal", overlap=overlap),
                       method=method).replace(s=s)
    mesh = VirtualMesh(2, 4, device=cuda)
    solver = ECGSolver.build(a, mesh, cfg)
    kernels.reset_launch_counts()
    mesh.reset_counters()
    gpu = solver.solve(b)
    counts = kernels.launch_counts()
    cpu = ECGSolver.build(a, VirtualMesh(2, 4, device="cpu"), cfg).solve(b)
    k = gpu.n_iters
    assert gpu.converged and k == cpu.n_iters
    spmbvs = 1 + s * k + (method == "pipelined")
    per = 2 if overlap else 1
    if overlap:
        assert solver.op.split["int_rows"].shape[1] and solver.op.split["bnd_rows"].shape[1]
    assert counts["bsr_spmbv"] == per * spmbvs
    assert counts["halo_pack"] == len(solver.op.plan.phases) * spmbvs
    from repro_torch.core.methods import get_method

    assert mesh.psum_calls == (get_method(method).psums_per_block(s) + 1) * k + 1
    x_g, x_c = solver.unshard(gpu.x), solver.unshard(cpu.x)
    assert np.abs(x_g - x_c).max() <= 1e-8 * np.abs(x_c).max()
    if overlap:
        blocking = ECGSolver.build(a, mesh, cfg.replace(overlap=False)).solve(b)
        assert blocking.n_iters == k and torch.equal(blocking.x, gpu.x)


@pytest.mark.parametrize("mesh_shape", [None, (2, 4)])
def test_solve_packed_on_card_launch_counts(cuda, mesh_shape):
    """A width-16 pack (4 requests of t = 4) runs the hand-written kernels
    at width 16: ``bsr_spmbv`` once per iteration plus the full-width
    initial residual, ``fused_gram``, ``ecg_tail``, ``rank_apply`` and
    ``drop_mask`` once per iteration; on the mesh every segment's exchange
    launches the halo kernels of its re-sliced plan.  The results equal the
    CPU pack's iteration counts, and a 32-wide pack raises before any
    launch."""
    a = fd_laplace_2d(24, device="cpu")
    rng = np.random.default_rng(0)
    bs = [rng.standard_normal(a.shape[0]) for _ in range(4)]
    tols = [1e-4, 1e-6, 1e-8, 1e-8]
    cfg = SolverConfig(t=4, tol=1e-8, max_iters=2000, kernel="pallas", adaptive="rankrev",
                       comm=CommConfig(strategy="optimal"))
    mesh = None if mesh_shape is None else VirtualMesh(*mesh_shape, device=cuda)
    solver = ECGSolver.build(a, mesh, cfg, device=None if mesh else cuda)
    kernels.reset_launch_counts()
    res = solver.solve_packed(bs, tols=tols)
    counts = kernels.launch_counts()
    k = res[0].pack["packed_iters"]
    cpu_mesh = None if mesh_shape is None else VirtualMesh(*mesh_shape, device="cpu")
    cpu = ECGSolver.build(a, cpu_mesh, cfg, device=None if cpu_mesh else "cpu").solve_packed(
        bs, tols=tols)
    assert [r.n_iters for r in res] == [r.n_iters for r in cpu]
    assert all(r.converged for r in res)
    halo = 0
    if mesh is not None:
        segs = res[0].comm_segments
        halo = len(solver.op.plan.at_width(16).phases) + sum(
            len(solver.op.plan.at_width(w).phases) * it for w, it in segs)
    assert counts == _counts(bsr_spmbv=k + 1, fused_gram=k, ecg_tail=k, rank_apply=k, drop_mask=k,
                             halo_pack=halo, halo_unpack=halo)
    kernels.reset_launch_counts()
    with pytest.raises(NotImplementedError, match="queue 2 item 4"):
        ECGSolver.build(a, mesh, cfg.replace(t=8), device=None if mesh else cuda).solve_packed(bs)
    assert kernels.launch_counts() == _counts()
