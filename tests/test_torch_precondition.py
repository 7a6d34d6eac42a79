"""Port parity: preconditioned ECG (repro_torch vs repro), float64 on the CPU.

Inputs are the reference's generator outputs, carried over with
``CSRMatrix.from_numpy``, and numpy arrays made from seeds.  Compared:

* the ``block_trisolve`` plain version against the reference's Pallas kernel
  in interpret mode and its oracle: 1e-12 in float64, 1e-5 in float32
  (LAPACK-style solves against substitution, blocks with κ < 10);
* the host-side pieces (block extraction and factors, slot layouts, the
  diagonal, the new generators): exactly equal;
* the λmax estimate, Chebyshev and inexact applies: 1e-12 relative (only
  the CSR product's summation order differs);
* whole handle solves per kind: equal ``n_iters`` and reseed iterations,
  ``res_hist`` within 1e-9 relative and x within 1e-9 of max|x|.  FD solves
  run to 1e-8·‖b‖, DG solves to 1e-6·‖b‖ (ROADMAP.md queue 3 says why DG
  solves stop early).
"""

import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.precondition as ref_prec
import repro.solver as ref_solver
import repro.sparse as ref_sparse
from repro.kernels.block_trisolve.kernel import block_trisolve_pallas
from repro.kernels.block_trisolve.ref import block_trisolve_dense as ref_dense
from repro.kernels.block_trisolve.ref import block_trisolve_ref as ref_trisolve
from repro.precondition import block_jacobi as ref_bj
from repro.precondition import inexact as ref_inexact
from repro.sparse.csr import csr_spmbv as ref_csr_spmbv

from repro_torch import kernels
from repro_torch.kernels.block_trisolve.ref import block_trisolve_dense
from repro_torch.launch import solve as port_cli
from repro_torch.precondition import (
    PreconditionConfig,
    build_sequential_preconditioner,
    estimate_lambda_max,
    make_chebyshev_apply,
)
from repro_torch.precondition import block_jacobi as port_bj
from repro_torch.precondition import inexact as port_inexact
from repro_torch.solver import ECGSolver, SolverConfig
from repro_torch.sparse import aniso_laplace_2d, csr_spmbv, scaled_laplace_2d
from repro_torch.sparse.csr import CSRMatrix

KINDS = ["block_jacobi", "chebyshev", "inexact"]
MATRICES = {
    "fd": lambda: ref_sparse.fd_laplace_2d(12),
    "dg": lambda: ref_sparse.dg_laplace_2d((8, 8), block=2),
}


def _port(ra):
    return CSRMatrix.from_numpy(ra.indptr, ra.indices, ra.data, ra.shape, device="cpu")


def _factors(nb, bs, seed=0):
    """Lower Cholesky factors of well-conditioned SPD blocks (κ < 10)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((nb, bs, bs))
    return np.linalg.cholesky(q @ q.transpose(0, 2, 1) / (4 * bs) + np.eye(bs))


# ------------------------------------------------------------ block_trisolve
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("t", [1, 4, 8])
@pytest.mark.parametrize("bs", [4, 8, 16])
def test_block_trisolve_plain_matches_reference(bs, t, dtype):
    nb = 5
    l = _factors(nb, bs).astype(dtype)
    x = np.random.default_rng(bs + t).standard_normal((nb, bs, t)).astype(dtype)
    got = kernels.block_trisolve(torch.as_tensor(l), torch.as_tensor(x)).numpy()
    tol = dict(rtol=1e-12, atol=1e-12) if dtype == "float64" else dict(rtol=1e-5, atol=1e-5)
    assert got.dtype == np.dtype(dtype) and got.shape == (nb, bs, t)
    np.testing.assert_allclose(got, np.asarray(block_trisolve_pallas(jnp.asarray(l), jnp.asarray(x),
                                                                     interpret=True)), **tol)
    np.testing.assert_allclose(got, np.asarray(ref_trisolve(jnp.asarray(l), jnp.asarray(x))), **tol)
    # the substitution form, as the CUDA kernel computes it
    dense = block_trisolve_dense(torch.as_tensor(l), torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(dense, np.asarray(ref_dense(jnp.asarray(l), jnp.asarray(x))), **tol)
    np.testing.assert_allclose(dense, got, **tol)


@pytest.mark.parametrize("ranks,rmax", [(1, 37), (3, 22), (3, 24)])
def test_block_trisolve_row_layout_equals_padded_apply(ranks, rmax):
    """Rows past rmax in a rank's last block read as zero: the result equals
    the reference's apply on each rank's rows padded with zeros."""
    bs, t = 8, 3
    nb_rank = -(-rmax // bs)
    l = _factors(ranks * nb_rank, bs, seed=1)
    x = np.random.default_rng(2).standard_normal((ranks * rmax, t))
    got = kernels.block_trisolve(torch.as_tensor(l), torch.as_tensor(x), ranks=ranks).numpy()
    xp = np.zeros((ranks, nb_rank * bs, t))
    xp[:, :rmax] = x.reshape(ranks, rmax, t)
    want = np.asarray(ref_trisolve(jnp.asarray(l), jnp.asarray(xp.reshape(-1, bs, t))))
    want = want.reshape(ranks, nb_rank * bs, t)[:, :rmax].reshape(-1, t)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="exceed"):
        kernels.block_trisolve(torch.as_tensor(l), torch.zeros(ranks * (nb_rank * bs + 1), t,
                                                               dtype=torch.float64), ranks=ranks)
    assert kernels.launch_counts()["block_trisolve"] == 0  # CPU tensors


def test_block_update_plain_matches_reference():
    from repro.kernels.block_update.kernel import block_update_pallas
    from repro.kernels.block_update.ref import block_update_ref as ref_update

    rng = np.random.default_rng(3)
    n, t = 530, 4
    rows = [rng.standard_normal((n, t)) for _ in range(4)]
    c = rng.standard_normal((t, t))
    got = kernels.block_update(*map(torch.as_tensor, rows + [c]))
    for want in (block_update_pallas(*map(jnp.asarray, rows + [c]), interpret=True),
                 ref_update(*map(jnp.asarray, rows + [c]))):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=1e-12)


# ------------------------------------------------------------ host-side pieces
@pytest.mark.parametrize("block", [4, 5, 8, 32])
@pytest.mark.parametrize("matrix", sorted(MATRICES))
def test_extract_and_factor_blocks_equal_reference(matrix, block):
    ra = MATRICES[matrix]()
    pa = _port(ra)
    n = ra.shape[0]
    ros_ref, ns_ref = ref_bj.slot_layout(n, block)
    ros, ns = port_bj.slot_layout(n, block)
    assert ns == ns_ref and np.array_equal(ros, ros_ref)
    want = ref_bj.extract_blocks(ra, ros_ref, block)
    got = port_bj.extract_blocks(pa, ros, block)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(port_bj.factor_blocks(got), ref_bj.factor_blocks(want))


def _extract_blocks_numpy(a, row_of_slot, block):
    """The host build of the diagonal blocks (the port's before the
    extraction moved to the CSR's device): numpy over the nonzeros."""
    indptr, indices, data = a.numpy()
    nb = row_of_slot.shape[0] // block
    out = np.zeros((nb, block, block), dtype=data.dtype)
    live = np.flatnonzero(row_of_slot >= 0)
    slot_of_row = np.full(a.shape[0], -1, np.int64)
    slot_of_row[row_of_slot[live]] = live
    sr = np.repeat(slot_of_row, np.diff(indptr.astype(np.int64)))
    sc = slot_of_row[indices.astype(np.int64)]
    keep = (sr >= 0) & (sc >= 0) & (sr // block == sc // block)
    sr, sc = sr[keep], sc[keep]
    out[sr // block, sr % block, sc % block] = data[keep]
    pad = np.flatnonzero(row_of_slot < 0)
    out[pad // block, pad % block, pad % block] = 1.0
    return out


@pytest.mark.parametrize("block", [4, 7, 16])
@pytest.mark.parametrize("matrix", sorted(MATRICES))
def test_device_extraction_equals_the_numpy_one(matrix, block):
    """The blocks built on the CSR's device equal the host build exactly,
    on the sequential slot layout and on a rank layout with padding slots
    in every rank."""
    ra = MATRICES[matrix]()
    pa = _port(ra)
    n = ra.shape[0]
    ros, _ = port_bj.slot_layout(n, block)
    p = 3
    rmax = -(-n // p) + 2
    true_row = np.full(p * rmax, -1, np.int64)
    starts = np.linspace(0, n, p + 1).astype(int)
    for r in range(p):
        true_row[r * rmax : r * rmax + starts[r + 1] - starts[r]] = np.arange(starts[r], starts[r + 1])
    for layout in (ros, port_bj.rank_slot_layout(true_row, p, block)):
        got = port_bj.extract_blocks(pa, layout, block)
        want = _extract_blocks_numpy(pa, layout, block)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_rank_slot_layout_and_blocks_equal_reference():
    ra = ref_sparse.fd_laplace_2d(13)  # 169 rows: ranks of 22 (or 21) rows
    p, rmax = 8, 22
    starts = np.linspace(0, ra.shape[0], p + 1).astype(int)
    true_row = np.full(p * rmax, -1, np.int64)
    for r in range(p):
        true_row[r * rmax : r * rmax + starts[r + 1] - starts[r]] = np.arange(starts[r], starts[r + 1])
    for block in (4, 8, 22):
        want = ref_bj.rank_slot_layout(true_row, p, block)
        got = port_bj.rank_slot_layout(true_row, p, block)
        assert np.array_equal(got, want)
        assert np.array_equal(port_bj.extract_blocks(_port(ra), got, block),
                              ref_bj.extract_blocks(ra, want, block))


def test_non_spd_operator_raises_as_reference():
    ra = ref_sparse.fd_laplace_2d(6)
    data = np.asarray(ra.data).copy()
    indptr, indices = np.asarray(ra.indptr), np.asarray(ra.indices)
    row = 9  # block 2 at block=4
    data[indptr[row] + np.flatnonzero(indices[indptr[row]:indptr[row + 1]] == row)[0]] = -1.0
    bad_ref = ra.__class__(indptr=ra.indptr, indices=ra.indices, data=jnp.asarray(data), shape=ra.shape)
    bad = CSRMatrix.from_numpy(indptr, indices, data, ra.shape, device="cpu")
    ros, _ = port_bj.slot_layout(36, 4)
    with pytest.raises(ValueError) as want:
        ref_bj.extract_blocks(bad_ref, ros, 4)
    with pytest.raises(ValueError) as got:
        port_bj.extract_blocks(bad, ros, 4)
    assert str(got.value) == str(want.value) and "block 2 " in str(got.value)
    for mod, a in ((ref_inexact, bad_ref), (port_inexact, bad)):
        with pytest.raises(ValueError, match="non-positive diagonal"):
            mod.extract_diagonal(a)


@pytest.mark.parametrize("matrix", sorted(MATRICES))
def test_extract_diagonal_equals_reference(matrix):
    ra = MATRICES[matrix]()
    pa = _port(ra)
    assert np.array_equal(port_inexact.extract_diagonal(pa), ref_inexact.extract_diagonal(ra))
    ros = np.arange(ra.shape[0] + 7) - 3  # pads at both ends
    ros[ros >= ra.shape[0]] = -1
    assert np.array_equal(port_inexact.extract_diagonal(pa, row_of_slot=ros),
                          ref_inexact.extract_diagonal(ra, row_of_slot=ros))


@pytest.mark.parametrize("gen,args", [
    ("aniso_laplace_2d", (16,)), ("aniso_laplace_2d", (7, 5, 0.3)),
    ("scaled_laplace_2d", (12,)), ("scaled_laplace_2d", (6, 9, 2.0, 4)),
])
def test_ill_conditioned_generators_equal_reference(gen, args):
    port_gen = {"aniso_laplace_2d": aniso_laplace_2d, "scaled_laplace_2d": scaled_laplace_2d}[gen]
    ra = getattr(ref_sparse, gen)(*args)
    pa = port_gen(*args, device="cpu")
    assert pa.shape == ra.shape
    for want, got in zip((ra.indptr, ra.indices, ra.data), pa.numpy()):
        assert np.array_equal(got, np.asarray(want))
    bad = {"aniso_laplace_2d": dict(eps=0.0), "scaled_laplace_2d": dict(decades=0)}[gen]
    with pytest.raises(ValueError):
        getattr(ref_sparse, gen)(4, **bad)
    with pytest.raises(ValueError):
        port_gen(4, device="cpu", **bad)


# -------------------------------------------------------------------- applies
@pytest.mark.parametrize("matrix", sorted(MATRICES))
def test_lambda_max_and_chebyshev_apply_match_reference(matrix):
    ra = MATRICES[matrix]()
    pa = _port(ra)
    lam_ref, lam = ref_prec.estimate_lambda_max(ra), estimate_lambda_max(pa)
    assert abs(lam - lam_ref) <= 1e-12 * lam_ref
    v = np.random.default_rng(4).standard_normal((ra.shape[0], 3))
    want = ref_prec.make_chebyshev_apply(lambda y: ref_csr_spmbv(ra, y), lam_ref / 30, lam_ref, 4)(jnp.asarray(v))
    got = make_chebyshev_apply(lambda y: csr_spmbv(pa, y), lam / 30, lam, 4)(torch.as_tensor(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("k", [0, 1, 6, 7])
def test_inexact_apply_matches_reference(k):
    ra = MATRICES["fd"]()
    pa = _port(ra)
    want_fn = ref_inexact.make_inexact_apply(lambda y: ref_csr_spmbv(ra, y), ref_inexact.extract_diagonal(ra),
                                             2.0 / 3.0, 3)
    got_fn = port_inexact.make_inexact_apply(lambda y: csr_spmbv(pa, y), port_inexact.extract_diagonal(pa),
                                             2.0 / 3.0, 3)
    v = np.random.default_rng(5).standard_normal((ra.shape[0], 4))
    want = np.asarray(want_fn(jnp.asarray(v), k))
    got = got_fn(torch.as_tensor(v), k).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())
    if k % 2:  # the damping varies with k's parity
        assert not np.allclose(got, got_fn(torch.as_tensor(v), k - 1).numpy())


def test_sequential_block_jacobi_apply_matches_reference():
    ra = MATRICES["fd"]()  # 144 rows: block 32 leaves a ragged last block
    pa = _port(ra)
    cfg = ref_prec.PreconditionConfig(kind="block_jacobi")
    want_fn = ref_prec.build_sequential_preconditioner(ra, cfg, None)
    got_fn = build_sequential_preconditioner(pa, PreconditionConfig(kind="block_jacobi"), None)
    assert got_fn.factors.shape == (5, 32, 32) and set(got_fn.build_s) == {"extract_s", "factor_s", "transfer_s"}
    v = np.random.default_rng(6).standard_normal((ra.shape[0], 4))
    want = np.asarray(want_fn(jnp.asarray(v), 0))
    np.testing.assert_allclose(got_fn(torch.as_tensor(v), 0).numpy(), want, rtol=1e-12, atol=1e-12)
    f32 = got_fn(torch.as_tensor(v, dtype=torch.float32), 0)  # factors cast once per dtype
    assert f32.dtype == torch.float32 and torch.float32 in got_fn._by_dtype
    np.testing.assert_allclose(f32.numpy(), want, rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------- whole solves
def _solve_pair(ra, b, tol, precondition, backend="pallas", t=4, max_iters=500):
    rcfg = ref_solver.SolverConfig(t=t, tol=tol, max_iters=max_iters, kernel=backend,
                                   precondition=precondition)
    pcfg = SolverConfig.from_json(rcfg.to_json())
    want = ref_solver.ECGSolver.build(ra, config=rcfg).solve(b)
    got = ECGSolver.build(_port(ra), config=pcfg, device="cpu").solve(b)
    return want, got


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("matrix", sorted(MATRICES))
def test_preconditioned_solve_matches_reference(matrix, kind, backend):
    ra = MATRICES[matrix]()
    b = np.random.default_rng(0).standard_normal(ra.shape[0])
    tol = (1e-8 if matrix == "fd" else 1e-6) * float(np.linalg.norm(b))
    want, got = _solve_pair(ra, b, tol, kind, backend)
    k = want.n_iters
    assert got.converged and want.converged and got.n_iters == k
    hist = np.asarray(want.res_hist)[: k + 1]
    np.testing.assert_allclose(got.res_hist.numpy()[: k + 1], hist, rtol=1e-9, atol=1e-15 * hist[0])
    x_ref = np.asarray(want.x)
    assert np.abs(got.x.numpy() - x_ref).max() <= 1e-9 * np.abs(x_ref).max()
    assert got.reseed_events() == want.reseed_events()
    assert (got.n_reseeds > 0) == (kind == "inexact") and got.n_recoveries == 0
    if kind == "inexact":
        assert got.reseed_events() == list(range(8, k + 1, 8))
        assert np.array_equal(np.asarray(got.event_hist), np.asarray(want.event_hist))
    else:
        assert got.event_hist is None and want.event_hist is None


def test_inexact_breaks_down_as_the_reference():
    """The flexible classic recurrence loses positive definiteness of its
    Gram matrix on fd_laplace_2d(64) at t = 8, in the reference as in the
    port (the guard keeps the last finite iterate)."""
    ra = ref_sparse.fd_laplace_2d(64)
    b = np.random.default_rng(0).standard_normal(ra.shape[0])
    tol = 1e-8 * float(np.linalg.norm(b))
    want, got = _solve_pair(ra, b, tol, "inexact", t=8, max_iters=1000)
    assert want.breakdown and got.breakdown and not (want.converged or got.converged)
    assert bool(torch.isfinite(got.x).all())


def test_precondition_none_is_bit_identical():
    pa = _port(MATRICES["fd"]())
    b = np.random.default_rng(1).standard_normal(pa.shape[0])
    for backend in ("jnp", "pallas"):
        cfg = SolverConfig(t=4, tol=1e-8, kernel=backend)
        plain = ECGSolver.build(pa, config=cfg, device="cpu").solve(b)
        none = ECGSolver.build(pa, config=cfg.replace(precondition="none"), device="cpu").solve(b)
        assert torch.equal(plain.x, none.x) and plain.n_iters == none.n_iters
        assert torch.equal(plain.res_hist.nan_to_num(), none.res_hist.nan_to_num())


def test_preconditioners_cut_iterations_on_anisotropic_operator():
    a = aniso_laplace_2d(16, eps=0.01, device="cpu")
    b = np.random.default_rng(2).standard_normal(a.shape[0])
    cfg = SolverConfig(t=4, tol=1e-8 * float(np.linalg.norm(b)), max_iters=2000, kernel="pallas")
    iters = {}
    for kind in ("none", "block_jacobi", "chebyshev"):
        res = ECGSolver.build(a, config=cfg.replace(precondition=kind), device="cpu").solve(b)
        assert res.converged, kind
        iters[kind] = res.n_iters
    assert iters["block_jacobi"] < iters["none"] and iters["chebyshev"] < iters["none"], iters


def test_with_config_reuses_operator_and_preconditioner():
    pa = _port(MATRICES["fd"]())
    b = np.random.default_rng(3).standard_normal(pa.shape[0])
    s = ECGSolver.build(pa, config=SolverConfig(t=4, kernel="pallas", precondition="block_jacobi"),
                        device="cpu")
    loose = s.with_config(tol=1e-4)
    assert loose.stats.op_reused and loose._apply is s._apply and loose._precond is s._precond
    assert loose.solve(b).n_iters < s.solve(b).n_iters
    # a precondition override keeps the operator and rebuilds the apply alone
    cheb = s.with_config(precondition="chebyshev")
    assert cheb.stats.op_reused and cheb._apply is s._apply and cheb._precond is not s._precond
    assert cheb.solve(b).converged
    wider = s.with_config(block=8)
    assert wider._precond.factors.shape == (18, 8, 8) and wider.solve(b).converged
    off = s.with_config(precondition="none")
    assert off._precond is None and off.solve(b).converged


def test_cli_runs_a_preconditioner(capsys):
    port_cli.main(["--matrix", "fd", "--elements", "3", "--t", "4", "--backend", "pallas",
                   "--strategy", "sequential", "--precondition", "block_jacobi", "--device", "cpu"])
    out = capsys.readouterr().out
    assert re.search(r"^preconditioner: block_jacobi$", out, re.M)
    assert re.search(r"^sequential ECG\[classic/pallas\] t=4: iters=\d+ converged=True", out, re.M)
