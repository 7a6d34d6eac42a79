"""Port parity: the overlapped interior/boundary SpMBV (``overlap=True``) on a
virtual (2, 4) mesh.

The reference's distributed path needs 8 devices, so its side runs as this
file executed as a script, in a subprocess with 8 forced host devices (as
``tests/test_torch_distributed.py`` does); it writes an ``.npz``.  The port
runs all 8 ranks on a ``VirtualMesh(2, 4, device="cpu")``.  Compared:

(a) the split arrays of ``_make_distributed_spmbv(..., overlap=True)``
    (``int_rows``, ``bnd_rows`` and the interior and boundary Block-ELL
    ``blocks``/``idx`` for the pallas backend, the gathered CSR triples for
    jnp), exactly equal to the reference's ``DistributedSpMBV.split``, on
    ``fd_laplace_2d(13)`` (169 rows over 8 ranks: 22 rows, not a multiple
    of the 8-row tile) and ``dg_laplace_2d((8, 6), block=4)`` (every row a
    boundary row);
(b) the overlap apply equal bit for bit to the port's blocking apply, for
    all four strategies and both backends, and within 1e-12 of max|W| of
    the reference's overlap apply (only the summation order differs);
(c) whole overlap solves (classic, pipelined, s-step s = 2) on
    ``fd_laplace_2d(13)`` at 1e-8·‖b‖: the iteration counts equal to the
    reference's ``overlap=True`` solves, ``res_hist`` within 1e-9 relative
    and x within 1e-9 of max|x|, and equal bit for bit to the port's
    blocking solve (the same products in the same order); the mesh counts
    are the blocking solve's: (psums_per_block + 1)·k + 1 psums, one
    exchange per SpMBV.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
STRATEGIES = ["standard", "2step", "3step", "optimal"]
T_APPLY, T_SOLVE = 3, 4
METHODS = [("classic", 1), ("pipelined", 1), ("sstep", 2)]


def _ref_operators(sparse):
    return {"fd": sparse.fd_laplace_2d(13), "dg": sparse.dg_laplace_2d((8, 6), block=4)}


def _block(n, t):
    return np.random.default_rng(200 + n).standard_normal((n, t))


def _rhs(n):
    return np.random.default_rng(n).standard_normal(n)


# ----------------------------------------------------------- reference side
def _reference_results(out_path):
    """Runs in the subprocess: the reference's split arrays, overlap applies
    and overlap solves."""
    import jax

    jax.config.update("jax_enable_x64", True)
    import repro.sparse as ref_sparse
    from repro.core.machines import BLUE_WATERS
    from repro.solver import CommConfig, ECGSolver, SolverConfig
    from repro.sparse.spmbv import _make_distributed_spmbv

    mesh = jax.make_mesh((2, 4), ("node", "proc"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
    out = {}
    for name, a in _ref_operators(ref_sparse).items():
        n = a.shape[0]
        for backend in ("jnp", "pallas"):
            for strategy in STRATEGIES:
                op = _make_distributed_spmbv(a, mesh, strategy, t=T_APPLY, machine=BLUE_WATERS,
                                             backend=backend, overlap=True)
                if strategy == "standard":
                    for key, arr in op.split.items():
                        out[f"split/{name}/{backend}/{key}"] = np.asarray(arr)
                w = op.unshard(jax.jit(op.matvec_fn())(op.shard_vector(_block(n, T_APPLY))))
                out[f"apply/{name}/{strategy}/{backend}"] = w
    a = _ref_operators(ref_sparse)["fd"]
    b = _rhs(a.shape[0])
    for method, s in METHODS:
        cfg = SolverConfig(t=T_SOLVE, tol=1e-8 * float(np.linalg.norm(b)), max_iters=500,
                           comm=CommConfig(strategy="optimal", machine=BLUE_WATERS, overlap=True),
                           kernel="pallas", method=method).replace(s=s)
        solver = ECGSolver.build(a, mesh, cfg)
        res = solver.solve(b)
        key = f"solve/{method}"
        out[key + "/n_iters"] = np.asarray(res.n_iters)
        out[key + "/res_hist"] = np.asarray(res.res_hist)
        out[key + "/x"] = solver.unshard(res.x)
    np.savez(out_path, **out)


# ---------------------------------------------------------------- port side
@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("overlap_ref") / "reference.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, __file__, str(path)], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, f"STDOUT:\n{proc.stdout}\nSTDERR:\n{proc.stderr[-4000:]}"
    return dict(np.load(path))


@pytest.fixture(scope="module")
def operators():
    import repro.sparse as ref_sparse

    from repro_torch.sparse.csr import CSRMatrix

    return {
        name: CSRMatrix.from_numpy(a.indptr, a.indices, a.data, a.shape, device="cpu")
        for name, a in _ref_operators(ref_sparse).items()
    }


def _mesh():
    from repro_torch.launch.mesh import VirtualMesh

    return VirtualMesh(2, 4, device="cpu")


def _op(a, strategy, backend, overlap, mesh=None):
    from repro_torch.core.machines import BLUE_WATERS
    from repro_torch.sparse.spmbv import _make_distributed_spmbv

    return _make_distributed_spmbv(a, mesh or _mesh(), strategy, t=T_APPLY, machine=BLUE_WATERS,
                                   backend=backend, overlap=overlap)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("name", ["fd", "dg"])
def test_split_arrays_equal_reference(reference, operators, name, backend):
    op = _op(operators[name], "standard", backend, overlap=True)
    prefix = f"split/{name}/{backend}/"
    want = {k[len(prefix):]: v for k, v in reference.items() if k.startswith(prefix)}
    keys = ["int_rows", "bnd_rows"] + (
        ["int_blocks", "int_idx", "bnd_blocks", "bnd_idx"] if backend == "pallas" else
        [f"{part}_{arr}" for part in ("int", "bnd") for arr in ("indptr", "indices", "data")])
    assert sorted(op.split) == sorted(want) == sorted(keys)
    for key in keys:
        got = op.split[key].numpy()
        assert got.dtype == want[key].dtype and got.shape == want[key].shape, key
        assert np.array_equal(got, want[key]), key
    # the blocking arrays are not built beside the split, as the reference
    assert op.ell == {} and op.csr is None
    if name == "dg":  # every DG row couples to a neighbouring rank's element
        assert op.split["int_rows"].shape[1] == 0


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("name", ["fd", "dg"])
def test_overlap_apply_equals_blocking_and_reference(reference, operators, name, strategy, backend):
    a = operators[name]
    mesh = _mesh()
    blocking = _op(a, strategy, backend, overlap=False, mesh=mesh)
    overlap = _op(a, strategy, backend, overlap=True, mesh=mesh)
    v = _block(a.shape[0], T_APPLY)
    w_b = blocking.matvec_fn()(blocking.shard_vector(v))
    mesh.reset_counters()
    w_o = overlap.matvec_fn()(overlap.shard_vector(v))
    assert torch.equal(w_o, w_b)
    # the schedule moves the same exchange: one ppermute per rotation
    assert mesh.ppermute_calls == sum(1 for s in overlap.plan.steps if s.offset)
    assert mesh.psum_calls == 0
    want = reference[f"apply/{name}/{strategy}/{backend}"]
    assert np.abs(overlap.unshard(w_o) - want).max() <= 1e-12 * np.abs(want).max()
    # the width-compacted apply of the adaptive solve rides the same schedule
    active = torch.tensor([True, False, True])
    vm = torch.as_tensor(overlap.shard_vector(v)) * active
    assert torch.equal(overlap.masked_matvec_fn(2)(vm, active), blocking.matvec_fn()(vm))


@pytest.mark.parametrize("method,s", METHODS, ids=[m for m, _ in METHODS])
def test_overlap_solve_matches_reference_and_blocking(reference, operators, method, s):
    from repro_torch.core.machines import BLUE_WATERS
    from repro_torch.core.methods import get_method
    from repro_torch.solver import CommConfig, ECGSolver, SolverConfig

    a = operators["fd"]
    b = _rhs(a.shape[0])
    mesh = _mesh()
    cfg = SolverConfig(t=T_SOLVE, tol=1e-8 * float(np.linalg.norm(b)), max_iters=500,
                       comm=CommConfig(strategy="optimal", machine=BLUE_WATERS, overlap=True),
                       kernel="pallas", method=method).replace(s=s)
    solver = ECGSolver.build(a, mesh, cfg)
    assert solver.op.overlap
    mesh.reset_counters()
    res = solver.solve(b)
    counts = (mesh.psum_calls, mesh.ppermute_calls)
    key = f"solve/{method}"
    k = int(reference[key + "/n_iters"])
    assert res.converged and res.n_iters == k
    np.testing.assert_allclose(res.res_hist.numpy()[: k + 1], reference[key + "/res_hist"][: k + 1],
                               rtol=1e-9, atol=1e-15 * float(reference[key + "/res_hist"][0]))
    want = reference[key + "/x"]
    assert np.abs(solver.unshard(res.x) - want).max() <= 1e-9 * np.abs(want).max()
    # the blocking solve: the same products in the same order
    blocking = ECGSolver.build(a, mesh, cfg.replace(overlap=False))
    mesh.reset_counters()
    rb = blocking.solve(b)
    assert rb.n_iters == k and torch.equal(rb.x, res.x)
    assert np.array_equal(rb.res_hist.numpy(), res.res_hist.numpy(), equal_nan=True)
    assert counts == (mesh.psum_calls, mesh.ppermute_calls)
    spec = get_method(method)
    assert counts[0] == (spec.psums_per_block(s) + 1) * k + 1
    n_rot = sum(1 for st in solver.op.plan.steps if st.offset)
    spmbvs = 1 + s * k + (1 if method == "pipelined" else 0)  # r₀, the loop's, the AZ₀ seed
    assert counts[1] == n_rot * spmbvs


if __name__ == "__main__":
    _reference_results(sys.argv[1])
