"""Port parity: row partition, machine parameters and node-aware exchange plans.

All of this is host numpy work in both packages, so every array must be
exactly equal: the partition (``partition_csr``, ``rebased_local_csr``,
``interior_boundary_split``), every ``ExchangePlan`` of the four strategies
(steps, phases, sizes, col-split) and its accounting, and ``simulate_plan``.
"""

import dataclasses

import numpy as np
import pytest

import repro.core.machines as ref_machines
import repro.core.node_aware as ref_na
import repro.sparse as ref_sparse
import repro.sparse.partition as ref_part

import repro_torch.core.machines as port_machines
import repro_torch.core.node_aware as port_na
import repro_torch.sparse.partition as port_part
from repro_torch.sparse.csr import CSRMatrix

STRATEGIES = ["standard", "2step", "3step", "optimal"]
MESHES = [(2, 4), (4, 2)]


def _ref_matrix(name):
    if name == "fd":
        return ref_sparse.fd_laplace_2d(13)  # 169 rows: uneven over 4 and 8 ranks
    return ref_sparse.dg_laplace_2d((8, 6), block=4)


def _port(ra):
    return CSRMatrix.from_numpy(ra.indptr, ra.indices, ra.data, ra.shape, device="cpu")


_PMS = {}


def _partitions(name, p):
    key = (name, p)
    if key not in _PMS:
        ra = _ref_matrix(name)
        _PMS[key] = (ref_part.partition_csr(ra, p), port_part.partition_csr(_port(ra), p))
    return _PMS[key]


def _eq_list(xs, ys):
    assert len(xs) == len(ys)
    for x, y in zip(xs, ys):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and np.array_equal(x, y)


# ------------------------------------------------------------- partition
@pytest.mark.parametrize("p", [4, 8])
@pytest.mark.parametrize("name", ["fd", "dg"])
def test_partition_equal(name, p):
    ref, port = _partitions(name, p)
    assert np.array_equal(ref.part.starts, port.part.starts)
    assert ref.part.max_local_rows == port.part.max_local_rows
    for field in ("local_indptr", "local_indices", "local_data", "halo_sources"):
        _eq_list(getattr(ref, field), getattr(port, field))
    for rc, pc in zip(ref.comms, port.comms):
        assert rc.rank == pc.rank and rc.dtype == pc.dtype
        for d_ref, d_port in ((rc.recv_rows, pc.recv_rows), (rc.send_rows, pc.send_rows)):
            assert sorted(d_ref) == sorted(d_port)
            _eq_list([d_ref[q] for q in sorted(d_ref)], [d_port[q] for q in sorted(d_port)])
        assert rc.send_bytes(t=8) == pc.send_bytes(t=8)
    assert ref.part.owner_of(np.arange(5)).tolist() == port.part.owner_of(np.arange(5)).tolist()


@pytest.mark.parametrize("p", [4, 8])
@pytest.mark.parametrize("name", ["fd", "dg"])
def test_rebased_csr_and_interior_split_equal(name, p):
    ref, port = _partitions(name, p)
    for r_tri, p_tri in zip(ref_part.rebased_local_csr(ref), port_part.rebased_local_csr(port)):
        _eq_list(r_tri[:3], p_tri[:3])
        assert r_tri[3] == p_tri[3]
    for block_row in (1, 4, 8):
        for (ri, rb), (pi, pb) in zip(ref_part.interior_boundary_split(ref, block_row),
                                      port_part.interior_boundary_split(port, block_row)):
            _eq_list([ri, rb], [pi, pb])


def test_machine_parameters_equal():
    assert set(ref_machines.MACHINES) == set(port_machines.MACHINES)
    for name, m in ref_machines.MACHINES.items():
        assert dataclasses.asdict(m) == dataclasses.asdict(port_machines.MACHINES[name])
    assert dataclasses.asdict(ref_machines.TPU_V5E_POD.with_ppn(4)) == dataclasses.asdict(
        port_machines.TPU_V5E_POD.with_ppn(4))


# ------------------------------------------------------------------ plans
def _assert_plans_equal(ref, port):
    for field in ("strategy", "n_nodes", "ppn", "halo_size", "stage_size", "col_split", "t",
                  "p", "halo_rows"):
        assert getattr(ref, field) == getattr(port, field), field
    assert len(ref.steps) == len(port.steps)
    for rs, ps in zip(ref.steps, port.steps):
        assert (rs.axis, rs.offset, rs.src, rs.dst, rs.width) == (
            ps.axis, ps.offset, ps.src, ps.dst, ps.width)
        _eq_list([rs.gather_idx, rs.scatter_pos], [ps.gather_idx, ps.scatter_pos])
    try:
        ref_phases = ref.phases
    except AssertionError as err:  # the reference's within-phase hazard check
        with pytest.raises(AssertionError, match="read/write hazard"):
            port.phases
        return str(err)
    port_phases = port.phases
    assert len(ref_phases) == len(port_phases)
    for rp, pp in zip(ref_phases, port_phases):
        assert (rp.axis, rp.src, rp.dst, rp.offsets, rp.bounds, rp.width) == (
            pp.axis, pp.src, pp.dst, pp.offsets, pp.bounds, pp.width)
        _eq_list([rp.gather_idx, rp.scatter_pos], [pp.gather_idx, pp.scatter_pos])
    return None


def _assert_accounting_equal(ref, port, packed=True):
    for f in (4, 8):
        assert ref.wire_bytes(f) == port.wire_bytes(f)
        assert ref.local_bytes(f) == port.local_bytes(f)
        assert ref.wire_bytes(f, width=1) == port.wire_bytes(f, width=1)
    if packed:
        assert ref.dispatch_count(packed=True) == port.dispatch_count(packed=True)
    assert ref.dispatch_count(packed=False) == port.dispatch_count(packed=False)
    assert ref.comm_rows() == port.comm_rows()


def _plans(name, mesh, strategy, t, col_split=None):
    n_nodes, ppn = mesh
    ref_pm, port_pm = _partitions(name, n_nodes * ppn)
    ref = ref_na.build_exchange_plan(ref_pm, n_nodes, ppn, strategy, t=t,
                                     machine=ref_machines.BLUE_WATERS, col_split=col_split)
    port = port_na.build_exchange_plan(port_pm, n_nodes, ppn, strategy, t=t,
                                       machine=port_machines.BLUE_WATERS, col_split=col_split)
    return ref, port, ref_pm, port_pm


def _assert_simulation_equal(ref, port, ref_pm, port_pm, t, at_width=None):
    n = ref_pm.a.shape[0]
    cols = t if at_width is None else at_width
    x = np.random.default_rng(n + cols).standard_normal((n, cols))
    got = port_na.simulate_plan(port, port_pm, x, at_width=at_width)
    want = ref_na.simulate_plan(ref, ref_pm, x, at_width=at_width)
    _eq_list(got, want)
    for d, h in enumerate(got):  # a correct plan delivers exactly the halo rows
        assert np.array_equal(h, x[port_pm.halo_sources[d]])


@pytest.mark.parametrize("t", [1, 2, 8])
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("name", ["fd", "dg"])
def test_exchange_plan_equal(name, mesh, strategy, t):
    ref, port, ref_pm, port_pm = _plans(name, mesh, strategy, t)
    # where the reference's packed grouping refuses a plan (a stage slot both
    # read and written within one phase), the port refuses it the same way;
    # the step-by-step plan and its replay are still equal
    _assert_plan_and_slices_equal(ref, port, ref_pm, port_pm, t, [2] if t > 2 else [])


def _assert_plan_and_slices_equal(ref, port, ref_pm, port_pm, t, widths):
    hazard = _assert_plans_equal(ref, port)
    _assert_accounting_equal(ref, port, packed=hazard is None)
    _assert_simulation_equal(ref, port, ref_pm, port_pm, t)
    for width in widths:
        try:
            ref_w = ref.at_width(width)
        except AssertionError:  # a sub-plan sharing the refused phases
            assert hazard is not None
            with pytest.raises(AssertionError, match="read/write hazard"):
                port.at_width(width)
            continue
        port_w = port.at_width(width)
        hazard_w = _assert_plans_equal(ref_w, port_w)
        _assert_accounting_equal(ref_w, port_w, packed=hazard_w is None)
        _assert_simulation_equal(ref, port, ref_pm, port_pm, t, at_width=width)


@pytest.mark.parametrize("col_split", [None, 2, 4])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("name", ["fd", "dg"])
def test_optimal_col_split_plan_equal(name, mesh, col_split):
    ref, port, ref_pm, port_pm = _plans(name, mesh, "optimal", 8, col_split=col_split)
    assert port.col_split == (col_split or ref.col_split)
    # width 3 is not a multiple of col_split 2 or 4: a rebuilt sub-plan
    _assert_plan_and_slices_equal(ref, port, ref_pm, port_pm, 8, [2, 3])


@pytest.mark.parametrize("cutoff", [16, 64])
def test_auto_col_split_splits_wide_rows(cutoff):
    """The §4.3 byte model splits rows once a unit of few wide rows exceeds
    the eager cutoff: on a 1-D Laplacian (one-row units) at t = 16 both
    packages pick the same col_split > 1 (4 at a 16-byte cutoff, 2 at 64)."""
    ra = ref_sparse.fd_laplace_2d(40, 1)
    ref_pm = ref_part.partition_csr(ra, 8)
    port_pm = port_part.partition_csr(_port(ra), 8)
    ref = ref_na.build_exchange_plan(
        ref_pm, 2, 4, "optimal", t=16,
        machine=dataclasses.replace(ref_machines.BLUE_WATERS, eager_cutoff=cutoff))
    port = port_na.build_exchange_plan(
        port_pm, 2, 4, "optimal", t=16,
        machine=dataclasses.replace(port_machines.BLUE_WATERS, eager_cutoff=cutoff))
    assert port.col_split == ref.col_split == {16: 4, 64: 2}[cutoff]
    _assert_plan_and_slices_equal(ref, port, ref_pm, port_pm, 16, [1, 4])


def test_unknown_strategy_raises():
    _, port_pm = _partitions("fd", 8)
    with pytest.raises(ValueError, match="unknown strategy"):
        port_na.build_exchange_plan(port_pm, 2, 4, "bogus")
