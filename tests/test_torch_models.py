"""Port parity: the paper's performance models and their inputs (repro_torch
vs repro), on the CPU; a twin of the reference's ``tests/test_models.py``.

The same generators run in both packages in this one process: the
Table-3 surrogates seed their id shuffle with ``hash(name) % 2**31``, which
Python randomises per process, so the two sides agree only when they are
built in the same process (ROADMAP.md, "Behaviours the port copies").
Compared, all host-side numpy or Python floats:

* ``example_2_1_graph(scale=0.25)``, ``suite_surrogate`` and
  ``surrogate_graph`` for two Table-3 names at a small scale — CSR arrays
  exactly equal;
* the ``CommGraph`` statistics of a 64-rank, 8-per-node partition and the
  ``OptimalPlan`` of every machine at t ∈ {1, 4, 8, 16} — exactly equal;
* every model function of ``core/models.py`` for ``BLUE_WATERS``,
  ``LASSEN``, ``TPU_V5E_POD`` and ``HOST`` at t ∈ {1, 4, 8, 16} — to rtol
  1e-12 (the formulas are the reference's, in its order of operations, so
  in practice equal), ``tune_strategy``'s winner exactly;
* ``ECGOperationCounts``' fields.
"""

import dataclasses

import numpy as np
import pytest

import repro.core.comm_graph as ref_cg
import repro.core.machines as ref_machines
import repro.core.models as ref_models
import repro.sparse as ref_sparse
import repro.sparse.matrices as ref_matrices
from repro.core.ecg import ECGOperationCounts as RefCounts

import repro_torch.core.comm_graph as port_cg
import repro_torch.core.machines as port_machines
import repro_torch.core.models as port_models
import repro_torch.sparse.matrices as port_matrices
from repro_torch.core.ecg import ECGOperationCounts
from repro_torch.sparse import partition_csr

MACHINES = ("BLUE_WATERS", "LASSEN", "TPU_V5E_POD", "HOST")
TS = (1, 4, 8, 16)
SURROGATES = (("Geo_1438", 0.05), ("thermal2", 0.1))
GRAPH_STATS = ("p", "ppn", "n_nodes", "row_block", "m_standard", "s_standard_rows",
               "total_standard_rows", "m_proc_to_node", "s_proc_rows", "m_node_to_node",
               "s_node_to_node_rows", "s_node_rows", "s_proc_3step_rows", "total_node_aware_rows")


def _arrays(m):
    return [np.asarray(x) for x in (m.indptr, m.indices, m.data)]


def _assert_csr_equal(port, ref):
    assert tuple(port.shape) == tuple(ref.shape)
    for got, want in zip(_arrays(port), _arrays(ref)):
        np.testing.assert_array_equal(got, want)


def _port_csr(ref):
    from repro_torch.sparse.csr import CSRMatrix

    return CSRMatrix.from_numpy(ref.indptr, ref.indices, ref.data, ref.shape, device="cpu")


def test_machine_sets_equal_reference():
    for name in MACHINES:
        assert dataclasses.asdict(getattr(port_machines, name)) == dataclasses.asdict(
            getattr(ref_machines, name))
    assert port_machines.MACHINES.keys() == ref_machines.MACHINES.keys()
    assert port_machines.H100.name == "H100" and port_machines.H100.f == 8


def test_example_2_1_graph_equals_reference():
    (g, blk), (rg, rblk) = port_matrices.example_2_1_graph(0.25, device="cpu"), \
        ref_matrices.example_2_1_graph(0.25)
    assert blk == rblk == 16 and g.shape == (80 * 64, 80 * 64)
    _assert_csr_equal(g, rg)


@pytest.mark.parametrize("name,scale", SURROGATES)
def test_surrogates_equal_reference_in_process(name, scale):
    _assert_csr_equal(port_matrices.suite_surrogate(name, scale, device="cpu"),
                      ref_sparse.suite_surrogate(name, scale))
    (g, blk), (rg, rblk) = port_matrices.surrogate_graph(name, scale, device="cpu"), \
        ref_matrices.surrogate_graph(name, scale)
    assert blk == rblk
    _assert_csr_equal(g, rg)
    assert dataclasses.asdict(port_matrices.SUITE_MATRICES[name]) == dataclasses.asdict(
        ref_matrices.SUITE_MATRICES[name])
    np.testing.assert_array_equal(port_matrices.window_shuffle_perm(1000, 64, seed=3),
                                  ref_matrices.window_shuffle_perm(1000, 64, seed=3))


@pytest.fixture(scope="module")
def graphs():
    """(port, reference) comm graphs: Example 2.1 at a quarter scale over 64
    ranks of 8 (the reference test's), and a shuffled surrogate over 16 of 4."""
    out = {}
    rg, blk = ref_matrices.example_2_1_graph(0.25)
    out["ex21"] = (port_cg.build_comm_graph(partition_csr(_port_csr(rg), 64), ppn=8, row_block=blk),
                   ref_cg.build_comm_graph(ref_sparse.partition_csr(rg, 64), ppn=8, row_block=blk))
    rg, blk = ref_matrices.surrogate_graph("Geo_1438", 0.05)
    out["geo"] = (port_cg.build_comm_graph(partition_csr(_port_csr(rg), 16), ppn=4, row_block=blk),
                  ref_cg.build_comm_graph(ref_sparse.partition_csr(rg, 16), ppn=4, row_block=blk))
    return out


@pytest.mark.parametrize("which", ["ex21", "geo"])
def test_comm_graph_statistics_equal(graphs, which):
    g, rg = graphs[which]
    for stat in GRAPH_STATS:
        assert getattr(g, stat) == getattr(rg, stat), stat
    for field in ("std_msgs", "std_rows", "node_injected_rows"):
        np.testing.assert_array_equal(getattr(g, field), getattr(rg, field))
    assert g.rows_to_node == rg.rows_to_node
    assert g.node_pair_rows == rg.node_pair_rows


def _machines(name, ppn):
    return (getattr(port_machines, name).with_ppn(ppn), getattr(ref_machines, name).with_ppn(ppn))


def _close(got, want):
    assert got == pytest.approx(want, rel=1e-12, abs=0.0)


@pytest.mark.parametrize("t", TS)
@pytest.mark.parametrize("machine", MACHINES)
def test_models_equal_reference(graphs, machine, t):
    for which in ("ex21", "geo"):
        g, rg = graphs[which]
        m, rm = _machines(machine, g.ppn)
        plan, rplan = port_cg.build_optimal_plan(g, t, m), ref_cg.build_optimal_plan(rg, t, rm)
        assert (plan.t, plan.cutoff, plan.max_msgs, plan.max_bytes) == (
            rplan.t, rplan.cutoff, rplan.max_msgs, rplan.max_bytes)
        assert plan.buffers_per_node == rplan.buffers_per_node
        for field in ("n_opt", "s_proc_opt", "intra_moved"):
            np.testing.assert_array_equal(getattr(plan, field), getattr(rplan, field))
        for fn in ("t_standard_postal", "t_standard", "t_2step", "t_3step", "t_optimal"):
            _close(getattr(port_models, fn)(g, t, m), getattr(ref_models, fn)(rg, t, rm))
        for s in port_models.STRATEGIES:
            _close(port_models.t_p2p(g, t, m, s), ref_models.t_p2p(rg, t, rm, s))
        best, times = port_models.tune_strategy(g, t, m)
        rbest, rtimes = ref_models.tune_strategy(rg, t, rm)
        assert best == rbest and times.keys() == rtimes.keys()
        for s in times:
            _close(times[s], rtimes[s])
        counts = ECGOperationCounts(n=g.p * 1000, nnz=g.p * 80_000, p=g.p, t=t)
        rcounts = RefCounts(n=g.p * 1000, nnz=g.p * 80_000, p=g.p, t=t)
        for s in port_models.STRATEGIES:
            got = port_models.t_ecg_iteration(g, counts, m, s).as_dict()
            want = ref_models.t_ecg_iteration(rg, rcounts, rm, s).as_dict()
            assert got.keys() == want.keys()
            for k in got:
                _close(got[k], want[k])
    m, rm = _machines(machine, 8)
    _close(port_models.postal(m.alpha, m.R_b, 3, 1e5 * t), ref_models.postal(rm.alpha, rm.R_b, 3, 1e5 * t))
    for ppn in (None, 1, 16):
        _close(port_models.max_rate(m, 5, 1e4 * t, ppn=ppn), ref_models.max_rate(rm, 5, 1e4 * t, ppn=ppn))
    for p in (1, 8, 1024):
        _close(port_models.t_collective(p, t, m), ref_models.t_collective(p, t, rm))
        _close(port_models.t_collective_n(p, m, 3, 7 * t), ref_models.t_collective_n(p, rm, 3, 7 * t))
    counts = ECGOperationCounts(n=10_000, nnz=90_000, p=8, t=t)
    _close(port_models.t_computation(counts, m),
           ref_models.t_computation(RefCounts(n=10_000, nnz=90_000, p=8, t=t), rm))
    for nbytes in (1e2, 1e5, 1e7):
        for where in ("socket", "node", "network"):
            _close(port_models.ping_time(m, nbytes * t, where, active=t),
                   ref_models.ping_time(rm, nbytes * t, where, active=t))
        _close(port_models.split_send_time(m, nbytes, t), ref_models.split_send_time(rm, nbytes, t))
    for mod in (port_models, ref_models):
        with pytest.raises(ValueError):
            mod.ping_time(m, 1.0, "moon")


@pytest.mark.parametrize("t", TS)
def test_operation_counts_equal_reference(t):
    got, want = ECGOperationCounts(n=81_920, nnz=6_553_600, p=64, t=t), RefCounts(
        n=81_920, nnz=6_553_600, p=64, t=t)
    for field in ("spmbv_flops", "gram_flops", "fused_gram_flops", "cholesky_flops", "trsm_flops",
                  "update_flops", "total_flops", "allreduce_payload_floats"):
        assert getattr(got, field) == getattr(want, field), field


def test_iteration_model_record_equals_reference():
    got = port_models.ECGIterationModel(p2p=1e-5, collective=2e-6, computation=3e-4)
    want = ref_models.ECGIterationModel(p2p=1e-5, collective=2e-6, computation=3e-4)
    assert got.as_dict() == want.as_dict() and got.total == want.total
