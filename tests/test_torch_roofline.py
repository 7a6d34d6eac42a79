"""The LM dry-run's roofline and report, held exactly to the reference's
(``repro_torch.analysis.roofline``, ``repro_torch.analysis.report``,
``repro_torch.launch.dryrun``'s cell plan) on the same inputs (CPU, no
device): every config's ``param_count``/``active_param_count`` and
``model_flops`` for each kind, ``_shape_bytes``, ``CellCost.extrapolate``,
the roofline priced with the ``V5E_*`` constants (terms, ``dominant``,
``bound_s``, the ratios, ``as_dict``) and with the H100's, the collective
bytes and op counts of recorded calls (a smoke step traced on a fake
(2, 2) world) against the reference's HLO parser on lines written for the
same calls, ``report.render`` of one JSON byte for byte, the shape cells,
each config's ``SHAPES`` and the skip records the CLI writes.  The traces
themselves: ``tests/test_torch_dryrun.py``.
"""

import json
import warnings

import pytest
import torch

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    import repro.configs as ref_configs
    from repro.analysis import report as ref_report
    from repro.analysis import roofline as ref_roofline

import repro_torch.configs as configs
from repro_torch.analysis import report, roofline
from repro_torch.core.machines import H100_ROOFLINE, V5E_ROOFLINE
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import LMMesh

B, S = 4, 16


def smoke(arch, **kw):
    return configs.get_smoke(arch).with_(dtype=torch.float32, **kw)


def trace(cfg, kind="train", shape=(2, 2), seq=S, batch=B):
    """One smoke cell traced as rank 0 of a fake world of ``shape``."""
    with dryrun.fake_world(shape[0] * shape[1]):
        mesh = LMMesh(shape, ("data", "model"), device="cpu")
        return dryrun._trace_cell(cfg, mesh, kind, seq, batch)


# ------------------------------------------------------ exact parity: counts
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_model_flops_and_param_counts_equal_the_reference(arch):
    cfg, ref = configs.get_config(arch), ref_configs.get_config(arch)
    assert cfg.param_count() == ref.param_count()
    assert cfg.active_param_count() == ref.active_param_count()
    for kind, seq, batch in configs.SHAPE_CELLS.values():
        assert roofline.model_flops(cfg, kind, seq, batch) == ref_roofline.model_flops(ref, kind, seq, batch)
    with pytest.raises(ValueError):
        roofline.model_flops(cfg, "serve", 1, 1)


def test_shape_bytes_equals_the_reference():
    for dtype in [*ref_roofline._DTYPE_BYTES, "tuple", "token"]:
        for dims in ("", "7", "256,1024", "2,0,3"):
            assert roofline._shape_bytes(dtype, dims) == ref_roofline._shape_bytes(dtype, dims)
    assert roofline._DTYPE_BYTES == ref_roofline._DTYPE_BYTES
    assert roofline._COLLECTIVES == ref_roofline._COLLECTIVES


COSTS = [
    (dict(flops=10.0, hbm_bytes=100.0, coll_bytes=4.0, coll_breakdown={"all-reduce": 4.0}),
     dict(flops=16.0, hbm_bytes=130.0, coll_bytes=6.0, coll_breakdown={"all-reduce": 6.0, "all-gather": 1.0})),
    (dict(flops=3.1e14, hbm_bytes=9.7e11, coll_bytes=2.3e10, coll_breakdown={"all-gather": 2.3e10}),
     dict(flops=5.9e14, hbm_bytes=1.7e12, coll_bytes=4.1e10, coll_breakdown={"all-gather": 4.1e10})),
]


@pytest.mark.parametrize("case", range(len(COSTS)))
@pytest.mark.parametrize("n_units", [1, 2, 24, 6.333333333333333])
def test_extrapolation_equals_the_reference(case, n_units):
    c1, c2 = COSTS[case]
    got = roofline.CellCost.extrapolate(roofline.CellCost(**c1), roofline.CellCost(**c2), n_units)
    want = ref_roofline.CellCost.extrapolate(ref_roofline.CellCost(**c1), ref_roofline.CellCost(**c2), n_units)
    assert dataclasses_dict(got) == dataclasses_dict(want)


def dataclasses_dict(c):
    return dict(flops=c.flops, hbm_bytes=c.hbm_bytes, coll_bytes=c.coll_bytes, coll_breakdown=c.coll_breakdown)


ROOFLINE_CASES = [  # (cost, chips, model flops): each term dominating once
    (dict(flops=197e12, hbm_bytes=819e9 * 2, coll_bytes=5e10 * 0.5, coll_breakdown={}), 256, 197e12 * 128),
    (dict(flops=4.4e15, hbm_bytes=1.2e12, coll_bytes=3.3e10, coll_breakdown={}), 256, 9.1e17),
    (dict(flops=1.1e12, hbm_bytes=2.0e9, coll_bytes=7.7e11, coll_breakdown={}), 512, 2.2e14),
    (dict(flops=0.0, hbm_bytes=0.0, coll_bytes=0.0, coll_breakdown={}), 256, 0.0),
]


@pytest.mark.parametrize("case", range(len(ROOFLINE_CASES)))
def test_roofline_with_v5e_constants_equals_the_reference(case):
    cost, chips, mf = ROOFLINE_CASES[case]
    got = roofline.roofline_from_cost(roofline.CellCost(**cost), chips, mf, machine=V5E_ROOFLINE)
    want = ref_roofline.roofline_from_cost(ref_roofline.CellCost(**cost), chips, mf)
    for key in ("compute_s", "memory_s", "collective_s", "model_flops_global", "hlo_flops_global",
                "chips", "dominant", "bound_s", "useful_flops_ratio"):
        assert getattr(got, key) == getattr(want, key), key
    assert got.roofline_fraction == want.roofline_fraction
    assert got.as_dict() == want.as_dict()
    assert roofline.roofline_from_cost(roofline.CellCost(**cost), chips, mf).as_dict() == want.as_dict()


def test_roofline_with_h100_constants_names_the_machine_and_an_unmeasured_link():
    cost = roofline.CellCost(flops=1e15, hbm_bytes=2e12, coll_bytes=5e10, coll_breakdown={})
    rl = roofline.roofline_from_cost(cost, 256, 1e17, machine=H100_ROOFLINE, dtype="float32")
    assert rl.peak_flops == H100_ROOFLINE.matmul_flops["float32"]
    assert rl.compute_s == 1e15 / rl.peak_flops and rl.memory_s == 2e12 / H100_ROOFLINE.hbm_bw
    d = rl.as_dict()
    assert d["machine"] == "H100"
    if H100_ROOFLINE.link_bw is None:
        assert rl.collective_s is None and d["link_bw"] == "unmeasured"
        assert rl.bound_s == max(rl.compute_s, rl.memory_s) and rl.dominant in ("compute", "memory")
    assert rl.roofline_fraction == 1e17 / (256 * rl.peak_flops) / rl.bound_s
    with pytest.raises(ValueError, match="no measured matmul rate"):
        roofline.roofline_from_cost(cost, 256, 1e17, machine=V5E_ROOFLINE, dtype="float32")
    assert roofline.matmul_dtype(torch.bfloat16) == "bfloat16"
    assert roofline.matmul_dtype(torch.float32) == "float32"


# ------------------------------------------------ collectives from the trace
def hlo_lines(records):
    """HLO instructions for recorded calls (u8 arrays: one byte an
    element), operands as the reference's HLO writes them."""
    name = {"all_gather": "all-gather", "reduce_scatter": "reduce-scatter",
            "all_reduce": "all-reduce", "all_to_all": "all-to-all", "ppermute": "collective-permute"}
    lines = []
    for i, (op, group, nbytes) in enumerate(records):
        n = len(group)
        operand = {"all_gather": nbytes // n, "reduce_scatter": nbytes * n}.get(op, nbytes)
        lines.append(f"%c.{i} = u8[{nbytes}]{{0}} {name[op]}(u8[{operand}]{{0}} %p.{i}), "
                     f"replica_groups={{{{{','.join(map(str, group))}}}}}, dimensions={{0}}")
    return "\n".join(lines)


@pytest.mark.parametrize("arch", ["stablelm_1_6b", "olmoe_1b_7b"])
def test_collective_bytes_and_counts_equal_the_reference(arch):
    records = trace(smoke(arch)).records + [("all_to_all", (0, 1), 64), ("ppermute", (0, 2), 32)]
    assert {r[0] for r in records} >= {"all_gather", "reduce_scatter", "all_reduce"}
    hlo = hlo_lines(records)
    assert roofline.collective_bytes(records) == ref_roofline.collective_bytes(hlo)
    assert roofline.count_collective_ops(records) == ref_roofline.count_collective_ops(hlo)
    with pytest.raises(ValueError, match="unknown collective"):
        roofline.collective_bytes([("broadcast", (0, 1), 4)])


# ------------------------------------------------------------------ report
def _cell(arch, shape, mesh, rl=None, **extra):
    rec = dict(arch=arch, shape=shape, kind=configs.SHAPE_CELLS[shape][0], mesh=mesh,
               chips=256 if mesh == "single" else 512, compile_s=12.5, lower_s=0.1,
               memory=dict(argument_bytes_per_dev=2**30, output_bytes_per_dev=2**30,
                           temp_bytes_per_dev=3.5 * 2**30, alias_bytes_per_dev=0),
               collective_ops_schedule={"all-gather": 148, "all-reduce": 129, "reduce-scatter": 75,
                                        "all-to-all": 0, "collective-permute": 0})
    if rl is not None:
        rec["roofline"] = rl
    return rec | extra


def _records(machine=V5E_ROOFLINE):
    out = []
    for i, (arch, shape, cost) in enumerate([
            ("stablelm_1_6b", "train_4k", (5.6e13, 2.2e12, 7.3e10)),
            ("phi35_moe_42b", "train_4k", (1e12, 1e9, 5e11)),
            ("olmoe_1b_7b", "decode_32k", (2e9, 3e11, 1e8)),
            ("granite_8b", "prefill_32k", (9e14, 1e11, 1e9)),
            ("mamba2_780m", "long_500k", (1e9, 2e9, 5e11))]):
        c = roofline.CellCost(flops=cost[0], hbm_bytes=cost[1], coll_bytes=cost[2], coll_breakdown={})
        kind, seq, batch = configs.SHAPE_CELLS[shape]
        mf = roofline.model_flops(configs.get_config(arch), kind, seq, batch)
        rl = roofline.roofline_from_cost(c, 256, mf, machine=machine).as_dict()
        out.append(_cell(arch, shape, "single", rl))
        out.append(_cell(arch, shape, "multi"))
    out.append(dict(arch="stablelm_1_6b", shape="long_500k", mesh="single", skipped="pure full attention"))
    out.append(dict(arch="stablelm_1_6b", shape="long_500k", mesh="multi", skipped="pure full attention"))
    out.append(dict(arch="whisper_medium", shape="train_4k", mesh="multi", error="ValueError: " + "x" * 300,
                    trace="..."))
    return out


def test_report_render_is_byte_equal_to_the_reference(tmp_path):
    path = tmp_path / "dryrun.json"
    path.write_text(json.dumps(_records(), indent=1))
    got = report.render(str(path))
    assert got == ref_report.render(str(path))
    assert "v5e constants" in got and "**collective**" in got and "**memory**" in got
    empty = tmp_path / "empty.json"
    empty.write_text("[]")
    assert report.render(str(empty)) == ref_report.render(str(empty))
    for r in _records():
        if "roofline" in r:
            assert report._hint(r) == ref_report._hint(r)
    assert report.fmt_bytes(3.5 * 2**30) == ref_report.fmt_bytes(3.5 * 2**30)


def test_report_names_the_h100_and_its_unmeasured_link(tmp_path):
    path = tmp_path / "dryrun.json"
    path.write_text(json.dumps(_records(H100_ROOFLINE), indent=1))
    text = report.render(str(path))
    assert "(single-pod 16x16 = 256 chips, H100 constants)" in text
    assert "unfused upper bound" in text
    if H100_ROOFLINE.link_bw is None:
        assert "| link rate unmeasured |" in text and "**collective**" not in text


# ------------------------------------------------- cells, shapes and skips
def test_cells_and_skip_records_equal_the_reference(tmp_path, capsys):
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    assert configs.SHAPE_CELLS == ref_configs.SHAPE_CELLS
    for arch in configs.ARCH_IDS:
        assert configs.get_shapes(arch) == ref_configs.get_shapes(arch)
    assert dryrun._n_units(configs.get_config("zamba2_1_2b")) == 38 / 6
    cfg = dryrun._unit_layers(configs.get_config("whisper_medium"), 2)
    assert (cfg.n_layers, cfg.n_enc_layers, cfg.unroll) == (2, 2, True)
    assert dryrun._unit_layers(configs.get_config("zamba2_1_2b"), 1).n_layers == 6
    # every runnable cell already done: the CLI writes the skips alone
    keys = [(a, s, m) for m in ("single", "multi") for a in ref_configs.ARCH_IDS
            for s in ref_configs.SHAPE_CELLS]
    status = {k: ref_configs.get_shapes(k[0])[k[1]] for k in keys}
    done = [dict(arch=a, shape=s, mesh=m) for (a, s, m) in keys if status[(a, s, m)] == "run"]
    out = tmp_path / "dryrun.json"
    out.write_text(json.dumps(done))
    assert dryrun.main(["--out", str(out), "--device", "cpu"]) == 0
    got = [r for r in json.loads(out.read_text()) if "skipped" in r]
    want = [dict(arch=a, shape=s, mesh=m, skipped=status[(a, s, m)][5:]) for (a, s, m) in keys
            if status[(a, s, m)].startswith("skip:")]
    assert sorted(map(json.dumps, got)) == sorted(map(json.dumps, want))
    printed = capsys.readouterr().out.splitlines()
    assert sum(ln.startswith("SKIP ") for ln in printed) == len(want)
    assert printed[-1] == f"done: {len(done) + len(want)} cells, 0 failures"


