"""The LM dry-run's traces (``repro_torch.launch.dryrun``,
``repro_torch.launch.perf``'s transformer cells) on ``fake`` worlds in
this process (``fake_world``; nothing is launched): the six families'
abstract state against what ``init_params`` makes and their train /
prefill / decode cells on a fake (2, 2) world, 1- and 2-layer traces
extrapolating exactly to the 3-layer trace (dense and MoE), one-device
traces against ``FlopCounterMode`` of the real CPU steps, and perf's
lever rows on smoke configs.  The fake trace's collective calls against a
real gloo world's: ``tests/test_torch_lm_sharded.py``; the roofline and
report against the reference's: ``tests/test_torch_roofline.py``.
"""

import json

import pytest
import torch

import repro_torch.configs as configs
from repro_torch.analysis import roofline
from repro_torch.launch import dryrun, perf
from repro_torch.launch.mesh import LMMesh
from repro_torch.models.common import MeshAxes
from repro_torch.models.registry import model_api

B, S = 4, 16
FAMILIES = {"dense": "stablelm_1_6b", "vlm": "paligemma_3b", "moe": "olmoe_1b_7b",
            "ssm": "mamba2_780m", "hybrid": "zamba2_1_2b", "encdec": "whisper_medium"}


def smoke(arch, **kw):
    return configs.get_smoke(arch).with_(dtype=torch.float32, **kw)


def trace(cfg, kind="train", shape=(2, 2), seq=S, batch=B):
    """One smoke cell traced as rank 0 of a fake world of ``shape``."""
    with dryrun.fake_world(shape[0] * shape[1]):
        mesh = LMMesh(shape, ("data", "model"), device="cpu")
        return dryrun._trace_cell(cfg, mesh, kind, seq, batch)


# ------------------------------------------------------- traced smoke cells
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_abstract_state_has_init_params_shapes_and_traces_every_kind(family):
    """Each family's abstract parameters (one process's blocks on a fake (2,
    2) world) have ``init_params``' names, shapes and dtypes; its train,
    prefill and decode cells (one layer unit) trace, count FLOPs and calls,
    and stay inside the tracker's peak."""
    arch = FAMILIES[family]
    cfg = configs.get_smoke(arch)  # the config's own dtype
    api = model_api(cfg)
    with dryrun.fake_world(4):
        mesh = LMMesh((2, 2), ("data", "model"), device="cpu")
        specs = api.param_specs(cfg, MeshAxes.from_mesh(mesh))
        full = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu", mesh=mesh, specs=specs)
        abstract = api.abstract_params(cfg, "cpu", mesh, specs)
    want = {n: (tuple(p.shape), p.dtype) for n, p in full.named_parameters()}
    assert {n: (tuple(p.shape), p.dtype) for n, p in abstract.named_parameters()} == want
    for kind in ("train", "prefill", "decode"):
        tr = trace(dryrun._unit_layers(cfg, 1), kind)
        assert tr.flops > 0 and tr.hbm_bytes > 0 and tr.records, (kind, tr)
        assert sum(tr.calls.values()) == len(tr.records)
        assert tr.peak_bytes >= tr.argument_bytes > 0 and tr.output_bytes >= tr.alias_bytes


@pytest.fixture(scope="module")
def layer_traces():
    """Dense and MoE smoke steps at 3 layers on a fake (2, 2) world, and
    their 1- and 2-layer units: {arch: [1, 2, 3 layers]}."""
    out = {}
    for arch in ("stablelm_1_6b", "olmoe_1b_7b"):
        cfg = smoke(arch, n_layers=3)
        out[arch] = [trace(dryrun._unit_layers(cfg, 1)), trace(dryrun._unit_layers(cfg, 2)), trace(cfg)]
    return out


@pytest.mark.parametrize("arch", ["stablelm_1_6b", "olmoe_1b_7b"])
def test_one_and_two_layer_traces_extrapolate_to_the_full_trace(arch, layer_traces):
    costs = [roofline.cost_from_trace(t.flops, t.hbm_bytes, t.records) for t in layer_traces[arch]]
    got = roofline.CellCost.extrapolate(costs[0], costs[1], dryrun._n_units(smoke(arch, n_layers=3)))
    assert got.flops == costs[2].flops and got.coll_bytes == costs[2].coll_bytes
    assert got.coll_breakdown == costs[2].coll_breakdown
    assert costs[1].flops > costs[0].flops


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_one_device_trace_counts_the_real_steps_flops(kind):
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.train import AdamWConfig, DataConfig, batch_at, build_serve_step, build_train_step
    from repro_torch.train import init_opt_state

    cfg = smoke("stablelm_1_6b", remat=True)
    tr = dryrun._trace_cell(cfg, None, kind, S, B, device="cpu")
    api = model_api(cfg)
    model = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    data = batch_at(DataConfig(vocab=cfg.vocab, batch=B, seq=S), 0)
    with FlopCounterMode(display=False) as counter:
        if kind == "train":
            build_train_step(cfg, AdamWConfig(), batch=B, seq=S, device="cpu").step_fn(
                model, init_opt_state(model), data)
        elif kind == "prefill":
            with torch.no_grad():
                api.loss_fn(cfg)(model, data)
        else:
            step, info = build_serve_step(cfg, B, S, device="cpu")
            step(model, info["init_cache"](), {"token": data["tokens"][:, 0],
                                               "pos": torch.zeros(B, dtype=torch.int32)})
    assert tr.flops == counter.get_total_flops() > 0
    assert tr.records == [] and tr.calls == {}


def test_perf_rows_trace_their_levers(monkeypatch, tmp_path, capsys):
    """perf's rows on the smoke phi3 (the production mesh's fake world of
    256; train_4k's batch at seq 1024): ``attn_chunk`` changes the trace,
    ``attn_seq_shard`` does not (the same program as
    ``gqa_fix+attn_chunk``, and the line says so)."""
    monkeypatch.setattr(configs, "get_config", configs.get_smoke)  # bf16, as the configs
    # train_4k's batch, a quarter of its sequence (two attention chunks of 512)
    monkeypatch.setitem(dryrun.SHAPE_CELLS, "train_4k", ("train", 1024, 256))
    out = tmp_path / "perf.json"
    assert len(perf.ITERATIONS) == 13
    for row in ("baseline", "gqa_fix+attn_chunk", "attn_seq_shard"):
        perf.main(["--device", "cpu", "--machine", "v5e", "--out", str(out),
                   "--only", f"phi3_medium_14b/train_4k/{row}"])
    recs = {r["iteration"]: r for r in json.loads(out.read_text())}
    assert list(recs) == ["baseline", "gqa_fix+attn_chunk", "attn_seq_shard"]
    assert not any("error" in r for r in recs.values()), recs
    same = recs["attn_seq_shard"]
    assert same["same_program_as"] == "gqa_fix+attn_chunk"
    assert same["no_effect"] == ["gqa_shard_fix", "attn_seq_shard"]
    assert same["roofline"] == recs["gqa_fix+attn_chunk"]["roofline"]
    assert same["coll_breakdown"] == recs["gqa_fix+attn_chunk"]["coll_breakdown"]
    assert recs["baseline"]["roofline"]["memory_s"] != recs["gqa_fix+attn_chunk"]["roofline"]["memory_s"]
    assert recs["baseline"]["no_effect"] == [] and recs["baseline"]["same_program_as"] is None
    printed = capsys.readouterr().out
    assert ("PERF phi3_medium_14b x train_4k :: attn_seq_shard (gqa_shard_fix, attn_seq_shard: no effect "
            "in the port; the same program as gqa_fix+attn_chunk)") in printed
