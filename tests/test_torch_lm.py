"""Port parity: the LM half's dense path (repro_torch vs repro), float32 on
the CPU.

The reference's LM modules import ``jax.experimental.shard_map``, which
warns ``DeprecationWarning`` (an error under this suite's filters), so
they are imported with that warning ignored; its smoke mesh has Explicit
axes, on which ``constrain`` raises, so it runs on a (1, 1) mesh with
``AxisType.Auto`` axes (ROADMAP §3).  Weights are carried across: one
numpy tree per config from a seed (``emb`` random here, where the
reference's own initialiser makes it all ones), through
``params_from_reference``.

* host data, exactly: the ten configs (``CONFIG``, ``SMOKE``, ``SHAPES``
  field for field, the derived counts), ``batch_at`` for 3 steps,
  ``lr_at`` over a schedule;
* layers to 1e-5 (relative to the output's max): ``rms_norm``, ``rope``,
  causal ``attention`` (stablelm; phi3 GQA rep 4; granite-20b MQA), the
  chunked path (``attn_chunk=8`` at seq 32), ``mlp_block`` swiglu / gelu;
* ``loss_fn`` for the four dense configs, also with ``loss_chunk``, to
  1e-5 relative;
* three train steps of stablelm against the reference's
  ``build_train_step``: loss and grad_norm to 1e-5 relative, lr to 1e-6
  (the reference's step computes it in float32), the final parameters to
  1e-4 and the first moments to 5e-4 of each leaf's max: each package's
  float32 gradients sit ~1.5e-5 of their max from a float64 run's
  (``emb``, ``ln1``, ``wk``: behind an RMS norm of small activations), and
  three steps move the two apart (the moments are the gradients);
  microbatches 2 against 1 on the port to 1e-5;
* eight ``decode_step`` tokens against the reference's: logits and caches
  to 1e-5 relative; the port's decode logits against its own forward to
  1e-5 relative;
* checkpoints both ways (values exactly equal), ``latest``, and resume
  exactness (bit for bit);
* the CLI at ``--preset smoke --device cpu``; the dispatch of the other
  families (``moe`` and ``vlm`` are the transformer's, held in
  ``tests/test_torch_moe.py`` and ``tests/test_torch_vlm.py``; ``model_api``
  sends ``encdec``, ``ssm`` and ``hybrid`` to ``models.encdec`` and
  ``models.ssm``, held in ``tests/test_torch_encdec.py`` and
  ``tests/test_torch_ssm.py``, and the transformer's own functions refuse
  them); the refusals of the sharded layout.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import AxisType

# jax warns that ``jax.experimental.shard_map`` is deprecated once a process,
# on the first lookup of ``shard_map`` there.  Many of the reference's modules
# make that lookup (``repro.models``, ``repro.sparse.spmbv``, ``repro.tune``),
# and under this suite's filter the warning is an error when a ``repro.*``
# module raises it.  A reference test then passed or failed by whether its
# worker had run a test that made the lookup with the warning ignored.  The
# lookup made here, when the suite is collected, takes that order out of the
# result: every test run after collection sees the warning spent.
with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    from jax.experimental.shard_map import shard_map as _  # noqa: F401

import repro.configs as ref_configs
from repro.models import layers as ref_L
from repro.models.common import MeshAxes

import repro_torch.configs as configs
from repro_torch.launch import train as train_cli
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.common import LM_ITEM
from repro_torch.models.common import MeshAxes as PortMeshAxes
from repro_torch.models.registry import model_api
from repro_torch.train import (
    AdamWConfig,
    DataConfig,
    batch_at,
    build_serve_step,
    build_train_step,
    init_opt_state,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.train.optimizer import lr_at

DENSE = ["stablelm_1_6b", "phi3_medium_14b", "granite_8b", "granite_20b"]
OTHER = {"moe": "olmoe_1b_7b", "vlm": "paligemma_3b", "encdec": "whisper_medium"}
SSM = {"ssm": "mamba2_780m", "hybrid": "zamba2_1_2b"}  # tests/test_torch_ssm.py


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)


ref_train = ref_tf = ref_lr_at = None


@pytest.fixture(scope="module", autouse=True)
def _reference_lm():
    """Import ``repro.train`` and ``repro.models.transformer`` (which
    import ``jax.experimental.shard_map``) with the deprecation ignored,
    when the tests run."""
    global ref_train, ref_tf, ref_lr_at
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        import repro.train as ref_train
        from repro.models import transformer as ref_tf
        from repro.train.optimizer import lr_at as ref_lr_at


def smoke_pair(arch, **kw):
    """The reference's and the port's SMOKE config in float32."""
    return (ref_configs.get_smoke(arch).with_(dtype=jnp.float32, **kw),
            configs.get_smoke(arch).with_(dtype=torch.float32, **kw))


def carried_params(ref_cfg, seed=0):
    """A reference params tree (numpy, stacked) from a seed: norms
    1 + N(0, 0.1), ``emb`` and the other 2-D weights N(0, 0.02), the rest
    N(0, fan_in^-1/2) with the reference's fan_in (``shape[-2]``)."""
    rng = np.random.default_rng(seed)
    shapes = ref_tf.param_shapes(ref_cfg)

    def leaf(shape, name):
        if name in ("ln1", "ln2", "final_ln"):
            return (1 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        scale = 0.02 if len(shape) <= 2 else shape[-2] ** -0.5
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    return {k: ({n: leaf(s, n) for n, s in v.items()} if k == "layers" else leaf(v, k))
            for k, v in shapes.items()}


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


# ------------------------------------------------------------- host data
def _cfg_fields(cfg):
    d = dataclasses.asdict(cfg)
    d["dtype"] = str(np.dtype(d["dtype"])) if not isinstance(d["dtype"], torch.dtype) else \
        str(d["dtype"]).removeprefix("torch.")
    return d


def test_arch_ids_and_shape_cells():
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    assert configs.SHAPE_CELLS == ref_configs.SHAPE_CELLS


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_configs_equal_the_reference(arch):
    for get in ("get_config", "get_smoke"):
        ref, port = getattr(ref_configs, get)(arch), getattr(configs, get)(arch)
        assert _cfg_fields(port) == _cfg_fields(ref)
        for prop in ("head_dim", "d_inner", "n_ssm_heads", "vocab_padded"):
            assert getattr(port, prop) == getattr(ref, prop), prop
        assert port.param_count() == ref.param_count()
        assert port.active_param_count() == ref.active_param_count()
        assert _cfg_fields(port.with_(n_layers=3)) == _cfg_fields(ref.with_(n_layers=3))
    assert configs.get_shapes(arch) == ref_configs.get_shapes(arch)
    assert configs.get_config(arch).dtype is torch.bfloat16


def test_stablelm_param_count():
    assert configs.get_config("stablelm_1_6b").param_count() == 1_644_167_168


def test_batch_at_is_exact():
    dcfg = DataConfig(vocab=512, batch=3, seq=17, seed=5)
    rcfg = ref_train.DataConfig(vocab=512, batch=3, seq=17, seed=5)
    for step in range(3):
        port, ref = batch_at(dcfg, step), ref_train.batch_at(rcfg, step)
        for k in ("tokens", "labels"):
            assert port[k].dtype == torch.int32
            np.testing.assert_array_equal(port[k].numpy(), np.asarray(ref[k]))


def test_lr_at_is_exact():
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=110, min_lr_ratio=0.1)
    rcfg = ref_train.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=110, min_lr_ratio=0.1)
    for step in [0, 1, 5, 9, 10, 11, 37, 60, 109, 110, 200]:
        assert lr_at(ocfg, step) == float(ref_lr_at(rcfg, step)), step


# ------------------------------------------------------------------ layers
def test_rms_norm_and_rope():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(16)).astype(np.float32)
    ref = ref_L.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5)
    port = L.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-5)
    assert rel(port, ref) < 1e-6
    pos = np.arange(3, 9)[None, :].repeat(2, 0)
    ref = ref_L.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    port = L.rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0)
    assert rel(port, ref) < 1e-5


@pytest.mark.parametrize("arch, kw, s", [
    ("stablelm_1_6b", {}, 16),
    ("phi3_medium_14b", {}, 16),          # GQA, 4 query heads a KV head
    ("granite_20b", {}, 16),              # MQA
    ("stablelm_1_6b", {"attn_chunk": 8}, 32),
])
def test_causal_attention(mesh, arch, kw, s):
    rcfg, cfg = smoke_pair(arch, **kw)
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, s, cfg.n_heads, cfg.head_dim)).astype(np.float32)
    k, v = (rng.standard_normal((2, s, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32)
            for _ in range(2))
    mask = None if cfg.attn_chunk else ref_L.causal_mask(s)
    ref = ref_L.attention(rcfg, mesh, MeshAxes.from_mesh(mesh), *map(jnp.asarray, (q, k, v)), mask,
                          mask_kind="causal")
    port_mask = None if cfg.attn_chunk else L.causal_mask(s)
    port = L.attention(cfg, *map(torch.from_numpy, (q, k, v)), port_mask, mask_kind="causal")
    assert port.shape == (2, s, cfg.n_heads, cfg.head_dim)
    assert rel(port, ref) < 1e-5


@pytest.mark.parametrize("arch", ["stablelm_1_6b", "granite_20b"])  # swiglu, gelu (tanh)
def test_mlp_block(mesh, arch):
    rcfg, cfg = smoke_pair(arch)
    tree = carried_params(rcfg)["layers"]
    p = {k: v[0] for k, v in tree.items()}
    x = np.random.default_rng(3).standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    ref = ref_L.mlp_block(rcfg, mesh, MeshAxes.from_mesh(mesh), jnp.asarray(x), to_jax(p))
    port = L.mlp_block(cfg, torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()})
    assert rel(port, ref) < 1e-5


# ------------------------------------------------------------------ model
def test_init_params_rule():
    _, cfg = smoke_pair("granite_20b")  # gelu: no wg
    model = T.init_params(cfg, torch.Generator().manual_seed(0))
    tree = T.params_to_reference(model)
    shapes = T.param_shapes(cfg)
    assert {k: v.shape for k, v in tree["layers"].items()} == shapes["layers"]
    assert tree["emb"].shape == shapes["emb"] and tree["lm_head"].shape == shapes["lm_head"]
    for ones in (tree["emb"], tree["final_ln"], tree["layers"]["ln1"], tree["layers"]["ln2"]):
        assert np.all(ones == 1)
    assert abs(tree["lm_head"].std() - 0.02) < 2e-3
    for name in ("wd", "wq", "wu"):  # fan_in = shape[-2] of the stacked shape
        w = tree["layers"][name]
        assert abs(w.std() - w.shape[-2] ** -0.5) < 0.05 * w.shape[-2] ** -0.5, name
    assert sum(p.numel() for p in model.parameters()) == (
        cfg.param_count() + (cfg.vocab_padded - cfg.vocab) * cfg.d_model * 2
        + cfg.d_model * (2 * cfg.n_layers + 1))
    assert T.param_shapes(cfg) == ref_tf.param_shapes(smoke_pair("granite_20b")[0])


def test_params_round_trip():
    rcfg, _ = smoke_pair("phi3_medium_14b")
    tree = carried_params(rcfg)
    back = T.params_to_reference(T.params_from_reference(tree))
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(tree),
                                jax.tree_util.tree_leaves_with_path(back)):
        assert pa == pb
        np.testing.assert_array_equal(a, b)


#: (loss_chunk, attn_chunk) variants: plain, both levers (the chunked
#: attention path at seq 16), and a chunk as long as the sequence (the
#: reference then drops the causal mask, and so does the port)
VARIANTS = {"stablelm_1_6b": [(0, 0), (8, 8), (0, 16)]}


@pytest.mark.parametrize("arch", DENSE)
def test_loss_fn(mesh, arch):
    rcfg, cfg = smoke_pair(arch)
    variants = VARIANTS.get(arch, [(0, 0), (8, 8)])
    tree = carried_params(rcfg, seed=4)
    model = T.params_from_reference(tree)
    batch = ref_train.batch_at(ref_train.DataConfig(vocab=cfg.vocab, batch=2, seq=16), 0)
    pbatch = batch_at(DataConfig(vocab=cfg.vocab, batch=2, seq=16), 0)
    ref = jax.jit(lambda p, b: [ref_tf.loss_fn(rcfg.with_(loss_chunk=lc, attn_chunk=ac), mesh)(p, b)
                                for lc, ac in variants])(to_jax(tree), batch)
    with torch.no_grad():
        port = [T.loss_fn(cfg.with_(loss_chunk=lc, attn_chunk=ac))(model, pbatch) for lc, ac in variants]
    for v, a, b in zip(variants, port, ref):
        assert rel(a, b) < 1e-5, v
    if (0, 16) in variants:  # unmasked: not the causal loss
        assert abs(float(port[2]) - float(port[0])) > 1e-4


# --------------------------------------------------------------- training
#: eps = 1e-3: with the default 1e-8 AdamW's step is sign(g) wherever |g| is
#: above 1e-8, so an entry whose gradient is float32 rounding noise (a sum
#: that cancels) moves by ±lr at random in either package; a larger eps
#: keeps the update smooth in g, so the comparison tests the math
OPT = dict(lr=1e-3, eps=1e-3, warmup_steps=2, total_steps=10)


def test_three_train_steps_match_the_reference(mesh):
    rcfg, cfg = smoke_pair("stablelm_1_6b")
    tree = carried_params(rcfg, seed=7)
    bundle = ref_train.build_train_step(rcfg, mesh, ref_train.AdamWConfig(**OPT), batch=4, seq=16,
                                        donate=False)
    params = to_jax(tree)
    ropt = ref_train.init_opt_state(params)
    model = T.params_from_reference(tree)
    opt = init_opt_state(model)
    step_fn = build_train_step(cfg, AdamWConfig(**OPT), batch=4, seq=16, device="cpu").step_fn
    dcfg = DataConfig(vocab=cfg.vocab, batch=4, seq=16)
    for step in range(3):
        params, ropt, rm = bundle.step_fn(params, ropt, ref_train.batch_at(
            ref_train.DataConfig(vocab=cfg.vocab, batch=4, seq=16), step))
        m = step_fn(model, opt, batch_at(dcfg, step))
        assert rel(m["loss"], rm["loss"]) < 1e-5
        assert rel(m["grad_norm"], rm["grad_norm"]) < 1e-5
        assert rel(m["lr"], rm["lr"]) < 1e-6  # the reference's step computes it in float32
    assert int(opt["step"]) == int(ropt["step"]) == 3
    got = T.params_to_reference(model)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(jax.tree.map(np.asarray, params))):
        assert np.max(np.abs(a - b)) <= 1e-4 * np.max(np.abs(b)), path
    mu = T.stack_named(opt["mu"])
    for a, b in zip(jax.tree_util.tree_leaves(mu), jax.tree_util.tree_leaves(ropt["mu"])):
        assert np.max(np.abs(a - np.asarray(b))) <= 5e-4 * np.max(np.abs(np.asarray(b)))


def test_microbatches_equal_one_batch():
    rcfg, cfg = smoke_pair("stablelm_1_6b")
    tree = carried_params(rcfg, seed=8)
    batch = batch_at(DataConfig(vocab=cfg.vocab, batch=4, seq=16), 0)
    out = {}
    for mb in (1, 2):
        model = T.params_from_reference(tree)
        opt = init_opt_state(model)
        m = build_train_step(cfg, AdamWConfig(**OPT), batch=4, seq=16, microbatches=mb,
                             device="cpu").step_fn(model, opt, batch)
        out[mb] = (m, T.params_to_reference(model))
    assert rel(out[2][0]["loss"], out[1][0]["loss"]) < 1e-5
    assert rel(out[2][0]["grad_norm"], out[1][0]["grad_norm"]) < 1e-5
    for a, b in zip(jax.tree_util.tree_leaves(out[2][1]), jax.tree_util.tree_leaves(out[1][1])):
        assert np.max(np.abs(a - b)) <= 1e-5 * np.max(np.abs(b))


# ----------------------------------------------------------------- decode
def test_eight_decode_tokens_match_the_reference_and_the_forward(mesh):
    rcfg, cfg = smoke_pair("phi3_medium_14b")  # GQA
    tree = carried_params(rcfg, seed=9)
    model = T.params_from_reference(tree)
    b, s_cache, n = 2, 12, 8
    toks = np.random.default_rng(10).integers(0, cfg.vocab, (b, n)).astype(np.int32)
    rf = jax.jit(ref_tf.decode_step(rcfg, mesh))
    rcache = ref_tf.init_cache(rcfg, b, s_cache)
    step_fn, info = build_serve_step(cfg, b, s_cache, device="cpu")
    cache = info["init_cache"]()
    assert {k: tuple(v.shape) for k, v in cache.items()} == info["cache_shapes"]
    params = to_jax(tree)
    with torch.no_grad():
        full = T.logits_from_hidden(cfg, model, T.forward(cfg, model, torch.from_numpy(toks)))
    for i in range(n):
        pos = np.full((b,), i, np.int32)
        rlog, rcache = rf(params, rcache, {"token": jnp.asarray(toks[:, i]), "pos": jnp.asarray(pos)})
        logits, cache = step_fn(model, cache, {"token": torch.from_numpy(toks[:, i]),
                                                "pos": torch.from_numpy(pos)})
        assert rel(logits, rlog) < 1e-5, i
        assert rel(logits, full[:, i]) < 1e-5, i
    for k in ("k", "v"):
        assert rel(cache[k], rcache[k]) < 1e-5
        assert np.all(cache[k][:, :, n:].numpy() == 0)


def test_row_write_equals_the_one_hot_blend():
    rng = np.random.default_rng(11)
    cache = rng.standard_normal((3, 7, 2, 4)).astype(np.float32)
    new = rng.standard_normal((3, 1, 2, 4)).astype(np.float32)
    pos = np.array([0, 4, 6], np.int32)
    blend = np.asarray(ref_tf._scatter_cache(jnp.asarray(cache), jnp.asarray(new), jnp.asarray(pos)))
    port = torch.from_numpy(cache.copy())
    port[torch.arange(3), torch.from_numpy(pos)] = torch.from_numpy(new[:, 0])
    np.testing.assert_array_equal(port.numpy(), blend)


# ------------------------------------------------------------- checkpoints
def _trained_pair(mesh, steps=1):
    """Port and reference stablelm smoke states after ``steps`` steps."""
    rcfg, cfg = smoke_pair("stablelm_1_6b")
    tree = carried_params(rcfg, seed=12)
    model = T.params_from_reference(tree)
    opt = init_opt_state(model)
    step_fn = build_train_step(cfg, AdamWConfig(**OPT), batch=2, seq=8, device="cpu").step_fn
    for s in range(steps):
        step_fn(model, opt, batch_at(DataConfig(vocab=cfg.vocab, batch=2, seq=8), s))
    params = to_jax(carried_params(rcfg, seed=13))
    ropt = ref_train.init_opt_state(params)
    ropt = {"mu": jax.tree.map(lambda x: x + 0.5, ropt["mu"]), "nu": ropt["nu"],
            "step": jnp.asarray(4, jnp.int32)}
    return model, opt, params, ropt


def _assert_port_equals_ref(model, opt, params, ropt):
    port = {"opt": {"mu": T.stack_named(opt["mu"]), "nu": T.stack_named(opt["nu"]),
                    "step": opt["step"].numpy()},
            "params": T.params_to_reference(model)}
    ref = jax.tree.map(np.asarray, {"opt": ropt, "params": params})
    assert jax.tree.structure(port) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(port), jax.tree.leaves(ref)):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_checkpoint_port_to_reference(mesh, tmp_path):
    model, opt, params, ropt = _trained_pair(mesh)
    save_checkpoint(tmp_path, 1, {"params": model, "opt": opt}, extra={"who": "port"})
    assert latest_step(tmp_path) == ref_train.latest_step(tmp_path) == 1
    assert (tmp_path / "latest").is_symlink() and (tmp_path / "step_00000001" / "leaves.npz").exists()
    state, meta = ref_train.restore_checkpoint(tmp_path, {"params": params, "opt": ropt})
    assert meta["extra"] == {"who": "port"}
    _assert_port_equals_ref(model, opt, state["params"], state["opt"])


def test_checkpoint_reference_to_port(mesh, tmp_path):
    model, opt, params, ropt = _trained_pair(mesh)
    ref_train.save_checkpoint(tmp_path, 7, {"params": params, "opt": ropt})
    ref_train.save_checkpoint(tmp_path, 9, {"params": params, "opt": ropt})
    assert latest_step(tmp_path) == 9
    state, meta = restore_checkpoint(tmp_path, {"params": model, "opt": opt}, step=7)
    assert meta["step"] == 7 and state["params"] is model
    assert state["opt"]["step"].dtype == torch.int32
    _assert_port_equals_ref(model, state["opt"], params, ropt)


def test_resume_is_exact(tmp_path):
    rcfg, cfg = smoke_pair("stablelm_1_6b")
    tree = carried_params(rcfg, seed=14)
    dcfg = DataConfig(vocab=cfg.vocab, batch=2, seq=8)
    step_fn = build_train_step(cfg, AdamWConfig(**OPT), batch=2, seq=8, device="cpu").step_fn

    def run(model, opt, steps):
        for s in steps:
            m = step_fn(model, opt, batch_at(dcfg, s))
        return m

    a, a_opt = T.params_from_reference(tree), None
    a_opt = init_opt_state(a)
    ma = run(a, a_opt, range(4))
    b = T.params_from_reference(tree)
    b_opt = init_opt_state(b)
    run(b, b_opt, range(2))
    save_checkpoint(tmp_path, 2, {"params": b, "opt": b_opt})
    c = T.init_params(cfg, torch.Generator().manual_seed(1))
    state, meta = restore_checkpoint(tmp_path, {"params": c, "opt": init_opt_state(c)})
    mc = run(c, state["opt"], range(meta["step"], 4))
    assert float(ma["loss"]) == float(mc["loss"])
    for (n, p), (_, q) in zip(a.named_parameters(), c.named_parameters()):
        assert torch.equal(p, q), n
    for k in ("mu", "nu"):
        for n in a_opt[k]:
            assert torch.equal(a_opt[k][n], state["opt"][k][n]), (k, n)


# -------------------------------------------------------------- CLI, refusals
def test_cli_smoke(tmp_path, capsys):
    argv = ["--preset", "smoke", "--device", "cpu", "--steps", "3", "--batch", "2", "--seq", "16",
            "--log-every", "1", "--ckpt-dir", str(tmp_path)]
    train_cli.main(argv)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "arch=stablelm-smoke params=0.5M preset=smoke"
    steps = [line for line in out if line.startswith("step ")]
    assert len(steps) == 3 and out[-1] == "done"
    losses = [float(line.split()[3]) for line in steps]
    assert all(np.isfinite(losses))
    assert latest_step(tmp_path) == 3
    train_cli.main(argv[:5] + ["5", "--resume"] + argv[6:])
    out = capsys.readouterr().out.splitlines()
    assert "resumed from step 3" in out
    assert [line.split()[1] for line in out if line.startswith("step ")] == ["4", "5"]


def test_cli_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--preset", "smoke", "--steps", "1"])


@pytest.mark.parametrize("family", sorted(OTHER))
def test_other_families_refused(family):
    """Every family is ported: ``model_api`` sends ``moe`` and ``vlm`` to the
    transformer and ``encdec`` to ``models.encdec``, whose family the
    transformer's own functions still refuse before any device work (its
    ``param_specs`` and ``cache_specs`` among them).  The sharded layout's
    specs of each family are the reference's (``tests/test_torch_lm_specs.py``),
    and ``encdec``'s step builds on a mesh too (its sharded execution:
    ``tests/test_torch_lm_sharded_families.py``)."""
    cfg = configs.get_smoke(OTHER[family])
    assert cfg.family == family
    own = (lambda: T.init_params(cfg, torch.Generator()), lambda: T.loss_fn(cfg),
           lambda: T.decode_step(cfg), lambda: T.param_specs(cfg, _AXES), lambda: T.cache_specs(cfg, _AXES, 1, 16))
    for call in (own if family == "encdec" else ()):
        with pytest.raises(NotImplementedError, match=LM_ITEM):
            call()
    home = {"moe": "repro_torch.models.transformer", "vlm": "repro_torch.models.transformer",
            "encdec": "repro_torch.models.encdec"}[family]
    assert model_api(cfg).init_params.__module__ == home
    assert model_api(cfg).param_specs.__module__ == home
    assert "tokens" in build_train_step(cfg, device="cpu").input_specs
    if family == "encdec":
        from repro_torch.launch.mesh import make_smoke_mesh

        assert build_train_step(cfg, mesh=make_smoke_mesh(device="cpu")).state_specs is not None
    else:  # the transformer's own functions take it
        assert T.param_specs(cfg, _AXES)["emb"] == ("model", "data")
        model = T.init_params(cfg, torch.Generator().manual_seed(0))
        layer = set(dict(model.layers[0].named_parameters()))
        assert ({"router", "we_g", "we_u", "we_d"} if family == "moe" else {"wg", "wu", "wd"}) <= layer
        assert callable(T.loss_fn(cfg)) and callable(T.decode_step(cfg))


_AXES = PortMeshAxes(batch=("data",), fsdp="data", model="model", sizes={"data": 2, "model": 2})


@pytest.mark.parametrize("family", sorted(SSM))
def test_transformer_refuses_the_ssm_families(family):
    """``model_api`` sends them to ``models.ssm``; the transformer's own
    functions still refuse them before any device work."""
    cfg = configs.get_smoke(SSM[family])
    assert cfg.family == family
    for call in (lambda: T.init_params(cfg, torch.Generator()), lambda: T.loss_fn(cfg),
                 lambda: T.decode_step(cfg)):
        with pytest.raises(NotImplementedError, match=LM_ITEM):
            call()


def test_sharded_layout_refused(tmp_path, capsys):
    """The 2-D layout runs for every family and the decode step
    (``tests/test_torch_lm_sharded*.py``): the sharded ssm and hybrid steps
    and the sharded serve step build on the smoke mesh.  The perf CLI
    without ``--ecg`` (part 6) runs its cells on a fake world of 256 (here
    none: ``--only`` matches no row; the rows are traced in
    ``tests/test_torch_dryrun.py``).  The production mesh needs a world of
    256 processes."""
    from repro_torch.launch import perf as perf_cli
    from repro_torch.launch.mesh import make_production_mesh, make_smoke_mesh

    cfg = configs.get_smoke("stablelm_1_6b")
    mesh = make_smoke_mesh(device="cpu")
    assert build_serve_step(cfg, 1, 16, device="cpu", mesh=mesh)[1]["cache_specs"]["k"] == (
        None, "data", None, "model", None)
    for a in SSM.values():
        assert build_train_step(configs.get_smoke(a), mesh=mesh).mesh is mesh
    perf_cli.main(["--device", "cpu", "--out", str(tmp_path / "perf.json"), "--only", "no such row"])
    assert capsys.readouterr().out.splitlines()[-1] == "perf pass done"
    with pytest.raises(ValueError, match="initialised torch.distributed world of 256"):
        make_production_mesh()
    assert tuple(T.param_specs(cfg, _AXES)["layers"]["wq"]) == (None, "data", "model", None)
