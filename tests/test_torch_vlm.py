"""Port parity: the LM half's VLM prefix (paligemma-3b's family),
repro_torch vs repro on the CPU, float32.

The reference is imported with ``DeprecationWarning`` ignored and runs on
an ``AxisType.Auto`` (1, 1) mesh, as in ``tests/test_torch_lm.py``.
Weights are carried across: one numpy tree per seed, through
``params_from_reference``.  The smoke config is MQA (4 heads, 1 K/V
head, d_head 32) with an 8-patch image prefix.

* ``batch_at`` with ``extra`` patch embeddings equal to the reference's
  bit for bit (float32 and bfloat16);
* ``prefix_lm_mask`` equal to the reference's;
* the chunked ``prefix:<n>`` attention against the reference's chunked
  path and against the port's plain path under ``prefix_lm_mask``, at
  sequences the chunk divides, to 1e-5;
* ``forward(embeds=…)`` and ``loss_fn`` (the loss over the text positions
  only) to 1e-5 relative, with ``remat`` on and off and with
  ``attn_chunk``;
* three ``build_train_step`` steps against the reference's, to
  ``tests/test_torch_lm.py``'s bounds;
* eight ``decode_step`` tokens against the reference's (logits and cache
  to 1e-5 relative) and against the port's own forward;
* one bfloat16 decode step: the cache's and the logits' dtypes the
  reference's;
* ``init_params``'s rule, the full-width element count from shapes alone,
  the params and checkpoint round trips both ways, ``preset_config``
  against the reference trainer's and the CLI at ``--preset smoke
  --device cpu``.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import AxisType

import repro.configs as ref_configs
from repro.models.common import MeshAxes

import repro_torch.configs as configs
from repro_torch.launch import train as train_cli
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.registry import model_api
from repro_torch.models.transformer import stack_named
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

ARCH = "paligemma_3b"


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)


ref_train = ref_tf = ref_L = ref_launch = None


@pytest.fixture(scope="module", autouse=True)
def _reference_lm():
    """Import the reference's LM modules (which import
    ``jax.experimental.shard_map``) with the deprecation ignored, when the
    tests run."""
    global ref_train, ref_tf, ref_L, ref_launch
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        import repro.train as ref_train
        from repro.models import layers as ref_L
        from repro.models import transformer as ref_tf
        from repro.launch import train as ref_launch


@pytest.fixture(scope="module", autouse=True)
def _fast_reference_compiles():
    """XLA's cheap compile for the reference's jit calls of this module."""
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


def smoke_pair(dtype=(jnp.float32, torch.float32), **kw):
    """The reference's (``unroll``ed: a Python loop over the layers) and
    the port's paligemma SMOKE config in ``dtype``."""
    return (ref_configs.get_smoke(ARCH).with_(dtype=dtype[0], unroll=True, **kw),
            configs.get_smoke(ARCH).with_(dtype=dtype[1], **kw))


def carried_params(ref_cfg, seed=0):
    """A reference params tree (numpy, stacked) from a seed: norms
    1 + N(0, 0.1), ``emb`` N(0, 0.02), every projection N(0, fan_in^-1/2)
    with fan_in its input width."""
    rng = np.random.default_rng(seed)

    def leaf(shape, name):
        if name in ("ln1", "ln2", "final_ln"):
            v = 1 + 0.1 * rng.standard_normal(shape)
        elif name == "emb":
            v = 0.02 * rng.standard_normal(shape)
        elif name == "wo":
            v = rng.standard_normal(shape) / np.sqrt(shape[1] * shape[2])
        else:
            v = rng.standard_normal(shape) / np.sqrt(shape[1])
        return v.astype(np.float32)

    return {k: ({n: leaf(s, n) for n, s in v.items()} if isinstance(v, dict) else leaf(v, k))
            for k, v in ref_tf.param_shapes(ref_cfg).items()}


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


# ------------------------------------------------------------- host data
@pytest.mark.parametrize("dtype", [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)])
def test_batch_at_draws_the_patch_embeds_exactly(dtype):
    _, cfg = smoke_pair(dtype=dtype)
    dcfg = DataConfig(vocab=cfg.vocab, batch=2, seq=9, seed=4)
    rcfg = ref_train.DataConfig(vocab=cfg.vocab, batch=2, seq=9, seed=4)
    specs = T.train_input_specs(cfg, 2, 9)
    assert specs["patch_embeds"] == ((2, cfg.n_patches, cfg.d_model), dtype[1])
    extra = {"patch_embeds": specs["patch_embeds"]}
    rextra = {"patch_embeds": jax.ShapeDtypeStruct(specs["patch_embeds"][0], dtype[0])}
    for step in range(2):
        port, ref = batch_at(dcfg, step, extra=extra), ref_train.batch_at(rcfg, step, extra=rextra)
        assert sorted(port) == sorted(ref) == ["labels", "patch_embeds", "tokens"]
        assert port["patch_embeds"].dtype == dtype[1]
        for k in port:
            np.testing.assert_array_equal(port[k].float().numpy() if k == "patch_embeds" else port[k].numpy(),
                                          np.asarray(ref[k], np.float32 if k == "patch_embeds" else None))


@pytest.mark.parametrize("s,n", [(1, 0), (7, 3), (16, 8), (12, 12)])
def test_prefix_lm_mask(s, n):
    got = L.prefix_lm_mask(s, n)
    assert got.shape == (1, 1, s, s) and got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_L.prefix_lm_mask(s, n)))


# ------------------------------------------------------------- attention
@pytest.mark.parametrize("s,prefix", [(32, 8), (32, 13), (24, 8)])
def test_chunked_prefix_attention(mesh, s, prefix):
    rcfg, cfg = smoke_pair(attn_chunk=8)
    rng = np.random.default_rng(s + prefix)
    b, h, kv, dh = 2, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = rng.standard_normal((b, s, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, dh)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, dh)).astype(np.float32)
    kind = f"prefix:{prefix}"
    ref = jax.jit(lambda q_, k_, v_: ref_L.attention(rcfg, mesh, MeshAxes.from_mesh(mesh), q_, k_, v_, None,
                                                     mask_kind=kind))(q, k, v)
    port = L.attention(cfg, *map(torch.from_numpy, (q, k, v)), None, mask_kind=kind)
    plain = L.attention(cfg.with_(attn_chunk=0), *map(torch.from_numpy, (q, k, v)),
                        L.prefix_lm_mask(s, prefix), mask_kind=kind)
    assert rel(port, ref) < 1e-5
    assert rel(port, plain) < 1e-5
    # the prefix is attended to from every position: not the causal result
    causal = L.attention(cfg, *map(torch.from_numpy, (q, k, v)), None, mask_kind="causal")
    assert rel(port, causal) > 1e-2


def test_chunked_attention_refuses_an_unknown_mask_kind():
    _, cfg = smoke_pair(attn_chunk=8)
    x = torch.zeros(1, 16, cfg.n_heads, cfg.head_dim)
    with pytest.raises(ValueError, match="mask_kind"):
        L.attention(cfg, x, x[:, :, :1], x[:, :, :1], None, mask_kind="prefix:x")


# ---------------------------------------------------------------- forward
@pytest.mark.parametrize("attn_chunk", [0, 8])
def test_forward_with_embeds_and_loss(mesh, attn_chunk):
    rcfg, cfg = smoke_pair(attn_chunk=attn_chunk)
    tree = carried_params(rcfg, seed=1)
    b, s = 2, 24  # 8 patches + 24 tokens: 32 positions, 4 chunks of 8
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    embeds = (0.02 * rng.standard_normal((b, cfg.n_patches, cfg.d_model))).astype(np.float32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:], "patch_embeds": embeds}
    params = to_jax(tree)
    r_x = jax.jit(lambda p, t, e: ref_tf.forward(rcfg, mesh, p, tokens=t, embeds=e)[0])(
        params, batch["tokens"], embeds)
    r_loss = jax.jit(ref_tf.loss_fn(rcfg, mesh))(params, batch)
    pbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    grads = []
    for remat in (False, True):
        c = cfg.with_(remat=remat)
        model = T.params_from_reference(tree)
        x = T.forward(c, model, pbatch["tokens"], embeds=pbatch["patch_embeds"])
        assert x.shape == (b, cfg.n_patches + s, cfg.d_model)
        assert rel(x.detach(), r_x) < 1e-5, remat
        loss = T.loss_fn(c)(model, pbatch)
        assert rel(loss.detach(), r_loss) < 1e-5, remat
        grads.append(torch.autograd.grad(loss, list(model.parameters())))
    for a, g in zip(*grads):
        assert rel(a, g) < 1e-6
    # without the image the VLM's loss is the causal decoder's
    no_img = {k: v for k, v in batch.items() if k != "patch_embeds"}
    assert rel(T.loss_fn(cfg)(model, {k: torch.from_numpy(v) for k, v in no_img.items()}).detach(),
               jax.jit(ref_tf.loss_fn(rcfg, mesh))(params, no_img)) < 1e-5


# ------------------------------------------------------------ train step
OPT = dict(lr=1e-3, eps=1e-3, warmup_steps=2, total_steps=10)  # tests/test_torch_lm.py says why
TRAIN = dict(batch=2, seq=24)


def test_three_train_steps_match_the_reference(mesh):
    rcfg, cfg = smoke_pair()
    tree = carried_params(rcfg, seed=7)
    bundle = ref_train.build_train_step(rcfg, mesh, ref_train.AdamWConfig(**OPT), **TRAIN, donate=False)
    rextra = {k: v for k, v in bundle.abstract_batch.items() if k not in ("tokens", "labels")}
    params = jax.device_put(to_jax(tree), bundle.param_shardings)
    ropt = jax.device_put(ref_train.init_opt_state(params), bundle.opt_shardings)
    model = T.params_from_reference(tree)
    opt = init_opt_state(model)
    port = build_train_step(cfg, AdamWConfig(**OPT), **TRAIN, device="cpu")
    extra = {k: v for k, v in port.input_specs.items() if k not in ("tokens", "labels")}
    assert list(extra) == list(rextra) == ["patch_embeds"]
    for step in range(3):
        rb = ref_train.batch_at(ref_train.DataConfig(vocab=cfg.vocab, **TRAIN), step, extra=rextra)
        params, ropt, rm = bundle.step_fn(params, ropt, jax.device_put(rb, bundle.batch_shardings))
        m = port.step_fn(model, opt, batch_at(DataConfig(vocab=cfg.vocab, **TRAIN), step, extra=extra))
        assert rel(m["loss"], rm["loss"]) < 1e-5
        assert rel(m["grad_norm"], rm["grad_norm"]) < 1e-5
        assert rel(m["lr"], rm["lr"]) < 1e-6
    got, want = T.params_to_reference(model), jax.tree.map(np.asarray, params)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree.leaves(want)):
        assert np.max(np.abs(a - b)) <= 1e-4 * np.max(np.abs(b)), path
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(stack_named(opt["mu"])),
                            jax.tree.leaves(jax.tree.map(np.asarray, ropt["mu"]))):
        assert np.max(np.abs(a - b)) <= 5e-4 * np.max(np.abs(b)), path


# ----------------------------------------------------------------- decode
def test_eight_decode_tokens_match_the_reference_and_the_forward(mesh):
    rcfg, cfg = smoke_pair()
    tree = carried_params(rcfg, seed=9)
    model = T.params_from_reference(tree)
    b, s_cache, n = 2, 12, 8
    toks = np.random.default_rng(10).integers(0, cfg.vocab, (b, n)).astype(np.int32)
    dev = jax.devices()[0]  # committed inputs: one compile
    params = jax.device_put(to_jax(tree), dev)
    rcache = jax.device_put(ref_tf.init_cache(rcfg, b, s_cache), dev)
    rf = jax.jit(ref_tf.decode_step(rcfg, mesh))
    step_fn, info = build_serve_step(cfg, b, s_cache, device="cpu")
    assert "prefill" not in info
    cache = info["init_cache"]()
    assert {k: tuple(v.shape) for k, v in cache.items()} == info["cache_shapes"] == {
        k: v.shape for k, v in rcache.items()}
    assert info["cache_shapes"]["k"] == (cfg.n_layers, b, s_cache, 1, cfg.head_dim)  # MQA
    with torch.no_grad():
        full = T.logits_from_hidden(cfg, model, T.forward(cfg, model, torch.from_numpy(toks)))
    for i in range(n):
        pos = np.full((b,), i, np.int32)
        rlog, rcache = rf(params, rcache, jax.device_put({"token": toks[:, i], "pos": pos}, dev))
        logits, cache = step_fn(model, cache, {"token": torch.from_numpy(toks[:, i]),
                                                "pos": torch.from_numpy(pos)})
        assert rel(logits, rlog) < 1e-5, i
        assert rel(logits, full[:, i]) < 1e-5, i
    for k in ("k", "v"):
        assert rel(cache[k], rcache[k]) < 1e-5, k
        assert np.all(cache[k][:, :, n:].numpy() == 0)


def test_bf16_decode_step_keeps_the_reference_dtypes(mesh):
    rcfg, cfg = smoke_pair(dtype=(jnp.bfloat16, torch.bfloat16))
    tree = carried_params(rcfg, seed=11)
    model = T.params_from_reference(tree, dtype=torch.bfloat16)
    rcache = ref_tf.init_cache(rcfg, 1, 8)
    step_fn, info = build_serve_step(cfg, 1, 8, device="cpu")
    cache = info["init_cache"]()
    name = lambda d: str(d).removeprefix("torch.")
    assert {k: name(v.dtype) for k, v in cache.items()} == {k: str(v.dtype) for k, v in rcache.items()} == {
        "k": "bfloat16", "v": "bfloat16"}
    rlog, rcache = jax.jit(ref_tf.decode_step(rcfg, mesh))(
        jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree), rcache,
        {"token": jnp.asarray([3], jnp.int32), "pos": jnp.asarray([0], jnp.int32)})
    logits, cache = step_fn(model, cache, {"token": torch.tensor([3], dtype=torch.int32),
                                           "pos": torch.tensor([0], dtype=torch.int32)})
    assert name(logits.dtype) == str(rlog.dtype) == "bfloat16"
    assert {k: name(v.dtype) for k, v in cache.items()} == {k: str(v.dtype) for k, v in rcache.items()}
    assert rel(logits.float(), np.asarray(rlog, np.float32)) < 2e-2


# --------------------------------------------------- params, checkpoints
def test_init_params_rule():
    rcfg, cfg = smoke_pair()
    model = T.init_params(cfg, torch.Generator().manual_seed(0))
    tree = T.params_to_reference(model)
    assert T.param_shapes(cfg) == ref_tf.param_shapes(rcfg)
    assert jax.tree.map(lambda a: a.shape, tree) == ref_tf.param_shapes(rcfg)
    # the reference's rule: leaves of at most two dims ending in d_model are
    # ones (the norms, and emb: tied, so no lm_head); the rest N(0, shape[-2]^-1/2)
    assert "lm_head" not in tree
    for w in (tree["emb"], tree["final_ln"], tree["layers"]["ln1"], tree["layers"]["ln2"]):
        assert np.all(w == 1)
    for name in ("wq", "wk", "wv", "wo", "wg", "wu", "wd"):
        w = tree["layers"][name]
        sd = w.shape[-2] ** -0.5
        assert abs(w.mean()) < 0.1 * sd and abs(w.std() - sd) < 0.1 * sd, name
    gap = (cfg.vocab_padded - cfg.vocab) * cfg.d_model + (2 * cfg.n_layers + 1) * cfg.d_model
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count() + gap


def test_full_width_element_count():
    shapes = T.param_shapes(configs.get_config(ARCH))
    count = sum(int(np.prod(s)) for s in jax.tree.leaves(shapes, is_leaf=lambda s: isinstance(s, tuple)))
    assert count == 2_508_793_856
    assert configs.get_config(ARCH).param_count() == 2_508_587_008


def test_params_round_trip():
    rcfg, _ = smoke_pair()
    tree = carried_params(rcfg)
    back = T.params_to_reference(T.params_from_reference(tree))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(tree),
                                jax.tree_util.tree_leaves_with_path(back)):
        assert pa == pb
        np.testing.assert_array_equal(a, b)


def test_checkpoints_both_ways(tmp_path):
    rcfg, cfg = smoke_pair()
    tree = carried_params(rcfg, seed=14)
    model = T.params_from_reference(tree)
    opt = init_opt_state(model)
    with torch.no_grad():
        for i, name in enumerate(opt["mu"]):
            opt["mu"][name].add_(i + 0.5)
            opt["nu"][name].add_(0.25 * i)
    opt["step"].fill_(4)
    port = {"opt": {"mu": stack_named(opt["mu"]), "nu": stack_named(opt["nu"]), "step": opt["step"].numpy()},
            "params": T.params_to_reference(model)}

    def assert_equal(a_tree, b_tree):
        assert jax.tree.structure(a_tree) == jax.tree.structure(b_tree)
        for a, b in zip(jax.tree.leaves(a_tree), jax.tree.leaves(b_tree)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    save_checkpoint(tmp_path / "port", 4, {"params": model, "opt": opt})
    like = {"params": to_jax(tree), "opt": ref_train.init_opt_state(to_jax(tree))}
    state, meta = ref_train.restore_checkpoint(tmp_path / "port", like)
    assert meta["step"] == 4
    assert_equal(jax.tree.map(np.asarray, state), port)
    ref_train.save_checkpoint(tmp_path / "ref", 6, state)
    assert latest_step(tmp_path / "ref") == 6
    fresh = T.init_params(cfg, torch.Generator().manual_seed(1))
    got, meta = restore_checkpoint(tmp_path / "ref", {"params": fresh, "opt": init_opt_state(fresh)})
    assert got["params"] is fresh and meta["step"] == 6
    assert_equal({"opt": {"mu": stack_named(got["opt"]["mu"]), "nu": stack_named(got["opt"]["nu"]),
                          "step": got["opt"]["step"].numpy()}, "params": T.params_to_reference(fresh)}, port)


# -------------------------------------------------------------- CLI, API
def test_model_api_dispatches_the_vlm_to_the_transformer():
    api = model_api(configs.get_smoke(ARCH))
    assert (api.init_params, api.loss_fn, api.decode_step, api.cache_shapes, api.init_cache,
            api.train_input_specs) == (T.init_params, T.loss_fn, T.decode_step, T.cache_shapes,
                                       T.init_cache, T.train_input_specs)


def _fields(cfg):
    d = dataclasses.asdict(cfg)
    d.pop("dtype")
    return d


def test_presets_equal_the_reference_trainer():
    for preset in ("smoke", "tiny", "100m", "full"):
        port, ref = train_cli.preset_config(ARCH, preset), ref_launch.preset_config(ARCH, preset)
        assert _fields(port) == _fields(ref), preset
        assert port.param_count() == ref.param_count(), preset
        assert T.param_shapes(port) == ref_tf.param_shapes(ref), preset


def test_cli_smoke(tmp_path, capsys):
    argv = ["--arch", ARCH, "--preset", "smoke", "--device", "cpu", "--steps", "2", "--batch", "2",
            "--seq", "16", "--log-every", "1", "--ckpt-dir", str(tmp_path)]
    train_cli.main(argv)
    out = capsys.readouterr().out.splitlines()
    cfg = configs.get_smoke(ARCH)
    assert out[0] == f"arch={cfg.name} params={cfg.param_count() / 1e6:.1f}M preset=smoke"
    steps = [line for line in out if line.startswith("step ")]
    assert len(steps) == 2 and out[-1] == "done"
    assert all(np.isfinite(float(line.split()[3])) for line in steps)
    train_cli.main(argv[:7] + ["3", "--resume"] + argv[8:])
    out = capsys.readouterr().out.splitlines()
    assert "resumed from step 2" in out
    assert [line.split()[1] for line in out if line.startswith("step ")] == ["3"]
