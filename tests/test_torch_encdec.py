"""Port parity: the LM half's encoder-decoder (whisper-medium's family),
repro_torch vs repro on the CPU, float32.

The reference is imported with ``DeprecationWarning`` ignored and runs on
an ``AxisType.Auto`` (1, 1) mesh, as in ``tests/test_torch_lm.py``.
Weights are carried across: one numpy tree per seed, through
``params_from_reference``.

* ``batch_at`` with ``extra`` frames equal to the reference's bit for bit;
* ``encode``, ``decode_train`` and ``loss_fn`` to 1e-5 relative, with
  ``remat`` on and off (the port's gradients equal across the two), and
  the ``attn_chunk`` path (a chunk dividing every key length: the 32
  frames and the 32 tokens);
* a chunk that does not divide the frames: the reference asserts, the
  port raises ``ValueError``;
* three ``build_train_step`` steps against the reference's, to
  ``tests/test_torch_lm.py``'s bounds;
* eight ``decode_step`` tokens against the reference's, the cross cache
  from each package's ``prefill_cross_cache``: logits and every cache
  leaf to 1e-5 relative; the port's decode against its own forward;
* one bfloat16 decode step: the cache's and the logits' dtypes the
  reference's;
* ``init_params``'s rule, the full-width element counts from shapes alone,
  the params and checkpoint round trips both ways (values exactly equal),
  ``preset_config`` against the reference trainer's, the CLI at
  ``--preset smoke --device cpu``, and ``model_api``'s dispatch (``moe``
  still refused, citing ROADMAP's label).
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

import repro_torch.configs as configs
from repro_torch.launch import train as train_cli
from repro_torch.models import encdec as E
from repro_torch.models import transformer as T
from repro_torch.models.common import LM_ITEM
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

ARCH = "whisper_medium"


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)


ref_train = ref_ed = ref_launch = None


@pytest.fixture(scope="module", autouse=True)
def _reference_lm():
    """Import the reference's LM modules (which import
    ``jax.experimental.shard_map``) with the deprecation ignored, when the
    tests run."""
    global ref_train, ref_ed, ref_launch
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        import repro.train as ref_train
        from repro.models import encdec as ref_ed
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
    the port's whisper SMOKE config in ``dtype``."""
    return (ref_configs.get_smoke(ARCH).with_(dtype=dtype[0], unroll=True, **kw),
            configs.get_smoke(ARCH).with_(dtype=dtype[1], **kw))


def carried_params(ref_cfg, seed=0):
    """A reference params tree (numpy, stacked) from a seed: norms
    1 + N(0, 0.1), ``emb`` and ``enc_pos`` N(0, 0.02), every projection
    N(0, fan_in^-1/2) with fan_in its input width (d_model; heads × d_head
    for ``wo``/``xo``; d_ff for ``wd``)."""
    rng = np.random.default_rng(seed)

    def leaf(shape, name):
        if "ln" in name:
            v = 1 + 0.1 * rng.standard_normal(shape)
        elif name in ("emb", "enc_pos"):
            v = 0.02 * rng.standard_normal(shape)
        elif name in ("wo", "xo"):
            v = rng.standard_normal(shape) / np.sqrt(shape[1] * shape[2])
        else:
            v = rng.standard_normal(shape) / np.sqrt(shape[1])
        return v.astype(np.float32)

    return {k: ({n: leaf(s, n) for n, s in v.items()} if isinstance(v, dict) else leaf(v, k))
            for k, v in ref_ed.param_shapes(ref_cfg).items()}


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def frames_for(cfg, b, seed):
    return np.random.default_rng(seed).standard_normal((b, cfg.enc_ctx, cfg.d_model)).astype(np.float32)


# ------------------------------------------------------------- host data
def test_batch_at_draws_the_frames_exactly():
    _, cfg = smoke_pair()
    dcfg = DataConfig(vocab=cfg.vocab, batch=2, seq=9, seed=3)
    rcfg = ref_train.DataConfig(vocab=cfg.vocab, batch=2, seq=9, seed=3)
    specs = E.train_input_specs(cfg, 2, 9)
    assert list(specs) == ["frames", "tokens", "labels"]
    extra = {k: v for k, v in specs.items() if k == "frames"}
    rextra = {"frames": jax.ShapeDtypeStruct(extra["frames"][0], jnp.float32)}
    for step in range(2):
        port, ref = batch_at(dcfg, step, extra=extra), ref_train.batch_at(rcfg, step, extra=rextra)
        assert sorted(port) == sorted(ref) == ["frames", "labels", "tokens"]
        assert port["frames"].dtype == torch.float32 and port["frames"].shape == (2, cfg.enc_ctx, cfg.d_model)
        for k in port:
            np.testing.assert_array_equal(port[k].numpy(), np.asarray(ref[k]))


# -------------------------------------------------------------- forwards
@pytest.mark.parametrize("attn_chunk", [0, 8])
def test_encode_decode_train_and_loss(mesh, attn_chunk):
    rcfg, cfg = smoke_pair(attn_chunk=attn_chunk)
    tree = carried_params(rcfg, seed=1)
    b, s = 2, 32
    frames = frames_for(cfg, b, seed=2)
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    batch = {"frames": frames, "tokens": toks[:, :-1], "labels": toks[:, 1:]}
    params = to_jax(tree)
    r_enc = jax.jit(lambda p, f: ref_ed.encode(rcfg, mesh, p, f))(params, frames)
    r_dec = jax.jit(lambda p, t, e: ref_ed.decode_train(rcfg, mesh, p, t, e))(params, batch["tokens"], r_enc)
    r_loss = jax.jit(ref_ed.loss_fn(rcfg, mesh))(params, batch)
    pbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    grads = []
    for remat in (False, True):
        c = cfg.with_(remat=remat)
        model = E.params_from_reference(tree)
        enc = E.encode(c, model, pbatch["frames"])
        assert rel(enc.detach(), r_enc) < 1e-5, remat
        dec = E.decode_train(c, model, pbatch["tokens"], enc)
        assert rel(dec.detach(), r_dec) < 1e-5, remat
        loss = E.loss_fn(c)(model, pbatch)
        assert rel(loss.detach(), r_loss) < 1e-5, remat
        grads.append(torch.autograd.grad(loss, list(model.parameters())))
    for a, g in zip(*grads):
        assert rel(a, g) < 1e-6


def test_a_chunk_must_divide_the_frames(mesh):
    rcfg, cfg = smoke_pair(attn_chunk=12)  # 32 frames
    tree = carried_params(rcfg)
    frames = frames_for(cfg, 1, seed=4)
    with pytest.raises(AssertionError):
        ref_ed.encode(rcfg, mesh, to_jax(tree), frames)
    with pytest.raises(ValueError, match="must divide the key length 32"):
        E.encode(cfg, E.params_from_reference(tree), torch.from_numpy(frames))


# ------------------------------------------------------------ train step
OPT = dict(lr=1e-3, eps=1e-3, warmup_steps=2, total_steps=10)  # tests/test_torch_lm.py says why
TRAIN = dict(batch=2, seq=32)


def test_three_train_steps_match_the_reference(mesh):
    rcfg, cfg = smoke_pair()
    tree = carried_params(rcfg, seed=7)
    bundle = ref_train.build_train_step(rcfg, mesh, ref_train.AdamWConfig(**OPT), **TRAIN, donate=False)
    rextra = {k: v for k, v in bundle.abstract_batch.items() if k not in ("tokens", "labels")}
    # committed to the step's shardings: else the second call compiles again
    params = jax.device_put(to_jax(tree), bundle.param_shardings)
    ropt = jax.device_put(ref_train.init_opt_state(params), bundle.opt_shardings)
    model = E.params_from_reference(tree)
    opt = init_opt_state(model)
    port = build_train_step(cfg, AdamWConfig(**OPT), **TRAIN, device="cpu")
    extra = {k: v for k, v in port.input_specs.items() if k not in ("tokens", "labels")}
    assert list(extra) == list(rextra) == ["frames"]
    for step in range(3):
        rb = ref_train.batch_at(ref_train.DataConfig(vocab=cfg.vocab, **TRAIN), step, extra=rextra)
        params, ropt, rm = bundle.step_fn(params, ropt, jax.device_put(rb, bundle.batch_shardings))
        m = port.step_fn(model, opt, batch_at(DataConfig(vocab=cfg.vocab, **TRAIN), step, extra=extra))
        assert rel(m["loss"], rm["loss"]) < 1e-5
        assert rel(m["grad_norm"], rm["grad_norm"]) < 1e-5
        assert rel(m["lr"], rm["lr"]) < 1e-6
    got, want = E.params_to_reference(model), jax.tree.map(np.asarray, params)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree.leaves(want)):
        assert np.max(np.abs(a - b)) <= 1e-4 * np.max(np.abs(b)), path
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(stack_named(opt["mu"])),
                            jax.tree.leaves(jax.tree.map(np.asarray, ropt["mu"]))):
        assert np.max(np.abs(a - b)) <= 5e-4 * np.max(np.abs(b)), path


# ---------------------------------------------------------------- decode
def test_eight_decode_tokens_match_the_reference_and_the_forward(mesh):
    rcfg, cfg = smoke_pair()
    tree = carried_params(rcfg, seed=9)
    model = E.params_from_reference(tree)
    b, s_cache, n = 2, 12, 8
    toks = np.random.default_rng(10).integers(0, cfg.vocab, (b, n)).astype(np.int32)
    frames = frames_for(cfg, b, seed=11)
    dev = jax.devices()[0]  # committed inputs: one compile
    params = jax.device_put(to_jax(tree), dev)
    rcache = jax.device_put(jax.jit(lambda p, f: ref_ed.prefill_cross_cache(rcfg, mesh, p, f, b, s_cache))(
        params, frames), dev)
    rf = jax.jit(ref_ed.decode_step(rcfg, mesh))
    step_fn, info = build_serve_step(cfg, b, s_cache, device="cpu")
    cache = info["prefill"](model, torch.from_numpy(frames))
    assert {k: tuple(v.shape) for k, v in cache.items()} == info["cache_shapes"] == {
        k: v.shape for k, v in rcache.items()}
    for k in ("xk", "xv"):
        assert rel(cache[k], rcache[k]) < 1e-5, k
    with torch.no_grad():
        enc = E.encode(cfg, model, torch.from_numpy(frames))
        full = T.logits_from_hidden(cfg, model, E.decode_train(cfg, model, torch.from_numpy(toks), enc))
    for i in range(n):
        pos = np.full((b,), i, np.int32)
        rlog, rcache = rf(params, rcache, jax.device_put({"token": toks[:, i], "pos": pos}, dev))
        logits, cache = step_fn(model, cache, {"token": torch.from_numpy(toks[:, i]),
                                                "pos": torch.from_numpy(pos)})
        assert rel(logits, rlog) < 1e-5, i
        assert rel(logits, full[:, i]) < 1e-5, i
    assert sorted(cache) == sorted(rcache) == ["k", "v", "xk", "xv"]
    for k in cache:
        assert cache[k].dtype == torch.float32 and rcache[k].dtype == jnp.float32
        assert rel(cache[k], rcache[k]) < 1e-5, k
    assert np.all(cache["k"][:, :, n:].numpy() == 0)


def test_bf16_decode_step_keeps_the_reference_dtypes(mesh):
    rcfg, cfg = smoke_pair(dtype=(jnp.bfloat16, torch.bfloat16))
    tree = carried_params(rcfg, seed=12)
    model = E.params_from_reference(tree, dtype=torch.bfloat16)
    frames = frames_for(cfg, 1, seed=13)
    rparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)
    rcache = ref_ed.prefill_cross_cache(rcfg, mesh, rparams, jnp.asarray(frames, jnp.bfloat16), 1, 8)
    step_fn, info = build_serve_step(cfg, 1, 8, device="cpu")
    cache = info["prefill"](model, torch.from_numpy(frames).to(torch.bfloat16))
    name = lambda d: str(d).removeprefix("torch.")
    assert {k: name(v.dtype) for k, v in cache.items()} == {k: str(v.dtype) for k, v in rcache.items()}
    assert {k: str(v.dtype) for k, v in ref_ed.abstract_cache(rcfg, 1, 8).items()} == {
        k: "bfloat16" for k in cache}
    rlog, rcache = jax.jit(ref_ed.decode_step(rcfg, mesh))(
        rparams, rcache, {"token": jnp.asarray([3], jnp.int32), "pos": jnp.asarray([0], jnp.int32)})
    logits, cache = step_fn(model, cache, {"token": torch.tensor([3], dtype=torch.int32),
                                           "pos": torch.tensor([0], dtype=torch.int32)})
    assert name(logits.dtype) == str(rlog.dtype) == "bfloat16"
    assert {k: name(v.dtype) for k, v in cache.items()} == {k: str(v.dtype) for k, v in rcache.items()}
    assert rel(logits.float(), np.asarray(rlog, np.float32)) < 5e-2


# --------------------------------------------------- params, checkpoints
def test_init_params_rule():
    rcfg, cfg = smoke_pair()
    model = E.init_params(cfg, torch.Generator().manual_seed(0))
    tree = E.params_to_reference(model)
    shapes = ref_ed.param_shapes(rcfg)
    assert E.param_shapes(cfg) == shapes
    assert jax.tree.map(lambda a: a.shape, tree) == shapes
    for path, w in jax.tree_util.tree_leaves_with_path(tree):
        name = path[-1].key
        if "ln" in name:
            assert np.all(w == 1), name
        else:  # N(0, fan_in^-1/2), fan_in = shape[-2] of the stacked shape
            sd = w.shape[-2] ** -0.5
            assert abs(w.mean()) < 0.1 * sd and abs(w.std() - sd) < 0.1 * sd, name
    gap = {"enc_pos": cfg.enc_ctx * cfg.d_model, "pad_rows": (cfg.vocab_padded - cfg.vocab) * cfg.d_model,
           "norms": (2 * cfg.n_enc_layers + 3 * cfg.n_layers + 2) * cfg.d_model}
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count() + sum(gap.values())


def test_full_width_element_count():
    shapes = E.param_shapes(configs.get_config(ARCH))
    count = sum(int(np.prod(s)) for s in jax.tree.leaves(shapes, is_leaf=lambda s: isinstance(s, tuple)))
    assert count == 759_519_232
    assert configs.get_config(ARCH).param_count() == 757_752_832


def test_params_round_trip():
    rcfg, _ = smoke_pair()
    tree = carried_params(rcfg)
    model = E.params_from_reference(tree)
    assert len(model.enc_layers) == len(model.dec_layers) == 2
    back = E.params_to_reference(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(tree),
                                jax.tree_util.tree_leaves_with_path(back)):
        assert pa == pb
        np.testing.assert_array_equal(a, b)


def test_checkpoints_both_ways(tmp_path):
    rcfg, cfg = smoke_pair()
    tree = carried_params(rcfg, seed=14)
    model = E.params_from_reference(tree)
    opt = init_opt_state(model)
    with torch.no_grad():
        for i, name in enumerate(opt["mu"]):
            opt["mu"][name].add_(i + 0.5)
            opt["nu"][name].add_(0.25 * i)
    opt["step"].fill_(4)
    port = {"opt": {"mu": stack_named(opt["mu"]), "nu": stack_named(opt["nu"]), "step": opt["step"].numpy()},
            "params": E.params_to_reference(model)}
    assert {"enc_layers", "dec_layers", "enc_pos"} <= set(port["opt"]["mu"])

    def assert_equal(a_tree, b_tree):
        assert jax.tree.structure(a_tree) == jax.tree.structure(b_tree)
        for a, b in zip(jax.tree.leaves(a_tree), jax.tree.leaves(b_tree)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # port -> reference
    save_checkpoint(tmp_path / "port", 4, {"params": model, "opt": opt})
    like = {"params": to_jax(tree), "opt": ref_train.init_opt_state(to_jax(tree))}
    state, meta = ref_train.restore_checkpoint(tmp_path / "port", like)
    assert meta["step"] == 4
    assert_equal(jax.tree.map(np.asarray, state), port)
    # reference -> port, into a fresh model
    ref_train.save_checkpoint(tmp_path / "ref", 6, state)
    assert latest_step(tmp_path / "ref") == 6
    fresh = E.init_params(cfg, torch.Generator().manual_seed(1))
    got, meta = restore_checkpoint(tmp_path / "ref", {"params": fresh, "opt": init_opt_state(fresh)})
    assert got["params"] is fresh and meta["step"] == 6
    assert_equal({"opt": {"mu": stack_named(got["opt"]["mu"]), "nu": stack_named(got["opt"]["nu"]),
                          "step": got["opt"]["step"].numpy()}, "params": E.params_to_reference(fresh)}, port)


# -------------------------------------------------------------- CLI, API
def test_model_api_dispatch():
    api = model_api(configs.get_smoke(ARCH))
    assert (api.init_params, api.loss_fn, api.decode_step, api.cache_shapes, api.init_cache,
            api.train_input_specs, api.prefill_cross_cache) == (
        E.init_params, E.loss_fn, E.decode_step, E.cache_shapes, E.init_cache, E.train_input_specs,
        E.prefill_cross_cache)
    vlm = model_api(configs.get_smoke("paligemma_3b"))
    assert (vlm.init_params, vlm.loss_fn, vlm.prefill_cross_cache) == (T.init_params, T.loss_fn, None)
    # the moe family is the transformer's too (tests/test_torch_moe.py),
    # its specs included; the sharded execution of encdec is part 5b
    moe = configs.get_smoke("olmoe_1b_7b")
    assert model_api(moe).init_params is T.init_params
    assert model_api(moe).param_specs is T.param_specs
    assert sum(p.numel() for p in T.init_params(moe, torch.Generator()).parameters()) > moe.param_count()
    assert api.param_specs is E.param_specs and api.cache_specs is E.cache_specs
    with pytest.raises(NotImplementedError, match=LM_ITEM):
        T.param_specs(configs.get_smoke(ARCH), None)


def _fields(cfg):
    d = dataclasses.asdict(cfg)
    d.pop("dtype")
    return d


def test_presets_equal_the_reference_trainer():
    for preset in ("smoke", "tiny", "100m", "full"):
        port, ref = train_cli.preset_config(ARCH, preset), ref_launch.preset_config(ARCH, preset)
        assert _fields(port) == _fields(ref), preset
        assert port.param_count() == ref.param_count(), preset
        assert E.param_shapes(port) == ref_ed.param_shapes(ref), preset


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
