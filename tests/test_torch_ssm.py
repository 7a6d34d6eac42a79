"""Port parity: the LM half's SSM families (Mamba2 and the Zamba2 hybrid),
repro_torch vs repro on the CPU.

The reference is imported with ``DeprecationWarning`` ignored and runs on
an ``AxisType.Auto`` (1, 1) mesh, as in ``tests/test_torch_lm.py``.
Weights are carried across: one numpy tree per config from a seed,
through ``params_from_reference``.

The reference's SSD scan casts x to float32 and starts its ``lax.scan``
carry in that dtype, so with float64 dt, A, B and C its scan refuses the
float64 carry it computes; ``rms_norm`` computes the variance in float32.
The float64 checks therefore run the reference's functions with
``jnp.float32`` read as ``jnp.float64`` in the namespaces of
``repro.models.ssm`` and ``repro.models.layers`` (a monkeypatch on the
test's side; no file changes), against the port's float64 path, which
keeps float64 where the reference casts to float32.

* ``ssd_chunked`` in float64 at (s, chunk) = (32, 32), (64, 16),
  (128, 128) to 1e-12 relative, against the reference and against a
  step-by-step recurrence (``ssm_decode_layer``'s update); in float32
  against the unpatched reference to 1e-5;
* ``_causal_conv`` and ``ssm_layer`` in float64 to 1e-12;
* ``loss_fn`` of both smoke configs in float32 to 1e-5 relative, with
  ``remat`` on and off (the port's gradients equal across the two);
* three ``build_train_step`` steps of each against the reference's: loss
  and grad_norm to 1e-5 relative, lr to 1e-6, parameters to 1e-4 and
  first moments to 5e-4 of each leaf's max (``tests/test_torch_lm.py``'s
  bounds);
* eight ``decode_step`` tokens against the reference's: logits and every
  cache leaf to 1e-5 relative in float32; the port's decode logits
  against its own forward to 1e-5;
* one bfloat16 decode step of each: the cache's and the logits' dtypes
  equal the reference's (zamba2: K/V float32, ``conv`` float32 after the
  step, float32 logits; mamba2: bfloat16 ``conv`` and logits), logits
  within 2e-2 relative;
* ``init_params``'s rule, the params and checkpoint round trips both ways
  (values exactly equal, ``shared`` included), ``preset_config`` against
  the reference trainer's, and the CLI at ``--preset smoke --device cpu``.
"""

import dataclasses
import types
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
from repro_torch.models import ssm as S
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
from repro_torch.models.transformer import stack_named

ARCHS = ["mamba2_780m", "zamba2_1_2b"]


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)


ref_train = ref_ssm = ref_L = ref_launch = None


@pytest.fixture(scope="module", autouse=True)
def _reference_lm():
    """Import the reference's LM modules (which import
    ``jax.experimental.shard_map``) with the deprecation ignored, when the
    tests run."""
    global ref_train, ref_ssm, ref_L, ref_launch
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        import repro.train as ref_train
        from repro.models import layers as ref_L
        from repro.models import ssm as ref_ssm
        from repro.launch import train as ref_launch


@pytest.fixture(scope="module", autouse=True)
def _fast_reference_compiles():
    """XLA's cheap compile (``jax_disable_most_optimizations``) for the
    reference's jit calls of this module: a few seconds less a compile."""
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


@pytest.fixture
def ref_f64(monkeypatch):
    """The reference's SSM and layer functions with ``jnp.float32`` read as
    ``jnp.float64`` (module docstring)."""
    proxy = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp) if not k.startswith("__")})
    proxy.float32 = jnp.float64
    monkeypatch.setattr(ref_ssm, "jnp", proxy)
    monkeypatch.setattr(ref_L, "jnp", proxy)


def smoke_pair(arch, dtype=(jnp.float32, torch.float32), **kw):
    """The reference's and the port's SMOKE config in ``dtype``.  The
    reference's is ``unroll``ed (a Python loop over the layers where it
    would ``lax.scan``: the same math, and a jit compile of a few seconds
    less; the port always loops)."""
    return (ref_configs.get_smoke(arch).with_(dtype=dtype[0], unroll=True, **kw),
            configs.get_smoke(arch).with_(dtype=dtype[1], **kw))


def carried_params(ref_cfg, seed=0, dtype=np.float32):
    """A reference params tree (numpy, stacked) from a seed: the leaves the
    initialiser sets to constants near those constants (norms, ``conv_b``,
    ``D_skip`` 1 + N(0, 0.1); ``A_log`` log(1 … h) + N(0, 0.1);
    ``dt_bias`` -1 + N(0, 0.1)), ``emb`` N(0, 0.02), every other weight
    N(0, fan_in^-1/2) with fan_in its input width."""
    rng = np.random.default_rng(seed)
    shapes = ref_ssm.param_shapes(ref_cfg)
    fan_in = {"in_proj": -2, "out_proj": -2, "conv_w": -2, "wq": 0, "wk": 0, "wv": 0, "wg": 0, "wu": 0,
              "wd": 0}

    def leaf(shape, name):
        noise = 0.1 * rng.standard_normal(shape)
        if name in ("ln", "out_ln", "final_ln", "ln1", "ln2", "conv_b", "D_skip"):
            v = 1 + noise
        elif name == "A_log":
            v = np.log(np.broadcast_to(np.arange(1, shape[-1] + 1), shape)) + noise
        elif name == "dt_bias":
            v = -1 + noise
        elif name == "emb":
            v = 0.02 * rng.standard_normal(shape)
        elif name == "wo":
            v = rng.standard_normal(shape) / np.sqrt(shape[0] * shape[1])
        else:
            v = rng.standard_normal(shape) / np.sqrt(shape[fan_in[name]])
        return v.astype(dtype)

    return {k: ({n: leaf(s, n) for n, s in v.items()} if isinstance(v, dict) else leaf(v, k))
            for k, v in shapes.items()}


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def ssd_inputs(s, seed, b=2, h=3, p=4, n=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, p)), rng.uniform(0.05, 0.5, (b, s, h)),
            -rng.uniform(0.5, 2.0, h), rng.standard_normal((b, s, n)), rng.standard_normal((b, s, n)))


# ------------------------------------------------------------------- SSD
@pytest.mark.parametrize("s,chunk", [(32, 32), (64, 16), (128, 128)])
def test_ssd_chunked(ref_f64, s, chunk):
    x, dt, A, B, C = ssd_inputs(s, seed=s + chunk)
    y, final = S.ssd_chunked(*map(torch.from_numpy, (x, dt, A, B, C)), chunk=chunk)
    assert y.dtype == final.dtype == torch.float64
    ry, rfinal = jax.jit(ref_ssm.ssd_chunked, static_argnames="chunk")(
        *map(jnp.asarray, (x, dt, A, B, C)), chunk=chunk)
    assert ry.dtype == jnp.float64
    assert rel(y, ry) < 1e-12 and rel(final, rfinal) < 1e-12
    # the step-by-step recurrence: ssm_decode_layer's update, one token at a time
    state = np.zeros((x.shape[0], x.shape[2], x.shape[3], B.shape[-1]))
    ys = []
    for i in range(s):
        state = state * np.exp(dt[:, i] * A)[..., None, None] + np.einsum(
            "bhp,bn,bh->bhpn", x[:, i], B[:, i], dt[:, i])
        ys.append(np.einsum("bn,bhpn->bhp", C[:, i], state))
    assert rel(y, np.stack(ys, axis=1)) < 1e-12 and rel(final, state) < 1e-12


def test_ssd_chunked_float32_against_the_unpatched_reference():
    x, dt, A, B, C = (a.astype(np.float32) for a in ssd_inputs(64, seed=7))
    y, final = S.ssd_chunked(*map(torch.from_numpy, (x, dt, A, B, C)), chunk=16)
    ry, rfinal = jax.jit(ref_ssm.ssd_chunked, static_argnames="chunk")(
        *map(jnp.asarray, (x, dt, A, B, C)), chunk=16)
    assert y.dtype == torch.float32 and ry.dtype == jnp.float32
    assert rel(y, ry) < 1e-5 and rel(final, rfinal) < 1e-5


def test_causal_conv():
    rng = np.random.default_rng(3)
    x, w, b = rng.standard_normal((2, 9, 6)), rng.standard_normal((4, 6)), rng.standard_normal(6)
    port = S._causal_conv(*map(torch.from_numpy, (x, w, b)))
    assert rel(port, ref_ssm._causal_conv(*map(jnp.asarray, (x, w, b)))) < 1e-12


@pytest.mark.parametrize("s", [32, 256])  # one chunk; two chunks of 128
def test_ssm_layer(ref_f64, mesh, s):
    rcfg, cfg = smoke_pair("mamba2_780m", dtype=(jnp.float64, torch.float64))
    tree = carried_params(rcfg, seed=4, dtype=np.float64)["layers"]
    p = {k: v[1] for k, v in tree.items()}
    x = np.random.default_rng(5).standard_normal((2, s, cfg.d_model))
    ref = jax.jit(lambda x_, p_: ref_ssm.ssm_layer(rcfg, mesh, MeshAxes.from_mesh(mesh), x_, p_))(
        jnp.asarray(x), to_jax(p))
    port = S.ssm_layer(cfg, torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()})
    assert port.dtype == torch.float64 and ref.dtype == jnp.float64
    assert rel(port, ref) < 1e-12


def test_ssm_layer_chunk_must_divide_the_sequence():
    _, cfg = smoke_pair("mamba2_780m")
    model = S.init_params(cfg.with_(n_layers=1), torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="must divide"):
        S.ssm_layer(cfg, torch.zeros(1, 200, cfg.d_model), model.layers[0])


# ------------------------------------------------------------------ model
OPT = dict(lr=1e-3, eps=1e-3, warmup_steps=2, total_steps=10)  # tests/test_torch_lm.py says why
TRAIN_SEED, TRAIN = 7, dict(batch=2, seq=256)  # two SSD chunks of 128 a layer
_REFERENCE_STEPS: dict = {}


def reference_steps(mesh, arch):
    """The reference's three ``build_train_step`` steps of ``arch``'s smoke
    config from ``carried_params(seed=TRAIN_SEED)``: the metrics, the final
    params and the first moments (numpy).  Computed once and shared by the
    loss and the train-step tests: its jit compile is most of their time."""
    if arch not in _REFERENCE_STEPS:
        rcfg, cfg = smoke_pair(arch)
        bundle = ref_train.build_train_step(rcfg, mesh, ref_train.AdamWConfig(**OPT), **TRAIN,
                                            donate=False)
        # committed to the step's shardings, as its outputs are: uncommitted
        # inputs would make the second call compile the step again
        params = jax.device_put(to_jax(carried_params(rcfg, seed=TRAIN_SEED)), bundle.param_shardings)
        ropt = jax.device_put(ref_train.init_opt_state(params), bundle.opt_shardings)
        metrics = []
        for step in range(3):
            params, ropt, rm = bundle.step_fn(params, ropt, jax.device_put(ref_train.batch_at(
                ref_train.DataConfig(vocab=cfg.vocab, **TRAIN), step), bundle.batch_shardings))
            metrics.append({k: float(v) for k, v in rm.items()})
        _REFERENCE_STEPS[arch] = (metrics, jax.tree.map(np.asarray, params),
                                  jax.tree.map(np.asarray, ropt["mu"]))
    return _REFERENCE_STEPS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_with_and_without_remat(mesh, arch):
    rcfg, cfg = smoke_pair(arch)
    tree = carried_params(rcfg, seed=TRAIN_SEED)
    pbatch = batch_at(DataConfig(vocab=cfg.vocab, **TRAIN), 0)
    # the reference's loss_fn at these params and batch: its first step's loss
    want = reference_steps(mesh, arch)[0][0]["loss"]
    grads = []
    for r in (False, True):
        model = S.params_from_reference(tree)
        loss = S.loss_fn(cfg.with_(remat=r))(model, pbatch)
        assert rel(loss.detach(), want) < 1e-5, r
        grads.append(torch.autograd.grad(loss, list(model.parameters())))
    for a, b in zip(*grads):
        assert rel(a, b) < 1e-6


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_the_reference(mesh, arch):
    rcfg, cfg = smoke_pair(arch)
    metrics, want, want_mu = reference_steps(mesh, arch)
    model = S.params_from_reference(carried_params(rcfg, seed=TRAIN_SEED))
    opt = init_opt_state(model)
    step_fn = build_train_step(cfg, AdamWConfig(**OPT), **TRAIN, device="cpu").step_fn
    for step, rm in enumerate(metrics):
        m = step_fn(model, opt, batch_at(DataConfig(vocab=cfg.vocab, **TRAIN), step))
        assert rel(m["loss"], rm["loss"]) < 1e-5
        assert rel(m["grad_norm"], rm["grad_norm"]) < 1e-5
        assert rel(m["lr"], rm["lr"]) < 1e-6
    got = S.params_to_reference(model)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree.leaves(want)):
        assert np.max(np.abs(a - b)) <= 1e-4 * np.max(np.abs(b)), path
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(stack_named(opt["mu"])),
                            jax.tree.leaves(want_mu)):
        assert np.max(np.abs(a - b)) <= 5e-4 * np.max(np.abs(b)), path


# ----------------------------------------------------------------- decode
@pytest.mark.parametrize("arch", ARCHS)
def test_eight_decode_tokens_match_the_reference_and_the_forward(mesh, arch):
    rcfg, cfg = smoke_pair(arch)
    tree = carried_params(rcfg, seed=9)
    model = S.params_from_reference(tree)
    b, s_cache, n = 2, 12, 8
    toks = np.random.default_rng(10).integers(0, cfg.vocab, (b, n)).astype(np.int32)
    rf = jax.jit(ref_ssm.decode_step(rcfg, mesh))
    dev = jax.devices()[0]  # committed inputs: one compile (the train test says why)
    rcache = jax.device_put(ref_ssm.init_cache(rcfg, b, s_cache), dev)
    step_fn, info = build_serve_step(cfg, b, s_cache, device="cpu")
    cache = info["init_cache"]()
    assert {k: tuple(v.shape) for k, v in cache.items()} == info["cache_shapes"] == {
        k: v.shape for k, v in rcache.items()}
    params = jax.device_put(to_jax(tree), dev)
    with torch.no_grad():
        full = S.logits_from_hidden(cfg, model, S.forward(cfg, model, torch.from_numpy(toks)))
    for i in range(n):
        pos = np.full((b,), i, np.int32)
        rlog, rcache = rf(params, rcache, jax.device_put({"token": toks[:, i], "pos": pos}, dev))
        logits, cache = step_fn(model, cache, {"token": torch.from_numpy(toks[:, i]),
                                                "pos": torch.from_numpy(pos)})
        assert rel(logits, rlog) < 1e-5, i
        assert rel(logits, full[:, i]) < 1e-5, i
    assert sorted(cache) == sorted(rcache)
    for k in cache:
        assert cache[k].dtype == torch.float32 and rcache[k].dtype == jnp.float32
        assert rel(cache[k], rcache[k]) < 1e-5, k
    if "k" in cache:
        assert np.all(cache["k"][:, :, n:].numpy() == 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_decode_step_keeps_the_reference_dtypes(mesh, arch):
    rcfg, cfg = smoke_pair(arch, dtype=(jnp.bfloat16, torch.bfloat16))
    tree = carried_params(rcfg, seed=11)
    model = S.params_from_reference(tree, dtype=torch.bfloat16)
    rcache = ref_ssm.init_cache(rcfg, 1, 8)
    step_fn, info = build_serve_step(cfg, 1, 8, device="cpu")
    cache = info["init_cache"]()
    name = lambda d: str(d).removeprefix("torch.")
    assert {k: name(v.dtype) for k, v in cache.items()} == {k: str(v.dtype) for k, v in rcache.items()}
    rlog, rcache = jax.jit(ref_ssm.decode_step(rcfg, mesh))(
        jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree), rcache,
        {"token": jnp.asarray([3], jnp.int32), "pos": jnp.asarray([0], jnp.int32)})
    logits, cache = step_fn(model, cache, {"token": torch.tensor([3], dtype=torch.int32),
                                           "pos": torch.tensor([0], dtype=torch.int32)})
    assert name(logits.dtype) == str(rlog.dtype)
    assert {k: name(v.dtype) for k, v in cache.items()} == {k: str(v.dtype) for k, v in rcache.items()}
    want = {"zamba2_1_2b": ("float32", {"conv": "float32", "ssm": "float32", "k": "float32", "v": "float32"}),
            "mamba2_780m": ("bfloat16", {"conv": "bfloat16", "ssm": "float32"})}[arch]
    assert (name(logits.dtype), {k: name(v.dtype) for k, v in cache.items()}) == want
    assert rel(logits.float(), np.asarray(rlog, np.float32)) < 2e-2


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_rule(arch):
    rcfg, cfg = smoke_pair(arch)
    model = S.init_params(cfg, torch.Generator().manual_seed(0))
    tree = S.params_to_reference(model)
    shapes = ref_ssm.param_shapes(rcfg)
    assert S.param_shapes(cfg) == shapes
    assert jax.tree.map(lambda a: a.shape, tree) == shapes
    lay, h = tree["layers"], cfg.n_ssm_heads
    for ones in [tree["final_ln"]] + [lay[k] for k in ("ln", "out_ln", "conv_b", "D_skip")] + (
            [tree["shared"][k] for k in ("ln1", "ln2")] if "shared" in tree else []):
        assert np.all(ones == 1)
    # log(1 … h) correctly rounded to float32; XLA's float32 log (the
    # reference's) is one ulp off at a few entries
    a_log = np.log(np.arange(1, h + 1, dtype=np.float64)).astype(np.float32)
    np.testing.assert_array_equal(lay["A_log"], np.broadcast_to(a_log, (cfg.n_layers, h)))
    np.testing.assert_array_max_ulp(a_log, np.asarray(jnp.log(jnp.arange(1, h + 1, dtype=jnp.float32))), 1)
    assert np.all(lay["dt_bias"] == -1)
    drawn = [("emb", tree["emb"])] + [(k, lay[k]) for k in ("in_proj", "conv_w", "out_proj")] + (
        [(k, v) for k, v in tree["shared"].items() if v.ndim >= 2] if "shared" in tree else [])
    for k, w in drawn:  # N(0, fan_in^-1/2), fan_in = shape[-2] of the stacked shape
        assert abs(w.mean()) < 0.1 * w.shape[-2] ** -0.5, k
        assert abs(w.std() - w.shape[-2] ** -0.5) < 0.1 * w.shape[-2] ** -0.5, k
    gap = (cfg.vocab_padded - cfg.vocab) * cfg.d_model + cfg.d_model + cfg.n_layers * (
        cfg.d_inner + 2 * cfg.d_state + cfg.n_ssm_heads + cfg.d_model)  # pad rows, final_ln, conv_b, dt_bias, ln
    if "shared" in tree:
        gap += 2 * cfg.d_model  # ln1, ln2
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count() + gap


def test_full_width_element_counts():
    counts = {}
    for arch in ARCHS:
        shapes = S.param_shapes(configs.get_config(arch))
        counts[arch] = sum(int(np.prod(s)) for s in jax.tree.leaves(
            shapes, is_leaf=lambda s: isinstance(s, tuple)))
    assert counts == {"mamba2_780m": 780_382_464, "zamba2_1_2b": 1_104_937_856}


# ------------------------------------------------------ params, checkpoints
@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip(arch):
    rcfg, _ = smoke_pair(arch)
    tree = carried_params(rcfg)
    back = S.params_to_reference(S.params_from_reference(tree))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(tree),
                                jax.tree_util.tree_leaves_with_path(back)):
        assert pa == pb
        np.testing.assert_array_equal(a, b)


def test_checkpoints_both_ways_with_the_shared_block(tmp_path):
    rcfg, cfg = smoke_pair("zamba2_1_2b")
    tree = carried_params(rcfg, seed=12)
    model = S.params_from_reference(tree)
    opt = init_opt_state(model)
    with torch.no_grad():
        for i, name in enumerate(opt["mu"]):
            opt["mu"][name].add_(i + 0.5)
            opt["nu"][name].add_(0.25 * i)
    opt["step"].fill_(4)
    port = {"opt": {"mu": stack_named(opt["mu"]), "nu": stack_named(opt["nu"]), "step": opt["step"].numpy()},
            "params": S.params_to_reference(model)}
    assert set(port["params"]["shared"]) == set(tree["shared"]) and "shared" in port["opt"]["mu"]

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
    fresh = S.init_params(cfg, torch.Generator().manual_seed(1))
    got, meta = restore_checkpoint(tmp_path / "ref", {"params": fresh, "opt": init_opt_state(fresh)})
    assert got["params"] is fresh and meta["step"] == 6
    assert_equal({"opt": {"mu": stack_named(got["opt"]["mu"]), "nu": stack_named(got["opt"]["nu"]),
                          "step": got["opt"]["step"].numpy()}, "params": S.params_to_reference(fresh)}, port)


# -------------------------------------------------------------- CLI, API
def test_model_api_dispatches_the_ssm_families():
    for arch in ARCHS:
        api = model_api(configs.get_smoke(arch))
        assert (api.init_params, api.loss_fn, api.decode_step, api.cache_shapes, api.init_cache) == (
            S.init_params, S.loss_fn, S.decode_step, S.cache_shapes, S.init_cache)


def _fields(cfg):
    d = dataclasses.asdict(cfg)
    d.pop("dtype")
    return d


@pytest.mark.parametrize("arch", ARCHS)
def test_presets_equal_the_reference_trainer(arch):
    for preset in ("smoke", "tiny", "100m", "full"):
        port, ref = train_cli.preset_config(arch, preset), ref_launch.preset_config(arch, preset)
        assert _fields(port) == _fields(ref), preset
        assert port.param_count() == ref.param_count(), preset
        assert S.param_shapes(port) == ref_ssm.param_shapes(ref), preset


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_smoke(arch, tmp_path, capsys):
    argv = ["--arch", arch, "--preset", "smoke", "--device", "cpu", "--steps", "2", "--batch", "2",
            "--seq", "32", "--log-every", "1", "--ckpt-dir", str(tmp_path)]
    train_cli.main(argv)
    out = capsys.readouterr().out.splitlines()
    cfg = configs.get_smoke(arch)
    assert out[0] == f"arch={cfg.name} params={cfg.param_count() / 1e6:.1f}M preset=smoke"
    steps = [line for line in out if line.startswith("step ")]
    assert len(steps) == 2 and out[-1] == "done"
    assert all(np.isfinite(float(line.split()[3])) for line in steps)
    train_cli.main(argv[:7] + ["3", "--resume"] + argv[8:])
    out = capsys.readouterr().out.splitlines()
    assert "resumed from step 2" in out
    assert [line.split()[1] for line in out if line.startswith("step ")] == ["3"]
