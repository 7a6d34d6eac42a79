"""Port parity: the LM half's MoE family (olmoe-1b-7b, phi3.5-moe-42b),
repro_torch vs repro on the CPU, float32.

The reference is imported with ``DeprecationWarning`` ignored (its
``models/moe.py`` imports ``jax.experimental.shard_map``) and runs jitted
on an ``AxisType.Auto`` (1, 1) mesh, as in ``tests/test_torch_lm.py``:
eagerly its per-expert loop takes about a minute a call.  Its compiles run
under ``jax_disable_most_optimizations``; each arch's trainer is traced
and compiled once (a module fixture runs its three steps), which is most
of the file's time.  Weights are carried across: one numpy tree per seed,
through ``params_from_reference``.  Both smoke configs: ``olmoe-smoke``
(8 experts, top-2) and ``phi35moe-smoke`` (4 experts, top-2, GQA).

* ``moe_ffn`` against the reference's on tokens skewed towards expert 0,
  so that picks are dropped (their count worked out in numpy from the
  routing and held against :func:`repro_torch.models.moe.record_dropped`):
  output to 1e-5 of its max, aux to 1e-6 relative (also with the gelu
  FFN, which no config uses); at ``capacity_factor
  = E/k`` (nothing dropped) against the reference's ``moe_ffn_reference``,
  as is the port's own oracle; the port's gradients there against its
  oracle's (plain autograd) to 1e-5, and bit-identical over two runs;
* ``loss_fn`` (``+ 0.01·aux``) and its gradients against the reference
  trainer's first step (its first moments over (1 - b1) times the clip
  scale): loss to 1e-5 relative, each gradient leaf to 1e-4 of its max
  (float32: the two packages' sums run in other orders);
* three ``build_train_step`` steps against the reference's, to
  ``tests/test_torch_lm.py``'s bounds;
* eight ``decode_step`` tokens at batch 2 (two tokens routed together:
  capacity 1) against the reference's: logits and K/V caches to 1e-5;
* ``init_params``'s rule and the full-width element counts, the params
  and checkpoint round trips both ways (values exactly equal), the
  dispatch and the CLI at ``--preset smoke --device cpu``.
"""

import math
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
from repro_torch.models import moe
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

ARCHS = ["olmoe_1b_7b", "phi35_moe_42b"]
OPT = dict(lr=1e-3, eps=1e-3, warmup_steps=2, total_steps=10)  # tests/test_torch_lm.py says why
TRAIN = dict(batch=2, seq=16)


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)


ref_train = ref_tf = ref_moe = None


@pytest.fixture(scope="module", autouse=True)
def _reference_lm():
    """Import the reference's LM modules with the deprecation ignored, when
    the tests run."""
    global ref_train, ref_tf, ref_moe
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        import repro.train as ref_train
        from repro.models import moe as ref_moe
        from repro.models import transformer as ref_tf


@pytest.fixture(scope="module", autouse=True)
def _fast_reference_compiles():
    """XLA's cheap compile for the reference's jit calls of this module."""
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


def smoke_pair(arch, **kw):
    """The reference's and the port's SMOKE config in float32."""
    return (ref_configs.get_smoke(arch).with_(dtype=jnp.float32, **kw),
            configs.get_smoke(arch).with_(dtype=torch.float32, **kw))


def carried_params(ref_cfg, seed=0):
    """A reference params tree (numpy, stacked) from a seed: norms
    1 + N(0, 0.1), ``emb`` and ``lm_head`` N(0, 0.02), every other weight
    N(0, fan_in^-1/2) with fan_in its input width (``router`` d, ``we_d``
    d_ff)."""
    rng = np.random.default_rng(seed)

    def leaf(shape, name):
        if name in ("ln1", "ln2", "final_ln"):
            v = 1 + 0.1 * rng.standard_normal(shape)
        elif name in ("emb", "lm_head"):
            v = 0.02 * rng.standard_normal(shape)
        elif name == "wo":
            v = rng.standard_normal(shape) / np.sqrt(shape[1] * shape[2])
        else:
            v = rng.standard_normal(shape) / np.sqrt(shape[-2] if name.startswith("we_") else shape[1])
        return v.astype(np.float32)

    return {k: ({n: leaf(s, n) for n, s in v.items()} if isinstance(v, dict) else leaf(v, k))
            for k, v in ref_tf.param_shapes(ref_cfg).items()}


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


# ------------------------------------------------------------- moe_ffn
def skewed_case(cfg, seed):
    """Tokens (2, 16, d) and one layer's expert weights, every token pushed
    towards expert 0 (a shared offset along v, and v added to the router's
    column 0), so expert 0's queue overflows its capacity."""
    rng = np.random.default_rng(seed)
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff
    v = rng.standard_normal(d)
    v /= np.linalg.norm(v)
    x = rng.standard_normal((2, 16, d)) + 2.0 * v
    router = rng.standard_normal((d, e)) / np.sqrt(d)
    router[:, 0] += v
    p = {"router": router, "we_g": rng.standard_normal((e, d, f)) / np.sqrt(d),
         "we_u": rng.standard_normal((e, d, f)) / np.sqrt(d),
         "we_d": rng.standard_normal((e, f, d)) / np.sqrt(f)}
    return x.astype(np.float32), {k: w.astype(np.float32) for k, w in p.items()}


def dropped_picks(cfg, x, router):
    """The picks the reference's rule drops, in float64 numpy: top-k of the
    softmax, each expert's members in token order past its capacity."""
    xf = x.reshape(-1, x.shape[-1]).astype(np.float64)
    logits = xf @ router.astype(np.float64)
    top = np.argsort(-logits, axis=-1, kind="stable")[:, : cfg.top_k]
    members = np.bincount(top.reshape(-1), minlength=cfg.n_experts)
    cap = int(max(1, math.ceil(len(xf) * cfg.top_k / cfg.n_experts) * cfg.capacity_factor))
    return int(np.maximum(members - cap, 0).sum())


@pytest.mark.parametrize("arch,mlp", [(a, "swiglu") for a in ARCHS] + [("olmoe_1b_7b", "gelu")])
def test_moe_ffn_drops_and_matches_the_reference(mesh, arch, mlp):
    """Both configs are SwiGLU; the gelu branch on olmoe's.  The
    reference's ``moe_ffn`` reads ``we_g`` whatever the FFN (its
    ``shard_map`` takes it), so it gets one there; the port's gets none,
    as ``layer_shapes`` makes none for gelu."""
    rcfg, cfg = smoke_pair(arch, mlp=mlp)
    x, p = skewed_case(cfg, seed=len(arch))
    want_dropped = dropped_picks(cfg, x, p["router"])
    assert want_dropped > 0
    r_out, r_aux = jax.jit(lambda x_, p_: ref_moe.moe_ffn(rcfg, mesh, MeshAxes.from_mesh(mesh), x_, p_))(x, p)
    if mlp != "swiglu":
        p.pop("we_g")
    with moe.record_dropped() as dropped:
        out, aux = moe.moe_ffn(cfg, torch.from_numpy(x), {k: torch.from_numpy(w) for k, w in p.items()})
    assert [int(n) for n in dropped] == [want_dropped]
    assert out.shape == x.shape and aux.dtype == torch.float32
    assert rel(out, r_out) < 1e-5
    assert rel(aux, r_aux) < 1e-6
    # the drops matter: the no-drop oracle is another function here
    assert rel(moe.moe_ffn_reference(cfg, torch.from_numpy(x), {k: torch.from_numpy(w) for k, w in p.items()}),
               r_out) > 1e-2


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_without_drops_is_the_dense_oracle(mesh, arch):
    """At ``capacity_factor = E/k`` the capacity is at least T: nothing is
    dropped, and ``moe_ffn`` is the reference's no-drop oracle.  Its
    gradients (the dispatch and combine gathers' own backward) equal plain
    autograd's through the port's oracle, and two runs are bit-identical."""
    rcfg, cfg = smoke_pair(arch)
    rcfg, cfg = (c.with_(capacity_factor=c.n_experts / c.top_k) for c in (rcfg, cfg))
    x, p = skewed_case(cfg, seed=len(arch) + 1)
    assert moe.capacity(cfg, 32) >= 32 and dropped_picks(cfg, x, p["router"]) == 0
    r_oracle = jax.jit(lambda x_, p_: ref_moe.moe_ffn_reference(rcfg, x_, p_))(x, p)
    grads, outs = [], []
    for fn in (lambda *a: moe.moe_ffn(*a)[0], moe.moe_ffn_reference, lambda *a: moe.moe_ffn(*a)[0]):
        xt = torch.from_numpy(x).requires_grad_()
        pt = {k: torch.from_numpy(w).requires_grad_() for k, w in p.items()}
        out = fn(cfg, xt, pt)
        outs.append(out.detach())
        grads.append(torch.autograd.grad((out * torch.linspace(-1, 1, out.numel()).view(out.shape)).sum(),
                                         [xt, *pt.values()]))
    assert rel(outs[0], r_oracle) < 1e-5 and rel(outs[1], r_oracle) < 1e-5
    for a, b in zip(grads[0], grads[1]):
        assert rel(a, b) < 1e-5
    for a, b in zip(grads[0], grads[2]):
        assert torch.equal(a, b)


# ---------------------------------------------------- loss, train, decode
@pytest.fixture(scope="module")
def reference_steps(mesh):
    """Each arch's reference trainer, compiled once: three steps from
    ``carried_params(seed=7)`` on ``batch_at``'s batches 0-2.  Records
    each step's metrics, the gradients of step 1 (its first moments over
    (1 - b1) times the clip scale), and the final parameters and moments,
    as numpy."""
    out = {}
    for arch in ARCHS:
        rcfg, cfg = smoke_pair(arch)
        tree = carried_params(rcfg, seed=7)
        opt_cfg = ref_train.AdamWConfig(**OPT)
        bundle = ref_train.build_train_step(rcfg, mesh, opt_cfg, **TRAIN, donate=False)
        params = jax.device_put(to_jax(tree), bundle.param_shardings)
        ropt = jax.device_put(ref_train.init_opt_state(params), bundle.opt_shardings)
        run = {"tree": tree, "metrics": [], "input_specs": list(bundle.abstract_batch)}
        for step in range(3):
            rb = ref_train.batch_at(ref_train.DataConfig(vocab=cfg.vocab, **TRAIN), step)
            params, ropt, rm = bundle.step_fn(params, ropt, jax.device_put(rb, bundle.batch_shardings))
            run["metrics"].append({k: float(v) for k, v in rm.items()})
            if step == 0:
                scale = min(1.0, opt_cfg.grad_clip / (run["metrics"][0]["grad_norm"] + 1e-9))
                run["grads"] = jax.tree.map(lambda m: np.asarray(m, np.float64) / ((1 - opt_cfg.b1) * scale),
                                            ropt["mu"])
        run["params"] = jax.tree.map(np.asarray, params)
        run["mu"] = jax.tree.map(np.asarray, ropt["mu"])
        out[arch] = run
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_the_reference(reference_steps, arch):
    """``loss_fn`` (the summed aux loss at 0.01 included) and its gradients
    at the reference trainer's first step: loss to 1e-5 relative, each
    gradient leaf to 1e-4 of its max (float32: the two packages' sums run
    in other orders)."""
    _, cfg = smoke_pair(arch)
    run = reference_steps[arch]
    model = T.params_from_reference(run["tree"])
    batch = batch_at(DataConfig(vocab=cfg.vocab, **TRAIN), 0)
    with moe.record_dropped() as dropped:
        loss = T.loss_fn(cfg)(model, batch)
    assert len(dropped) == cfg.n_layers
    if arch == "olmoe_1b_7b":  # 8 experts of capacity 10 for 32 tokens
        assert sum(int(n) for n in dropped) > 0
    assert rel(loss.detach(), run["metrics"][0]["loss"]) < 1e-5
    with torch.no_grad():
        x, aux = T.forward_with_aux(cfg, model, batch["tokens"])
        assert float(aux) > 0 and rel(loss, T.lm_loss(cfg, model, x, batch["labels"]) + 0.01 * aux) < 1e-7
    grads = torch.autograd.grad(loss, list(model.parameters()))
    got = stack_named(dict(zip(dict(model.named_parameters()), grads)))
    assert jax.tree.structure(got) == jax.tree.structure(run["grads"])
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree.leaves(run["grads"])):
        assert np.max(np.abs(a - b)) <= 1e-4 * np.max(np.abs(b)), path


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_the_reference(reference_steps, arch):
    _, cfg = smoke_pair(arch)
    run = reference_steps[arch]
    model = T.params_from_reference(run["tree"])
    opt = init_opt_state(model)
    port = build_train_step(cfg, AdamWConfig(**OPT), **TRAIN, device="cpu")
    assert list(port.input_specs) == run["input_specs"] == ["tokens", "labels"]
    for step, rm in enumerate(run["metrics"]):
        m = port.step_fn(model, opt, batch_at(DataConfig(vocab=cfg.vocab, **TRAIN), step))
        assert rel(m["loss"], rm["loss"]) < 1e-5
        assert rel(m["grad_norm"], rm["grad_norm"]) < 1e-5
        assert rel(m["lr"], rm["lr"]) < 1e-6
    got = T.params_to_reference(model)
    assert jax.tree.structure(got) == jax.tree.structure(run["params"])
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree.leaves(run["params"])):
        assert np.max(np.abs(a - b)) <= 1e-4 * np.max(np.abs(b)), path
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(stack_named(opt["mu"])),
                            jax.tree.leaves(run["mu"])):
        assert np.max(np.abs(a - b)) <= 5e-4 * np.max(np.abs(b)), path


@pytest.mark.parametrize("arch", ARCHS)
def test_eight_decode_tokens_match_the_reference(mesh, arch):
    rcfg, cfg = smoke_pair(arch)
    tree = carried_params(rcfg, seed=9)
    model = T.params_from_reference(tree)
    b, s_cache, n = 2, 12, 8
    assert moe.capacity(cfg, b) == 1  # the two new tokens share each expert's one slot
    toks = np.random.default_rng(10).integers(0, cfg.vocab, (b, n)).astype(np.int32)
    dev = jax.devices()[0]  # committed inputs: one compile
    params = jax.device_put(to_jax(tree), dev)
    rcache = jax.device_put(ref_tf.init_cache(rcfg, b, s_cache), dev)
    rf = jax.jit(ref_tf.decode_step(rcfg, mesh))
    step_fn, info = build_serve_step(cfg, b, s_cache, device="cpu")
    cache = info["init_cache"]()
    assert info["cache_shapes"] == {k: v.shape for k, v in rcache.items()}
    dropped = 0
    for i in range(n):
        pos = np.full((b,), i, np.int32)
        rlog, rcache = rf(params, rcache, jax.device_put({"token": toks[:, i], "pos": pos}, dev))
        with moe.record_dropped() as drops:
            logits, cache = step_fn(model, cache, {"token": torch.from_numpy(toks[:, i]),
                                                    "pos": torch.from_numpy(pos)})
        dropped += sum(int(d) for d in drops)
        assert rel(logits, rlog) < 1e-5, i
    assert dropped > 0  # two tokens on one expert: the second is dropped, in both packages
    for k in ("k", "v"):
        assert rel(cache[k], rcache[k]) < 1e-5, k


# --------------------------------------------------- params, checkpoints
def test_init_params_rule_and_full_width_counts():
    rcfg, cfg = smoke_pair("olmoe_1b_7b")
    model = T.init_params(cfg, torch.Generator().manual_seed(0))
    tree = T.params_to_reference(model)
    assert jax.tree.map(lambda a: a.shape, tree) == ref_tf.param_shapes(rcfg)
    for name in ("router", "we_g", "we_u", "we_d"):
        w = tree["layers"][name]
        sd = w.shape[-2] ** -0.5  # router: d; we_g/we_u: d; we_d: d_ff
        assert abs(w.mean()) < 0.1 * sd and abs(w.std() - sd) < 0.1 * sd, name
    gap = 2 * (cfg.vocab_padded - cfg.vocab) * cfg.d_model + (2 * cfg.n_layers + 1) * cfg.d_model
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count() + gap
    for arch, count in (("olmoe_1b_7b", 6_919_028_736), ("phi35_moe_42b", 41_872_261_120)):
        full = configs.get_config(arch)
        assert T.param_shapes(full) == ref_tf.param_shapes(ref_configs.get_config(arch))
        assert full.param_count() == count


@pytest.mark.parametrize("arch", ARCHS)
def test_params_and_checkpoints_both_ways(tmp_path, arch):
    rcfg, cfg = smoke_pair(arch)
    tree = carried_params(rcfg, seed=14)
    back = T.params_to_reference(T.params_from_reference(tree))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
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
    fresh = T.init_params(cfg, torch.Generator().manual_seed(1))
    got, meta = restore_checkpoint(tmp_path / "ref", {"params": fresh, "opt": init_opt_state(fresh)})
    assert got["params"] is fresh and meta["step"] == 6
    assert_equal({"opt": {"mu": stack_named(got["opt"]["mu"]), "nu": stack_named(got["opt"]["nu"]),
                          "step": got["opt"]["step"].numpy()}, "params": T.params_to_reference(fresh)}, port)


# -------------------------------------------------------------- CLI, API
@pytest.mark.parametrize("arch", ARCHS)
def test_model_api_dispatches_the_moe_to_the_transformer(arch):
    api = model_api(configs.get_smoke(arch))
    assert (api.init_params, api.loss_fn, api.decode_step, api.cache_shapes, api.init_cache,
            api.train_input_specs, api.prefill_cross_cache) == (
        T.init_params, T.loss_fn, T.decode_step, T.cache_shapes, T.init_cache, T.train_input_specs, None)
    for preset in ("smoke", "tiny"):  # both keep routing: experts and top-k as configured
        port, ref = train_cli.preset_config(arch, preset), ref_configs.get_config(arch)
        assert port.family == "moe" and port.n_experts == (
            ref_configs.get_smoke(arch).n_experts if preset == "smoke" else ref.n_experts)


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_smoke(tmp_path, capsys, arch):
    argv = ["--arch", arch, "--preset", "smoke", "--device", "cpu", "--steps", "2", "--batch", "2",
            "--seq", "16", "--log-every", "1", "--ckpt-dir", str(tmp_path)]
    train_cli.main(argv)
    out = capsys.readouterr().out.splitlines()
    cfg = configs.get_smoke(arch)
    assert out[0] == f"arch={cfg.name} params={cfg.param_count() / 1e6:.1f}M preset=smoke"
    steps = [line for line in out if line.startswith("step ")]
    assert len(steps) == 2 and out[-1] == "done"
    assert all(np.isfinite(float(line.split()[3])) and np.isfinite(float(line.split()[5])) for line in steps)
    assert latest_step(tmp_path) == 2
