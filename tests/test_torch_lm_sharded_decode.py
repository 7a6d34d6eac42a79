"""The sharded decode step (``build_serve_step(mesh=…)``) of every family,
and checkpoints under the layout.

The pattern of ``tests/test_torch_lm_sharded_families.py``: a module-scoped
world of 4 gloo processes runs this file as a script, once per rank
(``repro_torch`` only), two reference subprocesses run the reference on 4
forced host devices, and the test process runs the port on one device.
Weights are carried from one seeded numpy tree
(:func:`test_torch_lm_sharded_families.carried`), in float32.

(a) Decode, against the reference's ``build_serve_step`` on the same
    mesh: 6 tokens (drawn from a seed) at positions offset by row (each
    row starts at its own slot, so a sequence-sharded cache is written on
    more than one process and a process's slots may all be masked), the
    gathered logits of every step and the gathered caches at the end
    within 1e-5 of their max.  Cases: stablelm (K/V over heads),
    granite-20b (MQA: the cache's slots over "model", combined by the
    log-sum-exp rule), olmoe (experts over "model", each batch shard's
    tokens routed together), mamba2 (the SSM state over heads), zamba2 at
    batch 4 on (2, 2) and at batch 2 on (4, 1) (the batch does not divide
    "data", so the K/V slots go over "data"), and whisper after
    ``prefill`` (self and cross K/V over heads).
(b) Checkpoints: a (2, 2) stablelm step is saved under the layout (each
    leaf gathered by its spec, rank 0 writes), then restored onto a fresh
    (2, 2) model, onto (1, 4) and, in the test process, onto one device:
    the next step equals the uninterrupted run's (bit for bit on (2, 2),
    within 1e-5 elsewhere), and the reference's ``restore_checkpoint``
    reads the checkpoint, its leaves equal to the port's gathered ones.
    The trainer's CLI on ``--mesh 2,2`` stops after 2 steps and resumes to
    4 with the lines of an uninterrupted 4-step run; a SIGTERM that
    reaches rank 0 alone makes every rank save at the next step boundary
    and exit 143.
"""

import contextlib
import datetime
import io
import os
import signal
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_lm_sharded import load_tree, mesh_names, rel, save_tree
from test_torch_lm_sharded_families import carried, finish, port_cfg, start

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
OPT = dict(lr=1e-3, eps=1e-3, warmup_steps=2, total_steps=10)
SEQ, TOKENS = 32, 6
OFFSETS = {4: [0, 9, 14, 26], 2: [0, 13]}
# name: (mesh shape, arch, batch)
DECODE = {
    "stablelm": ((2, 2), "stablelm_1_6b", 4),
    "granite20": ((2, 2), "granite_20b", 4),
    "olmoe": ((2, 2), "olmoe_1b_7b", 4),
    "mamba2": ((2, 2), "mamba2_780m", 4),
    "zamba2": ((2, 2), "zamba2_1_2b", 4),
    "zamba2_b2": ((4, 1), "zamba2_1_2b", 2),
    "whisper": ((2, 2), "whisper_medium", 4),
}
CKPT_ARCH, B, S = "stablelm_1_6b", 4, 16


def write_inputs(d: Path):
    from repro_torch.train import DataConfig, batch_at

    out = {}
    for i, (name, (_, arch, b)) in enumerate(DECODE.items()):
        cfg = port_cfg(arch, {})
        save_tree(out, f"{name}/params/", carried(cfg, seed=60 + i))
        rng = np.random.default_rng(70 + i)
        out[f"{name}/tokens"] = rng.integers(0, cfg.vocab, (TOKENS, b)).astype(np.int32)
        out[f"{name}/frames"] = (0.1 * rng.standard_normal((b, cfg.enc_ctx, cfg.d_model))).astype(np.float32)
    cfg = port_cfg(CKPT_ARCH, {})
    save_tree(out, "ckpt/params/", carried(cfg, seed=80))
    for step in range(2):
        for k, v in batch_at(DataConfig(vocab=cfg.vocab, batch=B, seq=S), step).items():
            out[f"ckpt/batch{step}/{k}"] = v.numpy()
    np.savez(d / "inputs.npz", **out)


def positions(b, t):
    return np.asarray(OFFSETS[b], np.int32) + t


def ckpt_batch(npz, step):
    return {k: torch.from_numpy(v) for k, v in load_tree(npz, f"ckpt/batch{step}/").items()}


# ------------------------------------------------------------ world side
def _world_main(d: Path, rank: int) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d / 'rendezvous'}", rank=rank,
                            world_size=WORLD, timeout=datetime.timedelta(seconds=60))
    try:
        out = _checkpoints(d, rank) | _decode(d) | _cli(d, rank)
    finally:
        dist.destroy_process_group()
    out["modules"] = np.asarray(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro")))
    np.savez(d / f"rank{rank}.npz", **out)


def _decode(d: Path) -> dict:
    from repro_torch.launch.mesh import LMMesh
    from repro_torch.train import build_serve_step

    npz = np.load(d / "inputs.npz")
    out = {}
    for name, (shape, arch, b) in DECODE.items():
        cfg = port_cfg(arch, {})
        mesh = LMMesh(shape, mesh_names(shape), device="cpu")
        step, info = build_serve_step(cfg, b, SEQ, mesh=mesh)
        params = info["shard"](load_tree(npz, f"{name}/params/"))
        if "prefill" in info:
            cache = info["prefill"](params, torch.from_numpy(npz[f"{name}/frames"]))
        else:
            cache = info["init_cache"]()
        logits = []
        for t in range(TOKENS):
            lg, cache = step(params, cache, {"token": torch.from_numpy(npz[f"{name}/tokens"][t]),
                                             "pos": torch.from_numpy(positions(b, t))})
            logits.append(info["gather_logits"](lg).numpy())
        out[f"{name}/logits"] = np.stack(logits)
        out[f"{name}/seq_axes"] = np.asarray(str(info["cache_specs"].get("k", (None,) * 3)[2]))
        for k, v in info["unshard_cache"](cache).items():
            out[f"{name}/cache/{k}"] = v.float().numpy()
    return out


def _checkpoints(d: Path, rank: int) -> dict:
    """(b): the uninterrupted run saves after step 0; fresh models on (2, 2)
    and (1, 4) restore it and take step 1."""
    from repro_torch.launch.mesh import LMMesh
    from repro_torch.models import transformer as T
    from repro_torch.models.common import gather_named
    from repro_torch.train import AdamWConfig, build_train_step, restore_checkpoint, save_checkpoint

    npz = np.load(d / "inputs.npz")
    cfg = port_cfg(CKPT_ARCH, {})
    out = {}

    def bundle_on(shape):
        mesh = LMMesh(shape, ("data", "model"), device="cpu")
        return mesh, build_train_step(cfg, AdamWConfig(**OPT), batch=B, seq=S, mesh=mesh)

    def after_step1(tag, mesh, bundle, model, opt):
        m = bundle.step_fn(model, opt, ckpt_batch(npz, 1))
        out[f"ckpt/{tag}/metrics"] = np.asarray([float(m["loss"]), float(m["grad_norm"])])
        full = bundle.unshard(model)  # collective: every rank gathers
        if rank == 0:
            save_tree(out, f"ckpt/{tag}/params/", T.stack_named(full))

    mesh, bundle = bundle_on((2, 2))
    model = bundle.shard(load_tree(npz, "ckpt/params/"))
    opt = bundle.init_opt(model)
    bundle.step_fn(model, opt, ckpt_batch(npz, 0))
    save_checkpoint(d / "ckpt", 1, {"params": model, "opt": opt}, mesh=mesh, specs=bundle.state_specs)
    mom_of = bundle.state_specs["opt"]["mu"]  # the saved values, gathered by every rank
    saved = {"params": bundle.unshard(model)} | {k: gather_named(opt[k], mom_of, mesh) for k in ("mu", "nu")}
    saved = {k: {n: t.clone() for n, t in v.items()} for k, v in saved.items()}  # not views of what steps
    if rank == 0:
        for k, v in saved.items():
            save_tree(out, f"ckpt/saved/{k}/", T.stack_named(v))
    after_step1("uninterrupted", mesh, bundle, model, opt)
    for tag, shape in (("same_mesh", (2, 2)), ("other_mesh", (1, 4))):
        mesh, bundle = bundle_on(shape)
        fresh = bundle.init(torch.Generator().manual_seed(5))
        state, meta = restore_checkpoint(d / "ckpt", {"params": fresh, "opt": bundle.init_opt(fresh)},
                                         mesh=mesh, specs=bundle.state_specs)
        assert meta["step"] == 1 and state["params"] is fresh
        after_step1(tag, mesh, bundle, fresh, state["opt"])
    return out


def _cli(d: Path, rank: int) -> dict:
    """The trainer's CLI on (2, 2): 2 steps with checkpoints, resumed to 4,
    against 4 uninterrupted; then a SIGTERM to rank 0 alone."""
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.mesh import LMMesh
    from repro_torch.train import install_preemption_handler, latest_step, save_checkpoint

    argv = ["--preset", "smoke", "--device", "cpu", "--mesh", "2,2", "--batch", "4", "--seq", "16",
            "--log-every", "1"]
    out = {}
    for tag, extra in (("first", ["--steps", "2", "--ckpt-dir", str(d / "cli")]),
                       ("resumed", ["--steps", "4", "--ckpt-dir", str(d / "cli"), "--resume"]),
                       ("uninterrupted", ["--steps", "4"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            train_cli.main(argv + extra)
        out[f"cli/{tag}"] = np.asarray(buf.getvalue())
    mesh = LMMesh((2, 2), ("data", "model"), device="cpu")
    before = signal.getsignal(signal.SIGTERM)
    poll = install_preemption_handler(
        lambda: save_checkpoint(d / "preempted", 7, {"x": torch.ones(3)}, mesh=mesh), mesh)
    if rank == 0:
        os.kill(os.getpid(), signal.SIGTERM)
    try:
        poll()
        code = 0
    except SystemExit as e:
        code = e.code
    finally:
        signal.signal(signal.SIGTERM, before)
    out["preempted/exit"] = np.asarray(code)
    out["preempted/step"] = np.asarray(latest_step(d / "preempted"))
    return out


# ------------------------------------------------------- reference side
def _reference_main(d: Path, part: int) -> None:
    """The reference's decode steps on 4 forced host devices, in two
    processes that run at once; part 1 then reads the checkpoint the
    world writes."""
    import warnings

    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    jax.config.update("jax_disable_most_optimizations", True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        import repro.configs as ref_configs
        import repro.train as ref_train
        from repro.models import encdec as ref_encdec
        from repro.models.registry import model_api

    npz = np.load(d / "inputs.npz")
    out = {}
    for name in list(DECODE)[part::2]:
        shape, arch, b = DECODE[name]
        mesh = jax.make_mesh(shape, mesh_names(shape), axis_types=(AxisType.Auto,) * len(shape))
        rcfg = ref_configs.get_smoke(arch).with_(dtype=jnp.float32)
        step, info = ref_train.build_serve_step(rcfg, mesh, b, SEQ)
        params = jax.device_put(jax.tree.map(jnp.asarray, load_tree(npz, f"{name}/params/")),
                                info["param_shardings"])
        api = model_api(rcfg)
        if rcfg.family == "encdec":
            cache = ref_encdec.prefill_cross_cache(rcfg, mesh, params, jnp.asarray(npz[f"{name}/frames"]), b,
                                                   SEQ)
        else:
            cache = api.init_cache(rcfg, b, SEQ)
        cache = jax.device_put(cache, info["cache_shardings"])
        logits = []
        for t in range(TOKENS):
            batch = jax.device_put({"token": jnp.asarray(npz[f"{name}/tokens"][t]),
                                    "pos": jnp.asarray(positions(b, t))}, info["batch_shardings"])
            lg, cache = step(params, cache, batch)
            logits.append(np.asarray(lg))
        out[f"{name}/logits"] = np.stack(logits)
        for k, v in cache.items():
            out[f"{name}/cache/{k}"] = np.asarray(v, np.float32)
    if part == 1:  # the port's checkpoint, once the world has written it
        deadline = time.monotonic() + 120
        while not (d / "ckpt" / "latest" / "meta.json").exists() and time.monotonic() < deadline:
            time.sleep(0.2)
        tree = jax.tree.map(jnp.asarray, load_tree(npz, "ckpt/params/"))
        state, meta = ref_train.restore_checkpoint(d / "ckpt", {"params": tree,
                                                                "opt": ref_train.init_opt_state(tree)})
        out["ckpt/step"] = np.asarray(meta["step"])
        for k in ("mu", "nu"):
            save_tree(out, f"ckpt/{k}/", jax.tree.map(np.asarray, state["opt"][k]))
        save_tree(out, "ckpt/params/", jax.tree.map(np.asarray, state["params"]))
    np.savez(d / f"reference{part}.npz", **out)


# ------------------------------------------------------------ parent side
def _one_device_restore(d: Path, npz) -> dict:
    """Step 1 on one device from the world's checkpoint."""
    from repro_torch.models import transformer as T
    from repro_torch.train import AdamWConfig, build_train_step, init_opt_state, restore_checkpoint

    cfg = port_cfg(CKPT_ARCH, {})
    model = T.init_params(cfg, torch.Generator().manual_seed(5))
    deadline = time.monotonic() + 120
    while not (d / "ckpt" / "latest" / "meta.json").exists() and time.monotonic() < deadline:
        time.sleep(0.2)
    state, meta = restore_checkpoint(d / "ckpt", {"params": model, "opt": init_opt_state(model)})
    m = build_train_step(cfg, AdamWConfig(**OPT), batch=B, seq=S, device="cpu").step_fn(
        model, state["opt"], ckpt_batch(npz, 1))
    return {"metrics": np.asarray([float(m["loss"]), float(m["grad_norm"])]),
            "params": T.params_to_reference(model)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the world's results by rank, the reference's, the one-device
    restore's)."""
    d = tmp_path_factory.mktemp("lm_sharded_decode")
    write_inputs(d)
    procs, logs = start(d, __file__, 2)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = _one_device_restore(d, np.load(d / "inputs.npz"))
    finally:
        torch.set_num_threads(threads)
        finish(d, procs, logs)
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]
    return ranks, dict(np.load(d / "reference0.npz")) | dict(np.load(d / "reference1.npz")), one


def close(got, want):
    return np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))


def test_workers_import_neither_jax_nor_the_reference(runs):
    ranks, _, _ = runs
    assert all(out["modules"].size == 0 for out in ranks), [out["modules"] for out in ranks]


@pytest.mark.parametrize("name", list(DECODE))
def test_decode_matches_the_reference_sharded_step(runs, name):
    ranks, ref, _ = runs
    for out in ranks:  # every process gathers the same logits
        assert close(out[f"{name}/logits"], ref[f"{name}/logits"]), name
    keys = sorted(k for k in ref if k.startswith(f"{name}/cache/"))
    assert keys == sorted(k for k in ranks[0] if k.startswith(f"{name}/cache/"))
    for k in keys:
        assert close(ranks[0][k], ref[k]), k
    want_seq = {"granite20": "model", "zamba2_b2": "data"}.get(name, "None")
    assert str(ranks[0][f"{name}/seq_axes"]) == want_seq


def test_checkpoint_restores_onto_the_same_and_another_mesh_and_one_device(runs):
    ranks, _, one = runs
    for out in ranks:
        want = out["ckpt/uninterrupted/metrics"]
        assert np.array_equal(out["ckpt/same_mesh/metrics"], want)
        assert rel(out["ckpt/other_mesh/metrics"], want) < 1e-5
        assert rel(one["metrics"], want) < 1e-5
    want = load_tree(ranks[0], "ckpt/uninterrupted/params/")
    for tag in ("same_mesh", "other_mesh"):
        got = load_tree(ranks[0], f"ckpt/{tag}/params/")
        for group in want:
            for k, w in (want[group].items() if isinstance(want[group], dict) else [("", want[group])]):
                g = got[group][k] if k else got[group]
                assert (np.array_equal(g, w) if tag == "same_mesh" else close(g, w)), (tag, group, k)
    for group, w in want.items():
        for k, wv in (w.items() if isinstance(w, dict) else [("", w)]):
            assert close(np.asarray(one["params"][group][k] if k else one["params"][group]), wv), (group, k)


def test_the_reference_reads_the_checkpoint(runs):
    ranks, ref, _ = runs
    assert int(ref["ckpt/step"]) == 1
    for what in ("params", "mu", "nu"):
        want = load_tree(ranks[0], f"ckpt/saved/{what}/")
        got = load_tree(ref, f"ckpt/{what}/")
        flat = lambda t, p="": {k2: v2 for k, v in t.items() for k2, v2 in
                                (flat(v, f"{p}{k}/").items() if isinstance(v, dict) else [(p + k, v)])}
        assert flat(got).keys() == flat(want).keys()
        for k, v in flat(want).items():
            np.testing.assert_array_equal(flat(got)[k], v, err_msg=f"{what}/{k}")


def test_cli_resumes_where_it_stopped_and_a_partial_sigterm_saves(runs):
    ranks, _, _ = runs
    lines = {tag: str(ranks[0][f"cli/{tag}"]).splitlines() for tag in ("first", "resumed", "uninterrupted")}
    assert lines["resumed"][1] == "resumed from step 2" and lines["resumed"][-1] == "done"
    fields = lambda ls: [ln.split()[:8] for ln in ls if ln.startswith("step ")]  # without the ms
    assert fields(lines["first"]) == fields(lines["uninterrupted"])[:2]
    assert fields(lines["resumed"]) == fields(lines["uninterrupted"])[2:]
    assert all(str(out["cli/resumed"]) == "" for out in ranks[1:])  # only rank 0 prints
    for out in ranks:
        assert int(out["preempted/exit"]) == 143 and int(out["preempted/step"]) == 7


if __name__ == "__main__":
    d, who = Path(sys.argv[1]), sys.argv[2]
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "tests"))
    if who.startswith("reference"):
        _reference_main(d, int(who.removeprefix("reference")))
    else:
        _world_main(d, int(who))
