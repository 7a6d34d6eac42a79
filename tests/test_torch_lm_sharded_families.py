"""The ssm, hybrid and encdec families' sharded train step over a world.

A module-scoped world of 4 gloo processes on the CPU (``file://``
rendezvous under ``tmp_path``) runs this file as a script, once per rank
(the children import ``repro_torch`` only, neither JAX nor the
reference).  Beside it, two reference subprocesses run the reference's
sharded step on 4 forced host devices (``AxisType.Auto`` meshes, XLA's
cheap compile), and the test process runs the port's one-device step
(held to the reference by ``tests/test_torch_ssm.py`` and
``tests/test_torch_encdec.py``).  Every case starts from one numpy tree a
seed draws (:func:`carried`) and takes two float32 steps on
``batch_at``'s batches 0 and 1 (batch 4 x seq 16, whisper's frames
beside; AdamW with eps 1e-3, as ``tests/test_torch_lm.py`` says why).

(a) (2, 2) mamba2, zamba2 and whisper against the reference's sharded
    step: loss and grad norm within 1e-5 relative, the gathered first
    moments within 1e-5 of each leaf's max, each process's blocks equal to
    the slices of the gathered leaves.  mamba2's ``in_proj`` columns do
    not follow its heads over "model" (296 columns, 74 a process), so each
    process gathers the projection over "model".
(b) against the port's one-device step: (1, 4) mamba2 (2 SSD heads a
    process), (4, 1) zamba2 (FSDP only) and (1, 4) mamba2 with 6 SSD heads
    (``d_model`` 48), which "model" does not divide, so the heads and
    ``in_proj`` run replicated while ``out_proj``'s rows stay sharded:
    loss and grad norm within 1e-5 relative, the gathered parameters and
    first moments within 1e-5 of each leaf's max.
"""

import datetime
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_lm_sharded import leaves, load_tree, mesh_names, rel, save_tree, world_tree

ROOT = Path(__file__).resolve().parents[1]
WORLD, TIMEOUT_S = 4, 240
OPT = dict(lr=1e-3, eps=1e-3, warmup_steps=2, total_steps=10)
B, S, STEPS = 4, 16, 2
# name: (mesh shape, arch, config overrides)
REFERENCE = {
    "mamba2": ((2, 2), "mamba2_780m", {}),
    "zamba2": ((2, 2), "zamba2_1_2b", {}),
    "whisper": ((2, 2), "whisper_medium", {}),
}
ONE_DEVICE = {
    "mamba2_tp": ((1, 4), "mamba2_780m", {}),
    "zamba2_fsdp": ((4, 1), "zamba2_1_2b", {}),
    "mamba2_6_heads": ((1, 4), "mamba2_780m", {"d_model": 48}),
}
CASES = REFERENCE | ONE_DEVICE


def port_cfg(arch, kw):
    import repro_torch.configs as configs

    return configs.get_smoke(arch).with_(dtype=torch.float32, **kw)


def carried(cfg, seed):
    """The stacked numpy params tree of a case: the leaves the initialiser
    sets to constants near them (norms, ``conv_b`` and ``D_skip`` 1 + N(0,
    0.1); ``A_log`` log(1 … h) + N(0, 0.1); ``dt_bias`` -1 + N(0, 0.1)),
    ``emb``, ``lm_head`` and ``enc_pos`` N(0, 0.02), every other weight
    N(0, fan_in^-1/2) with fan_in its input width."""
    from repro_torch.models.common import STACKED
    from repro_torch.models.registry import model_api

    rng = np.random.default_rng(seed)

    def leaf(shape, name, stacked):
        core = shape[1:] if stacked else shape
        noise = rng.standard_normal(shape)
        if "ln" in name or name in ("conv_b", "D_skip"):
            v = 1 + 0.1 * noise
        elif name == "A_log":
            v = np.log(np.broadcast_to(np.arange(1, shape[-1] + 1), shape)) + 0.1 * noise
        elif name == "dt_bias":
            v = -1 + 0.1 * noise
        elif name in ("emb", "lm_head", "enc_pos"):
            v = 0.02 * noise
        elif name in ("wo", "xo"):
            v = noise / np.sqrt(core[0] * core[1])
        else:
            v = noise / np.sqrt(core[0])
        return v.astype(np.float32)

    return {k: ({n: leaf(s, n, k in STACKED) for n, s in v.items()} if isinstance(v, dict)
                else leaf(v, k, False))
            for k, v in model_api(cfg).param_shapes(cfg).items()}


def write_inputs(d: Path):
    from repro_torch.models.registry import model_api
    from repro_torch.train import DataConfig, batch_at

    out = {}
    for i, (name, (_, arch, kw)) in enumerate(CASES.items()):
        cfg = port_cfg(arch, kw)
        save_tree(out, f"{name}/params/", carried(cfg, seed=40 + i))
        extra = {k: v for k, v in model_api(cfg).train_input_specs(cfg, B, S).items()
                 if k not in ("tokens", "labels")}
        for step in range(STEPS):
            for k, v in batch_at(DataConfig(vocab=cfg.vocab, batch=B, seq=S), step, extra=extra).items():
                out[f"{name}/batch{step}/{k}"] = v.numpy()
    np.savez(d / "inputs.npz", **out)


def batches(npz, name):
    return [{k: torch.from_numpy(v) for k, v in load_tree(npz, f"{name}/batch{s}/").items()}
            for s in range(STEPS)]


# ------------------------------------------------------------ world side
def _world_main(d: Path, rank: int) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d / 'rendezvous'}", rank=rank,
                            world_size=WORLD, timeout=datetime.timedelta(seconds=60))
    try:
        out = _world(d)
    finally:
        dist.destroy_process_group()
    out["modules"] = np.asarray(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro")))
    np.savez(d / f"rank{rank}.npz", **out)


def _world(d: Path) -> dict:
    from repro_torch.launch.mesh import LMMesh
    from repro_torch.models import transformer as T
    from repro_torch.models.common import block_of, gather_named
    from repro_torch.train import AdamWConfig, build_train_step

    npz = np.load(d / "inputs.npz")
    out = {}
    for name, (shape, arch, kw) in CASES.items():
        cfg = port_cfg(arch, kw)
        mesh = LMMesh(shape, mesh_names(shape), device="cpu")
        bundle = build_train_step(cfg, AdamWConfig(**OPT), batch=B, seq=S, mesh=mesh)
        model = bundle.shard(load_tree(npz, f"{name}/params/"))
        opt = bundle.init_opt(model)
        metrics, calls = [], []
        for data in batches(npz, name):
            mesh.reset_counters()
            m = bundle.step_fn(model, opt, data)
            metrics.append([float(m["loss"]), float(m["grad_norm"]), float(m["lr"])])
            calls.append(dict(mesh.calls))
        out[f"{name}/metrics"] = np.asarray(metrics)
        out[f"{name}/calls"] = np.asarray(json.dumps(calls))
        full = bundle.unshard(model)
        spec_of = bundle.state_specs["params"]
        mom_of = bundle.state_specs["opt"]["mu"]
        mu = gather_named(opt["mu"], mom_of, mesh)
        out[f"{name}/block_err"] = np.asarray(max(
            [float((p.detach() - block_of(full[n], spec_of(n), mesh)).abs().max())
             for n, p in model.named_parameters()]
            + [float((opt["mu"][n] - block_of(mu[n], mom_of(n), mesh)).abs().max()) for n in mu]))
        if mesh.rank == 0:
            save_tree(out, f"{name}/params/", T.stack_named(full))
            save_tree(out, f"{name}/mu/", T.stack_named(mu))
    return out


# ------------------------------------------------------- reference side
def _reference_main(d: Path, part: int) -> None:
    """The reference's sharded steps on 4 forced host devices, in two
    processes that run at once (``part`` 0: mamba2 and whisper; 1:
    zamba2)."""
    import warnings

    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    jax.config.update("jax_disable_most_optimizations", True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        import repro.configs as ref_configs
        import repro.train as ref_train

    npz = np.load(d / "inputs.npz")
    out = {}
    for name in (("mamba2", "whisper"), ("zamba2",))[part]:
        shape, arch, kw = REFERENCE[name]
        mesh = jax.make_mesh(shape, mesh_names(shape), axis_types=(AxisType.Auto,) * len(shape))
        rcfg = ref_configs.get_smoke(arch).with_(dtype=jnp.float32, **kw)
        bundle = ref_train.build_train_step(rcfg, mesh, ref_train.AdamWConfig(**OPT), batch=B, seq=S,
                                            donate=False)
        params = jax.device_put(jax.tree.map(jnp.asarray, load_tree(npz, f"{name}/params/")),
                                bundle.param_shardings)
        opt = jax.device_put(ref_train.init_opt_state(params), bundle.opt_shardings)
        metrics = []
        for data in batches(npz, name):
            rb = jax.device_put({k: jnp.asarray(v.numpy()) for k, v in data.items()},
                                bundle.batch_shardings)
            params, opt, m = bundle.step_fn(params, opt, rb)
            metrics.append([float(m["loss"]), float(m["grad_norm"]), float(m["lr"])])
        out[f"{name}/metrics"] = np.asarray(metrics)
        save_tree(out, f"{name}/mu/", jax.tree.map(np.asarray, opt["mu"]))
    np.savez(d / f"reference{part}.npz", **out)


# ------------------------------------------------------------ parent side
def from_reference(cfg, tree):
    from repro_torch.models import encdec, ssm

    return (encdec if cfg.family == "encdec" else ssm).params_from_reference(tree)


def _one_device(npz, name):
    """The port's one-device steps of a case: metrics, params, mu."""
    from repro_torch.models import transformer as T
    from repro_torch.train import AdamWConfig, build_train_step, init_opt_state

    _, arch, kw = CASES[name]
    cfg = port_cfg(arch, kw)
    model = from_reference(cfg, load_tree(npz, f"{name}/params/"))
    opt = init_opt_state(model)
    step_fn = build_train_step(cfg, AdamWConfig(**OPT), batch=B, seq=S, device="cpu").step_fn
    metrics = []
    for data in batches(npz, name):
        m = step_fn(model, opt, data)
        metrics.append([float(m["loss"]), float(m["grad_norm"]), float(m["lr"])])
    return {"metrics": np.asarray(metrics), "params": T.params_to_reference(model),
            "mu": T.stack_named(opt["mu"])}


def start(d: Path, script: str, n_refs: int, world: int = WORLD):
    """The world's processes and ``n_refs`` reference processes of
    ``script`` (a test file run as a script), their logs under ``d``."""
    base = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env = base | {"GLOO_SOCKET_IFNAME": os.environ.get("GLOO_SOCKET_IFNAME", "lo")}
    ref_env = base | {"JAX_PLATFORMS": "cpu", "XLA_FLAGS": "--xla_force_host_platform_device_count=4 "
                                                          "--xla_cpu_multi_thread_eigen=false"}
    refs = [f"reference{i}" for i in range(n_refs)]
    logs = {r: open(d / f"{r}.log", "w") for r in [*range(world), *refs]}
    procs = {r: subprocess.Popen([sys.executable, script, str(d), str(r)],
                                 env=env if r not in refs else ref_env,
                                 stdout=logs[r], stderr=subprocess.STDOUT) for r in logs}
    return procs, logs


def finish(d: Path, procs, logs, timeout_s: float = TIMEOUT_S) -> None:
    """Wait for every process (killed past ``timeout_s``) and fail on any
    that did not exit 0, with the end of its log."""
    try:
        deadline = time.monotonic() + timeout_s
        for p in procs.values():
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs.values():
            f.close()
    failed = {r: (d / f"{r}.log").read_text()[-3000:] for r, p in procs.items() if p.returncode}
    assert not failed, failed


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the world's results by rank, the reference's, the one-device steps
    by case): the world and the reference run while the test process
    computes the one-device steps."""
    d = tmp_path_factory.mktemp("lm_sharded_families")
    write_inputs(d)
    procs, logs = start(d, __file__, 2)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the world and the reference need the cores
    try:
        npz = np.load(d / "inputs.npz")
        one = {name: _one_device(npz, name) for name in ONE_DEVICE}
    finally:
        torch.set_num_threads(threads)
        finish(d, procs, logs)
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]
    return ranks, dict(np.load(d / "reference0.npz")) | dict(np.load(d / "reference1.npz")), one


def assert_metrics_and_blocks(ranks, name, want_metrics):
    for out in ranks:  # every process reports the same global metrics
        got = out[f"{name}/metrics"]
        for (l, gn, lr), (wl, wgn, wlr) in zip(got, want_metrics):
            assert rel(l, wl) < 1e-5 and rel(gn, wgn) < 1e-5 and rel(lr, wlr) < 1e-6, (name, got, want_metrics)
        assert float(out[f"{name}/block_err"]) == 0.0


def assert_leaves_close(got, want, what):
    assert got.keys() == want.keys(), (what, sorted(got.keys() ^ want.keys()))
    for k in want:
        assert np.max(np.abs(got[k] - want[k])) <= 1e-5 * np.max(np.abs(want[k])), (what, k)


def test_workers_import_neither_jax_nor_the_reference(runs):
    ranks, _, _ = runs
    assert all(out["modules"].size == 0 for out in ranks), [out["modules"] for out in ranks]


@pytest.mark.parametrize("name", sorted(REFERENCE))
def test_matches_the_reference_sharded_step(runs, name):
    ranks, ref, _ = runs
    assert_metrics_and_blocks(ranks, name, ref[f"{name}/metrics"])
    assert_leaves_close(world_tree(ranks, name, "mu"), leaves(load_tree(ref, f"{name}/mu/")), "mu")
    calls = json.loads(str(ranks[0][f"{name}/calls"]))
    assert calls[0].get("model", 0) > 0 and calls[0].get("data", 0) > 0


@pytest.mark.parametrize("name", sorted(ONE_DEVICE))
def test_matches_the_one_device_step(runs, name):
    ranks, _, one = runs
    assert_metrics_and_blocks(ranks, name, one[name]["metrics"])
    for what in ("params", "mu"):
        assert_leaves_close(world_tree(ranks, name, what), leaves(one[name][what]), what)


if __name__ == "__main__":
    d, who = Path(sys.argv[1]), sys.argv[2]
    sys.path.insert(0, str(ROOT / "src"))
    if who.startswith("reference"):
        _reference_main(d, int(who.removeprefix("reference")))
    else:
        _world_main(d, int(who))
