"""The LM half's sharded step: 2-D FSDP("data") x TP("model") over a world.

A module-scoped world of 4 gloo processes on the CPU (``file://``
rendezvous under ``tmp_path``) runs this file as a script, once per rank
(the children import ``repro_torch`` only, neither JAX nor the
reference).  Beside it, two reference subprocesses run the reference's
sharded step on 4 forced host devices (``AxisType.Auto`` meshes, XLA's
cheap compile), and the test process runs the port's one-device step.
Every case starts from one numpy tree a seed draws (norms 1 + N(0, 0.1),
``emb``/``lm_head`` N(0, 0.02), the rest N(0, fan_in^-1/2)) and takes two
float32 steps on ``batch_at``'s batches 0 and 1 (batch 4 x seq 16; AdamW
with eps 1e-3, as ``tests/test_torch_lm.py`` says why).

(a) (2, 2): stablelm (dense), granite-20b (MQA: its one K/V head
    replicated and sliced to each process's query heads) and paligemma
    (tied embeddings, the image prefix): loss and grad norm within 1e-5
    relative of the reference's sharded step, the gathered first moments
    within 1e-5 of each leaf's max; each process's blocks equal the slices
    of the gathered leaves.
(b) (2, 2) olmoe at its own capacity factor, against the reference's
    sharded step (per-shard capacity and the pmean'd aux): its shards drop
    picks, and the one-device step differs there.
(c) against the port's one-device step (held to the reference by
    ``tests/test_torch_lm.py``): (4, 1) FSDP only, and (1, 4) TP/EP only
    with ``dense_scatter_combine`` and ``moe_scatter_combine`` off and on
    (granite-8b's 2 K/V heads replicated over 4: the GQA slice, also in 2
    microbatches; olmoe at
    capacity_factor E/k, where nothing drops; on (4, 1) the levers have no
    sequence to scatter over "model"; without ``seq_parallel``; 6 heads
    and a d_ff of 250, which "model" does not divide, run replicated), and
    (2, 2) with remat, the chunked
    levers and ``dense_scatter_combine``: loss and grad norm within 1e-5
    relative, the
    gathered parameters within 1e-5 and the first moments within 1e-5 of
    each leaf's max.  (A data-sharded MoE differs from one device by
    design, its aux being a mean over shards.)
(d) ("pod", "data", "model") (2, 2, 1): ``hierarchical_allreduce`` in its
    three branches (the 2-step path, a leading dim "data" does not divide,
    no pod axis) on per-process values (their sum) and on replicated ones
    (the reference's n·x, held to the reference's output);
    ``tiered_collective_bytes`` of a pod train step's recorded calls equal
    to the reference's on HLO lines written for the same calls; the pod
    step against the one-device step as (c).  The dry-run's fake-world
    trace of the stablelm, olmoe and pod steps makes rank 0's calls.
(e) ``make_production_mesh()`` in a world of 4 raises ``ValueError``; an
    expert count that "model" does not divide is refused; the trainer's CLI
    trains on ``--mesh 2,2`` (rank 0 prints).  (The perf CLI without
    ``--ecg`` traces its cells on a fake world:
    ``tests/test_torch_dryrun.py``.)  (The other families, the sharded decode step and
    checkpoints under the layout: ``tests/test_torch_lm_sharded_families.py``
    and ``tests/test_torch_lm_sharded_decode.py``.)
"""

import contextlib
import datetime
import io
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
WORLD, TIMEOUT_S = 4, 240
OPT = dict(lr=1e-3, eps=1e-3, warmup_steps=2, total_steps=10)
B, S, STEPS = 4, 16, 2
# name: (mesh shape, arch, config overrides)
REFERENCE = {
    "stablelm": ((2, 2), "stablelm_1_6b", {}),
    "granite20": ((2, 2), "granite_20b", {}),
    "paligemma": ((2, 2), "paligemma_3b", {}),
    "olmoe": ((2, 2), "olmoe_1b_7b", {}),
}
ONE_DEVICE = {
    "fsdp": ((4, 1), "stablelm_1_6b", {}),
    "tp": ((1, 4), "granite_8b", {}),
    "tp_scatter": ((1, 4), "granite_8b", {"dense_scatter_combine": True}),
    "tp_no_sp": ((1, 4), "granite_8b", {"seq_parallel": False}),
    # 6 heads and d_ff 250 do not divide over 4: attention and the MLP run
    # replicated over "model", as the reference's specs lay them out
    "tp_uneven": ((1, 4), "stablelm_1_6b", {"n_heads": 6, "n_kv_heads": 6, "d_head": 16, "d_ff": 250}),
    "ep": ((1, 4), "olmoe_1b_7b", {"capacity_factor": 4.0}),
    "ep_scatter": ((1, 4), "olmoe_1b_7b", {"capacity_factor": 4.0, "moe_scatter_combine": True}),
    "levers": ((2, 2), "granite_8b", {"remat": True, "attn_chunk": 8, "loss_chunk": 8,
                                      "dense_scatter_combine": True}),
    "pod": ((2, 2, 1), "stablelm_1_6b", {"remat": True}),
}
CASES = REFERENCE | ONE_DEVICE
MICROBATCHES = {"tp": 2}  # the rest take the batch in one


def mesh_names(shape):
    return ("data", "model") if len(shape) == 2 else ("pod", "data", "model")


def port_cfg(arch, kw):
    import repro_torch.configs as configs

    return configs.get_smoke(arch).with_(dtype=torch.float32, **kw)


def carried(cfg, seed):
    """The stacked numpy params tree of a case (module docstring)."""
    from repro_torch.models import transformer as T

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
            for k, v in T.param_shapes(cfg).items()}


def save_tree(out, prefix, tree):
    for k, v in tree.items():
        if isinstance(v, dict):
            save_tree(out, f"{prefix}{k}/", v)
        else:
            out[prefix + k] = np.asarray(v)


def load_tree(npz, prefix):
    tree = {}
    for key in getattr(npz, "files", npz):
        if key.startswith(prefix):
            node, parts = tree, key[len(prefix):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = npz[key]
    return tree


def write_inputs(d: Path):
    from repro_torch.train import DataConfig, batch_at
    from repro_torch.models import transformer as T

    out = {}
    for i, (name, (_, arch, kw)) in enumerate(CASES.items()):
        cfg = port_cfg(arch, kw)
        save_tree(out, f"{name}/params/", carried(cfg, seed=10 + i))
        extra = {k: v for k, v in T.train_input_specs(cfg, B, S).items() if k not in ("tokens", "labels")}
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
        out = _world(d, rank)
    finally:
        dist.destroy_process_group()
    out["modules"] = np.asarray(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro")))
    np.savez(d / f"rank{rank}.npz", **out)


def _world(d: Path, rank: int) -> dict:
    from repro_torch.collectives import hierarchical_allreduce
    from repro_torch.launch.mesh import LMMesh
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    from repro_torch.models.common import block_of, gather_named, named_specs
    from repro_torch.train import AdamWConfig, build_train_step

    npz = np.load(d / "inputs.npz")
    out = {}
    for name, (shape, arch, kw) in CASES.items():
        cfg = port_cfg(arch, kw)
        mesh = LMMesh(shape, mesh_names(shape), device="cpu")
        bundle = build_train_step(cfg, AdamWConfig(**OPT), batch=B, seq=S, mesh=mesh,
                                  microbatches=MICROBATCHES.get(name, 1))
        model = bundle.shard(load_tree(npz, f"{name}/params/"))
        opt = bundle.init_opt(model)
        metrics, calls = [], []
        with moe.record_dropped() as dropped, mesh.record_calls() as records:
            for data in batches(npz, name):
                mesh.reset_counters()
                m = bundle.step_fn(model, opt, data)
                metrics.append([float(m["loss"]), float(m["grad_norm"]), float(m["lr"])])
                calls.append(dict(mesh.calls))
        out[f"{name}/metrics"] = np.asarray(metrics)
        out[f"{name}/dropped"] = np.asarray(sum(int(x) for x in dropped))
        out[f"{name}/calls"] = np.asarray(json.dumps(calls))
        if name == "pod":
            out["pod/records"] = np.asarray(json.dumps(records))
        full = bundle.unshard(model)
        spec_of = named_specs(bundle.param_specs)
        mom_of = named_specs(bundle.opt_specs["mu"])
        mu = gather_named(opt["mu"], mom_of, mesh)
        out[f"{name}/block_err"] = np.asarray(max(
            [float((p.detach() - block_of(full[n], spec_of(n), mesh)).abs().max())
             for n, p in model.named_parameters()]
            + [float((opt["mu"][n] - block_of(mu[n], mom_of(n), mesh)).abs().max()) for n in mu]))
        if rank == 0:
            save_tree(out, f"{name}/params/", T.stack_named(full))
            save_tree(out, f"{name}/mu/", T.stack_named(mu))
    # (d) hierarchical_allreduce's three branches
    pod = LMMesh((2, 2, 1), ("pod", "data", "model"), device="cpu")
    flat = LMMesh((2, 2), ("data", "model"), device="cpu")
    for tag, mesh, rows in (("two_step", pod, 4), ("uneven", pod, 3), ("no_pod", flat, 4)):
        own = torch.arange(rows * 3, dtype=torch.float32).view(rows, 3) * (rank + 1)
        out[f"hier/{tag}/own"] = hierarchical_allreduce(own, mesh).numpy()
        out[f"hier/{tag}/replicated"] = hierarchical_allreduce(hier_input(rows), mesh).numpy()
    out["hier/two_step/calls"] = np.asarray(json.dumps(pod.calls))
    # (e) refusals, then the CLI
    out |= _refusals()
    return out


def hier_input(rows):
    return torch.linspace(-1, 1, rows * 3, dtype=torch.float32).view(rows, 3)


def _refusals() -> dict:
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.mesh import LMMesh, make_production_mesh
    from repro_torch.train import build_train_step

    mesh = LMMesh((1, 4), ("data", "model"), device="cpu")
    got = {}

    def refused(tag, exc, fn, match=None):
        try:
            fn()
            got[f"refused/{tag}"] = np.asarray("no exception")
        except exc as e:
            got[f"refused/{tag}"] = np.asarray("ok" if match is None or match in str(e) else str(e))

    refused("production_mesh", ValueError, make_production_mesh, "256")
    refused("production_mesh_multi_pod", ValueError, lambda: make_production_mesh(multi_pod=True), "512")
    refused("experts", ValueError, lambda: build_train_step(
        port_cfg("olmoe_1b_7b", {"n_experts": 6}), batch=B, seq=S, mesh=mesh), "divide")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train_cli.main(["--preset", "smoke", "--device", "cpu", "--mesh", "2,2", "--steps", "2",
                        "--log-every", "1", "--batch", "4", "--seq", "16"])
    got["cli"] = np.asarray(buf.getvalue())
    return got


# ------------------------------------------------------- reference side
def _reference_main(d: Path, part: int) -> None:
    """The reference's sharded steps on 4 forced host devices, in two
    processes that run at once (``part`` 0: the first and third cases of
    ``REFERENCE``; 1: the others and hierarchical_allreduce)."""
    import warnings

    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    jax.config.update("jax_disable_most_optimizations", True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        import repro.configs as ref_configs
        import repro.train as ref_train
        from repro.collectives import hierarchical_allreduce

    npz = np.load(d / "inputs.npz")
    out = {}
    for name, (shape, arch, kw) in list(REFERENCE.items())[part::2]:
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
    pod = jax.make_mesh((2, 2, 1), ("pod", "data", "model"), axis_types=(AxisType.Auto,) * 3)
    flat = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    for tag, mesh, rows in (("two_step", pod, 4), ("uneven", pod, 3), ("no_pod", flat, 4))[:3 * part]:
        x = jnp.asarray(hier_input(rows).numpy())
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            out[f"hier/{tag}/replicated"] = np.asarray(hierarchical_allreduce(x, mesh))
    np.savez(d / f"reference{part}.npz", **out)


# ------------------------------------------------------------ parent side
def _one_device(npz, name):
    """The port's one-device steps of a case: metrics, params, mu."""
    from repro_torch.models import transformer as T
    from repro_torch.train import AdamWConfig, build_train_step, init_opt_state

    _, arch, kw = CASES[name]
    cfg = port_cfg(arch, kw)
    model = T.params_from_reference(load_tree(npz, f"{name}/params/"))
    opt = init_opt_state(model)
    step_fn = build_train_step(cfg, AdamWConfig(**OPT), batch=B, seq=S, device="cpu",
                               microbatches=MICROBATCHES.get(name, 1)).step_fn
    metrics = []
    for data in batches(npz, name):
        m = step_fn(model, opt, data)
        metrics.append([float(m["loss"]), float(m["grad_norm"]), float(m["lr"])])
    return {"metrics": np.asarray(metrics), "params": T.params_to_reference(model),
            "mu": T.stack_named(opt["mu"])}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the world's results by rank, the reference's, the one-device
    steps by case): the world and the reference run while the test process
    computes the one-device steps."""
    d = tmp_path_factory.mktemp("lm_sharded")
    write_inputs(d)
    base = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env = base | {"GLOO_SOCKET_IFNAME": os.environ.get("GLOO_SOCKET_IFNAME", "lo")}
    ref_env = base | {"JAX_PLATFORMS": "cpu", "XLA_FLAGS": "--xla_force_host_platform_device_count=4 --xla_cpu_multi_thread_eigen=false"}
    refs = ["reference0", "reference1"]
    logs = {r: open(d / f"{r}.log", "w") for r in [*range(WORLD), *refs]}
    procs = {r: subprocess.Popen([sys.executable, __file__, str(d), str(r)], env=env if r not in refs else ref_env,
                                 stdout=logs[r], stderr=subprocess.STDOUT) for r in logs}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the world and the reference need the cores
    try:
        npz = np.load(d / "inputs.npz")
        one = {name: _one_device(npz, name) for name in [*ONE_DEVICE, "olmoe"]}
        deadline = time.monotonic() + TIMEOUT_S
        for p in procs.values():
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    finally:
        torch.set_num_threads(threads)
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs.values():
            f.close()
    failed = {r: (d / f"{r}.log").read_text()[-3000:] for r, p in procs.items() if p.returncode}
    assert not failed, failed
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]
    return ranks, dict(np.load(d / "reference0.npz")) | dict(np.load(d / "reference1.npz")), one


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out |= leaves(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: np.asarray(v)}
    return out


def world_tree(ranks, name, what):
    return leaves(load_tree(ranks[0], f"{name}/{what}/"))


def assert_metrics_and_blocks(ranks, name, want_metrics):
    for out in ranks:  # every process reports the same global metrics
        got = out[f"{name}/metrics"]
        for (l, gn, lr), (wl, wgn, wlr) in zip(got, want_metrics):
            assert rel(l, wl) < 1e-5 and rel(gn, wgn) < 1e-5 and rel(lr, wlr) < 1e-6, (name, got, want_metrics)
        assert float(out[f"{name}/block_err"]) == 0.0


def test_workers_import_neither_jax_nor_the_reference(runs):
    ranks, _, _ = runs
    assert all(out["modules"].size == 0 for out in ranks), [out["modules"] for out in ranks]


@pytest.mark.parametrize("name", ["stablelm", "granite20", "paligemma"])
def test_dense_mqa_and_vlm_match_the_reference_sharded_step(runs, name):
    ranks, ref, _ = runs
    assert_metrics_and_blocks(ranks, name, ref[f"{name}/metrics"])
    want = leaves(load_tree(ref, f"{name}/mu/"))
    got = world_tree(ranks, name, "mu")
    assert got.keys() == want.keys()
    for k in want:
        assert np.max(np.abs(got[k] - want[k])) <= 1e-5 * np.max(np.abs(want[k])), k


def test_moe_matches_the_reference_sharded_step_with_drops(runs):
    ranks, ref, one = runs
    assert_metrics_and_blocks(ranks, "olmoe", ref["olmoe/metrics"])
    want = leaves(load_tree(ref, "olmoe/mu/"))
    got = world_tree(ranks, "olmoe", "mu")
    for k in want:
        assert np.max(np.abs(got[k] - want[k])) <= 1e-5 * np.max(np.abs(want[k])), k
    # each shard's capacity counts its own tokens: picks are dropped, and
    # the one-device step (capacity over all tokens, aux of all tokens) differs
    assert all(int(out["olmoe/dropped"]) > 0 for out in ranks)
    assert rel(one["olmoe"]["metrics"][0][0], ref["olmoe/metrics"][0][0]) > 1e-5


@pytest.mark.parametrize("name", sorted(ONE_DEVICE))
def test_matches_the_one_device_step(runs, name):
    ranks, _, one = runs
    assert_metrics_and_blocks(ranks, name, one[name]["metrics"])
    for what in ("params", "mu"):
        want = leaves(one[name][what])
        got = world_tree(ranks, name, what)
        assert got.keys() == want.keys()
        for k in want:
            assert np.max(np.abs(got[k] - want[k])) <= 1e-5 * np.max(np.abs(want[k])), (what, k)
    calls = json.loads(str(ranks[0][f"{name}/calls"]))
    shape = CASES[name][0]
    if shape[-1] > 1:  # the combines over "model"
        assert calls[0].get("model", 0) > 0
    if shape[-2] > 1:  # the FSDP gathers and their reduce-scatters
        assert calls[0].get("data", 0) > 0
    if len(shape) == 3:  # the 2-step gradient allreduce: over "data" and over "pod"
        assert calls[0].get("pod", 0) > 0


@pytest.mark.parametrize("branch", ["two_step", "uneven", "no_pod"])
def test_hierarchical_allreduce_branches(runs, branch):
    ranks, ref, _ = runs
    rows = 3 if branch == "uneven" else 4
    base = np.arange(rows * 3, dtype=np.float32).reshape(rows, 3)
    # the sum over the axes summed: (pod, data) on the pod mesh, data alone without it
    n_model = 1 if branch != "no_pod" else 2
    for r, out in enumerate(ranks):
        peers = [q for q in range(WORLD) if q % n_model == r % n_model]
        np.testing.assert_allclose(out[f"hier/{branch}/own"], base * sum(q + 1 for q in peers), rtol=1e-6)
        np.testing.assert_allclose(out[f"hier/{branch}/replicated"], ref[f"hier/{branch}/replicated"],
                                   rtol=1e-6)
    if branch == "two_step":
        # per call of the 2-step path: a reduce-scatter and an all-gather over
        # "data", a psum over "pod"; the uneven branch's flat psum over both
        assert json.loads(str(ranks[0]["hier/two_step/calls"])) == {"data": 4, "pod": 2, "pod+data": 2}


def test_tiered_collective_bytes_equals_the_reference(runs):
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        from repro.collectives.hierarchical import tiered_collective_bytes as ref_tiered

    from repro_torch.collectives import tiered_collective_bytes

    ranks, _, _ = runs
    records = [tuple(r) for r in json.loads(str(ranks[0]["pod/records"]))]
    op_name = {"all_gather": "all-gather", "reduce_scatter": "reduce-scatter", "all_reduce": "all-reduce"}
    hlo = "\n".join(
        f"%c.{i} = f32[{nbytes // 4}]{{0}} {op_name[op]}(f32[{nbytes // 4}]{{0}} %p.{i}), "
        f"replica_groups={{{{{','.join(map(str, group))}}}}}, dimensions={{0}}"
        for i, (op, group, nbytes) in enumerate(records))
    pod_size = 2  # ranks per pod on a (2, 2, 1) mesh
    got = tiered_collective_bytes(records, pod_size)
    assert got == ref_tiered(hlo, pod_size)
    assert got["cross_pod"] > 0 and got["intra_pod"] > 0


@pytest.mark.parametrize("mesh_kind", ["one_device", "world_of_one"])
def test_step_count_kept_on_the_host_changes_no_bit(mesh_kind):
    """The optimizer reads its step count from the host copy kept on the
    count (no device read a step): three steps give parameters, moments
    and metrics bit-identical to steps that read the count from the tensor
    each time (the copy dropped before every step); a count restored in
    place (a checkpoint's ``copy_``) is read from the tensor once."""
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import transformer as T
    from repro_torch.train import AdamWConfig, DataConfig, batch_at, build_train_step, init_opt_state
    from repro_torch.train.optimizer import lr_at

    cfg = port_cfg("stablelm_1_6b", {})
    opt_cfg = AdamWConfig(**OPT)
    mesh = make_smoke_mesh(device="cpu") if mesh_kind == "world_of_one" else None
    bundle = build_train_step(cfg, opt_cfg, batch=B, seq=S, device="cpu", mesh=mesh)
    data = [batch_at(DataConfig(vocab=cfg.vocab, batch=B, seq=S), s) for s in range(3)]
    runs = []
    for read_device in (False, True):
        model = T.params_from_reference(carried(cfg, seed=3))
        opt = bundle.init_opt(model) if mesh is not None else init_opt_state(model)
        metrics = []
        for d in data:
            if read_device:  # the parent's behaviour: int(state["step"]) every step
                del opt["step"]._host_count
            m = bundle.step_fn(model, opt, d)
            metrics.append((m["loss"].item(), m["grad_norm"].item(), m["lr"]))
        runs.append((metrics, {n: p.detach().clone() for n, p in model.named_parameters()},
                     {n: t.clone() for n, t in opt["mu"].items()}, {n: t.clone() for n, t in opt["nu"].items()}))
    (m0, p0, mu0, nu0), (m1, p1, mu1, nu1) = runs
    assert m0 == m1 and int(opt["step"]) == 3
    for a, b in ((p0, p1), (mu0, mu1), (nu0, nu1)):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    with torch.no_grad():
        opt["step"].copy_(torch.tensor(7, dtype=torch.int32))  # as restore_checkpoint writes it
    assert bundle.step_fn(model, opt, data[0])["lr"] == lr_at(opt_cfg, 8) and int(opt["step"]) == 8
    assert opt["step"]._host_count == (opt["step"]._version, 8)


@pytest.mark.parametrize("name", ["stablelm", "olmoe", "pod"])
def test_fake_trace_makes_the_worlds_calls(runs, name):
    """The dry-run's trace of the same step as rank 0 of a ``fake`` world
    (``repro_torch.launch.dryrun``: no process, nothing moved) makes the
    calls rank 0 of the gloo world made, axis by axis."""
    from repro_torch.launch.dryrun import _trace_cell, fake_world
    from repro_torch.launch.mesh import LMMesh

    ranks, _, _ = runs
    shape, arch, kw = CASES[name]
    with fake_world(int(np.prod(shape))):
        tr = _trace_cell(port_cfg(arch, kw), LMMesh(shape, mesh_names(shape), device="cpu"), "train", S, B)
    want = json.loads(str(ranks[0][f"{name}/calls"]))[0]
    assert tr.calls == want and len(tr.records) == sum(want.values())


def test_refusals_and_the_cli(runs):
    ranks, _, _ = runs
    for out in ranks:
        for key in [k for k in out if k.startswith("refused/")]:
            assert str(out[key]) == "ok", (key, str(out[key]))
    lines = str(ranks[0]["cli"]).splitlines()
    assert lines[0] == "arch=stablelm-smoke params=0.5M preset=smoke" and lines[-1] == "done"
    steps = [ln.split() for ln in lines if ln.startswith("step ")]
    assert len(steps) == 2 and all(np.isfinite(float(s[3])) and np.isfinite(float(s[5])) for s in steps)
    assert all(str(out["cli"]) == "" for out in ranks[1:])  # only rank 0 prints


if __name__ == "__main__":
    d, who = Path(sys.argv[1]), sys.argv[2]
    sys.path.insert(0, str(ROOT / "src"))
    if who.startswith("reference"):
        _reference_main(d, int(who.removeprefix("reference")))
    else:
        _world_main(d, int(who))
