"""Port parity: the LM half's sharding rules (repro_torch vs repro), exactly.

The 2-D FSDP("data") x TP("model") layout is a set of pure host functions
of a config and a mesh's axis names and sizes, so it is held to the
reference without devices: ``MeshAxes`` is built directly for the meshes
(1, 1), (2, 2), (4, 2), (1, 16), the production (16, 16) and the
multi-pod (2, 16, 16).  For each of the ten configs and its smoke
version, on each mesh, every leaf of the port's

* ``param_specs`` (the family's module through ``ModelApi``),
* ``cache_specs`` over a grid of batch x sequence sizes,
* ``zero1_specs`` and ``opt_state_specs`` (on the family's stacked shapes)

equals the reference's, entry for entry (the reference's ``PartitionSpec``
against the port's ``P`` as tuples).  Also: phi3-medium-14b's replicated
Q/K/V at 16 ("model" divides neither its 40 heads nor its 10 K/V heads)
and its
``emb = P('model', 'data')``; ``MeshAxes``' rules; ``P``'s normalisation;
``local_shape``; the per-name specs, shapes and blocks; ``constrain``'s
checks.

The reference's LM modules import ``jax.experimental.shard_map``, whose
``DeprecationWarning`` this suite's filters make an error, so they are
imported with the warning ignored, as ``tests/test_torch_lm.py`` does.
"""

import warnings

import pytest
import torch
from jax.sharding import PartitionSpec

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    from jax.experimental.shard_map import shard_map as _  # noqa: F401

import repro.configs as ref_configs
from repro.models.common import MeshAxes as RefMeshAxes

import repro_torch.configs as configs
from repro_torch.models import encdec as E
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.models.common import (
    P,
    MeshAxes,
    block_of,
    constrain,
    local_shape,
    local_shapes,
    named_shapes,
    named_specs,
)
from repro_torch.models.registry import model_api
from repro_torch.train.optimizer import opt_state_specs, zero1_specs

MESHES = {
    "1x1": {"data": 1, "model": 1},
    "2x2": {"data": 2, "model": 2},
    "4x2": {"data": 4, "model": 2},
    "1x16": {"data": 1, "model": 16},
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
}
CONFIGS = [(arch, kind) for arch in configs.ARCH_IDS for kind in ("full", "smoke")]
BATCHES = (1, 2, 8, 16, 32, 128)
SEQS = (16, 4096, 32768, 524288)
SHAPES = {"dense": T, "moe": T, "vlm": T, "ssm": S, "hybrid": S, "encdec": E}

ref_registry = None


@pytest.fixture(scope="module", autouse=True)
def _reference_lm():
    """Import the reference's LM registry with the deprecation ignored."""
    global ref_registry
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        import repro.models.registry as ref_registry


def axes_pair(sizes):
    batch = tuple(a for a in ("pod", "data") if a in sizes)
    kw = dict(batch=batch, fsdp="data", model="model", sizes=dict(sizes))
    return RefMeshAxes(**kw), MeshAxes(**kw)


def cfg_pair(arch, kind):
    get = "get_config" if kind == "full" else "get_smoke"
    return getattr(ref_configs, get)(arch), getattr(configs, get)(arch)


def flat(tree, prefix=()):
    """{path: entries} of a nested dict whose leaves are specs."""
    if isinstance(tree, (PartitionSpec, P)):
        return {prefix: tuple(tree)}
    out = {}
    for k, v in tree.items():
        out |= flat(v, prefix + (k,))
    return out


def assert_same(got, want):
    g, w = flat(got), flat(want)
    assert g.keys() == w.keys()
    for path in w:
        assert g[path] == w[path], (path, g[path], w[path])


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch,kind", CONFIGS)
def test_specs_equal_the_reference(arch, kind, mesh):
    rcfg, cfg = cfg_pair(arch, kind)
    raxes, axes = axes_pair(MESHES[mesh])
    rapi, api = ref_registry.model_api(rcfg), model_api(cfg)
    rspecs, specs = rapi.param_specs(rcfg, raxes), api.param_specs(cfg, axes)
    assert_same(specs, rspecs)
    for b in BATCHES:
        for s in SEQS:
            assert_same(api.cache_specs(cfg, axes, b, s), rapi.cache_specs(rcfg, raxes, b, s))
    rshapes = rapi.abstract_params(rcfg)
    shapes = SHAPES[cfg.family].param_shapes(cfg)
    assert_same(zero1_specs(specs, axes, shapes), ref_zero1(rspecs, raxes, rshapes))
    ropt = ref_opt_state(rspecs, raxes, rshapes)
    opt = opt_state_specs(specs, axes, shapes)
    assert opt.keys() == ropt.keys()
    for k in opt:
        assert_same(opt[k], ropt[k])


def ref_zero1(*a):
    from repro.train.optimizer import zero1_specs as f

    return f(*a)


def ref_opt_state(*a):
    from repro.train.optimizer import opt_state_specs as f

    return f(*a)


def test_phi3_medium_replicates_kv_at_16():
    cfg = configs.get_config("phi3_medium_14b")
    _, axes = axes_pair(MESHES["16x16"])
    specs = T.param_specs(cfg, axes)
    assert cfg.n_kv_heads == 10 and cfg.vocab_padded == 100352
    assert tuple(specs["layers"]["wk"]) == (None, "data", None, None)
    assert tuple(specs["layers"]["wq"]) == (None, "data", None, None)  # 40 heads neither
    assert tuple(specs["emb"]) == ("model", "data")
    # K/V heads do not divide "model": the cache shards its sequence instead
    assert tuple(T.cache_specs(cfg, axes, 8, 4096)["k"]) == (None, None, "model", None, None)
    assert tuple(T.cache_specs(cfg, axes, 16, 4096)["k"]) == (None, "data", "model", None, None)


def test_mesh_axes_rules_and_p():
    _, axes = axes_pair(MESHES["2x16x16"])
    assert axes.batch == ("pod", "data") and axes.size("pod") == 2 and axes.size(None) == 1
    assert axes.tp(48) == "model" and axes.tp(10) is None and axes.fs(4096) == "data"
    assert tuple(P(None, ("data",), ("pod", "data"))) == (None, "data", ("pod", "data"))
    assert P(None, ("pod", "data"), "model").mesh_axes() == ("pod", "data", "model")
    assert local_shape((64, 48, 5), P(("pod", "data"), "model"), axes.sizes) == (2, 3, 5)
    with pytest.raises(ValueError, match="does not divide"):
        local_shape((10, 4), P("model"), axes.sizes)


def test_named_specs_and_blocks():
    class Mesh:  # the process at ("data", "model") = (1, 0) of a (2, 2) mesh
        axis_names = ("data", "model")
        shape = {"data": 2, "model": 2}

        @staticmethod
        def axis_size(axes):
            return 2 ** len(axes)

        @staticmethod
        def axis_index(axes):
            return {("data",): 1, ("model",): 0}[tuple(axes)]

    cfg = configs.get_smoke("stablelm_1_6b")
    _, axes = axes_pair(MESHES["2x2"])
    specs = T.param_specs(cfg, axes)
    spec_of, shape_of = named_specs(specs), named_shapes(T.param_shapes(cfg))
    # a layer's weight takes its stacked spec and shape without the layer entry
    assert spec_of("layers.1.wq") == P(*specs["layers"]["wq"][1:]) and spec_of("emb") == specs["emb"]
    assert shape_of("layers.1.wq") == tuple(T.param_shapes(cfg)["layers"]["wq"][1:])
    local = local_shapes(T.param_shapes(cfg), specs, Mesh)
    assert local["layers"]["wq"][0] == cfg.n_layers
    emb = torch.arange(cfg.vocab_padded * cfg.d_model).view(cfg.vocab_padded, cfg.d_model)
    blk = block_of(emb, spec_of("emb"), Mesh)  # emb: vocab over "model", d_model over "data"
    assert tuple(blk.shape) == local["emb"]
    assert torch.equal(blk, emb[: cfg.vocab_padded // 2, cfg.d_model // 2:])


def test_constrain_checks_the_block():
    class Mesh:
        axis_names = ("data", "model")
        shape = {"data": 2, "model": 4}

    x = torch.zeros(3, 8, 5)
    assert constrain(x, Mesh, None, "model", None, full=(3, 32, 5)) is x
    with pytest.raises(ValueError, match="is not the"):
        constrain(x, Mesh, "data", "model", None, full=(4, 32, 5))
    with pytest.raises(ValueError, match="does not fit"):
        constrain(x, Mesh, "pod", None)
