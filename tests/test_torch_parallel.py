"""The port's parallelism layer (``repro_torch.parallel``, ``launch/mesh.py``,
``runtime/elastic.py``, ZeRO-1's specs and ``launch/steps.py``'s spec
functions) against the reference's, in one process: every spec compared
as a tuple of entries on the same (meta) shapes.  The reference's spec
functions read only a mesh's axis sizes, so a stub mesh stands in for a 2 x
16 pod there; the port's take an ``AbstractMesh``.  The multi-rank paths
are in ``tests/test_torch_sharded_serving.py``."""

import functools
import warnings

import numpy as np
import pytest
import torch

from repro.launch import steps as jax_steps
from repro.optim import adamw as jax_adamw
from repro.parallel import sharding as jax_sharding
from repro.runtime import elastic as jax_elastic
from repro_torch.configs import get_config
from repro_torch.configs.registry import ALL
from repro_torch.launch import steps
from repro_torch.launch.compress_shapes import compressed_param_shapes
from repro_torch.models import build_model
from repro_torch.models.api import serving_cache_pspecs
from repro_torch.optim import state_pspecs, zero_pspec
from repro_torch.parallel import (NONE_PARALLEL, AbstractMesh, P, Parallelism,
                                  make_parallelism, param_pspec, param_pspecs)
from repro_torch.parallel.sharding import _match_linear
from repro_torch.runtime.elastic import MeshPlan, shrink_plan, validate_batch_divisibility

MESHES = {"1x1": ((1, 1), ("data", "model")), "2x2": ((2, 2), ("data", "model")),
          "2x16": ((2, 16), ("data", "model"))}


class _StubMesh:
    """The reference's spec functions read ``mesh.shape[axis]`` only."""

    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))
        self.axis_names = tuple(axes)


def _pars(name):
    shape, axes = MESHES[name]
    return (Parallelism(AbstractMesh(shape, axes)),
            jax_sharding.Parallelism(_StubMesh(shape, axes)))


def _tup(spec):
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e for e in spec)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _same_specs(got, want):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    bad = {k: (g[k], w[k]) for k in g if _tup(g[k]) != _tup(w[k])}
    assert not bad, list(bad.items())[:5]


@functools.lru_cache(maxsize=None)
def _meta_params(arch):
    model = build_model(get_config(arch))
    return model, model.init(device="meta")


@functools.lru_cache(maxsize=None)
def _factored(arch):
    model, params = _meta_params(arch)
    return compressed_param_shapes(model, params, 0.3)


ARCHS = sorted(ALL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("fsdp", [None, ("data",), ("pod", "data")])
def test_param_pspecs_equal_reference_for_every_config(arch, fsdp):
    """Every registered config's param tree and its factored tree (meta
    shapes): the port's rules give the reference's specs leaf for leaf."""
    for tree in (_meta_params(arch)[1], _factored(arch)):
        _same_specs(param_pspecs(tree, fsdp), jax_sharding.param_pspecs(tree, fsdp))


@pytest.mark.parametrize("arch", ["mistral-7b", "deepseek-v3-671b", "rwkv6-1.6b",
                                  "jamba-v0.1-52b", "small-llama"])
@pytest.mark.parametrize("dp_axes", [("data",), ("pod", "data")])
def test_zero_state_pspecs_equal_reference(arch, dp_axes):
    for tree in (_meta_params(arch)[1], _factored(arch)):
        for fsdp in (None, dp_axes):
            ours = state_pspecs(tree, param_pspecs(tree, fsdp), dp_axes)
            ref = jax_adamw.state_pspecs(tree, jax_sharding.param_pspecs(tree, fsdp), dp_axes)
            assert _tup(ours.step) == _tup(ref.step) == ()
            for a, b in ((ours.mu, ref.mu), (ours.nu, ref.nu), (ours.master, ref.master)):
                _same_specs(a, b)


@pytest.mark.parametrize("spec,shape", [
    ((None, "model"), (4096, 14336)), (("model", None), (14336, 4096)), ((), (7,)),
    ((None,), (1,)), (("data", "model"), (256, 512)), ((None, None), (3, 1)),
    ((None, "model", None), (64, 2048, 1408))])
def test_zero_pspec_equals_reference(spec, shape):
    for axes in (("data",), ("pod", "data")):
        assert _tup(zero_pspec(P(*spec), shape, axes)) == _tup(
            jax_adamw.zero_pspec(jax_sharding.P(*spec), shape, axes))


def _cache_shapes(arch, batch, max_len):
    model = build_model(get_config(arch).reduced())
    return model.init_cache(batch, max_len, device="meta")


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ["mistral-7b", "rwkv6-1.6b", "minicpm3-4b",
                                  "jamba-v0.1-52b", "moonshot-v1-16b-a3b"])
@pytest.mark.parametrize("batch,max_len", [(1, 512), (4, 64), (32, 1024)])
def test_cache_pspecs_equal_reference(mesh, arch, batch, max_len):
    ours, ref = _pars(mesh)
    shapes = _cache_shapes(arch, batch, max_len)
    _same_specs(steps.cache_pspecs(shapes, ours), jax_steps.cache_pspecs(shapes, ref))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_and_logits_pspecs_equal_reference(mesh):
    ours, ref = _pars(mesh)
    for b in (1, 2, 4, 6, 32, 64):
        batch = {"tokens": torch.empty((b, 128), device="meta"),
                 "extra": {"frames": torch.empty((b, 16, 8), device="meta")}}
        _same_specs(steps.batch_pspecs(batch, ours), jax_steps.batch_pspecs(batch, ref))
        for vocab in (256, 32000, 32001, 151936):
            assert _tup(steps.logits_pspec(b, vocab, ours)) == _tup(
                jax_steps.logits_pspec(b, vocab, ref))
    meshless = (steps.logits_pspec(4, 64, NONE_PARALLEL),
                jax_steps.logits_pspec(4, 64, jax_sharding.NONE_PARALLEL))
    assert _tup(meshless[0]) == _tup(meshless[1]) == (None, None, None)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ["mistral-7b", "chatglm3-6b", "phi3-medium-14b",
                                  "whisper-small"])
def test_sanitize_pspecs_equal_reference(mesh, arch):
    ours, ref = _pars(mesh)
    for tree in (_meta_params(arch)[1], _factored(arch)):
        got = steps.sanitize_pspecs(param_pspecs(tree), tree, ours.mesh)
        want = jax_steps.sanitize_pspecs(jax_sharding.param_pspecs(tree), tree, ref.mesh)
        _same_specs(got, want)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("fsdp", [False, True])
def test_train_shardings_equal_reference(mesh, fsdp):
    ours, ref = _pars(mesh)
    for arch in ("small-llama", "mistral-7b", "rwkv6-1.6b"):
        params = _meta_params(arch)[1]
        batch = {"tokens": torch.empty((16, 128), device="meta"),
                 "loss_mask": torch.empty((16, 128), device="meta")}
        (p, opt, b), (p2, opt2, metrics) = steps.train_shardings(params, ours, batch, fsdp)
        (rp, ropt, rb), (_, _, rmetrics) = jax_steps.train_shardings(params, ref, batch, fsdp)
        _same_specs(p, rp)
        _same_specs(b, rb)
        for a, w in ((opt.mu, ropt.mu), (opt.nu, ropt.nu), (opt.master, ropt.master)):
            _same_specs(a, w)
        assert p2 is p and opt2 is opt
        assert {k: _tup(v) for k, v in metrics.items()} == {
            k: _tup(v) for k, v in rmetrics.items()}


def test_serving_cache_pspecs_place_heads_on_the_model_axis():
    """The port's serving cache specs: the reference's DP entries (the
    pools' block dim, the slab's batch dim, where they divide) and, by
    design, the attention K/V heads (RWKV-6: the state's heads) over the
    model axis where the reference keeps the cache whole over TP."""
    par, _ = _pars("2x2")
    mistral = build_model(get_config("mistral-7b").reduced())  # 4 / 1 heads
    pools = serving_cache_pspecs(mistral, par, num_blocks=8, block_size=16)
    leaf = pools["g0"]["sub0"]["attn"]
    # (the reduced configs stack their 2 layers: a leading None)
    assert _tup(leaf["k"]) == (None, "data", None, None, None)  # 1 KV head: whole
    llama = build_model(get_config("llama-7b").reduced())  # 4 / 4 heads
    pools = serving_cache_pspecs(llama, par, num_blocks=8, block_size=16, kv_quant=True)
    leaf = pools["g0"]["sub0"]["attn"]
    assert _tup(leaf["k"]) == (None, "data", None, "model", None)
    assert _tup(leaf["k_scale"]) == (None, "data", None, "model")
    slab = serving_cache_pspecs(llama, par, max_batch=3, max_len=64)
    assert _tup(slab["g0"]["sub0"]["attn"]["v"]) == (None, None, None, "model", None)
    rwkv = build_model(get_config("rwkv6-1.6b").reduced())
    slab = serving_cache_pspecs(rwkv, par, max_batch=4, max_len=64)
    assert _tup(slab["g0"]["sub0"]["rwkv"]["state"]) == (None, "data", "model", None, None)
    assert _tup(slab["g0"]["sub0"]["rwkv"]["shift_t"]) == (None, "data", None)
    with pytest.raises(ValueError, match="exactly one"):
        serving_cache_pspecs(llama, par)


# ------------------------------------------------- TestShardingRules' port

def _leaf(*shape):
    return torch.empty(shape, device="meta")


def test_attention_tp():
    leaf = _leaf(512, 2048)
    assert param_pspec(("g0", "sub0", "attn", "wq", "kernel"), leaf) == P(None, "model")
    assert param_pspec(("g0", "sub0", "attn", "wo", "kernel"), leaf) == P("model", None)


def test_factored_input_output_sharding():
    """u shards its input dim, v its output dim, never both replicated."""
    u, v = _leaf(2048, 128), _leaf(128, 512)
    assert param_pspec(("mlp", "wo", "u"), u) == P("model", None)
    assert param_pspec(("mlp", "wo", "v"), v) == P(None, "model")
    assert param_pspec(("mlp", "wi", "u"), u) == P("model", None)
    assert param_pspec(("mlp", "wi", "v"), v) == P(None, "model")
    assert param_pspec(("attn", "wkv_a", "u"), u) == P(None, None)


def test_experts_ep():
    spec = param_pspec(("g1", "sub0", "moe", "experts", "wi", "kernel"), _leaf(64, 2048, 1408))
    assert spec == P("model", None, None)


def test_stacked_prefix_nones():
    spec = param_pspec(("g1", "sub0", "moe", "experts", "wi", "kernel"),
                       _leaf(47, 64, 2048, 1408))
    assert spec == P(None, "model", None, None)


def test_fsdp_adds_dp_axis():
    spec = param_pspec(("mlp", "wi", "kernel"), _leaf(8192, 22016), fsdp_axes=("data",))
    assert spec == P("data", "model")


def test_rwkv_rules():
    assert param_pspec(("rwkv_c", "wk", "kernel"), _leaf(2048, 7168)) == P(None, "model")
    assert param_pspec(("rwkv_c", "wv", "kernel"), _leaf(7168, 2048)) == P("model", None)


def test_linear_roles_of_the_model_paths():
    """The paths the model layers name select the rules the reference's
    param paths do (first match wins)."""
    for path in ("attn/wq", "attn/wk", "attn/wv", "mlp/wi", "mlp/wg", "rwkv_t/wr",
                 "rwkv_t/wk", "rwkv_t/wv", "rwkv_t/wg", "rwkv_c/wk", "unembed"):
        assert _match_linear(path) == (None, "model"), path
    for path in ("attn/wo", "mlp/wo", "rwkv_t/wo", "rwkv_c/wv"):
        assert _match_linear(path) == ("model", None), path
    assert _match_linear("rwkv_c/wr") == (None, None)
    for path in ("attn/wq", "rwkv_c/wk", "rwkv_t/wo", "mlp/wo"):
        assert _match_linear(path) == jax_sharding._match_linear(path)


def test_partition_spec_is_a_tuple_by_value():
    assert P(None, "model") == P(None, "model") == (None, "model")
    assert P() != P(None) and hash(P("data")) == hash(("data",))
    assert repr(P("data")) == "P('data')" and repr(P(None, "model")) == "P(None, 'model')"


def test_make_parallelism_and_meshless():
    assert make_parallelism(None) is NONE_PARALLEL and not NONE_PARALLEL.active
    assert NONE_PARALLEL.dp_size == NONE_PARALLEL.tp_size == 1
    pod = make_parallelism(AbstractMesh((2, 16, 16), ("pod", "data", "model")))
    assert pod.dp_axes == ("pod", "data") and pod.dp == ("pod", "data")
    assert pod.dp_size == 32 and pod.tp_size == 16 and pod.size == 512
    one = make_parallelism(AbstractMesh((2, 4), ("data", "model")))
    assert one.dp == "data" and one.size == 8
    x = torch.ones(3)
    assert one.constrain(x, "data") is x


# ------------------------------------------------------ TestElastic's port

def test_shrink_keeps_tp():
    plan = MeshPlan((2, 16, 16), ("pod", "data", "model"))
    new = shrink_plan(plan, 256)
    assert new is not None
    assert new.shape[new.axes.index("model")] == 16
    assert new.size <= 256


def test_shrink_impossible():
    assert shrink_plan(MeshPlan((16, 16), ("data", "model")), 8) is None


def test_batch_divisibility():
    plan = MeshPlan((8, 16), ("data", "model"))
    assert validate_batch_divisibility(256, plan, ("data",))
    assert not validate_batch_divisibility(100, plan, ("data",))


PLANS = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
         ((4, 2), ("data", "model")), ((3, 5, 2), ("pod", "data", "model")),
         ((8, 1), ("data", "model")), ((1, 4), ("data", "model"))]


@pytest.mark.parametrize("shape,axes", PLANS)
def test_shrink_plan_and_divisibility_equal_reference(shape, axes):
    ours, ref = MeshPlan(shape, axes), jax_elastic.MeshPlan(shape, axes)
    assert ours.size == ref.size
    for avail in range(0, ours.size + 3):
        got, want = shrink_plan(ours, avail), jax_elastic.shrink_plan(ref, avail)
        assert (got is None) == (want is None), avail
        if got is not None:
            assert (got.shape, got.axes) == (want.shape, want.axes), avail
    for batch in (1, 2, 6, 16, 100, 256, 512):
        for dp_axes in (("data",), ("pod", "data")):
            assert validate_batch_divisibility(batch, ours, dp_axes) == \
                jax_elastic.validate_batch_divisibility(batch, ref, dp_axes)


# ------------------------------------------------------------ mesh factory

def test_make_serving_mesh_rejects_nonpositive_axes():
    from repro_torch.launch.mesh import make_serving_mesh

    with pytest.raises(ValueError, match="positive"):
        make_serving_mesh(0, 2, device="cpu")
    with pytest.raises(ValueError, match="positive"):
        make_serving_mesh(2, -1, device="cpu")


def test_make_serving_mesh_warns_and_falls_back_to_11():
    """Without a launcher the world is one process: dp x tp = 2 x 2 warns
    and gives a (1, 1) mesh (a one-rank gloo group through a FileStore),
    as the reference falls back on a one-device host; the production mesh
    refuses the world."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_production_mesh, make_serving_mesh

    assert not dist.is_initialized()
    try:
        with pytest.warns(UserWarning, match="falling back"):
            mesh = make_serving_mesh(2, 2, device="cpu")
        assert dict(zip(mesh.mesh_dim_names, mesh.shape)) == {"data": 1, "model": 1}
        par = make_parallelism(mesh)
        assert (par.dp_size, par.tp_size, par.dp_rank, par.tp_rank) == (1, 1, 0, 0)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            again = make_serving_mesh(1, 1, device="cpu")
        assert tuple(again.shape) == (1, 1)
        with pytest.raises(ValueError, match="256"):
            make_production_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def test_mesh_constants_are_the_cards():
    from repro_torch.launch import mesh

    assert mesh.DEVICE == "H100 80GB HBM3, 700 W"
    assert (mesh.PEAK_FLOPS_BF16, mesh.HBM_BW, mesh.NVLINK_BW) == (989e12, 3.35e12, 900e9)
    assert mesh.CHIP_HBM_BYTES == 80 * 1024 ** 3
    assert np.isclose(mesh.PEAK_FLOPS_BF16 / mesh.HBM_BW, 295.2, atol=0.1)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("max_batch", [3, 8])
def test_serving_shardings_bundle(mesh, max_batch):
    """What each rank holds: slots over DP when they divide it (the
    reference's ``_dp_entry``), and the params' sanitized rules."""
    ours, ref = _pars(mesh)
    params = _factored("small-llama")
    sh = steps.ServingShardings(ours, params, None, max_batch)
    dp = "data" if max_batch % ours.dp_size == 0 else None
    assert _tup(sh.row.spec) == (dp,) and _tup(sh.mat.spec) == (dp, None)
    assert _tup(sh.mat3.spec) == (dp, None, None) and _tup(sh.rep.spec) == ()
    assert jax_steps._dp_entry(ref, max_batch) == dp
    want = jax_steps.sanitize_pspecs(jax_sharding.param_pspecs(params), params, ref.mesh)
    _same_specs({k: v.spec for k, v in _flat(sh.params).items()}, _flat(want))
    named = steps.named({"a": P(None, "model"), "b": {"c": P()}}, ours.mesh)
    assert named["a"].spec == P(None, "model") and named["b"]["c"].mesh is ours.mesh
