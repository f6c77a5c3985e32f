"""Port parity for deepseek-v3-671b: Multi-head Latent Attention over a
top-8 token-choice MoE, its (mla, moe) layers after three dense (mla, mlp)
ones.  The reduced config (the reference's ``reduced()``: 3 dense and 2 MoE
layers, 8 experts top-2 at capacity factor 8.0, the tiny MLA) against the
JAX package on the same numpy-seeded inputs: config fields, layer specs,
groups, targets and Gram keys (and every other config's targets, now that
they are composed a mixer's then an ffn's), the train logits, per-expert
Grams from the port's calibration, nsvd1 logits at 0.2 with the experts
pinned to the reference's choices (``RoutingTrace``), slab prefill then
decode, greedy streams against the reference engine with exact-length
admission; the paged and int8 refusals; the full-width factored shapes
(61 layers, 256 experts) against ``jax.eval_shape``; the full-width working
sizes of the absorbed decode and the naive prefill on meta tensors;
chip_smoke's dsv3_serve counts on a reduced twin; and the card cut's
resident bytes.  fp32 on both sides."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import t2np, to_np, to_t

from repro.calib.runner import collect_grams as jax_collect_grams
from repro.configs import get_config as jax_get_config
from repro.configs import paper_models as jax_paper
from repro.core import CompressionConfig as JaxCompressionConfig
from repro.core import GramStore as JaxGramStore
from repro.core import build_plan as jax_build_plan
from repro.core import compress_params as jax_compress_params
from repro.launch.compress_shapes import compressed_param_shapes as jax_compressed_param_shapes
from repro.models import build_model as jax_build_model
from repro.models import moe as jax_moe
from repro.serving.engine import ServingEngine as JaxEngine
from repro.serving.scheduler import SchedulerConfig
from repro_torch.calib.runner import collect_grams
from repro_torch.configs import ALL, DEEPSEEK_V3_671B, SMALL, get_config
from repro_torch.core import CompressionConfig, GramStore, build_plan, compress_params
from repro_torch.launch.compress_shapes import (calibration_bytes, compressed_param_shapes,
                                                tree_bytes)
from repro_torch.models import build_model, cache_layout, lowrank_utils, mla, moe
from repro_torch.models import prefill_pad_safe
from repro_torch.models.blocks import group_layers, resolve_specs
from repro_torch.serving.engine import ServingEngine

# fp32 on both sides; the two frameworks sum in other orders, so logits of
# O(1) agree to ~1e-6 relative (tests/test_torch_model.py).
TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "deepseek-v3-671b"
# chip_smoke's dsv3_serve cut keeps its weights, fp64 Grams and a batched
# tap's fp32 Gram with its experts' fp64 sum (38.47 GiB) under this, so the compression's own fp64
# work (~17 GiB above weights and Grams, measured on the H100) has room
# under 72 GiB.
RESIDENT_BUDGET_GIB = 40


def _card_cut():
    """chip_smoke's dsv3_serve cut: 4 of 61 layers, 16 of 256 experts."""
    return dataclasses.replace(DEEPSEEK_V3_671B, num_layers=4, moe=dataclasses.replace(
        DEEPSEEK_V3_671B.moe, num_experts=16))


@functools.lru_cache(maxsize=None)
def _setup(seed=0, spread=False):
    """(reference model, params, port model, params) of the reduced
    deepseek-v3; ``spread`` scales the unembed by 8 so greedy choices are
    not near-ties (the engine tests)."""
    jmodel = jax_build_model(jax_get_config(ARCH).reduced())
    tmodel = build_model(get_config(ARCH).reduced())
    jparams = jmodel.init(jax.random.key(seed))
    if spread:
        jparams["unembed"]["kernel"] = jparams["unembed"]["kernel"] * 8.0
    return jmodel, jparams, tmodel, to_t(jparams)


def _batches(n=2, shape=(4, 16), seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, shape).astype(np.int32) for _ in range(n)]


@functools.lru_cache(maxsize=None)
def _calibrated():
    jmodel, jparams, tmodel, tparams = _setup()
    batches = _batches()
    jgrams = jax_collect_grams(jmodel, jparams, [{"tokens": jnp.asarray(b)} for b in batches])
    return jgrams, collect_grams(tmodel, tparams, batches)


# ------------------------------------------------------------------ config

@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_reference(reduced):
    """Every field the port keeps, field for field, full and reduced; the
    reduced topology is the reference's: 5 layers (3 dense, 2 MoE), 8
    experts top-2 at capacity factor 8.0, the tiny MLA."""
    j, t = jax_get_config(ARCH), get_config(ARCH)
    if reduced:
        j, t = j.reduced(), t.reduced()
    tj = dataclasses.asdict(t)
    assert {k: v for k, v in dataclasses.asdict(j).items() if k in tj} == tj
    assert t.layer_specs() == j.layer_specs()
    if reduced:
        assert (t.num_layers, t.moe.first_k_dense, t.moe.num_experts, t.moe.top_k,
                t.moe.capacity_factor) == (5, 3, 8, 2, 8.0)
        assert (t.mla.q_lora_rank, t.mla.kv_lora_rank) == (16, 8)
    else:
        assert (t.d_model, t.num_heads, t.d_ff, t.vocab_size, t.moe.num_experts,
                t.moe.top_k, t.moe.d_ff_expert) == (7168, 128, 18432, 129280, 256, 8, 2048)
    assert get_config(ARCH) is DEEPSEEK_V3_671B and ARCH in ALL


@pytest.mark.parametrize("cut,want", [
    ("reduced", [((("mla", "mlp"),), 3), ((("mla", "moe"),), 2)]),
    ("card", [((("mla", "mlp"),) * 3 + (("mla", "moe"),), 1)]),
    ("full", [((("mla", "mlp"),), 3), ((("mla", "moe"),), 58)]),
])
def test_specs_and_groups_match_reference(cut, want):
    """``resolve_specs`` maps ("attn", mlp|moe) to ("mla", mlp|moe) as the
    reference's; the stacking is (mla, mlp) x 3 then (mla, moe) x n (the
    4-layer card cut, with one MoE layer, is one unstacked period of 4)."""
    cfgs = {"reduced": (jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()),
            "card": (None, _card_cut()),
            "full": (jax_get_config(ARCH), get_config(ARCH))}
    jcfg, tcfg = cfgs[cut]
    specs = resolve_specs(tcfg)
    groups = group_layers(specs)
    assert [(g.period, g.repeats) for g in groups] == want
    if jcfg is not None:
        jmodel = jax_build_model(jcfg)
        assert specs == tuple(jmodel.specs)
        assert [(g.period, g.repeats, g.first_layer) for g in groups] == [
            (tuple(g.period), g.repeats, g.first_layer) for g in jmodel.groups]


SMALL_FAMILY = {"small-llama": "llama-7b", "small-llama-13b": "llama-7b",
                "small-opt": "opt-6.7b", "small-mistral": "mistral-7b"}


def _target_keys(model):
    return [(t.path, t.in_dim, t.out_dim, t.gram_key, tuple(t.stacked))
            for t in model.compressible_targets()]


@pytest.mark.parametrize("arch", sorted(ALL))
def test_targets_match_reference_for_every_config(arch):
    """Targets composed as a mixer's list then an ffn's give the
    reference's paths, dims, stacking and Gram keys for every config the
    port has, full and reduced (the (mla, moe) pair of deepseek-v3 among
    them, the per-kind table's configs unchanged)."""
    tcfg = get_config(arch)
    if arch in SMALL_FAMILY:  # the reference keeps its small configs in its benchmarks
        jcfg = jax_paper.small_lm(arch, jax_get_config(SMALL_FAMILY[arch]), tcfg.num_layers,
                                  tcfg.d_model, tcfg.d_ff, tcfg.vocab_size, tcfg.num_heads)
        tj = dataclasses.asdict(tcfg)
        assert {k: v for k, v in dataclasses.asdict(jcfg).items() if k in tj} == tj
    else:
        jcfg = jax_get_config(arch)
    for j, t in ((jcfg, tcfg), (jcfg.reduced(), tcfg.reduced())):
        assert _target_keys(build_model(t)) == _target_keys(jax_build_model(j))


def test_targets_and_gram_keys_of_the_moe_layer():
    """An (mla, moe) layer's targets: the five MLA ones, then the experts'
    (stacked over layers and experts) and the shared expert's; every Gram
    key a target reads is one the calibration collects."""
    _, _, tmodel, _ = _setup()
    moe_layer = [t for t in tmodel.compressible_targets() if t.path[:2] == ("g1", "sub0")]
    assert [t.path[2:] for t in moe_layer] == [
        ("attn", "wq_a"), ("attn", "wq_b"), ("attn", "wkv_a"), ("attn", "wkv_b"),
        ("attn", "wo"), ("moe", "experts", "wi"), ("moe", "experts", "wg"),
        ("moe", "experts", "wo"), ("moe", "shared", "wi"), ("moe", "shared", "wg"),
        ("moe", "shared", "wo")]
    assert [tuple(t.stacked) for t in moe_layer] == [(2,)] * 5 + [(2, 8)] * 3 + [(2,)] * 3
    keys = set(_calibrated()[1].keys())
    assert {t.gram_key for t in tmodel.compressible_targets()} <= keys


# ------------------------------------------------------------------ model

def test_block_taps_compose_mla_and_moe():
    """One (mla, moe) layer taps ``…attn.*`` (MLA's four) beside ``…moe.*``
    (router_in, the capacity buffers, the shared expert's), as the
    reference's block, with the same values."""
    jmodel, jparams, tmodel, tparams = _setup()
    tokens = _batches(1, (2, 9), seed=11)[0]
    jtaps, ttaps = {}, {}
    jmodel.apply(jparams, jnp.asarray(tokens), mode="train", taps=jtaps)
    tmodel.apply(tparams, torch.as_tensor(tokens), mode="train", taps=ttaps)
    layer = "g1/rep1/sub0."
    got = sorted(k[len(layer):] for k in ttaps if k.startswith(layer))
    assert got == sorted(k[len(layer):] for k in jtaps if k.startswith(layer)) == sorted([
        "attn.in", "attn.q_lora_in", "attn.kv_lora_in", "attn.out_in", "moe.router_in",
        "moe.expert_buf", "moe.expert_mid", "moe.shared_in", "moe.shared_mid"])
    for k in (layer + "attn.out_in", layer + "moe.expert_mid"):
        np.testing.assert_allclose(t2np(ttaps[k]), np.asarray(jtaps[k]), **TOL, err_msg=k)


def test_train_logits_match():
    jmodel, jparams, tmodel, tparams = _setup()
    tokens = np.random.default_rng(1).integers(0, 256, (2, 21))
    want, _, _ = jmodel.apply(jparams, jnp.asarray(tokens, jnp.int32), mode="train")
    got = tmodel.apply(tparams, torch.as_tensor(tokens), mode="train")
    np.testing.assert_allclose(t2np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("n", [8, 173, 1536, 8192])
def test_capacity_at_top8(n):
    """``capacity_of`` at the card cut's top-8 of 16 experts and at 256,
    against the reference's formula inside ``moe_apply``: ceil(n k int(4
    cf) / 4E), at least 8."""
    for e in (16, 256):
        cfg = dataclasses.replace(_card_cut(), moe=dataclasses.replace(
            _card_cut().moe, num_experts=e))
        want = max(8, -(-n * 8 * int(4 * 1.25) // (4 * e)))
        assert moe.capacity_of(n, cfg) == want
    assert moe.capacity_of(2048, _card_cut()) == 1280  # a calibration batch


def test_port_calibration_gives_reference_grams():
    """The port's calibration collects the reference's keys (per layer and
    shared over each stack; per expert "{base}/{layer}/{e}" and their sum),
    each Gram, absmean and count within fp32 sum order."""
    jgrams, tgrams = _calibrated()
    assert set(tgrams.keys()) == set(jgrams.keys())
    expert = [k for k in jgrams.keys() if "expert_buf/" in k]
    assert len(expert) == 2 * 8 and "g1/sub0.moe.expert_buf/1/7" in expert
    assert "g0/sub0.attn.kv_lora_in/2" in tgrams.keys()
    for k in jgrams.keys():
        want = np.asarray(jgrams.gram(k))
        np.testing.assert_allclose(t2np(tgrams.gram(k)), want, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(want).max(), 1e-30), err_msg=k)
        np.testing.assert_allclose(t2np(tgrams.absmean(k)), np.asarray(jgrams.absmean(k)),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
        assert tgrams.count(k) == jgrams.count(k), k
    # Lossless capacity: a layer's expert counts sum to its routed slots (2
    # batches of 4 x 16 tokens, top-2).
    counts = [tgrams.count(f"g1/sub0.moe.expert_buf/0/{e}") for e in range(8)]
    assert sum(counts) == 2 * 4 * 16 * 2


def _reference_choices(jmodel, jparams, tokens):
    """The reference's top-k experts of every MoE layer on ``tokens``, in
    call order (from its router_in taps)."""
    taps = {}
    jmodel.apply(jparams, jnp.asarray(tokens, jnp.int32), mode="train", taps=taps)
    k = jmodel.cfg.moe.top_k
    out = []
    for r in range(2):
        lp = jax.tree.map(lambda a: a[r], jparams["g1"]["sub0"]["moe"])
        probs = jax_moe.router_probs(lp, taps[f"g1/rep{r}/sub0.moe.router_in"])
        out.append(torch.as_tensor(np.array(jax.lax.top_k(probs, k)[1])).long())
    return out


@pytest.mark.parametrize("grams_from", ["reference", "port"])
def test_compressed_logits_match_with_routing_pinned(grams_from, tmp_path):
    """nsvd1 at ratio 0.2 (min_dim 8; per-expert Grams with the shared
    fallback): the reference's compressed forward against the port's, on
    the port's compression from the reference's GramStore file or from its
    own calibration, the port's experts pinned to the reference's choices
    by a ``RoutingTrace`` (its flips count the tokens whose own choice
    differed).  Factors differ by SVD signs only: fp32 sum order."""
    jmodel, jparams, tmodel, tparams = _setup()
    jgrams, tgrams = _calibrated()
    path = str(tmp_path / "grams.npz")
    jgrams.save(path)
    kw = dict(method="nsvd1", ratio=0.2, dtype="float32", use_randomized=False, min_dim=8)
    jplan = jax_build_plan(jmodel.compressible_targets(), JaxCompressionConfig(**kw))
    tplan = build_plan(tmodel.compressible_targets(), CompressionConfig(**kw))
    assert tplan.summary() == jplan.summary()
    jc = jax_compress_params(jparams, jplan, JaxGramStore.load(path))
    tc = compress_params(tparams, tplan, GramStore.load(path, device="cpu")
                         if grams_from == "reference" else tgrams)
    experts = tc["g1"]["sub0"]["moe"]["experts"]["wi"]
    assert set(experts) == {"u", "v", "u2", "v2"} and experts["u"].shape[:2] == (2, 8)
    assert set(tc["g0"]["sub0"]["attn"]["wkv_b"]) >= {"u", "v"}
    tokens = np.random.default_rng(2).integers(0, 256, (2, 19))
    want, _, _ = jmodel.apply(jc, jnp.asarray(tokens, jnp.int32), mode="train")
    trace = moe.RoutingTrace()
    trace.choices = _reference_choices(jmodel, jc, tokens)
    with trace.replay():
        got = tmodel.apply(tc, torch.as_tensor(tokens), mode="train")
    assert trace.flips <= 2  # rounding-level near-ties at most
    np.testing.assert_allclose(t2np(got), np.asarray(want), **TOL)


def _cache_leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _cache_leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def test_slab_prefill_then_decode_match_reference():
    """The whole model on the latent slab: prefill two prompts into a fresh
    slab, then three absorbed decode steps; logits and every slab leaf
    (c_kv and k_rope of the dense and the MoE stacks)."""
    jmodel, jparams, tmodel, tparams = _setup()
    rng = np.random.default_rng(12)
    prompt = rng.integers(0, 256, (2, 13))
    jcache, tcache = jmodel.init_cache(2, 24), tmodel.init_cache(2, 24, device="cpu")
    jl, jcache, _ = jmodel.apply(jparams, jnp.asarray(prompt, jnp.int32), mode="prefill",
                                 cache=jcache)
    tl = tmodel.apply(tparams, torch.as_tensor(prompt), mode="prefill", cache=tcache)
    np.testing.assert_allclose(t2np(tl), np.asarray(jl), **TOL)
    clen = np.full(2, 13, np.int32)
    for _ in range(3):
        step = rng.integers(0, 256, (2, 1))
        jd, jcache, _ = jmodel.apply(jparams, jnp.asarray(step, jnp.int32), mode="decode",
                                     cache=jcache, cache_len=jnp.asarray(clen))
        td = tmodel.apply(tparams, torch.as_tensor(step), mode="decode", cache=tcache,
                          cache_len=torch.as_tensor(clen))
        np.testing.assert_allclose(t2np(td), np.asarray(jd), **TOL)
        clen = clen + 1
    want, got = dict(_cache_leaves(to_np(jcache))), dict(_cache_leaves(tcache))
    assert want.keys() == got.keys() and {n.rsplit("/", 1)[1] for n in got} == {
        "c_kv", "k_rope"}
    for name, w in want.items():
        np.testing.assert_allclose(t2np(got[name]), w, **TOL, err_msg=name)


# ---------------------------------------------------------------- serving

def test_layout_is_the_exact_length_latent_slab():
    """(mla, moe) is pad-sensitive (its MoE layers), so the latent slab is
    admitted one request a call at its exact length; MLA's latents have
    no paged form."""
    _, _, tmodel, tparams = _setup()
    assert cache_layout(tmodel) == "dense" and not prefill_pad_safe(tmodel)
    eng = ServingEngine(tmodel, tparams, max_batch=2, max_len=32)
    assert eng.layout == "dense" and eng.kv is None and not eng._bucketed
    with pytest.raises(ValueError, match="paged"):
        tmodel.init_paged_cache(8, 4, device="cpu")


@pytest.mark.parametrize("kw,match", [({"paged": True}, "cache layout"),
                                      ({"kv_quant": True}, "kv_quant")])
def test_engine_refuses_pages_and_int8(kw, match):
    _, _, tmodel, tparams = _setup()
    with pytest.raises(ValueError, match=match):
        ServingEngine(tmodel, tparams, max_batch=2, max_len=32, **kw)


def test_greedy_streams_match_reference_engine():
    """Dense latent slab, exact-length admission: the port's greedy streams
    equal the reference engine's (worst case, depth 1); one admission call
    a request at its prompt's length, in both; every request finishes; one
    host sync a step and one an admission."""
    jmodel, jparams, tmodel, tparams = _setup(seed=1, spread=True)
    rng = np.random.default_rng(0)
    lens = (5, 11, 7, 11)
    prompts = [rng.integers(2, 200, size=n) for n in lens]
    kw = dict(max_batch=2, max_len=32)
    ref = JaxEngine(jmodel, jparams, pipeline_depth=1,
                    sched_config=SchedulerConfig(admission="worst_case"), **kw)
    widths = []
    ref_prefill = ref._prefill

    def ref_recorded(params, cache, tokens, *rest):
        widths.append(int(tokens.shape[1]))
        return ref_prefill(params, cache, tokens, *rest)
    ref._prefill = ref_recorded
    eng = ServingEngine(tmodel, tparams, pipeline_depth=1, **kw)
    calls = []
    prefill = eng._prefill

    def recorded(params, cache, tokens, *rest):
        calls.append(tuple(tokens.shape))
        return prefill(params, cache, tokens, *rest)
    eng._prefill = recorded
    ref_ids = [ref.submit(p, max_new_tokens=6) for p in prompts]
    ids = [eng.submit(p, max_new_tokens=6) for p in prompts]
    want, got = ref.run(), eng.run()
    assert [got[i] for i in ids] == [want[i] for i in ref_ids]
    assert widths == list(lens) and calls == [(1, n) for n in lens]
    assert eng.admissions_by_width == {5: 1, 11: 2, 7: 1}
    assert all(r.finish_reason == "stop" for r in eng.finished_requests.values())
    st = eng.stats()
    assert st["steps"] == ref.stats()["steps"]
    assert st["prefill_ticks"] == len(lens) and st["host_syncs"] == st["steps"] + len(lens)


# ------------------------------------------------------- full-width sizes

def _shape_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _shape_leaves(tree[key], prefix + (key,))
    else:
        yield prefix, (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))


def test_full_width_compressed_shapes_match_reference():
    """deepseek-v3-671b at full width, all 61 layers and 256 experts, no
    memory (the reference's abstract init against meta tensors): every
    target's factors at nsvd1 0.2 as the reference's shape-level
    compression gives them (the experts at rank 1152 = 1094 + 58: shape-level
    compression rounds ranks to multiples of 128; the served plan does not)."""
    jmodel = jax_build_model(jax_get_config(ARCH))
    jshapes = jax.eval_shape(jmodel.init, jax.random.key(0))
    want = jax_compressed_param_shapes(jmodel, jshapes, 0.2, method="nsvd1")
    tmodel = build_model(get_config(ARCH))
    meta = jax.tree.map(lambda x: torch.empty(x.shape, device="meta",
                                              dtype=getattr(torch, str(x.dtype))), jshapes)
    got = compressed_param_shapes(tmodel, meta, 0.2, method="nsvd1")
    assert dict(_shape_leaves(got)) == dict(_shape_leaves(want))
    wi = got["g1"]["sub0"]["moe"]["experts"]["wi"]
    assert wi["u"].is_meta and tuple(wi["u"].shape) == (58, 256, 7168, 1094)
    assert tuple(wi["v2"].shape) == (58, 256, 58, 2048)
    # And the port's own meta init gives the reference's dense tree.
    assert dict(_shape_leaves(tmodel.init(device="meta"))) == dict(_shape_leaves(meta))


def test_full_width_mla_and_moe_working_sizes_on_meta():
    """One full-width (mla, moe) layer on meta tensors (128 heads, kv_lora
    512, qk 192, 256 experts top-8 at d_model 7168): the naive prefill
    expands K and V from the latent, (1, L, 128 x (128 + 128)) (the rope
    key shared); an absorbed decode step of 8 rows rebuilds wkv_b as (512,
    32768) with ``dense_kernel`` and folds the query to (8, 1, 128, 512);
    the experts see (256, capacity, 7168) buffers."""
    cfg = dataclasses.replace(DEEPSEEK_V3_671B, num_layers=4)
    model = build_model(cfg)
    params = model.init(device="meta")
    seen = {}

    def spy(name, fn, arg=None):
        """Record the output's shape (or positional argument ``arg``'s)."""
        def wrapped(*a, **k):
            out = fn(*a, **k)
            seen.setdefault(name, []).append(tuple((out if arg is None else a[arg]).shape))
            return out
        return wrapped

    real_einsum = torch.einsum

    def einsum(eq, *ops):
        out = real_einsum(eq, *ops)
        if eq == "bshn,rhn->bshr":
            seen.setdefault("q_eff", []).append(tuple(out.shape))
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(mla, "dense_kernel", spy("dense_kernel", lowrank_utils.dense_kernel))
    mp.setattr(moe, "_expert_ffn", spy("expert_ffn", moe._expert_ffn, arg=1))
    mp.setattr(torch, "einsum", einsum)
    mp.setattr(mla, "_naive_attention", spy("naive", mla._naive_attention))
    try:
        with torch.no_grad():
            cache = model.init_cache(8, 256, device="meta")
            model.apply(params, torch.zeros((8, 173), dtype=torch.long, device="meta"),
                        mode="prefill", cache=cache)
            out = model.apply(params, torch.zeros((8, 1), dtype=torch.long, device="meta"),
                              mode="decode", cache=cache,
                              cache_len=torch.zeros(8, dtype=torch.int32, device="meta"))
    finally:
        mp.undo()
    assert tuple(out.shape) == (8, 1, 129280)
    assert seen["naive"] == [(8, 173, 128, 128)] * 4  # (B, L, H, v) a layer
    assert seen["dense_kernel"] == [(512, 32768)] * 4
    assert seen["q_eff"] == [(8, 1, 128, 512)] * 4
    cap_prefill = moe.capacity_of(8 * 173, cfg)
    assert seen["expert_ffn"] == [(256, cap_prefill, 7168), (256, 8, 7168)]
    assert cap_prefill == 55


def test_card_cut_resident_bytes_under_budget():
    """The dsv3_serve cut's calibration on meta tensors: weights 9.08 GB,
    the fp64 GramStore 28.53 GB (an expert's expert_buf Gram 411 MB), a
    batched tap's fp32 Gram and its experts' fp64 sum 3.70 GB; together
    under the budget, which
    leaves the compression's own fp64 work room under 72 GiB.  256
    experts would not fit: their Grams alone are 135 GB."""
    got = calibration_bytes(build_model(_card_cut()))
    assert got == {"weights": 9_079_699_456, "grams": 28_532_531_200,
                   "batch_gram": 3_699_376_128}
    assert sum(got.values()) <= RESIDENT_BUDGET_GIB * 2 ** 30
    full = dataclasses.replace(_card_cut(), moe=DEEPSEEK_V3_671B.moe)
    assert calibration_bytes(build_model(full))["grams"] > 100e9


@pytest.mark.parametrize("arch", [ARCH, "moonshot-v1-16b-a3b", "minicpm3-4b", "mistral-7b"])
def test_calibration_bytes_equal_what_a_calibration_leaves(arch):
    """``calibration_bytes`` on meta tensors against a real calibration of
    the reduced config on the CPU: the param tree's bytes, and the fp64
    GramStore's (every key an (n, n) Gram and an (n,) absmean), whatever
    the calibration batch's shape."""
    model = build_model(get_config(arch).reduced())
    params = model.init(device="cpu")
    store = collect_grams(model, params, _batches(1, (3, 11)))
    got = calibration_bytes(model)
    assert got["weights"] == tree_bytes(params)
    assert got["grams"] == sum(8 * (store.gram(k).numel() + store.absmean(k).numel())
                               for k in store.keys())


def test_chip_dsv3_path_counts_hold_on_cpu():
    """chip_smoke's DSV3_PREDICTED, derived as serve_path derives it: the
    schedule (steps, admission calls, host syncs) from a reduced twin with
    the card cut's topology and routing (3 dense + 1 MoE layer, 16 experts
    top-8 at capacity factor 1.25) served on the CPU with *Serve*'s prompt
    lengths; the launches from the card cut's nested calls a forward (32
    single and 3 batched; 28 single at decode) and each call's capacity
    rows; a calibration batch's Gram taps (26 single, 2 batched)."""
    import chip_smoke as cs
    from repro_torch.launch.serve import serve

    red = get_config(ARCH).reduced()
    twin = dataclasses.replace(red, num_layers=4, moe=dataclasses.replace(
        red.moe, num_experts=16, top_k=8, capacity_factor=1.25))
    rng = np.random.default_rng(0)
    plens = rng.integers(16, 201, size=8)
    prompts = [rng.integers(2, twin.vocab_size // 2, size=int(n)) for n in plens]
    calls = []

    def record(eng):
        prefill = eng._prefill

        def recorded(params, cache, tokens, *rest):
            calls.append((int(tokens.shape[1]), int(tokens.shape[0])))
            return prefill(params, cache, tokens, *rest)
        eng._prefill = recorded

    res = serve(twin, requests=8, max_new=32, max_batch=8, max_len=256, seed=0,
                compress=0.2, block_size=16, prefill_chunk=64, prompts=prompts,
                device="cpu", sched_policy="worst_case", pipeline_depth=1, on_engine=record)
    eng, p = res["engine"], cs.DSV3_PREDICTED
    st = eng.stats()
    assert calls == cs.admission_calls(plens, False) == [(int(n), 1) for n in plens]
    assert (st["steps"], st["prefill_ticks"], st["host_syncs"]) == (
        p["steps"], p["prefill_calls"], p["host_syncs"])
    assert eng.admissions_by_width == p["admissions"] and not eng._bucketed
    cut = build_model(_card_cut())
    assert cs.nested_calls(res["model"]) == cs.nested_calls(cut) == (32, 3)
    assert cs.nested_calls(cut, decode=True) == (28, 3)
    assert [moe.capacity_of(int(n), twin) for n in plens] == [
        moe.capacity_of(int(n), _card_cut()) for n in plens] == [
        109, 84, 69, 41, 45, 15, 19, 12]
    nested, batched = cs.nested_expect_of(_card_cut(), cut, st["steps"], list(plens))
    assert nested == p["nested"] and batched == {"stream": 2 * 3 + 31 * 3, "mma": 6 * 3,
                                                 "tile": 0}
    assert p["launches"]["nested_lowrank"] == nested["stream"] + nested["mma"]
    taps = {}
    res["model"].apply(res["params"], torch.zeros((2, 8), dtype=torch.long), taps=taps)
    n_batched = sum(k.endswith(("expert_buf", "expert_mid")) for k in taps)
    assert (len(taps) - n_batched, n_batched) == (26, 2)
    assert p["launches"]["gram"] == 16 * len(taps)
