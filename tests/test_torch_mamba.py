"""Port parity for jamba-v0.1-52b: the Mamba (S6) mixer and jamba's 1:7
Mamba / attention hybrid over a top-2 token-choice MoE.  The reduced config
(the reference's ``reduced()``: 16 layers, one stacked period of 8 repeated
twice, 8 experts top-2 at capacity factor 8.0, the tiny Mamba) against the
JAX package on the same numpy-seeded inputs: config fields, layer specs,
groups, targets and Gram keys, the mixer's output, state and conv tail in
causal and decode mode at several lengths and chunk sizes, the layer's
taps, train logits, per-expert Grams, nsvd1 logits at 0.2 with the experts
pinned to the reference's choices (``RoutingTrace``), slab prefill then
decode, greedy streams against the reference engine with exact-length
admission; the paged, int8 and speculative refusals; the full-width
factored shapes (32 layers, 16 experts) against ``jax.eval_shape``;
chip_smoke's jamba_serve counts on a reduced twin; the card cut's resident
bytes; the serve CLI's memory check; and three faults of the reference
that the port does not share.  fp32 on both sides."""

import dataclasses
import functools
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import t2np, to_np, to_t

from repro.calib.runner import collect_grams as jax_collect_grams
from repro.configs import get_config as jax_get_config
from repro.core import CompressionConfig as JaxCompressionConfig
from repro.core import GramStore as JaxGramStore
from repro.core import build_plan as jax_build_plan
from repro.core import compress_params as jax_compress_params
from repro.launch.compress_shapes import compressed_param_shapes as jax_compressed_param_shapes
from repro.models import build_model as jax_build_model
from repro.models import mamba as jax_mamba
from repro.models import moe as jax_moe
from repro.serving.engine import ServingEngine as JaxEngine
from repro.serving.scheduler import SchedulerConfig
from repro_torch.calib.runner import collect_grams
from repro_torch.configs import ALL, FAMILIES, JAMBA_V0_1_52B, PAPER, get_config
from repro_torch.core import CompressionConfig, GramStore, build_plan, compress_params
from repro_torch.core.nsvd import split_rank
from repro_torch.launch.compress_shapes import (calibration_bytes, compressed_param_shapes,
                                                compression_bytes, decomposition_bytes,
                                                tree_bytes)
from repro_torch.launch.serve import fit_error, main as serve_main, run_bytes
from repro_torch.models import build_model, cache_layout, mamba, moe, prefill_pad_safe
from repro_torch.models.blocks import group_layers, resolve_specs
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.spec import SpecConfig

# fp32 on both sides; the two frameworks sum in other orders (and the
# port's prefix scan combines in another tree than the reference's
# associative_scan), so O(1) logits agree to ~1e-5.
TOL = dict(rtol=1e-4, atol=1e-4)
MIXER_TOL = 1e-4  # of max |y| (and of max |h| for the state)
COMPRESSED_TOL = 1e-3  # of max |logit|: factors differ by SVD signs and rounding
ARCH = "jamba-v0.1-52b"
# chip_smoke's jamba_serve cut keeps its weights (8.70 GB) and fp64 Grams
# (42.86 GB) under this; with a calibration batch's transient and the
# compression's own bytes (``launch.serve.run_bytes``) the run stays under
# PEAK_LIMIT_GIB, above which the cut would take 4 experts.
RESIDENT_BUDGET_GIB = 55
PEAK_LIMIT_GIB = 72


def _card_cut(experts=8):
    """chip_smoke's jamba_serve cut: 5 of 32 layers, 8 of 16 experts."""
    return dataclasses.replace(JAMBA_V0_1_52B, num_layers=5, moe=dataclasses.replace(
        JAMBA_V0_1_52B.moe, num_experts=experts))


@functools.lru_cache(maxsize=None)
def _setup(seed=0, spread=False):
    """(reference model, params, port model, params) of the reduced jamba;
    ``spread`` scales the unembed by 8 so greedy choices are not near-ties
    (the engine tests)."""
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


def _close(got, want, tol, what=""):
    """|got - want| <= tol * max |want|, element by element."""
    want = np.asarray(want)
    np.testing.assert_allclose(t2np(got), want, rtol=0,
                               atol=tol * float(np.abs(want).max()), err_msg=what)


# ------------------------------------------------------------------ config

@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_reference(reduced):
    """Every field the port keeps, field for field, full and reduced (the
    Mamba sub-config among them); the reduced topology is the reference's:
    16 layers, 8 experts top-2 at capacity factor 8.0, the tiny Mamba."""
    j, t = jax_get_config(ARCH), get_config(ARCH)
    if reduced:
        j, t = j.reduced(), t.reduced()
    tj = dataclasses.asdict(t)
    assert {k: v for k, v in dataclasses.asdict(j).items() if k in tj} == tj
    assert t.layer_specs() == j.layer_specs()
    if reduced:
        assert (t.num_layers, t.moe.num_experts, t.moe.top_k, t.moe.capacity_factor) == (
            16, 8, 2, 8.0)
        assert dataclasses.astuple(t.mamba) == (64, 4, 4, 4)
    else:
        assert (t.d_model, t.num_heads, t.num_kv_heads, t.d_ff, t.vocab_size, t.pos_emb,
                t.moe.num_experts, t.moe.top_k, t.moe.d_ff_expert) == (
            4096, 32, 8, 14336, 65536, "none", 16, 2, 14336)
        assert dataclasses.astuple(t.mamba) == (8192, 16, 4, 256)
    assert get_config(ARCH) is JAMBA_V0_1_52B and ARCH in ALL


@pytest.mark.parametrize("cut,want", [
    ("reduced", [(("mamba", "mlp"), ("mamba", "moe"), ("mamba", "mlp"), ("mamba", "moe"),
                  ("gqa", "mlp"), ("mamba", "moe"), ("mamba", "mlp"), ("mamba", "moe")), 2]),
    ("card", [(("mamba", "mlp"), ("mamba", "moe"), ("mamba", "mlp"), ("mamba", "moe"),
               ("gqa", "mlp")), 1]),
    ("full", [(("mamba", "mlp"), ("mamba", "moe"), ("mamba", "mlp"), ("mamba", "moe"),
               ("gqa", "mlp"), ("mamba", "moe"), ("mamba", "mlp"), ("mamba", "moe")), 4]),
])
def test_specs_and_groups_match_reference(cut, want):
    """``resolve_specs`` keeps the ffn of a "mamba" layer, as the
    reference's; jamba's period of 8 is one stacked group (the 5-layer card
    cut one unstacked period of 5, attention at index 4)."""
    cfgs = {"reduced": (jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()),
            "card": (dataclasses.replace(jax_get_config(ARCH), num_layers=5), _card_cut()),
            "full": (jax_get_config(ARCH), get_config(ARCH))}
    jcfg, tcfg = cfgs[cut]
    specs = resolve_specs(tcfg)
    groups = group_layers(specs)
    assert [[g.period, g.repeats] for g in groups] == [want]
    jmodel = jax_build_model(jcfg)
    assert specs == tuple(jmodel.specs)
    assert [(g.period, g.repeats, g.first_layer) for g in groups] == [
        (tuple(g.period), g.repeats, g.first_layer) for g in jmodel.groups]


@pytest.mark.parametrize("arch", sorted(set(FAMILIES) | set(PAPER)))
def test_every_config_resolves_as_the_reference(arch):
    """Every config's layer specs and stack groups, full and reduced, equal
    the reference's now that "mamba" layers resolve."""
    for j, t in ((jax_get_config(arch), get_config(arch)),
                 (jax_get_config(arch).reduced(), get_config(arch).reduced())):
        jmodel = jax_build_model(j)
        assert resolve_specs(t) == tuple(jmodel.specs)
        assert [(g.period, g.repeats) for g in group_layers(resolve_specs(t))] == [
            (tuple(g.period), g.repeats) for g in jmodel.groups]


def test_targets_and_gram_keys_of_the_mamba_moe_layer():
    """A (mamba, moe) layer's targets: the four Mamba linears (in_proj,
    x_proj, dt_proj, out_proj, with their dims and Gram keys), then the
    experts' (stacked over repeats and experts); every Gram key a target
    reads is one the calibration collects."""
    _, _, tmodel, _ = _setup()
    layer = [t for t in tmodel.compressible_targets() if t.path[:2] == ("g0", "sub1")]
    assert [(t.path[2:], t.in_dim, t.out_dim, t.gram_key, tuple(t.stacked))
            for t in layer] == [
        (("mamba", "in_proj"), 32, 128, "g0/sub1.mamba.in", (2,)),
        (("mamba", "x_proj"), 64, 12, "g0/sub1.mamba.ssm_in", (2,)),
        (("mamba", "dt_proj"), 4, 64, "g0/sub1.mamba.dt_in", (2,)),
        (("mamba", "out_proj"), 64, 32, "g0/sub1.mamba.out_in", (2,)),
        (("moe", "experts", "wi"), 32, 32, "g0/sub1.moe.expert_buf", (2, 8)),
        (("moe", "experts", "wg"), 32, 32, "g0/sub1.moe.expert_buf", (2, 8)),
        (("moe", "experts", "wo"), 32, 32, "g0/sub1.moe.expert_mid", (2, 8))]
    keys = set(_calibrated()[1].keys())
    assert {t.gram_key for t in tmodel.compressible_targets()} <= keys


# ------------------------------------------------------------------ mixer

def _mixer(seed=3):
    """The reduced config's Mamba params (reference init) on both sides."""
    cfg = jax_get_config(ARCH).reduced()
    jp = jax_mamba.mamba_init(jax.random.key(seed), cfg, jnp.float32)
    return cfg, jp, to_t(jp), get_config(ARCH).reduced()


def _x(shape, seed=4):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("s", [8, 200, 600])
def test_mixer_prefill_then_decode_matches_reference(s):
    """``mamba_apply`` in causal mode with a cache (a prefill: output, final
    state h and conv tail), then three decode steps against the cache,
    against the reference's at S = 8, 200 and 600 (the port at its chunk of
    64, the reference at 256: at 600 two chunks of 300)."""
    jcfg, jp, tp, tcfg = _mixer()
    x = _x((2, s, 32))
    jc = jax_mamba.init_mamba_cache(jcfg, 2, jnp.float32)
    want, jc = jax_mamba.mamba_apply(jp, jnp.asarray(x), jcfg, mode="causal", cache=jc)
    tc = mamba.init_mamba_cache(tcfg, 2, torch.float32, "cpu")
    got = mamba.mamba_apply(tp, torch.as_tensor(x), tcfg, mode="causal", cache=tc)
    _close(got, want, MIXER_TOL, "y")
    _close(tc["h"], jc["h"], MIXER_TOL, "h")
    np.testing.assert_array_equal(t2np(tc["conv"]), np.asarray(jc["conv"]))
    for i in range(3):
        step = _x((2, 1, 32), seed=10 + i)
        want, jc = jax_mamba.mamba_apply(jp, jnp.asarray(step), jcfg, mode="decode", cache=jc)
        got = mamba.mamba_apply(tp, torch.as_tensor(step), tcfg, mode="decode", cache=tc)
        _close(got, want, MIXER_TOL, f"decode {i}")
    _close(tc["h"], jc["h"], MIXER_TOL, "h after decode")
    _close(tc["conv"], jc["conv"], MIXER_TOL, "conv after decode")


@pytest.mark.parametrize("chunk", [8, 32, 256])
def test_mixer_chunk_sizes_match_reference_chunk(chunk):
    """Chunking changes rounding only: the port at chunks 8, 32 and 256
    against the reference's chunk of 256, output and final state, at S = 200
    (a last chunk shorter than the others at 8 and 32: 200 = 25 x 8, 6 x 32
    + 8)."""
    jcfg, jp, tp, tcfg = _mixer()
    x = _x((2, 200, 32), seed=6)
    jc = jax_mamba.init_mamba_cache(jcfg, 2, jnp.float32)
    want, jc = jax_mamba.mamba_apply(jp, jnp.asarray(x), jcfg, mode="causal", cache=jc,
                                     chunk=256)
    tc = mamba.init_mamba_cache(tcfg, 2, torch.float32, "cpu")
    got = mamba.mamba_apply(tp, torch.as_tensor(x), tcfg, cache=tc, chunk=chunk)
    _close(got, want, MIXER_TOL)
    _close(tc["h"], jc["h"], MIXER_TOL)


def test_block_taps_compose_mamba_and_moe():
    """One (mamba, moe) layer taps ``…mamba.*`` (in, ssm_in, dt_in,
    out_in) beside ``…moe.*`` (router_in, the capacity buffers), as the
    reference's block, with the same values."""
    jmodel, jparams, tmodel, tparams = _setup()
    tokens = _batches(1, (2, 9), seed=11)[0]
    jtaps, ttaps = {}, {}
    jmodel.apply(jparams, jnp.asarray(tokens), mode="train", taps=jtaps)
    tmodel.apply(tparams, torch.as_tensor(tokens), mode="train", taps=ttaps)
    assert sorted(ttaps) == sorted(jtaps)
    layer = "g0/rep1/sub1."
    assert sorted(k[len(layer):] for k in ttaps if k.startswith(layer)) == sorted([
        "mamba.in", "mamba.ssm_in", "mamba.dt_in", "mamba.out_in", "moe.router_in",
        "moe.expert_buf", "moe.expert_mid"])
    for k in jtaps:
        np.testing.assert_allclose(t2np(ttaps[k]), np.asarray(jtaps[k]), **TOL, err_msg=k)


def test_train_logits_match():
    jmodel, jparams, tmodel, tparams = _setup()
    tokens = np.random.default_rng(1).integers(0, 256, (2, 21))
    want, _, _ = jmodel.apply(jparams, jnp.asarray(tokens, jnp.int32), mode="train")
    got = tmodel.apply(tparams, torch.as_tensor(tokens), mode="train")
    np.testing.assert_allclose(t2np(got), np.asarray(want), **TOL)


def test_port_calibration_gives_reference_grams():
    """The port's calibration collects the reference's keys (per layer and
    shared over the stack; per expert "{base}/{layer}/{e}" and their sum),
    the Mamba taps' among them, each Gram, absmean and count within fp32
    sum order."""
    jgrams, tgrams = _calibrated()
    assert set(tgrams.keys()) == set(jgrams.keys())
    expert = [k for k in jgrams.keys() if "expert_buf/" in k]
    assert len(expert) == 4 * 2 * 8 and "g0/sub7.moe.expert_buf/1/7" in expert
    assert {"g0/sub0.mamba.dt_in/1", "g0/sub4.attn.in/0"} <= set(tgrams.keys())
    for k in jgrams.keys():
        want = np.asarray(jgrams.gram(k))
        np.testing.assert_allclose(t2np(tgrams.gram(k)), want, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(want).max(), 1e-30), err_msg=k)
        np.testing.assert_allclose(t2np(tgrams.absmean(k)), np.asarray(jgrams.absmean(k)),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
        assert tgrams.count(k) == jgrams.count(k), k
    # Lossless capacity: a layer's expert counts sum to its routed slots (2
    # batches of 4 x 16 tokens, top-2).
    counts = [tgrams.count(f"g0/sub1.moe.expert_buf/0/{e}") for e in range(8)]
    assert sum(counts) == 2 * 4 * 16 * 2


def _reference_choices(jmodel, jparams, tokens):
    """The reference's top-k experts of every MoE call on ``tokens``, in
    the port's call order (repeat by repeat, then the period's MoE layers)."""
    taps = {}
    jmodel.apply(jparams, jnp.asarray(tokens, jnp.int32), mode="train", taps=taps)
    k = jmodel.cfg.moe.top_k
    out = []
    for r in range(2):
        for j in (1, 3, 5, 7):
            lp = jax.tree.map(lambda a: a[r], jparams["g0"][f"sub{j}"]["moe"])
            probs = jax_moe.router_probs(lp, taps[f"g0/rep{r}/sub{j}.moe.router_in"])
            out.append(torch.as_tensor(np.array(jax.lax.top_k(probs, k)[1])).long())
    return out


def _pinned_logits(tmodel, tparams, jmodel, jparams, tokens):
    """The port's train logits with its experts pinned to the reference's
    choices on ``jparams``, and the routings the pin changed."""
    trace = moe.RoutingTrace()
    trace.choices = _reference_choices(jmodel, jparams, tokens)
    with trace.replay():
        got = tmodel.apply(tparams, torch.as_tensor(tokens), mode="train")
    return got, trace.flips


@pytest.mark.parametrize("grams_from", ["reference", "port"])
def test_compressed_logits_match_with_routing_pinned(grams_from, tmp_path):
    """nsvd1 at ratio 0.2 (min_dim 8, so the reduced dt_proj (4 -> 64) is
    kept dense as on both sides; per-expert Grams with the shared
    fallback): the reference's compressed forward against the port's, from
    the reference's GramStore file or the port's own calibration, the
    port's experts pinned to the reference's choices."""
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
    lin = tc["g0"]["sub1"]["mamba"]
    assert set(lin["in_proj"]) == {"u", "v", "u2", "v2"} and {"u", "v"} <= set(lin["x_proj"])
    assert set(lin["dt_proj"]) == {"kernel", "bias"}
    tokens = np.random.default_rng(2).integers(0, 256, (2, 19))
    want, _, _ = jmodel.apply(jc, jnp.asarray(tokens, jnp.int32), mode="train")
    got, flips = _pinned_logits(tmodel, tc, jmodel, jc, tokens)
    assert flips <= 2  # rounding-level near-ties at most
    _close(got, want, COMPRESSED_TOL)


def _cache_leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _cache_leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def test_slab_prefill_then_decode_match_reference():
    """The whole model on the dense slab: prefill two prompts into a fresh
    slab, then three decode steps; logits and every leaf of the one cache
    tree (the Mamba layers' h and conv beside the attention layers' k and
    v)."""
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
        "h", "conv", "k", "v"}
    for name, w in want.items():
        np.testing.assert_allclose(t2np(got[name]), w, **TOL, err_msg=name)


# ---------------------------------------------------------------- serving

def test_layout_is_the_exact_length_dense_slab():
    """Recurrent state and a MoE: pad-sensitive twice over, so the dense
    slab with one exact-length admission a request; no paged form."""
    _, _, tmodel, tparams = _setup()
    assert cache_layout(tmodel) == "dense" and not prefill_pad_safe(tmodel)
    eng = ServingEngine(tmodel, tparams, max_batch=2, max_len=32)
    assert eng.layout == "dense" and eng.kv is None and not eng._bucketed
    with pytest.raises(ValueError, match="paged"):
        tmodel.init_paged_cache(8, 4, device="cpu")


@pytest.mark.parametrize("kw,match", [
    ({"paged": True}, "paging requires a pure-attention cache"),
    ({"paged": True, "kv_quant": True}, "paging requires a pure-attention cache"),
    ("spec", "speculative decoding needs pure-attention caches")])
def test_engine_refuses_pages_int8_and_spec(kw, match):
    """Each refusal names its reason, as for RWKV-6.  ``kv_quant`` alone is
    taken: it makes the attention layer's slab int8, the Mamba state stays
    fp32 (tests/test_torch_slab_int8.py); with pages it is refused as pages
    are."""
    _, _, tmodel, tparams = _setup()
    if kw == "spec":
        kw = {"spec_config": SpecConfig(draft_params=tparams, k=2)}
    with pytest.raises(ValueError, match=match):
        ServingEngine(tmodel, tparams, max_batch=2, max_len=32, **kw)
    eng = ServingEngine(tmodel, tparams, max_batch=2, max_len=32, kv_quant=True)
    assert {str(leaf.dtype) for leaf in (eng.cache["g0"]["sub4"]["attn"]["k"],
                                         eng.cache["g0"]["sub0"]["mamba"]["h"])} == {
        "torch.int8", "torch.float32"}


def _recorded(eng, attr, out):
    """Record each dense admission call's token shape."""
    call = getattr(eng, attr)

    def recorded(params, cache, tokens, *rest):
        out.append(tuple(tokens.shape))
        return call(params, cache, tokens, *rest)
    setattr(eng, attr, recorded)


def test_greedy_streams_match_reference_engine():
    """Dense slab, exact-length admission: the port's greedy streams equal
    the reference engine's (worst case, depth 1); one admission call a
    request at its prompt's length, in both; every request finishes; one
    host sync a step and one an admission."""
    jmodel, jparams, tmodel, tparams = _setup(seed=1, spread=True)
    rng = np.random.default_rng(0)
    lens = (5, 11, 7, 11)
    prompts = [rng.integers(2, 200, size=n) for n in lens]
    kw = dict(max_batch=2, max_len=32)
    ref = JaxEngine(jmodel, jparams, pipeline_depth=1,
                    sched_config=SchedulerConfig(admission="worst_case"), **kw)
    eng = ServingEngine(tmodel, tparams, pipeline_depth=1, **kw)
    widths, calls = [], []
    _recorded(ref, "_prefill", widths)
    _recorded(eng, "_prefill", calls)
    ref_ids = [ref.submit(p, max_new_tokens=6) for p in prompts]
    ids = [eng.submit(p, max_new_tokens=6) for p in prompts]
    want, got = ref.run(), eng.run()
    assert [got[i] for i in ids] == [want[i] for i in ref_ids]
    assert [w[1] for w in widths] == list(lens) and calls == [(1, n) for n in lens]
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
    """jamba-v0.1-52b at full width, all 32 layers and 16 experts, no
    memory (the reference's abstract init against meta tensors): every
    target's factors at nsvd1 0.2 as the reference's shape-level
    compression gives them; the one difference is dt_proj's bias, which
    the port keeps beside its factors and the reference drops."""
    jmodel = jax_build_model(jax_get_config(ARCH))
    jshapes = jax.eval_shape(jmodel.init, jax.random.key(0))
    want = dict(_shape_leaves(jax_compressed_param_shapes(jmodel, jshapes, 0.2,
                                                          method="nsvd1")))
    tmodel = build_model(get_config(ARCH))
    meta = jax.tree.map(lambda x: torch.empty(x.shape, device="meta",
                                              dtype=getattr(torch, str(x.dtype))), jshapes)
    got = dict(_shape_leaves(compressed_param_shapes(tmodel, meta, 0.2, method="nsvd1")))
    extra = {k: v for k, v in got.items() if k not in want}
    assert {k for k in got if k in want} == set(want)
    assert all(got[k] == want[k] for k in want)
    assert sorted(extra) == [("g0", f"sub{j}", "mamba", "dt_proj", "bias")
                             for j in (0, 1, 2, 3, 5, 6, 7)]
    assert all(v == ((4, 8192), "bfloat16") for v in extra.values())
    # The experts at 2310 + 122 (shape-level compression rounds ranks to
    # multiples of 128; the served plan's 2421 + 127 does not).
    assert got[("g0", "sub1", "moe", "experts", "wi", "u")] == ((4, 16, 4096, 2310),
                                                                "bfloat16")
    # And the port's own meta init gives the reference's dense tree.
    assert dict(_shape_leaves(tmodel.init(device="meta"))) == dict(_shape_leaves(meta))


def test_card_cut_resident_bytes_under_budget():
    """The jamba_serve cut's calibration on meta tensors: weights 8.70 GB
    and the fp64 GramStore 42.86 GB (an expert's expert_mid Gram 1.64 GB)
    resident, under the budget; a batched tap's fp32 Gram and its experts'
    fp64 sum 8.22 GB on top while a batch is folded in.  The whole run,
    compression included (``run_bytes``: 65.95 GiB), stays under the peak
    limit.  All 16 experts would hold 71.3 GB of Grams: more than the card
    with the weights and the batched Gram."""
    cut = build_model(_card_cut())
    got = calibration_bytes(cut)
    assert got == {"weights": 8_695_668_736, "grams": 42_855_030_784,
                   "batch_gram": 8_220_835_840}
    assert got["weights"] + got["grams"] <= RESIDENT_BUDGET_GIB * 2 ** 30
    assert run_bytes(_card_cut(), [0.2])[0] <= PEAK_LIMIT_GIB * 2 ** 30
    full = calibration_bytes(build_model(_card_cut(16)))
    assert full["grams"] > 71e9 and sum(full.values()) > 80 * 2 ** 30


def test_calibration_bytes_equal_what_a_calibration_leaves():
    """``calibration_bytes`` on meta tensors (the scan on meta) against a
    real calibration of the reduced jamba on the CPU: the param tree's
    bytes and the fp64 GramStore's."""
    model = build_model(get_config(ARCH).reduced())
    params = model.init(device="cpu")
    store = collect_grams(model, params, _batches(1, (3, 11)))
    got = calibration_bytes(model)
    assert got["weights"] == tree_bytes(params)
    assert got["grams"] == sum(8 * (store.gram(k).numel() + store.absmean(k).numel())
                               for k in store.keys())


def test_compression_bytes_count_the_factors_and_the_widest_target():
    """``compression_bytes`` of the jamba_serve cut on meta tensors, under
    the serve CLI's config: ``factors`` is every factored leaf the served
    plan makes (``compressed_param_shapes``' u, v, u2, v2), and ``work`` the
    widest target's, a MoE layer's experts/wo (8 x 14336 -> 4096): its
    kernels cast to fp32, its slices' factors before they are stacked, and
    one slice's decomposition, whose eigen whitener's build at n 14336
    leads (``decomposition_bytes``)."""
    cut = build_model(_card_cut())
    config = CompressionConfig(method="nsvd1", ratio=0.2, dtype="bfloat16",
                               use_randomized=False)
    got = compression_bytes(cut, config)
    plan = build_plan(cut.compressible_targets(), config)
    shapes = compressed_param_shapes(cut, cut.init(device="meta"), 0.2, multiple_of=1)

    def leaf(tree, path):
        for p in path:
            tree = tree[p]
        return tree
    own = {t.name: tree_bytes({k: v for k, v in leaf(shapes, t.path).items()
                               if k in ("u", "v", "u2", "v2")}) for t in plan.targets}
    assert got["factors"] == sum(own.values())
    wo = "g0/sub3/moe/experts/wo"
    a, n = 8 * 14336 * 4096, 8 * 14336 ** 2
    assert decomposition_bytes(14336, 4096) == a + int(6.125 * n)
    assert got["work"] == 4 * 8 * 14336 * 4096 + own[wo] + decomposition_bytes(14336, 4096)


def test_serve_cli_refuses_what_does_not_fit(monkeypatch, capsys):
    """``--arch jamba-v0.1-52b --no-reduced`` resolves, and on the card the
    CLI compares what the run will hold with the card's free memory before
    it allocates anything: 32 layers' weights (103.15 GB), or a 5-layer
    cut's calibration and compression with all 16 experts (112.05 GB) or
    with chip_smoke's 8 (70.82 GB), do not fit 50 GB free, and it prints
    both numbers.  The 8-expert cut's weights, Grams and a batch's Grams
    (59.77 GB) fit 60 GB, but with the compression's factors and fp64
    decomposition they do not, so 60 GB is refused too; 80 GiB fits."""
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda *a: (50 * 10 ** 9, 80 * 2 ** 30))
    for argv, need in ((["--no-reduced"], "103.15 GB (weights)"),
                       (["--no-reduced", "--layers", "5", "--compress", "0.2"],
                        "112.05 GB (weights 14.33 + calibration Grams 71.31 + compression "
                        "26.40)")):
        with pytest.raises(SystemExit):
            serve_main(["--arch", ARCH, *argv])
        err = capsys.readouterr().err
        assert need in err and "50.00 GB free" in err
    assert fit_error(_card_cut(), [0.2], 80 * 2 ** 30) is None
    assert "70.82 GB" in fit_error(_card_cut(), [0.2], 50 * 10 ** 9)
    calib = calibration_bytes(build_model(_card_cut()))
    assert sum(calib.values()) < 60 * 10 ** 9
    assert "70.82 GB" in fit_error(_card_cut(), [0.2], 60 * 10 ** 9)
    # A draft (the spec CLI's --spec-ratio) adds its own factors.
    assert run_bytes(_card_cut(), [0.2, 0.6])[0] > run_bytes(_card_cut(), [0.2])[0]


def test_serve_cli_runs_the_reduced_config_on_cpu(capsys):
    """``--arch jamba-v0.1-52b --device cpu`` serves the reduced config:
    the dense slab, one exact-length prefill a request."""
    serve_main(["--arch", ARCH, "--device", "cpu", "--requests", "2", "--max-new", "3",
                "--max-batch", "2"])
    out = capsys.readouterr().out
    assert "2 requests, 6 tokens" in out and "cache layout dense; prefill calls 2" in out


def test_chip_jamba_path_counts_hold_on_cpu():
    """chip_smoke's JAMBA_PREDICTED, derived as serve_path derives it: the
    schedule (steps, admission calls, host syncs) from a reduced twin with
    the card cut's topology and routing (5 layers, 8 experts top-2 at
    capacity factor 1.25) served on the CPU with *Serve*'s prompt lengths;
    the launches from the card cut's nested calls a forward (29 single and
    6 batched, the same at decode) and each call's capacity rows; a
    calibration batch's Gram taps (27 single, 4 batched); flash on the one
    attention layer; and the kernel phase's ranks against the card cut's
    plan."""
    import chip_smoke as cs
    from repro_torch.launch.serve import serve

    red = get_config(ARCH).reduced()
    twin = dataclasses.replace(red, num_layers=5, moe=dataclasses.replace(
        red.moe, capacity_factor=1.25))
    rng = np.random.default_rng(0)
    plens = rng.integers(16, 201, size=8)
    prompts = [rng.integers(2, twin.vocab_size // 2, size=int(n)) for n in plens]
    calls = []
    res = serve(twin, requests=8, max_new=32, max_batch=8, max_len=256, seed=0,
                compress=0.2, block_size=16, prefill_chunk=64, prompts=prompts,
                device="cpu", sched_policy="worst_case", pipeline_depth=1,
                on_engine=lambda eng: _recorded(eng, "_prefill", calls))
    eng, p = res["engine"], cs.JAMBA_PREDICTED
    st = eng.stats()
    assert [(w, r) for r, w in calls] == cs.admission_calls(plens, False) == [
        (int(n), 1) for n in plens]
    assert (st["steps"], st["prefill_ticks"], st["host_syncs"]) == (
        p["steps"], p["prefill_calls"], p["host_syncs"])
    assert eng.admissions_by_width == p["admissions"] and not eng._bucketed
    cut_cfg = _card_cut()
    cut = build_model(cut_cfg)
    assert cs.nested_calls(res["model"]) == cs.nested_calls(cut) == (29, 6)
    assert cs.nested_calls(cut, decode=True) == (29, 6)
    assert [moe.capacity_of(int(n), twin) for n in plens] == [
        moe.capacity_of(int(n), cut_cfg) for n in plens] == [55, 42, 35, 21, 23, 8, 10, 8]
    nested, batched = cs.nested_expect_of(cut_cfg, cut, st["steps"], list(plens))
    assert nested == p["nested"] and batched == {"stream": 6 * (31 + 3), "mma": 6 * 5,
                                                 "tile": 0}
    assert p["launches"]["nested_lowrank"] == nested["stream"] + nested["mma"]
    assert p["launches"]["flash_attention"] == cs.mixer_layers(cut, "flash_attention") * (
        16 + 8) == 24
    taps = {}
    res["model"].apply(res["params"], torch.zeros((2, 8), dtype=torch.long), taps=taps)
    n_batched = sum(k.endswith(("expert_buf", "expert_mid")) for k in taps)
    assert (len(taps) - n_batched, n_batched) == (27, 4)
    assert p["launches"]["gram"] == 16 * len(taps)
    # The batched gram's launches by width: each MoE layer's expert_buf
    # (d_model) and expert_mid (d_ff_expert) taps, once a batch.
    widths = Counter(x.shape[-1] for k, x in taps.items()
                     if k.endswith(("expert_buf", "expert_mid")))
    assert cs.batched_gram_expect(twin, res["model"], 16) == {
        f"batched {n}": 16 * c for n, c in widths.items()}
    assert cs.batched_gram_expect(cut_cfg, cut, 16) == {"batched 4096": 32,
                                                        "batched 14336": 32}
    # The kernel phase's shapes and ranks are the served plan's.
    plan = build_plan(cut.compressible_targets(), CompressionConfig(
        method="nsvd1", ratio=0.2, use_randomized=False))
    ranks = {t.path[-1]: (t.in_dim, t.out_dim, plan.rank_of(t)) for t in plan.targets
             if t.path[1] == "sub1"}
    assert [ranks[name[len("jamba_"):]] for name, *_ in cs.JAMBA_PATH_SHAPES] == [
        tuple(shape) for _, *shape in cs.JAMBA_PATH_SHAPES]
    assert split_rank(ranks["wi"][2], 0.95) == (cs.JAMBA_K1, cs.JAMBA_K2)
    assert cs.cache_bytes_per_token(cut) == 2 * 8 * 128 * 2
    assert cs.cache_bytes_per_row(cut) == 4 * (8192 * 16 * 4 + 3 * 8192 * 2)


# ------------------------------------------------- faults of the reference

def test_reference_fault_compressed_dt_proj():
    """Fault 1: ``dt_proj`` is a target, but the reference reads its dense
    kernel with a plain matmul, and its compression drops the bias.  At
    dt_rank 8 (so min_dim 8 keeps the target) with ``svd`` at 0.2 the
    reference's forward raises KeyError; the port's (dt_proj through the
    factors, the bias kept) equals the reference on params whose dt_proj is
    re-densified as {kernel: u @ v, bias}, experts pinned."""
    base = jax_get_config(ARCH).reduced()
    jcfg = dataclasses.replace(base, mamba=dataclasses.replace(base.mamba, dt_rank=8))
    tbase = get_config(ARCH).reduced()
    tcfg = dataclasses.replace(tbase, mamba=dataclasses.replace(tbase.mamba, dt_rank=8))
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    jparams = jmodel.init(jax.random.key(2))
    kw = dict(method="svd", ratio=0.2, dtype="float32", use_randomized=False, min_dim=8)
    jplan = jax_build_plan(jmodel.compressible_targets(), JaxCompressionConfig(**kw))
    jc = jax_compress_params(jparams, jplan, JaxGramStore())
    tc = compress_params(to_t(jparams), build_plan(tmodel.compressible_targets(),
                                                   CompressionConfig(**kw)), GramStore())
    tokens = np.random.default_rng(3).integers(0, 256, (2, 17))
    with pytest.raises(KeyError, match="kernel"):
        jmodel.apply(jc, jnp.asarray(tokens, jnp.int32), mode="train")
    dt = tc["g0"]["sub0"]["mamba"]["dt_proj"]
    assert set(dt) == {"u", "v", "bias"} and tuple(dt["u"].shape)[:2] == (2, 8)
    for j in (0, 1, 2, 3, 5, 6, 7):
        leaf = jc["g0"][f"sub{j}"]["mamba"]["dt_proj"]
        jc["g0"][f"sub{j}"]["mamba"]["dt_proj"] = {
            "kernel": jnp.matmul(leaf["u"], leaf["v"]),
            "bias": jparams["g0"][f"sub{j}"]["mamba"]["dt_proj"]["bias"]}
    want, _, _ = jmodel.apply(jc, jnp.asarray(tokens, jnp.int32), mode="train")
    got, flips = _pinned_logits(tmodel, tc, jmodel, jc, tokens)
    assert flips <= 2
    _close(got, want, COMPRESSED_TOL)


def test_reference_fault_scan_length():
    """Fault 2: the reference's chunked scan reshapes S into S // 256
    chunks of S // (S // 256) and raises at S = 513; the port takes any
    length (a last chunk of 1 here) and equals its own chunk-1 sequential
    recurrence, output and final state."""
    jcfg, jp, tp, tcfg = _mixer()
    x = _x((1, 513, 32), seed=8)
    with pytest.raises(TypeError, match="reshape"):
        jax_mamba.mamba_apply(jp, jnp.asarray(x), jcfg, mode="causal")
    caches = [mamba.init_mamba_cache(tcfg, 1, torch.float32, "cpu") for _ in range(2)]
    got = mamba.mamba_apply(tp, torch.as_tensor(x), tcfg, cache=caches[0])
    want = mamba.mamba_apply(tp, torch.as_tensor(x), tcfg, cache=caches[1], chunk=1)
    _close(got, t2np(want), MIXER_TOL)
    _close(caches[0]["h"], t2np(caches[1]["h"]), MIXER_TOL)


def test_reference_fault_short_prompt():
    """Fault 3: a prompt shorter than d_conv - 1 (3 tokens): the
    reference's prefill writes S rows of conv tail into a 3-row cache, and
    its engine raises on a 2-token prompt.  The port left-pads the tail
    with zeros (what decode from a zero tail computes): its greedy stream
    equals a cacheless reference forward over the growing sequence."""
    jmodel, jparams, tmodel, tparams = _setup(seed=1, spread=True)
    prompt = np.asarray([7, 42])
    ref = JaxEngine(jmodel, jparams, max_batch=2, max_len=32, pipeline_depth=1,
                    sched_config=SchedulerConfig(admission="worst_case"))
    ref.submit(prompt, max_new_tokens=5)
    with pytest.raises(ValueError, match="Incompatible shapes"):
        ref.run()
    eng = ServingEngine(tmodel, tparams, max_batch=2, max_len=32, pipeline_depth=1)
    uid = eng.submit(prompt, max_new_tokens=5)
    got = eng.run()[uid]
    seq = list(prompt)
    for _ in range(5):
        logits, _, _ = jmodel.apply(jparams, jnp.asarray([seq], jnp.int32), mode="train")
        seq.append(int(jnp.argmax(logits[0, -1])))
    assert got == seq[2:]


def test_compress_params_keeps_every_other_config_tree():
    """Keeping a target's sibling leaves changes only jamba's tree (its
    dt_proj bias): every other config's compressed tree (reduced, ``svd``
    at 0.2) has the reference's leaves, shapes and dtypes, exactly."""
    for arch in sorted(set(FAMILIES) | set(PAPER)):
        if arch == ARCH:
            continue
        jmodel = jax_build_model(jax_get_config(arch).reduced())
        tmodel = build_model(get_config(arch).reduced())
        jparams = jmodel.init(jax.random.key(0))
        kw = dict(method="svd", ratio=0.2, dtype="float32", use_randomized=False)
        jc = jax_compress_params(jparams, jax_build_plan(
            jmodel.compressible_targets(), JaxCompressionConfig(**kw)), JaxGramStore())
        tc = compress_params(to_t(jparams), build_plan(
            tmodel.compressible_targets(), CompressionConfig(**kw)), GramStore())
        assert dict(_shape_leaves(tc)) == dict(_shape_leaves(to_t(jc))), arch
