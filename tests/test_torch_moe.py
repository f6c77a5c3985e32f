"""Port parity for the token-choice MoE slice: the reduced
moonshot-v1-16b-a3b (a dense first layer, then two (gqa, moe) layers of 8
experts, top-2, one shared expert) against the JAX model, with the
reference's weights carried across by the bridge.

Held here: the dispatch (slot order, ranks, validity, the capacity buffer),
the top-k choices, ``moe_apply`` and its aux loss at lossless and at
dropping capacity and with nested-factored experts, the bf16 combine bit for
bit, the batched ``nested_lowrank`` and ``gram`` plain versions against the
reference's vmapped kernel (interpret mode) and its expert Gram update,
targets, per-expert and fallback Grams, compressed logits, the dense-slab
attention (decode and prefill), the serving layout queries and greedy
streams against the reference engine on the dense layout.

All fp32 on the CPU (the reduced config is fp32) unless a test says bf16;
inputs from numpy seeds.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import t2np, to_np, to_t

from repro.calib.gram import expert_gram_update as jax_expert_gram_update
from repro.calib.runner import collect_grams as jax_collect_grams
from repro.configs import get_config as jax_get_config
from repro.core import CompressionConfig as JaxCompressionConfig
from repro.core import GramStore as JaxGramStore
from repro.core import build_plan as jax_build_plan
from repro.core import compress_params as jax_compress_params
from repro.kernels.nested_lowrank.ops import nested_lowrank_matmul as jax_nested
from repro.models import attention as jax_attention
from repro.models import build_model as jax_build_model
from repro.models import moe as jax_moe
from repro.serving.engine import ServingEngine as JaxEngine
from repro.serving.scheduler import SchedulerConfig
from repro_torch.calib.runner import collect_grams
from repro_torch.configs import get_config
from repro_torch.core import CompressionConfig, GramStore, build_plan, compress_params
from repro_torch.kernels.gram.ops import gram_accumulate_batched
from repro_torch.kernels.nested_lowrank import ops as nlr_ops
from repro_torch.models import attention, build_model, cache_layout, moe, prefill_pad_safe
from repro_torch.serving.engine import ServingEngine

# fp32 on both sides, sums in other orders (the dense families' tolerance,
# tests/test_torch_model.py).
TOL = dict(rtol=1e-4, atol=1e-4)
# Products of a few fp32 terms (the router, one expert's FFN): a few ulps.
TIGHT = dict(rtol=1e-5, atol=1e-6)


def _cfgs(**moe_kw):
    jcfg = jax_get_config("moonshot-v1-16b-a3b").reduced()
    tcfg = get_config("moonshot-v1-16b-a3b").reduced()
    if moe_kw:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **moe_kw))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, **moe_kw))
    return jcfg, tcfg


def test_reduced_config_matches_reference():
    jcfg, tcfg = _cfgs()
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff", "vocab_size",
              "head_dim", "rope_theta", "norm", "activation", "dtype", "layer_specs"):
        want, got = getattr(jcfg, f), getattr(tcfg, f)
        assert (got() if callable(got) else got) == (want() if callable(want) else want), f
    for f in ("num_experts", "top_k", "d_ff_expert", "num_shared_experts", "first_k_dense",
              "moe_every", "capacity_factor", "router_dtype"):
        assert getattr(tcfg.moe, f) == getattr(jcfg.moe, f), f
    full_j, full_t = jax_get_config("moonshot-v1-16b-a3b"), get_config("moonshot-v1-16b-a3b")
    assert full_t.moe.__dict__ == full_j.moe.__dict__
    assert (full_t.d_model, full_t.vocab_size, full_t.d_ff, full_t.num_layers) == \
        (full_j.d_model, full_j.vocab_size, full_j.d_ff, full_j.num_layers)


# ------------------------------------------------------------ the MoE layer

@functools.lru_cache(maxsize=None)
def _layer(seed=0):
    jcfg, tcfg = _cfgs()
    jp = jax_moe.moe_init(jax.random.key(seed), jcfg, jnp.float32)
    return jcfg, tcfg, jp, to_t(jp)


def _routing(n, seed, e=8, k=2):
    """(x, top_w, top_i) from the reference's router on random tokens."""
    jcfg, _, jp, _ = _layer()
    x = np.random.default_rng(seed).standard_normal((n, jcfg.d_model)).astype(np.float32)
    probs = jax_moe.router_probs(jp, jnp.asarray(x))
    top_w, top_i = jax.lax.top_k(probs, k)
    return x, np.asarray(top_w), np.asarray(top_i)


@pytest.mark.parametrize("n,capacity", [(24, 48), (40, 8)])
def test_dispatch_matches_reference(n, capacity):
    """Lossless and dropping capacity: the same sorted slots, ranks,
    validity and (bit for bit) capacity buffer."""
    x, top_w, top_i = (a.copy() for a in _routing(n, seed=n))
    want = jax_moe._dispatch(jnp.asarray(x), jnp.asarray(top_w), jnp.asarray(top_i), 0, 8,
                             capacity)
    got = moe._dispatch(torch.as_tensor(x), torch.as_tensor(top_w),
                        torch.as_tensor(top_i).long(), 8, capacity)
    for f in ("valid", "sorted_e", "pos", "sorted_t", "sorted_w", "buf"):
        np.testing.assert_array_equal(t2np(getattr(got, f)), np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert (not bool(np.asarray(want.valid).all())) == (capacity < n), "drops as intended"


def test_top_k_picks_the_reference_experts():
    jcfg, _, jp, tp = _layer()
    x = np.random.default_rng(9).standard_normal((64, jcfg.d_model)).astype(np.float32)
    jprobs = jax_moe.router_probs(jp, jnp.asarray(x))
    tprobs = moe.router_probs(tp, torch.as_tensor(x))
    np.testing.assert_allclose(t2np(tprobs), np.asarray(jprobs), **TIGHT)
    jw, ji = jax.lax.top_k(jprobs, 2)
    tw, ti = torch.topk(tprobs, 2, dim=-1)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(t2np(tw), np.asarray(jw), **TIGHT)


@pytest.mark.parametrize("cf,tokens", [(8.0, 24), (1.25, 96)])
def test_moe_apply_matches_reference(cf, tokens):
    """Output and aux loss at lossless capacity (cf 8) and at cf 1.25 with
    enough tokens (capacity 30 for 192 slots over 8 experts) that slots
    drop."""
    jcfg, tcfg = _cfgs(capacity_factor=cf)
    _, _, jp, tp = _layer()
    x = np.random.default_rng(4).standard_normal((2, tokens // 2, jcfg.d_model))
    x = x.astype(np.float32)
    want, want_aux = jax_moe.moe_apply(jp, jnp.asarray(x), jcfg)
    got, got_aux = moe.moe_apply(tp, torch.as_tensor(x), tcfg)
    np.testing.assert_allclose(t2np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), **TIGHT)
    cap = moe.capacity_of(tokens, tcfg)
    probs = jax_moe.router_probs(jp, jnp.asarray(x.reshape(tokens, -1)))
    loads = np.bincount(np.asarray(jax.lax.top_k(probs, 2)[1]).ravel(), minlength=8)
    assert (loads.max() > cap) == (cf < 2), (loads, cap)


def test_routing_trace_replays_the_recorded_experts():
    """A replayed run takes the recorded run's experts (weights from its own
    router) and counts the tokens whose own choice differed; replaying on
    the same input changes nothing."""
    _, tcfg, _, tp = _layer()
    rng = np.random.default_rng(11)
    x = torch.as_tensor(rng.standard_normal((1, 16, tcfg.d_model)).astype(np.float32))
    y = torch.as_tensor(rng.standard_normal((1, 16, tcfg.d_model)).astype(np.float32))
    trace = moe.RoutingTrace()
    with trace.record():
        want, _ = moe.moe_apply(tp, x, tcfg)
    with trace.replay():
        got, _ = moe.moe_apply(tp, x, tcfg)
    assert trace.flips == 0 and torch.equal(got, want)
    with trace.replay():
        moe.moe_apply(tp, y, tcfg)
    own = torch.topk(moe.router_probs(tp, y[0]), 2, dim=-1).indices.sort(-1).values
    rec = trace.choices[0].sort(-1).values
    assert trace.flips == int((own != rec).any(-1).sum()) > 0
    with pytest.raises(RuntimeError, match="already active"), trace.record(), trace.replay():
        pass


def _nested_experts(jcfg, seed, dtype=np.float32):
    """Random nested factors for every expert linear: (E, in, k1) ... ."""
    rng = np.random.default_rng(seed)
    e, d, f = jcfg.moe.num_experts, jcfg.d_model, jcfg.moe.d_ff_expert
    out = {}
    for name, (i, o) in (("wi", (d, f)), ("wg", (d, f)), ("wo", (f, d))):
        k1, k2 = 6, 3
        out[name] = {"u": rng.standard_normal((e, i, k1)) / np.sqrt(i),
                     "v": rng.standard_normal((e, k1, o)) / np.sqrt(k1),
                     "u2": rng.standard_normal((e, i, k2)) / np.sqrt(i),
                     "v2": rng.standard_normal((e, k2, o)) / np.sqrt(k2)}
        out[name] = {k: v.astype(dtype) for k, v in out[name].items()}
    return out


def test_moe_apply_nested_experts_matches_reference():
    """Nested-factored experts: the batched nested form (its plain version
    here) against the reference's vmapped kernel oracle."""
    jcfg, tcfg = _cfgs()
    _, _, jp, _ = _layer()
    jp = dict(jp, experts={k: {n: jnp.asarray(a) for n, a in v.items()}
                           for k, v in _nested_experts(jcfg, 5).items()})
    tp = to_t(jp)
    x = np.random.default_rng(6).standard_normal((2, 11, jcfg.d_model)).astype(np.float32)
    before = nlr_ops.launches
    want, want_aux = jax_moe.moe_apply(jp, jnp.asarray(x), jcfg)
    got, got_aux = moe.moe_apply(tp, torch.as_tensor(x), tcfg)
    assert nlr_ops.launches == before  # the CPU takes the plain version
    np.testing.assert_allclose(t2np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), **TIGHT)


@pytest.mark.parametrize("n,capacity", [(24, 48), (40, 8)])
def test_combine_bf16_is_the_reference_bit_for_bit(n, capacity):
    """bf16 expert outputs: each token's k weighted slots added in the
    reference's scatter-add order, rounding to bf16 at every add."""
    x, top_w, top_i = _routing(n, seed=100 + n)
    disp = jax_moe._dispatch(jnp.asarray(x), jnp.asarray(top_w), jnp.asarray(top_i), 0, 8,
                             capacity)
    h = np.random.default_rng(n).standard_normal((8, capacity, x.shape[1])) * 3
    hj = jnp.asarray(h, jnp.bfloat16)
    want = jax_moe._combine(hj, disp, n)
    tdisp = moe.Dispatch(*(torch.as_tensor(np.array(a)) for a in disp))
    ht = to_t({"h": hj})["h"]
    got = moe._combine(ht, tdisp._replace(sorted_e=tdisp.sorted_e.long(),
                                          pos=tdisp.pos.long(),
                                          sorted_t=tdisp.sorted_t.long()), n)
    assert got.dtype == torch.bfloat16
    want_bits = np.asarray(want).view(np.uint16)
    got_bits = got.view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(got_bits, want_bits)


# ------------------------------------------------------- batched kernels

@pytest.mark.parametrize("dtype,rows", [(np.float32, 5), (np.float32, 24),
                                        (jnp.bfloat16, 8)])
def test_batched_nested_plain_matches_reference_kernel_interpret(dtype, rows):
    """The batched plain version against the reference's Pallas kernel
    vmapped over experts in interpret mode.  fp32: sum order; bf16: both
    round x@u, x@u2 and the output to bf16, at a few bf16 ulps of the
    output (the single form's NESTED_TOL in chip_smoke.py)."""
    rng = np.random.default_rng(rows)
    e, k_in, n, k1, k2 = 4, 64, 256, 12, 4
    args = [rng.standard_normal(s).astype(np.float32) * sc for s, sc in (
        ((e, rows, k_in), 1.0), ((e, k_in, k1), k_in ** -0.5), ((e, k1, n), k1 ** -0.5),
        ((e, k_in, k2), k_in ** -0.5), ((e, k2, n), k2 ** -0.5))]
    jargs = [jnp.asarray(a, dtype) for a in args]
    want = jax.vmap(functools.partial(jax_nested, interpret=True))(*jargs)
    got = nlr_ops.nested_lowrank_matmul_batched(*to_t({str(i): a for i, a in
                                                       enumerate(jargs)}).values())
    assert got.shape == (e, rows, n)
    w = np.asarray(want, np.float32)
    if dtype == np.float32:
        np.testing.assert_allclose(t2np(got), w, **TOL)
    else:
        assert np.abs(t2np(got) - w).max() <= 2e-2 * np.abs(w).max()


def test_batched_gram_plain_matches_reference_expert_update():
    """Per-expert Grams and sum |x| of a zero-padded capacity buffer."""
    rng = np.random.default_rng(3)
    buf = rng.standard_normal((8, 12, 32)).astype(np.float32)
    buf[:, 9:] = 0.0  # empty slots
    buf[5] = 0.0      # an expert that saw no token
    g, a, cnt = jax_expert_gram_update(jnp.asarray(buf))
    tg, ta = gram_accumulate_batched(torch.as_tensor(buf))
    np.testing.assert_allclose(t2np(tg), np.asarray(g), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t2np(ta), np.asarray(a), rtol=1e-5, atol=1e-5)
    assert (torch.as_tensor(buf) != 0).any(-1).sum(1).tolist() == np.asarray(cnt).tolist()


def test_plan_counts_the_batch():
    """At the full-width expert shapes (2048 -> 1408, rank 667) the batched
    form runs the kernel one expert would, with 64x the blocks, so its
    split-K depth drops: at decode rows to the fewest slices the stream
    kernel's 512-row x slice allows, at an eval batch's 960 rows to one
    slice of x @ [u|u2] and one each of v and v2."""
    k1, k2 = 634, 33
    single = nlr_ops.plan(8, torch.bfloat16, 2048, 1408, k1, k2, True)
    batched = nlr_ops.plan(8, torch.bfloat16, 2048, 1408, k1, k2, True, 64)
    assert single.kernel == batched.kernel == "stream"
    assert single.s1 > batched.s1 == 2048 // nlr_ops.STREAM_MAX_CHUNK
    assert single.s2 > batched.s2
    eval_batch = nlr_ops.plan(960, torch.bfloat16, 2048, 1408, k1, k2, True, 64)
    assert eval_batch.kernel == "mma" and (eval_batch.s1, eval_batch.s2) == (1, 2)
    assert nlr_ops.plan(960, torch.float32, 2048, 1408, k1, k2, True, 64).kernel == "tile"
    assert nlr_ops.plan(1025, torch.bfloat16, 2048, 1408, k1, k2, True, 64).kernel == "plain"


# ------------------------------------------------------------------ model

@functools.lru_cache(maxsize=None)
def _model(seed=0):
    jcfg, tcfg = _cfgs()
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    jparams = jmodel.init(jax.random.key(seed))
    return jmodel, tmodel, jparams, to_t(jparams)


def test_train_logits_match():
    jmodel, tmodel, jparams, tparams = _model()
    tokens = np.random.default_rng(1).integers(0, 256, (2, 21))
    want, _, _ = jmodel.apply(jparams, jnp.asarray(tokens, jnp.int32), mode="train")
    got = tmodel.apply(tparams, torch.as_tensor(tokens), mode="train")
    np.testing.assert_allclose(t2np(got), np.asarray(want), **TOL)


def test_compressible_targets_match():
    jmodel, tmodel, _, _ = _model()
    key = [(t.path, t.in_dim, t.out_dim, t.gram_key, t.stacked)
           for t in jmodel.compressible_targets()]
    assert [(t.path, t.in_dim, t.out_dim, t.gram_key, t.stacked)
            for t in tmodel.compressible_targets()] == key
    assert ("g1", "sub0", "moe", "experts", "wi") in [k[0] for k in key]
    assert dict((k[0], k[4]) for k in key)[("g1", "sub0", "moe", "experts", "wo")] == (2, 8)


@pytest.fixture(scope="module")
def calibrated(tmp_path_factory):
    jmodel, tmodel, jparams, tparams = _model()
    rng = np.random.default_rng(5)
    batches = [rng.integers(0, 256, (4, 16)).astype(np.int32) for _ in range(2)]
    jgrams = jax_collect_grams(jmodel, jparams, [{"tokens": jnp.asarray(b)} for b in batches])
    tgrams = collect_grams(tmodel, tparams, batches)
    path = str(tmp_path_factory.mktemp("grams") / "grams.npz")
    jgrams.save(path)
    return jgrams, tgrams, path


def test_collect_grams_match_per_expert_and_fallback(calibrated):
    """The reference's key set (per expert "{base}/{layer}/{e}" and the
    shared fallback "{base}"), Grams, absmeans and counts."""
    jgrams, tgrams, _ = calibrated
    assert set(tgrams.keys()) == set(jgrams.keys())
    expert = [k for k in jgrams.keys() if "expert_buf/" in k]
    assert len(expert) == 2 * 8 and "g1/sub0.moe.expert_buf/1/7" in expert
    for k in jgrams.keys():
        want = np.asarray(jgrams.gram(k))
        np.testing.assert_allclose(t2np(tgrams.gram(k)), want, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(want).max(), 1e-30), err_msg=k)
        np.testing.assert_allclose(t2np(tgrams.absmean(k)), np.asarray(jgrams.absmean(k)),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
        assert tgrams.count(k) == jgrams.count(k), k
    # Lossless capacity: a layer's expert counts sum to its routed slots (2
    # batches of 4 x 16 tokens, top-2); the fallback sums both layers.
    counts = [tgrams.count(f"g1/sub0.moe.expert_buf/0/{e}") for e in range(8)]
    assert sum(counts) == 2 * 4 * 16 * 2 == tgrams.count("g1/sub0.moe.expert_buf") / 2


def test_stacked_store_updates_read_as_separate_keys():
    """``update_stacked`` sums into one (E, n, n) tensor; its keys read as
    if each had been updated alone."""
    rng = np.random.default_rng(8)
    a, b = (torch.as_tensor(rng.standard_normal((3, 4, 4))) for _ in range(2))
    sa, sb = (torch.as_tensor(rng.standard_normal((3, 4))) for _ in range(2))
    keys = ["t/0", "t/1", "t/2"]
    stacked, plain = GramStore(), GramStore()
    stacked.update_stacked(keys, a, sa, [1.0, 2.0, 3.0])
    stacked.update_stacked(keys, b, sb, [4.0, 0.0, 1.0])
    for e, k in enumerate(keys):
        plain.update(k, a[e], sa[e], [1.0, 2.0, 3.0][e])
        plain.update(k, b[e], sb[e], [4.0, 0.0, 1.0][e])
        assert torch.equal(stacked.gram(k), plain.gram(k))
        assert torch.equal(stacked.absmean(k), plain.absmean(k))
        assert stacked.count(k) == plain.count(k)


@pytest.mark.parametrize("grams_from", ["reference", "port"])
def test_compressed_logits_match(calibrated, grams_from):
    """nsvd1 at ratio 0.2 (min_dim 8, per-expert Grams with the shared
    fallback): the reference's compressed forward against the port's, on
    the port's own compression from the reference's GramStore file or from
    its own calibration.  Factors differ by SVD signs only, so the logits
    agree to sum order (fp32)."""
    jmodel, tmodel, jparams, tparams = _model()
    jgrams, tgrams, path = calibrated
    kw = dict(method="nsvd1", ratio=0.2, dtype="float32", use_randomized=False, min_dim=8)
    jplan = jax_build_plan(jmodel.compressible_targets(), JaxCompressionConfig(**kw))
    tplan = build_plan(tmodel.compressible_targets(), CompressionConfig(**kw))
    assert tplan.summary() == jplan.summary()
    jc = jax_compress_params(jparams, jplan, JaxGramStore.load(path))
    tc = compress_params(tparams, tplan, GramStore.load(path, device="cpu")
                         if grams_from == "reference" else tgrams)
    assert set(tc["g1"]["sub0"]["moe"]["experts"]["wi"]) == {"u", "v", "u2", "v2"}
    assert tc["g1"]["sub0"]["moe"]["experts"]["wi"]["u"].shape[:2] == (2, 8)
    tokens = np.random.default_rng(2).integers(0, 256, (2, 19))
    want, _, _ = jmodel.apply(jc, jnp.asarray(tokens, jnp.int32), mode="train")
    got = tmodel.apply(tc, torch.as_tensor(tokens), mode="train")
    np.testing.assert_allclose(t2np(got), np.asarray(want), **TOL)
    # And the reference's factors, carried across, through the port's forward.
    np.testing.assert_allclose(t2np(tmodel.apply(to_t(to_np(jc)), torch.as_tensor(tokens),
                                                 mode="train")), np.asarray(want), **TOL)


# --------------------------------------------------- dense-slab attention

def _attn(seed=3):
    jcfg, tcfg = _cfgs()
    jp = jax_attention.attention_init(jax.random.key(seed), jcfg, jnp.float32)
    return jcfg, tcfg, jp, to_t(jp)


def test_slab_prefill_then_decode_match_reference():
    """Causal prefill writing a fresh slab (K/V padded to max_len), then a
    one-token decode step and a three-token chunk whose last position runs
    past max_len in one row (that write drops): outputs and slabs."""
    jcfg, tcfg, jp, tp = _attn()
    b, s0, t_max = 2, 9, 14
    rng = np.random.default_rng(7)
    jcache = {"k": jnp.ones((b, t_max, 4, 8)), "v": jnp.ones((b, t_max, 4, 8))}
    tcache = {k: torch.ones((b, t_max, 4, 8)) for k in ("k", "v")}  # stale rows: overwritten
    x = rng.standard_normal((b, s0, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s0), (b, s0))
    jy, jcache = jax_attention.attention_apply(jp, jnp.asarray(x), jcfg, jnp.asarray(pos),
                                               mode="causal", cache=jcache)
    ty = attention.attention_apply(tp, torch.as_tensor(x), tcfg, torch.as_tensor(pos),
                                   mode="causal", cache=tcache)
    np.testing.assert_allclose(t2np(ty), np.asarray(jy), **TOL)
    clen = np.array([s0, 12], np.int32)
    for s in (1, 3):
        x = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32)
        pos = clen[:, None] + np.arange(s)
        jy, jcache = jax_attention.attention_apply(
            jp, jnp.asarray(x), jcfg, jnp.asarray(pos), mode="decode", cache=jcache,
            cache_len=jnp.asarray(clen))
        ty = attention.attention_apply(tp, torch.as_tensor(x), tcfg, torch.as_tensor(pos),
                                       mode="decode", cache=tcache,
                                       cache_len=torch.as_tensor(clen))
        np.testing.assert_allclose(t2np(ty), np.asarray(jy), **TOL, err_msg=f"S={s}")
        for leaf in ("k", "v"):
            np.testing.assert_allclose(t2np(tcache[leaf]), np.asarray(jcache[leaf]), **TOL,
                                       err_msg=f"S={s} {leaf}")
        clen = clen + s
    assert clen[1] > t_max  # row 1's last write ran past the slab


def _cache_leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _cache_leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def test_model_prefill_then_decode_match():
    """The whole model: prefill two prompts into a fresh dense cache, then
    two decode steps; logits and every slab leaf (stacked MoE layers
    included)."""
    jmodel, tmodel, jparams, tparams = _model()
    rng = np.random.default_rng(12)
    prompt = rng.integers(0, 256, (2, 13))
    jcache = jmodel.init_cache(2, 24)
    tcache = tmodel.init_cache(2, 24, device="cpu")
    jl, jcache, _ = jmodel.apply(jparams, jnp.asarray(prompt, jnp.int32), mode="prefill",
                                 cache=jcache)
    tl = tmodel.apply(tparams, torch.as_tensor(prompt), mode="prefill", cache=tcache)
    np.testing.assert_allclose(t2np(tl), np.asarray(jl), **TOL)
    clen = np.full(2, 13, np.int32)
    for _ in range(2):
        step = rng.integers(0, 256, (2, 1))
        jd, jcache, _ = jmodel.apply(jparams, jnp.asarray(step, jnp.int32), mode="decode",
                                     cache=jcache, cache_len=jnp.asarray(clen))
        td = tmodel.apply(tparams, torch.as_tensor(step), mode="decode", cache=tcache,
                          cache_len=torch.as_tensor(clen))
        np.testing.assert_allclose(t2np(td), np.asarray(jd), **TOL)
        clen = clen + 1
    want, got = dict(_cache_leaves(to_np(jcache))), dict(_cache_leaves(tcache))
    assert want.keys() == got.keys()
    for name, w in want.items():
        np.testing.assert_allclose(t2np(got[name]), w, **TOL, err_msg=name)


# ---------------------------------------------------------------- serving

def test_layout_queries_and_paged_refusal():
    """As tests/test_paged_kvcache.py and tests/test_serving_engine.py hold
    the reference: MoE is pad-sensitive and serves on the dense layout;
    asking for pages is refused with the reference's message; ``kv_quant``
    makes its slab's K/V int8 (tests/test_torch_slab_int8.py holds that slab
    against the reference's)."""
    _, tmodel, _, tparams = _model()
    assert cache_layout(tmodel) == "dense" and not prefill_pad_safe(tmodel)
    eng = ServingEngine(tmodel, tparams, max_batch=2, max_len=64)
    assert eng.layout == "dense" and eng.kv is None
    with pytest.raises(ValueError, match="cache layout"):
        ServingEngine(tmodel, tparams, max_batch=2, max_len=64, paged=True)
    eng = ServingEngine(tmodel, tparams, max_batch=2, max_len=64, kv_quant=True)
    slab = eng.cache["g1"]["sub0"]["attn"]
    assert eng.layout == "dense" and slab["k"].dtype == torch.int8
    assert slab["k_scale"].shape == slab["k"].shape[:-1]


def _min_margin(jmodel, jparams, prompt, gen):
    """Smallest top-2 logit gap over the reference's greedy choices."""
    seq = np.concatenate([prompt, gen[:-1]]).astype(np.int32)
    logits, _, _ = jmodel.apply(jparams, jnp.asarray(seq)[None], mode="train")
    steps = np.asarray(logits[0, len(prompt) - 1:])
    top2 = np.sort(steps, axis=-1)[:, -2:]
    return float((top2[:, 1] - top2[:, 0]).min())


def test_greedy_streams_match_reference_engine():
    """Dense layout, exact-length admission, lossless capacity: the port's
    streams equal the reference engine's (worst-case admission, pipeline
    depth 1); every request finishes, one host sync per step and
    admission.  The top-2 margin is checked first (ROADMAP C)."""
    jmodel, tmodel, jparams, _ = _model(1)
    jparams = dict(jparams, unembed={"kernel": jparams["unembed"]["kernel"] * 8.0})
    tparams = to_t(jparams)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, 200, size=n) for n in (5, 11, 7)]
    kw = dict(max_batch=2, max_len=32)
    ref = JaxEngine(jmodel, jparams, pipeline_depth=1,
                    sched_config=SchedulerConfig(admission="worst_case"), **kw)
    eng = ServingEngine(tmodel, tparams, **kw)
    ref_ids = [ref.submit(p, max_new_tokens=6) for p in prompts]
    ids = [eng.submit(p, max_new_tokens=6) for p in prompts]
    want, got = ref.run(), eng.run()
    for p, rid in zip(prompts, ref_ids):
        assert _min_margin(jmodel, jparams, p, want[rid]) > 50 * TOL["atol"]
    assert [got[i] for i in ids] == [want[i] for i in ref_ids]
    assert all(r.finish_reason == "stop" for r in eng.finished_requests.values())
    st = eng.stats()
    assert st["prefill_ticks"] == 3 and st["host_syncs"] == st["steps"] + 3


def test_attention_stack_streams_equal_on_slab_and_pages():
    """The reference's layout contract (tests/test_paged_kvcache.py): greedy
    streams are the same on the dense slab (``paged=False``: exact-length
    admission, slab decode) as on the paged pools, for a pure-attention
    stack on the port's own weights."""
    from torch_parity import tiny_cfgs

    _, tcfg = tiny_cfgs("small-mistral", d_model=32, d_ff=48, vocab=64)
    tmodel = build_model(tcfg)
    tparams = tmodel.init(0, device="cpu")
    tparams["unembed"]["kernel"] = tparams["unembed"]["kernel"] * 8.0
    prompts = [np.random.default_rng(s).integers(2, 60, size=n)
               for s, n in enumerate((4, 19, 9))]
    streams = {}
    for paged in (True, False):
        eng = ServingEngine(tmodel, tparams, max_batch=2, max_len=40, block_size=8,
                            prefill_chunk=8, paged=paged)
        assert eng.layout == ("paged" if paged else "dense")
        ids = [eng.submit(p, max_new_tokens=8) for p in prompts]
        out = eng.run()
        streams[paged] = [out[i] for i in ids]
    assert streams[True] == streams[False]
