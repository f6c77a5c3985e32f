"""Port parity for the int8 dense K/V slab (``kv_quant`` on the dense
layout): the reference's symmetric per-(position, head) int8 quantization
with fp32 scales, written at prefill (which attends with its own
full-precision K/V) and at decode (which attends over the whole slab
dequantized to q's dtype).  Held against the JAX package on the same
numpy-seeded inputs and weights: the quantizer; the attention's slab
prefill, decode and a chunk whose last write drops; the whole model's
prefill and decode steps on the reduced moonshot-v1-16b-a3b (token-choice
MoE), jamba-v0.1-52b (only its GQA layer's slab is int8; the Mamba state
keeps fp32) and whisper-small (the decoder's self slab int8, the cross
slab fp32); and the engine's greedy streams on the int8 slab (MoE and
jamba with exact-length admission, an attention stack with ``paged=False``
and bucketed admission).  Also the engine's refusal where a model's cache
holds no K/V (RWKV-6, MLA), its bytes a token, and the dense re-prefill
budget the port copies from the reference (ROADMAP C).

What is held, and to what: int8 values within 1 LSB (the two frameworks'
K/V differ in their last fp32 bits, which can move a value across a
rounding point); scales at rtol 1e-6 where both quantize K/V computed from
the same inputs (the quantizer, one attention layer), and in a whole model
at the fp32 K/V's own tolerance (a deeper layer's input already differs
by the frameworks' summation order); outputs and logits at the dense
families' fp32 tolerance; streams exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import t2np, tiny_cfgs, to_np, to_t, tiny_rwkv

from repro.configs import get_config as jax_get_config
from repro.models import attention as jax_attention
from repro.models import build_model as jax_build_model
from repro.serving import faults as jax_faults
from repro.serving.engine import ServingEngine as JaxEngine
from repro.serving.scheduler import SchedulerConfig as JaxSchedulerConfig
from repro_torch.configs import get_config
from repro_torch.models import attention, build_model
from repro_torch.models.api import cache_bytes_per_token
from repro_torch.serving import faults as torch_faults
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.scheduler import SchedulerConfig

# fp32 on both sides, sums in other orders (the dense families' tolerance).
TOL = dict(rtol=1e-4, atol=1e-4)
SCALE_RTOL = 1e-6
LSB = 1  # int8 values: at most one step apart


def _int8_close(got, want, what=""):
    diff = np.abs(got.numpy().astype(np.int32) - np.asarray(want).astype(np.int32))
    assert diff.max() <= LSB, f"{what}: int8 values {diff.max()} apart"


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def _slabs_close(tcache, jcache, scale_tol=dict(rtol=SCALE_RTOL, atol=0)):
    """Every leaf of the port's slab against the reference's: int8 within
    1 LSB, scales at ``scale_tol``, everything else at TOL."""
    want, got = dict(_leaves(to_np(jcache))), dict(_leaves(tcache))
    assert want.keys() == got.keys()
    for name, w in want.items():
        g = got[name]
        assert str(g.dtype).replace("torch.", "") == str(w.dtype), name
        if g.dtype == torch.int8:
            _int8_close(g, w, name)
        elif name.endswith("_scale"):
            np.testing.assert_allclose(t2np(g), w, **scale_tol, err_msg=name)
        else:
            np.testing.assert_allclose(t2np(g), w, **TOL, err_msg=name)
    return got


# ------------------------------------------------------------------ quantizer

def test_quantize_kv_matches_reference():
    """Per-vector max/127 scales (floored at 1e-8: an all-zero vector),
    round-half-even, clip to +-127: the port's quantizer on the same fp32
    vectors gives the reference's int8 values and scales exactly, and its
    dequantization the same values."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 7, 4, 8)).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[1, 2, 3] = np.array([127, -63.5, 0.5, 1.5, -2.5, 3, 4, 5], np.float32)  # ties
    jq, js = jax_attention._quantize_kv(jnp.asarray(x))
    tq, ts = attention.quantize_kv(torch.as_tensor(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert float(ts[0, 0, 0]) == pytest.approx(1e-8)
    np.testing.assert_array_equal(
        t2np(attention.dequantize_kv(tq, ts, torch.float32)),
        np.asarray(jax_attention._dequantize_kv(jq, js, jnp.float32)))


# ------------------------------------------------------------------ attention

def test_attention_int8_slab_prefill_then_decode_match_reference():
    """The reduced MoE's attention on an int8 slab: the prefill's output is
    the full-precision one (it attends with its own K/V) and its slab the
    quantized K/V padded with zeros; then a one-token decode step and a
    three-token chunk whose last position runs past max_len in one row
    (that write drops), each attending over the dequantized slab."""
    jcfg = jax_get_config("moonshot-v1-16b-a3b").reduced()
    tcfg = get_config("moonshot-v1-16b-a3b").reduced()
    jp = jax_attention.attention_init(jax.random.key(3), jcfg, jnp.float32)
    tp = to_t(jp)
    b, s0, t_max = 2, 9, 14
    rng = np.random.default_rng(7)
    jcache = jax_attention.init_kv_cache(jcfg, b, t_max, jnp.float32, quant=True)
    tcache = attention.init_kv_cache(tcfg, b, t_max, torch.float32, "cpu", quant=True)
    for c in tcache.values():  # stale rows: the prefill overwrites them
        c.fill_(1)
    x = rng.standard_normal((b, s0, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s0), (b, s0))
    jy, jcache = jax_attention.attention_apply(jp, jnp.asarray(x), jcfg, jnp.asarray(pos),
                                               mode="causal", cache=jcache)
    ty = attention.attention_apply(tp, torch.as_tensor(x), tcfg, torch.as_tensor(pos),
                                   mode="causal", cache=tcache)
    plain = attention.attention_apply(tp, torch.as_tensor(x), tcfg, torch.as_tensor(pos),
                                      mode="causal")
    np.testing.assert_allclose(t2np(ty), np.asarray(jy), **TOL)
    assert torch.equal(ty, plain)
    _slabs_close(tcache, jcache)
    assert not tcache["k"][:, s0:].any() and not tcache["k_scale"][:, s0:].any()
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
        _slabs_close(tcache, jcache)
        clen = clen + s
    assert clen[1] > t_max  # row 1's last write ran past the slab


# ------------------------------------------------------------------ models

def _whisper_frames(b, seed):
    return np.random.default_rng(seed).standard_normal((b, 16, 32)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _model(arch):
    jmodel = jax_build_model(jax_get_config(arch).reduced())
    tmodel = build_model(get_config(arch).reduced())
    jparams = jmodel.init(jax.random.key(0))
    return jmodel, jparams, tmodel, to_t(jparams)


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "jamba-v0.1-52b", "whisper-small"])
def test_model_int8_slab_prefill_then_decode_match_reference(arch):
    """Prefill two prompts into a fresh int8 slab, then two decode steps:
    the logits and every slab leaf after each call.  Each decode step runs
    on the reference's slab as the previous call left it (copied into the
    port's), so that a value one LSB apart (a rounding point crossed; it
    moves a dequantized key by a whole scale step) cannot hide a fault in
    the decode's own arithmetic.  Only GQA self-attention slabs are
    int8 (the MoE's; jamba's attention layer's, beside its Mamba ``h`` and
    ``conv`` in fp32; whisper's decoder self slab, beside its fp32 cross
    slab), as the reference's ``init_cache(kv_quant=True)`` makes them."""
    jmodel, jparams, tmodel, tparams = _model(arch)
    rng = np.random.default_rng(12)
    prompt = rng.integers(0, 256, (2, 13))
    kw, tkw = {}, {}
    if arch == "whisper-small":
        fr = _whisper_frames(2, 3)
        kw, tkw = {"frames": jnp.asarray(fr)}, {"frames": torch.as_tensor(fr)}
    jcache = jmodel.init_cache(2, 24, kv_quant=True)
    tcache = tmodel.init_cache(2, 24, device="cpu", kv_quant=True)
    jl, jcache, _ = jmodel.apply(jparams, jnp.asarray(prompt, jnp.int32), mode="prefill",
                                 cache=jcache, **kw)
    tl = tmodel.apply(tparams, torch.as_tensor(prompt), mode="prefill", cache=tcache, **tkw)
    np.testing.assert_allclose(t2np(tl), np.asarray(jl), **TOL)
    clen = np.full(2, 13, np.int32)
    for _ in range(2):
        got = _slabs_close(tcache, jcache, TOL)
        want = dict(_leaves(to_np(jcache)))
        for name, leaf in got.items():
            leaf.copy_(torch.as_tensor(want[name]))
        step = rng.integers(0, 256, (2, 1))
        jd, jcache, _ = jmodel.apply(jparams, jnp.asarray(step, jnp.int32), mode="decode",
                                     cache=jcache, cache_len=jnp.asarray(clen))
        td = tmodel.apply(tparams, torch.as_tensor(step), mode="decode", cache=tcache,
                          cache_len=torch.as_tensor(clen))
        np.testing.assert_allclose(t2np(td), np.asarray(jd), **TOL)
        clen = clen + 1
    got = _slabs_close(tcache, jcache, TOL)
    int8 = sorted(k for k, v in got.items() if v.dtype == torch.int8)
    assert int8 and all(k.endswith(("attn/k", "attn/v")) for k in int8)
    assert not any(v.dtype == torch.int8 for k, v in got.items() if "/cross/" in k)


# ------------------------------------------------------------------ engine

def _spread(arch, seed=1):
    jmodel = jax_build_model(jax_get_config(arch).reduced())
    jparams = jmodel.init(jax.random.key(seed))
    jparams["unembed"]["kernel"] = jparams["unembed"]["kernel"] * 8.0
    return jmodel, jparams, build_model(get_config(arch).reduced()), to_t(jparams)


@functools.lru_cache(maxsize=None)
def _engine_model(kind):
    """Reference and port models with spread logits (greedy choices not
    near-ties): the reduced MoE, the reduced jamba, or a tiny Mistral
    served with ``paged=False`` (bucketed admission)."""
    if kind == "mistral-dense":
        jcfg, tcfg = tiny_cfgs("small-mistral", d_model=32, d_ff=48, vocab=64)
        jmodel = jax_build_model(jcfg)
        jparams = jmodel.init(jax.random.key(1))
        jparams["unembed"]["kernel"] = jparams["unembed"]["kernel"] * 8.0
        return jmodel, jparams, build_model(tcfg), to_t(jparams)
    return _spread(kind)


@pytest.mark.parametrize("kind", ["moonshot-v1-16b-a3b", "jamba-v0.1-52b", "mistral-dense"])
def test_engine_int8_slab_streams_match_reference(kind):
    """The engine on the int8 dense slab (``kv_quant=True``): greedy
    streams equal the reference engine's on its int8 slab (worst case,
    depth 1), admissions exact-length (MoE, jamba) or bucketed with their
    padding rows dropped (the attention stack with ``paged=False``); every
    request finishes; the engine's slab is int8 where the model's
    attention K/V are, and its bytes a token are the reference slab's."""
    jmodel, jparams, tmodel, tparams = _engine_model(kind)
    vocab = tmodel.cfg.vocab_size
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, vocab // 2, size=n) for n in (5, 11, 7, 3)]
    kw = dict(max_batch=3, max_len=32, kv_quant=True)
    if kind == "mistral-dense":
        kw["paged"] = False
    ref = JaxEngine(jmodel, jparams, pipeline_depth=1,
                    sched_config=JaxSchedulerConfig(admission="worst_case"), **kw)
    eng = ServingEngine(tmodel, tparams, pipeline_depth=1,
                        sched_config=SchedulerConfig(admission="worst_case"), **kw)
    assert eng.layout == "dense" and eng._bucketed == (kind == "mistral-dense")
    ref_ids = [ref.submit(p, max_new_tokens=6) for p in prompts]
    ids = [eng.submit(p, max_new_tokens=6) for p in prompts]
    want, got = ref.run(), eng.run()
    assert [got[i] for i in ids] == [want[i] for i in ref_ids]
    assert all(r.finish_reason == "stop" and len(r.generated) == 6
               for r in eng.finished_requests.values())
    leaves = dict(_leaves(eng.cache))
    assert {str(v.dtype) for k, v in leaves.items() if k.endswith(("/k", "/v"))} == {
        "torch.int8"}
    ref_bytes = sum(int(np.asarray(v).nbytes) for _, v in _leaves(to_np(ref.cache)))
    port_bytes = sum(v.numel() * v.element_size() for v in leaves.values())
    assert port_bytes == ref_bytes
    assert eng.cache_stats()["bytes_per_token"] == cache_bytes_per_token(tmodel, True)


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "jamba-v0.1-52b",
                                  "llava-next-mistral-7b"])
def test_bytes_per_token_of_the_int8_slab(arch):
    """The slab's bytes a token (``cache_stats()["bytes_per_token"]``): per
    GQA layer 2 x Hkv x hd bytes of int8 K/V and 2 x Hkv x 4 of scales,
    against 2 x Hkv x hd x 4 in fp32; llava's (no cache leaf of its own)
    equals its backbone's.  Counted on the full-width config's meta slab
    too: Mistral-7B's 32 layers, 8 KV heads of 128, take 67584 B a token in
    int8 against 131072 in bf16."""
    tmodel = build_model(get_config(arch).reduced())
    cfg = tmodel.cfg
    gqa = sum(m == "gqa" for m, _ in tmodel.specs)
    hkv, hd = cfg.num_kv_heads, cfg.head_dim
    assert cache_bytes_per_token(tmodel, True) - cache_bytes_per_token(tmodel) == (
        gqa * 2 * hkv * (hd + 4) - gqa * 2 * hkv * hd * 4)
    eng = ServingEngine(tmodel, tmodel.init(0, "cpu"), max_batch=2, max_len=16,
                        kv_quant=True, paged=False)
    assert eng.cache_stats()["bytes_per_token"] == cache_bytes_per_token(tmodel, True)
    if arch == "llava-next-mistral-7b":
        full = build_model(get_config(arch))
        assert cache_bytes_per_token(full, True) == 32 * 2 * 8 * (128 + 4) == 67584
        assert cache_bytes_per_token(full) == 32 * 2 * 8 * 128 * 2


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "minicpm3-4b"])
def test_engine_refuses_int8_without_attention_kv(arch):
    """A dense cache holding no attention K/V (RWKV-6's recurrent state,
    MLA's latents) has nothing to quantize: the engine refuses
    ``kv_quant`` with a ValueError where the reference quantizes nothing
    (ROADMAP C, differences by design)."""
    tmodel = build_model(get_config(arch).reduced())
    with pytest.raises(ValueError, match="kv_quant quantizes attention K/V"):
        ServingEngine(tmodel, tmodel.init(0, "cpu"), max_batch=2, max_len=16,
                      kv_quant=True)


# ------------------------------------------------------------------ re-prefill budget

def test_dense_reprefill_budget_copies_reference():
    """A dense-layout row retried after a poisoned step re-prefills its
    prompt with the generated tokens folded in, and both engines set its
    device budget to ``max_new_tokens - 1`` there (reference
    ``serving/engine.py:1314``), not to what is left of it: so the host
    ends the row (``req.done``), while the device still holds it active
    with a budget of the tokens generated before the retry.  A row the
    device ends has budget 0 and is inactive.  Streams and reasons are the
    reference's (RWKV-6, reduced, exact-length admission; ROADMAP C)."""
    jmodel, jparams, tmodel, tparams = tiny_rwkv("dense")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(2, 120, size=n) for n in (6, 9)]
    max_new = 10
    out = []
    for cls, faults, model, params, active in (
            (JaxEngine, jax_faults, jmodel, jparams, "_active_dev"),
            (ServingEngine, torch_faults, tmodel, tparams, "active_dev")):
        eng = cls(model, params, max_batch=2, max_len=48, pipeline_depth=1,
                  faults=faults.FaultPlan([faults.FaultSpec(kind="poison_logits", step=3,
                                                            uid=1)]),
                  fault_policy=faults.FaultPolicy(max_retries=1, retry_backoff_steps=1))
        budgets = []
        call = eng._prefill

        def recorded(params, cache, tokens, plens, slots, budget, *rest, call=call):
            budgets.append((int(np.asarray(plens)[0]), int(np.asarray(budget)[0])))
            return call(params, cache, tokens, plens, slots, budget, *rest)
        eng._prefill = recorded
        uids = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
        eng.run()
        reqs = [eng.finished_requests[u] for u in uids]
        dev_budget = np.asarray(eng.budget_dev).astype(int)
        dev_active = np.asarray(getattr(eng, active)).astype(bool)
        out.append(([r.generated for r in reqs], [r.finish_reason for r in reqs], budgets,
                    [(int(dev_budget[r.slot]), bool(dev_active[r.slot])) for r in reqs]))
    (streams, reasons, budgets, device), port = out
    assert port == out[0]
    assert reasons == ["stop", "stop"] and all(len(s) == max_new for s in streams)
    # The first admissions, then uid 1's re-prefill of its prompt and the
    # tokens it had before the poisoned step: the full budget again.
    (p0, b0), (p1, b1), (p_re, b_re) = budgets
    assert (p0, p1) == (6, 9) and b0 == b1 == b_re == max_new - 1
    before = p_re - 9
    assert 0 < before < max_new - 1
    assert device == [(0, False), (before, True)]
