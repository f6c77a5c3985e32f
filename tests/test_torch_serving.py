"""Port parity for the serving slice: greedy streams of the port's engine
equal the reference engine's (worst-case admission, pipeline depth 1), on
dense and NSVD-compressed weights, with fp32 and int8 KV pools (paged
layout) and for RWKV-6 on the dense recurrent-state slab; device-side EOS
exits; the temperature-stream invariant; and the allocator the port
copies."""

import jax.numpy as jnp
import numpy as np
import pytest
from torch_parity import tiny_cfgs, tiny_lm, tiny_rwkv

from repro.serving.engine import ServingEngine as JaxEngine
from repro.serving.scheduler import SchedulerConfig
from repro_torch.models import build_model, cache_layout, prefill_pad_safe
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.kvcache import BlockAllocator

LOGIT_TOL = 1e-4  # fp32 logits agree to this (tests/test_torch_model.py)
PROMPT_LENS = (3, 17, 9, 30, 12)


@pytest.fixture(params=["dense", "nsvd1"])
def lm(request):
    return tiny_lm(request.param)


@pytest.fixture
def dense_lm():
    return tiny_lm("dense")


def _prompts(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, 60, size=n) for n in PROMPT_LENS]


def _min_margin(jmodel, jparams, prompt, gen):
    """Smallest top-2 logit gap over the reference's greedy choices."""
    seq = np.concatenate([prompt, gen[:-1]]).astype(np.int32)
    logits, _, _ = jmodel.apply(jparams, jnp.asarray(seq)[None], mode="train")
    steps = np.asarray(logits[0, len(prompt) - 1:])
    top2 = np.sort(steps, axis=-1)[:, -2:]
    return float((top2[:, 1] - top2[:, 0]).min())


@pytest.mark.parametrize("kv_quant", [False, True])
def test_greedy_streams_match_reference_engine(lm, kv_quant):
    jmodel, jparams, tmodel, tparams = lm
    kw = dict(max_batch=3, max_len=48, block_size=8, prefill_chunk=8,
              kv_quant=kv_quant)
    ref = JaxEngine(jmodel, jparams, pipeline_depth=1,
                    sched_config=SchedulerConfig(admission="worst_case"), **kw)
    eng = ServingEngine(tmodel, tparams, **kw)
    ref_ids = [ref.submit(p, max_new_tokens=10) for p in _prompts()]
    ids = [eng.submit(p, max_new_tokens=10) for p in _prompts()]
    want, got = ref.run(), eng.run()
    for p, rid in zip(_prompts(), ref_ids):
        assert _min_margin(jmodel, jparams, p, want[rid]) > 50 * LOGIT_TOL
    assert [got[i] for i in ids] == [want[i] for i in ref_ids]
    assert all(r.finish_reason == "stop" for r in eng.finished_requests.values())
    assert eng.kv.alloc.in_use() == 0  # every block came back
    # One host sync per decode step (plus one per finishing prefill chunk).
    st = eng.stats()
    assert st["host_syncs"] <= st["steps"] + st["prefill_ticks"]


def _solo(tmodel, tparams, prompt, max_new, **kw):
    eng = ServingEngine(tmodel, tparams, max_batch=1, max_len=64, **kw)
    uid = eng.submit(prompt, max_new_tokens=max_new)
    return eng.run()[uid]


def test_eos_stops_row_on_device(dense_lm):
    """The stream stops at the FIRST occurrence of the eos token, which it
    includes; the device cleared the row's active flag and froze its
    length in that same step.  (The eos is a token first sampled by a decode
    step: one sampled at prefill retires the row on the host instead.)"""
    _, _, tmodel, tparams = dense_lm
    for seed in range(11, 31):  # a prompt whose stream has a fresh token
        p = np.random.default_rng(seed).integers(2, 60, size=7)
        full = _solo(tmodel, tparams, p, 8)
        fresh = [t for j, t in enumerate(full) if j >= 1 and t not in full[:j]]
        if fresh:
            break
    eos = fresh[0]
    eng = ServingEngine(tmodel, tparams, max_batch=1, max_len=64)
    uid = eng.submit(p, max_new_tokens=8, eos_id=eos)
    out = eng.run()
    assert out[uid] == full[:full.index(eos) + 1]
    assert not bool(eng.active_dev[0])
    assert int(eng.cache_len[0]) == len(p) + len(out[uid]) - 1


def test_max_len_exit():
    _, tcfg = tiny_cfgs("small-llama", d_model=32, d_ff=48, vocab=64)
    tmodel = build_model(tcfg)
    tparams = tmodel.init(0, device="cpu")
    eng = ServingEngine(tmodel, tparams, max_batch=2, max_len=24)
    uid = eng.submit(np.arange(2, 20), max_new_tokens=50)
    out = eng.run()[uid]
    assert len(out) == 24 - 1 - 18 + 1  # stops when the cache reaches max_len-1


def test_temperature_stream_depends_only_on_seed_uid_prompt(dense_lm):
    """A sampled stream is the same alone and inside a batch (other slot,
    other admission timing); another engine seed gives another stream."""
    _, _, tmodel, tparams = dense_lm
    prompts = _prompts(4)

    def run(seed):
        eng = ServingEngine(tmodel, tparams, max_batch=3, max_len=48,
                            seed=seed, prefill_chunk=8)
        ids = [eng.submit(p, max_new_tokens=8, temperature=1.0) for p in prompts]
        out = eng.run()
        return [out[u] for u in ids], ids

    batched, ids = run(5)
    for i in range(5):
        eng = ServingEngine(tmodel, tparams, max_batch=1, max_len=48, seed=5,
                            prefill_chunk=8)
        eng._uid = iter([ids[i]])  # same uid as in the batched run
        uid = eng.submit(prompts[i], max_new_tokens=8, temperature=1.0)
        assert eng.run()[uid] == batched[i]
    other, _ = run(6)
    assert other != batched


def test_allocator_alloc_free_reuse():
    a = BlockAllocator(8)
    assert a.alloc("r0", 3) == [0, 1, 2] and a.in_use() == 3
    assert a.alloc("r1", 5) == [3, 4, 5, 6, 7]
    assert a.alloc("r2", 1) is None and a.in_use() == 8
    assert sorted(a.free("r0")) == [0, 1, 2]
    assert a.alloc("r2", 2) == [0, 1]
    assert a.peak_in_use == 8


def test_submit_rejects_bad_requests(dense_lm):
    _, _, tmodel, tparams = dense_lm
    eng = ServingEngine(tmodel, tparams, max_batch=1, max_len=16, num_blocks=2,
                        block_size=4)
    with pytest.raises(ValueError):
        eng.submit(np.arange(20))
    with pytest.raises(ValueError):
        eng.submit(np.arange(3), max_new_tokens=0)
    with pytest.raises(ValueError):
        eng.submit(np.arange(3), max_new_tokens=10)  # 13 tokens > 2 blocks


def test_sampler_draws_the_softmax_distribution():
    """Temperature sampling cannot reproduce threefry's bits; it is held to
    the distribution instead: over 20000 independent request keys the
    token frequencies match softmax(logits / t) (TV < 0.02; the sampling
    error at this count is ~0.005)."""
    import torch

    from repro_torch.launch.steps import request_keys, sample_tokens

    n, t = 20000, 0.7
    logits = torch.tensor([2.0, 1.0, 0.5, 0.0, -1.0, 1.5, -0.5, 0.2])
    keys = request_keys(3, range(n), "cpu")
    _, tok = sample_tokens(keys, logits.expand(n, -1), torch.full((n,), t))
    freq = np.bincount(tok.numpy(), minlength=8) / n
    want = torch.softmax(logits / t, -1).numpy()
    assert 0.5 * np.abs(freq - want).sum() < 0.02


# ------------------------------------------------- RWKV-6, dense slab


def _rwkv_prompts(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, 200, size=n) for n in PROMPT_LENS]


@pytest.mark.parametrize("kind", ["dense", "nsvd1"])
def test_rwkv_greedy_streams_match_reference_dense_engine(kind):
    """The reduced rwkv6-1.6b on the dense slab: the same greedy streams as
    the reference engine's dense path (3 slots for 5 requests, so slots are
    reused and every admission replaces a previous occupant's state)."""
    jmodel, jparams, tmodel, tparams = tiny_rwkv(kind)
    kw = dict(max_batch=3, max_len=48)
    ref = JaxEngine(jmodel, jparams, pipeline_depth=1,
                    sched_config=SchedulerConfig(admission="worst_case"), **kw)
    eng = ServingEngine(tmodel, tparams, **kw)
    assert not ref.paged and eng.layout == "dense"
    ref_ids = [ref.submit(p, max_new_tokens=10) for p in _rwkv_prompts()]
    ids = [eng.submit(p, max_new_tokens=10) for p in _rwkv_prompts()]
    want, got = ref.run(), eng.run()
    for p, rid in zip(_rwkv_prompts(), ref_ids):
        assert _min_margin(jmodel, jparams, p, want[rid]) > 50 * LOGIT_TOL
    assert [got[i] for i in ids] == [want[i] for i in ref_ids]
    assert all(r.finish_reason == "stop" for r in eng.finished_requests.values())


def test_rwkv_dense_layout_exact_length_admission_one_sync_per_step():
    """RWKV-6 takes the dense layout and is not pad-safe, so each admission
    prefills ONE request at its exact prompt length; the engine syncs with
    the host once per decode step and once per admission.  Attention
    models keep the paged layout."""
    _, _, tmodel, tparams = tiny_rwkv("dense")
    assert cache_layout(tmodel) == "dense" and not prefill_pad_safe(tmodel)
    amodel = tiny_lm("dense")[2]
    assert cache_layout(amodel) == "paged" and prefill_pad_safe(amodel)
    eng = ServingEngine(tmodel, tparams, max_batch=2, max_len=48)
    assert eng.kv is None
    shapes = []
    prefill = eng._prefill

    def spy(params, cache, tokens, *rest):
        shapes.append(tuple(tokens.shape))
        return prefill(params, cache, tokens, *rest)

    eng._prefill = spy
    for p in _rwkv_prompts(1):
        eng.submit(p, max_new_tokens=6)
    out = eng.run()
    assert len(out) == len(PROMPT_LENS) and all(len(v) == 6 for v in out.values())
    assert shapes == [(1, n) for n in PROMPT_LENS]
    st = eng.stats()
    assert st["prefill_ticks"] == len(PROMPT_LENS)
    assert st["host_syncs"] == st["steps"] + st["prefill_ticks"]
