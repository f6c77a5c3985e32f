"""Port parity for the dense GQA archs of the reference's ``ASSIGNED``
(chatglm3-6b: 2 KV heads, half-dim rotary; phi3-medium-14b: 40/10 heads;
deepseek-67b) at their ``reduced()`` shrink, as tests/test_arch_smoke.py
builds them: the configs, logits over the train forward, a paged chunked
prefill then decode and a dense-slab prefill then decode, the target list
and Gram keys, and NSVD-compressed logits on the reference's Grams.
``reduced()`` turns chatglm3's G 16 into G 4, so one more case keeps 32/2
heads (G 16) at a narrow head dim, with rotary_pct 0.5, through the paged
path.  Weights cross by the bridge; fp32 on both sides."""

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
from repro.core import CompressionConfig as JaxCompressionConfig
from repro.core import build_plan as jax_build_plan
from repro.core import compress_params as jax_compress_params
from repro.models import build_model as jax_build_model
from repro_torch.calib.runner import collect_grams
from repro_torch.configs import get_config
from repro_torch.models import build_model, cache_layout, prefill_pad_safe

# fp32 on both sides; the two frameworks sum in different orders, so logits
# of O(1) agree to ~1e-6 relative (tests/test_torch_model.py).
TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ("chatglm3-6b", "phi3-medium-14b", "deepseek-67b")
# The published group sizes (query heads per KV head) and chatglm3's rotary
# fraction, which the full-width configs must carry.
GROUPS = {"chatglm3-6b": 16, "phi3-medium-14b": 4, "deepseek-67b": 8}


def _cfgs(arch, g16=False):
    jcfg, tcfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    if g16:  # chatglm3's 32/2 heads at a narrow head dim
        jcfg, tcfg = (dataclasses.replace(c, num_heads=32, num_kv_heads=2, head_dim=8)
                      for c in (jcfg, tcfg))
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _setup(arch, compressed=False, g16=False):
    jcfg, tcfg = _cfgs(arch, g16)
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    jparams = jmodel.init(jax.random.key(0))
    grams = None
    if compressed:
        rng = np.random.default_rng(3)
        batches = [{"tokens": jnp.asarray(rng.integers(0, jcfg.vocab_size, (4, 32)),
                                          jnp.int32)} for _ in range(2)]
        grams = jax_collect_grams(jmodel, jparams, batches)
        plan = jax_build_plan(jmodel.compressible_targets(), JaxCompressionConfig(
            method="nsvd1", ratio=0.3, dtype="float32", use_randomized=False))
        jparams = jax_compress_params(jparams, plan, grams)
    return jcfg, jmodel, tmodel, jparams, to_t(jparams), grams


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    """Full width and reduced, field for field (the fields the port keeps;
    the encoder and frontend fields are the reference's only)."""
    for j, t in ((jax_get_config(arch), get_config(arch)),
                 (jax_get_config(arch).reduced(), get_config(arch).reduced())):
        tj = dataclasses.asdict(t)
        assert {k: v for k, v in dataclasses.asdict(j).items() if k in tj} == tj
    full = get_config(arch)
    assert full.num_heads // full.num_kv_heads == GROUPS[arch]
    assert full.rotary_pct == (0.5 if arch == "chatglm3-6b" else 1.0)


@pytest.mark.parametrize("arch", ARCHS)
def test_layout_is_paged_and_pad_safe(arch):
    tmodel = _setup(arch)[2]
    assert cache_layout(tmodel) == "paged" and prefill_pad_safe(tmodel)


@pytest.mark.parametrize("compressed", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_logits_match(arch, compressed):
    jcfg, jmodel, tmodel, jparams, tparams, _ = _setup(arch, compressed)
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 11))
    want, _, _ = jmodel.apply(jparams, jnp.asarray(tokens, jnp.int32), mode="train")
    got = tmodel.apply(tparams, torch.as_tensor(tokens), mode="train")
    np.testing.assert_allclose(t2np(got), np.asarray(want), **TOL)


def _paged_prefill_then_decode(jcfg, jmodel, tmodel, jparams, tparams):
    """A 9-token chunk on top of 6 cached tokens through the block table,
    then two decode steps; rows of different lengths and a dead row."""
    bs, nb, m = 4, 12, 5
    tables = np.asarray([[3, 0, 7, 8, -1], [1, 5, 2, 9, 4], [-1] * m], np.int32)
    rng = np.random.default_rng(2)
    jpools = jmodel.init_paged_cache(nb, bs)
    tpools = tmodel.init_paged_cache(nb, bs, device="cpu")
    clen = np.zeros(3, np.int32)
    for s in (6, 9, 1, 1):
        toks = rng.integers(0, jcfg.vocab_size, (3, s))
        jl, jpools, _ = jmodel.apply(jparams, jnp.asarray(toks, jnp.int32), mode="decode",
                                     cache=jpools, cache_len=jnp.asarray(clen),
                                     block_tables=jnp.asarray(tables))
        tl = tmodel.apply(tparams, torch.as_tensor(toks), mode="decode", cache=tpools,
                          cache_len=torch.as_tensor(clen),
                          block_tables=torch.as_tensor(tables))
        np.testing.assert_allclose(t2np(tl[:2]), np.asarray(jl[:2]), **TOL)
        clen = clen + s
    jk = np.asarray(jpools["g0"]["sub0"]["attn"]["k"])
    np.testing.assert_allclose(t2np(tpools["g0"]["sub0"]["attn"]["k"][:, :nb]), jk, **TOL)


@pytest.mark.parametrize("compressed", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_prefill_then_decode_match(arch, compressed):
    jcfg, jmodel, tmodel, jparams, tparams, _ = _setup(arch, compressed)
    _paged_prefill_then_decode(jcfg, jmodel, tmodel, jparams, tparams)


@pytest.mark.parametrize("compressed", [False, True])
def test_chatglm3_g16_half_rotary_paged_match(compressed):
    """chatglm3's own grouping, 32 query heads over 2 KV heads (G 16, the
    paged kernel's widest group), with half of each head dim rotated,
    through the port's plain paged path against the reference."""
    jcfg, jmodel, tmodel, jparams, tparams, _ = _setup("chatglm3-6b", compressed, g16=True)
    assert tmodel.cfg.num_heads // tmodel.cfg.num_kv_heads == 16
    assert tmodel.cfg.rotary_pct == 0.5
    _paged_prefill_then_decode(jcfg, jmodel, tmodel, jparams, tparams)


@pytest.mark.parametrize("arch", ARCHS)
def test_slab_prefill_then_decode_match(arch):
    """The dense slab (``paged=False`` serving): a prefill into a fresh
    cache, then two decode steps; logits and the K/V slab."""
    jcfg, jmodel, tmodel, jparams, tparams, _ = _setup(arch, True)
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, jcfg.vocab_size, (2, 13))
    jcache = jmodel.init_cache(2, 24)
    tcache = tmodel.init_cache(2, 24, device="cpu")
    jl, jcache, _ = jmodel.apply(jparams, jnp.asarray(prompt, jnp.int32), mode="prefill",
                                 cache=jcache)
    tl = tmodel.apply(tparams, torch.as_tensor(prompt), mode="prefill", cache=tcache)
    np.testing.assert_allclose(t2np(tl), np.asarray(jl), **TOL)
    clen = np.full(2, 13, np.int32)
    for _ in range(2):
        step = rng.integers(0, jcfg.vocab_size, (2, 1))
        jd, jcache, _ = jmodel.apply(jparams, jnp.asarray(step, jnp.int32), mode="decode",
                                     cache=jcache, cache_len=jnp.asarray(clen))
        td = tmodel.apply(tparams, torch.as_tensor(step), mode="decode", cache=tcache,
                          cache_len=torch.as_tensor(clen))
        np.testing.assert_allclose(t2np(td), np.asarray(jd), **TOL)
        clen = clen + 1
    want = to_np(jcache)["g0"]["sub0"]["attn"]
    for name in ("k", "v"):
        np.testing.assert_allclose(t2np(tcache["g0"]["sub0"]["attn"][name]), want[name],
                                   **TOL)


@pytest.mark.parametrize("arch, g16", [(a, False) for a in ARCHS] + [("chatglm3-6b", True)])
def test_targets_and_gram_keys_match(arch, g16):
    jcfg, tcfg = _cfgs(arch, g16)
    jt = jax_build_model(jcfg).compressible_targets()
    tt = build_model(tcfg).compressible_targets()
    assert [(t.path, t.in_dim, t.out_dim, t.gram_key, t.stacked) for t in jt] \
        == [(t.path, t.in_dim, t.out_dim, t.gram_key, t.stacked) for t in tt]


@pytest.mark.parametrize("arch", ARCHS)
def test_port_calibration_gives_reference_grams(arch):
    """The port's calibration taps the keys the reference's does (4 a
    layer, per layer and shared over the stack, and the final norm's), each
    Gram within fp32 sum-order error."""
    jcfg, jmodel, tmodel, jparams, tparams, _ = _setup(arch)
    rng = np.random.default_rng(3)
    batches = [rng.integers(0, jcfg.vocab_size, (4, 32)).astype(np.int32) for _ in range(2)]
    want = jax_collect_grams(jmodel, jparams, [{"tokens": jnp.asarray(b)} for b in batches])
    got = collect_grams(tmodel, tparams, batches)
    assert set(got.keys()) == set(want.keys())
    for key in want.keys():
        w = np.asarray(want.gram(key))
        np.testing.assert_allclose(got.gram(key).cpu().numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())


def test_chip_glm_path_counts_hold_on_cpu():
    """chip_smoke's glm_serve schedule (GLM_PREDICTED's steps, chunk calls
    and host syncs: they depend only on the prompt lengths and the plan) on
    the reduced chatglm3 at 32/2 heads on the CPU: *Serve*'s prompt
    lengths, worst case, depth 1; every request finishes with 32 tokens."""
    import chip_smoke as cs
    from repro_torch.launch.serve import serve

    tcfg = _cfgs("chatglm3-6b", g16=True)[1]
    rng = np.random.default_rng(0)
    plens = rng.integers(16, 201, size=8)
    prompts = [rng.integers(2, tcfg.vocab_size // 2, size=int(n)) for n in plens]
    res = serve(tcfg, requests=8, max_new=32, max_batch=8, max_len=256, seed=0,
                compress=0.2, block_size=16, prefill_chunk=64, prompts=prompts,
                device="cpu", sched_policy="worst_case", pipeline_depth=1)
    st, eng = res["engine"].stats(), res["engine"]
    p = cs.GLM_PREDICTED
    assert eng.layout == "paged"
    assert (st["steps"], st["prefill_ticks"], st["host_syncs"]) == (
        p["steps"], p["prefill_calls"], p["host_syncs"])
    assert eng.admissions_by_width == p["admissions"]
    assert all(len(v) == 32 for v in res["outputs"].values())
