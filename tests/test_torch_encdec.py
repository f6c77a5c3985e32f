"""Port parity for the encoder-decoder family (whisper-small): the reduced
config (the reference's ``reduced()``: 2 encoder and 2 decoder layers, d
32, 16 frames, fp32) against the JAX package on the same numpy-seeded
tokens and frames -- the config, full and reduced; the targets and Gram
keys; the reference's params through ``bridge.to_torch`` against the
port's meta init tree; the ``bidir`` and ``cross`` attention modes;
``encode``; train logits with frames; the calibration's every tap (Gram,
sum |x|, row count); nsvd1 logits at 0.2 from the reference's Grams;
prefill and decode through ``make_prefill_step`` / ``make_decode_step``
(logits, greedy tokens, the self and cross K/V); perplexity and the logit
KL on batch dicts; the serving engine's refusal; the reference's token-only
helpers (ROADMAP C); and chip_smoke's whisper counts on a reduced twin.
Also: a batch dict and a bare token array give identical Grams, perplexity
and KL on a decoder-only model."""

import dataclasses
import functools
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import t2np, tiny_cfgs, to_t

from repro.calib.runner import collect_grams as jax_collect_grams
from repro.configs import get_config as jax_get_config
from repro.core import CompressionConfig as JaxCompressionConfig
from repro.core import GramStore as JaxGramStore
from repro.core import build_plan as jax_build_plan
from repro.core import compress_params as jax_compress_params
from repro.eval.attribution import mean_logit_kl as jax_mean_logit_kl
from repro.eval.perplexity import activation_similarity as jax_activation_similarity
from repro.eval.perplexity import evaluate_ppl as jax_evaluate_ppl
from repro.launch.steps import make_decode_step as jax_make_decode_step
from repro.launch.steps import make_prefill_step as jax_make_prefill_step
from repro.models import attention as jax_attention
from repro.models import build_model as jax_build_model
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch.calib.runner import collect_grams
from repro_torch.configs import ALL, ENCDEC, WHISPER_SMALL, get_config
from repro_torch.core import CompressionConfig, GramStore, build_plan, compress_params
from repro_torch.eval.attribution import mean_logit_kl
from repro_torch.eval.perplexity import activation_similarity, evaluate_ppl
from repro_torch.launch.serve import serve
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import EncDecLM, attention, build_model, cache_layout
from repro_torch.obs.quality_report import build_entry
from repro_torch.serving.engine import ServingEngine

# fp32 on both sides; the frameworks sum in other orders.
TOL = dict(rtol=1e-4, atol=1e-4)
COMPRESSED_TOL = 1e-3  # of max |logit|: factors differ by SVD signs and rounding
ARCH = "whisper-small"
VOCAB = 256


@functools.lru_cache(maxsize=None)
def _setup(spread=False):
    """(reference model, params, port model, params) of the reduced
    whisper; ``spread`` scales the unembed by 8 so greedy choices are not
    near-ties."""
    if spread:
        jmodel, jparams, tmodel, _ = _setup()
        jparams = dict(jparams, unembed={"kernel": jparams["unembed"]["kernel"] * 8.0})
        return jmodel, jparams, tmodel, to_t(jparams)
    jmodel = jax_build_model(jax_get_config(ARCH).reduced())
    tmodel = build_model(get_config(ARCH).reduced())
    jparams = jmodel.init(jax.random.key(0))
    return jmodel, jparams, tmodel, to_t(jparams)


def _frames(b, seed):
    """Stand-in frames for the stubbed conv frontend, as the reference's
    tests draw them."""
    return np.random.default_rng(seed).standard_normal((b, 16, 32)).astype(np.float32)


def _batches(n=2, shape=(4, 8), seed=5):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, VOCAB, shape).astype(np.int32),
             "frames": _frames(shape[0], seed + 10 + i)} for i in range(n)]


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _calibrated():
    jmodel, jparams, tmodel, tparams = _setup()
    batches = _batches()
    return (jax_collect_grams(jmodel, jparams, [_jax(b) for b in batches]),
            collect_grams(tmodel, tparams, batches))


def _close(got, want, tol, what=""):
    """|got - want| <= tol * max |want|, element by element."""
    want = np.asarray(want)
    np.testing.assert_allclose(t2np(got), want, rtol=0,
                               atol=tol * float(np.abs(want).max()), err_msg=what)


def _shapes(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _shapes(v, prefix + (k,))
        else:
            yield prefix + (k,), tuple(v.shape), str(v.dtype).replace("torch.", "")


# ------------------------------------------------------------------ config

@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_reference(reduced):
    """Every field, full and reduced: the reference's dataclass has no
    field the port lacks now, and ``reduced()`` keeps 2 + 2 layers and 16
    frames."""
    j, t = jax_get_config(ARCH), get_config(ARCH)
    if reduced:
        j, t = j.reduced(), t.reduced()
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert t.is_encdec and j.is_encdec
    if reduced:
        assert (t.encoder_layers, t.num_layers, t.encoder_seq, t.d_model, t.num_heads,
                t.head_dim, t.d_ff, t.vocab_size, t.num_patches, t.dtype) == (
            2, 2, 16, 32, 4, 8, 64, 256, 8, "float32")
    else:
        assert (t.encoder_layers, t.num_layers, t.encoder_seq, t.d_model, t.num_heads,
                t.num_kv_heads, t.head_dim, t.d_ff, t.vocab_size, t.pos_emb, t.norm,
                t.activation, t.frontend) == (12, 12, 1500, 768, 12, 12, 64, 3072, 51865,
                                              "learned", "layernorm", "gelu", "audio")
    assert get_config(ARCH) is WHISPER_SMALL and ARCH in ALL and ARCH in ENCDEC
    assert not any(c.is_encdec for k, c in ALL.items() if k != ARCH)


@pytest.mark.parametrize("reduced", [False, True])
def test_targets_match_reference(reduced):
    """The port's targets are the reference's (paths, dims, Gram keys,
    stacking): 6 an encoder layer and 10 a decoder layer, 192 matrices at
    full depth; every Gram key a target reads is one the calibration
    collects, shared and per layer."""
    j, t = jax_get_config(ARCH), get_config(ARCH)
    if reduced:
        j, t = j.reduced(), t.reduced()
    got = [(s.path, s.in_dim, s.out_dim, s.gram_key, tuple(s.stacked))
           for s in build_model(t).compressible_targets()]
    want = [(s.path, s.in_dim, s.out_dim, s.gram_key, tuple(s.stacked))
            for s in jax_build_model(j).compressible_targets()]
    assert got == want and len(got) == 16
    assert sum(int(np.prod(s[4])) for s in got) == (32 if reduced else 192)
    if reduced:
        keys = set(_calibrated()[1].keys())
        for s in got:
            assert {s[3], f"{s[3]}/0", f"{s[3]}/1"} <= keys


def test_reference_params_load_into_the_port_tree():
    """``bridge.to_torch`` of the reference's params has the port's keys,
    shapes and dtypes: reduced (real params against the port's CPU init)
    and at full width and depth (``jax.eval_shape`` against meta tensors)."""
    jmodel, jparams, tmodel, tparams = _setup()
    assert sorted(_shapes(tparams)) == sorted(_shapes(tmodel.init(0, "cpu")))
    full = jax_build_model(jax_get_config(ARCH))
    want = jax.eval_shape(full.init, jax.random.key(0))
    got = build_model(WHISPER_SMALL).init(device="meta")
    ref = {tuple(k.key for k in path): (tuple(leaf.shape), str(leaf.dtype))
           for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]}
    assert {p: (s, d) for p, s, d in _shapes(got)} == ref
    assert set(tparams) == {"embed", "pos_dec", "pos_enc", "encoder", "enc_norm",
                            "decoder", "final_norm", "unembed"}
    assert tparams["decoder"]["sub0"]["cross"]["wq"]["kernel"].shape == (2, 32, 32)


# ------------------------------------------------------------------ attention

@pytest.mark.parametrize("mode", ["bidir", "cross"])
def test_attention_modes_match_reference(mode):
    """``bidir`` (no mask) and ``cross`` (K/V from the memory, 16 frames
    against 9 queries) against ``attention_apply``: the output and the taps
    (``.in``, ``.out_in`` and, for cross, ``.kv_in``)."""
    jcfg = jax_get_config(ARCH).reduced()
    jp = jax_attention.attention_init(jax.random.key(3), jcfg, jnp.float32)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 32)).astype(np.float32)
    mem = rng.standard_normal((2, 16, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9), (2, 9)).copy()
    jt, tt = {}, {}
    want, _ = jax_attention.attention_apply(
        jp, jnp.asarray(x), jcfg, jnp.asarray(pos), mode=mode,
        memory=jnp.asarray(mem) if mode == "cross" else None, taps=jt, tap_prefix="a")
    got = attention.attention_apply(
        to_t(jp), torch.as_tensor(x), get_config(ARCH).reduced(), torch.as_tensor(pos),
        mode=mode, memory=torch.as_tensor(mem) if mode == "cross" else None, taps=tt,
        tap_prefix="a")
    np.testing.assert_allclose(t2np(got), np.asarray(want), **TOL)
    assert sorted(tt) == sorted(jt) == sorted(
        ["a.in", "a.out_in"] + (["a.kv_in"] if mode == "cross" else []))
    for k in jt:
        np.testing.assert_allclose(t2np(tt[k]), np.asarray(jt[k]), **TOL, err_msg=k)


def test_attention_refuses_cross_without_memory_and_unknown_modes():
    cfg = get_config(ARCH).reduced()
    p = attention.attention_init(torch.Generator().manual_seed(0), cfg, torch.float32, "cpu")
    x, pos = torch.zeros(1, 3, 32), torch.zeros(1, 3, dtype=torch.long)
    with pytest.raises(ValueError, match="memory"):
        attention.attention_apply(p, x, cfg, pos, mode="cross")
    with pytest.raises(ValueError, match="not ported"):
        attention.attention_apply(p, x, cfg, pos, mode="sliding")


# ------------------------------------------------------------------ model

def test_encode_matches_reference():
    jmodel, jparams, tmodel, tparams = _setup()
    fr = _frames(3, 7)
    want = jax.jit(jmodel.encode)(jparams, jnp.asarray(fr))
    np.testing.assert_allclose(t2np(tmodel.encode(tparams, torch.as_tensor(fr))),
                               np.asarray(want), **TOL)


def test_train_logits_and_taps_match_reference():
    """Train logits with frames, and every tap (11 names a layer pair: 4 of
    the encoder's, 7 of the decoder's, per layer) with its values."""
    jmodel, jparams, tmodel, tparams = _setup()
    b = _batches(1, (3, 11), seed=9)[0]
    @jax.jit
    def fwd(p, tokens, frames):
        taps = {}
        return jmodel.apply(p, tokens, frames=frames, taps=taps)[0], taps
    want, jt = fwd(jparams, jnp.asarray(b["tokens"]), jnp.asarray(b["frames"]))
    tt = {}
    got = tmodel.apply(tparams, torch.as_tensor(b["tokens"]),
                       frames=torch.as_tensor(b["frames"]), taps=tt)
    np.testing.assert_allclose(t2np(got), np.asarray(want), **TOL)
    assert sorted(tt) == sorted(jt) and len(tt) == 22
    assert {k.split(".", 1)[1] for k in tt} == {
        "attn.in", "attn.out_in", "mlp.in", "mlp.mid", "cross.in", "cross.kv_in",
        "cross.out_in"}
    for k in jt:
        np.testing.assert_allclose(t2np(tt[k]), np.asarray(jt[k]), **TOL, err_msg=k)


def test_apply_refuses_train_without_frames():
    _, _, tmodel, tparams = _setup()
    with pytest.raises(ValueError, match="frames"):
        tmodel.apply(tparams, torch.zeros((1, 4), dtype=torch.long))
    with pytest.raises(ValueError, match="no encoder"):
        EncDecLM(get_config("small-llama"))


def test_calibration_gives_reference_grams():
    """Every key (11 taps, shared and per layer), each Gram, sum |x| and row
    count, from batch dicts with frames; ``kv_in`` counts the memory's rows
    (4 x 16 a batch), the decoder's taps the tokens' (4 x 8)."""
    jgrams, tgrams = _calibrated()
    assert set(tgrams.keys()) == set(jgrams.keys())
    assert len(tgrams.keys()) == 11 * 3
    for k in jgrams.keys():
        want = np.asarray(jgrams.gram(k))
        np.testing.assert_allclose(t2np(tgrams.gram(k)), want, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(want).max(), 1e-30), err_msg=k)
        np.testing.assert_allclose(t2np(tgrams.absmean(k)), np.asarray(jgrams.absmean(k)),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
        assert tgrams.count(k) == jgrams.count(k), k
    assert tgrams.count("dec/sub0.cross.kv_in/1") == 2 * 4 * 16
    assert tgrams.count("dec/sub0.cross.in/1") == tgrams.count("enc/sub0.attn.in/0") / 2


@functools.lru_cache(maxsize=None)
def _compressed(spread=False):
    """nsvd1 at 0.2 (k1_frac 0.9, fp32 factors) on both sides, from the
    reference's GramStore (written and read back through its npz file)."""
    import os
    import tempfile

    jmodel, jparams, tmodel, tparams = _setup(spread)
    jgrams, _ = _calibrated()
    kw = dict(method="nsvd1", ratio=0.2, k1_frac=0.9, dtype="float32",
              use_randomized=False)
    jplan = jax_build_plan(jmodel.compressible_targets(), JaxCompressionConfig(**kw))
    tplan = build_plan(tmodel.compressible_targets(), CompressionConfig(**kw))
    assert tplan.summary() == jplan.summary()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "grams.npz")
        jgrams.save(path)
        jc = jax_compress_params(jparams, jplan, JaxGramStore.load(path))
        tc = compress_params(tparams, tplan, GramStore.load(path, device="cpu"))
    return jc, tc


def test_compressed_logits_match_reference():
    """nsvd1 at 0.2 from the reference's Grams: every target nested, the
    compressed train logits within 1e-3 of max |logit|."""
    jmodel, _, tmodel, _ = _setup()
    jc, tc = _compressed()
    assert set(tc["decoder"]["sub0"]["cross"]["wk"]) == {"u", "v", "u2", "v2"}
    assert set(tc["encoder"]["sub0"]["mlp"]["wo"]) == {"u", "v", "u2", "v2"}
    b = _batches(1, (2, 13), seed=21)[0]
    want = jax.jit(lambda p, t, f: jmodel.apply(p, t, frames=f)[0])(
        jc, jnp.asarray(b["tokens"]), jnp.asarray(b["frames"]))
    got = tmodel.apply(tc, torch.as_tensor(b["tokens"]), frames=torch.as_tensor(b["frames"]))
    _close(got, want, COMPRESSED_TOL)


# ------------------------------------------------------------------ decode

def _cache_leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _cache_leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("kind", ["dense", "nsvd1"])
def test_prefill_and_decode_steps_match_reference(kind):
    """``make_prefill_step`` then 4 ``make_decode_step`` steps, greedy, on
    the reference's and the port's: the prefill's and every step's logits,
    the greedy tokens, and the cache (self K/V slab, cross K/V slab) after
    the prefill and after the last step."""
    jmodel, jparams, tmodel, tparams = _setup(spread=True)
    if kind == "nsvd1":
        jparams, tparams = _compressed(spread=True)
    b = _batches(1, (3, 6), seed=31)[0]
    max_len = 12
    jl, jc = jax.jit(jax_make_prefill_step(jmodel, max_len))(jparams, _jax(b))
    tl, tc = make_prefill_step(tmodel, max_len)(tparams, b)
    tol = TOL if kind == "dense" else dict(rtol=0, atol=COMPRESSED_TOL * float(
        np.abs(np.asarray(jl)).max()))
    np.testing.assert_allclose(t2np(tl), np.asarray(jl), **tol)
    want = dict(_cache_leaves(jax.tree.map(np.asarray, jc)))
    got = dict(_cache_leaves(tc))
    assert sorted(got) == sorted(want) == [
        "decoder/sub0/attn/k", "decoder/sub0/attn/v", "decoder/sub0/cross/k",
        "decoder/sub0/cross/v"]
    assert got["decoder/sub0/cross/k"].shape == (2, 3, 16, 4, 8)
    for k in want:
        np.testing.assert_allclose(t2np(got[k]), want[k], rtol=1e-4, atol=1e-4, err_msg=k)
    jstep, tstep = jax.jit(jax_make_decode_step(jmodel)), make_decode_step(tmodel)
    jtok = ttok = np.array(jnp.argmax(jl[:, -1], -1))
    assert np.array_equal(t2np(tl[:, -1]).argmax(-1), jtok)
    streams = [[], []]
    for i in range(4):
        cl = np.full((3,), 6 + i, np.int32)
        jl, jc = jstep(jparams, jc, {"tokens": jnp.asarray(jtok[:, None], jnp.int32),
                                     "cache_len": jnp.asarray(cl)})
        tl, tc = tstep(tparams, tc, {"tokens": torch.as_tensor(ttok[:, None]),
                                     "cache_len": torch.as_tensor(cl)})
        np.testing.assert_allclose(t2np(tl), np.asarray(jl), **tol)
        jtok, ttok = np.array(jnp.argmax(jl[:, -1], -1)), t2np(tl[:, -1]).argmax(-1)
        streams[0].append(jtok)
        streams[1].append(ttok)
    assert np.array_equal(np.stack(streams[0]), np.stack(streams[1]))
    want = dict(_cache_leaves(jax.tree.map(np.asarray, jc)))
    for k, v in _cache_leaves(tc):
        np.testing.assert_allclose(t2np(v), want[k], rtol=1e-4, atol=1e-4, err_msg=k)


def test_cache_layout_is_dense_and_the_engine_refuses():
    """``cache_layout`` says "dense", as the reference's; the port's engine
    refuses an encoder-decoder with a ValueError naming the reason, and
    ``serve()`` fails at its calibration, whose batches carry no frames.  The
    reference's engine takes the model and then fails inside its prefill,
    whose admissions pass no frames (ROADMAP C)."""
    jmodel, jparams, tmodel, tparams = _setup()
    assert cache_layout(tmodel) == "dense"
    with pytest.raises(ValueError, match="encoder-decoder"):
        ServingEngine(tmodel, tparams, max_batch=2, max_len=16)
    with pytest.raises(ValueError, match="encoder-decoder"):
        serve(get_config(ARCH).reduced(), compress=0.2, device="cpu")
    eng = JaxEngine(jmodel, jparams, max_batch=2, max_len=16)
    eng.submit(np.arange(2, 6, dtype=np.int32), max_new_tokens=2)
    with pytest.raises(Exception):
        eng.run(max_steps=4)


# ------------------------------------------------------------------ eval

def test_ppl_and_logit_kl_match_reference_on_batch_dicts():
    """``evaluate_ppl`` dense and compressed, and ``mean_logit_kl`` between
    them, over batch dicts with frames."""
    jmodel, jparams, tmodel, tparams = _setup()
    jc, tc = _compressed()
    batches = _batches(2, (3, 10), seed=41)
    jb = [_jax(b) for b in batches]
    for jp, tp in ((jparams, tparams), (jc, tc)):
        np.testing.assert_allclose(evaluate_ppl(tmodel, tp, batches),
                                   jax_evaluate_ppl(jmodel, jp, jb), rtol=1e-4)
    want = jax_mean_logit_kl(jmodel, jparams, jc, jb)
    got = mean_logit_kl(tmodel, tparams, tc, batches)
    assert want > 0 and got == pytest.approx(want, rel=1e-3, abs=1e-6)


def test_reference_fault_token_only_helpers():
    """The reference's ``activation_similarity`` builds token-only batches,
    so an encoder-decoder model fails inside it (its ``build_entry`` trains
    a small decoder LM only); the port's fails with a ValueError naming the
    frames, as does its ``build_entry``, whose calibration stream is bare
    token arrays (ROADMAP C)."""
    jmodel, jparams, tmodel, tparams = _setup()
    with pytest.raises(Exception):
        jax_activation_similarity(jmodel, jparams, "en_a", "jp", VOCAB, n_batches=1,
                                  batch=2, seq=8)
    with pytest.raises(ValueError, match="frames"):
        activation_similarity(tmodel, tparams, "en_a", "jp", VOCAB, n_batches=1, batch=2,
                              seq=8)
    with pytest.raises(ValueError, match="frames"):
        build_entry(get_config(ARCH).reduced(), device="cpu", calib_samples=4,
                    eval_n_batches=1, attribution=False)


@pytest.mark.parametrize("fn", ["grams", "ppl", "logit_kl"])
def test_batch_dict_and_bare_tokens_agree_on_a_decoder_model(fn):
    """The calibration and eval entry points take the reference's batch
    dicts or bare (B, S) token arrays: on a decoder-only model both give
    identical Grams, perplexity and KL, bit for bit."""
    _, tcfg = tiny_cfgs("small-llama", d_model=32, d_ff=48, vocab=64)
    model = build_model(tcfg)
    params = model.init(0, "cpu")
    rng = np.random.default_rng(6)
    arrays = [rng.integers(0, 64, (3, 12)).astype(np.int32) for _ in range(2)]
    dicts = [{"tokens": a} for a in arrays]
    if fn == "grams":
        a, d = collect_grams(model, params, arrays), collect_grams(model, params, dicts)
        assert sorted(a.keys()) == sorted(d.keys()) and len(a.keys()) > 0
        for k in a.keys():
            assert torch.equal(a.gram(k), d.gram(k)) and torch.equal(a.absmean(k),
                                                                     d.absmean(k))
            assert a.count(k) == d.count(k)
    elif fn == "ppl":
        assert evaluate_ppl(model, params, arrays) == evaluate_ppl(model, params, dicts)
    else:
        other = model.init(1, "cpu")
        kl = mean_logit_kl(model, params, other, arrays)
        assert kl > 0 and kl == mean_logit_kl(model, params, other, dicts)


# ------------------------------------------------------------------ chip_smoke

def test_chip_whisper_path_counts_hold_on_cpu(monkeypatch):
    """chip_smoke's whisper path: ``whisper_expect`` at WHISPER_RUN's shapes
    is WHISPER_PREDICTED, and on a reduced twin (2 + 2 layers, a run of 2
    calibration batches, 1 eval batch a domain, 2 rows decoding 3 tokens)
    the main run's calls of each wrapper, the nested ones by the route
    their rows take (with the row gate at 48, so that all three routes
    occur), equal ``whisper_expect`` at the twin's shapes.  The kernel
    phase's whisper ranks are the served plan's."""
    import chip_smoke as cs
    import repro_torch.calib.gram as calib_gram
    import repro_torch.kernels.nested_lowrank.ops as nlr

    assert cs.whisper_expect(WHISPER_SMALL, cs.WHISPER_RUN) == cs.WHISPER_PREDICTED
    calls = Counter()
    flash, gram, nested = (attention.flash_attention, calib_gram.gram_accumulate,
                           nlr.nested_lowrank_matmul)

    def counted(name, fn):
        def wrapped(*a):
            calls[name] += 1
            return fn(*a)
        return wrapped

    def routed(x, *a):
        rows = x.numel() // x.shape[-1]
        calls["stream" if rows <= 16 else "mma" if rows <= 48 else "gate"] += 1
        return nested(x, *a)
    monkeypatch.setattr(attention, "flash_attention", counted("flash", flash))
    monkeypatch.setattr(calib_gram, "gram_accumulate", counted("gram", gram))
    monkeypatch.setattr(nlr, "nested_lowrank_matmul", routed)
    cfg = get_config(ARCH).reduced()
    run = dict(calib_batches=2, calib_batch=4, seq=8, eval_batches=1, eval_batch=4,
               rows=2, prompt=4, new=3)
    model = build_model(cfg)
    res = cs.whisper_drive(torch, np, model, model.init(0, "cpu"), run)
    assert dict(calls) == cs.whisper_expect(cfg, run, gate_rows=48)
    assert all(v > 0 for v in calls.values()) and len(calls) == 5
    assert res["greedy"]["tokens"].shape == (2, 3)
    assert all(np.isfinite(v) for d in res["ppl"].values() for v in d.values())
    plan = build_plan(build_model(WHISPER_SMALL).compressible_targets(), CompressionConfig(
        method="nsvd1", ratio=0.2, k1_frac=0.9, use_randomized=False))
    ranks = {t.name: plan.rank_of(t) for t in plan.targets}
    assert [(k, n, r) for _, k, n, r in cs.WHISPER_PATH_SHAPES] == [
        (768, 3072, ranks["decoder/sub0/mlp/wi"]), (3072, 768, ranks["decoder/sub0/mlp/wo"])]
