"""Port parity for the vision frontend (llava-next-mistral-7b: a projector
over patch features put in front of the token embeddings): the reduced
config (the reference's ``reduced()``: 2 layers, d 32, 8 patches of 1024
features, fp32) against the JAX package on the same numpy-seeded tokens and
patches -- the config, full and reduced; the targets and Gram keys (the
projector's after the layers); the reference's params through the bridge
against the port's meta init tree, and a compressed projector's leaves
through a checkpoint file; train logits and every tap with patches (the
raw fp32 ``projector.in``, the tanh GELU's ``projector.mid``, and a
``final.out_in`` over the prefix rows too) and without them; the
calibration's every Gram, sum |x| and row count over batch dicts with
patches; nsvd1 logits at 0.2 from the reference's Grams; prefill and
decode through ``make_prefill_step`` / ``make_decode_step`` behind an image
(cache_len counts the prefix); perplexity and the logit KL on batch dicts;
the paged layout and the engine's text-only streams against the reference
engine's; the reference launcher's token-only calibration (ROADMAP C);
``calibration_bytes`` with the projector's Grams; and chip_smoke's llava
counts on a reduced twin."""

import dataclasses
import functools
import os
import tempfile
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import t2np, to_np, to_t

from repro.calib.runner import calibration_batches as jax_calibration_batches
from repro.calib.runner import collect_grams as jax_collect_grams
from repro.configs import get_config as jax_get_config
from repro.core import CompressionConfig as JaxCompressionConfig
from repro.core import GramStore as JaxGramStore
from repro.core import build_plan as jax_build_plan
from repro.core import compress_params as jax_compress_params
from repro.eval.attribution import mean_logit_kl as jax_mean_logit_kl
from repro.eval.perplexity import evaluate_ppl as jax_evaluate_ppl
from repro.launch.steps import make_decode_step as jax_make_decode_step
from repro.launch.steps import make_prefill_step as jax_make_prefill_step
from repro.models import build_model as jax_build_model
from repro.serving.engine import ServingEngine as JaxEngine
from repro.serving.scheduler import SchedulerConfig as JaxSchedulerConfig
from repro_torch import bridge
from repro_torch.calib.runner import collect_grams
from repro_torch.configs import ALL, FAMILIES, LLAVA_NEXT_MISTRAL_7B, get_config
from repro_torch.core import CompressionConfig, GramStore, build_plan, compress_params
from repro_torch.eval.attribution import mean_logit_kl
from repro_torch.eval.perplexity import evaluate_ppl
from repro_torch.launch.compress_shapes import calibration_bytes, tree_bytes
from repro_torch.launch.serve import serve
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import attention, build_model, cache_layout
from repro_torch.models.api import batch_inputs
from repro_torch.models.transformer import VISION_FEATURE_DIM
from repro_torch.obs.quality_report import build_entry
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.scheduler import SchedulerConfig

# fp32 on both sides; the frameworks sum in other orders.
TOL = dict(rtol=1e-4, atol=1e-4)
COMPRESSED_TOL = 1e-3  # of max |logit|: factors differ by SVD signs and rounding
GRAM_TOL = 1e-5  # of max |G|: fp32 Grams of the same taps, summed in other orders
ARCH = "llava-next-mistral-7b"
VOCAB = 256
PATCHES = 8  # the reduced config's num_patches


@functools.lru_cache(maxsize=None)
def _setup(spread=False):
    """(reference model, params, port model, params) of the reduced llava;
    ``spread`` scales the unembed by 8 so greedy choices are not near-ties."""
    if spread:
        jmodel, jparams, tmodel, _ = _setup()
        jparams = dict(jparams, unembed={"kernel": jparams["unembed"]["kernel"] * 8.0})
        return jmodel, jparams, tmodel, to_t(jparams)
    jmodel = jax_build_model(jax_get_config(ARCH).reduced())
    tmodel = build_model(get_config(ARCH).reduced())
    jparams = jmodel.init(jax.random.key(0))
    return jmodel, jparams, tmodel, to_t(jparams)


def _patches(b, seed):
    """Stand-in patch features for the stubbed vision tower, fp32."""
    return np.random.default_rng(seed).standard_normal(
        (b, PATCHES, VISION_FEATURE_DIM)).astype(np.float32)


def _batches(n=2, shape=(4, 8), seed=5):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, VOCAB, shape).astype(np.int32),
             "patches": _patches(shape[0], seed + 10 + i)} for i in range(n)]


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
    """Every field, full and reduced: the Mistral-7B backbone (32 layers,
    4096, 32/8 x 128, d_ff 14336, vocab 32000, rope_theta 1e6) behind
    576 patches; ``reduced()`` keeps 8."""
    j, t = jax_get_config(ARCH), get_config(ARCH)
    if reduced:
        j, t = j.reduced(), t.reduced()
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert t.frontend == "vision" and t.family == "vlm" and not t.is_encdec
    if reduced:
        assert (t.num_layers, t.d_model, t.num_patches, t.dtype) == (2, 32, 8, "float32")
    else:
        assert (t.num_layers, t.d_model, t.num_heads, t.num_kv_heads, t.head_dim, t.d_ff,
                t.vocab_size, t.rope_theta, t.num_patches) == (
            32, 4096, 32, 8, 128, 14336, 32000, 1e6, 576)
    assert get_config(ARCH) is LLAVA_NEXT_MISTRAL_7B and ARCH in ALL and ARCH in FAMILIES


@pytest.mark.parametrize("reduced", [False, True])
def test_targets_match_reference(reduced):
    """The port's targets are the reference's (paths, dims, Gram keys,
    stacking), the projector's two after the layers: wi 1024 -> d_model on
    ``projector.in`` and wo d_model -> d_model on ``projector.mid``; every
    Gram key a target reads is one the calibration collects."""
    j, t = jax_get_config(ARCH), get_config(ARCH)
    if reduced:
        j, t = j.reduced(), t.reduced()
    got = [(s.path, s.in_dim, s.out_dim, s.gram_key, tuple(s.stacked))
           for s in build_model(t).compressible_targets()]
    want = [(s.path, s.in_dim, s.out_dim, s.gram_key, tuple(s.stacked))
            for s in jax_build_model(j).compressible_targets()]
    assert got == want and len(got) == 9
    assert got[-2:] == [(("projector", "wi"), 1024, t.d_model, "projector.in", ()),
                        (("projector", "wo"), t.d_model, t.d_model, "projector.mid", ())]
    if reduced:
        keys = set(_calibrated()[1].keys())
        assert {s[3] for s in got} <= keys


def test_reference_params_load_into_the_port_tree():
    """``bridge.to_torch`` of the reference's params has the port's keys,
    shapes and dtypes: reduced (real params against the port's CPU init)
    and at full width and depth (``jax.eval_shape`` against meta tensors),
    the projector's among them."""
    jmodel, jparams, tmodel, tparams = _setup()
    assert sorted(_shapes(tparams)) == sorted(_shapes(tmodel.init(0, "cpu")))
    full = jax_build_model(jax_get_config(ARCH))
    want = jax.eval_shape(full.init, jax.random.key(0))
    got = build_model(LLAVA_NEXT_MISTRAL_7B).init(device="meta")
    ref = {tuple(k.key for k in path): (tuple(leaf.shape), str(leaf.dtype))
           for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]}
    assert {p: (s, d) for p, s, d in _shapes(got)} == ref
    assert ref[("projector", "wi", "kernel")] == ((1024, 4096), "bfloat16")
    assert tparams["projector"]["wi"]["kernel"].shape == (1024, 32)
    np.testing.assert_array_equal(t2np(tparams["projector"]["wo"]["kernel"]),
                                  np.asarray(jparams["projector"]["wo"]["kernel"]))


# ------------------------------------------------------------------ model

def test_train_logits_and_taps_match_reference():
    """Train logits with patches (the S token positions only) and every
    tap with its values: the layers' 4 a layer, ``projector.in`` (the raw
    fp32 patches), ``projector.mid`` (the tanh-approximated GELU of wi's
    output) and ``final.out_in`` over all P + S rows."""
    jmodel, jparams, tmodel, tparams = _setup()
    b = _batches(1, (3, 11), seed=9)[0]

    @jax.jit
    def fwd(p, tokens, patches):
        taps = {}
        return jmodel.apply(p, tokens, patches=patches, taps=taps)[0], taps
    want, jt = fwd(jparams, jnp.asarray(b["tokens"]), jnp.asarray(b["patches"]))
    tt = {}
    got = tmodel.apply(tparams, torch.as_tensor(b["tokens"]),
                       patches=torch.as_tensor(b["patches"]), taps=tt)
    assert got.shape == (3, 11, VOCAB)
    np.testing.assert_allclose(t2np(got), np.asarray(want), **TOL)
    assert sorted(tt) == sorted(jt) and len(tt) == 11
    assert tt["projector.in"].dtype == torch.float32
    assert tuple(tt["final.out_in"].shape) == (3, PATCHES + 11, 32)
    for k in jt:
        np.testing.assert_allclose(t2np(tt[k]), np.asarray(jt[k]), **TOL, err_msg=k)
    # The exact GELU would not be the reference's: it is off by more than TOL.
    mid = torch.nn.functional.gelu(torch.as_tensor(b["patches"]) @ tparams["projector"]["wi"][
        "kernel"])
    assert float((mid - tt["projector.mid"]).abs().max()) > TOL["atol"]


def test_text_only_forward_matches_reference():
    """Without patches the model is its backbone: no projector, no prefix,
    logits and taps as the reference's."""
    jmodel, jparams, tmodel, tparams = _setup()
    tokens = np.random.default_rng(2).integers(0, VOCAB, (2, 9)).astype(np.int32)
    taps = {}
    got = tmodel.apply(tparams, torch.as_tensor(tokens), taps=taps)
    want, _, _ = jmodel.apply(jparams, jnp.asarray(tokens))
    np.testing.assert_allclose(t2np(got), np.asarray(want), **TOL)
    assert not any(k.startswith("projector") for k in taps)
    assert tuple(taps["final.out_in"].shape) == (2, 9, 32)


def test_batch_inputs_take_patches():
    """A batch dict's ``patches`` reach ``apply`` as given (fp32) on the
    params' device; a dict without them, or a bare token array, is
    text-only."""
    _, _, tmodel, _ = _setup()
    b = _batches(1)[0]
    toks, kw = batch_inputs(tmodel, b, "cpu")
    assert toks.shape == (4, 8) and kw["patches"].dtype == torch.float32
    assert torch.equal(kw["patches"], torch.as_tensor(b["patches"]))
    assert batch_inputs(tmodel, {"tokens": b["tokens"]}, "cpu")[1] == {}
    assert batch_inputs(tmodel, b["tokens"], "cpu")[1] == {}


def test_calibration_gives_reference_grams():
    """Every key (the layers' 4 taps shared and per layer, the final
    norm's, the projector's two), each Gram, sum |x| and row count, from
    batch dicts with patches: ``projector.in`` counts the patches' rows
    (4 x 8 a batch), ``final.out_in`` the prefix's and the tokens' (4 x (8
    + 8)), as the reference's."""
    jgrams, tgrams = _calibrated()
    assert set(tgrams.keys()) == set(jgrams.keys())
    assert len(tgrams.keys()) == 4 * 3 + 3
    for k in jgrams.keys():
        want = np.asarray(jgrams.gram(k))
        np.testing.assert_allclose(t2np(tgrams.gram(k)), want, rtol=GRAM_TOL,
                                   atol=GRAM_TOL * max(np.abs(want).max(), 1e-30), err_msg=k)
        np.testing.assert_allclose(t2np(tgrams.absmean(k)), np.asarray(jgrams.absmean(k)),
                                   rtol=GRAM_TOL, atol=1e-6, err_msg=k)
        assert tgrams.count(k) == jgrams.count(k), k
    assert tgrams.count("projector.in") == 2 * 4 * PATCHES
    assert tgrams.count("final.out_in") == 2 * 4 * (PATCHES + 8)
    assert tgrams.count("g0/sub0.mlp.mid/1") == 2 * 4 * (PATCHES + 8)


@functools.lru_cache(maxsize=None)
def _compressed(spread=False):
    """nsvd1 at 0.2 (k1_frac 0.95, fp32 factors) on both sides, from the
    reference's GramStore (written and read back through its npz file)."""
    jmodel, jparams, tmodel, tparams = _setup(spread)
    jgrams, _ = _calibrated()
    kw = dict(method="nsvd1", ratio=0.2, k1_frac=0.95, dtype="float32",
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
    projector's too; the compressed train logits with patches within 1e-3
    of max |logit|."""
    jmodel, _, tmodel, _ = _setup()
    jc, tc = _compressed()
    for w in ("wi", "wo"):
        assert set(tc["projector"][w]) == {"u", "v", "u2", "v2"}
    b = _batches(1, (2, 13), seed=21)[0]
    want = jax.jit(lambda p, t, q: jmodel.apply(p, t, patches=q)[0])(
        jc, jnp.asarray(b["tokens"]), jnp.asarray(b["patches"]))
    got = tmodel.apply(tc, torch.as_tensor(b["tokens"]), patches=torch.as_tensor(b["patches"]))
    _close(got, want, COMPRESSED_TOL)


def test_bridge_carries_the_projector_leaves(tmp_path):
    """The reference's compressed params cross by ``bridge.to_torch`` with
    the projector's factors bit for bit, and through a checkpoint file
    (``save_checkpoint`` / ``load_checkpoint``) unchanged."""
    jc, _ = _compressed()
    tc = to_t(jc)
    for w in ("wi", "wo"):
        for leaf in ("u", "v", "u2", "v2"):
            np.testing.assert_array_equal(t2np(tc["projector"][w][leaf]),
                                          np.asarray(jc["projector"][w][leaf]))
    path = str(tmp_path / "step_0")
    bridge.save_checkpoint(path, to_np(jc))
    back, _ = bridge.load_checkpoint(path, "cpu")
    assert sorted(_shapes(back)) == sorted(_shapes(tc))
    assert torch.equal(back["projector"]["wi"]["u2"], tc["projector"]["wi"]["u2"])


# ------------------------------------------------------------------ decode

def _cache_leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _cache_leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("kind", ["dense", "nsvd1"])
def test_prefill_and_decode_steps_match_reference(kind):
    """``make_prefill_step`` of 3 prompts behind their images, then 4
    ``make_decode_step`` steps at cache_len P + S + i (the prefix counted),
    greedy, on the reference's and the port's: the prefill's and every
    step's logits, the greedy tokens, and the K/V slab after the prefill
    (its first P rows the image's) and after the last step."""
    jmodel, jparams, tmodel, tparams = _setup(spread=True)
    if kind == "nsvd1":
        jparams, tparams = _compressed(spread=True)
    b = _batches(1, (3, 6), seed=31)[0]
    max_len = PATCHES + 6 + 5
    jl, jc = jax.jit(jax_make_prefill_step(jmodel, max_len))(jparams, _jax(b))
    tl, tc = make_prefill_step(tmodel, max_len)(tparams, b)
    tol = TOL if kind == "dense" else dict(rtol=0, atol=COMPRESSED_TOL * float(
        np.abs(np.asarray(jl)).max()))
    np.testing.assert_allclose(t2np(tl), np.asarray(jl), **tol)
    want = dict(_cache_leaves(jax.tree.map(np.asarray, jc)))
    got = dict(_cache_leaves(tc))
    assert sorted(got) == sorted(want) == ["g0/sub0/attn/k", "g0/sub0/attn/v"]
    assert got["g0/sub0/attn/k"].shape == (2, 3, max_len, 1, 8)
    for k in want:
        np.testing.assert_allclose(t2np(got[k]), want[k], rtol=1e-4, atol=1e-4, err_msg=k)
    assert bool(got["g0/sub0/attn/k"][:, :, :PATCHES + 6].any(-1).all())
    jstep, tstep = jax.jit(jax_make_decode_step(jmodel)), make_decode_step(tmodel)
    jtok = ttok = np.array(jnp.argmax(jl[:, -1], -1))
    assert np.array_equal(t2np(tl[:, -1]).argmax(-1), jtok)
    streams = [[], []]
    for i in range(4):
        cl = np.full((3,), PATCHES + 6 + i, np.int32)
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


def test_decode_without_the_prefix_offset_drifts():
    """The decode step's rotary positions come from cache_len: a step at
    the prompt's length alone (the prefix not counted) gives other logits
    than the reference's at P + S, so the offset the previous test holds
    is the one that matters."""
    _, _, tmodel, tparams = _setup(spread=True)
    b = _batches(1, (2, 6), seed=33)[0]
    _, cache = make_prefill_step(tmodel, PATCHES + 8)(tparams, b)
    step = make_decode_step(tmodel)
    tok = torch.ones((2, 1), dtype=torch.long)
    def clone(tree):
        return {k: clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}
    right, _ = step(tparams, clone(cache),
                    {"tokens": tok, "cache_len": torch.full((2,), PATCHES + 6)})
    wrong, _ = step(tparams, cache, {"tokens": tok, "cache_len": torch.full((2,), 6)})
    assert float((right - wrong).abs().max()) > 1e-2


# ------------------------------------------------------------------ eval

def test_ppl_and_logit_kl_match_reference_on_batch_dicts():
    """``evaluate_ppl`` dense and compressed, and ``mean_logit_kl`` between
    them, over batch dicts with patches (the loss over the text tokens)."""
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


# ------------------------------------------------------------------ serving

def test_paged_layout_and_text_only_engine_streams_match_reference():
    """The projector adds no cache leaf, so the layout is "paged", as the
    reference's; the engine serves the model text-only (no admission takes
    patches), and its greedy streams on the compressed params equal the
    reference engine's (worst case, depth 1)."""
    jmodel, _, tmodel, _ = _setup()
    jc, tc = _compressed(spread=True)
    assert cache_layout(tmodel) == "paged"
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, VOCAB // 2, size=n) for n in (5, 11, 7)]
    kw = dict(max_batch=2, max_len=32, block_size=8, prefill_chunk=8)
    ref = JaxEngine(jmodel, jc, pipeline_depth=1,
                    sched_config=JaxSchedulerConfig(admission="worst_case"), **kw)
    eng = ServingEngine(tmodel, tc, pipeline_depth=1,
                        sched_config=SchedulerConfig(admission="worst_case"), **kw)
    assert eng.layout == "paged"
    ref_ids = [ref.submit(p, max_new_tokens=6) for p in prompts]
    ids = [eng.submit(p, max_new_tokens=6) for p in prompts]
    want, got = ref.run(), eng.run()
    assert [got[i] for i in ids] == [want[i] for i in ref_ids]
    assert all(r.finish_reason == "stop" for r in eng.finished_requests.values())


def test_reference_fault_serve_compress_calibrates_tokens_only():
    """The reference's serve launcher compresses from ``get_grams``, whose
    calibration batches hold tokens only (``benchmarks/common.py``), so the
    projector's targets find no Gram and its ``compress_params`` raises a
    KeyError on ``projector.in`` (ROADMAP C).  The port's ``serve()``
    refuses the run with a ValueError naming the patches before it
    calibrates, as does the quality CLI's ``build_entry``, whose stream is
    bare token arrays too; uncompressed, or given compressed params,
    ``serve()`` serves the model text-only."""
    jmodel, jparams, _, _ = _setup()
    grams = jax_collect_grams(jmodel, jparams, jax_calibration_batches(
        VOCAB, "en_a", n_samples=16, batch=16, seq=16))
    plan = jax_build_plan(jmodel.compressible_targets(), JaxCompressionConfig(
        method="nsvd1", ratio=0.2, dtype="float32", use_randomized=False))
    with pytest.raises(KeyError, match="projector.in"):
        jax_compress_params(jparams, plan, grams)
    cfg = get_config(ARCH).reduced()
    for kw in ({"compress": 0.2}, {"spec_ratio": 0.6}):
        with pytest.raises(ValueError, match="patches"):
            serve(cfg, device="cpu", **kw)
    with pytest.raises(ValueError, match="patches"):
        build_entry(cfg, device="cpu", calib_samples=4, eval_n_batches=1, attribution=False)
    _, tc = _compressed()
    res = serve(cfg, params=tc, requests=2, max_new=3, device="cpu")
    assert res["engine"].layout == "paged" and all(
        len(v) == 3 for v in res["outputs"].values())


def test_calibration_bytes_count_the_projector():
    """``calibration_bytes`` on meta tensors runs its forward behind one
    image, so the projector's Grams (``projector.in`` 1024 wide,
    ``projector.mid`` d_model wide) are counted: the param tree's bytes and
    the fp64 GramStore's equal a real calibration's with patches."""
    model = build_model(get_config(ARCH).reduced())
    params = model.init(device="cpu")
    store = collect_grams(model, params, _batches(1, (3, 5)))
    got = calibration_bytes(model)
    assert got["weights"] == tree_bytes(params)
    assert got["grams"] == sum(8 * (store.gram(k).numel() + store.absmean(k).numel())
                               for k in store.keys())
    assert got["grams"] >= 8 * (1024 * 1024 + 1024)


# ------------------------------------------------------------------ chip_smoke

def test_chip_llava_path_counts_hold_on_cpu(monkeypatch):
    """chip_smoke's llava path: ``llava_expect`` at LLAVA_RUN's shapes and
    *Serve*'s schedule (33 decode steps, 3 chunk calls) is LLAVA_PREDICTED,
    and on a reduced twin in bf16 (2 layers, 8 patches; a run of 2
    calibration batches, 1 eval batch a domain, 2 rows decoding 3 tokens,
    3 served requests) the main run's calls of each wrapper, the gram's by
    the kernel its tap would take on the card (fp32 ``projector.in``: the
    tf32x3 kernel) and the nested ones by the route their rows take (with the
    row gate at 48, so that all three routes occur), equal ``llava_expect``
    at the twin's shapes and its engine's schedule.  The kernel phase's
    projector ranks are the served plan's."""
    import chip_smoke as cs
    import repro_torch.calib.gram as calib_gram
    import repro_torch.kernels.gram.ops as gram_ops
    import repro_torch.kernels.nested_lowrank.ops as nlr

    cut = dataclasses.replace(LLAVA_NEXT_MISTRAL_7B, num_layers=cs.LLAVA_LAYERS)
    assert cs.llava_expect(cut, cs.LLAVA_RUN, 33, 3) == cs.LLAVA_PREDICTED
    assert cs.llava_nested_linears(cut) == (28, 2)
    calls = Counter()
    flash, paged, gram, nested = (attention.flash_attention, attention.paged_attention,
                                  calib_gram.gram_accumulate, nlr.nested_lowrank_matmul)

    def counted(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    def gram_routed(x):
        calls["gram"] += 1
        calls["tf32x3"] += gram_ops.route(x.dtype, x.shape[-1], x.data_ptr()) == "tf32x3"
        return gram(x)

    def routed(x, *a):
        rows = x.numel() // x.shape[-1]
        calls["stream" if rows <= 16 else "mma" if rows <= 48 else "gate"] += 1
        return nested(x, *a)
    monkeypatch.setattr(attention, "flash_attention", counted("flash", flash))
    monkeypatch.setattr(attention, "paged_attention", counted("paged", paged))
    monkeypatch.setattr(calib_gram, "gram_accumulate", gram_routed)
    monkeypatch.setattr(nlr, "nested_lowrank_matmul", routed)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="bfloat16")
    run = dict(calib_batches=2, calib_batch=4, seq=8, eval_batches=1, eval_batch=4,
               rows=2, prompt=4, new=3,
               engine=dict(requests=3, lo=4, hi=20, max_new=4, max_batch=2, max_len=64,
                           block=8, chunk=8))
    model = build_model(cfg)
    res = cs.llava_drive(torch, np, model, model.init(0, "cpu"), run)
    st = res["served"]["engine"].stats()
    calls.update(steps=st["steps"], chunks=st["prefill_ticks"])
    assert dict(calls) == cs.llava_expect(cfg, run, st["steps"], st["prefill_ticks"],
                                          gate_rows=48)
    assert all(v > 0 for v in calls.values()) and len(calls) == 9
    assert res["greedy"]["tokens"].shape == (2, 3) and res["single"].shape == (1, 1, VOCAB)
    assert all(np.isfinite(v) for d in res["ppl"].values() for v in d.values())
    assert all(len(v) == 4 for v in res["served"]["outputs"].values())
    plan = build_plan(build_model(cut).compressible_targets(), CompressionConfig(
        method="nsvd1", ratio=0.2, k1_frac=0.95, use_randomized=False))
    ranks = {t.name: plan.rank_of(t) for t in plan.targets}
    assert [(k, n, r) for _, k, n, r in cs.LLAVA_PATH_SHAPES] == [
        (1024, 4096, ranks["projector/wi"]), (4096, 4096, ranks["projector/wo"])]
