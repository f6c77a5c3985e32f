"""Port parity for Multi-head Latent Attention (minicpm3-4b's family) and
the dense slab's bucketed admission, against the JAX reference on the same
numpy-seeded inputs: MLA's rope, naive prefill (with its four taps) and
absorbed decode against ``repro.models.mla``; the targets, Gram keys and
``dense_kernel`` on a factored ``wkv_b``; the reduced minicpm3's logits,
dense and NSVD-compressed; a reference MLA checkpoint and GramStore read
through the bridge; and the port's engine against the reference engine on
the dense slab (greedy streams, admission calls by prompt width, prefill
calls and host syncs) for the reduced minicpm3 and a tiny Mistral served
with ``paged=False`` (bucketed), and for the RWKV-6 and MoE slabs
(exact-length, one request a call).  fp32 on both sides."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import t2np, tiny_lm, tiny_rwkv, to_np, to_t

from repro.calib.runner import collect_grams as jax_collect_grams
from repro.checkpoint.checkpointer import save_checkpoint as jax_save_checkpoint
from repro.configs import get_config as jax_get_config
from repro.core import CompressionConfig as JaxCompressionConfig
from repro.core import build_plan as jax_build_plan
from repro.core import compress_params as jax_compress_params
from repro.launch.compress_shapes import compressed_param_shapes as jax_compressed_param_shapes
from repro.models import build_model as jax_build_model
from repro.models import lowrank_utils as jax_lowrank_utils
from repro.models import mla as jax_mla
from repro.serving.engine import ServingEngine as JaxEngine
from repro.serving.scheduler import SchedulerConfig
from repro_torch import bridge
from repro_torch.calib.runner import collect_grams
from repro_torch.configs import get_config
from repro_torch.core import GramStore
from repro_torch.launch.compress_shapes import compressed_param_shapes
from repro_torch.launch.steps import make_prefill_admit_step
from repro_torch.models import build_model, cache_layout, lowrank_utils, mla, prefill_pad_safe
from repro_torch.serving.engine import ServingEngine

# fp32 on both sides; the two frameworks sum in different orders, so logits
# of O(1) agree to ~1e-6 relative (tests/test_torch_model.py).
TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "minicpm3-4b"


@functools.lru_cache(maxsize=None)
def _setup(compressed=False, spread=False):
    """(reference cfg, model, params, port model, params, reference Grams)
    of the reduced minicpm3; ``spread`` scales the unembed by 8 so greedy
    choices are not near-ties (the engine tests)."""
    jcfg = jax_get_config(ARCH).reduced()
    jmodel, tmodel = jax_build_model(jcfg), build_model(get_config(ARCH).reduced())
    jparams = jmodel.init(jax.random.key(0))
    if spread:
        jparams["unembed"]["kernel"] = jparams["unembed"]["kernel"] * 8.0
    grams = None
    if compressed:
        rng = np.random.default_rng(3)
        batches = [{"tokens": jnp.asarray(rng.integers(0, jcfg.vocab_size, (4, 32)),
                                          jnp.int32)} for _ in range(2)]
        grams = jax_collect_grams(jmodel, jparams, batches)
        plan = jax_build_plan(jmodel.compressible_targets(), JaxCompressionConfig(
            method="nsvd1", ratio=0.3, dtype="float32", use_randomized=False))
        jparams = jax_compress_params(jparams, plan, grams)
    return jcfg, jmodel, jparams, tmodel, to_t(jparams), grams


def _layer(compressed=False):
    """One MLA layer's params (the first of the stack) on both sides."""
    jcfg, _, jparams, _, _, _ = _setup(compressed)
    jp = jax.tree.map(lambda a: a[0], jparams["g0"]["sub0"]["attn"])
    return jcfg, get_config(ARCH).reduced(), jp, to_t(jp)


def test_config_and_layout():
    """MLAConfig and reduced() field for field; the latent slab is dense
    (c_kv and k_rope are not pageable) and pad-safe (bucketed)."""
    for j, t in ((jax_get_config(ARCH), get_config(ARCH)),
                 (jax_get_config(ARCH).reduced(), get_config(ARCH).reduced())):
        tj = dataclasses.asdict(t)
        assert {k: v for k, v in dataclasses.asdict(j).items() if k in tj} == tj
    tmodel = _setup()[3]
    assert cache_layout(tmodel) == "dense" and prefill_pad_safe(tmodel)
    with pytest.raises(ValueError, match="paged"):
        tmodel.init_paged_cache(8, 4, device="cpu")


@pytest.mark.parametrize("shape", [(2, 5, 8), (2, 5, 3, 8)])
def test_rope_rotates_halves_like_reference(shape):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    pos = rng.integers(0, 300, shape[:2])
    want = jax_mla._rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    got = mla._rope(torch.as_tensor(x), torch.as_tensor(pos), 10000.0)
    np.testing.assert_allclose(t2np(got), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("compressed", [False, True])
def test_naive_prefill_and_taps_match(compressed):
    """The expanded path on a (2, 9) batch into a fresh slab: output, the
    four taps (.in, .q_lora_in, .kv_lora_in, .out_in) and the slab rows."""
    jcfg, tcfg, jp, tp = _layer(compressed)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, jcfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(9), (2, 1))
    jtaps, ttaps = {}, {}
    jcache = jax_mla.init_mla_cache(jcfg, 2, 16, jnp.float32)
    tcache = mla.init_mla_cache(tcfg, 2, 16, torch.float32, "cpu")
    want, jcache = jax_mla.mla_apply(jp, jnp.asarray(x), jcfg, jnp.asarray(pos),
                                     cache=jcache, taps=jtaps, tap_prefix="a")
    got = mla.mla_apply(tp, torch.as_tensor(x), tcfg, torch.as_tensor(pos), cache=tcache,
                        taps=ttaps, tap_prefix="a")
    np.testing.assert_allclose(t2np(got), np.asarray(want), **TOL)
    assert list(ttaps) == list(jtaps) == ["a.in", "a.q_lora_in", "a.kv_lora_in", "a.out_in"]
    for k in jtaps:
        np.testing.assert_allclose(t2np(ttaps[k]), np.asarray(jtaps[k]), **TOL, err_msg=k)
    for k in ("c_kv", "k_rope"):
        np.testing.assert_allclose(t2np(tcache[k]), np.asarray(jcache[k]), **TOL, err_msg=k)


@pytest.mark.parametrize("compressed", [False, True])
def test_absorbed_decode_matches_reference(compressed):
    """Three absorbed decode steps on a slab prefilled to different lengths
    a row: outputs, taps and the latent slab.  Held against the reference's
    own decode (absorbed and expanded attention associate the products
    differently)."""
    jcfg, tcfg, jp, tp = _layer(compressed)
    rng = np.random.default_rng(2)
    jcache = {k: jnp.asarray(rng.standard_normal(v.shape).astype(np.float32))
              for k, v in jax_mla.init_mla_cache(jcfg, 3, 12, jnp.float32).items()}
    tcache = {k: torch.as_tensor(np.array(v)) for k, v in jcache.items()}
    clen = np.asarray([0, 4, 9], np.int32)
    for _ in range(3):
        x = rng.standard_normal((3, 1, jcfg.d_model)).astype(np.float32)
        jtaps, ttaps = {}, {}
        want, jcache = jax_mla.mla_apply(jp, jnp.asarray(x), jcfg, jnp.asarray(clen[:, None]),
                                         mode="decode", cache=jcache,
                                         cache_len=jnp.asarray(clen), taps=jtaps,
                                         tap_prefix="a")
        got = mla.mla_apply(tp, torch.as_tensor(x), tcfg, torch.as_tensor(clen[:, None]),
                            mode="decode", cache=tcache, cache_len=torch.as_tensor(clen),
                            taps=ttaps, tap_prefix="a")
        np.testing.assert_allclose(t2np(got), np.asarray(want), **TOL)
        for k in jtaps:
            np.testing.assert_allclose(t2np(ttaps[k]), np.asarray(jtaps[k]), **TOL)
        clen = clen + 1
    for k in ("c_kv", "k_rope"):
        np.testing.assert_allclose(t2np(tcache[k]), np.asarray(jcache[k]), **TOL, err_msg=k)


def test_targets_and_dense_kernel():
    """The five MLA targets a layer (wq_a and wkv_a on attn.in, wq_b on
    attn.q_lora_in, wkv_b on attn.kv_lora_in, wo on attn.out_in) and the
    MLP's, stacked as the reference's; ``dense_kernel`` rebuilds a factored
    wkv_b (u@v + u2@v2) as the reference's does, and returns a dense
    kernel as it is."""
    jcfg, jmodel, _, tmodel, _, _ = _setup()
    jt, tt = jmodel.compressible_targets(), tmodel.compressible_targets()
    assert [(t.path, t.in_dim, t.out_dim, t.gram_key, t.stacked) for t in jt] \
        == [(t.path, t.in_dim, t.out_dim, t.gram_key, t.stacked) for t in tt]
    assert [t.path[-1] for t in tt] == ["wq_a", "wq_b", "wkv_a", "wkv_b", "wo",
                                        "wi", "wg", "wo"]
    rng = np.random.default_rng(7)
    jcfg = get_config(ARCH).reduced()
    r, n = jcfg.mla.kv_lora_rank, jcfg.num_heads * (jcfg.mla.qk_nope_head_dim
                                                    + jcfg.mla.v_head_dim)
    nested = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in (("u", (r, 5)), ("v", (5, n)), ("u2", (r, 2)), ("v2", (2, n)))}
    _, _, jp, tp = _layer(compressed=True)  # nsvd1 at this rank: u, v only
    for jw, tw in ((jax.tree.map(jnp.asarray, nested), to_t(nested)), (jp["wkv_b"], tp["wkv_b"])):
        np.testing.assert_allclose(t2np(lowrank_utils.dense_kernel(tw)),
                                   np.asarray(jax_lowrank_utils.dense_kernel(jw)),
                                   rtol=1e-5, atol=1e-6)
    _, _, jd, td = _layer()
    assert lowrank_utils.dense_kernel(td["wkv_b"]) is td["wkv_b"]["kernel"]


@pytest.mark.parametrize("compressed", [False, True])
def test_model_logits_match(compressed):
    """The reduced minicpm3 (2 stacked MLA layers), dense and compressed on
    the reference's Grams: the train forward, a prefill into a fresh slab,
    then three decode steps; logits and every slab leaf."""
    jcfg, jmodel, jparams, tmodel, tparams, _ = _setup(compressed)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 11))
    want, _, _ = jmodel.apply(jparams, jnp.asarray(tokens, jnp.int32), mode="train")
    got = tmodel.apply(tparams, torch.as_tensor(tokens), mode="train")
    np.testing.assert_allclose(t2np(got), np.asarray(want), **TOL)
    jcache, tcache = jmodel.init_cache(2, 24), tmodel.init_cache(2, 24, device="cpu")
    jl, jcache, _ = jmodel.apply(jparams, jnp.asarray(tokens, jnp.int32), mode="prefill",
                                 cache=jcache)
    tl = tmodel.apply(tparams, torch.as_tensor(tokens), mode="prefill", cache=tcache)
    np.testing.assert_allclose(t2np(tl), np.asarray(jl), **TOL)
    clen = np.full(2, 11, np.int32)
    for _ in range(3):
        step = rng.integers(0, jcfg.vocab_size, (2, 1))
        jd, jcache, _ = jmodel.apply(jparams, jnp.asarray(step, jnp.int32), mode="decode",
                                     cache=jcache, cache_len=jnp.asarray(clen))
        td = tmodel.apply(tparams, torch.as_tensor(step), mode="decode", cache=tcache,
                          cache_len=torch.as_tensor(clen))
        np.testing.assert_allclose(t2np(td), np.asarray(jd), **TOL)
        clen = clen + 1
    want_c = to_np(jcache)["g0"]["sub0"]["attn"]
    for k in ("c_kv", "k_rope"):
        np.testing.assert_allclose(t2np(tcache["g0"]["sub0"]["attn"][k]), want_c[k], **TOL)


def test_port_calibration_gives_reference_grams():
    """The port's calibration taps every key the reference's does (six a
    layer, per layer and shared over the stack, and the final norm's), each
    Gram within fp32 sum-order error."""
    jcfg, jmodel, jparams, tmodel, tparams, _ = _setup()
    rng = np.random.default_rng(3)
    batches = [rng.integers(0, jcfg.vocab_size, (4, 32)).astype(np.int32) for _ in range(2)]
    want = jax_collect_grams(jmodel, jparams, [{"tokens": jnp.asarray(b)} for b in batches])
    got = collect_grams(tmodel, tparams, batches)
    assert set(got.keys()) == set(want.keys())
    assert {k.split("/")[1].split(".", 1)[1] for k in got.keys() if k.startswith("g0/")} == {
        "attn.in", "attn.q_lora_in", "attn.kv_lora_in", "attn.out_in", "mlp.in", "mlp.mid"}
    for key in want.keys():
        w = np.asarray(want.gram(key))
        np.testing.assert_allclose(got.gram(key).cpu().numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())


def test_bridge_loads_reference_mla_checkpoint_and_grams(tmp_path):
    """A reference checkpoint of the compressed MLA model (attn/{wq_a,
    q_norm, wq_b, wkv_a, kv_norm, wkv_b, wo}, stacked layer dims) and its
    GramStore load unchanged, and the loaded params give the reference's
    logits."""
    jcfg, jmodel, jparams, tmodel, _, grams = _setup(compressed=True)
    path = str(tmp_path / "ckpt")
    jax_save_checkpoint(path, jparams)
    params, _ = bridge.load_checkpoint(path, device="cpu")
    attn = params["g0"]["sub0"]["attn"]
    assert set(attn) == {"wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wkv_b", "wo"}
    assert attn["wkv_b"]["u"].shape[0] == jcfg.num_layers
    gpath = str(tmp_path / "grams.npz")
    grams.save(gpath)
    store = GramStore.load(gpath, device="cpu")
    assert set(store.keys()) == set(grams.keys())
    for key in grams.keys():
        np.testing.assert_array_equal(store.gram(key).cpu().numpy(),
                                      np.asarray(grams.gram(key)))
    tokens = np.random.default_rng(6).integers(0, jcfg.vocab_size, (2, 9))
    want, _, _ = jmodel.apply(jparams, jnp.asarray(tokens, jnp.int32), mode="train")
    np.testing.assert_allclose(t2np(tmodel.apply(params, torch.as_tensor(tokens))),
                               np.asarray(want), **TOL)


def _shape_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _shape_leaves(tree[key], prefix + (key,))
    else:
        yield prefix, (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))


def test_full_width_compressed_shapes_match_reference():
    """minicpm3-4b at full width (2 layers, no memory: the reference's
    abstract init against meta tensors): every MLA target's factors, nsvd1
    at 0.2, as the reference's shape-level compression gives them."""
    jcfg = dataclasses.replace(jax_get_config(ARCH), num_layers=2)
    jmodel = jax_build_model(jcfg)
    jshapes = jax.eval_shape(jmodel.init, jax.random.key(0))
    want = jax_compressed_param_shapes(jmodel, jshapes, 0.2, method="nsvd1")
    tmodel = build_model(dataclasses.replace(get_config(ARCH), num_layers=2))
    meta = jax.tree.map(lambda x: torch.empty(x.shape, device="meta",
                                              dtype=getattr(torch, str(x.dtype))), jshapes)
    got = compressed_param_shapes(tmodel, meta, 0.2, method="nsvd1")
    assert dict(_shape_leaves(got)) == dict(_shape_leaves(want))
    attn = got["g0"]["sub0"]["attn"]
    assert attn["wkv_b"]["u"].is_meta and attn["wkv_b"]["u"].shape[:2] == (2, 256)
    assert set(attn["wkv_a"]) == {"u", "v", "u2", "v2"}


# ---------------------------------------------------------------- serving

def _ref_engine(jmodel, jparams, **kw):
    """The reference engine (worst case, depth 1) with its prefill-admit
    calls' prompt widths recorded: each call is one admission group and one
    first-token read, so its host syncs are its steps plus these calls."""
    ref = JaxEngine(jmodel, jparams, pipeline_depth=1,
                    sched_config=SchedulerConfig(admission="worst_case"), **kw)
    widths = []
    prefill = ref._prefill

    def recorded(params, cache, tokens, *rest):
        widths.append(int(tokens.shape[1]))
        return prefill(params, cache, tokens, *rest)

    ref._prefill = recorded
    return ref, widths


def _by_width(widths):
    out = {}
    for w in widths:
        out[w] = out.get(w, 0) + 1
    return out


def _serve_both(jmodel, jparams, tmodel, tparams, prompts, max_new=6, **kw):
    """Both engines on ``prompts``: the streams, the reference engine and
    its admission widths, and the port's engine with its prefill-admit
    calls as (rows, width, requests admitted)."""
    ref, widths = _ref_engine(jmodel, jparams, **kw)
    eng = ServingEngine(tmodel, tparams, pipeline_depth=1, **kw)
    calls = []
    prefill = eng._prefill

    def recorded(params, cache, tokens, plens, slots, *rest):
        calls.append((int(tokens.shape[0]), int(tokens.shape[1]),
                      int((slots < eng.max_batch).sum())))
        return prefill(params, cache, tokens, plens, slots, *rest)

    eng._prefill = recorded
    ref_ids = [ref.submit(p, max_new_tokens=max_new) for p in prompts]
    ids = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    want, got = ref.run(), eng.run()
    return ([want[i] for i in ref_ids], [got[i] for i in ids], ref, widths, eng, calls)


# (prompt lengths, max_batch).  groups: three buckets of (16, 32, 64), a
# first group of three in bucket 16 (one of them queued behind a 40-token
# prompt), more than max_batch free slots never, and a later admission into
# freed slots; the calls admit groups of 3, 2 and 1.  padding: a group of 3
# in 4 free slots, admitted in 4 rows, one of them a padding row.
SLAB_CASES = {"groups": ((5, 40, 11, 16, 17, 33, 3), 3),
              "padding": ((5, 11, 3, 40, 20), 4)}


@pytest.mark.parametrize("case", sorted(SLAB_CASES))
@pytest.mark.parametrize("model", ["minicpm3", "mistral"])
def test_bucketed_slab_streams_match_reference_engine(model, case):
    """Pad-safe models on the dense slab: the reduced minicpm3 (MLA) and a
    tiny Mistral served with ``paged=False``.  Greedy streams equal the
    reference engine's; admission calls by prompt width (the bucket: one
    call a group), prefill calls and host syncs (one a step and one an
    admission group) equal the reference's; each call's rows are its
    group's size rounded up to a power of two, at most max_batch (the
    reference pads to max_batch), and the padding rows' writes drop."""
    lens, max_batch = SLAB_CASES[case]
    if model == "minicpm3":
        _, jmodel, jparams, tmodel, tparams, _ = _setup(spread=True)
        vocab, kw = 256, {}
    else:
        jmodel, jparams, tmodel, tparams = tiny_lm("nsvd1")
        vocab, kw = 64, {"paged": False}
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, vocab // 2, size=n) for n in lens]
    want, got, ref, widths, eng, calls = _serve_both(
        jmodel, jparams, tmodel, tparams, prompts, max_batch=max_batch, max_len=64, **kw)
    assert got == want
    assert eng.layout == "dense" and eng._bucketed
    st = eng.stats()
    assert eng.admissions_by_width == _by_width(widths)
    assert set(eng.admissions_by_width) <= {16, 32, 64}
    assert [w for _, w, _ in calls] == widths
    assert [r for r, _, _ in calls] == [
        min(max_batch, next(p for p in (1, 2, 4, 8) if p >= n)) for _, _, n in calls]
    assert st["prefill_ticks"] == len(widths) < len(lens)
    assert st["steps"] == ref.stats()["steps"]
    assert st["host_syncs"] == ref.stats()["steps"] + len(widths)
    assert all(r.finish_reason == "stop" for r in eng.finished_requests.values())
    if case == "groups":
        assert {n for _, _, n in calls} == {1, 2, 3}
    else:
        assert calls[0] == (4, 16, 3)


@pytest.mark.parametrize("family", ["rwkv", "moe"])
def test_pad_sensitive_slabs_keep_exact_length_admission(family):
    """RWKV-6 (recurrent state) and MoE (capacity over a call's tokens) are
    not pad-safe: one request a call at its exact length, in both engines;
    the streams equal the reference's."""
    if family == "rwkv":
        jmodel, jparams, tmodel, tparams = tiny_rwkv("dense")
    else:
        jcfg = jax_get_config("moonshot-v1-16b-a3b").reduced()
        jmodel = jax_build_model(jcfg)
        jparams = jmodel.init(jax.random.key(1))
        jparams["unembed"]["kernel"] = jparams["unembed"]["kernel"] * 8.0
        tmodel, tparams = build_model(get_config("moonshot-v1-16b-a3b").reduced()), \
            to_t(jparams)
    rng = np.random.default_rng(0)
    lens = (5, 11, 7, 11)
    prompts = [rng.integers(2, 200, size=n) for n in lens]
    want, got, ref, widths, eng, calls = _serve_both(jmodel, jparams, tmodel, tparams,
                                                     prompts, max_batch=2, max_len=32)
    assert got == want
    assert not eng._bucketed
    assert widths == list(lens)  # FIFO, one prompt a call at its length
    assert calls == [(1, n, 1) for n in lens]
    assert eng.admissions_by_width == _by_width(lens)
    st = eng.stats()
    assert st["prefill_ticks"] == len(lens)
    assert st["host_syncs"] == st["steps"] + len(lens)


def test_admit_step_drops_padding_rows():
    """The prefill-admit root on a pad-safe model: a (3, 8) call with one
    real row at slot 1 and two padding rows (slots >= max_batch) writes
    only slot 1's slab rows, length (its real length, not the padded
    width), last token, budget, key and active flag; every other slot keeps
    its values, and the first token comes from the last REAL position."""
    _, _, _, tmodel, tparams, _ = _setup()
    step = make_prefill_admit_step(tmodel, 16)
    g = torch.Generator().manual_seed(0)
    cache = tmodel.init_cache(4, 16, device="cpu")
    for leaf in (cache["g0"]["sub0"]["attn"]["c_kv"], cache["g0"]["sub0"]["attn"]["k_rope"]):
        leaf.copy_(torch.randn(leaf.shape, generator=g))
    before = {k: v.clone() for k, v in cache["g0"]["sub0"]["attn"].items()}
    state = [torch.tensor([7, 7, 7, 7], dtype=torch.int32),  # cache_len
             torch.tensor([1, 2, 3, 4], dtype=torch.int32),  # last_token
             torch.tensor([9, 9, 9, 9], dtype=torch.int32),  # budget
             torch.arange(8, dtype=torch.int64).reshape(4, 2),  # key_data
             torch.tensor([True, False, True, False])]  # active
    prompt = torch.tensor([5, 6, 7, 8, 9], dtype=torch.int32)
    tokens = torch.zeros((3, 8), dtype=torch.int32)
    tokens[0, :5] = prompt
    out = step(tparams, cache, tokens, torch.tensor([5, 1, 1], dtype=torch.int32),
               torch.tensor([1, 4, 4], dtype=torch.int32),
               torch.tensor([4, 0, 0], dtype=torch.int32),
               torch.tensor([[11, 0], [0, 0], [0, 0]], dtype=torch.int64), *state[:4],
               torch.zeros(3), state[4])
    first, cache_len, last_token, budget, key_data, active = out
    alone = tmodel.apply(tparams, prompt[None], mode="prefill",
                         cache=tmodel.init_cache(1, 16, device="cpu"))
    assert int(first[0]) == int(alone[0, -1].argmax())
    assert cache_len.tolist() == [7, 5, 7, 7]
    assert last_token.tolist() == [1, int(first[0]), 3, 4]
    assert budget.tolist() == [9, 4, 9, 9]
    assert key_data[[0, 2, 3]].tolist() == [[0, 1], [4, 5], [6, 7]]
    assert key_data[1].tolist() == [11, 1]
    assert active.tolist() == [True, True, True, False]
    for k, v in cache["g0"]["sub0"]["attn"].items():
        assert torch.equal(v[:, [0, 2, 3]], before[k][:, [0, 2, 3]]), k
        assert not torch.equal(v[:, 1], before[k][:, 1]), k
        assert bool((v[:, 1, 8:] == 0).all()), k  # the fresh row cache past P


def test_chip_mla_path_counts_hold_on_cpu():
    """chip_smoke's mla_serve schedule (MLA_PREDICTED's steps, admission
    calls by bucket and host syncs: they depend only on the prompt lengths
    and the plan) and each admission call's rows, on the reduced minicpm3
    on the CPU: *Serve*'s prompt lengths, max_batch 8, max_len 256, worst
    case, depth 1."""
    import chip_smoke as cs
    from repro_torch.launch.serve import serve

    tcfg = get_config(ARCH).reduced()
    rng = np.random.default_rng(0)
    plens = rng.integers(16, 201, size=8)
    prompts = [rng.integers(2, tcfg.vocab_size // 2, size=int(n)) for n in plens]
    calls = []

    def record(eng):
        prefill = eng._prefill

        def recorded(params, cache, tokens, *rest):
            calls.append((int(tokens.shape[1]), int(tokens.shape[0])))
            return prefill(params, cache, tokens, *rest)
        eng._prefill = recorded

    res = serve(tcfg, requests=8, max_new=32, max_batch=8, max_len=256, seed=0,
                compress=0.2, block_size=16, prefill_chunk=64, prompts=prompts,
                device="cpu", sched_policy="worst_case", pipeline_depth=1, on_engine=record)
    eng, p = res["engine"], cs.MLA_PREDICTED
    # Each admission call's (width, rows), as chip_smoke derives them from
    # the prompt lengths alone.
    assert sorted(calls) == cs.admission_calls(plens, True) == [(32, 4), (128, 4), (256, 2)]
    st = eng.stats()
    assert eng.layout == "dense" and eng._bucketed
    assert (st["steps"], st["prefill_ticks"], st["host_syncs"]) == (
        p["steps"], p["prefill_calls"], p["host_syncs"])
    assert eng.admissions_by_width == p["admissions"]
    assert all(len(v) == 32 for v in res["outputs"].values())
    # The nested calls a forward the launch counts are built from: 8 a layer
    # at prefill, 7 at decode (wkv_b through dense_kernel).
    model = res["model"]
    assert cs.nested_calls(model) == (8 * tcfg.num_layers, 0)
    assert cs.nested_calls(model, decode=True) == (7 * tcfg.num_layers, 0)
