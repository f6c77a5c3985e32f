"""Port parity for the RWKV-6 slice: the port's ``rwkv6`` wrapper (its plain
sequential scan on the CPU) against the reference's scan oracle and its
chunked Pallas kernel in interpret mode, the final state against the
reference scan's carry, the time-mix / channel-mix layers and the whole
reduced rwkv6-1.6b model (train, prefill, decode and their caches) against
the JAX model with the reference's weights carried across by the bridge,
and calibration + compression (targets, Gram keys, dense equivalents).

All fp32 on the CPU (the reduced config is fp32), inputs from numpy seeds.
"""

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
from repro.core import GramStore as JaxGramStore
from repro.core import build_plan as jax_build_plan
from repro.core import compress_params as jax_compress_params
from repro.core.lowrank import dense_equivalent as jax_dense_equivalent
from repro.kernels.rwkv6.ops import rwkv6_attention as jax_rwkv6_attention
from repro.kernels.rwkv6.ref import rwkv6_scan_ref as jax_rwkv6_scan_ref
from repro.models import build_model as jax_build_model
from repro.models import rwkv6 as jax_rwkv6
from repro_torch.calib.runner import collect_grams
from repro_torch.configs import get_config
from repro_torch.core import CompressionConfig, GramStore, build_plan, compress_params
from repro_torch.core.lowrank import dense_equivalent
from repro_torch.kernels.rwkv6 import ops as rwkv_ops
from repro_torch.kernels.rwkv6.ops import rwkv6_attention, rwkv6_heads
from repro_torch.kernels.rwkv6.ref import rwkv6_scan_ref
from repro_torch.models import build_model, rwkv6

# Plain scan vs the reference's scan: the same fp32 recurrence, einsums
# summed in another order (~1e-7 relative).
SCAN_TOL = dict(rtol=1e-5, atol=1e-5)
# Scan vs the chunked Pallas kernel: the reference's own kernel tolerance
# (tests/test_kernels.py), exp/log of cumulated log-decays vs products.
CHUNK_TOL = dict(rtol=2e-4, atol=2e-4)
# Layers and logits: fp32 on both sides, sum order only (the dense
# families' tolerance, tests/test_torch_model.py).
TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(bh, t, k, seed, w=None, scale=0.5):
    rng = np.random.default_rng(seed)
    r, kk, v = (rng.standard_normal((bh, t, k)).astype(np.float32) * scale
                for _ in range(3))
    if w is None:  # decays in (0, 1), strong ones included
        w = rng.uniform(0.01, 0.999, (bh, t, k)).astype(np.float32)
    u = (rng.standard_normal((bh, k)) * scale).astype(np.float32)
    return r, kk, v, np.broadcast_to(np.float32(w), (bh, t, k)).copy(), u


def _t(arrays):
    return [torch.as_tensor(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _reference_carry(r, k, v, w, u):
    """The reference scan's final state S_T, read through the reference's
    own ``rwkv6_scan_ref``: K more steps with k = v = 0 and w = 1 leave S_T
    unchanged, and step i with r = e_i yields row i of S_T."""
    bh, _, kd = r.shape
    eye = np.broadcast_to(np.eye(kd, dtype=np.float32), (bh, kd, kd))
    zero = np.zeros((bh, kd, kd), np.float32)
    ext = [np.concatenate([a, b], 1) for a, b in
           ((r, eye), (k, zero), (v, zero), (w, np.ones_like(zero)))]
    return np.asarray(jax_rwkv6_scan_ref(*_j(ext), jnp.asarray(u)))[:, -kd:]


@pytest.mark.parametrize("bh,t,k", [(2, 32, 16), (3, 40, 16), (1, 48, 64), (2, 7, 8)])
def test_plain_scan_matches_reference_scan(bh, t, k):
    args = _inputs(bh, t, k, seed=bh * 100 + t)
    want = np.asarray(jax_rwkv6_scan_ref(*_j(args)))
    got = rwkv6_scan_ref(*_t(args))
    assert got.dtype == torch.float32 and got.shape == (bh, t, k)
    np.testing.assert_allclose(t2np(got), want, **SCAN_TOL)


@pytest.mark.parametrize("bh,t,k,chunk", [
    (2, 32, 16, 8),
    (4, 64, 32, 16),
    (1, 48, 64, 16),
    (2, 40, 16, 16),   # T not a multiple of the chunk: the reference pads
])
def test_wrapper_matches_chunked_pallas_interpret(bh, t, k, chunk):
    """The reference kernel test's shapes and tolerance."""
    args = _inputs(bh, t, k, seed=4)
    want = np.asarray(jax_rwkv6_attention(*_j(args), chunk=chunk, interpret=True))
    np.testing.assert_allclose(t2np(rwkv6_attention(*_t(args))), want, **CHUNK_TOL)


def test_extreme_decay_matches_chunked_pallas_interpret():
    """w = 1e-6, where chunk algebra without the per-chunk rebase overflows."""
    args = _inputs(2, 32, 16, seed=5, w=1e-6, scale=1.0)
    args = (*args[:4], np.zeros_like(args[4]))
    want = np.asarray(jax_rwkv6_attention(*_j(args), chunk=8, interpret=True))
    got = t2np(rwkv6_attention(*_t(args)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **CHUNK_TOL)


@pytest.mark.parametrize("bh,t,k", [(2, 40, 16), (1, 17, 64), (3, 1, 8)])
def test_final_state_matches_reference_carry(bh, t, k):
    args = _inputs(bh, t, k, seed=t)
    y, state = rwkv6_attention(*_t(args), return_state=True)
    assert state.dtype == torch.float32 and state.shape == (bh, k, k)
    np.testing.assert_allclose(t2np(state), _reference_carry(*args), **SCAN_TOL)
    np.testing.assert_allclose(t2np(y), t2np(rwkv6_attention(*_t(args))), rtol=0, atol=0)


def test_heads_layout_reads_model_layout():
    """``rwkv6_heads`` on permuted (B, T, H, K) views and a broadcast bonus
    equals the flat (BH, T, K) call."""
    b, t, h, k = 2, 21, 3, 8
    rng = np.random.default_rng(6)
    r, kk, v = (torch.as_tensor(rng.standard_normal((b, t, h, k)).astype(np.float32))
                for _ in range(3))
    w = torch.as_tensor(rng.uniform(0.05, 0.99, (b, t, h, k)).astype(np.float32))
    bonus = torch.as_tensor(rng.standard_normal((h, k)).astype(np.float32))
    y, s = rwkv6_heads(*(x.permute(0, 2, 1, 3) for x in (r, kk, v, w)),
                       bonus.expand(b, h, k), return_state=True)
    flat = [x.permute(0, 2, 1, 3).reshape(b * h, t, k) for x in (r, kk, v, w)]
    wy, ws = rwkv6_scan_ref(*flat, bonus.repeat(b, 1), return_state=True)
    assert torch.equal(y.reshape(b * h, t, k), wy) and torch.equal(s.reshape(b * h, k, k), ws)


# ------------------------------------------------------------ launch plan

@pytest.mark.parametrize("heads", [1, 3])
@pytest.mark.parametrize("k", rwkv_ops.HEAD_DIMS)
def test_plan_covers_every_head_row_and_column_once(k, heads):
    """Every (head, row of S) and every (head, column of y) belongs to
    exactly one block; a head's blocks are one cluster of K/16 (one block
    for K <= 16), consecutive in the grid, as the cluster launch groups
    them."""
    p = rwkv_ops.plan((1, heads, 40, k), 4, [0] * 4, [0, 40 * k, k])
    assert p.cluster == max(1, k // 16) and p.blocks(heads) == heads * p.cluster
    assert p.threads == (128 if k >= 32 else 4 * k) and p.threads % 32 == 0
    rows, cols = {}, {}
    for block in range(p.blocks(heads)):
        head, own_rows, own_cols = p.owned(block)
        assert head == block // p.cluster
        for j in own_rows:
            rows[(head, j)] = rows.get((head, j), 0) + 1
        for c in own_cols:
            cols[(head, c)] = cols.get((head, c), 0) + 1
    every = {(hd, j) for hd in range(heads) for j in range(k)}
    assert set(rows) == every and set(rows.values()) == {1}
    assert set(cols) == every and set(cols.values()) == {1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [16, 64])
def test_plan_model_layout_and_contiguous_take_16_byte_copies(k, dtype):
    """The model's permuted (B, T, H, K) views (T stride H K) and contiguous
    (B, H, T, K) tensors: 16-byte copies."""
    b, t, h = 2, 37, 4
    model = torch.zeros((b, t, h, k), dtype=dtype).permute(0, 2, 1, 3)
    flat = torch.zeros((b, h, t, k), dtype=dtype)
    for x in (model, flat, flat[:, :, 16:], flat[1:]):
        p = rwkv_ops.plan(x.shape, x.element_size(), [x.data_ptr()] * 4, x.stride())
        assert p.vec == 16, (x.shape, x.stride())


@pytest.mark.parametrize("dtype,offset,vec", [
    (torch.float32, 1, 4), (torch.float32, 3, 4), (torch.bfloat16, 2, 4),
    (torch.bfloat16, 1, 0), (torch.bfloat16, 3, 0)])
def test_plan_offset_view_takes_narrow_copies(dtype, offset, vec):
    """A view ``offset`` elements into its storage: 4-byte copies when the
    base is 4-byte aligned, else none (the wrapper copies the inputs)."""
    buf = torch.zeros(2 * 3 * 20 * 64 + offset, dtype=dtype)
    x = buf[offset:].view(2, 3, 20, 64)
    p = rwkv_ops.plan(x.shape, x.element_size(), [x.data_ptr()] * 4, x.stride())
    assert p.vec == vec


@pytest.mark.parametrize("dtype,vec", [(torch.float32, 4), (torch.bfloat16, 0)])
def test_plan_odd_t_stride_takes_narrow_copies(dtype, vec):
    """(B, T, H, K + 1) storage sliced to K and permuted: an odd T (and H)
    stride in elements."""
    x = torch.zeros((2, 30, 3, 65), dtype=dtype)[..., :64].permute(0, 2, 1, 3)
    p = rwkv_ops.plan(x.shape, x.element_size(), [x.data_ptr()] * 4, x.stride())
    assert p.vec == vec


def test_plan_ignores_strides_of_unit_dims():
    """A stride the kernel never multiplies (a dimension of length 1) does
    not narrow the copies; a misaligned base among the four does."""
    p = rwkv_ops.plan((1, 1, 1, 64), 4, [64, 128, 192, 256], [7, 5, 3])
    assert p.vec == 16
    assert rwkv_ops.plan((1, 1, 2, 64), 4, [64, 128, 192, 256], [7, 5, 3]).vec == 4
    assert rwkv_ops.plan((2, 1, 1, 64), 4, [64, 128, 192, 260], [64, 5, 3]).vec == 4


def test_plan_rejects_other_head_dims():
    with pytest.raises(ValueError):
        rwkv_ops.plan((1, 1, 8, 24), 4, [0] * 4, [0, 0, 24])


# ------------------------------------------------------------------ model

def _cfgs():
    return jax_get_config("rwkv6-1.6b").reduced(), get_config("rwkv6-1.6b").reduced()


def test_reduced_config_matches_reference():
    jcfg, tcfg = _cfgs()
    for f in ("num_layers", "d_model", "num_heads", "d_ff", "vocab_size", "head_dim",
              "norm", "pos_emb", "activation", "mixer_pattern", "dtype", "subquadratic"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert (tcfg.rwkv.head_dim, tcfg.rwkv.decay_lora, tcfg.rwkv.mix_lora) == \
        (jcfg.rwkv.head_dim, jcfg.rwkv.decay_lora, jcfg.rwkv.mix_lora)


def test_time_mix_and_channel_mix_match_reference():
    """Causal (train), prefill into a fresh cache, and one decode step of
    both layers, with the reference's params; caches compared leaf by leaf."""
    jcfg, tcfg = _cfgs()
    kt, kc = jax.random.split(jax.random.key(7))
    jt = jax_rwkv6.rwkv_time_mix_init(kt, jcfg, jnp.float32)
    jc = jax_rwkv6.rwkv_channel_mix_init(kc, jcfg, jnp.float32)
    tt, tc = to_t(jt), to_t(jc)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 13, tcfg.d_model)).astype(np.float32)
    x1 = rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)

    want_t, _ = jax_rwkv6.rwkv_time_mix(jt, jnp.asarray(x), jcfg)
    want_c, _ = jax_rwkv6.rwkv_channel_mix(jc, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(t2np(rwkv6.rwkv_time_mix(tt, torch.as_tensor(x), tcfg)),
                               np.asarray(want_t), **TOL)
    np.testing.assert_allclose(t2np(rwkv6.rwkv_channel_mix(tc, torch.as_tensor(x), tcfg)),
                               np.asarray(want_c), **TOL)

    jcache = jax_rwkv6.init_rwkv_cache(jcfg, 2, jnp.float32)
    tcache = rwkv6.init_rwkv_cache(tcfg, 2, torch.float32, "cpu")
    for mode, inp in (("causal", x), ("decode", x1)):
        jy, nc = jax_rwkv6.rwkv_time_mix(jt, jnp.asarray(inp), jcfg, mode=mode, cache=jcache)
        jz, ncc = jax_rwkv6.rwkv_channel_mix(jc, jnp.asarray(inp), jcfg, mode=mode,
                                             cache=jcache)
        jcache = {**nc, **ncc}
        ty = rwkv6.rwkv_time_mix(tt, torch.as_tensor(inp), tcfg, mode=mode, cache=tcache)
        tz = rwkv6.rwkv_channel_mix(tc, torch.as_tensor(inp), tcfg, mode=mode, cache=tcache)
        np.testing.assert_allclose(t2np(ty), np.asarray(jy), **TOL)
        np.testing.assert_allclose(t2np(tz), np.asarray(jz), **TOL)
        for leaf in ("state", "shift_t", "shift_c"):
            np.testing.assert_allclose(t2np(tcache[leaf]), np.asarray(jcache[leaf]), **TOL,
                                       err_msg=f"{mode} {leaf}")


@functools.lru_cache(maxsize=None)
def _setup(compressed):
    jcfg, tcfg = _cfgs()
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    jparams = jmodel.init(jax.random.key(0))
    if compressed:
        rng = np.random.default_rng(3)
        batches = [{"tokens": jnp.asarray(rng.integers(0, jcfg.vocab_size, (4, 32)),
                                          jnp.int32)} for _ in range(2)]
        grams = jax_collect_grams(jmodel, jparams, batches)
        plan = jax_build_plan(jmodel.compressible_targets(), JaxCompressionConfig(
            method="nsvd1", ratio=0.3, dtype="float32", use_randomized=False))
        jparams = jax_compress_params(jparams, plan, grams)
    return jcfg, jmodel, tmodel, jparams, to_t(jparams)


@pytest.mark.parametrize("compressed", [False, True])
def test_train_logits_match(compressed):
    jcfg, jmodel, tmodel, jparams, tparams = _setup(compressed)
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 23))
    want, _, _ = jmodel.apply(jparams, jnp.asarray(tokens, jnp.int32), mode="train")
    got = tmodel.apply(tparams, torch.as_tensor(tokens), mode="train")
    np.testing.assert_allclose(t2np(got), np.asarray(want), **TOL)


def _cache_leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _cache_leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


@pytest.mark.parametrize("compressed", [False, True])
def test_prefill_then_decode_match(compressed):
    """Prefill two prompts into a fresh dense cache, then two decode steps:
    logits and every cache leaf (stacked state and shifts) match."""
    jcfg, jmodel, tmodel, jparams, tparams = _setup(compressed)
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, jcfg.vocab_size, (2, 19))
    jcache = jmodel.init_cache(2, 32)
    tcache = tmodel.init_cache(2, 32, device="cpu")
    jl, jcache, _ = jmodel.apply(jparams, jnp.asarray(prompt, jnp.int32), mode="prefill",
                                 cache=jcache)
    tl = tmodel.apply(tparams, torch.as_tensor(prompt), mode="prefill", cache=tcache)
    np.testing.assert_allclose(t2np(tl), np.asarray(jl), **TOL)
    clen = np.full(2, 19, np.int32)
    for _ in range(2):
        step = rng.integers(0, jcfg.vocab_size, (2, 1))
        jd, jcache, _ = jmodel.apply(jparams, jnp.asarray(step, jnp.int32), mode="decode",
                                     cache=jcache, cache_len=jnp.asarray(clen))
        td = tmodel.apply(tparams, torch.as_tensor(step), mode="decode", cache=tcache,
                          cache_len=torch.as_tensor(clen))
        np.testing.assert_allclose(t2np(td), np.asarray(jd), **TOL)
        clen = clen + 1
    want, got = dict(_cache_leaves(to_np(jcache))), dict(_cache_leaves(tcache))
    assert want.keys() == got.keys()
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape, name
        np.testing.assert_allclose(t2np(got[name]), w, **TOL, err_msg=name)


@pytest.fixture(scope="module")
def calibrated(tmp_path_factory):
    jcfg, tcfg = _cfgs()
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    jparams = jmodel.init(jax.random.key(1))
    rng = np.random.default_rng(5)
    batches = [rng.integers(0, jcfg.vocab_size, (4, 24)).astype(np.int32)
               for _ in range(3)]
    jgrams = jax_collect_grams(jmodel, jparams, [{"tokens": jnp.asarray(b)} for b in batches])
    tparams = to_t(jparams)
    tgrams = collect_grams(tmodel, tparams, batches)
    path = str(tmp_path_factory.mktemp("grams") / "grams.npz")
    jgrams.save(path)
    return jmodel, tmodel, jparams, tparams, jgrams, tgrams, path


def test_compressible_targets_and_gram_keys_match(calibrated):
    """8 targets per layer (rwkv_t/{wr,wk,wv,wg,wo}, rwkv_c/{wk,wv,wr}); 9
    taps per layer (w_in has a Gram though no target reads it)."""
    jmodel, tmodel, _, _, jgrams, tgrams, _ = calibrated
    jt, tt = jmodel.compressible_targets(), tmodel.compressible_targets()
    assert [(t.path, t.in_dim, t.out_dim, t.gram_key, t.stacked) for t in tt] \
        == [(t.path, t.in_dim, t.out_dim, t.gram_key, t.stacked) for t in jt]
    assert len(tt) == 8
    assert set(tgrams.keys()) == set(jgrams.keys())
    layers = tmodel.cfg.num_layers
    assert len(tgrams.keys()) == 9 * (layers + 1) + 1
    for k in jgrams.keys():
        want = np.asarray(jgrams.gram(k))
        np.testing.assert_allclose(t2np(tgrams.gram(k)), want,
                                   rtol=1e-5, atol=1e-5 * np.abs(want).max(), err_msg=k)
        assert tgrams.count(k) == jgrams.count(k)


def _targets(tree, prefix=()):
    if isinstance(tree, dict) and not ({"kernel", "u"} & set(tree)):
        for key in sorted(tree):
            yield from _targets(tree[key], prefix + (key,))
    elif isinstance(tree, dict):
        yield prefix, tree


@pytest.mark.parametrize("grams_from", ["reference", "port"])
def test_compressed_dense_equivalents_match(calibrated, grams_from):
    """nsvd1 on the same params: equal plans, and dense equivalents within
    1e-5 relative, from the reference's GramStore file or from the port's
    own calibration.  Factors are not compared leaf by leaf (SVD signs)."""
    jmodel, tmodel, jparams, tparams, _, tgrams, path = calibrated
    kw = dict(method="nsvd1", ratio=0.3, dtype="float32", use_randomized=False)
    jplan = jax_build_plan(jmodel.compressible_targets(), JaxCompressionConfig(**kw))
    tplan = build_plan(tmodel.compressible_targets(), CompressionConfig(**kw))
    assert tplan.summary() == jplan.summary()
    want = to_np(jax_compress_params(jparams, jplan, JaxGramStore.load(path)))
    got = compress_params(tparams, tplan, GramStore.load(path, device="cpu")
                          if grams_from == "reference" else tgrams)
    wl, gl = dict(_targets(want)), dict(_targets(got))
    assert wl.keys() == gl.keys()
    assert sum("u2" in w for w in wl.values()) == 8  # every target nested
    for name, w in wl.items():
        jd = np.asarray(jax_dense_equivalent({k: jnp.asarray(v) for k, v in w.items()}))
        td = t2np(dense_equivalent(gl[name]))
        rel = np.linalg.norm(td - jd) / np.linalg.norm(jd)
        assert rel < 1e-5, (name, rel)
