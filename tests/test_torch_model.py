"""Port parity: DecoderLM logits (train, chunked prefill, paged decode)
against the JAX reference, dense and NSVD-compressed, for the three paper
families, with the reference's weights carried across by the bridge."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import t2np, tiny_cfgs, to_t

from repro.calib.runner import collect_grams as jax_collect_grams
from repro.core import CompressionConfig as JaxCompressionConfig
from repro.core import build_plan as jax_build_plan
from repro.core import compress_params as jax_compress_params
from repro.models import build_model as jax_build_model
from repro_torch.models import build_model

# fp32 on both sides; the two frameworks sum in different orders, so logits
# of O(1) agree to ~1e-6 relative — 1e-4 leaves room for depth.
TOL = dict(rtol=1e-4, atol=1e-4)
FAMILIES = ("small-llama", "small-opt", "small-mistral")


@functools.lru_cache(maxsize=None)  # shared by the tests of one family
def _setup(family, compressed):
    jcfg, tcfg = tiny_cfgs(family)
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
@pytest.mark.parametrize("family", FAMILIES)
def test_train_logits_match(family, compressed):
    jcfg, jmodel, tmodel, jparams, tparams = _setup(family, compressed)
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 11))
    want, _, _ = jmodel.apply(jparams, jnp.asarray(tokens, jnp.int32), mode="train")
    got = tmodel.apply(tparams, torch.as_tensor(tokens), mode="train")
    np.testing.assert_allclose(t2np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("compressed", [False, True])
@pytest.mark.parametrize("family", FAMILIES)
def test_chunked_prefill_then_paged_decode_match(family, compressed):
    """A prefill chunk (S > 1) then a decode step (S == 1) through the
    block table, rows of different lengths, one row with a -1 table entry
    past its reservation, and a dead row whose table is all -1."""
    jcfg, jmodel, tmodel, jparams, tparams = _setup(family, compressed)
    bs, nb, m = 4, 12, 5
    tables = np.asarray([[3, 0, 7, -1, -1], [1, 5, 2, 9, 4], [-1] * m], np.int32)
    starts = np.asarray([0, 6, 0], np.int32)
    rng = np.random.default_rng(2)
    chunk = rng.integers(0, jcfg.vocab_size, (3, 9))
    jpools = jmodel.init_paged_cache(nb, bs)
    tpools = tmodel.init_paged_cache(nb, bs, device="cpu")
    # Row 1 has 6 cached tokens from an earlier chunk.
    early = rng.integers(0, jcfg.vocab_size, (3, 6))
    zero = np.zeros(3, np.int32)
    _, jpools, _ = jmodel.apply(jparams, jnp.asarray(early, jnp.int32), mode="decode",
                                cache=jpools, cache_len=jnp.asarray(zero),
                                block_tables=jnp.asarray(tables))
    tmodel.apply(tparams, torch.as_tensor(early), mode="decode", cache=tpools,
                 cache_len=torch.as_tensor(zero), block_tables=torch.as_tensor(tables))
    jl, jpools, _ = jmodel.apply(jparams, jnp.asarray(chunk, jnp.int32), mode="decode",
                                 cache=jpools, cache_len=jnp.asarray(starts),
                                 block_tables=jnp.asarray(tables))
    tl = tmodel.apply(tparams, torch.as_tensor(chunk), mode="decode", cache=tpools,
                      cache_len=torch.as_tensor(starts),
                      block_tables=torch.as_tensor(tables))
    np.testing.assert_allclose(t2np(tl[:2]), np.asarray(jl[:2]), **TOL)
    step = rng.integers(0, jcfg.vocab_size, (3, 1))
    clen = starts + 9
    jd, jpools, _ = jmodel.apply(jparams, jnp.asarray(step, jnp.int32), mode="decode",
                                 cache=jpools, cache_len=jnp.asarray(clen),
                                 block_tables=jnp.asarray(tables))
    td = tmodel.apply(tparams, torch.as_tensor(step), mode="decode", cache=tpools,
                      cache_len=torch.as_tensor(clen),
                      block_tables=torch.as_tensor(tables))
    np.testing.assert_allclose(t2np(td[:2]), np.asarray(jd[:2]), **TOL)
    # Every pool block the reference wrote, the port wrote identically (the
    # dead row's writes dropped on both sides; the port's extra last block
    # is its write sink).
    jk = np.asarray(jpools["g0"]["sub0"]["attn"]["k"])
    np.testing.assert_allclose(t2np(tpools["g0"]["sub0"]["attn"]["k"][:, :nb]), jk, **TOL)


def test_compressible_targets_match():
    for family in FAMILIES:
        jcfg, tcfg = tiny_cfgs(family)
        jt = jax_build_model(jcfg).compressible_targets()
        tt = build_model(tcfg).compressible_targets()
        assert [(t.path, t.in_dim, t.out_dim, t.gram_key, t.stacked) for t in jt] \
            == [(t.path, t.in_dim, t.out_dim, t.gram_key, t.stacked) for t in tt]
