"""Port parity: calibration Grams and NSVD/NID/ASVD/SVD compression against the
JAX reference, and GramStore files crossing between the two packages."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import t2np, tiny_cfgs, to_np, to_t

from repro.calib.runner import collect_grams as jax_collect_grams
from repro.core import CompressionConfig as JaxCompressionConfig
from repro.core import GramStore as JaxGramStore
from repro.core import build_plan as jax_build_plan
from repro.core import compress_params as jax_compress_params
from repro.core.lowrank import dense_equivalent as jax_dense_equivalent
from repro.models import build_model as jax_build_model
from repro_torch.calib.gram import normalize_tap
from repro_torch.calib.runner import collect_grams
from repro_torch.core import CompressionConfig, GramStore, build_plan, compress_params
from repro_torch.core.lowrank import dense_equivalent
from repro_torch.models import build_model


@pytest.fixture(scope="module")
def calibrated(tmp_path_factory):
    jcfg, tcfg = tiny_cfgs("small-mistral", d_model=48, d_ff=64)
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    jparams = jmodel.init(jax.random.key(1))
    rng = np.random.default_rng(5)
    batches = [rng.integers(0, jcfg.vocab_size, (4, 24)).astype(np.int32)
               for _ in range(3)]
    jgrams = jax_collect_grams(jmodel, jparams, [{"tokens": jnp.asarray(b)} for b in batches])
    tparams = to_t(jparams)
    tgrams = collect_grams(tmodel, tparams, batches)
    path = os.path.join(tmp_path_factory.mktemp("grams"), "grams.npz")
    jgrams.save(path)
    return jmodel, tmodel, jparams, tparams, jgrams, tgrams, path


def test_normalize_tap():
    assert normalize_tap("g0/rep3/sub0.mlp.in") == ("g0/sub0.mlp.in", "3")
    assert normalize_tap("final.out_in") == ("final.out_in", "")


def test_grams_match_reference(calibrated):
    _, _, _, _, jgrams, tgrams, _ = calibrated
    assert set(tgrams.keys()) == set(jgrams.keys())
    for k in jgrams.keys():
        want = np.asarray(jgrams.gram(k))
        # fp32 Grams of O(1) activations summed over ~100 rows: sum-order
        # differences are ~1e-6 relative to the largest entry.
        np.testing.assert_allclose(t2np(tgrams.gram(k)), want,
                                   rtol=1e-5, atol=1e-5 * np.abs(want).max())
        np.testing.assert_allclose(t2np(tgrams.absmean(k)), np.asarray(jgrams.absmean(k)),
                                   rtol=1e-5, atol=1e-6)
        assert tgrams.count(k) == jgrams.count(k)


def test_gram_files_cross_both_ways(calibrated, tmp_path):
    _, _, _, _, jgrams, tgrams, path = calibrated
    loaded = GramStore.load(path, device="cpu")  # reference file -> port
    assert set(loaded.keys()) == set(jgrams.keys())
    k = next(iter(jgrams.keys()))
    np.testing.assert_array_equal(loaded.gram(k).numpy(), np.asarray(jgrams.gram(k)))
    out = os.path.join(tmp_path, "port.npz")
    tgrams.save(out)  # port file -> reference
    back = JaxGramStore.load(out)
    assert set(back.keys()) == set(tgrams.keys())
    np.testing.assert_array_equal(np.asarray(back.gram(k)), tgrams.gram(k).numpy())


def _leaves(tree, prefix=()):
    if isinstance(tree, dict) and not ({"kernel", "u"} & set(tree)):
        for key in sorted(tree):
            yield from _leaves(tree[key], prefix + (key,))
    elif isinstance(tree, dict):
        yield prefix, tree


@pytest.mark.parametrize("method", ["nsvd1", "nsvd2", "asvd0", "asvd1", "asvd2", "svd",
                                    "asvd3", "nid1", "nid2"])
def test_compress_params_match_reference(calibrated, method):
    """Same params and Grams in: equal plans (summary, ranks), equal k1/k2
    splits, and dense equivalents within 1e-5 relative.  Factors are not
    compared leaf by leaf: SVD signs are not unique."""
    jmodel, tmodel, jparams, tparams, _, _, path = calibrated
    kw = dict(method=method, ratio=0.3, dtype="float32", use_randomized=False)
    jplan = jax_build_plan(jmodel.compressible_targets(), JaxCompressionConfig(**kw))
    tplan = build_plan(tmodel.compressible_targets(), CompressionConfig(**kw))
    assert tplan.summary() == jplan.summary()
    assert dict(tplan.ranks) == dict(jplan.ranks)
    want = to_np(jax_compress_params(jparams, jplan, JaxGramStore.load(path)))
    got = compress_params(tparams, tplan, GramStore.load(path, device="cpu"))
    wl, gl = dict(_leaves(want)), dict(_leaves(got))
    assert wl.keys() == gl.keys()
    for name, w in wl.items():
        g = gl[name]
        assert set(g) == set(w)
        for key in g:
            assert tuple(g[key].shape) == w[key].shape, (name, key)
        jd = np.asarray(jax_dense_equivalent({k: jnp.asarray(v) for k, v in w.items()}))
        td = t2np(dense_equivalent(g))
        rel = np.linalg.norm(td - jd) / np.linalg.norm(jd)
        assert rel < 1e-5, (name, rel)


def test_randomized_svd_matches_reference():
    """The randomized range finder draws its test matrix from numpy exactly
    as the reference does, so the truncations agree to fp64 round-off."""
    from repro.core.svd import randomized_svd as jax_randomized_svd
    from repro_torch.core.svd import randomized_svd

    rng = np.random.default_rng(9)
    a = rng.standard_normal((120, 80)) * np.exp(-np.arange(80) / 10.0)
    want = jax_randomized_svd(a, 12).matrix()
    got = randomized_svd(torch.as_tensor(a), 12).matrix().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9 * np.abs(want).max())
