"""Port parity for evaluation: perplexity, logit KL, per-target attribution
and activation similarity on a tiny fp32 model whose dense and compressed
params cross from the reference through the bridge; the eval streams and
the next-token loss against the reference's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import tiny_cfgs, to_t

from repro.calib.runner import collect_grams as jax_collect_grams
from repro.core import CompressionConfig as JaxCompressionConfig
from repro.core import build_plan as jax_build_plan
from repro.core import compress_params as jax_compress_params
from repro.data.synth import DomainSampler as JaxDomainSampler
from repro.eval.attribution import mean_logit_kl as jax_mean_logit_kl
from repro.eval.attribution import per_target_attribution as jax_per_target_attribution
from repro.eval.perplexity import activation_similarity as jax_activation_similarity
from repro.eval.perplexity import eval_batches as jax_eval_batches
from repro.eval.perplexity import evaluate_ppl as jax_evaluate_ppl
from repro.models import build_model as jax_build_model
from repro.models.losses import next_token_xent as jax_next_token_xent
from repro_torch.data.synth import DomainSampler
from repro_torch.eval.attribution import get_subtree, mean_logit_kl, per_target_attribution
from repro_torch.eval.attribution import swap_subtree
from repro_torch.eval.perplexity import activation_similarity, eval_batches, evaluate_ppl
from repro_torch.models import build_model
from repro_torch.models.losses import next_token_xent

VOCAB = 64


@pytest.fixture(scope="module")
def pair():
    """(reference model, port model, dense and compressed params on each
    side, reference plan): a tiny calibrated and nsvd1-compressed LLaMA."""
    jcfg, tcfg = tiny_cfgs("small-llama", d_model=32, d_ff=48, vocab=VOCAB)
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    jparams = jmodel.init(jax.random.key(0))
    jparams = jax.tree.map(lambda a: a * 3.0 if a.ndim >= 2 else a, jparams)  # spread logits
    batches = list(jax_eval_batches(VOCAB, "en_a", 3, 4, 24, seed=5))
    jgrams = jax_collect_grams(jmodel, jparams, batches)
    jplan = jax_build_plan(jmodel.compressible_targets(), JaxCompressionConfig(
        method="nsvd1", ratio=0.3, k1_frac=0.9, dtype="float32", use_randomized=False))
    jcomp = jax_compress_params(jparams, jplan, jgrams)
    return jmodel, tmodel, jparams, jcomp, to_t(jparams), to_t(jcomp), jplan


def _jax_stream(domain, n=2, batch=4, seq=24):
    return list(jax_eval_batches(VOCAB, domain, n, batch, seq))


def test_eval_batches_match_reference():
    for d in ("en_a", "zh"):
        got = list(eval_batches(VOCAB, d, 3, 4, 24))
        want = [b["tokens"] for b in _jax_stream(d, 3)]
        assert all(np.array_equal(g, w) and g.dtype == w.dtype for g, w in zip(got, want))


@pytest.mark.parametrize("vocab,shape", [(512, (16, 128)), (32000, (2, 300)), (VOCAB, (3, 9))])
def test_domain_sampler_bit_identical(vocab, shape):
    """The port's sampler draws by binary search over precomputed CDFs; the
    reference counts per step.  Same draws, every domain and the mix."""
    a, b = DomainSampler(vocab, seed=3), JaxDomainSampler(vocab, seed=3)
    for d in ("en_a", "en_b", "task", "zh", "jp", "mix"):
        x, y = a.batch(d, *shape), b.batch(d, *shape)
        assert x.dtype == y.dtype and np.array_equal(x, y), d


@pytest.mark.parametrize("masked", [False, True])
def test_next_token_xent_matches_reference(masked):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((3, 7, 11)).astype(np.float32) * 3
    tokens = rng.integers(0, 11, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) > 0.3).astype(np.float32) if masked else None
    want = jax_next_token_xent(jnp.asarray(logits), jnp.asarray(tokens),
                               None if mask is None else jnp.asarray(mask))
    got = next_token_xent(torch.as_tensor(logits), torch.as_tensor(tokens),
                          None if mask is None else torch.as_tensor(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("which", ["dense", "compressed"])
@pytest.mark.parametrize("domain", ["en_a", "jp"])
def test_evaluate_ppl_matches_reference(pair, which, domain):
    """fp32 model, same batches: perplexities within 1e-5 relative (matmul
    and softmax sum order)."""
    jmodel, tmodel, jd, jc, td, tc, _ = pair
    jp, tp = (jd, td) if which == "dense" else (jc, tc)
    want = jax_evaluate_ppl(jmodel, jp, _jax_stream(domain))
    got = evaluate_ppl(tmodel, tp, eval_batches(VOCAB, domain, 2, 4, 24))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_mean_logit_kl_matches_reference(pair):
    """KL of two fp32 forwards: within 1e-4 relative plus 1e-7 nats."""
    jmodel, tmodel, jd, jc, td, tc, _ = pair
    want = jax_mean_logit_kl(jmodel, jd, jc, _jax_stream("en_a"))
    got = mean_logit_kl(tmodel, td, tc, eval_batches(VOCAB, "en_a", 2, 4, 24))
    assert want > 1e-4  # the compression moved the logits
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)
    assert abs(mean_logit_kl(tmodel, td, td, eval_batches(VOCAB, "en_a", 1, 4, 24))) < 1e-6


def test_per_target_attribution_matches_reference(pair):
    """Same targets in the same order (by KL), per-target KL within 1e-4
    relative, shares within 1e-4 absolute."""
    jmodel, tmodel, jd, jc, td, tc, jplan = pair
    want = jax_per_target_attribution(jmodel, jd, jc, jplan.targets,
                                      lambda: _jax_stream("en_a", 1))
    got = per_target_attribution(tmodel, td, tc, jplan.targets,
                                 lambda: eval_batches(VOCAB, "en_a", 1, 4, 24))
    assert [r["target"] for r in got] == [r["target"] for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["logit_kl"], w["logit_kl"], rtol=1e-4, atol=1e-7)
        assert abs(g["share"] - w["share"]) < 1e-4
    assert abs(sum(r["share"] for r in got) - 1.0) < 1e-9


def test_activation_similarity_matches_reference(pair):
    jmodel, tmodel, jd, _, td, _, _ = pair
    want = jax_activation_similarity(jmodel, jd, "en_a", "zh", VOCAB, n_batches=2)
    got = activation_similarity(tmodel, td, "en_a", "zh", VOCAB, n_batches=2)
    assert got.keys() == want.keys() and len(got) == 2 * 2  # attn.in, mlp.in per layer
    for k in want:
        assert abs(got[k] - want[k]) < 1e-6, k


def test_swap_subtree_is_copy_on_path():
    tree = {"a": {"b": {"kernel": torch.zeros(2)}, "c": torch.ones(1)}, "d": torch.ones(3)}
    leaf = {"u": torch.ones(2)}
    out = swap_subtree(tree, ("a", "b"), leaf)
    assert get_subtree(out, ("a", "b")) is leaf
    assert "kernel" in tree["a"]["b"]  # the input is untouched
    assert out["d"] is tree["d"] and out["a"]["c"] is tree["a"]["c"]
