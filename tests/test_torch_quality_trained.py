"""The quality target on trained weights: both packages' ``build_entry``
(calibrate -> compress -> evaluate) on small-llama trained by the
reference's recipe (``benchmarks.common.train_small_lm``: 300 fp32 AdamW
steps of 16 x 128 ``mix`` tokens, on the CPU), with the
``BENCH_quality.json`` entry's settings: nsvd1, ratio 0.2, k1_frac 0.9,
128 calibration samples, 4 eval batches of 16 x 128.  The port's GramStore
is kept in host memory, in one group of layers a pass.

The checkpoint is committed under ``tests/torch_data/small-llama/`` in the
reference's layout (one ``.npy`` a leaf and a JSON manifest), so both
packages read the same weights; the reference restores it through
``train_small_lm`` from a temporary copy named by
``benchmarks.common.MODELS_DIR``.

Tolerances (port against reference, fp32 forwards summed in another
order, fp64 decompositions of Grams that differ at fp32 rounding):
perplexities PPL_REL, the logit KL KL_REL, the decomposition errors and
absorption DECOMP_REL, the activation similarity SIM_REL; the achieved
ratio and parameter counts exactly.

The entry of commit 91ffdda (``BENCH_quality.json``) was made by the
reference on weights it trained then: on these weights, trained by the
same recipe today, the reference reproduces its achieved ratio and
parameter counts exactly (held below for both packages) but none of its
perplexities, errors or KL (ROADMAP C: dense en_a 132.164 against
131.581, the jp ratio 1.2030 against 1.1365)."""

import os
import shutil

import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.obs.quality_report import EVAL_DOMAINS, build_entry

CHECKPOINT = os.path.join(os.path.dirname(__file__), "torch_data", "small-llama")
SETTINGS = dict(method="nsvd1", ratio=0.2, k1_frac=0.9, eval_n_batches=4, calib_samples=128,
                attribution=False)
PPL_REL = 1e-5
KL_REL = 1e-4
DECOMP_REL = 1e-5
SIM_REL = 1e-6

# BENCH_quality.json, entry 91ffdda (git_sha 91ffdda3ce21, config_hash
# 4ffc1ea63c36): the numbers the reference reproduces on these weights.
ENTRY_91FFDDA = {"achieved_ratio": 0.20169005102040816, "targets": 7,
                 "dense_params": 802816, "factored_params": 640896,
                 "gram_fallback_slices": 0}


@pytest.fixture(scope="module")
def entries(tmp_path_factory):
    """(reference entry, port entry) on the committed checkpoint."""
    import benchmarks.common as bench
    from repro.obs.quality_report import build_entry as jax_build_entry

    models = tmp_path_factory.mktemp("models")
    shutil.copytree(CHECKPOINT, models / "small-llama")
    with pytest.MonkeyPatch.context() as m:
        m.setattr(bench, "MODELS_DIR", str(models))
        want = jax_build_entry("small-llama", **SETTINGS)
    # The reference restored the checkpoint and trained nothing.
    assert sorted(os.listdir(models / "small-llama")) == ["step_00000000"]
    params, _ = bridge.load_checkpoint(bridge.latest_checkpoint(CHECKPOINT), "cpu")
    assert params["embed"]["table"].dtype == torch.float32
    got = build_entry(get_config("small-llama"), params=params, grams_on="host", **SETTINGS)
    return want, got


@pytest.mark.parametrize("domain", EVAL_DOMAINS)
def test_perplexities_match_the_reference(entries, domain):
    want, got = entries
    for key in ("dense_ppl", "compressed_ppl", "ppl_ratio"):
        assert got[key][domain] == pytest.approx(want[key][domain], rel=PPL_REL), key
    # Compression costs perplexity on every domain.
    assert got["compressed_ppl"][domain] > got["dense_ppl"][domain]


def test_decomposition_and_kl_match_the_reference(entries):
    want, got = entries
    assert got["achieved_ratio"] == want["achieved_ratio"]
    wd, gd = want["decomposition"], got["decomposition"]
    for key in ("targets", "dense_params", "factored_params", "achieved_ratio",
                "gram_fallback_slices"):
        assert gd[key] == wd[key], key
    for key in ("plain_rel_err_mean", "whitened_rel_err_mean", "outlier_absorption_mean"):
        assert gd[key] == pytest.approx(wd[key], rel=DECOMP_REL), key
    # Whitening is what the paper's method buys: an order of magnitude.
    assert gd["whitened_rel_err_mean"] < 0.2 * gd["plain_rel_err_mean"]
    assert got["logit_kl"] == pytest.approx(want["logit_kl"], rel=KL_REL)
    for key in ("mean", "min"):
        assert got["activation_similarity"][key] == pytest.approx(
            want["activation_similarity"][key], rel=SIM_REL), key


def test_both_hold_the_91ffdda_entry_where_the_reference_reproduces_it(entries):
    for entry in entries:
        assert entry["achieved_ratio"] == ENTRY_91FFDDA["achieved_ratio"]
        for key in ("targets", "dense_params", "factored_params", "gram_fallback_slices"):
            assert entry["decomposition"][key] == ENTRY_91FFDDA[key], key
    # The port's store was in host memory, its settings the entry's.
    meta = entries[1]["meta"]
    assert meta["grams_on"] == "host" and meta["calib_samples"] == 128
    assert meta["eval_n_batches"] == 4 and meta["eval_shape"] == [16, 128]


def test_chip_smoke_holds_the_card_to_this_reference_run(entries):
    """``chip_smoke.py``'s train path runs the port's ``build_entry`` on the
    same checkpoint on the card and holds it to TRAINED_REFERENCE, the
    reference's run written as constants (the card has no JAX): they are
    this run's, within this file's tolerances (another host's CPU may sum
    in another order), and its tolerances are this file's."""
    import chip_smoke as cs

    want = entries[0]
    ref = cs.TRAINED_REFERENCE
    assert os.path.samefile(cs.TRAINED_CHECKPOINT, CHECKPOINT)
    assert cs.TRAINED_TOL == {"ppl": PPL_REL, "kl": KL_REL, "decomposition": DECOMP_REL}
    for key in ("dense_ppl", "compressed_ppl"):
        assert ref[key].keys() == set(EVAL_DOMAINS)
        for d in EVAL_DOMAINS:
            assert ref[key][d] == pytest.approx(want[key][d], rel=PPL_REL), (key, d)
    assert ref["logit_kl"] == pytest.approx(want["logit_kl"], rel=KL_REL)
    assert ref["achieved_ratio"] == want["achieved_ratio"]
    for key in ("plain_rel_err_mean", "whitened_rel_err_mean", "outlier_absorption_mean"):
        assert ref[key] == pytest.approx(want["decomposition"][key], rel=DECOMP_REL), key
