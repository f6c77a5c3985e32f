"""Port parity for compression quality: decomposition diagnostics, the
telemetry's plan report and calibration statistics against the
reference's on the same params and Grams; telemetry as a pure observer;
and the quality-report CLI end to end on the CPU (writing only the history
file it is given, never BENCH_quality.json)."""

import hashlib
import json
import os

import jax
import numpy as np
import pytest
import torch
from torch_parity import tiny_cfgs, to_t

from repro.calib.runner import collect_grams as jax_collect_grams
from repro.core import CompressionConfig as JaxCompressionConfig
from repro.core import GramStore as JaxGramStore
from repro.core import build_plan as jax_build_plan
from repro.core import compress_params as jax_compress_params
from repro.core.nsvd import decomposition_diagnostics as jax_diagnostics
from repro.core.nsvd import nested_compress as jax_nested_compress
from repro.eval.perplexity import eval_batches as jax_eval_batches
from repro.models import build_model as jax_build_model
from repro.obs.compression import CompressionTelemetry as JaxTelemetry
from repro.obs.compression import gram_activation_stats as jax_gram_activation_stats
from repro.obs.metrics import MetricsRegistry as JaxMetricsRegistry
from repro_torch.calib.runner import collect_grams
from repro_torch.configs import MISTRAL_7B, small_lm
from repro_torch.core import (ALL_METHODS, CompressionConfig, GramStore, build_plan,
                              compress_params)
from repro_torch.core.nsvd import decomposition_diagnostics, nested_compress
from repro_torch.models import build_model
from repro_torch.obs import quality_report
from repro_torch.obs.compression import CompressionTelemetry, gram_activation_stats
from repro_torch.obs.metrics import MetricsRegistry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _matrix_and_gram(seed=0, m=16, n=24, rows=80):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, n))
    x = rng.standard_normal((rows, n)) * np.exp(rng.standard_normal(n))  # outlier channels
    return a, x.T @ x


@pytest.mark.parametrize("with_gram", [True, False])
@pytest.mark.parametrize("method", ["nsvd1", "nsvd2", "nid1", "nid2"])
def test_decomposition_diagnostics_match_reference(method, with_gram):
    """Same matrix and Gram; each side decomposes with its own SVD (signs
    differ, errors do not): fp64, within 1e-8 relative."""
    a, g = _matrix_and_gram()
    want = jax_diagnostics(a, jax_nested_compress(a, 10, method, gram=g, k1_frac=0.8,
                                                  use_randomized=False),
                           gram=g if with_gram else None)
    ta, tg = torch.as_tensor(a), torch.as_tensor(g)
    got = decomposition_diagnostics(ta, nested_compress(ta, 10, method, gram=tg, k1_frac=0.8,
                                                        use_randomized=False),
                                    gram=tg if with_gram else None)
    assert got.keys() == want.keys()
    for k in want:
        if np.isnan(want[k]):
            assert np.isnan(got[k]), k
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-8, err_msg=k)
    assert (got["k1"], got["k2"]) == (8.0, 2.0)


def test_gram_activation_stats_match_reference():
    _, g = _matrix_and_gram(seed=1)
    absmean = np.abs(np.random.default_rng(2).standard_normal(24)) + 0.1
    absmean[3] = 9.0
    want = jax_gram_activation_stats(g, absmean, 80.0)
    got = gram_activation_stats(torch.as_tensor(g), torch.as_tensor(absmean), 80.0)
    assert got.keys() == want.keys() and got["outlier_frac"] == want["outlier_frac"]
    for k in ("absmean_mean", "absmean_p50", "absmean_p99", "absmean_max",
              "gram_rank_frac", "samples", "channels"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=k)
    np.testing.assert_allclose(got["gram_cond"], want["gram_cond"], rtol=1e-8)


@pytest.fixture(scope="module")
def calibrated(tmp_path_factory):
    jcfg, tcfg = tiny_cfgs("small-mistral", d_model=32, d_ff=48)
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    jparams = jmodel.init(jax.random.key(2))
    jtel, ttel = JaxTelemetry(), CompressionTelemetry()
    jgrams = jax_collect_grams(jmodel, jparams, jax_eval_batches(64, "en_a", 3, 4, 24),
                               telemetry=jtel)
    tgrams = collect_grams(tmodel, to_t(jparams),
                           [b["tokens"] for b in jax_eval_batches(64, "en_a", 3, 4, 24)],
                           telemetry=ttel)
    path = str(tmp_path_factory.mktemp("grams") / "grams.npz")
    jgrams.save(path)
    return jmodel, tmodel, jparams, path, jtel, ttel, tgrams


def test_calibration_telemetry_matches_reference(calibrated):
    """Per-key statistics of the accumulated store.  On the reference's own
    store (saved at ``path``) the port's ``gram_activation_stats`` gives
    the reference's Gram rank fraction exactly.  From each side's own Grams
    (fp32 sums in another order): within 1e-5 relative; the rank fraction
    exactly where the condition number is under 1e5, and above it within
    the eigenvalues that lie within fp32 round-off (n * eps32 * lam_max,
    n channels) of the rank cut ``1e-10 * lam_max``, which the sum order
    can move across it."""
    _, _, _, path, jtel, ttel, tgrams = calibrated
    assert ttel.calib.keys() == jtel.calib.keys() == set(tgrams.keys())
    ref = GramStore.load(path, device="cpu")
    eps32 = float(np.finfo(np.float32).eps)
    for key, want in jtel.calib.items():
        same = gram_activation_stats(ref.gram(key), ref.absmean(key), ref.count(key))
        assert same["gram_rank_frac"] == want["gram_rank_frac"], key
        got = ttel.calib[key]
        assert got["channels"] == want["channels"] and got["samples"] == want["samples"]
        for k in ("absmean_mean", "absmean_p50", "absmean_p99", "absmean_max"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=(key, k))
        assert got["gram_cond"] > 0
        # A condition number near 1/eps(fp32) is set by the Grams' fp32
        # round-off, which differs with the sum order: compare the rest.
        if want["gram_cond"] < 1e5:
            np.testing.assert_allclose(got["gram_cond"], want["gram_cond"], rtol=1e-3)
            assert got["gram_rank_frac"] == want["gram_rank_frac"], key
        else:
            g = ref.gram(key).double()
            lam = torch.linalg.eigvalsh(0.5 * (g + g.T))
            lam_max, n = float(lam[-1]), lam.numel()
            near = int(((lam - 1e-10 * lam_max).abs() <= n * eps32 * lam_max).sum())
            moved = round(abs(got["gram_rank_frac"] - want["gram_rank_frac"]) * n)
            assert moved <= near, (key, got["gram_rank_frac"], want["gram_rank_frac"], near)
    assert ttel.calib_batches.value == jtel.calib_batches.value == 3


def test_plan_report_totals_match_reference(calibrated):
    """Same params and GramStore file: equal counts and ratios; mean errors
    and absorption within 1e-6 (fp64 decompositions of equal inputs)."""
    jmodel, tmodel, jparams, path, _, _, _ = calibrated
    kw = dict(method="nsvd1", ratio=0.25, k1_frac=0.9, dtype="float32", use_randomized=False)
    jtel, ttel = JaxTelemetry(), CompressionTelemetry()
    jplan = jax_build_plan(jmodel.compressible_targets(), JaxCompressionConfig(**kw))
    tplan = build_plan(tmodel.compressible_targets(), CompressionConfig(**kw))
    jax_compress_params(jparams, jplan, JaxGramStore.load(path), telemetry=jtel)
    compress_params(to_t(jparams), tplan, GramStore.load(path, device="cpu"), telemetry=ttel)
    want, got = jtel.plan_report(plan=jplan), ttel.plan_report(plan=tplan)
    for k in ("targets", "dense_params", "factored_params", "gram_fallback_slices"):
        assert got["totals"][k] == want["totals"][k], k
    for k in ("achieved_ratio", "plain_rel_err_mean", "whitened_rel_err_mean",
              "outlier_absorption_mean"):
        np.testing.assert_allclose(got["totals"][k], want["totals"][k], rtol=1e-6, err_msg=k)
    assert got["plan"] == want["plan"]
    assert [t["target"] for t in got["targets"]] == [t["target"] for t in want["targets"]]
    for g, w in zip(got["targets"], want["targets"]):
        assert (g["rank"], g["k1"], g["k2"], len(g["slices"])) == \
            (w["rank"], w["k1"], w["k2"], len(w["slices"]))


def test_compressed_params_bit_identical_with_telemetry(calibrated):
    _, tmodel, jparams, path, _, _, _ = calibrated
    grams = GramStore.load(path, device="cpu")
    plan = build_plan(tmodel.compressible_targets(), CompressionConfig(
        method="nsvd1", ratio=0.3, dtype="float32", use_randomized=False))
    params = to_t(jparams)
    tel = CompressionTelemetry()
    on = compress_params(params, plan, grams, telemetry=tel)
    off = compress_params(params, plan, grams)

    def leaves(tree, prefix=()):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], prefix + (k,))
        else:
            yield prefix, tree
    a, b = dict(leaves(on)), dict(leaves(off))
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert len(tel.reports) == len(plan.targets)


def test_gram_store_resolve_matches_reference():
    jstore, tstore = JaxGramStore(), GramStore()
    for key, count in (("shared", 100.0), ("layer/0", 3.0), ("layer/1", 50.0)):
        jstore.update(key, np.eye(2), np.ones(2), count)
        tstore.update(key, torch.eye(2, dtype=torch.float64), torch.ones(2), count)
    for key in ("layer/0", "layer/1", "layer/2", "shared"):
        assert tstore.resolve(key, "shared", 10) == jstore.resolve(key, "shared", 10)
    with pytest.raises(KeyError):
        tstore.resolve("nothing", "absent")


def test_metrics_registry_matches_reference():
    out = []
    for reg in (JaxMetricsRegistry(), MetricsRegistry()):
        c = reg.counter("c_total", "a counter", labelnames=("tap",))
        c.labels(tap="x").inc(3)
        reg.gauge("g", "a gauge").set(2.5)
        h = reg.histogram("h_seconds", "a histogram", buckets=(0.1, 1.0))
        for v in (0.05, 0.5, 5.0):
            h.observe(v)
        out.append((reg.snapshot(), reg.prometheus_text()))
    assert out[0] == out[1]


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_quality_report_cli_end_to_end_on_cpu(tmp_path, monkeypatch, capsys):
    """The CLI on a tiny random model: an entry with every number finite,
    appended (not overwritten) to the history it is given; the reference's
    BENCH_quality.json is left as it was."""
    bench = os.path.join(ROOT, "BENCH_quality.json")
    before = _sha(bench)
    cfg = small_lm("tiny-mistral", MISTRAL_7B, num_layers=2, d_model=32, d_ff=48,
                   vocab_size=64, num_heads=4)
    monkeypatch.setattr(quality_report, "get_config", lambda name: cfg)
    hist, report = tmp_path / "history.json", tmp_path / "report.json"
    argv = ["--model", "tiny-mistral", "--no-reduced", "--device", "cpu",
            "--eval-batches", "1", "--eval-batch", "2", "--eval-seq", "24",
            "--calib-samples", "32", "--attribution-batches", "1",
            "--history", str(hist), "--report", str(report)]
    quality_report.main(argv)
    quality_report.main(argv + ["--no-attribution"])
    assert _sha(bench) == before
    doc = json.loads(hist.read_text())
    assert doc["generated_by"] == "repro_torch.obs.quality_report"
    first, second = doc["history"]
    assert len(first["attribution"]) == 7 and second["attribution"] == []
    nums = [*first["dense_ppl"].values(), *first["compressed_ppl"].values(),
            first["logit_kl"], first["achieved_ratio"], *first["seconds"].values(),
            *first["decomposition"].values()]
    assert all(np.isfinite(float(v)) for v in nums)
    assert first["meta"]["device"] == "cpu" and first["decomposition"]["targets"] == 7
    assert set(first["dense_ppl"]) == set(quality_report.EVAL_DOMAINS)
    rep = json.loads(report.read_text())
    assert len(rep["targets"]) == 7 and rep["calibration"]
    assert "quality entry ->" in capsys.readouterr().out


@pytest.mark.parametrize("method", ALL_METHODS)
def test_quality_report_cli_takes_every_method(tmp_path, monkeypatch, method):
    """``--method`` reaches the compressor: an entry for each of the nine
    methods on a tiny random model, every number finite, the plan's method
    recorded."""
    cfg = small_lm("tiny-mistral", MISTRAL_7B, num_layers=1, d_model=32, d_ff=48,
                   vocab_size=64, num_heads=4)
    monkeypatch.setattr(quality_report, "get_config", lambda name: cfg)
    hist = tmp_path / "history.json"
    quality_report.main(["--model", "tiny-mistral", "--no-reduced", "--device", "cpu",
                         "--method", method, "--eval-batches", "1", "--eval-batch", "2",
                         "--eval-seq", "24", "--calib-samples", "32", "--no-attribution",
                         "--history", str(hist)])
    (entry,) = json.loads(hist.read_text())["history"]
    assert entry["meta"]["method"] == method
    tot = dict(entry["decomposition"])
    if method == "svd":  # no Gram: no whitened error, as in the reference
        no_gram = ("whitened_rel_err_mean", "outlier_absorption_mean")
        assert all(np.isnan(tot.pop(k)) for k in no_gram)
    nums = [*entry["dense_ppl"].values(), *entry["compressed_ppl"].values(),
            entry["logit_kl"], entry["achieved_ratio"], *tot.values()]
    assert all(np.isfinite(float(v)) for v in nums)
    assert tot["targets"] == 7
