"""Compression-side observability: calibration telemetry and per-target
decomposition diagnostics (the reference's ``obs/compression.py``).

  * **Calibration telemetry** — ``calib.runner.collect_grams`` /
    ``calib.gram.accumulate_taps`` feed per-tap activation statistics into
    a ``MetricsRegistry``: absmean channel distribution percentiles, the
    outlier-channel fraction at configurable thresholds, Gram condition
    numbers, accumulated sample counts, and Gram fallback usage.
  * **Decomposition diagnostics** — ``core.compress.compress_params``
    reports a ``DecompositionReport`` per ``TargetSpec``: plain vs
    activation-whitened relative error, singular-value tail mass, the
    k1/k2 split, outlier absorption vs a rank-matched plain SVD, and
    achieved-vs-requested rank and params; aggregated by ``plan_report``
    / ``write_report``.

Telemetry is a PURE OBSERVER: compressed params are bit-identical with it
on or off.  Core talks to it duck-typed through the ``on_*`` hooks and
never imports ``repro_torch.obs``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from repro_torch.obs.metrics import MetricsRegistry

# Outlier thresholds: a channel is an outlier at threshold t when its
# absolute mean activation exceeds t x the tap-wide channel mean (ASVD's
# working definition of the channels worth absorbing).
OUTLIER_THRESHOLDS = (2.0, 4.0, 8.0)

# Relative-error buckets for the decomposition histograms (dimensionless).
ERROR_BUCKETS = (0.001, 0.003, 0.01, 0.03, 0.1, 0.3, 0.5, 1.0)


def gram_activation_stats(
    gram: torch.Tensor,
    absmean: torch.Tensor,
    count: float,
    thresholds: Sequence[float] = OUTLIER_THRESHOLDS,
) -> Dict:
    """Per-tap activation statistics from the accumulated (Gram, absmean).

    ``absmean`` is the per-channel mean |x| (count-normalized, as
    ``GramStore.absmean`` returns it); its n values are summarized on the
    host.  The condition number comes from the Gram's eigenvalues,
    ``torch.linalg.eigvalsh`` in fp64 on the Gram's device, paid once per
    key at the END of calibration, never per batch.
    """
    a = absmean.detach().to(torch.float64).cpu().numpy()
    n = int(a.shape[0])
    mean = float(a.mean()) if n else 0.0
    stats: Dict = {
        "channels": n,
        "samples": float(count),
        "absmean_mean": mean,
        "absmean_p50": float(np.percentile(a, 50)) if n else 0.0,
        "absmean_p99": float(np.percentile(a, 99)) if n else 0.0,
        "absmean_max": float(a.max()) if n else 0.0,
        "outlier_frac": {},
    }
    for t in thresholds:
        frac = float(np.mean(a > t * mean)) if n and mean > 0 else 0.0
        stats["outlier_frac"][float(t)] = frac
    g = gram.to(torch.float64)
    lam = torch.linalg.eigvalsh(0.5 * (g + g.T))
    lam_max = float(lam[-1]) if lam.numel() else 0.0
    pos = lam[lam > 0]
    lam_min = float(pos.min()) if pos.numel() else 0.0
    stats["gram_cond"] = (lam_max / lam_min) if lam_min > 0 else float("inf")
    stats["gram_rank_frac"] = (
        float((lam > lam_max * 1e-10).double().mean()) if lam_max > 0 else 0.0
    )
    return stats


@dataclasses.dataclass
class DecompositionReport:
    """Quality record of one compressed ``TargetSpec`` (all slices).

    Per-slice numbers come from ``repro_torch.core.nsvd.decomposition_diagnostics``;
    scalar fields aggregate across the stacked slices (mean errors, summed
    params).  ``slices`` keeps the raw per-slice dicts so per-LAYER
    attribution survives the aggregation (a stacked (L,) target holds one
    entry per layer)."""

    target: str
    method: str
    shape: Tuple[int, int]  # (out, in) — paper orientation
    stacked: Tuple[int, ...]
    rank: int
    requested_rank: int
    k1: int
    k2: int
    requested_ratio: float
    achieved_ratio: float
    dense_params: int
    factored_params: int
    plain_rel_err: float
    whitened_rel_err: float
    sv_tail_mass: float
    outlier_absorption: float
    gram_fallback_slices: int
    seconds: float
    slices: List[Dict] = dataclasses.field(default_factory=list)

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["shape"] = list(self.shape)
        d["stacked"] = list(self.stacked)
        return d


def _nan_mean(vals: Sequence[float]) -> float:
    xs = [v for v in vals if not math.isnan(v)]
    return float(np.mean(xs)) if xs else float("nan")


class CompressionTelemetry:
    """Facade the calibration runner and the compression orchestrator talk
    to.  Its families live on a ``MetricsRegistry`` (``metrics``), exported
    with ``snapshot()`` / ``prometheus_text()``.

    ``compare_plain`` gates the one extra rank-matched plain SVD per slice
    that the outlier-absorption ratio needs; everything else is computed
    from byproducts of the decomposition itself."""

    enabled = True

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 outlier_thresholds: Sequence[float] = OUTLIER_THRESHOLDS,
                 compare_plain: bool = True):
        self.metrics = m = registry if registry is not None else MetricsRegistry()
        self.outlier_thresholds = tuple(outlier_thresholds)
        self.compare_plain = compare_plain
        self.calib: Dict[str, Dict] = {}  # tap -> gram_activation_stats
        self.reports: Dict[str, DecompositionReport] = {}
        self._slices: Dict[str, List[Dict]] = {}
        self.calib_store_seconds = 0.0

        # -- calibration families
        self.calib_batches = m.counter(
            "compress_calib_batches_total", "calibration batches folded "
            "into the GramStore")
        self.calib_rows = m.counter(
            "compress_calib_rows_total", "activation rows accumulated per "
            "tap", labelnames=("tap",))
        self.calib_samples = m.gauge(
            "compress_calib_samples", "accumulated sample count per Gram "
            "key at the end of calibration", labelnames=("tap",))
        self.calib_outlier_frac = m.gauge(
            "compress_calib_outlier_channel_frac", "fraction of channels "
            "whose mean |activation| exceeds threshold x the tap mean",
            labelnames=("tap", "threshold"))
        self.calib_absmean = m.gauge(
            "compress_calib_absmean", "per-tap absmean channel "
            "distribution", labelnames=("tap", "stat"))
        self.calib_gram_cond = m.gauge(
            "compress_calib_gram_condition_number", "condition number of "
            "the accumulated calibration Gram", labelnames=("tap",))
        self.gram_fallbacks = m.counter(
            "compress_gram_fallbacks_total", "per-slice Gram lookups that "
            "fell back to the shared key (min_count or missing)",
            labelnames=("reason",))

        # -- decomposition families
        self.targets_total = m.counter(
            "compress_targets_total", "TargetSpecs compressed")
        self.slices_total = m.counter(
            "compress_slices_total", "stacked slices factorized")
        self.plain_err = m.gauge(
            "compress_plain_rel_err", "||A - A~||_F / ||A||_F per target "
            "(mean over slices)", labelnames=("target",))
        self.whitened_err = m.gauge(
            "compress_whitened_rel_err", "||(A - A~)X||_F / ||A X||_F per "
            "target (mean over slices)", labelnames=("target",))
        self.tail_mass = m.gauge(
            "compress_sv_tail_mass", "singular-value tail mass at the "
            "chosen rank (whitened energy fraction truncated)",
            labelnames=("target",))
        self.absorption = m.gauge(
            "compress_outlier_absorption", "activation-weighted error "
            "removed by whitening vs a rank-matched plain SVD",
            labelnames=("target",))
        self.rank_achieved = m.gauge(
            "compress_rank_achieved", "rank actually assigned",
            labelnames=("target",))
        self.rank_requested = m.gauge(
            "compress_rank_requested", "unaligned budget rank for the "
            "requested ratio", labelnames=("target",))
        self.factored_params_g = m.gauge(
            "compress_factored_params", "params stored by the "
            "factorization", labelnames=("target",))
        self.seconds = m.histogram(
            "compress_target_seconds", "wall time factorizing one target",
            buckets=(0.01, 0.03, 0.1, 0.3, 1.0, 3.0, 10.0, 30.0, 100.0))
        self.k2_share = m.histogram(
            "compress_k2_rank_share", "k2 / (k1 + k2) across targets",
            buckets=(0.0, 0.01, 0.02, 0.05, 0.1, 0.2, 0.5, 1.0))
        self.slice_whitened_hist = m.histogram(
            "compress_slice_whitened_rel_err", "whitened relative error "
            "across ALL slices", buckets=ERROR_BUCKETS)

    # ---------------------------------------------------- calibration hooks

    def on_calib_batch(self, tap_rows: Dict[str, int]) -> None:
        """One ``accumulate_taps`` call: rows folded per (normalized) tap."""
        self.calib_batches.inc()
        for tap, rows in tap_rows.items():
            self.calib_rows.labels(tap=tap).inc(rows)

    def on_calib_store(self, store, device=None) -> None:
        """End-of-calibration sweep over the accumulated GramStore: the
        expensive per-tap statistics (outlier fractions, Gram condition
        numbers) computed exactly once, each key read onto ``device``
        (None: where it lives) in turn; ``calib_store_seconds`` times it."""
        t0 = time.perf_counter()
        for key in sorted(store.keys()):
            stats = gram_activation_stats(
                store.gram(key, device=device), store.absmean(key, device=device),
                store.count(key),
                thresholds=self.outlier_thresholds)
            self.calib[key] = stats
            self.calib_samples.labels(tap=key).set(stats["samples"])
            for t, frac in stats["outlier_frac"].items():
                self.calib_outlier_frac.labels(
                    tap=key, threshold=repr(t)).set(frac)
            for stat in ("mean", "p50", "p99", "max"):
                self.calib_absmean.labels(tap=key, stat=stat).set(
                    stats[f"absmean_{stat}"])
            cond = stats["gram_cond"]
            self.calib_gram_cond.labels(tap=key).set(
                cond if math.isfinite(cond) else -1.0)
        self.calib_store_seconds = time.perf_counter() - t0

    def on_gram_fallback(self, key: str, fallback: str, reason: str) -> None:
        self.gram_fallbacks.labels(reason=reason).inc()

    # --------------------------------------------------- decomposition hooks

    def on_slice(self, target: str, slice_idx: Tuple[int, ...],
                 diag: Dict) -> None:
        """One factorized matrix (one stacked slice, or the whole kernel
        for unstacked targets).  ``diag`` comes from
        ``repro_torch.core.nsvd.decomposition_diagnostics``."""
        self.slices_total.inc()
        d = dict(diag, slice=list(slice_idx))
        self._slices.setdefault(target, []).append(d)
        if not math.isnan(d.get("whitened_rel_err", float("nan"))):
            self.slice_whitened_hist.observe(d["whitened_rel_err"])

    def on_target(self, *, name: str, method: str, shape: Tuple[int, int],
                  stacked: Tuple[int, ...], rank: int, requested_rank: int,
                  requested_ratio: float, achieved_ratio: float,
                  dense_params: int, factored_params: int,
                  gram_fallback_slices: int, seconds: float) -> DecompositionReport:
        """Aggregate the slices recorded for ``name`` into a report."""
        slices = self._slices.pop(name, [])
        k1 = int(slices[0]["k1"]) if slices else rank
        k2 = int(slices[0]["k2"]) if slices else 0
        report = DecompositionReport(
            target=name, method=method, shape=tuple(shape),
            stacked=tuple(stacked), rank=int(rank),
            requested_rank=int(requested_rank), k1=k1, k2=k2,
            requested_ratio=float(requested_ratio),
            achieved_ratio=float(achieved_ratio),
            dense_params=int(dense_params),
            factored_params=int(factored_params),
            plain_rel_err=_nan_mean([s["plain_rel_err"] for s in slices]),
            whitened_rel_err=_nan_mean(
                [s["whitened_rel_err"] for s in slices]),
            sv_tail_mass=_nan_mean([s["sv_tail_mass"] for s in slices]),
            outlier_absorption=_nan_mean(
                [s["outlier_absorption"] for s in slices]),
            gram_fallback_slices=int(gram_fallback_slices),
            seconds=float(seconds), slices=slices,
        )
        self.reports[name] = report
        self.targets_total.inc()
        self.seconds.observe(seconds)
        if rank > 0:
            self.k2_share.observe(k2 / max(1, k1 + k2))
        for gauge, val in (
            (self.plain_err, report.plain_rel_err),
            (self.whitened_err, report.whitened_rel_err),
            (self.tail_mass, report.sv_tail_mass),
            (self.absorption, report.outlier_absorption),
        ):
            if not math.isnan(val):
                gauge.labels(target=name).set(val)
        self.rank_achieved.labels(target=name).set(rank)
        self.rank_requested.labels(target=name).set(requested_rank)
        self.factored_params_g.labels(target=name).set(factored_params)
        return report

    # ------------------------------------------------------------- export

    def plan_report(self, plan=None) -> Dict:
        """The plan-level JSON artifact: every target's report plus totals
        (and the plan's own achieved-vs-requested summary when given)."""
        targets = [self.reports[k].to_dict() for k in sorted(self.reports)]
        dense = sum(t["dense_params"] for t in targets)
        factored = sum(t["factored_params"] for t in targets)
        doc: Dict = {
            "schema": 1,
            "generated_by": "repro.obs.compression",
            "targets": targets,
            "totals": {
                "targets": len(targets),
                "dense_params": dense,
                "factored_params": factored,
                "achieved_ratio": 1.0 - factored / dense if dense else 0.0,
                "plain_rel_err_mean": _nan_mean(
                    [t["plain_rel_err"] for t in targets]),
                "whitened_rel_err_mean": _nan_mean(
                    [t["whitened_rel_err"] for t in targets]),
                "outlier_absorption_mean": _nan_mean(
                    [t["outlier_absorption"] for t in targets]),
                "gram_fallback_slices": sum(
                    t["gram_fallback_slices"] for t in targets),
            },
            "calibration": self.calib,
        }
        if plan is not None:
            doc["plan"] = {
                "method": plan.config.method,
                "ratio": plan.config.ratio,
                "k1_frac": plan.config.k1_frac,
                "achieved_ratio": plan.achieved_ratio,
                "ranks": dict(plan.ranks),
            }
        return doc

    def write_report(self, path: str, plan=None) -> Dict:
        doc = self.plan_report(plan)
        with open(path, "w") as f:
            json.dump(_json_safe(doc), f, indent=1)
        return doc


def _json_safe(obj):
    """NaN/inf-safe JSON tree (artifacts load everywhere, not just json
    with allow_nan)."""
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    if isinstance(obj, (np.floating, np.integer)):
        return _json_safe(obj.item())
    return obj


class _NullCompressionTelemetry:
    """Shared no-op twin (the default when no telemetry is supplied)."""

    enabled = False
    __slots__ = ()

    def on_calib_batch(self, tap_rows):
        pass

    def on_calib_store(self, store, device=None):
        pass

    def on_gram_fallback(self, key, fallback, reason):
        pass

    def on_slice(self, target, slice_idx, diag):
        pass

    def on_target(self, **kw):
        return None


NULL_COMPRESSION_TELEMETRY = _NullCompressionTelemetry()
