"""Quality-drift report: dense vs compressed on the eval suite, on the card.

    PYTHONPATH=src python -m repro_torch.obs.quality_report \\
        --model mistral-7b --no-reduced --layers 2 --eval-batch 4 --eval-seq 2048

One run calibrates with ``CompressionTelemetry`` attached (Grams through
the ``gram`` kernel), compresses, and evaluates dense vs compressed
perplexity on every eval domain (every forward causal, through the
``flash_attention`` kernel); then the mean per-token logit KL (dense ||
compressed), the per-target attribution of that drift, and the
cross-domain activation similarity.  It APPENDS a git-SHA and
config-hash stamped entry to an append-only history file (``--history``,
by default under the repo's ``chiprun_out/``) and optionally writes the
per-target decomposition report (``--report``).

``small-*`` models load the reference's trained checkpoint from
``experiments/models/<name>/``; any other arch starts from random weights
drawn from ``--seed``, so its perplexities check the wiring, not the
compression's quality.  Telemetry is a pure observer: the compressed
params evaluated here are bit-identical to a run without it.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import subprocess
import time
from typing import Dict, List, Optional

import torch

from repro_torch import Device, resolve_device
from repro_torch.calib.runner import calibration_batches, collect_grams
from repro_torch.configs import ModelConfig, get_config
from repro_torch.core import CompressionConfig, build_plan, compress_params
from repro_torch.core.compress import GRAM_HOMES
from repro_torch.eval.attribution import mean_logit_kl, per_target_attribution
from repro_torch.eval.perplexity import activation_similarity, eval_batches, evaluate_ppl
from repro_torch.launch.serve import load_small
from repro_torch.models import build_model
from repro_torch.obs.compression import CompressionTelemetry

QUALITY_SCHEMA = 1
EVAL_DOMAINS = ("en_a", "en_b", "task", "zh", "jp")
_REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", ".."))
DEFAULT_HISTORY = os.path.join(_REPO_ROOT, "chiprun_out", "quality_history.json")


def git_sha() -> str:
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short=12", "HEAD"], capture_output=True,
            text=True, timeout=10, cwd=_REPO_ROOT).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def config_hash(meta: Dict) -> str:
    return hashlib.sha256(json.dumps(meta, sort_keys=True).encode()).hexdigest()[:12]


def append_quality_history(entry: Dict, path: str = DEFAULT_HISTORY) -> Dict:
    """Append a stamped entry to the history at ``path`` (prior entries are
    kept verbatim) and return the written document."""
    history: List[Dict] = []
    if os.path.exists(path):
        try:
            with open(path) as f:
                prev = json.load(f)
            if isinstance(prev.get("history"), list):
                history = prev["history"]
        except (json.JSONDecodeError, OSError):
            history = []
    history.append(entry)
    doc = {"schema": QUALITY_SCHEMA, "generated_by": "repro_torch.obs.quality_report",
           "history": history}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
    return doc


def build_entry(cfg: ModelConfig, *, method: str = "nsvd1", ratio: float = 0.2,
                k1_frac: float = 0.9, eval_n_batches: int = 6, eval_batch: int = 16,
                eval_seq: int = 128, calib_samples: int = 256, attribution: bool = True,
                attribution_batches: int = 2, report_path: Optional[str] = None,
                seed: int = 0, params=None, device: Device = None,
                grams_on: str = "device") -> Dict:
    """Run calibrate -> compress -> evaluate on ``cfg`` and return the
    history entry.  ``params`` (dense, on their device) skips the load or
    random init; ``grams_on`` is the GramStore's home, "device" or "host"
    (``calib.runner.collect_grams``); the entry's ``seconds`` hold each
    phase's wall time."""
    if cfg.frontend == "vision":
        # Its calibration stream is bare token arrays: the projector's
        # targets would find no Gram.
        raise ValueError(f"{cfg.name}'s projector targets are calibrated on image "
                         "patches; build_entry calibrates on tokens only")
    dev = resolve_device(device) if params is None else params["embed"]["table"].device
    model = build_model(cfg)
    vocab = cfg.vocab_size
    seconds: Dict[str, float] = {}
    t_all = time.perf_counter()

    def phase(name, t0):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds[name] = time.perf_counter() - t0

    t0 = time.perf_counter()
    if params is None:
        params = (load_small(cfg.name, dev) if cfg.name.startswith("small-")
                  else model.init(seed, dev))
    phase("init", t0)

    telemetry = CompressionTelemetry()
    t0 = time.perf_counter()
    grams = collect_grams(model, params, calibration_batches(
        vocab, "en_a", n_samples=calib_samples, batch=16, seq=128),
        telemetry=telemetry, grams_on=grams_on)
    phase("calibrate", t0)
    seconds["calib_stats"] = telemetry.calib_store_seconds  # within calibrate

    t0 = time.perf_counter()
    plan = build_plan(model.compressible_targets(), CompressionConfig(
        method=method, ratio=ratio, k1_frac=k1_frac, dtype=cfg.dtype,
        use_randomized=False))
    cparams = compress_params(params, plan, grams, telemetry=telemetry)
    del grams
    phase("compress", t0)

    def batches(domain, n):
        return eval_batches(vocab, domain, n_batches=n, batch=eval_batch, seq=eval_seq)

    t0 = time.perf_counter()
    dense_ppl: Dict[str, float] = {}
    compressed_ppl: Dict[str, float] = {}
    for d in EVAL_DOMAINS:
        dense_ppl[d] = evaluate_ppl(model, params, batches(d, eval_n_batches))
        compressed_ppl[d] = evaluate_ppl(model, cparams, batches(d, eval_n_batches))
    phase("evaluate", t0)

    t0 = time.perf_counter()
    logit_kl = mean_logit_kl(model, params, cparams, batches("en_a", eval_n_batches))
    phase("logit_kl", t0)

    t0 = time.perf_counter()
    attribution_rows: List[Dict] = []
    if attribution:
        attribution_rows = per_target_attribution(
            model, params, cparams, plan.targets,
            lambda: batches("en_a", attribution_batches))
    phase("attribution", t0)

    # Cross-domain activation shift: the calibration domain vs the most
    # distribution-shifted eval domain (zh).
    t0 = time.perf_counter()
    sims = list(activation_similarity(model, params, "en_a", "zh", vocab).values())
    act_sim = {"domains": ["en_a", "zh"], "mean": sum(sims) / max(len(sims), 1),
               "min": min(sims) if sims else 0.0}
    phase("activation_similarity", t0)

    if report_path:
        telemetry.write_report(report_path, plan=plan)
    meta = {"model": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
            "dtype": cfg.dtype, "method": method, "ratio": ratio, "k1_frac": k1_frac,
            "eval_n_batches": eval_n_batches, "eval_shape": [eval_batch, eval_seq],
            "calib_samples": calib_samples, "grams_on": grams_on,
            "seed": seed, "device": (torch.cuda.get_device_name(dev)
                                     if dev.type == "cuda" else dev.type)}
    return {
        "git_sha": git_sha(),
        "config_hash": config_hash(meta),
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "meta": meta,
        "achieved_ratio": plan.achieved_ratio,
        "dense_ppl": dense_ppl,
        "compressed_ppl": compressed_ppl,
        "ppl_ratio": {d: compressed_ppl[d] / dense_ppl[d] for d in compressed_ppl},
        "logit_kl": logit_kl,
        "attribution": attribution_rows,
        "activation_similarity": act_sim,
        "decomposition": telemetry.plan_report(plan=plan)["totals"],
        "seconds": seconds,
        "wall_s": time.perf_counter() - t_all,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description="dense-vs-compressed quality report "
                                 "(appends to --history)")
    ap.add_argument("--model", default="small-llama")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction, default=True,
                    help="shrink a full-size arch to its smoke-test config")
    ap.add_argument("--layers", type=int, default=None, help="cut the depth")
    ap.add_argument("--method", default="nsvd1")
    ap.add_argument("--ratio", type=float, default=0.2)
    ap.add_argument("--k1-frac", type=float, default=0.9)
    ap.add_argument("--eval-batches", type=int, default=6)
    ap.add_argument("--eval-batch", type=int, default=16)
    ap.add_argument("--eval-seq", type=int, default=128)
    ap.add_argument("--calib-samples", type=int, default=256)
    ap.add_argument("--attribution-batches", type=int, default=2)
    ap.add_argument("--no-attribution", action="store_true",
                    help="skip the per-target logit-KL patching pass")
    ap.add_argument("--report", default=None, metavar="PATH",
                    help="also write the per-target decomposition report JSON")
    ap.add_argument("--history", default=DEFAULT_HISTORY, metavar="PATH",
                    help="append-only quality history JSON")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--grams-on", choices=GRAM_HOMES, default="device",
                    help="the calibration GramStore's home: device memory, or host "
                    "memory filled a group of layers at a time")
    args = ap.parse_args(argv)

    cfg = get_config(args.model)
    if args.reduced and not args.model.startswith("small-"):
        cfg = cfg.reduced()
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    entry = build_entry(
        cfg, method=args.method, ratio=args.ratio, k1_frac=args.k1_frac,
        eval_n_batches=args.eval_batches, eval_batch=args.eval_batch,
        eval_seq=args.eval_seq, calib_samples=args.calib_samples,
        attribution=not args.no_attribution,
        attribution_batches=args.attribution_batches, report_path=args.report,
        seed=args.seed, device=args.device, grams_on=args.grams_on)
    for d in EVAL_DOMAINS:
        print(f"  ppl[{d}]: dense={entry['dense_ppl'][d]:.4f} compressed="
              f"{entry['compressed_ppl'][d]:.4f} (x{entry['ppl_ratio'][d]:.4f})")
    print(f"  logit KL (dense || compressed): {entry['logit_kl']:.6f} nats/token")
    for r in entry["attribution"][:3]:
        print(f"  attribution: {r['target']} kl={r['logit_kl']:.6f} share={r['share']:.0%}")
    tot = entry["decomposition"]
    print(f"  achieved ratio {entry['achieved_ratio']:.5f}; whitened err "
          f"{tot['whitened_rel_err_mean']:.4f} vs plain {tot['plain_rel_err_mean']:.4f}, "
          f"absorption {tot['outlier_absorption_mean']:.4f}")
    print("  phase seconds: " + ", ".join(f"{k}={v:.2f}" for k, v in entry["seconds"].items()))
    doc = append_quality_history(entry, args.history)
    print(f"  quality entry -> {args.history} [{entry['git_sha']} "
          f"{entry['config_hash']}, {len(doc['history'])} run(s)]")


if __name__ == "__main__":
    main()
