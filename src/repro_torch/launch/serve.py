"""Serving launcher: build (or load) a model, optionally calibrate and
NSVD-compress it, and serve batched requests through the engine, on the
cache layout the model takes (``models.api.cache_layout``): paged block
pools for the attention families, the dense recurrent-state slab for
RWKV-6.

    python -m repro_torch.launch.serve --arch mistral-7b --no-reduced \\
        --compress 0.2 --requests 8 --max-new 32
    python -m repro_torch.launch.serve --arch rwkv6-1.6b --no-reduced \\
        --compress 0.2 --requests 8 --max-new 32 --max-batch 8

``small-*`` archs load the reference's trained checkpoint from
``experiments/models/<name>/`` (and its ``grams.npz`` when present); every
other arch starts from random weights drawn from ``--seed``.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import Device, bridge, resolve_device
from repro_torch.calib.runner import calibration_batches, collect_grams
from repro_torch.configs import ModelConfig, get_config
from repro_torch.core import CompressionConfig, GramStore, build_plan, compress_params
from repro_torch.models import build_model
from repro_torch.serving.engine import ServingEngine

MODELS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                          "experiments", "models")


def load_small(name: str, device: Device = None):
    """The reference's trained small-* checkpoint (no training in the port)."""
    ckpt_dir = os.path.join(MODELS_DIR, name)
    if not os.path.isdir(ckpt_dir):
        raise FileNotFoundError(
            f"no reference checkpoint for {name!r} under {ckpt_dir}: training "
            "is not ported yet — train it with the JAX package first "
            f"(python -m repro.launch.serve --arch {name})")
    params, _ = bridge.load_checkpoint(bridge.latest_checkpoint(ckpt_dir), device)
    return params


def default_prompts(n: int, vocab: int, seed: int, length: int = 8) -> List[np.ndarray]:
    """The reference launcher's prompts: ``length`` tokens from [2, vocab/2)."""
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab // 2, size=length) for _ in range(n)]


def serve(cfg: ModelConfig, *, requests: int = 8, max_new: int = 16,
          max_batch: int = 4, max_len: int = 256, temperature: float = 0.0,
          seed: int = 0, compress: Optional[float] = None, block_size: int = 16,
          num_blocks: Optional[int] = None, prefill_chunk: int = 64,
          eos: Optional[int] = None, prompts: Optional[Sequence] = None,
          params=None, device: Device = None) -> Dict:
    """Init (or take ``params``), calibrate + compress when ``compress`` is
    a ratio, then serve ``requests`` prompts.  Returns the outputs, the
    finished requests, the seconds of each phase and the engine."""
    dev = resolve_device(device)
    model = build_model(cfg)
    seconds: Dict[str, float] = {}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    if params is None:
        params = (load_small(cfg.name, dev) if cfg.name.startswith("small-")
                  else model.init(seed, dev))
    sync()
    seconds["init"] = time.perf_counter() - t0

    plan = None
    if compress is not None:
        t0 = time.perf_counter()
        gram_path = os.path.join(MODELS_DIR, cfg.name, "grams.npz")
        if cfg.name.startswith("small-") and os.path.exists(gram_path):
            grams = GramStore.load(gram_path, dev)
        else:
            grams = collect_grams(model, params, calibration_batches(
                cfg.vocab_size, "en_a", n_samples=256, batch=16, seq=128))
        sync()
        seconds["calibrate"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        plan = build_plan(model.compressible_targets(), CompressionConfig(
            method="nsvd1", ratio=compress, dtype=cfg.dtype,
            use_randomized=False))
        params = compress_params(params, plan, grams)
        del grams
        sync()
        seconds["compress"] = time.perf_counter() - t0

    eng = ServingEngine(model, params, max_batch=max_batch, max_len=max_len,
                        seed=seed, block_size=block_size, num_blocks=num_blocks,
                        prefill_chunk=prefill_chunk, eos_id=eos)
    if prompts is None:
        prompts = default_prompts(requests, cfg.vocab_size, seed)
    for p in prompts:
        eng.submit(p, max_new_tokens=max_new, temperature=temperature)
    t0 = time.perf_counter()
    out = eng.run()
    sync()
    seconds["serve"] = time.perf_counter() - t0
    n_tok = sum(len(v) for v in out.values())
    return {"outputs": out, "requests": eng.finished_requests, "plan": plan,
            "seconds": seconds, "tokens": n_tok,
            "tok_per_s": n_tok / max(seconds["serve"], 1e-9), "engine": eng,
            "params": params, "model": model}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="small-llama")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True, help="shrink a full-size arch to its "
                    "smoke-test config (--no-reduced serves it at full size)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--compress", type=float, default=None,
                    help="NSVD ratio (runs a calibration pass first)")
    ap.add_argument("--block-size", type=int, default=16, help="paged layout only")
    ap.add_argument("--num-blocks", type=int, default=None, help="paged layout only")
    ap.add_argument("--prefill-chunk", type=int, default=64, help="paged layout only")
    ap.add_argument("--eos", type=int, default=None)
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced and not args.arch.startswith("small-"):
        cfg = cfg.reduced()
    res = serve(cfg, requests=args.requests, max_new=args.max_new,
                max_batch=args.max_batch, max_len=args.max_len,
                temperature=args.temperature, seed=args.seed,
                compress=args.compress, block_size=args.block_size,
                num_blocks=args.num_blocks, prefill_chunk=args.prefill_chunk,
                eos=args.eos, device=args.device)
    if res["plan"] is not None:
        print(f"serving NSVD-compressed weights "
              f"({res['plan'].achieved_ratio:.0%} removed)")
    print(f"{len(res['outputs'])} requests, {res['tokens']} tokens, "
          f"{res['tok_per_s']:.1f} tok/s")
    print("phase seconds: " + ", ".join(f"{k}={v:.2f}"
                                         for k, v in res["seconds"].items()))
    s = res["engine"].stats()
    print(f"cache layout {res['engine'].layout}; prefill calls {s['prefill_ticks']}")
    print(f"decode steps: {s['steps']}  p50={s['step_p50_s'] * 1e3:.2f}ms  "
          f"p90={s['step_p90_s'] * 1e3:.2f}ms  host syncs={s['host_syncs']}")


if __name__ == "__main__":
    main()
