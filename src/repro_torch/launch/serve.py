"""Serving launcher: build (or load) a model, optionally calibrate and
NSVD-compress it, and serve batched requests through the engine, on the
cache layout the model takes (``models.api.cache_layout``): paged block
pools for the attention families, the dense slab for RWKV-6 (recurrent
state) and the token-choice MoE family (attention K/V).

    python -m repro_torch.launch.serve --arch mistral-7b --no-reduced \\
        --compress 0.2 --requests 8 --max-new 32
    python -m repro_torch.launch.serve --arch rwkv6-1.6b --no-reduced \\
        --compress 0.2 --requests 8 --max-new 32 --max-batch 8
    python -m repro_torch.launch.serve --arch moonshot-v1-16b-a3b --no-reduced \\
        --layers 3 --compress 0.2 --requests 8 --max-new 32 --max-batch 8

The engine schedules as the reference's does by default: on-demand block
growth with preemption (re-prefill resume), one latency class, two decode
steps in flight; ``--sched-policy``, ``--priority-classes``, ``--no-preempt``
and ``--pipeline-depth`` change that, and ``serve(resume="swap")`` resumes
preempted rows from host copies of their blocks.

Faults (``serving/faults``): ``--chaos PLAN.json`` injects a seeded
``FaultPlan`` (the reference's JSON), ``--max-retries`` lets a poisoned
request re-prefill before it ends with "error", and ``--step-timeout``
makes a slower step raise ``ServingFault`` with an engine snapshot.  A
fault report prints at exit.  SIGTERM drains (the queue is shed, live rows
finish), and the engine is closed on every exit.

``small-*`` archs load the reference's trained checkpoint from
``experiments/models/<name>/`` (and its ``grams.npz`` when present); every
other arch starts from random weights drawn from ``--seed``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import signal
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import Device, bridge, resolve_device
from repro_torch.calib.gram import calibration_precision
from repro_torch.calib.runner import calibration_batches, collect_grams
from repro_torch.configs import ModelConfig, get_config
from repro_torch.core import CompressionConfig, GramStore, build_plan, compress_params
from repro_torch.models import build_model
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.faults import FaultPlan, FaultPolicy
from repro_torch.serving.scheduler import SchedulerConfig

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
          params=None, device: Device = None, sched_policy: str = "on_demand",
          priority_classes: Sequence[str] = ("default",), preempt: bool = True,
          resume: str = "reprefill", pipeline_depth: Optional[int] = None,
          faults: Optional[FaultPlan] = None,
          fault_policy: Optional[FaultPolicy] = None) -> Dict:
    """Init (or take ``params``), calibrate + compress when ``compress`` is
    a ratio, then serve ``requests`` prompts under the scheduling policy
    (``sched_policy``, ``priority_classes``, ``preempt``, ``resume``; the
    reference's defaults) at ``pipeline_depth`` (None: the engine's default,
    2), with an optional fault plan and policy.  Every request goes to the
    lowest class.  In the main thread SIGTERM drains the engine while it
    runs; the engine is closed on every exit (a ``ServingFault`` still
    raises).  Returns the outputs, the
    finished requests, the seconds of each phase and the engine.  Matmuls
    run in full fp32 on the card (no TF32): calibration needs it, and so
    does the MoE router, whose top-k choices TF32 would change."""
    dev = resolve_device(device)
    calibration_precision()
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
                        prefill_chunk=prefill_chunk, eos_id=eos,
                        pipeline_depth=pipeline_depth,
                        sched_config=SchedulerConfig(
                            admission=sched_policy, preempt=preempt, resume=resume,
                            priority_classes=tuple(priority_classes)),
                        faults=faults, fault_policy=fault_policy)
    if prompts is None:
        prompts = default_prompts(requests, cfg.vocab_size, seed)
    for p in prompts:
        eng.submit(p, max_new_tokens=max_new, temperature=temperature)
    main_thread = threading.current_thread() is threading.main_thread()
    if main_thread:
        prev = signal.signal(signal.SIGTERM, lambda *_: eng.request_drain())
    t0 = time.perf_counter()
    try:
        out = eng.run()
    finally:
        eng.close()
        if main_thread:
            signal.signal(signal.SIGTERM, prev)
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
    ap.add_argument("--layers", type=int, default=None, help="cut the depth")
    ap.add_argument("--eos", type=int, default=None)
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--sched-policy", choices=("on_demand", "worst_case"),
                    default="on_demand", help="paged admission: on_demand "
                    "reserves the prompt's blocks and grows at block boundaries; "
                    "worst_case reserves prompt + max_new up front")
    ap.add_argument("--priority-classes", default=None, metavar="A,B,...",
                    help="latency classes, highest priority first (default: one "
                    "'default' class, FIFO); requests here all land in the lowest")
    ap.add_argument("--no-preempt", action="store_true",
                    help="never evict a live row when the pool runs dry: a starved "
                    "row stalls until blocks free, and a full-pool deadlock raises")
    ap.add_argument("--pipeline-depth", type=int, default=None,
                    help="in-flight decode steps (default 2, or "
                    "REPRO_SERVING_PIPELINE_DEPTH); 1 waits for each step's tokens "
                    "before the next dispatch; every depth gives the same tokens")
    fault_g = ap.add_argument_group(
        "fault tolerance", "seeded chaos and the degradation policy "
        "(repro_torch.serving.faults); off by default")
    fault_g.add_argument("--chaos", default=None, metavar="PLAN.json",
                         help='inject the FaultPlan in PLAN.json ({"faults": [{"kind": '
                         '"straggler", "step": 4}, ...]}); a fault report prints at exit')
    fault_g.add_argument("--max-retries", type=int, default=0,
                         help="poisoned-request retries (re-prefill from the committed "
                         "context, capped exponential backoff) before finish reason "
                         "'error'")
    fault_g.add_argument("--step-timeout", type=float, default=None, metavar="SECONDS",
                         help="hard per-step limit: a slower step raises ServingFault "
                         "with an engine snapshot")
    args = ap.parse_args(argv)
    faults = fault_policy = None
    if args.chaos is not None or args.max_retries or args.step_timeout is not None:
        if args.chaos is not None:
            faults = FaultPlan.from_json(args.chaos)
            print(f"chaos: {len(faults)} seeded fault(s) from {args.chaos}")
        fault_policy = FaultPolicy(max_retries=args.max_retries,
                                   step_timeout_s=args.step_timeout)

    cfg = get_config(args.arch)
    if args.reduced and not args.arch.startswith("small-"):
        cfg = cfg.reduced()
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    res = serve(cfg, requests=args.requests, max_new=args.max_new,
                max_batch=args.max_batch, max_len=args.max_len,
                temperature=args.temperature, seed=args.seed,
                compress=args.compress, block_size=args.block_size,
                num_blocks=args.num_blocks, prefill_chunk=args.prefill_chunk,
                eos=args.eos, device=args.device, sched_policy=args.sched_policy,
                priority_classes=tuple(c.strip() for c in args.priority_classes.split(",")
                                       if c.strip()) if args.priority_classes
                else ("default",),
                preempt=not args.no_preempt, pipeline_depth=args.pipeline_depth,
                faults=faults, fault_policy=fault_policy)
    if res["plan"] is not None:
        print(f"serving NSVD-compressed weights "
              f"({res['plan'].achieved_ratio:.0%} removed)")
    print(f"{len(res['outputs'])} requests, {res['tokens']} tokens, "
          f"{res['tok_per_s']:.1f} tok/s")
    print("phase seconds: " + ", ".join(f"{k}={v:.2f}"
                                         for k, v in res["seconds"].items()))
    s = res["engine"].stats()
    print(f"cache layout {res['engine'].layout}; prefill calls {s['prefill_ticks']}")
    print(f"decode steps: {s['steps']} (pipeline depth {s['pipeline_depth']})  "
          f"p50={s['step_p50_s'] * 1e3:.2f}ms  p90={s['step_p90_s'] * 1e3:.2f}ms  "
          f"[dispatch {s['step_dispatch_s'] * 1e3:.2f}ms + device wait "
          f"{s['step_device_wait_s'] * 1e3:.2f}ms + host {s['step_host_s'] * 1e3:.2f}ms "
          f"per step]  host syncs={s['host_syncs']}")
    if res["engine"].layout == "paged":
        sch = res["engine"].scheduler_stats()
        occ = sch["occupancy_live_frac"]
        occ_s = f"{occ:.0%}" if occ is not None else "n/a"
        print(f"sched[{sch['admission_policy']}]: live/reserved {occ_s}, "
              f"{sch['preempt_count']} preempts, {sch['resumes']} resumes, "
              f"{sch['grown_blocks']} grown blocks, {sch['stalls']} stalls, "
              f"swap {sch['swap_bytes'] / 1e6:.2f}MB")
    if fault_policy is not None:
        fs = res["engine"].fault_stats()
        inj = ", ".join(f"{k}={v}" for k, v in sorted(fs["injected"].items()))
        reasons: Dict[str, int] = {}
        for r in res["requests"].values():
            reasons[r.finish_reason] = reasons.get(r.finish_reason, 0) + 1
        print(f"faults: injected [{inj or 'none'}], quarantined={fs['quarantined']} "
              f"retried={fs['retried']} shed={fs['shed']} cancelled={fs['cancelled']} "
              f"swap_fallbacks={fs['swap_fallbacks']} straggler slow/trips="
              f"{fs['straggler_slow']}/{fs['straggler_trips']}; finish reasons {reasons}")
        if faults is not None and faults.outstanding():
            kinds = [sp.kind for sp in faults.outstanding()]
            print(f"faults: {len(kinds)} spec(s) never found an injection site: {kinds}")


if __name__ == "__main__":
    main()
