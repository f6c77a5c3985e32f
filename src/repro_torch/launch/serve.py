"""Serving launcher: build (or load) a model, optionally calibrate and
NSVD-compress it, and serve batched requests through the engine, on the
cache layout the model takes (``models.api.cache_layout``): paged block
pools for the attention families (the paper's, chatglm3-6b, phi3-medium-14b,
deepseek-67b), the dense slab for RWKV-6 (recurrent state), the token-choice
MoE family (attention K/V), jamba (the Mamba layers' state beside the
attention layer's K/V) and MLA (minicpm3-4b: its latents, admitted in
prompt-length buckets).

    python -m repro_torch.launch.serve --arch mistral-7b --no-reduced \\
        --compress 0.2 --requests 8 --max-new 32
    python -m repro_torch.launch.serve --arch chatglm3-6b --no-reduced \\
        --layers 2 --compress 0.2 --requests 8 --max-new 32 --max-batch 8
    python -m repro_torch.launch.serve --arch minicpm3-4b --no-reduced \\
        --layers 4 --compress 0.2 --requests 8 --max-new 32 --max-batch 8
    python -m repro_torch.launch.serve --arch rwkv6-1.6b --no-reduced \\
        --compress 0.2 --requests 8 --max-new 32 --max-batch 8
    python -m repro_torch.launch.serve --arch moonshot-v1-16b-a3b --no-reduced \\
        --layers 3 --compress 0.2 --requests 8 --max-new 32 --max-batch 8
    python -m repro_torch.launch.serve --arch jamba-v0.1-52b --no-reduced \\
        --layers 5 --requests 8 --max-new 32 --max-batch 8

On the card the CLI first sizes what the run will hold (the weights, and
when it compresses the calibration's fp64 Grams and a batched tap's Gram:
``launch.compress_shapes.calibration_bytes``, on meta tensors) against the
card's free memory, and refuses a run that does not fit before it
allocates anything (jamba-v0.1-52b's 32 layers are 103 GB of bf16 weights;
a 5-layer cut with all 16 experts still holds 71 GB of Grams).

The engine schedules as the reference's does by default: on-demand block
growth with preemption (re-prefill resume), one latency class, two decode
steps in flight; ``--sched-policy``, ``--priority-classes``, ``--no-preempt``
and ``--pipeline-depth`` change that, and ``serve(resume="swap")`` resumes
preempted rows from host copies of their blocks.

Speculative decoding (``serving/spec``): ``--spec-ratio R`` builds a
draft of the same weights at NSVD ratio R (above ``--compress``) from the
same calibration Grams, and each engine step drafts ``--spec-k`` tokens
and verifies them in one target call (``--spec-dynamic-k``: per-row
windows); a ``spec[k=...]`` line prints the acceptance.

    python -m repro_torch.launch.serve --arch mistral-7b --no-reduced \\
        --layers 2 --compress 0.2 --spec-ratio 0.6 --spec-k 4 --max-batch 8

Faults (``serving/faults``): ``--chaos PLAN.json`` injects a seeded
``FaultPlan`` (the reference's JSON), ``--max-retries`` lets a poisoned
request re-prefill before it ends with "error", and ``--step-timeout``
makes a slower step raise ``ServingFault`` with an engine snapshot.  A
fault report prints at exit.  SIGTERM drains (the queue is shed, live rows
finish), and the engine is closed on every exit.

Observability (``repro_torch.obs``): any of ``--metrics-port``,
``--metrics-json``, ``--trace-jsonl``, ``--trace-chrome`` or ``--profile-dir``
turns on the engine's telemetry (compression reports into the same
registry) and prints a ``telemetry:`` line (TTFT, TPOT, events) at exit;
``--metrics-port`` serves /metrics, /metrics.json and /healthz while the
run lasts, and ``--profile-dir`` writes a torch.profiler Chrome trace of
``--profile-steps`` engine steps.  ``--transfer-guard`` runs every dispatch
under torch's sync-debug mode "error" (the card only), and ``--paged``
picks the cache layout (auto: the model's own).

    python -m repro_torch.launch.serve --arch mistral-7b --no-reduced --layers 2 \\
        --compress 0.2 --metrics-json m.json --trace-chrome t.json --profile-dir prof

Mesh serving (``--dp``/``--tp``): one process a rank under ``torchrun``
(NCCL on the card, gloo with ``--device cpu``), each serving the same
requests over a (dp, tp) mesh -- weights tensor-parallel, slots and their
KV pools data-parallel (``serving.engine``).  Without ``torchrun``, dp*tp
> 1 warns and serves a (1, 1) mesh, as the reference does.  Rank 0 prints
the mesh line, the per-device cache bytes and the per-shard peaks.

    torchrun --nproc-per-node 4 -m repro_torch.launch.serve --device cpu \
        --dp 2 --tp 2 --arch llama-7b --requests 8 --max-new 8

``small-*`` archs load the trained checkpoint from
``experiments/models/<name>/`` (and its ``grams.npz`` when present),
training it first with the reference's recipe when there is none; every
other arch starts from random weights drawn from ``--seed``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import signal
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import Device, bridge, resolve_device
from repro_torch.calib.gram import calibration_precision
from repro_torch.calib.runner import calibration_batches, collect_grams
from repro_torch.configs import ModelConfig, get_config
from repro_torch.core import CompressionConfig, GramStore, build_plan, compress_params
from repro_torch.core.compress import GRAM_HOMES
from repro_torch.launch.train import MODELS_DIR, train_small_lm
from repro_torch.models import build_model
from repro_torch.models.api import build_draft_params
from repro_torch.obs import CompressionTelemetry, MetricsServer, Telemetry, write_metrics_json
from repro_torch.parallel import Parallelism, make_parallelism
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.faults import FaultPlan, FaultPolicy
from repro_torch.serving.scheduler import SchedulerConfig
from repro_torch.serving.spec import SpecConfig


def load_small(name: str, device: Device = None):
    """The trained small-* checkpoint under ``experiments/models/<name>/``
    (the reference's or the port's: one layout).  When there is none, it is
    trained first with the reference's recipe (``launch.train.train_small_lm``)
    on ``device`` and saved there, as the reference's launcher does on its
    first run."""
    ckpt_dir = os.path.join(MODELS_DIR, name)
    if not os.path.isdir(ckpt_dir) or not any(
            n.startswith("step_") and not n.endswith(".tmp") for n in os.listdir(ckpt_dir)):
        train_small_lm(name, device=device, ckpt_dir=ckpt_dir)
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
          fault_policy: Optional[FaultPolicy] = None,
          spec_ratio: Optional[float] = None, spec_k: int = 4,
          spec_dynamic_k: bool = False, paged: Optional[bool] = None,
          telemetry: Optional[Telemetry] = None, transfer_guard: bool = False,
          on_engine: Optional[Callable[[ServingEngine], None]] = None,
          grams_on: str = "device", parallelism: Optional[Parallelism] = None) -> Dict:
    """Init (or take ``params``), calibrate + compress when ``compress`` is
    a ratio, build a speculative draft at ``spec_ratio`` (from the
    uncompressed params and the same Grams, drafting ``spec_k`` tokens a
    step), then serve ``requests`` prompts under the scheduling policy
    (``sched_policy``, ``priority_classes``, ``preempt``, ``resume``; the
    reference's defaults) at ``pipeline_depth`` (None: the engine's default,
    2), with an optional fault plan and policy, on the cache layout ``paged``
    picks (None: the model's own).  ``telemetry`` observes the engine, and
    compression reports into its registry; ``transfer_guard`` runs every
    dispatch under sync-debug "error"; ``on_engine`` is called with the
    engine once it is built; ``grams_on`` is the calibration GramStore's
    home, "device" or "host" (``calib.runner.collect_grams``);
    ``parallelism``: the serving mesh (every rank calibrates and compresses
    the whole model, then the engine cuts its shards).  Every
    request goes to the lowest class.  In the main thread SIGTERM drains
    the engine while it runs; the engine is closed on every exit (a
    ``ServingFault`` still raises).  Returns the outputs, the finished
    requests, the seconds of each phase, the engine and, when it
    calibrated, its GramStore's home, group count, bytes and the most of
    them held on the device at once (``gram_store``).  Matmuls run in full
    fp32 on the card (no TF32): calibration needs it, and so does the MoE
    router, whose top-k choices TF32 would change."""
    if cfg.frontend == "vision" and (compress is not None or spec_ratio is not None):
        # The reference's launcher calibrates on tokens only, and then finds
        # no Gram for the projector's targets.
        raise ValueError(
            f"{cfg.name}'s projector targets are calibrated on image patches, and "
            "serve() calibrates on tokens only: collect Grams over batch dicts with "
            "'patches' (calib.runner.collect_grams), compress, and pass params=")
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

    plan = spec = store = None
    if compress is not None or spec_ratio is not None:
        t0 = time.perf_counter()
        gram_path = os.path.join(MODELS_DIR, cfg.name, "grams.npz")
        if cfg.name.startswith("small-") and os.path.exists(gram_path):
            grams = GramStore.load(gram_path, dev if grams_on == "device" else "cpu")
        else:
            grams = collect_grams(model, params, calibration_batches(
                cfg.vocab_size, "en_a", n_samples=256, batch=16, seq=128),
                grams_on=grams_on)
        sync()
        seconds["calibrate"] = time.perf_counter() - t0
        store = {"grams_on": grams_on, "groups": grams.groups, "bytes": grams.nbytes(),
                 "device_bytes": grams.device_bytes}
        base = params
        if compress is not None:
            t0 = time.perf_counter()
            plan = build_plan(model.compressible_targets(), CompressionConfig(
                method="nsvd1", ratio=compress, dtype=cfg.dtype,
                use_randomized=False))
            params = compress_params(base, plan, grams, telemetry=(
                None if telemetry is None
                else CompressionTelemetry(registry=telemetry.metrics)))
            sync()
            seconds["compress"] = time.perf_counter() - t0
        if spec_ratio is not None:
            t0 = time.perf_counter()
            spec = SpecConfig(draft_params=build_draft_params(model, base, grams, spec_ratio),
                              k=spec_k, dynamic_k=spec_dynamic_k, draft_ratio=spec_ratio)
            sync()
            seconds["draft"] = time.perf_counter() - t0
        del grams, base

    eng = ServingEngine(model, params, max_batch=max_batch, max_len=max_len,
                        seed=seed, block_size=block_size, num_blocks=num_blocks,
                        prefill_chunk=prefill_chunk, eos_id=eos,
                        pipeline_depth=pipeline_depth,
                        sched_config=SchedulerConfig(
                            admission=sched_policy, preempt=preempt, resume=resume,
                            priority_classes=tuple(priority_classes)),
                        faults=faults, fault_policy=fault_policy, spec_config=spec,
                        paged=paged, telemetry=telemetry, transfer_guard=transfer_guard,
                        parallelism=parallelism)
    if on_engine is not None:
        on_engine(eng)
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
        if telemetry is not None and telemetry.profile is not None:
            telemetry.profile.stop()
    sync()
    seconds["serve"] = time.perf_counter() - t0
    n_tok = sum(len(v) for v in out.values())
    return {"outputs": out, "requests": eng.finished_requests, "plan": plan,
            "seconds": seconds, "tokens": n_tok,
            "tok_per_s": n_tok / max(seconds["serve"], 1e-9), "engine": eng,
            "params": params, "model": model, "gram_store": store}


def run_bytes(cfg: ModelConfig, ratios: Sequence[float],
              grams_on: str = "device") -> tuple:
    """(bytes, what they are) that a run of ``cfg`` holds on the device at
    most: the weights; when it compresses (at each of ``ratios``: the
    served model's, a draft's) the calibration's fp64 Grams, and on top of
    them the larger of what a calibration batch's tap makes and drops and
    compression's own bytes (every ratio's factored leaves and the most
    one target's fp64 decomposition adds); all sized on meta tensors
    (``calibration_bytes``, ``gram_layers``, ``compression_bytes``).  With
    the Grams in host memory (``grams_on="host"``) the device holds, in
    place of all of them, the keys every calibration group holds and one
    layer's (the least a group takes) while it calibrates, and one Gram at
    a time while it compresses.  A calibration batch's activations are not
    counted: on the served cuts the compression's bytes are larger."""
    from repro_torch.launch.compress_shapes import (calibration_bytes, compression_bytes,
                                                    gram_layers, tree_bytes)

    model = build_model(cfg)
    if not ratios:
        return tree_bytes(model.init(device="meta")), "weights"
    calib = calibration_bytes(model)
    configs = [CompressionConfig(method="nsvd1", ratio=r, dtype=cfg.dtype,
                                 use_randomized=False) for r in ratios]
    comp = [compression_bytes(model, c) for c in configs]
    factors = sum(c["factors"] for c in comp)
    work = max(c["work"] for c in comp)
    if grams_on == "device":
        extra = max(calib["batch_gram"], factors + work)
        return (calib["weights"] + calib["grams"] + extra,
                f"weights {calib['weights'] / 1e9:.2f} + calibration Grams "
                f"{calib['grams'] / 1e9:.2f} + compression {extra / 1e9:.2f}")
    layers = gram_layers(model)
    group = layers["shared"] + max(layers["layers"].values(), default=0) + calib["batch_gram"]
    widest = max(t.in_dim for t in model.compressible_targets())
    comp_dev = factors + work + 8 * (widest * widest + widest)
    return (calib["weights"] + max(group, comp_dev),
            f"weights {calib['weights'] / 1e9:.2f} + the larger of a calibration group's "
            f"Grams {group / 1e9:.2f} and compression {comp_dev / 1e9:.2f}; "
            f"{calib['grams'] / 1e9:.2f} of Grams in host memory")


def fit_error(cfg: ModelConfig, ratios: Sequence[float], free_bytes: int,
              grams_on: str = "device") -> Optional[str]:
    """Why a run of ``cfg`` compressing at ``ratios`` with its Grams on
    ``grams_on`` cannot fit ``free_bytes`` of device memory (both numbers,
    ``run_bytes``), or None when it fits.  When the Grams on the device do
    not fit but in host memory they would, the message says so before it
    suggests a cut."""
    need, what = run_bytes(cfg, ratios, grams_on)
    if need <= free_bytes:
        return None
    msg = (f"{cfg.name} at {cfg.num_layers} layers needs {need / 1e9:.2f} GB "
           f"({what}) but the card has {free_bytes / 1e9:.2f} GB free; ")
    if grams_on == "device" and ratios:
        host, _ = run_bytes(cfg, ratios, "host")
        if host <= free_bytes:
            return msg + (f"--grams-on host keeps the Grams in host memory and needs "
                          f"{host / 1e9:.2f} GB on the card, or cut it with --layers")
    return msg + "cut it with --layers"


def report_telemetry(telemetry: Telemetry, eng: ServingEngine, args) -> None:
    """The ``telemetry:`` line, and the files the observability flags name.
    A profiler capture that failed is printed, never passed over."""
    bb = telemetry.bench_block()
    print(f"telemetry: ttft p50={bb['ttft_s']['p50'] * 1e3:.1f}ms "
          f"p99={bb['ttft_s']['p99'] * 1e3:.1f}ms  tpot p50={bb['tpot_s']['p50'] * 1e3:.2f}ms  "
          f"queue wait p50={bb['queue_wait_s']['p50'] * 1e3:.1f}ms  "
          f"{len(telemetry.tracer)} events ({telemetry.tracer.dropped} dropped)")
    if args.metrics_json:
        write_metrics_json(telemetry.metrics, args.metrics_json,
                           extra={"engine": {"stats": eng.stats(), "cache": eng.cache_stats(),
                                             "spec": eng.spec_stats()},
                                  "telemetry": bb})
        print(f"metrics snapshot -> {args.metrics_json}")
    if args.trace_jsonl:
        telemetry.tracer.export_jsonl(args.trace_jsonl)
        print(f"event trace (jsonl) -> {args.trace_jsonl}")
    if args.trace_chrome:
        telemetry.tracer.export_chrome(args.trace_chrome)
        print(f"chrome trace -> {args.trace_chrome}")
    prof = telemetry.profile
    if prof is not None:
        if prof.error is not None:
            print(f"profile capture FAILED: {prof.error!r}")
        elif prof.trace_path is not None:
            print(f"torch.profiler trace -> {prof.trace_path}")
        else:
            print(f"profile capture: no step dispatched, nothing written to {args.profile_dir}")


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
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel mesh axis: slots, per-slot state and KV pools "
                    "shard over dp ranks (max-batch should divide it)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel mesh axis: weights shard over tp ranks "
                    "(factored NSVD layers all-reduce rank-k partials). Run under "
                    "torchrun --nproc-per-node dp*tp; without it dp*tp > 1 falls back "
                    "to a (1, 1) mesh with a warning")
    ap.add_argument("--grams-on", choices=GRAM_HOMES, default="device",
                    help="the calibration GramStore's home: device memory, or host "
                    "memory (as the reference keeps it), filled a group of layers at "
                    "a time so that only one group's sums are on the card")
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
    ap.add_argument("--paged", choices=("auto", "on", "off"), default="auto",
                    help="cache layout: auto takes the model's own (paged for "
                    "pure-attention stacks), off the dense slab; on refuses a model "
                    "whose layout is dense")
    ap.add_argument("--transfer-guard", action="store_true",
                    help="run every dispatch under torch's sync-debug mode 'error': "
                    "a host sync inside one raises instead of stalling the ring "
                    "(the card only: refused with --device cpu)")
    ap.add_argument("--pipeline-depth", type=int, default=None,
                    help="in-flight decode steps (default 2, or "
                    "REPRO_SERVING_PIPELINE_DEPTH); 1 waits for each step's tokens "
                    "before the next dispatch; every depth gives the same tokens")
    spec_g = ap.add_argument_group(
        "speculative decoding", "a higher-ratio NSVD draft of the same weights "
        "(repro_torch.serving.spec); off by default")
    spec_g.add_argument("--spec-ratio", type=float, default=None,
                        help="enable self-speculative decoding with a draft compressed "
                        "at this (higher) NSVD ratio")
    spec_g.add_argument("--spec-k", type=int, default=4,
                        help="speculation window: draft tokens per step")
    spec_g.add_argument("--spec-dynamic-k", action="store_true",
                        help="per-row adaptive speculation windows")
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
    obs_g = ap.add_argument_group(
        "observability", "host-side telemetry (repro_torch.obs): any flag here turns "
        "on the tracer and the metrics registry; all are off by default")
    obs_g.add_argument("--metrics-port", type=int, default=None,
                       help="serve Prometheus text at :PORT/metrics, a JSON snapshot at "
                       ":PORT/metrics.json and a health probe at :PORT/healthz while "
                       "the run lasts (0 picks a free port)")
    obs_g.add_argument("--metrics-json", default=None, metavar="PATH",
                       help="write a final JSON metrics snapshot here")
    obs_g.add_argument("--trace-jsonl", default=None, metavar="PATH",
                       help="export the event ring as JSONL")
    obs_g.add_argument("--trace-chrome", default=None, metavar="PATH",
                       help="export the event ring as a Chrome trace (Perfetto, "
                       "chrome://tracing)")
    obs_g.add_argument("--profile-dir", default=None, metavar="DIR",
                       help="write a torch.profiler Chrome trace of the first "
                       "--profile-steps engine steps into DIR")
    obs_g.add_argument("--profile-steps", type=int, default=8,
                       help="steps to profile with --profile-dir")
    args = ap.parse_args(argv)
    if args.transfer_guard and resolve_device(args.device).type != "cuda":
        ap.error("--transfer-guard checks dispatches for host syncs on the card; "
                 f"--device {args.device} has none to check")
    faults = fault_policy = None
    if args.chaos is not None or args.max_retries or args.step_timeout is not None:
        if args.chaos is not None:
            faults = FaultPlan.from_json(args.chaos)
            print(f"chaos: {len(faults)} seeded fault(s) from {args.chaos}")
        fault_policy = FaultPolicy(max_retries=args.max_retries,
                                   step_timeout_s=args.step_timeout)

    telemetry = server = None
    engine_ref: Dict[str, ServingEngine] = {}
    if any(v is not None for v in (args.metrics_port, args.metrics_json, args.trace_jsonl,
                                   args.trace_chrome, args.profile_dir)):
        telemetry = Telemetry(profile_dir=args.profile_dir, profile_steps=args.profile_steps)
        if args.metrics_port is not None:
            # Up before compression, which reports into the same registry;
            # /healthz reads the engine once it exists.
            server = MetricsServer(telemetry.metrics, port=args.metrics_port,
                                   health=lambda: (engine_ref["eng"].degraded_components()
                                                   if "eng" in engine_ref else {}))
            print(f"metrics: {server.url} (+ /metrics.json, /healthz)")

    parallelism, rank = None, 0
    if args.dp * args.tp > 1 or "WORLD_SIZE" in os.environ:
        from repro_torch.launch.mesh import make_serving_mesh

        mesh = make_serving_mesh(args.dp, args.tp, device=args.device)
        parallelism = make_parallelism(mesh)
        rank = torch.distributed.get_rank()
        if rank == 0:
            print(f"serving mesh: dp={parallelism.dp_size} tp={parallelism.tp_size} "
                  f"({parallelism.size} device(s))")

    cfg = get_config(args.arch)
    if args.reduced and not args.arch.startswith("small-"):
        cfg = cfg.reduced()
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    if resolve_device(args.device).type == "cuda":
        err = fit_error(cfg, [r for r in (args.compress, args.spec_ratio) if r is not None],
                        torch.cuda.mem_get_info()[0], args.grams_on)
        if err is not None:
            if server is not None:
                server.close()
            ap.error(err)
    try:
        res = serve(cfg, requests=args.requests, max_new=args.max_new,
                    max_batch=args.max_batch, max_len=args.max_len,
                    temperature=args.temperature, seed=args.seed,
                    compress=args.compress, block_size=args.block_size,
                    num_blocks=args.num_blocks, prefill_chunk=args.prefill_chunk,
                    eos=args.eos, device=args.device, sched_policy=args.sched_policy,
                    priority_classes=tuple(c.strip()
                                           for c in args.priority_classes.split(",")
                                           if c.strip()) if args.priority_classes
                    else ("default",),
                    preempt=not args.no_preempt, pipeline_depth=args.pipeline_depth,
                    faults=faults, fault_policy=fault_policy, spec_ratio=args.spec_ratio,
                    spec_k=args.spec_k, spec_dynamic_k=args.spec_dynamic_k,
                    paged={"auto": None, "on": True, "off": False}[args.paged],
                    telemetry=telemetry, transfer_guard=args.transfer_guard,
                    on_engine=lambda eng: engine_ref.update(eng=eng),
                    grams_on=args.grams_on, parallelism=parallelism)
    finally:
        if server is not None:
            server.close()
    if parallelism is not None:
        torch.distributed.destroy_process_group()
    if rank != 0:
        return

    if res["gram_store"] is not None:
        gs = res["gram_store"]
        print(f"calibration Grams on the {gs['grams_on']}: {gs['groups']} group(s) of "
              f"layers, {gs['bytes'] / 1e9:.2f} GB ({gs['bytes']} bytes)")
    if res["plan"] is not None:
        print(f"serving NSVD-compressed weights "
              f"({res['plan'].achieved_ratio:.0%} removed)")
    if args.spec_ratio is not None:
        print(f"speculative decoding: nsvd-{args.spec_ratio:.0%} draft, k={args.spec_k}"
              + (" (dynamic per-row)" if args.spec_dynamic_k else ""))
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
    cs = res["engine"].cache_stats()
    mesh_s = cs["mesh"]
    per_dev = (f" ({cs['per_device_cache_hbm_bytes'] / 1e6:.2f}MB/device, "
               f"dp={mesh_s['dp']} tp={mesh_s['tp']})" if mesh_s["devices"] > 1 else "")
    extra = (f"  peak blocks={cs['blocks_peak']}/{cs['num_blocks']}"
             if cs["layout"] == "paged" else "")
    if cs.get("blocks_peak_by_shard"):
        extra += f"  per-shard peaks={cs['blocks_peak_by_shard']}"
    print(f"cache[{cs['layout']}]: {cs['cache_hbm_bytes'] / 1e6:.2f}MB{per_dev}, "
          f"capacity {cs['tokens_capacity']} tok{extra}")
    if res["engine"].layout == "paged":
        sch = res["engine"].scheduler_stats()
        occ = sch["occupancy_live_frac"]
        occ_s = f"{occ:.0%}" if occ is not None else "n/a"
        print(f"sched[{sch['admission_policy']}]: live/reserved {occ_s}, "
              f"{sch['preempt_count']} preempts, {sch['resumes']} resumes, "
              f"{sch['grown_blocks']} grown blocks, {sch['stalls']} stalls, "
              f"swap {sch['swap_bytes'] / 1e6:.2f}MB")
    ss = res["engine"].spec_stats()
    if ss:
        print(f"spec[k={ss['k']}]: acceptance {ss['acceptance_rate']:.0%}, "
              f"{ss['committed_per_row_step']:.2f} committed tok/row-step, "
              f"draft cache {ss['draft_hbm_bytes'] / 1e6:.2f}MB")
    if fault_policy is not None:
        fs = res["engine"].fault_stats()
        inj = ", ".join(f"{k}={v}" for k, v in sorted(fs["injected"].items()))
        reasons: Dict[str, int] = {}
        for r in res["requests"].values():
            reasons[r.finish_reason] = reasons.get(r.finish_reason, 0) + 1
        print(f"faults: injected [{inj or 'none'}], quarantined={fs['quarantined']} "
              f"retried={fs['retried']} shed={fs['shed']} cancelled={fs['cancelled']} "
              f"swap_fallbacks={fs['swap_fallbacks']} straggler slow/trips="
              f"{fs['straggler_slow']}/{fs['straggler_trips']} draft kills/re-enables="
              f"{fs['draft_kills']}/{fs['draft_reenables']}; finish reasons {reasons}")
        if faults is not None and faults.outstanding():
            kinds = [sp.kind for sp in faults.outstanding()]
            print(f"faults: {len(kinds)} spec(s) never found an injection site: {kinds}")

    if telemetry is not None:
        report_telemetry(telemetry, res["engine"], args)


if __name__ == "__main__":
    main()
