#!/usr/bin/env python3
"""Where the serving engine's decode step spends its host time, at
pipeline depths 1 and 2, and what the token copy costs there.

    python3 tools/ring_probe.py

Builds chip_smoke.py's serve-path model (mistral-7b at full width cut to 2
layers, random weights from seed 0, nsvd1 at 0.2 with bf16 factors), then
for each variant admits the first 8 sched_serve prompts into an engine
(max_batch 8, max_len 256, block 16, chunk 64, slot order) and times 40
``step()`` calls one by one: the call's wall, the part of it spent in
``_dispatch_decode``, and inside that the host inputs, the decode call
(its ~300 launches) and the token copy.  Variants: worst-case admission at
depth 1 and on-demand at depth 2 with the engine's pinned copy and event;
depth 1 with a blocking ``.cpu()`` copy (the engine before the ring);
depth 1 with the device kept busy (a ~2 ms ``torch.cuda._sleep`` queued
before each step), which tells launches into an idle device from ones
queued behind work.  Prints medians (ms) and writes
chiprun_out/ring_probe.json.  Needs one H100 and the CUDA toolkit.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
import chip_smoke  # noqa: E402

STEPS = 40
BUSY_CYCLES = 3_500_000  # ~2 ms at the H100's ~1.75 GHz


def probe(torch, np, model, params, prompts, depth, admission, copy, busy):
    from repro_torch.serving import engine as engine_mod
    from repro_torch.serving.scheduler import SchedulerConfig

    eng = engine_mod.ServingEngine(
        model, params, max_batch=8, max_len=256, seed=0, block_size=16,
        prefill_chunk=64, pipeline_depth=depth,
        sched_config=SchedulerConfig(admission=admission, sort_decode_rows=False))
    for p in prompts:
        eng.submit(p, max_new_tokens=chip_smoke.SCHED_MAX_NEW)
    while eng.sched or eng._prefilling:
        eng.run(max_steps=1)
    parts = {"inputs": [], "decode": [], "copy": [], "dispatch": []}

    def timed(name, fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            parts[name].append(time.perf_counter() - t0)
            return out
        return run

    real_to_host = engine_mod._to_host
    to_host = (lambda t: (t.cpu(), None)) if copy == "blocking" else real_to_host
    engine_mod._to_host = timed("copy", to_host)
    eng._host_inputs = timed("inputs", eng._host_inputs)
    eng._decode = timed("decode", eng._decode)
    eng._dispatch_decode = timed("dispatch", eng._dispatch_decode)
    walls = []
    try:
        for _ in range(4):
            eng.step()
        for v in parts.values():
            v.clear()
        for _ in range(STEPS):
            if busy:
                torch.cuda._sleep(BUSY_CYCLES)
            t0 = time.perf_counter()
            eng.step()
            walls.append(time.perf_counter() - t0)
        eng.drain()
    finally:
        engine_mod._to_host = real_to_host
    med = lambda xs: sorted(xs)[len(xs) // 2] * 1e3  # noqa: E731
    return {"step_ms": med(walls), **{f"{k}_ms": med(v) for k, v in parts.items()}}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ring_probe: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import MISTRAL_7B
    from repro_torch.kernels import build
    from repro_torch.launch.serve import serve

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all(("nested_lowrank", "paged_attention", "gram", "flash_attention"))
    cfg = dataclasses.replace(MISTRAL_7B, num_layers=2)
    rng = np.random.default_rng(0)
    plens = rng.integers(16, 201, size=chip_smoke.SCHED_REQUESTS)
    prompts = [rng.integers(2, cfg.vocab_size // 2, size=int(n)) for n in plens][:8]
    res = serve(cfg, requests=1, max_new=2, max_batch=8, max_len=256, seed=0,
                compress=0.2, prompts=prompts[:1], sched_policy="worst_case",
                pipeline_depth=1)
    model, params = res["model"], res["params"]
    variants = (("depth1", 1, "worst_case", "event", False),
                ("depth2", 2, "on_demand", "event", False),
                ("depth1_blocking_copy", 1, "worst_case", "blocking", False),
                ("depth1_device_busy", 1, "worst_case", "event", True),
                ("depth1_again", 1, "worst_case", "event", False),
                ("depth2_again", 2, "on_demand", "event", False))
    out = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "variants": {}}
    for name, depth, admission, copy, busy in variants:
        r = probe(torch, np, model, params, prompts, depth, admission, copy, busy)
        out["variants"][name] = r
        print(f"{name:22s} " + "  ".join(f"{k} {v:.3f}" for k, v in r.items()), flush=True)
    os.makedirs(chip_smoke.OUT_DIR, exist_ok=True)
    with open(os.path.join(chip_smoke.OUT_DIR, "ring_probe.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
