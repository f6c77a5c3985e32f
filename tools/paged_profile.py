#!/usr/bin/env python3
"""The paged-attention kernel's device time at each split plan, for the
constants of ``ops.plan_splits``.

    python3 tools/paged_profile.py

For chip_smoke.py's paged cases (lengths 1-700, long8, one32k and the
Mistral serve path's decode step: 8 rows of 35-189 tokens in a 16-column
table), bf16 and int8 pools: the device ms of one call (torch.profiler,
the mean of 5 calls, split kernel plus combine; the median of 3 such
windows) at each candidate number of splits (pps = ceil(columns /
splits)), with plan_splits' choice marked.  Writes
chiprun_out/paged_profile.json.  Needs one H100 and the CUDA toolkit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
import chip_smoke  # noqa: E402

SPLITS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128)
WINDOWS = 3  # profiled windows of 5 calls each; the median window is kept


def device_ms(torch, fn):
    """(split kernel, combine) device ms of one call, the mean of 5 in one
    profiled window."""
    k = chip_smoke.profile_step(torch, lambda: [fn() for _ in range(5)], quiet=True)["kernels"]
    return (sum(v for n, v in k.items() if "paged_split" in n) / 5,
            sum(v for n, v in k.items() if "paged_combine" in n) / 5)


def main() -> int:
    import numpy as np
    import torch
    from repro_torch.kernels.paged_attention import ops

    if not torch.cuda.is_available():
        print("paged_profile: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}", flush=True)
    out = []
    for case, lens, cols, heads in chip_smoke.PAGED_CASES:
        for pool in ("bfloat16", "int8"):
            q, kp, vp, ks, vs, bt, ln = chip_smoke.paged_inputs(torch, np, lens, pool,
                                                                cols=cols, heads=heads)
            b, hkv, m = q.shape[0], kp.shape[2], bt.shape[1]
            plan = ops.plan_splits(b, hkv, m)
            plans = {plan}
            for n in SPLITS:
                if n <= m:
                    pps = -(-m // n)
                    plans.add((-(-m // pps), pps))
            for n, pps in sorted(plans):
                runs = sorted((device_ms(torch, lambda: ops.launch(
                    q, kp, vp, bt, ln, ks, vs, None, n, pps)) for _ in range(WINDOWS)),
                    key=sum)
                split, combine = runs[len(runs) // 2]
                out.append(dict(case=case, pool=pool, B=b, cols=m, n_splits=n, pps=pps,
                                blocks=b * hkv * n, planned=(n, pps) == plan,
                                device_ms=split + combine, split_ms=split, combine_ms=combine,
                                windows=[sum(r) for r in runs]))
                print(f"{case:6s} {pool:8s} cols={m:<5d} splits={n:<4d} pps={pps:<4d} blocks="
                      f"{b * hkv * n:<6d} device {split + combine:.4f} ms (split {split:.4f}, "
                      f"combine {combine:.4f}; windows {sum(runs[0]):.4f}-"
                      f"{sum(runs[-1]):.4f}){'  <- plan_splits' if (n, pps) == plan else ''}",
                      flush=True)
            del q, kp, vp, ks, vs
            torch.cuda.empty_cache()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "paged_profile.json"), "w") as f:
        json.dump({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "rows": out}, f,
                  indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
