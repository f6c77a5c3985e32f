#!/usr/bin/env python3
"""The gram tf32x3 kernel's device time at each row-split count, for the
constants of ``ops.plan_splits``.

    python3 tools/gram_profile.py

For the fp32 rows of chip_smoke.py's gram phase (GRAM_SHAPES), the train
path's small-llama taps (2048 rows of 128 and 352) and the fp32 batched
phase's shapes: the device ms of one call (torch.profiler, the mean of 5
calls, the main kernel and its reduce; the median of 3 such windows) at
every split count from 1 to the most that keep MIN_SPLIT_ROWS rows a split
and at most 4 blocks an SM, with plan_splits' choice marked, beside the
fp32 ``matmul`` (TF32 off).  Writes chiprun_out/gram_profile.json.
Needs one H100 and the CUDA toolkit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

WINDOWS = 3  # profiled windows of 5 calls each; the median window is kept
SHAPES = ([(1, r, n) for r, n in chip_smoke.GRAM_SHAPES] + [(1, 2048, 128), (1, 2048, 352)]
          + list(chip_smoke.GRAM_BATCHED_FP32_SHAPES))


def device_ms(torch, fn):
    """(main kernel, reduce) device ms of one call, the mean of 5 in one
    profiled window."""
    k = chip_smoke.profile_step(torch, lambda: [fn() for _ in range(5)], quiet=True,
                                windows=WINDOWS)["kernels"]
    return (sum(v for n, v in k.items() if "gram_tf32x3" in n and "reduce" not in n) / 5,
            sum(v for n, v in k.items() if "gram_tf32x3_reduce" in n) / 5)


def main() -> int:
    sys.path.insert(1, os.path.join(ROOT, "src"))
    import torch
    from repro_torch.kernels.gram import ops

    if not torch.cuda.is_available():
        print("gram_profile: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(2)
    plan_splits, sms = ops.plan_splits, ops.sm_count(torch.device("cuda"))
    out = []
    for e, rows, n in SHAPES:
        x = torch.randn((e, rows, n), generator=gen, device="cuda")
        x[..., ::97] *= 20.0
        x2 = x if e > 1 else x[0]
        tiles = ops.upper_tiles(n) * e
        plan = plan_splits(rows, n, e, sms)
        most = max(1, min(rows // ops.MIN_SPLIT_ROWS, ops.MAX_BLOCKS_PER_SM * sms // tiles))
        lib = chip_smoke.profile_step(torch, lambda: [x2.transpose(-1, -2) @ x2 for _ in range(5)],
                                      quiet=True, windows=WINDOWS)["device_busy_ms"] / 5
        by_split = {}
        for s in sorted(set(range(1, most + 1)) | {plan}):
            ops.plan_splits = lambda *_, s=s: s  # the wrapper launches s splits
            by_split[s] = device_ms(torch, lambda: ops.launch(x2, "tf32x3"))
        ops.plan_splits = plan_splits
        best = min(by_split, key=lambda s: sum(by_split[s]))
        row = dict(E=e, rows=rows, n=n, tiles=tiles, plan=plan, best=best, matmul_ms=lib,
                   ms={s: sum(v) for s, v in by_split.items()},
                   reduce_ms={s: v[1] for s, v in by_split.items()})
        out.append(row)
        print(f"E={e} rows={rows} n={n} tiles={tiles}: plan {plan} "
              f"{sum(by_split[plan]):.4f} ms, best {best} {sum(by_split[best]):.4f} ms, "
              f"fp32 matmul {lib:.4f}; " + " ".join(
                  f"{s}{'*' if s == plan else ''}:{sum(v):.4f}" for s, v in by_split.items()),
              flush=True)
        del x, x2
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "gram_profile.json"), "w") as f:
        json.dump({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "rows": out},
                  f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
