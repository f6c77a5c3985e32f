#!/usr/bin/env python3
"""Where a nested_lowrank call's device time goes, at chip_smoke.py's
Mistral-7B shapes in bf16 with 1, 8 and 16 rows (the stream kernel) and 64
and 512 rows (the mma kernel).

    python3 tools/nested_profile.py

Needs one H100 and the CUDA toolkit.  For each shape and row count: the
device time of phase 1 (t = x @ [u|u2]), phase 2 (y = t @ [v;v2]) and the
two split-K reductions, from torch.profiler, averaged over 10 calls with the
L2 cache flushed before each (a decode step reads each factor once, after
other layers' factors have evicted it) and without the flush; ``multi_dot``
on the concatenated factors under the same flush; and the wrapper's host
time per call (100 calls enqueued back to back).  Then every chunk depth of
each phase at the gate and down shapes (8, 64 and 512 rows) and the gate
shape (16 rows), the other phase at its planned chunk: how far
``ops.plan``'s chunk is from the fastest.  Prints one line per measurement
and writes chiprun_out/nested_profile.json.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))
import chip_smoke  # noqa: E402

REPS = 10
ROWS = (1, 8, 16, 64, 512)
FLUSH_BYTES = 160 * 2 ** 20  # past the H100's 50 MB L2
SWEEP_CHUNKS = {"stream": (64, 128, 192, 256, 320, 384, 512),
                "mma": (256, 384, 512, 768, 1024, 1536, 2048, 4096)}
SWEPT = ((8, "gate"), (8, "down"), (16, "gate"), (64, "gate"), (64, "down"), (512, "gate"),
         (512, "down"))
KERNELS = ("stream_partial", "mma_partial")


def device_ms(torch, fn, flush) -> dict:
    """Mean device ms per call of ``fn`` by part (p1, p2, reduce, other)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            if flush is not None:
                flush.zero_()
            fn()
        torch.cuda.synchronize()
    parts = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or ev.self_device_time_total <= 0:
            continue
        if any(k in ev.key for k in KERNELS):
            part = "p1" if "true>" in ev.key else "p2"
        elif "reduce_partials" in ev.key:
            part = "reduce"
        elif flush is not None and "elementwise" in ev.key:
            continue  # the flush
        else:
            part = "other"
        parts[part] = parts.get(part, 0.0) + ev.self_device_time_total / 1e3 / REPS
    parts["total"] = sum(parts.values())
    return parts


def host_us(torch, fn, n: int = 100) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def main() -> int:
    import torch

    from repro_torch.kernels.nested_lowrank import ops

    if not torch.cuda.is_available():
        print("nested_profile: needs a CUDA device", file=sys.stderr)
        return 2
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def mk(*shape, s):
        return (torch.randn(shape, generator=gen, device="cuda") * s).to(torch.bfloat16)

    out = {"device": torch.cuda.get_device_name(0), "rows": [], "sweep": []}
    planned = ops.plan
    for target, k_in, n, r in chip_smoke.NESTED_SHAPES:
        k1 = int(round(0.95 * r))
        k2 = r - k1
        u, u2 = mk(k_in, k1, s=k_in ** -0.5), mk(k_in, k2, s=k_in ** -0.5)
        v, v2 = mk(k1, n, s=r ** -0.5), mk(k2, n, s=r ** -0.5)
        big_u, big_v = torch.cat([u, u2], 1), torch.cat([v, v2], 0)
        for m in ROWS:
            x = mk(m, k_in, s=1.0)
            p = planned(m, torch.bfloat16, k_in, n, k1, k2, True)

            def call():
                return ops.nested_lowrank_matmul(x, u, v, u2, v2)
            row = dict(target=target, M=m, plan=p._asdict(), cold=device_ms(torch, call, flush),
                       warm=device_ms(torch, call, None),
                       multi_dot_cold=device_ms(
                           torch, lambda: torch.linalg.multi_dot([x, big_u, big_v]),
                           flush)["total"],
                       host_us=host_us(torch, call))
            out["rows"].append(row)
            c = row["cold"]
            print(f"{target:4s} M={m:<2d} {p.kernel} cold {c['total'] * 1e3:6.1f} us (phase 1 "
                  f"{c.get('p1', 0) * 1e3:5.1f}, phase 2 {c.get('p2', 0) * 1e3:5.1f}, reduce "
                  f"{c.get('reduce', 0) * 1e3:4.1f})  warm {row['warm']['total'] * 1e3:6.1f} us  "
                  f"multi_dot cold {row['multi_dot_cold'] * 1e3:6.1f} us  host "
                  f"{row['host_us']:5.1f} us/call  plan s1={p.s1} c1={p.c1} s2={p.s2} c2={p.c2}",
                  flush=True)
            if (m, target) not in SWEPT:
                continue
            for phase in (1, 2):
                for c in SWEEP_CHUNKS[p.kernel]:
                    if phase == 1:
                        q = ops.Plan(p.kernel, -(-k_in // c), c, p.s2, p.c2)
                    else:
                        q = ops.Plan(p.kernel, p.s1, p.c1, -(-k1 // c) + -(-k2 // c), c)
                    ops.plan = lambda *a, q=q: q
                    try:
                        t = device_ms(torch, call, flush)
                    finally:
                        ops.plan = planned
                    out["sweep"].append(dict(target=target, M=m, phase=phase, chunk=c, **t))
                    print(f"  sweep {target} M={m} phase {phase} chunk {c:3d}: total "
                          f"{t['total'] * 1e3:6.1f} us (phase 1 {t.get('p1', 0) * 1e3:5.1f}, "
                          f"phase 2 {t.get('p2', 0) * 1e3:5.1f}, reduce "
                          f"{t.get('reduce', 0) * 1e3:4.1f})", flush=True)
    os.makedirs(chip_smoke.OUT_DIR, exist_ok=True)
    with open(os.path.join(chip_smoke.OUT_DIR, "nested_profile.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
