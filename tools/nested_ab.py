#!/usr/bin/env python3
"""One phase of chip_smoke.py on two trees of this repository, on one card,
in turns: the other tree, this one, this one, the other.

    python3 tools/nested_ab.py OTHER_ROOT [nested|gram|paged|rwkv6|flash_bwd|admit|calibrate]

OTHER_ROOT is another checkout (for example the parent commit, unpacked with
``git archive`` into a directory that .gitignore lists).  Each run is a
process of its own that builds that tree's kernels.  Phases:

  nested     that tree's ``chip_smoke.nested_phase``: each row's profiled
             device ms, for every (dtype, target, rows) both trees measure;
  gram       that tree's ``gram_accumulate`` at this tree's gram shapes
             (bf16 and fp32, chip_smoke's inputs), device ms of one call
             from torch.profiler (the mean of 5), and whether it is within
             GRAM_TOL of the plain version;
  paged      that tree's ``paged_attention`` at this tree's paged cases
             (chip_smoke's PAGED_CASES and inputs, bf16 and int8 pools),
             device ms of one call from torch.profiler (the mean of 5,
             every kernel the call launches), and whether it is within
             PAGED_TOL of the plain version on live rows;
  rwkv6      that tree's ``rwkv6_attention`` at this tree's RWKV_SHAPES
             (chip_smoke's inputs; the final state where the phase asks
             for it, at prefill), device ms of one call from torch.profiler
             (the mean of 5), and whether y and the state are within
             RWKV_TOL and RWKV_STATE_TOL of the plain version;
  flash_bwd  that tree's flash-attention backward (``ops.backward``) at this
             tree's FLASH_BWD_SHAPES (chip_smoke's inputs: the plain
             forward's out and lse, a random dO), device ms of one call
             from torch.profiler (the mean of 5, its three kernels), which
             kernels ran (a tree without the split counters: cuda_core), and
             whether dq, dk, dv are within FLASH_BWD_ELEM_TOL of the plain
             backward;
  admit      that tree's dense-slab admission on chip_smoke's spec_serve
             S3 (Mistral-7B width, 2 layers, bf16, *Serve*'s 8 prompts,
             target nsvd1 0.2 and draft 0.6 from one calibration, k 4,
             ``paged=False``, max_batch 8, max_len 256, depth 2): over
             ADMIT_REPS fresh engines each, one admission round's device
             ms (torch.profiler, every kernel of the target's and the
             draft's prefill calls), its wall ms, and TTFT (submit to first
             token, mean and max over the 8 requests, the engine's own
             stamps with telemetry on) of a whole run; the
             admission calls and their nested launches by kernel;
  calibrate  that tree's whole ``chip_smoke.py``: the calibrate seconds of
             its four paths (and each path's seconds), from the
             chiprun_out/chip_smoke.json it writes.

Prints each row's four readings and the ratio of this tree's mean to the
other's, and writes chiprun_out/<phase>_ab.json.  Needs one H100 and the
CUDA toolkit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

RUN_NESTED = """
import json, sys, torch
sys.path[:0] = [{root!r}, {src!r}]
import chip_smoke
from repro_torch.kernels.nested_lowrank import ops, ref
torch.backends.cuda.matmul.allow_tf32 = False
rows = chip_smoke.nested_phase(torch, ops, ref)
print("RESULT " + json.dumps([dict(key=[r["dtype"], r["target"], r["M"]], value=r["device_ms"],
                                   ran=r["ran"], ok=r["ok"]) for r in rows]), flush=True)
"""
RUN_GRAM = """
import json, sys, torch
sys.path[:0] = [{root!r}, {src!r}]
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from repro_torch.kernels.gram import ops, ref
torch.backends.cuda.matmul.allow_tf32 = False

def device_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / reps

out = []
gen = torch.Generator(device="cuda").manual_seed(2)
for dname in ("bfloat16", "float32"):
    for rows, n in {shapes!r}:
        x = torch.randn((rows, n), generator=gen, device="cuda")
        x[:, ::97] *= 20.0
        x = x.to(getattr(torch, dname))
        before = {{k: getattr(ops, k + "_launches", 0) for k in ("mma", "tf32x3", "fma")}}
        g, _ = ops.gram_accumulate(x)
        w, _ = ref.gram_accumulate_ref(x)
        ok = bool((g - w).abs().max() <= {tol!r} * w.abs().max())
        ran = next(k for k, v in before.items() if getattr(ops, k + "_launches", 0) > v)
        del g, w
        out.append(dict(key=[dname, rows, n], value=device_ms(lambda: ops.gram_accumulate(x)),
                        ran=ran, ok=ok))
print("RESULT " + json.dumps(out), flush=True)
"""
RUN_PAGED = """
import json, sys, numpy as np, torch
sys.path[:0] = [{src!r}, {this!r}]
import chip_smoke
from repro_torch.kernels.paged_attention import ops, ref
out = []
for case, lens, cols, heads in chip_smoke.PAGED_CASES:
    for pool in ("bfloat16", "int8"):
        q, kp, vp, ks, vs, bt, ln = chip_smoke.paged_inputs(torch, np, lens, pool,
                                                            cols=cols, heads=heads)
        live = ln > 0
        got = ops.paged_attention(q, kp, vp, bt, ln, ks, vs)[live].float()
        want = ref.paged_attention_ref(q, kp, vp, bt, ln, ks, vs)[live].float()
        ok = bool((got - want).abs().max() <= chip_smoke.PAGED_TOL * want.abs().max())
        dev = chip_smoke.profile_step(torch, lambda: [ops.paged_attention(
            q, kp, vp, bt, ln, ks, vs) for _ in range(5)], quiet=True)["device_busy_ms"] / 5
        out.append(dict(key=[case, pool], value=dev, ran="", ok=ok))
        del q, kp, vp, ks, vs, got, want
        torch.cuda.empty_cache()
print("RESULT " + json.dumps(out), flush=True)
"""
RUN_RWKV = """
import json, sys, torch
sys.path[:0] = [{src!r}, {this!r}]
import chip_smoke
from repro_torch.kernels.rwkv6 import ops, ref
out = []
gen = torch.Generator(device="cuda").manual_seed(4)
for case, bh, t, k, dname, w_fixed in chip_smoke.RWKV_SHAPES:
    args = chip_smoke.rwkv6_inputs(torch, gen, bh, t, k, dname, w_fixed)
    got, got_s = ops.rwkv6_attention(*args, return_state=True)
    want, want_s = ref.rwkv6_scan_ref(*args, return_state=True)
    ok = bool((got.float() - want.float()).abs().max()
              <= chip_smoke.RWKV_TOL[dname] * want.float().abs().max()
              and (got_s - want_s).abs().max() <= chip_smoke.RWKV_STATE_TOL * want_s.abs().max())
    del got, want, got_s, want_s
    with_state = case == "prefill"
    dev = chip_smoke.profile_step(torch, lambda: [ops.rwkv6_attention(
        *args, return_state=with_state) for _ in range(5)], quiet=True)["device_busy_ms"] / 5
    out.append(dict(key=[case, dname], value=dev, ran="", ok=ok))
    del args
    torch.cuda.empty_cache()
print("RESULT " + json.dumps(out), flush=True)
"""
RUN_FLASH_BWD = """
import json, sys, torch
sys.path[:0] = [{src!r}, {this!r}]
import chip_smoke
from repro_torch.kernels.flash_attention import ops, ref
out = []
gen = torch.Generator(device="cuda").manual_seed(5)
for dname, b, s, hq, hkv, hd in chip_smoke.FLASH_BWD_SHAPES:
    dt = getattr(torch, dname)
    mk = lambda h: torch.randn((b, s, h, hd), generator=gen, device="cuda").to(dt)
    q, k, v, dout = mk(hq), mk(hkv), mk(hkv), mk(hq)
    o, lse = ref.flash_attention_fwd_ref(q, k, v)
    tc = lambda: getattr(ops, "backward_tensor_core_launches", 0)
    before = tc()
    got = ops.backward(q, k, v, o, lse, dout)
    ran = "tensor_core" if tc() > before else "cuda_core"
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, dout)
    ok = max(chip_smoke.bwd_elem_err(torch, x, w) for x, w in zip(got, want)) <= (
        chip_smoke.FLASH_BWD_ELEM_TOL[dname])
    del got, want
    calls = lambda: [ops.backward(q, k, v, o, lse, dout) for _ in range(5)]
    dev = chip_smoke.profile_step(torch, calls, quiet=True)["device_busy_ms"] / 5
    out.append(dict(key=[dname, b, s, hq, hkv, hd], value=dev, ran=ran, ok=bool(ok)))
    del q, k, v, dout, o, lse
    torch.cuda.empty_cache()
print("RESULT " + json.dumps(out), flush=True)
"""
RUN_ADMIT = """
import dataclasses, json, statistics, sys, time, numpy as np, torch
sys.path[:0] = [{src!r}, {this!r}]
import chip_smoke
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from repro_torch.configs import MISTRAL_7B
from repro_torch.kernels import build
from repro_torch.kernels.nested_lowrank import ops as nlr
from repro_torch.launch.serve import serve
from repro_torch.obs import Telemetry
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.spec import SpecConfig
build.build_all(("nested_lowrank", "gram", "flash_attention"))
cfg = dataclasses.replace(MISTRAL_7B, num_layers=2)
rng = np.random.default_rng(0)
plens = rng.integers(16, 201, size=8)
prompts = [rng.integers(2, cfg.vocab_size // 2, size=int(n)) for n in plens]
res = serve(cfg, requests=8, max_new=32, max_batch=8, max_len=256, seed=0, compress=0.2,
            block_size=16, prefill_chunk=64, prompts=prompts, device="cuda",
            pipeline_depth=2, spec_ratio=0.6, spec_k=4, paged=False)
model, params, draft = res["model"], res["params"], res["engine"].draft.params

def engine(telemetry=None):
    eng = ServingEngine(model, params, max_batch=8, max_len=256, seed=0, block_size=16,
                        prefill_chunk=64, paged=False, pipeline_depth=2,
                        spec_config=SpecConfig(draft, k=4), telemetry=telemetry)
    for p in prompts:
        eng.submit(p, max_new_tokens=32)
    torch.cuda.synchronize()
    return eng

dev, wall, ttft_mean, ttft_max = [], [], [], []
for rep in range({reps} + 1):
    eng = engine(Telemetry())  # stamps submit and first-token times
    eng.run()
    torch.cuda.synchronize()
    ttft = [(r.t_first - r.t_submit) * 1e3 for r in eng.finished_requests.values()]
    eng.close()
    eng = engine()
    before = (nlr.stream_launches, nlr.mma_launches, nlr.tile_launches)
    t0 = time.perf_counter()
    eng._admit_dense()
    torch.cuda.synchronize()
    w = (time.perf_counter() - t0) * 1e3
    launches = [a - b for a, b in zip((nlr.stream_launches, nlr.mma_launches,
                                       nlr.tile_launches), before)]
    calls = eng.stats()["prefill_ticks"]
    eng.close()
    eng = engine()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng._admit_dense()
        torch.cuda.synchronize()
    eng.close()
    d = sum(e.self_device_time_total for e in prof.key_averages()
            if chip_smoke.device_work(e, DeviceType.CUDA)) / 1e3
    if rep:  # the first round warms up
        dev.append(d); wall.append(w)
        ttft_mean.append(statistics.mean(ttft)); ttft_max.append(max(ttft))
ran = f"calls={{calls}} nested(stream,mma,tile)={{launches}}"
out = [dict(key=["admit_device_ms"], value=statistics.median(dev), ran=ran, ok=True),
       dict(key=["admit_wall_ms"], value=statistics.median(wall), ran=ran, ok=True),
       dict(key=["ttft_mean_ms"], value=statistics.median(ttft_mean), ran=ran, ok=True),
       dict(key=["ttft_max_ms"], value=statistics.median(ttft_max), ran=ran, ok=True)]
print("RESULT " + json.dumps(out), flush=True)
"""
ADMIT_REPS = 5
PATHS = ("serve", "quality", "rwkv_serve", "rwkv_quality")


def run_script(root: str, phase: str) -> list:
    """[{key, value, ran, ok}] of ``phase`` on the tree at ``root``."""
    if phase == "calibrate":
        p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=root, capture_output=True,
                           text=True, timeout=1500)
        with open(os.path.join(root, "chiprun_out", "chip_smoke.json")) as f:
            res = json.load(f)
        out = []
        for path in PATHS:
            summary = res[f"{path}_path"]
            seconds = summary["seconds"] if "seconds" in summary else summary["entry"]["seconds"]
            out.append(dict(key=[path, "calibrate_s"], value=seconds["calibrate"], ran="",
                            ok=p.returncode == 0))
            out.append(dict(key=[path, "path_s"], value=res["path_seconds"][path], ran="",
                            ok=p.returncode == 0))
        return out
    template = {"nested": RUN_NESTED, "gram": RUN_GRAM, "paged": RUN_PAGED,
                "rwkv6": RUN_RWKV, "flash_bwd": RUN_FLASH_BWD, "admit": RUN_ADMIT}[phase]
    code = template.format(root=root, src=os.path.join(root, "src"), this=ROOT,
                           shapes=list(chip_smoke.GRAM_SHAPES), tol=chip_smoke.GRAM_TOL,
                           reps=ADMIT_REPS)
    p = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                       timeout=900)
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("RESULT ")]
    if p.returncode or not lines:
        raise RuntimeError(f"{root}: exit {p.returncode}\n{p.stdout[-2000:]}{p.stderr[-2000:]}")
    return json.loads(lines[-1][len("RESULT "):])


def main() -> int:
    if len(sys.argv) not in (2, 3) or (sys.argv[2:] and sys.argv[2] not in
                                       ("nested", "gram", "paged", "rwkv6",
                                        "flash_bwd", "admit", "calibrate")):
        print(__doc__, file=sys.stderr)
        return 2
    other = os.path.abspath(sys.argv[1])
    phase = sys.argv[2] if len(sys.argv) == 3 else "nested"
    order = (("other", other), ("this", ROOT), ("this", ROOT), ("other", other))
    runs = [(name, run_script(root, phase)) for name, root in order]
    table = {}
    for i, (name, rows) in enumerate(runs):
        for r in rows:
            table.setdefault(tuple(r["key"]), {}).setdefault(name, []).append(
                dict(run=i, value=r["value"], ran=r["ran"], ok=r["ok"]))
    out = []
    for k, by in table.items():
        if set(by) != {"other", "this"}:
            continue
        mean = {n: sum(x["value"] for x in v) / len(v) for n, v in by.items()}
        ratio = mean["this"] / mean["other"] if mean["other"] else float("nan")
        out.append(dict(key=list(k), other=by["other"], this=by["this"], ratio=ratio))
        print(" ".join(str(x) for x in k) + f"  other {by['other'][0]['ran']} "
              + " ".join(f"{x['value']:.4f}" for x in by["other"])
              + f"  this {by['this'][0]['ran']} "
              + " ".join(f"{x['value']:.4f}" for x in by["this"])
              + f"  this/other {ratio:.3f}", flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", f"{phase}_ab.json"), "w") as f:
        json.dump({"other": other, "phase": phase, "rows": out,
                   "ok": all(x["ok"] for _, rows in runs for x in rows)}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
