#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts on the GPU.

    python3 chip_smoke.py

Needs one NVIDIA H100 (sm_90a) and the CUDA toolkit.  Phases:
  1. device: nvidia-smi's name and power limit, torch's device name;
  2. build: compiles every kernel of the main path from src/repro_torch/csrc
     (one nvcc per source, in parallel);
  3. kernels: each kernel against its plain PyTorch version at the main
     path's shapes, with the stated tolerance, timed (CUDA events) beside
     the plain version, one PyTorch library call and the bytes/FLOP bound;
  4. main path: ``serve()`` on mistral-7b at full width (depth cut to 2
     layers, random weights from a seed): calibrate, NSVD-compress (nsvd1,
     ratio 0.2, bf16 factors) and serve 8 requests, with the kernels' launch
     counters read around the run; then one decode step's logits through the
     kernels against the same step through the plain versions.
Prints a JSON kernel summary, nvidia-smi's line, and as its last line
{"ok": true, "device": {...}}.  Any failed phase exits non-zero; without a
card (or outside the repository) it exits non-zero before printing results.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")

# H100 SXM published peaks (dense): HBM bytes/s and FLOP/s per input type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}

NESTED_SHAPES = (  # (target, in K, out N, rank) at ratio 0.2 on Mistral-7B
    ("wq", 4096, 4096, 1638),
    ("wk", 4096, 1024, 655),
    ("gate", 4096, 14336, 2548),
    ("down", 14336, 4096, 2548),
)
NESTED_ROWS = (1, 8, 64, 512)
# Max |kernel - plain| / max |plain| allowed.  bf16: the kernel and the plain
# version round the rank-width intermediate and the output to bf16 at the
# same points but sum in different orders (a few bf16 ulps of the output);
# fp32: summation order only.
NESTED_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
PAGED_TOL = 2e-2   # bf16 output; int8 pages dequantized in fp32 vs bf16
STEP_LOGIT_TOL = 5e-2  # 2-layer model: kernel vs plain rounding through a step


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median CUDA-event milliseconds of ``fn()`` over ``reps`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nested_phase(torch, ops, ref):
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
        for target, k_in, n, r in NESTED_SHAPES:
            k1 = int(round(0.95 * r))
            k2 = r - k1

            def mk(*shape, s):
                return (torch.randn(shape, generator=gen, device="cuda") * s).to(dt)
            u, u2 = mk(k_in, k1, s=k_in ** -0.5), mk(k_in, k2, s=k_in ** -0.5)
            v, v2 = mk(k1, n, s=r ** -0.5), mk(k2, n, s=r ** -0.5)
            big_u, big_v = torch.cat([u, u2], 1), torch.cat([v, v2], 0)
            for m in NESTED_ROWS:
                x = mk(m, k_in, s=1.0)
                got = ops.nested_lowrank_matmul(x, u, v, u2, v2)
                want = ref.nested_lowrank_matmul_ref(x, u, v, u2, v2)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                scale = float(want.float().abs().max())
                ok = bool(torch.isfinite(got).all()) and err <= NESTED_TOL[dname] * scale
                ms = time_ms(lambda: ops.nested_lowrank_matmul(x, u, v, u2, v2))
                plain = time_ms(lambda: ref.nested_lowrank_matmul_ref(x, u, v, u2, v2))
                lib = time_ms(lambda: torch.linalg.multi_dot([x, big_u, big_v]))
                el = x.element_size()
                nbytes = el * (x.numel() + u.numel() + v.numel() + u2.numel()
                               + v2.numel() + m * n)
                flops = 2 * m * (k_in * r + r * n)
                b, by = bound_ms(nbytes, flops, dname)
                row = dict(kernel="nested_lowrank", target=target, dtype=dname,
                           M=m, K=k_in, N=n, rank=r, k1=k1, k2=k2,
                           max_abs_err=err, ref_max_abs=scale,
                           tol=NESTED_TOL[dname] * scale, ok=ok, ms=ms,
                           plain_ms=plain, library_ms=lib, bytes=nbytes,
                           flops=flops, bound_ms=b, bound_by=by)
                rows.append(row)
                log(f"nested {dname:8s} {target:4s} M={m:<3d} err={err:.3e} "
                    f"(tol {row['tol']:.3e}) {'OK' if ok else 'FAIL'}  "
                    f"kernel {ms:.3f} ms  plain {plain:.3f} ms  library "
                    f"{lib:.3f} ms  bound {b:.3f} ms ({by}, {nbytes / 1e6:.1f} MB)")
    return rows


def paged_phase(torch, ops, ref):
    import numpy as np

    rows = []
    b, hq, hkv, hd, bs = 8, 32, 8, 128, 16
    # Page-edge lengths up to 700, and one dead row (all -1, length 0).
    lens = np.asarray([1, 15, 16, 17, 255, 256, 700, 0], np.int32)
    pages = [-(-int(n) // bs) for n in lens]
    m = max(pages)
    nb = sum(pages) + 8
    perm = np.random.default_rng(0).permutation(nb)
    table = np.full((b, m), -1, np.int32)
    it = iter(perm)
    for r, p in enumerate(pages):
        for j in range(p):
            table[r, j] = next(it)
    bt = torch.as_tensor(table, device="cuda")
    ln = torch.as_tensor(lens, device="cuda")
    live = torch.as_tensor(lens > 0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    q = (torch.randn((b, hq, hd), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
    for pool in ("bfloat16", "int8"):
        if pool == "int8":
            kp = torch.randint(-127, 128, (nb, bs, hkv, hd), generator=gen,
                               device="cuda", dtype=torch.int8)
            vp = torch.randint(-127, 128, (nb, bs, hkv, hd), generator=gen,
                               device="cuda", dtype=torch.int8)
            ks = torch.rand((nb, bs, hkv), generator=gen, device="cuda") * 0.01
            vs = torch.rand((nb, bs, hkv), generator=gen, device="cuda") * 0.01
        else:
            kp = torch.randn((nb, bs, hkv, hd), generator=gen, device="cuda").to(torch.bfloat16)
            vp = torch.randn((nb, bs, hkv, hd), generator=gen, device="cuda").to(torch.bfloat16)
            ks = vs = None
        got = ops.paged_attention(q, kp, vp, bt, ln, ks, vs)
        want = ref.paged_attention_ref(q, kp, vp, bt, ln, ks, vs)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()[live]
        err = float(diff.max())
        scale = float(want.float().abs()[live].max())
        dead_zero = bool((got[~live] == 0).all())
        ok = bool(torch.isfinite(got).all()) and err <= PAGED_TOL * scale and dead_zero
        ms = time_ms(lambda: ops.paged_attention(q, kp, vp, bt, ln, ks, vs), reps=20)
        plain = time_ms(lambda: ref.paged_attention_ref(q, kp, vp, bt, ln, ks, vs))
        # Library yardstick: SDPA over the pages gathered (outside the timing)
        # into a padded (B, Hq, T, hd) view with a length mask.
        kg = ref.gather_pages(kp, bt)
        vg = ref.gather_pages(vp, bt)
        if ks is not None:
            kg = kg.float() * ref.gather_pages(ks, bt)[..., None]
            vg = vg.float() * ref.gather_pages(vs, bt)[..., None]
        g = hq // hkv
        kg = kg.to(torch.bfloat16).transpose(1, 2).repeat_interleave(g, 1).contiguous()
        vg = vg.to(torch.bfloat16).transpose(1, 2).repeat_interleave(g, 1).contiguous()
        t = kg.shape[2]
        mask = (torch.arange(t, device="cuda")[None, :] < ln[:, None].clamp(min=1))
        mask = mask[:, None, None, :]
        q4 = q[:, :, None, :]
        lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, kg, vg, attn_mask=mask), reps=20)
        el = kp.element_size()
        tokens = int(lens.sum())
        nbytes = (2 * q.numel() * q.element_size() + 2 * tokens * hkv * hd * el
                  + (2 * tokens * hkv * 4 if ks is not None else 0)
                  + table.nbytes + lens.nbytes)
        flops = 4 * hq * hd * tokens
        bnd, by = bound_ms(nbytes, flops, "bfloat16")
        row = dict(kernel="paged_attention", pool=pool, B=b, Hq=hq, Hkv=hkv,
                   hd=hd, bs=bs, lengths=lens.tolist(), max_abs_err=err,
                   ref_max_abs=scale, tol=PAGED_TOL * scale, dead_row_zero=dead_zero,
                   ok=ok, ms=ms, plain_ms=plain, library_ms=lib, bytes=nbytes,
                   flops=flops, bound_ms=bnd, bound_by=by)
        rows.append(row)
        log(f"paged  pool={pool:8s} err={err:.3e} (tol {row['tol']:.3e}) "
            f"dead-row zeros={dead_zero} {'OK' if ok else 'FAIL'}  kernel "
            f"{ms:.4f} ms  plain {plain:.4f} ms  library(sdpa) {lib:.4f} ms  "
            f"bound {bnd:.4f} ms ({by}, {nbytes / 1e6:.2f} MB)")
    return rows


def profile_step(torch, fn) -> dict:
    """Device time by kernel name and device busy share of one call of
    ``fn`` (after a warm-up call), from torch.profiler's CUDA trace."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()  # the step's wall time, profiler off
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    per = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            per[ev.key] = (per.get(ev.key, (0.0, 0))[0] + dev_us / 1e3, ev.count)
    busy = sum(ms for ms, _ in per.values())
    top = sorted(per.items(), key=lambda kv: -kv[1][0])[:12]
    log(f"  profiled decode step: wall {wall_ms:.2f} ms (profiler off), device "
        f"busy {busy:.3f} ms ({busy / wall_ms:.1%} of wall)")
    for name, (ms, n) in top:
        log(f"    {ms:8.3f} ms  x{n:<4d} {name[:90]}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "top": [{"name": k, "ms": ms, "count": n} for k, (ms, n) in top]}


def main_path(torch, np):
    from repro_torch import kernels
    from repro_torch.configs import MISTRAL_7B
    from repro_torch.kernels.nested_lowrank import ops as nlr
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.launch.serve import serve
    from repro_torch.serving.kvcache import PagedKVCache

    cfg = dataclasses.replace(MISTRAL_7B, num_layers=2)
    rng = np.random.default_rng(0)
    plens = rng.integers(16, 201, size=8)
    prompts = [rng.integers(2, cfg.vocab_size // 2, size=int(n)) for n in plens]
    nlr.launches = 0
    pa.launches = 0
    res = serve(cfg, requests=8, max_new=32, max_batch=8, max_len=256,
                seed=0, compress=0.2, block_size=16, prefill_chunk=64,
                prompts=prompts)
    counts = {"nested_lowrank": nlr.launches, "paged_attention": pa.launches}
    eng, model, params = res["engine"], res["model"], res["params"]
    st = eng.stats()
    n_linear = len(model.compressible_targets()) * cfg.num_layers
    expect = {"nested_lowrank": n_linear * (st["steps"] + st["prefill_ticks"]),
              "paged_attention": cfg.num_layers * st["steps"]}
    reasons = {u: r.finish_reason for u, r in res["requests"].items()}
    outs = res["outputs"]
    ok = (len(outs) == 8 and all(reasons.get(u) for u in outs)
          and all(1 <= len(v) <= 32 for v in outs.values())
          and all(0 <= t < cfg.vocab_size for v in outs.values() for t in v)
          and all(counts[k] == expect[k] > 0 for k in counts))
    log(f"main path: {cfg.name} d_model={cfg.d_model} heads={cfg.num_heads}/"
        f"{cfg.num_kv_heads} hd={cfg.head_dim} d_ff={cfg.d_ff} vocab="
        f"{cfg.vocab_size} layers={cfg.num_layers} (depth cut from 32)")
    log(f"  prompt lengths {plens.tolist()}; plan achieved ratio "
        f"{res['plan'].achieved_ratio:.4f}")
    log("  phase seconds: " + ", ".join(f"{k}={v:.2f}" for k, v in res["seconds"].items()))
    log(f"  {res['tokens']} tokens in {res['seconds']['serve']:.2f} s = "
        f"{res['tok_per_s']:.1f} tok/s; decode steps {st['steps']}, prefill "
        f"chunks {st['prefill_ticks']}, host syncs {st['host_syncs']}, step p50 "
        f"{st['step_p50_s'] * 1e3:.2f} ms")
    log(f"  launches {counts} expected {expect}; finish reasons {sorted(set(reasons.values()))}")

    # One decode step with the kernels vs the same step through the plain
    # versions, on a cache prefilled with the first 15 tokens of each prompt.
    kv = PagedKVCache(model, 8, 256, block_size=16, device="cuda")
    for slot in range(8):
        kv.reserve(slot, 65)
    bt = kv.table_device()
    toks = torch.as_tensor(np.stack([p[:15] for p in prompts]), device="cuda")
    zero = torch.zeros(8, dtype=torch.int32, device="cuda")
    with torch.no_grad():
        model.apply(params, toks, mode="decode", cache=kv.pools, cache_len=zero,
                    block_tables=bt)
        clen = torch.full((8,), 15, dtype=torch.int32, device="cuda")
        nxt = torch.as_tensor([[int(p[15])] for p in prompts], device="cuda")

        def clone(tree):
            return {k: clone(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.clone()
        saved = clone(kv.pools)
        lk = model.apply(params, nxt, mode="decode", cache=kv.pools, cache_len=clen,
                         block_tables=bt).float()
        with kernels.plain():
            lp = model.apply(params, nxt, mode="decode", cache=saved,
                             cache_len=clen, block_tables=bt).float()
        try:  # measurement only: a profiler fault must not fail the smoke
            prof = profile_step(torch, lambda: model.apply(
                params, nxt, mode="decode", cache=clone(saved), cache_len=clen,
                block_tables=bt))
        except RuntimeError as e:
            prof = {"error": str(e)[:300]}
            log(f"  profiler unavailable: {prof['error']}")
    torch.cuda.synchronize()
    step_err = float((lk - lp).abs().max())
    step_scale = float(lp.abs().max())
    agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    step_ok = (lk.shape == (8, 1, cfg.vocab_size) and bool(torch.isfinite(lk).all())
               and step_err <= STEP_LOGIT_TOL * step_scale)
    log(f"  decode-step logits kernels vs plain: max abs err {step_err:.4e} "
        f"(max |logit| {step_scale:.3f}, tol {STEP_LOGIT_TOL * step_scale:.4e}), "
        f"argmax agreement {agree:.3f} {'OK' if step_ok else 'FAIL'}")
    summary = dict(config=cfg.name, layers=cfg.num_layers, prompt_lengths=plens.tolist(),
                   seconds=res["seconds"], tokens=res["tokens"],
                   tok_per_s=res["tok_per_s"], engine=st, launches=counts,
                   expected_launches=expect, finish_reasons=reasons,
                   achieved_ratio=res["plan"].achieved_ratio,
                   step_logit_max_abs_err=step_err, step_logit_max_abs=step_scale,
                   step_argmax_agreement=agree, step_profile=prof,
                   ok=bool(ok and step_ok))
    return summary, counts


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch.kernels import build
        from repro_torch.kernels.nested_lowrank import ops as nlr_ops, ref as nlr_ref
        from repro_torch.kernels.paged_attention import ops as pa_ops, ref as pa_ref
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})", file=sys.stderr)
        return 2
    import logging

    logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                        format="  %(name)s: %(message)s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: no output"
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda}); "
        f"nvidia-smi: {smi_line}")

    t0 = time.perf_counter()
    build_s = build.build_all()
    log(f"build: {build_s:.1f} s for {list(build.SOURCES)} (wall {time.perf_counter() - t0:.1f} s)")
    for name, text in build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas[{name}]: {line.strip()}")

    nested = nested_phase(torch, nlr_ops, nlr_ref)
    paged = paged_phase(torch, pa_ops, pa_ref)
    kernels_ok = all(r["ok"] for r in nested + paged)
    summary, counts = main_path(torch, np)

    # One entry per kernel at the main path's decode shape: the gate
    # projection (largest factor bytes) at 8 live rows in bf16, and the bf16
    # page pools.
    nrow = next(r for r in nested if r["dtype"] == "bfloat16"
                and r["target"] == "gate" and r["M"] == 8)
    prow = next(r for r in paged if r["pool"] == "bfloat16")
    entries = []
    for row, src, replaces in (
        (nrow, "src/repro_torch/csrc/nested_lowrank.cu",
         "src/repro/kernels/nested_lowrank/nested_lowrank.py:84"),
        (prow, "src/repro_torch/csrc/paged_attention.cu",
         "src/repro/kernels/paged_attention/paged_attention.py:243"),
    ):
        entries.append({"name": row["kernel"], "route": "cuda", "source": src,
                        "replaces": replaces, "launches": counts[row["kernel"]],
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"device": kind, "nvidia_smi": smi_line, "build_s": build_s,
                   "nested": nested, "paged": paged, "main_path": summary,
                   "kernels": entries}, f, indent=1)
    ok = kernels_ok and summary["ok"]
    if not ok:
        log(f"chip_smoke: FAILED (kernels ok={kernels_ok}, main path ok={summary['ok']})")
        return 1
    print(json.dumps({"kernels": entries}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
