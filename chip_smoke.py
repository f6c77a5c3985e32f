#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts on the GPU.

    python3 chip_smoke.py

Needs one NVIDIA H100 (sm_90a) and the CUDA toolkit.  Phases:
  1. device: nvidia-smi's name and power limit, torch's device name;
  2. build: compiles every kernel of the main paths from src/repro_torch/csrc
     (one nvcc per source, in parallel);
  3. kernels: each kernel against its plain PyTorch version at the main
     paths' shapes, with the stated tolerance, timed (CUDA events) beside
     the plain version, one PyTorch library call and the bytes/FLOP bound;
  4. serve path: ``serve()`` on mistral-7b at full width (depth cut to 2
     layers, random weights from a seed): calibrate, NSVD-compress (nsvd1,
     ratio 0.2, bf16 factors) and serve 8 requests, with the kernels' launch
     counters read around the run; then one decode step's logits through the
     kernels against the same step through the plain versions;
  5. quality path: ``obs.quality_report.build_entry`` on the same model:
     calibrate (gram kernel), compress with telemetry, evaluate dense vs
     compressed perplexity on five domains at (4, 2048) tokens a batch
     (flash_attention kernel), logit KL, per-target attribution, activation
     similarity; launch counts read around it, and one eval batch's logits
     through the kernels against the plain versions;
  6. RWKV-6 serve path: ``serve()`` on rwkv6-1.6b at full width (depth cut to
     4 layers, random weights from a seed) on the dense recurrent-state slab:
     calibrate (gram, rwkv6), compress, serve the same 8 requests (each
     admission one exact-length prefill through rwkv6; decode through
     nested_lowrank), launch counts read around it; then one dense decode
     step's logits through the kernels against the plain versions;
  7. RWKV-6 quality path: ``build_entry`` on the same model, one (4, 2048)
     eval batch per domain, every causal forward through rwkv6.
Prints a JSON kernel summary, nvidia-smi's line, and as its last line
{"ok": true, "device": {...}}.  Any failed phase exits non-zero; without a
card (or outside the repository) it exits non-zero before printing results.
"""

from __future__ import annotations

import dataclasses
import importlib
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
GRAM_SHAPES = ((2048, 4096), (2048, 14336))  # (rows, n): d_model and d_ff taps
# Max |kernel - plain| / max |plain|, for G and for sum |x|: both sum the
# same exact products (bf16 x bf16 is exact in fp32) in another order.
GRAM_TOL = 1e-5
# (B, S, Hq, Hkv): calibration and evaluation batches at Mistral-7B's heads,
# a ragged S, and G = 1.
FLASH_SHAPES = ((16, 128, 32, 8), (4, 2048, 32, 8), (4, 1000, 32, 8), (4, 1000, 8, 8))
# bf16: P is rounded to bf16 before P V unnormalized (kernel) vs normalized
# (plain), and outputs round to bf16; fp32: sum order only.
FLASH_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
EVAL_LOGIT_TOL = 5e-2  # 2-layer bf16 model: flash vs naive rounding, one batch
# (case, BH, T, K, dtype, fixed w): an rwkv6-1.6b eval batch (4 x 32 heads,
# 2048 tokens), one request's prefill (32 heads, ragged 200 tokens, with its
# final state), a calibration batch (16 x 32 heads, 128 tokens), extreme
# decay, and the eval batch in bf16.
RWKV_SHAPES = (("eval", 128, 2048, 64, "float32", None),
               ("prefill", 32, 200, 64, "float32", None),
               ("calib", 512, 128, 64, "float32", None),
               ("extreme", 32, 200, 64, "float32", 1e-6),
               ("eval", 128, 2048, 64, "bfloat16", None))
# Max |kernel - plain| / max |plain| for y and for the fp32 final state.
# fp32: the chunked form (exp of cumulated log-decays) vs the sequential
# scan's running products, summed in another order.  bf16: inputs widen
# exactly and both sides compute in fp32, then each rounds y to bf16 on its
# own: one bf16 ulp (2^-8) of the output; the state keeps the fp32 bound.
RWKV_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
RWKV_STATE_TOL = 1e-4


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


def gram_phase(torch, ops, ref):
    rows_out = []
    gen = torch.Generator(device="cuda").manual_seed(2)
    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
        for rows, n in GRAM_SHAPES:
            x = torch.randn((rows, n), generator=gen, device="cuda")
            x[:, ::97] *= 20.0  # outlier channels, as calibration taps have
            x = x.to(dt)
            got_g, got_a = ops.gram_accumulate(x)
            want_g, want_a = ref.gram_accumulate_ref(x)
            torch.cuda.synchronize()
            err = float((got_g - want_g).abs().max())
            scale = float(want_g.abs().max())
            a_err = float((got_a - want_a).abs().max())
            a_scale = float(want_a.abs().max())
            ok = (bool(torch.isfinite(got_g).all()) and err <= GRAM_TOL * scale
                  and a_err <= GRAM_TOL * a_scale)
            del got_g, want_g
            ms = time_ms(lambda: ops.gram_accumulate(x), reps=5)
            plain = time_ms(lambda: ref.gram_accumulate_ref(x), reps=5)
            flat = x.float()
            lib = time_ms(lambda: torch.matmul(flat.T, flat), reps=5)
            del flat
            nbytes = x.numel() * x.element_size() + 4 * (n * n + n)
            flops = rows * n * (n + 1)  # upper triangle: products exact for bf16
            b, by = bound_ms(nbytes, flops, dname)
            row = dict(kernel="gram", dtype=dname, rows=rows, n=n, max_abs_err=err,
                       ref_max_abs=scale, tol=GRAM_TOL * scale, abs_sum_err=a_err,
                       abs_sum_tol=GRAM_TOL * a_scale, ok=ok, ms=ms, plain_ms=plain,
                       library_ms=lib, bytes=nbytes, flops=flops, bound_ms=b,
                       bound_by=by)
            rows_out.append(row)
            log(f"gram   {dname:8s} rows={rows} n={n:<5d} err={err:.3e} (tol "
                f"{row['tol']:.3e}) |x| err={a_err:.3e} (tol {row['abs_sum_tol']:.3e}) "
                f"{'OK' if ok else 'FAIL'}  kernel {ms:.3f} ms  plain {plain:.3f} ms  "
                f"library(matmul) {lib:.3f} ms  bound {b:.3f} ms ({by})")
    return rows_out


def flash_phase(torch, ops, ref):
    rows_out = []
    gen = torch.Generator(device="cuda").manual_seed(3)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    hd = 128
    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
        for b, s, hq, hkv in FLASH_SHAPES:
            if dname == "float32" and s == 1000:
                continue  # the ragged and G = 1 cases are checked in bf16

            def mk(h):
                return torch.randn((b, s, h, hd), generator=gen, device="cuda").to(dt)
            q, k, v = mk(hq), mk(hkv), mk(hkv)
            got = ops.flash_attention(q, k, v)
            want = ref.flash_attention_ref(q, k, v)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            scale = float(want.float().abs().max())
            ok = bool(torch.isfinite(got).all()) and err <= FLASH_TOL[dname] * scale
            del got, want
            ms = time_ms(lambda: ops.flash_attention(q, k, v))
            plain = time_ms(lambda: ref.flash_attention_ref(q, k, v), reps=3)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            lib = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True))
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
            flops = 2 * b * hq * hd * s * (s + 1)
            bnd, by = bound_ms(nbytes, flops, dname)
            row = dict(kernel="flash_attention", dtype=dname, B=b, S=s, Hq=hq, Hkv=hkv,
                       hd=hd, max_abs_err=err, ref_max_abs=scale,
                       tol=FLASH_TOL[dname] * scale, ok=ok, ms=ms, plain_ms=plain,
                       library_ms=lib, bytes=nbytes, flops=flops, bound_ms=bnd,
                       bound_by=by)
            rows_out.append(row)
            log(f"flash  {dname:8s} B={b:<2d} S={s:<4d} Hq/Hkv={hq}/{hkv} err={err:.3e} "
                f"(tol {row['tol']:.3e}) {'OK' if ok else 'FAIL'}  kernel {ms:.3f} ms  "
                f"plain {plain:.3f} ms  library(sdpa) {lib:.3f} ms  bound {bnd:.4f} ms "
                f"({by})")
    return rows_out


def rwkv6_phase(torch, ops, ref):
    rows_out = []
    gen = torch.Generator(device="cuda").manual_seed(4)
    for case, bh, t, k, dname, w_fixed in RWKV_SHAPES:
        dt = getattr(torch, dname)
        r, kk, v = (torch.randn((bh, t, k), generator=gen, device="cuda") * 0.5
                    for _ in range(3))
        w = (torch.full((bh, t, k), w_fixed, device="cuda") if w_fixed is not None
             else torch.rand((bh, t, k), generator=gen, device="cuda") * 0.989 + 0.01)
        u = torch.randn((bh, k), generator=gen, device="cuda") * 0.5
        args = [x.to(dt) for x in (r, kk, v, w)] + [u]
        got, got_s = ops.rwkv6_attention(*args, return_state=True)
        want, want_s = ref.rwkv6_scan_ref(*args, return_state=True)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        s_err = float((got_s - want_s).abs().max())
        s_scale = float(want_s.abs().max())
        ok = (bool(torch.isfinite(got).all()) and bool(torch.isfinite(got_s).all())
              and err <= RWKV_TOL[dname] * scale and s_err <= RWKV_STATE_TOL * s_scale)
        del got, want, got_s, want_s
        with_state = case == "prefill"  # as the path calls it
        ms = time_ms(lambda: ops.rwkv6_attention(*args, return_state=with_state))
        plain = time_ms(lambda: ref.rwkv6_scan_ref(*args, return_state=with_state), reps=3)
        el = args[0].element_size()
        nbytes = (5 * bh * t * k * el + 4 * bh * k
                  + (4 * bh * k * k if with_state else 0))
        # As the chunked form executes it, per token: the cross and state
        # products (2 K^2 each), the intra-chunk matrix and its product
        # (2 L K each), the bonus (4 K).
        flops = bh * t * (4 * k * k + 4 * ops.CHUNK * k + 4 * k)
        bnd, by = bound_ms(nbytes, flops, dname)
        row = dict(kernel="rwkv6", case=case, dtype=dname, BH=bh, T=t, K=k,
                   w=w_fixed, with_state=with_state, max_abs_err=err,
                   ref_max_abs=scale, tol=RWKV_TOL[dname] * scale,
                   state_max_abs_err=s_err, state_tol=RWKV_STATE_TOL * s_scale, ok=ok,
                   ms=ms, plain_ms=plain, library_ms=None, bytes=nbytes, flops=flops,
                   bound_ms=bnd, bound_by=by)
        rows_out.append(row)
        log(f"rwkv6  {dname:8s} {case:7s} BH={bh:<3d} T={t:<4d} K={k} err={err:.3e} (tol "
            f"{row['tol']:.3e}) state err={s_err:.3e} (tol {row['state_tol']:.3e}) "
            f"{'OK' if ok else 'FAIL'}  kernel {ms:.3f} ms  plain {plain:.3f} ms  "
            f"library none  bound {bnd:.4f} ms ({by}, {nbytes / 1e6:.1f} MB)")
    return rows_out


KERNELS = ("nested_lowrank", "paged_attention", "gram", "flash_attention", "rwkv6")


def _ops(name):
    return importlib.import_module(f"repro_torch.kernels.{name}.ops")


def reset_counts() -> None:
    for name in KERNELS:
        _ops(name).launches = 0


def read_counts() -> dict:
    return {name: _ops(name).launches for name in KERNELS}


def profile_step(torch, fn, label: str = "decode step") -> dict:
    """Device time by kernel name and device busy share of one call of
    ``fn`` (after a warm-up call), from torch.profiler's CUDA trace.  Only
    device events are summed: an aten op's row repeats its kernels' time."""
    from torch.autograd import DeviceType
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
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = ev.self_device_time_total
        if dev_us > 0:
            per[ev.key] = (per.get(ev.key, (0.0, 0))[0] + dev_us / 1e3, ev.count)
    busy = sum(ms for ms, _ in per.values())
    top = sorted(per.items(), key=lambda kv: -kv[1][0])[:12]
    log(f"  profiled {label}: wall {wall_ms:.2f} ms (profiler off), device "
        f"busy {busy:.3f} ms ({busy / wall_ms:.1%} of wall)")
    for name, (ms, n) in top:
        log(f"    {ms:8.3f} ms  x{n:<4d} {name[:90]}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "top": [{"name": k, "ms": ms, "count": n} for k, (ms, n) in top]}


def factored_ratio(params, plan) -> float:
    """1 - (factor parameters / dense parameters) over the plan's targets,
    counted from the compressed params themselves."""
    dense = factored = 0
    for t in plan.targets:
        leaf = params
        for key in t.path:
            leaf = leaf[key]
        n = 1
        for d in t.stacked:
            n *= d
        dense += n * t.in_dim * t.out_dim
        factored += sum(leaf[k].numel() for k in ("u", "v", "u2", "v2") if k in leaf)
    return 1.0 - factored / dense


def serve_path(torch, np, cfg, mixer: str, taps_per_layer: int):
    """``serve()`` on ``cfg``: calibrate, compress (nsvd1, ratio 0.2) and
    serve 8 requests on the layout the model takes, with exact launch counts
    (``mixer``: the kernel each calibration forward runs once per layer);
    then one decode step's logits through the kernels against the plain
    versions, on a cache prefilled with each prompt's first 15 tokens."""
    from repro_torch import kernels
    from repro_torch.launch.serve import serve
    from repro_torch.serving.kvcache import PagedKVCache

    rng = np.random.default_rng(0)
    plens = rng.integers(16, 201, size=8)
    prompts = [rng.integers(2, cfg.vocab_size // 2, size=int(n)) for n in plens]
    reset_counts()
    res = serve(cfg, requests=8, max_new=32, max_batch=8, max_len=256,
                seed=0, compress=0.2, block_size=16, prefill_chunk=64,
                prompts=prompts)
    counts = read_counts()
    eng, model, params, plan = res["engine"], res["model"], res["params"], res["plan"]
    st = eng.stats()
    paged = eng.layout == "paged"
    layers = cfg.num_layers
    n_linear = len(model.compressible_targets()) * layers
    # Calibration: 256 samples in batches of 16, each one causal forward
    # (the mixer kernel once per layer, taps_per_layer taps per layer plus
    # the final-norm tap).  Every compressed linear of every prefill call and
    # decode step runs the nested kernel; paged decode steps run paged
    # attention once per layer; dense admissions prefill each prompt at its
    # exact length through rwkv6 (paged prefill chunks attend over gathered
    # pages, as the reference, not through flash_attention).
    calib_batches = 256 // 16
    expect = {"nested_lowrank": n_linear * (st["steps"] + st["prefill_ticks"]),
              "paged_attention": layers * st["steps"] if paged else 0,
              "gram": (taps_per_layer * layers + 1) * calib_batches,
              "flash_attention": 0, "rwkv6": 0}
    expect[mixer] = layers * (calib_batches + (0 if paged else st["prefill_ticks"]))
    reasons = {u: r.finish_reason for u, r in res["requests"].items()}
    outs = res["outputs"]
    ratio = factored_ratio(params, plan)
    syncs_ok = (st["host_syncs"] <= st["steps"] + st["prefill_ticks"] if paged else
                st["prefill_ticks"] == 8 and st["host_syncs"] == st["steps"] + 8)
    ok = (len(outs) == 8 and all(reasons.get(u) for u in outs)
          and all(1 <= len(v) <= 32 for v in outs.values())
          and all(0 <= t < cfg.vocab_size for v in outs.values() for t in v)
          and syncs_ok and abs(ratio - plan.achieved_ratio) < 1e-9
          and counts == expect and expect["nested_lowrank"] > 0)
    log(f"serve path: {cfg.name} d_model={cfg.d_model} heads={cfg.num_heads}/"
        f"{cfg.num_kv_heads} hd={cfg.head_dim} d_ff={cfg.d_ff} vocab="
        f"{cfg.vocab_size} layers={layers} (depth cut); cache layout {eng.layout}")
    log(f"  prompt lengths {plens.tolist()}; plan achieved ratio "
        f"{plan.achieved_ratio:.4f} (counted from the factors: {ratio:.4f})")
    log("  phase seconds: " + ", ".join(f"{k}={v:.2f}" for k, v in res["seconds"].items()))
    log(f"  {res['tokens']} tokens in {res['seconds']['serve']:.2f} s = "
        f"{res['tok_per_s']:.1f} tok/s; decode steps {st['steps']}, prefill "
        f"calls {st['prefill_ticks']}, host syncs {st['host_syncs']}, step p50 "
        f"{st['step_p50_s'] * 1e3:.2f} ms")
    log(f"  launches {counts} expected {expect}; finish reasons {sorted(set(reasons.values()))}")

    toks = torch.as_tensor(np.stack([p[:15] for p in prompts]), device="cuda")
    nxt = torch.as_tensor([[int(p[15])] for p in prompts], device="cuda")
    clen = torch.full((8,), 15, dtype=torch.int32, device="cuda")
    with torch.no_grad():
        if paged:
            kv = PagedKVCache(model, 8, 256, block_size=16, device="cuda")
            for slot in range(8):
                kv.reserve(slot, 65)
            extra = {"block_tables": kv.table_device()}
            cache = kv.pools
            model.apply(params, toks, mode="decode", cache=cache,
                        cache_len=torch.zeros_like(clen), **extra)
        else:
            extra = {}
            cache = model.init_cache(8, 256, device="cuda")
            model.apply(params, toks, mode="prefill", cache=cache)

        def clone(tree):
            return ({k: clone(v) for k, v in tree.items()} if isinstance(tree, dict)
                    else tree.clone())
        saved = clone(cache)
        lk = model.apply(params, nxt, mode="decode", cache=cache, cache_len=clen,
                         **extra).float()
        with kernels.plain():
            lp = model.apply(params, nxt, mode="decode", cache=clone(saved),
                             cache_len=clen, **extra).float()
        prof = profile_step(torch, lambda: model.apply(
            params, nxt, mode="decode", cache=clone(saved), cache_len=clen, **extra),
            f"{eng.layout} decode step (8 rows)")
    torch.cuda.synchronize()
    step_err = float((lk - lp).abs().max())
    step_scale = float(lp.abs().max())
    agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    step_ok = (lk.shape == (8, 1, cfg.vocab_size) and bool(torch.isfinite(lk).all())
               and step_err <= STEP_LOGIT_TOL * step_scale)
    log(f"  decode-step logits kernels vs plain: max abs err {step_err:.4e} "
        f"(max |logit| {step_scale:.3f}, tol {STEP_LOGIT_TOL * step_scale:.4e}), "
        f"argmax agreement {agree:.3f} {'OK' if step_ok else 'FAIL'}")
    summary = dict(config=cfg.name, layers=layers, layout=eng.layout,
                   prompt_lengths=plens.tolist(), seconds=res["seconds"],
                   tokens=res["tokens"], tok_per_s=res["tok_per_s"], engine=st,
                   launches=counts, expected_launches=expect, finish_reasons=reasons,
                   achieved_ratio=plan.achieved_ratio, factored_ratio=ratio,
                   step_logit_max_abs_err=step_err, step_logit_max_abs=step_scale,
                   step_argmax_agreement=agree, step_profile=prof,
                   ok=bool(ok and step_ok))
    return summary, counts


def quality_path(torch, np, cfg, eval_n: int, taps_per_layer: int, mixer: str):
    """``build_entry`` on ``cfg`` with exact launch counts (``mixer``: the
    kernel every causal forward runs once per layer, flash_attention or
    rwkv6), then one eval batch's logits through the kernels against the
    plain versions, and profiles of an eval forward and a calibration batch."""
    import math

    from repro_torch import kernels
    from repro_torch.calib.runner import calibration_batches, collect_grams
    from repro_torch.eval.perplexity import eval_batches
    from repro_torch.models import build_model
    from repro_torch.obs.quality_report import EVAL_DOMAINS, build_entry

    model = build_model(cfg)
    params = model.init(0, "cuda")
    eval_b, eval_s, attr_n = 4, 2048, 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    entry = build_entry(cfg, method="nsvd1", ratio=0.2, k1_frac=0.9,
                        eval_n_batches=eval_n, eval_batch=eval_b, eval_seq=eval_s,
                        calib_samples=256, attribution_batches=attr_n, params=params)
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # Causal forwards: calibration, dense and compressed ppl per domain, the
    # two forwards of each KL batch (logit KL, then each target's patch), and
    # 2 domains x 4 batches of activation similarity.
    n_targets = len(model.compressible_targets())
    forwards = (256 // 16 + 2 * len(EVAL_DOMAINS) * eval_n + 2 * eval_n
                + 2 * n_targets * attr_n + 2 * 4)
    # Eval batches have 8192 rows, above the nested kernel's 1024-row gate
    # (the reference's): compressed linears run as plain matmuls there.
    expect = {"nested_lowrank": 0, "paged_attention": 0, "flash_attention": 0,
              "rwkv6": 0, "gram": (taps_per_layer * cfg.num_layers + 1) * (256 // 16)}
    expect[mixer] = cfg.num_layers * forwards
    tot = entry["decomposition"]
    numbers = [*entry["dense_ppl"].values(), *entry["compressed_ppl"].values(),
               *entry["ppl_ratio"].values(), entry["logit_kl"], entry["achieved_ratio"],
               *(r["logit_kl"] for r in entry["attribution"]),
               entry["activation_similarity"]["mean"], *tot.values()]
    finite = all(math.isfinite(float(x)) for x in numbers)
    ratio_ok = abs(tot["achieved_ratio"] - entry["achieved_ratio"]) < 1e-9
    ok = (finite and ratio_ok and counts == expect
          and len(entry["attribution"]) == n_targets)
    log(f"quality path: {cfg.name} layers={cfg.num_layers} (depth cut), eval batches "
        f"{eval_n} x ({eval_b}, {eval_s}) per domain; peak device memory {peak_gb:.1f} GB")
    log("  phase seconds: " + ", ".join(f"{k}={v:.2f}" for k, v in entry["seconds"].items()))
    for d in EVAL_DOMAINS:
        log(f"  ppl[{d}]: dense {entry['dense_ppl'][d]:.3f} compressed "
            f"{entry['compressed_ppl'][d]:.3f} (x{entry['ppl_ratio'][d]:.4f})")
    log(f"  logit KL {entry['logit_kl']:.5f} nats/token; achieved ratio "
        f"{entry['achieved_ratio']:.5f} (factors: {tot['achieved_ratio']:.5f}); "
        f"decomposition {tot}")
    log(f"  attribution top: {entry['attribution'][:2]}; activation similarity "
        f"{entry['activation_similarity']}")
    log(f"  launches {counts} expected {expect}; all numbers finite: {finite}")

    # One eval batch's dense logits through the kernels vs the plain versions.
    toks = torch.as_tensor(next(eval_batches(cfg.vocab_size, "en_a", 1, eval_b, eval_s)),
                           device="cuda")
    with torch.no_grad():
        lk = model.apply(params, toks, mode="train").float()
        with kernels.plain():
            lp = model.apply(params, toks, mode="train").float()
    err = float((lk - lp).abs().max())
    scale = float(lp.abs().max())
    agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    logit_ok = (lk.shape == (eval_b, eval_s, cfg.vocab_size)
                and bool(torch.isfinite(lk).all()) and err <= EVAL_LOGIT_TOL * scale)
    del lk, lp
    log(f"  eval-batch logits kernels vs plain: max abs err {err:.4e} (max |logit| "
        f"{scale:.3f}, tol {EVAL_LOGIT_TOL * scale:.4e}), argmax agreement "
        f"{agree:.4f} {'OK' if logit_ok else 'FAIL'}")
    # Where the quality path's time goes: one eval forward and one
    # calibration batch (forward, gram launches, fp64 accumulation).
    calib_toks = next(calibration_batches(cfg.vocab_size, "en_a", 16, 16, 128))
    with torch.no_grad():
        prof_eval = profile_step(torch, lambda: model.apply(params, toks, mode="train"),
                                 f"eval forward ({eval_b} x {eval_s})")
    prof_calib = profile_step(torch, lambda: collect_grams(model, params, [calib_toks]),
                              "calibration batch (16 x 128)")
    summary = dict(config=cfg.name, layers=cfg.num_layers, entry=entry, launches=counts,
                   expected_launches=expect, peak_memory_gb=peak_gb,
                   eval_profile=prof_eval, calib_profile=prof_calib,
                   eval_logit_max_abs_err=err, eval_logit_max_abs=scale,
                   eval_argmax_agreement=agree, ok=bool(ok and logit_ok))
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
        from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref
        from repro_torch.kernels.gram import ops as gram_ops, ref as gram_ref
        from repro_torch.kernels.nested_lowrank import ops as nlr_ops, ref as nlr_ref
        from repro_torch.kernels.paged_attention import ops as pa_ops, ref as pa_ref
        from repro_torch.kernels.rwkv6 import ops as rwkv_ops, ref as rwkv_ref
        from repro_torch.configs import MISTRAL_7B, RWKV6_1_6B
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
    grams = gram_phase(torch, gram_ops, gram_ref)
    flash = flash_phase(torch, fa_ops, fa_ref)
    rwkv = rwkv6_phase(torch, rwkv_ops, rwkv_ref)
    kernels_ok = all(r["ok"] for r in nested + paged + grams + flash + rwkv)
    # mistral-7b cut to 2 of 32 layers; rwkv6-1.6b cut to 4 of 24; widths
    # untouched.  (path, function, args): the mixer kernel and the
    # calibration taps per layer of each model.
    mistral = dataclasses.replace(MISTRAL_7B, num_layers=2)
    rwkv6 = dataclasses.replace(RWKV6_1_6B, num_layers=4)
    runs = (("serve", serve_path, (mistral, "flash_attention", 4)),
            ("quality", quality_path, (mistral, 2, 4, "flash_attention")),
            ("rwkv_serve", serve_path, (rwkv6, "rwkv6", 9)),
            ("rwkv_quality", quality_path, (rwkv6, 1, 9, "rwkv6")))
    summaries, path_counts, path_s = {}, {}, {}
    for name, fn, args in runs:
        t0 = time.perf_counter()
        summaries[name], path_counts[name] = fn(torch, np, *args)
        path_s[name] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    log("path seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in path_s.items()))
    serve_counts, quality_counts = path_counts["serve"], path_counts["quality"]
    rwkv_serve_counts = path_counts["rwkv_serve"]

    # One entry per kernel at its path's main shape: the gate projection
    # (largest factor bytes) at 8 live decode rows in bf16 and the bf16 page
    # pools (serve path); the d_ff-wide tap in bf16 and the (4, 2048) eval
    # batch in bf16 (quality path); the rwkv6-1.6b eval batch in fp32 (the
    # model's dtype for the recurrence).  Launches are each kernel's count on
    # its own path (rwkv6: the RWKV-6 serve path).
    picks = (
        (next(r for r in nested if r["dtype"] == "bfloat16" and r["target"] == "gate"
              and r["M"] == 8), serve_counts, "src/repro_torch/csrc/nested_lowrank.cu",
         "src/repro/kernels/nested_lowrank/nested_lowrank.py:84"),
        (next(r for r in paged if r["pool"] == "bfloat16"), serve_counts,
         "src/repro_torch/csrc/paged_attention.cu",
         "src/repro/kernels/paged_attention/paged_attention.py:243"),
        (next(r for r in grams if r["dtype"] == "bfloat16" and r["n"] == 14336),
         quality_counts, "src/repro_torch/csrc/gram.cu", "src/repro/kernels/gram/gram.py:54"),
        (next(r for r in flash if r["dtype"] == "bfloat16" and r["S"] == 2048),
         quality_counts, "src/repro_torch/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention/flash_attention.py:108"),
        (next(r for r in rwkv if r["dtype"] == "float32" and r["case"] == "eval"),
         rwkv_serve_counts, "src/repro_torch/csrc/rwkv6.cu",
         "src/repro/kernels/rwkv6/rwkv6.py:105"),
    )
    entries = []
    for row, counts, src, replaces in picks:
        entries.append({"name": row["kernel"], "route": "cuda", "source": src,
                        "replaces": replaces, "launches": counts[row["kernel"]],
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"device": kind, "nvidia_smi": smi_line, "build_s": build_s,
                   "nested": nested, "paged": paged, "gram": grams, "flash": flash,
                   "rwkv6": rwkv, **{f"{k}_path": v for k, v in summaries.items()},
                   "path_seconds": path_s, "kernels": entries}, f, indent=1)
    paths_ok = {k: v["ok"] for k, v in summaries.items()}
    if not (kernels_ok and all(paths_ok.values())):
        log(f"chip_smoke: FAILED (kernels ok={kernels_ok}, paths ok={paths_ok})")
        return 1
    print(json.dumps({"kernels": entries}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
