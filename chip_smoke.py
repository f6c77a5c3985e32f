#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts on the GPU.

    python3 chip_smoke.py

Needs one NVIDIA H100 (sm_90a) and the CUDA toolkit.  Phases:
  1. device: nvidia-smi's name and power limit, torch's device name;
  2. build: compiles every kernel of the main paths from src/repro_torch/csrc
     (one nvcc per source, in parallel);
  3. kernels: each kernel against its plain PyTorch version at the main
     paths' shapes, with the stated tolerance, timed (CUDA events) beside
     the plain version, one PyTorch library call and the bytes/FLOP bound
     (nested_lowrank: also a per-element check, which kernel ran -- the
     stream kernel at 1-16 bf16 rows, the mma kernel at 17-1024, the tile
     kernel for fp32 -- the device time of one call and of ``multi_dot``
     from torch.profiler, and at bf16 rows above 16 the device time of the
     tile kernel that ran them before the mma kernel; gram: also a
     per-element check, exact symmetry, which kernel ran -- mma for bf16,
     FMA for fp32 -- the device time of one call and of the library call,
     and for bf16 the device time of the FMA kernel on the same rows;
     paged_attention: also a per-element check and zeros on a length-0 row at
     lengths 1-700, at eight rows of 512-8192 tokens, at one row of 32768
     and at the serve path's decode step, bf16 and int8 pools, with the
     split plan, which kernels ran, the device time of one call and of SDPA,
     the achieved bytes/s, and the combine kernel alone against its plain
     version on the split kernel's partials; rwkv6: also a per-element check
     of y and of the final state, and the device time of one call);
  4. serve path: ``serve()`` on mistral-7b at full width (depth cut to 2
     layers, random weights from a seed): calibrate, NSVD-compress (nsvd1,
     ratio 0.2, bf16 factors) and serve 8 requests, with the kernels' launch
     counters read around the run (nested calls: every decode step's on the
     stream kernel, every 512-row prefill chunk's on the mma kernel, none on
     the tile kernel; gram calls: all on the mma kernel; paged combine
     launches as plan_splits predicts for the table); then one decode
     step's logits through the kernels against the same step through the
     plain versions, and profiles of that step and of one prefill chunk
     (each profile the median of PROFILE_WINDOWS windows, of those that kept
     every kernel); the engine there runs as before the scheduler
     (worst-case admission, pipeline depth 1);
  4b. sched_serve path: the reference engine's serving policy on the same
     compressed model, 16 requests (prompts 16-200, 48 new tokens) in four
     runs (SCHED_RUNS): A worst case at depth 1 in slot order (the engine
     before the scheduler), B on demand at depth 2 with row order (and
     B_unsorted without it), C on demand at depth 2 on a 56-block pool with
     swap resume and defrag every 8 steps, D on demand at depth 4 on that
     pool with re-prefill resume and two latency classes, 4 interactive
     requests arriving after 10 steps.  B and C equal A token for token, as
     does every request of D never preempted; a re-prefilled request first
     differs from A, if at all, where A's top-2 logit margin (one
     teacher-forced forward a request, kept for 4c) is within 5% of max
     |logit|; C and D preempt
     at least 3 times, C swaps and defrag moves blocks, D preempts for the
     higher class; decode steps, prefill calls, preemptions and every
     launch count as predicted (SCHED_PREDICTED); every dispatch runs under
     sync-debug mode "error"; then the device timeline of two consecutive
     decode steps at depths 1 and 2 (largest idle gap, idle share);
  4c. fault_serve path: the serving engine's fault tolerance on the same
     model, prompts and A's streams, on demand at depth 2 (FAULT_SPECS): F1
     poisons one request twice (a re-prefill retry, then "error") and one
     once (a retry that finishes), fails three block reservations and
     stalls one token copy 0.05 s; F2 corrupts two swap payloads on the
     56-block pool (each falls back to re-prefill); F3 sheds two requests
     past their deadline, cancels a queued, a prefilling and a live request
     (steps in flight), drains and closes; F4 arms a 0.2 s step timeout on
     a warm engine and stalls one copy 0.3 s (ServingFault "step_timeout",
     its snapshot JSON).  Untouched requests equal A token for token,
     retried and preempted ones by the margin rule; every finish reason as
     expected (FAULT_REASONS); fault_stats() reconciles with the plan;
     counts and launches as predicted (FAULT_PREDICTED, from a CPU run:
     tests/test_torch_faults.py runs this path at a tiny width); every
     dispatch under sync-debug "error", the poisoned ones included; then
     the finite check's device time alone and a profiled decode step;
  5. quality path: ``obs.quality_report.build_entry`` on the same model:
     calibrate (gram kernel), compress with telemetry, evaluate dense vs
     compressed perplexity on five domains at (4, 2048) tokens a batch
     (flash_attention kernel), logit KL, per-target attribution, activation
     similarity; launch counts read around it, and one eval batch's logits
     through the kernels against the plain versions; profiles of one eval
     forward and of one steady calibration batch (the store already seeded);
  6. RWKV-6 serve path: ``serve()`` on rwkv6-1.6b at full width (depth cut to
     4 layers, random weights from a seed) on the dense recurrent-state slab:
     calibrate (gram, rwkv6), compress, serve the same 8 requests (each
     admission one exact-length prefill through rwkv6 and, above 16 rows,
     the nested mma kernel; decode through the nested stream kernel), launch
     counts read around it (every rwkv6 launch on 16-byte copies); then one
     dense decode step's logits through the kernels against the plain
     versions, and profiles of that step and of the longest prompt's
     admission;
  7. RWKV-6 quality path: ``build_entry`` on the same model, one (4, 2048)
     eval batch per domain, every causal forward through rwkv6;
  8. methods path (run after the Mistral quality path): mistral-7b at full
     width cut to 1 layer; one calibration (gram, flash_attention), then
     ``compress_model`` with each of the nine methods of ``ALL_METHODS``
     (ratio 0.3, k1_frac 0.9, bf16 factors, per-target diagnostics) and
     perplexity on one (1, 1024) batch of en_a and of jp (nested linears on
     the mma kernel); Eckart-Young per target, equal achieved ratios, exact
     launch counts; on the nid1 gate projection the residual's column ID
     exact (C its columns, T the identity there, its error above the
     rank-k2 SVD's) and the nested kernel per element against its plain
     version on those bf16 factors at 8 and 512 rows.
Prints a JSON kernel summary, nvidia-smi's line, and as its last line
{"ok": true, "device": {...}}.  Any failed phase exits non-zero; without a
card (or outside the repository) it exits non-zero before printing results.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import math
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
# bf16: <= 16 the stream kernel; 17 (the first mma row count), 64, 200 (an
# RWKV admission, not a multiple of 16) and 512 (a paged prefill chunk of 8
# x 64) the mma kernel.  fp32: the tile kernel at every row count.
NESTED_ROWS = (1, 8, 16, 17, 64, 200, 512)
# Max |kernel - plain| / max |plain| allowed.  bf16: the kernel and the plain
# version round the rank-width intermediate and the output to bf16 at the
# same points but sum in different orders (a few bf16 ulps of the output);
# fp32: summation order only.
NESTED_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# And for every element: |kernel - plain| <= tol * (|plain| + rms of its
# row), which a fault in a few columns, one u/u2 tile or a late split-K
# slice cannot hide under max |plain|.  bf16: the plain version rounds x@u,
# x@u2, their two products and the sum to bf16 (three roundings of the
# output, one ulp up to 2^-7 of |y|), the kernel rounds t and y once each;
# four ulps allowed.  fp32: sum order only.
NESTED_ELEM_TOL = {"bfloat16": 2 ** -5, "float32": 1e-4}
PAGED_TOL = 2e-2   # bf16 output; int8 pages dequantized in fp32 vs bf16
# And for every element of a live row: |kernel - plain| <= tol * (|plain| +
# rms of that (row, head)'s output over hd), which a split dropped from a
# long row (outputs ~0.04 there against ~3 for a length-1 row) cannot hide
# under max |plain|.  bf16: the plain version rounds probabilities, and
# int8's dequantized K/V, to bf16 while the kernel keeps them in fp32; the
# output rounds once.  fp32: sum order only.
PAGED_ELEM_TOL = {"bfloat16": 2 ** -5, "float32": 1e-4}
# (case, lengths, table columns or None for the longest row's pages) at
# Mistral-7B's heads (32/8, hd 128, block 16): page-edge lengths up to 700
# and a dead row (5.29 MB of bf16 K/V, L2-resident across calls); eight long
# rows, 30016 tokens (123 MB, beyond the 50 MB L2); one row at Mistral-7B's
# max_seq (134 MB); and the serve path's decode step halfway through its 32
# new tokens (its 8 prompts + 16, in its 16-column table: max_len 256,
# block 16).
PAGED_CASES = (("phase", (1, 15, 16, 17, 255, 256, 700, 0), None),
               ("long8", (512, 1024, 2048, 3000, 4096, 5000, 6144, 8192), None),
               ("one32k", (32768,), None),
               ("serve", (189, 149, 126, 81, 88, 39, 45, 35), 16))
# Kernel vs plain rounding through a decode step (and below, one eval
# batch), a few layers deep.  A MoE model's plain run takes the kernel run's
# expert choices (models.moe.RoutingTrace): top-k routing flips at near-ties
# on rounding-level differences (random routers have many), which moves a
# token's logits by O(1) whatever the kernels' error.
STEP_LOGIT_TOL = 5e-2
# (rows, n): the taps of a calibration batch (16 x 128 rows) at rwkv6-1.6b's
# d_model, Mistral-7B's d_model, rwkv6-1.6b's d_ff and Mistral-7B's d_ff.
GRAM_SHAPES = ((2048, 2048), (2048, 4096), (2048, 7168), (2048, 14336))
# Max |kernel - plain| / max |plain|, for G and for sum |x|: both sum the
# same exact products (bf16 x bf16 is exact in fp32) in another order.
GRAM_TOL = 1e-5
# And for every entry: |kernel - plain|_ij <= GRAM_ELEM_TOL * sqrt(plain_ii
# plain_jj), which a fault in one off-diagonal tile cannot hide under the
# outlier channels' max |G| (~8.8e5 here, against ~45 for an ordinary
# entry).  sqrt(G_ii G_jj) bounds sum_k |x_ki x_kj| (Cauchy-Schwarz), so a
# summation-order error over R rows is at most gamma_R of it: 1e-4 is
# gamma_2048 in fp32 (measured on the H100: up to 4.5e-6 for the mma
# kernel, 0 for the FMA kernel).  G must also equal G^T exactly, entry by
# entry.
GRAM_ELEM_TOL = 1e-4
# (B, S, Hq, Hkv): calibration and evaluation batches at Mistral-7B's heads,
# a ragged S, and G = 1.
FLASH_SHAPES = ((16, 128, 32, 8), (4, 2048, 32, 8), (4, 1000, 32, 8), (4, 1000, 8, 8))
# bf16: P is rounded to bf16 before P V unnormalized (kernel) vs normalized
# (plain), and outputs round to bf16; fp32: sum order only.
FLASH_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# And for every element: |kernel - plain| <= tol * (|plain| + rms of its
# row over hd), which a fault in a late tile or a few keys of a long row
# cannot hide under the large outputs of the first rows.  bf16: the output
# rounds to bf16 (up to one ulp, 2^-7 of |out|) after P's rounding at
# another point has moved the fp32 value by a few 2^-9 of the row's rms;
# four ulps allowed (measured up to 1.33e-2 on the H100).  fp32: sum order
# only (measured up to 7.4e-6).
FLASH_ELEM_TOL = {"bfloat16": 2 ** -5, "float32": 1e-4}
EVAL_LOGIT_TOL = 5e-2  # bf16 models: flash vs naive rounding, one batch
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
# fp32: the same recurrence, y summed over K in another order.  bf16:
# inputs widen exactly and both sides compute in fp32, then each rounds y
# to bf16 on its own: one bf16 ulp (2^-8) of the output; the state keeps
# the fp32 bound.
RWKV_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
RWKV_STATE_TOL = 1e-4
# Per element, |kernel - plain| / (|plain| + rms of the row: y over its K
# columns, the state over its V columns).  y, fp32: the two sum r.(S + u k
# v) in other orders, and a row is small where that sum cancels -- at t = 0,
# y_0 = (r.(u*k)) v_0, so the whole row scales with one dot product -- and
# both sides then carry fp32 rounding of the uncancelled terms: at the calib
# case the plain scan alone is 7.0e-5 from an fp64 scan and the kernel
# 2.4e-5 (kernel vs plain 9.4e-5), and kernel vs plain reached 4.0e-4 on
# other seeded inputs (H100 runs); 2e-3 allowed.  y, bf16: each side rounds
# y to bf16 on its own, at most one ulp apart (2^-7 of |plain| where the
# fp32 values straddle a rounding point); two allowed.  The state: the
# kernel rounds each step as the plain scan does (0 measured); 1e-4, the
# global bound, covers a plain version that fuses a multiply-add.
RWKV_ELEM_TOL = {"float32": 2e-3, "bfloat16": 2 ** -6}
RWKV_STATE_ELEM_TOL = 1e-4
DEVICE_REPS = 5  # calls a nested row's profiled device time is the mean of
# The batched (per-expert) forms at moonshot-v1-16b-a3b's expert shapes:
# 64 experts, rank 667 at ratio 0.2 (k1 634, k2 33 at k1_frac 0.95).
# (case, capacity rows C, in K, out N, dtype, the route): a decode step's 8
# rows (stream), an eval batch's 960 through the gate/up and down
# projections (mma), and fp32 (the tile kernel).  Held to NESTED_TOL and
# NESTED_ELEM_TOL, as the single form.
MOE_EXPERTS, MOE_K1, MOE_K2 = 64, 634, 33
NESTED_BATCHED_CASES = (("decode", 8, 2048, 1408, "bfloat16", "stream"),
                        ("eval_gate", 960, 2048, 1408, "bfloat16", "mma"),
                        ("eval_down", 960, 1408, 2048, "bfloat16", "mma"),
                        ("fp32", 8, 2048, 1408, "float32", "tile"))
# (E, C, n): a calibration batch's expert_buf and expert_mid taps (2048
# tokens, top-6 of 64 experts at capacity factor 1.25: C 240), bf16, held to
# GRAM_TOL and GRAM_ELEM_TOL with exact symmetry, expert by expert.
GRAM_BATCHED_SHAPES = ((64, 240, 2048), (64, 240, 1408))


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


def elem_err(torch, got, want) -> float:
    """Max over elements of |got - want| / (|want| + rms of want's row)."""
    w = want.float()
    rms = w.pow(2).mean(-1, keepdim=True).sqrt()
    return float(((got.float() - w).abs() / (w.abs() + rms).clamp_min(1e-30)).max())


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
                kernel = ops.plan(m, dt, k_in, n, k1, k2, True).kernel
                before = nested_split()
                got = ops.nested_lowrank_matmul(x, u, v, u2, v2)
                want = ref.nested_lowrank_matmul_ref(x, u, v, u2, v2)
                torch.cuda.synchronize()
                after = nested_split()
                ran = next((k for k in after if after[k] > before[k]), "none")
                err = float((got.float() - want.float()).abs().max())
                scale = float(want.float().abs().max())
                e_err = elem_err(torch, got, want)
                want_ran = (("stream" if m <= ops.STREAM_ROWS else "mma")
                            if dname == "bfloat16" else "tile")
                ok = (bool(torch.isfinite(got).all()) and err <= NESTED_TOL[dname] * scale
                      and e_err <= NESTED_ELEM_TOL[dname] and ran == kernel == want_ran)
                ms = time_ms(lambda: ops.nested_lowrank_matmul(x, u, v, u2, v2))
                plain = time_ms(lambda: ref.nested_lowrank_matmul_ref(x, u, v, u2, v2))
                lib = time_ms(lambda: torch.linalg.multi_dot([x, big_u, big_v]))
                # Device time of one call (the events above include the
                # wrapper's host time): the mean of DEVICE_REPS calls.
                dev_ms = profile_step(torch, lambda: [ops.nested_lowrank_matmul(
                    x, u, v, u2, v2) for _ in range(DEVICE_REPS)], quiet=True)[
                    "device_busy_ms"] / DEVICE_REPS
                lib_dev = profile_step(torch, lambda: [torch.linalg.multi_dot(
                    [x, big_u, big_v]) for _ in range(DEVICE_REPS)], quiet=True)[
                    "device_busy_ms"] / DEVICE_REPS
                tile_dev = None
                if ran == "mma":  # the tile kernel, which ran these rows before
                    tile_plan = ops.Plan("tile", *ops.split_k(m, k_in, r),
                                         *ops.split_k(m, r, n))
                    y_tile = torch.empty_like(got)
                    tile_dev = profile_step(torch, lambda: [ops.launch(
                        x, u, v, u2, v2, y_tile, tile_plan) for _ in range(DEVICE_REPS)],
                        quiet=True)["device_busy_ms"] / DEVICE_REPS
                el = x.element_size()
                nbytes = el * (x.numel() + u.numel() + v.numel() + u2.numel()
                               + v2.numel() + m * n)
                flops = 2 * m * (k_in * r + r * n)
                b, by = bound_ms(nbytes, flops, dname)
                row = dict(kernel="nested_lowrank", target=target, dtype=dname,
                           M=m, K=k_in, N=n, rank=r, k1=k1, k2=k2, ran=ran,
                           max_abs_err=err, ref_max_abs=scale,
                           tol=NESTED_TOL[dname] * scale, elem_err=e_err,
                           elem_tol=NESTED_ELEM_TOL[dname], ok=ok, ms=ms,
                           device_ms=dev_ms, plain_ms=plain, library_ms=lib,
                           library_device_ms=lib_dev, tile_device_ms=tile_dev, bytes=nbytes,
                           flops=flops, bound_ms=b, bound_by=by)
                rows.append(row)
                tile_txt = "" if tile_dev is None else f"  tile kernel device {tile_dev:.4f}"
                log(f"nested {dname:8s} {target:4s} M={m:<3d} {ran:6s} err={err:.3e} "
                    f"(tol {row['tol']:.3e}) elem err {e_err:.3e} (tol "
                    f"{row['elem_tol']:.3e}) {'OK' if ok else 'FAIL'}  kernel {ms:.4f} ms "
                    f"(device {dev_ms:.4f})  plain {plain:.3f} ms  library {lib:.4f} ms "
                    f"(device {lib_dev:.4f})  bound {b:.4f} ms ({by}, {nbytes / 1e6:.1f} MB)"
                    f"{tile_txt}")
    return rows


def paged_inputs(torch, np, lens, pool, cols=None):
    """(q, k_pages, v_pages, k_scales, v_scales, block_tables, lengths) of a
    paged case at Mistral-7B's heads: bf16 q; bf16 pools, or int8 with fp32
    scales; each row's pages scattered over a shuffled pool, -1 past them in
    a table of ``cols`` columns (default: the longest row's pages)."""
    b, hq, hkv, hd, bs = len(lens), 32, 8, 128, 16
    lens = np.asarray(lens, np.int32)
    pages = [-(-int(n) // bs) for n in lens]
    nb = sum(pages) + 8
    perm = iter(np.random.default_rng(0).permutation(nb))
    table = np.full((b, cols or max(pages)), -1, np.int32)
    for r, p in enumerate(pages):
        for j in range(p):
            table[r, j] = next(perm)
    gen = torch.Generator(device="cuda").manual_seed(1)
    q = (torch.randn((b, hq, hd), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
    if pool == "int8":
        kp, vp = (torch.randint(-127, 128, (nb, bs, hkv, hd), generator=gen, device="cuda",
                                dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.rand((nb, bs, hkv), generator=gen, device="cuda") * 0.01
                  for _ in range(2))
    else:
        kp, vp = (torch.randn((nb, bs, hkv, hd), generator=gen, device="cuda").to(torch.bfloat16)
                  for _ in range(2))
        ks = vs = None
    return (q, kp, vp, ks, vs, torch.as_tensor(table, device="cuda"),
            torch.as_tensor(lens, device="cuda"))


def paged_phase(torch, np, ops, ref):
    rows = []
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for case, lens, cols in PAGED_CASES:
        for pool in ("bfloat16", "int8"):
            q, kp, vp, ks, vs, bt, ln = paged_inputs(torch, np, lens, pool, cols=cols)
            b, hq, hd = q.shape
            hkv, bs = kp.shape[2], kp.shape[1]
            live = ln > 0
            n_splits, pps = ops.plan_splits(b, hkv, bt.shape[1])
            before = (ops.launches, ops.combine_launches)
            got = ops.paged_attention(q, kp, vp, bt, ln, ks, vs)
            want = ref.paged_attention_ref(q, kp, vp, bt, ln, ks, vs)
            torch.cuda.synchronize()
            counts = (ops.launches - before[0], ops.combine_launches - before[1])
            err = float((got.float() - want.float()).abs()[live].max())
            scale = float(want.float().abs()[live].max())
            e_err = elem_err(torch, got[live], want[live])
            dead_zero = bool((got[~live] == 0).all())
            ok = (bool(torch.isfinite(got).all()) and err <= PAGED_TOL * scale
                  and e_err <= PAGED_ELEM_TOL["bfloat16"] and dead_zero
                  and counts == (1, int(n_splits > 1)))
            del got, want
            ms = time_ms(lambda: ops.paged_attention(q, kp, vp, bt, ln, ks, vs), reps=20)
            plain = time_ms(lambda: ref.paged_attention_ref(q, kp, vp, bt, ln, ks, vs), reps=5)
            # Device time of one call, split kernel plus combine (the events
            # above include the wrapper's host time), the mean of DEVICE_REPS.
            prof = profile_step(torch, lambda: [ops.paged_attention(
                q, kp, vp, bt, ln, ks, vs) for _ in range(DEVICE_REPS)], quiet=True)
            dev_ms = prof["device_busy_ms"] / DEVICE_REPS
            combine_ms = sum(v for k, v in prof["kernels"].items()
                             if "paged_combine" in k) / DEVICE_REPS
            # Library yardstick: SDPA over the pages gathered (outside the
            # timing) into a padded (B, Hq, T, hd) view with a length mask.
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
            lib = time_ms(lambda: sdpa(q4, kg, vg, attn_mask=mask), reps=20)
            lib_dev = profile_step(torch, lambda: [sdpa(q4, kg, vg, attn_mask=mask) for _ in range(
                DEVICE_REPS)], quiet=True)["device_busy_ms"] / DEVICE_REPS
            del kg, vg, mask
            el = kp.element_size()
            tokens = int(ln.sum())
            nbytes = (2 * q.numel() * q.element_size() + 2 * tokens * hkv * hd * el
                      + (2 * tokens * hkv * 4 if ks is not None else 0)
                      + bt.numel() * 4 + ln.numel() * 4)
            flops = 4 * hq * hd * tokens
            bnd, by = bound_ms(nbytes, flops, "bfloat16")
            row = dict(kernel="paged_attention", case=case, pool=pool, B=b, Hq=hq, Hkv=hkv,
                       hd=hd, bs=bs, lengths=[int(x) for x in lens],
                       table_cols=bt.shape[1], n_splits=n_splits, pps=pps,
                       launches=counts[0], combine_launches=counts[1], max_abs_err=err,
                       ref_max_abs=scale, tol=PAGED_TOL * scale, elem_err=e_err,
                       elem_tol=PAGED_ELEM_TOL["bfloat16"], dead_row_zero=dead_zero,
                       ok=ok, ms=ms, device_ms=dev_ms, combine_device_ms=combine_ms,
                       plain_ms=plain, library_ms=lib, library_device_ms=lib_dev,
                       bytes=nbytes, flops=flops, bound_ms=bnd, bound_by=by,
                       tb_per_s=nbytes / dev_ms * 1e-9 if dev_ms > 0 else None,
                       bound_share=bnd / dev_ms if dev_ms > 0 else None)
            rows.append(row)
            log(f"paged  {case:6s} pool={pool:8s} splits={n_splits}x{pps}p launches="
                f"{counts} err={err:.3e} (tol {row['tol']:.3e}) elem err {e_err:.3e} (tol "
                f"{row['elem_tol']:.3e}) dead-row zeros={dead_zero} {'OK' if ok else 'FAIL'}"
                f"  kernel {ms:.4f} ms (device {dev_ms:.4f}, combine {combine_ms:.4f}; "
                f"{nbytes / dev_ms * 1e-9 if dev_ms > 0 else 0:.2f} TB/s, "
                f"{row['bound_share'] or 0:.1%} of bound)  plain {plain:.4f} ms  library(sdpa) "
                f"{lib:.4f} ms (device {lib_dev:.4f})  bound {bnd:.4f} ms ({by}, "
                f"{nbytes / 1e6:.2f} MB)")
            if n_splits > 1:
                rows.append(combine_row(torch, np, ops, ref, case, pool, q, kp, vp, ks, vs,
                                        bt, ln, n_splits, pps))
            del q, kp, vp, ks, vs
            torch.cuda.empty_cache()
    return rows


def combine_row(torch, np, ops, ref, case, pool, q, kp, vp, ks, vs, bt, ln, n_splits, pps):
    """The combine kernel alone on the split kernel's partials of a paged
    case, against its plain version on the same partials."""
    b, hq, hd = q.shape
    hkv, bs, cols = kp.shape[2], kp.shape[1], bt.shape[1]
    acc, ml = ops.split_partials(q, kp, vp, bt, ln, ks, vs, None, n_splits, pps)
    before = ops.combine_launches
    got = ops.combine(acc, ml, ln, bs, cols, pps, q.dtype)
    want = ref.combine_partials_ref(acc, ml, ln, bs, cols, pps, q.dtype)
    torch.cuda.synchronize()
    live = ln > 0
    err = float((got.float() - want.float()).abs()[live].max())
    scale = float(want.float().abs()[live].max())
    e_err = elem_err(torch, got[live], want[live])
    ok = (bool(torch.isfinite(got).all()) and err <= PAGED_TOL * scale
          and e_err <= PAGED_ELEM_TOL["bfloat16"] and bool((got[~live] == 0).all())
          and ops.combine_launches == before + 1)
    ms = time_ms(lambda: ops.combine(acc, ml, ln, bs, cols, pps, q.dtype), reps=20)
    plain = time_ms(lambda: ref.combine_partials_ref(acc, ml, ln, bs, cols, pps, q.dtype))
    dev_ms = profile_step(torch, lambda: [ops.combine(acc, ml, ln, bs, cols, pps, q.dtype)
                                          for _ in range(DEVICE_REPS)],
                          quiet=True)["device_busy_ms"] / DEVICE_REPS
    # Bytes: the partials of the splits each row's length reaches, the
    # lengths, the output.
    pages = -(-np.minimum(ln.cpu().numpy().astype(np.int64), cols * bs) // bs)
    reached = int(np.minimum(-(-pages // pps), n_splits).sum()) * hkv
    g = hq // hkv
    nbytes = reached * g * (hd + 2) * 4 + b * 4 + q.numel() * q.element_size()
    bnd, by = bound_ms(nbytes, reached * g * hd * 2, "float32")
    row = dict(kernel="paged_combine", case=case, pool=pool, B=b, n_splits=n_splits, pps=pps,
               reached_partials=reached, max_abs_err=err, ref_max_abs=scale,
               tol=PAGED_TOL * scale, elem_err=e_err, elem_tol=PAGED_ELEM_TOL["bfloat16"],
               ok=ok, ms=ms, device_ms=dev_ms, plain_ms=plain, library_ms=None,
               bytes=nbytes, bound_ms=bnd, bound_by=by)
    log(f"paged  {case:6s} pool={pool:8s} combine alone ({reached} partials of {n_splits} "
        f"splits) err={err:.3e} elem err {e_err:.3e} {'OK' if ok else 'FAIL'}  kernel "
        f"{ms:.4f} ms (device {dev_ms:.4f})  plain {plain:.4f} ms  library none  bound "
        f"{bnd:.5f} ms ({by})")
    return row


def gram_library(torch, x):
    """One PyTorch call for the same Gram: bf16 rows through cuBLAS's
    tensor cores with fp32 output (``torch.mm(..., out_dtype=float32)``),
    fp32 rows through the fp32 ``matmul`` (TF32 off).  Returns (fn, name)."""
    if x.dtype == torch.bfloat16:
        return (lambda: torch.mm(x.T, x, out_dtype=torch.float32)), "mm(out_dtype=fp32)"
    return (lambda: torch.matmul(x.T, x)), "fp32 matmul"


def gram_phase(torch, ops, ref):
    rows_out = []
    gen = torch.Generator(device="cuda").manual_seed(2)
    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
        for rows, n in GRAM_SHAPES:
            x = torch.randn((rows, n), generator=gen, device="cuda")
            x[:, ::97] *= 20.0  # outlier channels, as calibration taps have
            x = x.to(dt)
            before = gram_split()
            got_g, got_a = ops.gram_accumulate(x)
            want_g, want_a = ref.gram_accumulate_ref(x)
            torch.cuda.synchronize()
            after = gram_split()
            ran = next((k for k in after if after[k] > before[k]), "none")
            want_ran = "mma" if dname == "bfloat16" else "fma"
            err = float((got_g - want_g).abs().max())
            scale = float(want_g.abs().max())
            a_err = float((got_a - want_a).abs().max())
            a_scale = float(want_a.abs().max())
            e_err = ref.gram_elem_err(got_g, want_g)
            sym = bool(torch.equal(got_g, got_g.T))
            ok = (bool(torch.isfinite(got_g).all()) and err <= GRAM_TOL * scale
                  and a_err <= GRAM_TOL * a_scale and e_err <= GRAM_ELEM_TOL and sym
                  and ran == want_ran)
            del got_g, want_g
            ms = time_ms(lambda: ops.gram_accumulate(x), reps=5)
            plain = time_ms(lambda: ref.gram_accumulate_ref(x), reps=5)
            lib_fn, lib_name = gram_library(torch, x)
            lib = time_ms(lib_fn, reps=5)
            # Device time of one call (the mean of DEVICE_REPS), of the
            # library call, and for bf16 of the FMA kernel that ran these
            # rows before the mma kernel.
            dev_ms = profile_step(torch, lambda: [ops.gram_accumulate(x) for _ in range(
                DEVICE_REPS)], quiet=True)["device_busy_ms"] / DEVICE_REPS
            lib_dev = profile_step(torch, lambda: [lib_fn() for _ in range(DEVICE_REPS)],
                                   quiet=True)["device_busy_ms"] / DEVICE_REPS
            fma_dev = None
            if ran == "mma":
                fma_dev = profile_step(torch, lambda: [ops.launch(x, "fma") for _ in range(
                    DEVICE_REPS)], quiet=True)["device_busy_ms"] / DEVICE_REPS
            nbytes = x.numel() * x.element_size() + 4 * (n * n + n)
            flops = rows * n * (n + 1)  # upper triangle: products exact for bf16
            b, by = bound_ms(nbytes, flops, dname)
            row = dict(kernel="gram", dtype=dname, rows=rows, n=n, ran=ran, max_abs_err=err,
                       ref_max_abs=scale, tol=GRAM_TOL * scale, abs_sum_err=a_err,
                       abs_sum_tol=GRAM_TOL * a_scale, elem_err=e_err,
                       elem_tol=GRAM_ELEM_TOL, symmetric=sym, ok=ok, ms=ms,
                       device_ms=dev_ms, plain_ms=plain, library=lib_name, library_ms=lib,
                       library_device_ms=lib_dev, fma_device_ms=fma_dev, bytes=nbytes,
                       flops=flops, bound_ms=b, bound_by=by,
                       tflops=flops / dev_ms * 1e-9 if dev_ms > 0 else None)
            rows_out.append(row)
            fma_txt = "" if fma_dev is None else f"  fma kernel device {fma_dev:.4f}"
            log(f"gram   {dname:8s} rows={rows} n={n:<5d} {ran} err={err:.3e} (tol "
                f"{row['tol']:.3e}) |x| err={a_err:.3e} (tol {row['abs_sum_tol']:.3e}) elem "
                f"err {e_err:.3e} (tol {GRAM_ELEM_TOL:.0e}) symmetric={sym} "
                f"{'OK' if ok else 'FAIL'}  kernel {ms:.3f} ms (device {dev_ms:.4f})  plain "
                f"{plain:.3f} ms  library({lib_name}) {lib:.3f} ms (device {lib_dev:.4f})  "
                f"bound {b:.3f} ms ({by}){fma_txt}")
    return rows_out


def nested_batched_phase(torch, ops, ref):
    """The batched nested form at the MoE expert shapes, one case per route,
    per element against the batched plain version, beside two bmms over
    the experts' concatenated factors (x [u|u2] [v;v2], the single form's
    ``multi_dot`` counterpart) and the bound."""
    rows_out = []
    gen = torch.Generator(device="cuda").manual_seed(5)
    e, k1, k2 = MOE_EXPERTS, MOE_K1, MOE_K2
    r = k1 + k2
    for case, m, k_in, n, dname, route in NESTED_BATCHED_CASES:
        dt = getattr(torch, dname)

        def mk(*shape, s):
            return (torch.randn(shape, generator=gen, device="cuda") * s).to(dt)
        u, u2 = mk(e, k_in, k1, s=k_in ** -0.5), mk(e, k_in, k2, s=k_in ** -0.5)
        v, v2 = mk(e, k1, n, s=r ** -0.5), mk(e, k2, n, s=r ** -0.5)
        x = mk(e, m, k_in, s=1.0)
        x[:, m - m // 8:] = 0  # capacity slots left empty
        big_u, big_v = torch.cat([u, u2], 2), torch.cat([v, v2], 1)
        before = (nested_split(), dict(_ops("nested_lowrank").batched_by_kernel))
        got = ops.nested_lowrank_matmul_batched(x, u, v, u2, v2)
        want = ref.nested_lowrank_matmul_batched_ref(x, u, v, u2, v2)
        torch.cuda.synchronize()
        after = (nested_split(), dict(_ops("nested_lowrank").batched_by_kernel))
        ran = next((k for k in after[1] if after[1][k] > before[1][k]), "none")
        single_ran = any(after[0][k] - before[0][k] != after[1][k] - before[1][k]
                         for k in after[1])
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        e_err = elem_err(torch, got, want)
        ok = (bool(torch.isfinite(got).all()) and err <= NESTED_TOL[dname] * scale
              and e_err <= NESTED_ELEM_TOL[dname] and ran == route and not single_ran)
        del got, want

        def lib():
            return torch.bmm(torch.bmm(x, big_u), big_v)
        ms = time_ms(lambda: ops.nested_lowrank_matmul_batched(x, u, v, u2, v2))
        plain = time_ms(lambda: ref.nested_lowrank_matmul_batched_ref(x, u, v, u2, v2))
        lib_ms = time_ms(lib)
        dev_ms = profile_step(torch, lambda: [ops.nested_lowrank_matmul_batched(
            x, u, v, u2, v2) for _ in range(DEVICE_REPS)], quiet=True)["device_busy_ms"] / DEVICE_REPS
        lib_dev = profile_step(torch, lambda: [lib() for _ in range(DEVICE_REPS)],
                               quiet=True)["device_busy_ms"] / DEVICE_REPS
        el = x.element_size()
        nbytes = el * (x.numel() + u.numel() + v.numel() + u2.numel() + v2.numel() + e * m * n)
        flops = 2 * e * m * (k_in * r + r * n)
        b, by = bound_ms(nbytes, flops, dname)
        row = dict(kernel="nested_lowrank_batched", case=case, dtype=dname, E=e, M=m, K=k_in,
                   N=n, rank=r, k1=k1, k2=k2, ran=ran, max_abs_err=err, ref_max_abs=scale,
                   tol=NESTED_TOL[dname] * scale, elem_err=e_err,
                   elem_tol=NESTED_ELEM_TOL[dname], ok=ok, ms=ms, device_ms=dev_ms,
                   plain_ms=plain, library="bmm(bmm(x, [u|u2]), [v;v2])", library_ms=lib_ms,
                   library_device_ms=lib_dev, bytes=nbytes, flops=flops, bound_ms=b,
                   bound_by=by)
        rows_out.append(row)
        log(f"nested batched {dname:8s} {case:9s} E={e} C={m:<3d} {k_in}->{n} {ran:6s} "
            f"err={err:.3e} (tol {row['tol']:.3e}) elem err {e_err:.3e} (tol "
            f"{row['elem_tol']:.3e}) {'OK' if ok else 'FAIL'}  kernel {ms:.4f} ms (device "
            f"{dev_ms:.4f})  plain {plain:.3f} ms  library {lib_ms:.4f} ms (device "
            f"{lib_dev:.4f})  bound {b:.4f} ms ({by}, {nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.1f} GFLOP)")
        del x, u, v, u2, v2, big_u, big_v
    return rows_out


def gram_batched_phase(torch, ops, ref):
    """Per-expert Grams of zero-padded capacity buffers in one launch, each
    expert per element and exactly symmetric."""
    rows_out = []
    gen = torch.Generator(device="cuda").manual_seed(6)
    for e, rows, n in GRAM_BATCHED_SHAPES:
        buf = torch.randn((e, rows, n), generator=gen, device="cuda")
        buf[:, :, ::97] *= 20.0  # outlier channels
        buf[:, rows - rows // 5:] = 0  # capacity slots left empty
        buf = buf.to(torch.bfloat16)
        before = (gram_split(), _ops("gram").batched_launches)
        got_g, got_a = ops.gram_accumulate_batched(buf)
        want_g, want_a = ref.gram_accumulate_batched_ref(buf)
        torch.cuda.synchronize()
        after = (gram_split(), _ops("gram").batched_launches)
        ran = next((k for k in after[0] if after[0][k] > before[0][k]), "none")
        err = float((got_g - want_g).abs().max())
        scale = float(want_g.abs().max())
        a_err = float((got_a - want_a).abs().max())
        a_scale = float(want_a.abs().max())
        e_err = ref.gram_elem_err(got_g, want_g)
        sym = bool(torch.equal(got_g, got_g.transpose(1, 2)))
        ok = (bool(torch.isfinite(got_g).all()) and err <= GRAM_TOL * scale
              and a_err <= GRAM_TOL * a_scale and e_err <= GRAM_ELEM_TOL and sym
              and ran == "mma" and after[1] == before[1] + 1)
        del got_g, want_g
        # One PyTorch call for the same Grams: cuBLAS's bf16 tensor cores
        # with fp32 output.
        bt = buf.transpose(1, 2)
        lib_fn, lib_name = (lambda: torch.bmm(bt, buf, out_dtype=torch.float32),
                            "bmm(out_dtype=fp32)")
        ms = time_ms(lambda: ops.gram_accumulate_batched(buf), reps=5)
        plain = time_ms(lambda: ref.gram_accumulate_batched_ref(buf), reps=5)
        lib = time_ms(lib_fn, reps=5)
        dev_ms = profile_step(torch, lambda: [ops.gram_accumulate_batched(buf) for _ in range(
            DEVICE_REPS)], quiet=True)["device_busy_ms"] / DEVICE_REPS
        lib_dev = profile_step(torch, lambda: [lib_fn() for _ in range(DEVICE_REPS)],
                               quiet=True)["device_busy_ms"] / DEVICE_REPS
        nbytes = buf.numel() * buf.element_size() + 4 * e * (n * n + n)
        flops = e * rows * n * (n + 1)  # upper triangles: products exact for bf16
        b, by = bound_ms(nbytes, flops, "bfloat16")
        row = dict(kernel="gram_batched", dtype="bfloat16", E=e, rows=rows, n=n, ran=ran,
                   max_abs_err=err, ref_max_abs=scale, tol=GRAM_TOL * scale,
                   abs_sum_err=a_err, abs_sum_tol=GRAM_TOL * a_scale, elem_err=e_err,
                   elem_tol=GRAM_ELEM_TOL, symmetric=sym, ok=ok, ms=ms, device_ms=dev_ms,
                   plain_ms=plain, library=lib_name, library_ms=lib,
                   library_device_ms=lib_dev, bytes=nbytes, flops=flops, bound_ms=b,
                   bound_by=by)
        rows_out.append(row)
        log(f"gram batched E={e} rows={rows} n={n:<5d} {ran} err={err:.3e} (tol "
            f"{row['tol']:.3e}) |x| err={a_err:.3e} elem err {e_err:.3e} (tol "
            f"{GRAM_ELEM_TOL:.0e}) symmetric={sym} {'OK' if ok else 'FAIL'}  kernel {ms:.3f} "
            f"ms (device {dev_ms:.4f})  plain {plain:.3f} ms  library({lib_name}) {lib:.3f} "
            f"ms (device {lib_dev:.4f})  bound {b:.4f} ms ({by}, {nbytes / 1e6:.1f} MB)")
        del buf
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
            e_err = elem_err(torch, got, want)
            ok = (bool(torch.isfinite(got).all()) and err <= FLASH_TOL[dname] * scale
                  and e_err <= FLASH_ELEM_TOL[dname])
            del got, want
            ms = time_ms(lambda: ops.flash_attention(q, k, v))
            plain = time_ms(lambda: ref.flash_attention_ref(q, k, v), reps=3)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            lib = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True))
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
            flops = 2 * b * hq * hd * s * (s + 1)
            bnd, by = bound_ms(nbytes, flops, dname)
            tflops = flops / ms * 1e-9
            row = dict(kernel="flash_attention", dtype=dname, B=b, S=s, Hq=hq, Hkv=hkv,
                       hd=hd, max_abs_err=err, ref_max_abs=scale,
                       tol=FLASH_TOL[dname] * scale, elem_err=e_err,
                       elem_tol=FLASH_ELEM_TOL[dname], ok=ok, ms=ms, plain_ms=plain,
                       library_ms=lib, bytes=nbytes, flops=flops, bound_ms=bnd,
                       bound_by=by, tflops=tflops, bound_share=bnd / ms)
            rows_out.append(row)
            log(f"flash  {dname:8s} B={b:<2d} S={s:<4d} Hq/Hkv={hq}/{hkv} err={err:.3e} "
                f"(tol {row['tol']:.3e}) elem err {e_err:.3e} (tol {row['elem_tol']:.3e}) "
                f"{'OK' if ok else 'FAIL'}  kernel {ms:.3f} ms  "
                f"({tflops:.1f} TFLOP/s, {bnd / ms:.1%} of bound)  plain {plain:.3f} ms  "
                f"library(sdpa) {lib:.3f} ms ({flops / lib * 1e-9:.1f} TFLOP/s)  "
                f"bound {bnd:.4f} ms ({by})")
    return rows_out


def rwkv6_inputs(torch, gen, bh, t, k, dname, w_fixed):
    """r, k, v, w (BH, T, K) in ``dname`` and u (BH, K) fp32, drawn from
    ``gen``: decays uniform in (0.01, 0.999), or all ``w_fixed``."""
    r, kk, v = (torch.randn((bh, t, k), generator=gen, device="cuda") * 0.5
                for _ in range(3))
    w = (torch.full((bh, t, k), w_fixed, device="cuda") if w_fixed is not None
         else torch.rand((bh, t, k), generator=gen, device="cuda") * 0.989 + 0.01)
    u = torch.randn((bh, k), generator=gen, device="cuda") * 0.5
    return [x.to(getattr(torch, dname)) for x in (r, kk, v, w)] + [u]


def rwkv6_phase(torch, ops, ref):
    rows_out = []
    gen = torch.Generator(device="cuda").manual_seed(4)
    for case, bh, t, k, dname, w_fixed in RWKV_SHAPES:
        args = rwkv6_inputs(torch, gen, bh, t, k, dname, w_fixed)
        got, got_s = ops.rwkv6_attention(*args, return_state=True)
        want, want_s = ref.rwkv6_scan_ref(*args, return_state=True)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        s_err = float((got_s - want_s).abs().max())
        s_scale = float(want_s.abs().max())
        e_err = elem_err(torch, got, want)
        s_e_err = elem_err(torch, got_s, want_s)
        ok = (bool(torch.isfinite(got).all()) and bool(torch.isfinite(got_s).all())
              and err <= RWKV_TOL[dname] * scale and s_err <= RWKV_STATE_TOL * s_scale
              and e_err <= RWKV_ELEM_TOL[dname] and s_e_err <= RWKV_STATE_ELEM_TOL)
        del got, want, got_s, want_s
        with_state = case == "prefill"  # as the path calls it
        ms = time_ms(lambda: ops.rwkv6_attention(*args, return_state=with_state))
        plain = time_ms(lambda: ref.rwkv6_scan_ref(*args, return_state=with_state), reps=3)
        # Device time of one call (the event ms include the wrapper's host
        # time), the mean of DEVICE_REPS.
        dev = profile_step(torch, lambda: [ops.rwkv6_attention(
            *args, return_state=with_state) for _ in range(DEVICE_REPS)],
            quiet=True)["device_busy_ms"] / DEVICE_REPS
        el = args[0].element_size()
        nbytes = (5 * bh * t * k * el + 4 * bh * k
                  + (4 * bh * k * k if with_state else 0))
        # Per token: y = r (S + diag(u) k^T v) and S = diag(w) S + k^T v, a
        # multiply-add each for every element of S (4 K^2), and the bonus
        # r . (u * k) (4 K).
        flops = bh * t * (4 * k * k + 4 * k)
        bnd, by = bound_ms(nbytes, flops, dname)
        row = dict(kernel="rwkv6", case=case, dtype=dname, BH=bh, T=t, K=k,
                   w=w_fixed, with_state=with_state, max_abs_err=err,
                   ref_max_abs=scale, tol=RWKV_TOL[dname] * scale,
                   state_max_abs_err=s_err, state_tol=RWKV_STATE_TOL * s_scale,
                   elem_err=e_err, state_elem_err=s_e_err, elem_tol=RWKV_ELEM_TOL[dname],
                   state_elem_tol=RWKV_STATE_ELEM_TOL, ok=ok, ms=ms, device_ms=dev,
                   plain_ms=plain, library_ms=None, bytes=nbytes, flops=flops,
                   bound_ms=bnd, bound_by=by, bound_share=bnd / dev)
        rows_out.append(row)
        log(f"rwkv6  {dname:8s} {case:7s} BH={bh:<3d} T={t:<4d} K={k} err={err:.3e} (tol "
            f"{row['tol']:.3e}) state err={s_err:.3e} (tol {row['state_tol']:.3e}) elem err "
            f"{e_err:.3e} state {s_e_err:.3e} (tol {RWKV_ELEM_TOL[dname]:.1e}/"
            f"{RWKV_STATE_ELEM_TOL:.1e}) {'OK' if ok else 'FAIL'}  kernel {ms:.3f} ms, "
            f"device {dev:.4f} ms ({bnd / dev:.1%} of bound)  plain {plain:.3f} ms  "
            f"library none  bound {bnd:.4f} ms ({by}, {nbytes / 1e6:.1f} MB)")
    return rows_out


KERNELS = ("nested_lowrank", "paged_attention", "gram", "flash_attention", "rwkv6")


def _ops(name):
    return importlib.import_module(f"repro_torch.kernels.{name}.ops")


def reset_counts() -> None:
    for name in KERNELS:
        _ops(name).launches = 0
    fa = _ops("flash_attention")
    fa.tensor_core_launches = fa.cuda_core_launches = 0
    nlr = _ops("nested_lowrank")
    nlr.stream_launches = nlr.mma_launches = nlr.tile_launches = 0
    nlr.batched_by_kernel.update(stream=0, mma=0, tile=0)
    gram = _ops("gram")
    gram.mma_launches = gram.fma_launches = gram.batched_launches = 0
    _ops("paged_attention").combine_launches = 0
    rw = _ops("rwkv6")
    rw.vec16_launches = rw.vec4_launches = 0


def read_counts() -> dict:
    return {name: _ops(name).launches for name in KERNELS}


def flash_split_ok(counts: dict) -> tuple:
    """flash_attention's launches by kernel since ``reset_counts``, and
    whether every one ran the bf16 tensor-core kernel (the models are bf16)."""
    fa = _ops("flash_attention")
    split = {"tensor_core": fa.tensor_core_launches, "cuda_core": fa.cuda_core_launches}
    return split, split == {"tensor_core": counts["flash_attention"], "cuda_core": 0}


def rwkv6_split_ok(counts: dict) -> tuple:
    """rwkv6's launches by copy width since ``reset_counts``, and whether
    every one took 16-byte copies (the model's permuted views are aligned)."""
    rw = _ops("rwkv6")
    split = {"vec16": rw.vec16_launches, "vec4": rw.vec4_launches}
    return split, split == {"vec16": counts["rwkv6"], "vec4": 0}


def nested_split() -> dict:
    """nested_lowrank's launches by kernel since ``reset_counts``."""
    nlr = _ops("nested_lowrank")
    return {"stream": nlr.stream_launches, "mma": nlr.mma_launches,
            "tile": nlr.tile_launches}


def gram_split() -> dict:
    """gram's launches by kernel since ``reset_counts``."""
    gram = _ops("gram")
    return {"mma": gram.mma_launches, "fma": gram.fma_launches}


def batched_split() -> dict:
    """The batched forms' launches since ``reset_counts``: nested by kernel,
    gram in all (every one of them is also in the per-kernel counts)."""
    return {"nested": dict(_ops("nested_lowrank").batched_by_kernel),
            "gram": _ops("gram").batched_launches}


def nested_calls(model) -> tuple:
    """Nested-linear calls of one forward: (single form, batched form).  A
    target is one call per layer of its stack; a MoE layer's expert target
    (stacked over experts too) is one batched call per layer."""
    single = batched = 0
    for t in model.compressible_targets():
        if "experts" in t.path:
            batched += math.prod(t.stacked[:-1])
        else:
            single += math.prod(t.stacked)
    return single, batched


# Device kernels of one nested_lowrank call (both phases and reductions), of
# one gram call, and of one paged_attention call (split kernel and combine).
NESTED_KERNEL_NAMES = ("stream_partial", "mma_partial", "gemm_partial", "reduce_partials")
GRAM_KERNEL_NAMES = ("gram_mma", "gram_kernel")
PAGED_KERNEL_NAMES = ("paged_split_kernel", "paged_combine_kernel")


PROFILE_WINDOWS = 5  # profiler windows (and wall calls) a profile is the median of


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def profile_step(torch, fn, label: str = "decode step", quiet: bool = False,
                 windows: int = PROFILE_WINDOWS) -> dict:
    """Device time by kernel name and device busy share of one call of
    ``fn`` (after a warm-up call), from torch.profiler's CUDA trace: the
    median over ``windows`` profiled calls, of the windows that kept every
    kernel (the most device events; the profiler sometimes drops some),
    beside the median wall of as many calls with the profiler off.  Only
    device events are summed: an aten op's row repeats its kernels' time.
    ``quiet``: log nothing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(windows):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = _median(walls)
    seen = []
    for _ in range(windows):
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
        seen.append(per)
    n_events = [sum(n for _, n in per.values()) for per in seen]
    kept = [per for per, n in zip(seen, n_events) if n == max(n_events)]
    per = {k: (_median([p.get(k, (0.0, 0))[0] for p in kept]),
               max(p.get(k, (0.0, 0))[1] for p in kept))
           for k in set().union(*kept)}
    busy = _median([sum(ms for ms, _ in p.values()) for p in kept])
    top = sorted(per.items(), key=lambda kv: -kv[1][0])[:12]
    kernels = {k: ms for k, (ms, _) in per.items()}
    used = {"windows": windows, "windows_used": len(kept)}
    if quiet:
        return {"wall_ms": wall_ms, "device_busy_ms": busy, "kernels": kernels, **used}
    nested, gram, paged = (sum(ms for k, (ms, _) in per.items()
                               if any(name in k for name in names))
                           for names in (NESTED_KERNEL_NAMES, GRAM_KERNEL_NAMES,
                                         PAGED_KERNEL_NAMES))
    log(f"  profiled {label}: wall {wall_ms:.2f} ms (profiler off), device "
        f"busy {busy:.3f} ms ({busy / wall_ms:.1%} of wall), nested_lowrank "
        f"{nested:.3f} ms ({nested / max(busy, 1e-9):.1%} of busy), gram {gram:.3f} ms "
        f"({gram / max(busy, 1e-9):.1%}), paged_attention {paged:.4f} ms; medians of "
        f"{len(kept)} of {windows} windows")
    for name, (ms, n) in top:
        log(f"    {ms:8.3f} ms  x{n:<4d} {name[:90]}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "nested_ms": nested,
            "gram_ms": gram, "paged_ms": paged,
            "top": [{"name": k, "ms": ms, "count": n} for k, (ms, n) in top], **used}


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


def serve_path(torch, np, cfg, mixer: str, gram_taps: tuple, keep=None):
    """``serve()`` on ``cfg``: calibrate, compress (nsvd1, ratio 0.2) and
    serve 8 requests on the layout the model takes, with exact launch counts
    (``mixer``: the kernel each calibration forward runs once per layer;
    ``gram_taps``: a calibration batch's (single, batched) Gram taps); then
    one decode step's logits through the kernels against the plain
    versions, on a cache prefilled with each prompt's first 15 tokens, and
    for a MoE model one eval batch's logits through its compressed experts
    (the batched nested kernel at an eval batch's capacity).  The engine
    runs as before the scheduler (worst-case admission, pipeline depth 1),
    so counts and times compare across PRs; ``keep`` (a dict) receives the
    compressed model and params."""
    from repro_torch import kernels
    from repro_torch.launch.serve import serve
    from repro_torch.models.moe import RoutingTrace, capacity_of
    from repro_torch.serving.kvcache import PagedKVCache

    rng = np.random.default_rng(0)
    plens = rng.integers(16, 201, size=8)
    prompts = [rng.integers(2, cfg.vocab_size // 2, size=int(n)) for n in plens]
    reset_counts()
    res = serve(cfg, requests=8, max_new=32, max_batch=8, max_len=256,
                seed=0, compress=0.2, block_size=16, prefill_chunk=64,
                prompts=prompts, sched_policy="worst_case", pipeline_depth=1)
    counts = read_counts()
    split, split_ok = flash_split_ok(counts)
    rsplit, rsplit_ok = rwkv6_split_ok(counts)
    nsplit = nested_split()
    gsplit = gram_split()
    bsplit = batched_split()
    gram_ok = gsplit == {"mma": counts["gram"], "fma": 0}  # every tap is bf16
    eng, model, params, plan = res["engine"], res["model"], res["params"], res["plan"]
    if keep is not None:
        keep.update(model=model, params=params)
    st = eng.stats()
    paged = eng.layout == "paged"
    layers = cfg.num_layers
    n_single, n_batched = nested_calls(model)
    # Calibration: 256 samples in batches of 16, each one causal forward
    # (the mixer kernel once per layer, gram_taps Gram taps).  Every
    # compressed linear of every prefill call and decode step runs the
    # nested kernel (a MoE layer's experts its batched form); paged decode
    # steps run paged attention once per layer; dense admissions prefill
    # each prompt at its exact length through the mixer (paged prefill
    # chunks attend over gathered pages, as the reference, not through
    # flash_attention).
    calib_batches = 256 // 16
    expect = {"nested_lowrank": (n_single + n_batched) * (st["steps"] + st["prefill_ticks"]),
              "paged_attention": layers * st["steps"] if paged else 0,
              "gram": sum(gram_taps) * calib_batches,
              "flash_attention": 0, "rwkv6": 0}
    expect[mixer] = layers * (calib_batches + (0 if paged else st["prefill_ticks"]))
    # A decode step's compressed linears see the engine's 8 rows (bf16), a
    # prefill call its rows (paged: every chunk is max_batch x prefill_chunk
    # = 512 rows; dense: one call per prompt at its length), and a MoE
    # layer's experts the call's capacity rows; <= 16 rows run the stream
    # kernel, more the mma kernel, none the tile kernel.
    nlr = _ops("nested_lowrank")
    prefill_rows = ([8 * 64] * st["prefill_ticks"] if paged
                    else [len(p) for p in prompts])
    single_rows = [eng.max_batch] * st["steps"] + prefill_rows
    expert_rows = ([capacity_of(r, cfg) for r in single_rows] if n_batched else [])
    short = (sum(r <= nlr.STREAM_ROWS for r in single_rows),
             sum(r <= nlr.STREAM_ROWS for r in expert_rows))
    batched_expect = {"nested": {"stream": n_batched * short[1],
                                 "mma": n_batched * (len(expert_rows) - short[1]), "tile": 0},
                      "gram": gram_taps[1] * calib_batches}
    nested_expect = {"stream": n_single * short[0] + batched_expect["nested"]["stream"],
                     "mma": (n_single * (len(single_rows) - short[0])
                             + batched_expect["nested"]["mma"]), "tile": 0}
    nested_ok = (nsplit == nested_expect and bsplit == batched_expect
                 and len(prefill_rows) == st["prefill_ticks"])
    # Every paged decode step's attention also runs the combine when
    # plan_splits gives its table (max_batch rows x the table's columns)
    # more than one split.
    pa = _ops("paged_attention")
    n_splits = (pa.plan_splits(eng.kv.max_batch, cfg.num_kv_heads,
                               eng.kv.max_blocks_per_row)[0] if paged else 1)
    combine_expect = expect["paged_attention"] if n_splits > 1 else 0
    combine = pa.combine_launches
    combine_ok = combine == combine_expect
    reasons = {u: r.finish_reason for u, r in res["requests"].items()}
    outs = res["outputs"]
    ratio = factored_ratio(params, plan)
    syncs_ok = (st["host_syncs"] <= st["steps"] + st["prefill_ticks"] if paged else
                st["prefill_ticks"] == 8 and st["host_syncs"] == st["steps"] + 8)
    ok = (len(outs) == 8 and all(reasons.get(u) for u in outs)
          and all(1 <= len(v) <= 32 for v in outs.values())
          and all(0 <= t < cfg.vocab_size for v in outs.values() for t in v)
          and syncs_ok and abs(ratio - plan.achieved_ratio) < 1e-9
          and counts == expect and split_ok and rsplit_ok and nested_ok and gram_ok
          and combine_ok and expect["nested_lowrank"] > 0)
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
    log(f"  launches {counts} expected {expect}; flash_attention by kernel {split}; "
        f"nested_lowrank by kernel {nsplit} expected {nested_expect}, batched forms "
        f"{bsplit} expected {batched_expect} {'OK' if nested_ok else 'FAIL'}; gram by "
        f"kernel {gsplit} {'OK' if gram_ok else 'FAIL'}; paged combine launches {combine} "
        f"expected {combine_expect} ({n_splits} splits) {'OK' if combine_ok else 'FAIL'}; "
        f"rwkv6 by copy width {rsplit} {'OK' if rsplit_ok else 'FAIL'}; "
        f"finish reasons {sorted(set(reasons.values()))}")

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
        # The plain run takes the kernel run's expert choices (a MoE model's
        # top-k routing flips at near-ties on rounding-level differences;
        # flips counts the routings it would have changed).
        trace = RoutingTrace()
        with trace.record():
            lk = model.apply(params, nxt, mode="decode", cache=cache, cache_len=clen,
                             **extra).float()
        with kernels.plain(), trace.replay():
            lp = model.apply(params, nxt, mode="decode", cache=clone(saved),
                             cache_len=clen, **extra).float()
        step_flips = trace.flips
        prof = profile_step(torch, lambda: model.apply(
            params, nxt, mode="decode", cache=clone(saved), cache_len=clen, **extra),
            f"{eng.layout} decode step (8 rows)")
        # One prefill call as the engine makes it: paged, a chunk of 64
        # tokens for each of the 8 rows (512 nested rows; rewriting the same
        # positions each time); dense, the longest prompt's admission into a
        # fresh row cache.
        if paged:
            ptoks = torch.as_tensor(rng.integers(2, cfg.vocab_size // 2, size=(8, 64)),
                                    device="cuda")
            prof_prefill = profile_step(torch, lambda: model.apply(
                params, ptoks, mode="decode", cache=cache, cache_len=torch.zeros_like(clen),
                **extra), "paged prefill chunk (8 x 64 = 512 rows)")
        else:
            longest = max(prompts, key=len)
            ptoks = torch.as_tensor(longest[None], device="cuda")
            prof_prefill = profile_step(torch, lambda: model.apply(
                params, ptoks, mode="prefill", cache=model.init_cache(1, 256, device="cuda")),
                f"dense admission prefill ({len(longest)} rows)")
    torch.cuda.synchronize()
    step_err = float((lk - lp).abs().max())
    step_scale = float(lp.abs().max())
    agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    step_ok = (lk.shape == (8, 1, cfg.vocab_size) and bool(torch.isfinite(lk).all())
               and step_err <= STEP_LOGIT_TOL * step_scale)
    log(f"  decode-step logits kernels vs plain: max abs err {step_err:.4e} "
        f"(max |logit| {step_scale:.3f}, tol {STEP_LOGIT_TOL * step_scale:.4e}), "
        f"argmax agreement {agree:.3f}, expert routings pinned {step_flips} "
        f"{'OK' if step_ok else 'FAIL'}")
    eval_check = None
    if n_batched:
        # One (4, 2048) eval batch through the compressed model: every MoE
        # layer's experts at capacity_of(8192) rows on the batched mma
        # kernel (the dense and shared linears' 8192 rows are above the
        # gate), against the plain versions.
        etoks = torch.as_tensor(rng.integers(2, cfg.vocab_size // 2, size=(4, 2048)),
                                device="cuda")
        before = dict(_ops("nested_lowrank").batched_by_kernel)
        trace = RoutingTrace()
        with torch.no_grad():
            with trace.record():
                le = model.apply(params, etoks, mode="train")
            torch.cuda.synchronize()
            ran = {k: v - before[k] for k, v in _ops("nested_lowrank").batched_by_kernel.items()}
            with kernels.plain(), trace.replay():
                lpe = model.apply(params, etoks, mode="train")
        e_err = float((le.float() - lpe.float()).abs().max())
        e_scale = float(lpe.float().abs().max())
        e_ok = (le.shape == (4, 2048, cfg.vocab_size) and bool(torch.isfinite(le).all())
                and e_err <= EVAL_LOGIT_TOL * e_scale
                and ran == {"stream": 0, "mma": n_batched, "tile": 0})
        del le, lpe
        eval_check = dict(capacity=capacity_of(4 * 2048, cfg), batched_launches=ran,
                          max_abs_err=e_err, max_abs=e_scale, routings_pinned=trace.flips,
                          ok=e_ok)
        step_ok = step_ok and e_ok
        log(f"  compressed eval-batch logits (4 x 2048; expert capacity "
            f"{eval_check['capacity']} rows, batched launches {ran}) kernels vs plain: max "
            f"abs err {e_err:.4e} (max |logit| {e_scale:.3f}, tol "
            f"{EVAL_LOGIT_TOL * e_scale:.4e}), expert routings pinned {trace.flips} of "
            f"{4 * 2048 * len(trace.choices)} {'OK' if e_ok else 'FAIL'}")
    summary = dict(config=cfg.name, layers=layers, layout=eng.layout,
                   prompt_lengths=plens.tolist(), seconds=res["seconds"],
                   tokens=res["tokens"], tok_per_s=res["tok_per_s"], engine=st,
                   launches=counts, expected_launches=expect, flash_launches=split,
                   rwkv6_launches=rsplit,
                   nested_launches=nsplit, expected_nested_launches=nested_expect,
                   gram_launches=gsplit, batched_launches=bsplit,
                   expected_batched_launches=batched_expect, eval_check=eval_check,
                   paged_splits=n_splits,
                   paged_combine_launches=combine,
                   expected_paged_combine_launches=combine_expect,
                   finish_reasons=reasons,
                   achieved_ratio=plan.achieved_ratio, factored_ratio=ratio,
                   step_logit_max_abs_err=step_err, step_logit_max_abs=step_scale,
                   step_argmax_agreement=agree, step_routings_pinned=step_flips,
                   step_profile=prof,
                   prefill_profile=prof_prefill,
                   ok=bool(ok and step_ok))
    return summary, counts


# The sched_serve path: 16 requests (prompts of 16-200 tokens from seed 0,
# 48 new tokens each) on the serve path's compressed model, max_batch 8,
# max_len 256 (a 16-column table: plan_splits as on the serve path), block
# 16, prefill chunk 64.  (run, SchedulerConfig fields, pipeline depth, pool
# in blocks (None: 128, worst-case capacity for 8 rows), defrag every N
# consumed steps, 4 requests interactive and submitted after 10 steps).
# A is the engine as it was before the scheduler: worst case, depth 1, slot
# order; B_unsorted is B without row order (the launches order adds).
SCHED_REQUESTS, SCHED_MAX_NEW, SCHED_POOL = 16, 48, 56
SCHED_LATE, SCHED_LATE_AFTER = 4, 10
SCHED_RUNS = (("A", {"admission": "worst_case", "sort_decode_rows": False}, 1, None, 0, False),
              ("B", {}, 2, None, 0, False),
              ("B_unsorted", {"sort_decode_rows": False}, 2, None, 0, False),
              ("C", {"resume": "swap"}, 2, SCHED_POOL, 8, False),
              ("D", {"priority_classes": ("interactive", "batch")}, 4, SCHED_POOL, 0, True))
# Each run's decode steps, prefill chunk calls and preemptions (priority
# ones apart), from the engine's bookkeeping alone: no request has an eos,
# so every count depends only on the prompt lengths (a CPU run of the same
# engine at a tiny width gives them).  Launches follow from them.
SCHED_PREDICTED = {"A": (99, 9, 0, 0), "B": (100, 8, 0, 0), "B_unsorted": (100, 8, 0, 0),
                   "C": (151, 14, 13, 0), "D": (156, 36, 13, 7)}


def ring_window(torch, eng, label: str, windows: int = PROFILE_WINDOWS) -> dict:
    """Two consecutive ``step()`` calls of a serving engine with all its rows
    decoding, profiled: the device's largest idle gap (the gap between the
    two steps' work), its idle share of the span from the first device
    event to the last, and device events a step; medians over the windows
    that kept the most events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    seen = []
    for _ in range(windows):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            eng.step()
            eng.step()
            torch.cuda.synchronize()
        iv = sorted((ev.time_range.start, ev.time_range.end) for ev in prof.events()
                    if ev.device_type == DeviceType.CUDA)  # kernels and copies
        gaps, end = [], iv[0][1] if iv else 0.0
        for a, b in iv[1:]:
            if a > end:
                gaps.append(a - end)
            end = max(end, b)
        span = end - iv[0][0] if iv else 0.0
        seen.append((len(iv), max(gaps, default=0.0), sum(gaps), span))
    most = max(n for n, *_ in seen)
    kept = [w for w in seen if w[0] == most]
    out = {"windows": windows, "windows_used": len(kept), "events_per_step": most / 2,
           "largest_gap_ms": _median([w[1] for w in kept]) / 1e3,
           "idle_ms": _median([w[2] for w in kept]) / 1e3,
           "span_ms": _median([w[3] for w in kept]) / 1e3}
    out["idle_share"] = out["idle_ms"] / max(out["span_ms"], 1e-9)
    log(f"  ring window {label} (two decode steps, depth {eng.pipeline_depth}): largest "
        f"device idle gap {out['largest_gap_ms']:.3f} ms, idle {out['idle_ms']:.3f} of "
        f"{out['span_ms']:.3f} ms ({out['idle_share']:.1%}), {out['events_per_step']:.0f} "
        f"device events a step; medians of {len(kept)} of {windows} windows")
    return out


def sched_run(torch, np, model, params, prompts, label, kw, depth, pool, defrag_every,
              late) -> dict:
    """One engine run of the sched_serve path, its launch counts read
    around it; every dispatch runs under torch's sync-debug mode "error"."""
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.scheduler import SchedulerConfig

    eng = ServingEngine(model, params, max_batch=8, max_len=256, seed=0, block_size=16,
                        num_blocks=pool, prefill_chunk=64, pipeline_depth=depth,
                        sched_config=SchedulerConfig(**kw))
    checked = [0]
    dispatch = eng._dispatch_decode

    def dispatch_checked():
        torch.cuda.set_sync_debug_mode("error")
        try:
            dispatch()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        checked[0] += 1

    eng._dispatch_decode = dispatch_checked
    n_late = SCHED_LATE if late else 0
    cls = {"latency_class": "batch"} if late else {}
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    uids = [eng.submit(p, max_new_tokens=SCHED_MAX_NEW, **cls)
            for p in prompts[:SCHED_REQUESTS - n_late]]
    if late:
        while len(eng.step_times) < SCHED_LATE_AFTER:
            eng.run(max_steps=1)
        uids += [eng.submit(p, max_new_tokens=SCHED_MAX_NEW, latency_class="interactive")
                 for p in prompts[SCHED_REQUESTS - n_late:]]
    moved = defrags = 0
    next_defrag = defrag_every
    for _ in range(100_000):
        if len(eng.finished_requests) == SCHED_REQUESTS:
            break
        eng.run(max_steps=1)
        if defrag_every and len(eng.step_times) >= next_defrag:
            moved += eng.defrag()
            defrags += 1
            next_defrag += defrag_every
    eng.drain()  # steps dispatched after the last finish
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, nsplit = read_counts(), nested_split()
    combine = _ops("paged_attention").combine_launches
    reqs = [eng.finished_requests.get(u) for u in uids]
    st, sch = eng.stats(), eng.scheduler_stats()
    n_tok = sum(len(r.generated) for r in reqs if r is not None)
    return {"outputs": [r.generated if r else None for r in reqs],
            "preempted": [bool(r and r.preemptions) for r in reqs],
            "finished": all(r is not None and r.finish_reason == "stop"
                            and len(r.generated) == SCHED_MAX_NEW for r in reqs),
            "summary": dict(scheduler=dict(kw, pipeline_depth=depth, num_blocks=pool),
                            seconds=wall, tokens=n_tok, tok_per_s=n_tok / wall, stats=st,
                            scheduler_stats=sch, cache_stats=eng.cache_stats(),
                            launches=counts, nested_launches=nsplit,
                            paged_combine_launches=combine, checked_dispatches=checked[0],
                            defrags=defrags, defrag_moved=moved)}


def teacher_margins(torch, np, model, params, prompts, streams) -> list:
    """Per request, one teacher-forced forward over its prompt and
    ``streams``' tokens: at each generated position, the top-2 logit margin
    and the gate (STEP_LOGIT_TOL of max |logit|) the margin rule holds it
    to.  Two flash_attention launches a forward."""
    out = []
    for p, s in zip(prompts, streams):
        seq = torch.as_tensor(np.concatenate([p, s[:-1]])[None],
                              device=params["embed"]["table"].device)
        with torch.no_grad():
            lg = model.apply(params, seq, mode="train")[0, len(p) - 1:].float()
        top2 = torch.topk(lg, 2, dim=-1).values
        out.append(((top2[:, 0] - top2[:, 1]).cpu().numpy(),
                    (STEP_LOGIT_TOL * lg.abs().amax(-1)).cpu().numpy()))
    return out


def margin_row(got, want, margins) -> dict:
    """A stream against the uninterrupted run's: equal (as far as ``got``
    goes), or its first difference where that run's top-2 margin is within
    the gate (a re-prefill recomputes the context's KV through the chunk
    path, which rounds otherwise)."""
    row = {"equal": got == want[:len(got)]}
    if row["equal"]:
        row["ok"] = True
        return row
    j = next(k for k, (a, b) in enumerate(zip(got, want)) if a != b)
    margin, gate = float(margins[0][j]), float(margins[1][j])
    row.update(first_diff=j, margin=margin, gate=gate, ok=margin <= gate)
    return row


def sched_serve_path(torch, np, served):
    """The reference engine's serving policy at Mistral-7B width on the
    serve path's compressed model: runs A-D (SCHED_RUNS) on the same 16
    prompts; B, B_unsorted and C equal A token for token, as does every
    request of D never preempted, and a re-prefilled one first differs
    from A, if at all, where A's top-2 margin is within the step's gate;
    C and D preempt at least 3 times, C swaps and defrag moves blocks, D
    preempts for a higher class; launch counts as predicted; no dispatch
    synchronises.  Then ring windows of two decode steps at depths 1
    (A), 2 (B) and 2 without row order.  Hands the prompts, A's streams
    and their teacher-forced margins on to the fault path in ``served``."""
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.scheduler import SchedulerConfig

    model, params = served["model"], served["params"]
    cfg = model.cfg
    rng = np.random.default_rng(0)
    plens = rng.integers(16, 201, size=SCHED_REQUESTS)
    prompts = [rng.integers(2, cfg.vocab_size // 2, size=int(n)) for n in plens]
    n_single, _ = nested_calls(model)
    layers = cfg.num_layers
    runs, ok = {}, True
    for label, kw, depth, pool, defrag_every, late in SCHED_RUNS:
        r = sched_run(torch, np, model, params, prompts, label, kw, depth, pool,
                      defrag_every, late)
        sm, st, sch = r["summary"], r["summary"]["stats"], r["summary"]["scheduler_stats"]
        steps, ticks = st["steps"], st["prefill_ticks"]
        predicted = SCHED_PREDICTED[label]
        got = (steps, ticks, sch["preempt_count"], sch["priority_preemptions"])
        expect = {"nested_lowrank": n_single * (steps + ticks),
                  "paged_attention": layers * steps, "gram": 0, "flash_attention": 0,
                  "rwkv6": 0}
        nested_expect = {"stream": n_single * steps, "mma": n_single * ticks, "tile": 0}
        run_ok = (r["finished"] and got == predicted and sm["launches"] == expect
                  and sm["nested_launches"] == nested_expect
                  and sm["paged_combine_launches"] == layers * steps
                  and sm["checked_dispatches"] == steps and st["decode_syncs"] == steps
                  and st["swap_syncs"] == (sch["preempt_count"] if kw.get("resume") == "swap"
                                           else 0)
                  and sch["swap_fallbacks"] == 0)
        sm.update(expected_launches=expect, expected_nested_launches=nested_expect,
                  predicted=dict(zip(("steps", "prefill_ticks", "preemptions",
                                      "priority_preemptions"), predicted)))
        log(f"  run {label} ({sm['scheduler']}): {sm['tokens']} tokens in "
            f"{sm['seconds']:.2f} s = {sm['tok_per_s']:.1f} tok/s; steps {steps}, prefill "
            f"calls {ticks}, preemptions {sch['preempt_count']} (priority "
            f"{sch['priority_preemptions']}), predicted {predicted}; resumes "
            f"{sch['resumes']}, grown blocks {sch['grown_blocks']}, swap "
            f"{sch['swap_bytes'] / 1e6:.2f} MB, defrag moved {sm['defrag_moved']} blocks in "
            f"{sm['defrags']} calls, table uploads {sm['cache_stats']['table_uploads']}; "
            f"host syncs {st['host_syncs']} (decode {st['decode_syncs']}, swap "
            f"{st['swap_syncs']} apart), dispatches checked {sm['checked_dispatches']}; "
            f"step p50 {st['step_p50_s'] * 1e3:.2f} p90 {st['step_p90_s'] * 1e3:.2f} ms = "
            f"dispatch {st['step_dispatch_s'] * 1e3:.2f} + device wait "
            f"{st['step_device_wait_s'] * 1e3:.2f} + host {st['step_host_s'] * 1e3:.2f} ms "
            f"(means); launches {sm['launches']} nested {sm['nested_launches']} combine "
            f"{sm['paged_combine_launches']} {'OK' if run_ok else 'FAIL'}")
        ok = ok and run_ok
        runs[label] = r
    want = runs["A"]["outputs"]
    exact = {k: runs[k]["outputs"] == want for k in ("B", "B_unsorted", "C")}
    pressure = {"C": (runs["C"]["summary"]["scheduler_stats"]["preempt_count"] >= 3
                      and runs["C"]["summary"]["scheduler_stats"]["swap_bytes"] > 0
                      and runs["C"]["summary"]["defrag_moved"] > 0),
                "D": (runs["D"]["summary"]["scheduler_stats"]["preempt_count"] >= 3
                      and runs["D"]["summary"]["scheduler_stats"]["priority_preemptions"] >= 1)}
    # D: never-preempted requests exact; re-prefilled ones by the margin rule
    # on A's teacher-forced margins (one forward a request, kept for the
    # fault path).
    fa_before = _ops("flash_attention").launches
    margins = teacher_margins(torch, np, model, params, prompts, want)
    d_rows = []
    for i, (got, pre) in enumerate(zip(runs["D"]["outputs"], runs["D"]["preempted"])):
        if not pre:
            d_rows.append({"request": i, "preempted": False, "equal": got == want[i],
                           "ok": got == want[i]})
        else:
            d_rows.append(dict(margin_row(got, want[i], margins[i]), request=i,
                               preempted=True))
    margin_rows = [r for r in d_rows if r["preempted"] and not r["equal"]]
    d_ok = all(r["ok"] for r in d_rows)
    log(f"  exact against A: {exact}; pressure {pressure}; D: "
        f"{sum(r['preempted'] for r in d_rows)} re-prefilled requests, "
        f"{len(margin_rows)} differ from A, margins (first diff, margin, gate) "
        f"{[(r['request'], r['first_diff'], round(r['margin'], 4), round(r['gate'], 4)) for r in margin_rows]}; "
        f"never-preempted equal {all(r['equal'] for r in d_rows if not r['preempted'])}; "
        f"flash launches of the {len(margins)} teacher-forced forwards "
        f"{_ops('flash_attention').launches - fa_before} {'OK' if d_ok else 'FAIL'}")
    served["sched"] = {"prompts": prompts, "outputs": want, "margins": margins}
    # Ring windows: a fresh engine per setting with 8 rows decoding.
    windows = {}
    for label, kw, depth in (("A", SCHED_RUNS[0][1], 1), ("B", {}, 2),
                             ("B_unsorted", {"sort_decode_rows": False}, 2)):
        eng = ServingEngine(model, params, max_batch=8, max_len=256, seed=0, block_size=16,
                            prefill_chunk=64, pipeline_depth=depth,
                            sched_config=SchedulerConfig(**kw))
        for p in prompts[:8]:
            eng.submit(p, max_new_tokens=SCHED_MAX_NEW)
        while eng.sched or eng._prefilling:
            eng.run(max_steps=1)
        eng.step()
        windows[label] = ring_window(torch, eng, label)
        windows[label]["step_p50_ms"] = runs[label]["summary"]["stats"]["step_p50_s"] * 1e3
        eng.drain()
    added = windows["B"]["events_per_step"] - windows["B_unsorted"]["events_per_step"]
    log(f"  row order adds {added:.0f} device events a step; step p50 with it "
        f"{windows['B']['step_p50_ms']:.2f} ms, without {windows['B_unsorted']['step_p50_ms']:.2f}")
    summary = dict(config=cfg.name, layers=layers, prompt_lengths=plens.tolist(),
                   runs={k: v["summary"] for k, v in runs.items()},
                   preempted={k: v["preempted"] for k, v in runs.items()},
                   exact_against_A=exact, pressure=pressure, reprefilled=d_rows,
                   margin_rows=len(margin_rows), ring_windows=windows,
                   row_order_added_events=added,
                   ok=bool(ok and all(exact.values()) and all(pressure.values()) and d_ok))
    return summary, runs["B"]["summary"]["launches"]


# Phase 4c (fault_serve): runs F1-F4 on the sched_serve path's model, its
# 16 prompts and 48 new tokens, on demand at depth 2 (max_batch 8, max_len
# 256, block 16, chunk 64).  Each spec is (kind, step, uid, delay_s); the
# steps and uids come from a CPU run of the same engine and plans at a tiny
# width, so every spec finds its site: F1 (128 blocks, one retry with a
# 2-step backoff) poisons request 3 twice (a retry, then "error") and
# request 5 once (a retry that finishes), fails three reservations (the
# first at admission) and stalls one token copy after the watchdog's 8
# clean steps; F2 (56 blocks, swap resume) corrupts two swap payloads, the
# second matched to its uid; F3 (FAULT_F3) sheds two requests past their
# deadline, keeps one with an hour's, cancels a queued, a prefilling and a
# live request, drains after FAULT_F3["drain_after"] steps and closes; F4
# warms on two requests, then arms a 0.2 s step timeout and stalls one
# copy 0.3 s.
FAULT_STALL_S, FAULT_TIMEOUT_S, FAULT_TIMEOUT_STALL_S = 0.05, 0.2, 0.3
FAULT_SPECS = {
    "F1": (("poison_logits", 4, 3, 0.25), ("poison_logits", 20, 3, 0.25),
           ("poison_logits", 8, 5, 0.25), ("alloc_fail", 0, None, 0.25),
           ("alloc_fail", 12, None, 0.25), ("alloc_fail", 30, None, 0.25),
           ("straggler", 10, None, FAULT_STALL_S)),
    "F2": (("swap_corrupt", 0, None, 0.25), ("swap_corrupt", 60, 11, 0.25)),
    "F3": (),
    "F4": (("straggler", 60, None, FAULT_TIMEOUT_STALL_S),),
}
FAULT_F3 = {"deadline": (0, 1), "hour": 2, "queued": 15, "prefill": 9, "live": 4,
            "live_after": 20, "drain_after": 40}
FAULT_F4_WARM = 2  # requests served before the timeout is armed; 2 more follow
# (dispatched decode steps, consumed steps, prefill chunk calls, preemptions)
# and the finish reasons other than "stop", from the CPU run.
FAULT_PREDICTED = {"F1": (104, 104, 15, 0), "F2": (151, 151, 21, 13),
                   "F3": (71, 71, 7, 0), "F4": (60, 59, 5, 0)}
FAULT_REASONS = {"F1": {3: "error"}, "F2": {},
                 "F3": {0: "deadline", 1: "deadline", 4: "cancelled", 9: "cancelled",
                        12: "shutdown", 13: "shutdown", 14: "shutdown", 15: "cancelled"},
                 "F4": {2: "shutdown", 3: "shutdown"}}


def fault_run(torch, np, model, params, prompts, label) -> dict:
    """One run of the fault path on a fresh engine, its launch counts read
    around it; on the card every dispatch runs under sync-debug "error"."""
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.faults import FaultPlan, FaultPolicy, FaultSpec, ServingFault
    from repro_torch.serving.scheduler import SchedulerConfig

    cuda = params["embed"]["table"].device.type == "cuda"
    specs = [FaultSpec(kind, step, uid, delay) for kind, step, uid, delay in FAULT_SPECS[label]]
    plan = FaultPlan(specs)
    policy = FaultPolicy(max_retries=1, retry_backoff_steps=2) if label == "F1" else None
    eng = ServingEngine(model, params, max_batch=8, max_len=256, seed=0, block_size=16,
                        num_blocks=SCHED_POOL if label == "F2" else None,
                        prefill_chunk=64, pipeline_depth=2,
                        sched_config=SchedulerConfig(resume="swap" if label == "F2"
                                                     else "reprefill"),
                        faults=plan, fault_policy=policy)
    checked = [0]
    dispatch = eng._dispatch_decode

    def dispatch_checked():
        if cuda:
            torch.cuda.set_sync_debug_mode("error")
        try:
            dispatch()
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode("default")
        checked[0] += 1

    eng._dispatch_decode = dispatch_checked

    def steps_to(n):
        while len(eng.step_times) < n and (eng.sched or eng._prefilling or eng.active.any()):
            eng.run(max_steps=1)

    def submit(idx, **kw):
        return [eng.submit(prompts[i], max_new_tokens=SCHED_MAX_NEW, **kw) for i in idx]

    if cuda:
        torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    log_ = {}
    raised = None
    if label in ("F1", "F2"):
        uids = submit(range(SCHED_REQUESTS))
        eng.run()
    elif label == "F3":
        f3 = FAULT_F3
        uids = []
        for i in range(SCHED_REQUESTS):
            dl = (1e-3 if i in f3["deadline"] else 3600.0 if i == f3["hour"] else None)
            uids += submit([i], deadline_s=dl)
        log_["queued"] = eng.cancel(f3["queued"])
        time.sleep(0.01)  # past the two short deadlines
        eng.run(max_steps=1)
        log_["prefilling"] = any(t.req.uid == f3["prefill"] for t in eng._prefilling)
        log_["prefill"] = eng.cancel(f3["prefill"])
        steps_to(f3["live_after"])
        log_["ring_at_live_cancel"] = len(eng._ring)
        log_["live"] = eng.cancel(f3["live"])
        steps_to(f3["drain_after"])
        eng.request_drain()
        eng.run()
        eng.close()
        eng.close()
        try:
            eng.submit(prompts[0])
            log_["submit_after_close"] = "accepted"
        except RuntimeError:
            log_["submit_after_close"] = "raised"
    else:
        uids = submit(range(FAULT_F4_WARM))
        eng.run()
        eng._fault_policy = dataclasses.replace(eng._fault_policy,
                                                step_timeout_s=FAULT_TIMEOUT_S)
        uids += submit(range(FAULT_F4_WARM, 2 * FAULT_F4_WARM))
        try:
            eng.run()
        except ServingFault as e:
            raised = e
        eng.close()
    eng.drain()
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, nsplit = read_counts(), nested_split()
    reqs = [eng.finished_requests.get(u) for u in uids]
    st, sch, fs = eng.stats(), eng.scheduler_stats(), eng.fault_stats()
    if raised is not None:
        # The raising step's tokens are never committed, and close() commits
        # the steps still in flight after it (as the reference does), so a
        # stream is held to A only as far as it went at the raise.
        log_["raised"] = {"kind": raised.kind, "step": raised.step,
                          "snapshot_json_bytes": len(json.dumps(raised.snapshot)),
                          "committed": {s["uid"]: s["generated"]
                                        for s in raised.snapshot["slots"] if s}}
    return {"outputs": [r.generated if r else None for r in reqs],
            "reasons": [r.finish_reason if r else None for r in reqs],
            "retried": [bool(r and r.retries) for r in reqs],
            "preempted": [bool(r and r.preemptions) for r in reqs],
            "plan": plan, "log": log_,
            "summary": dict(seconds=wall, stats=st, scheduler_stats=sch,
                            fault_stats=fs, fired=[(sp.kind, sp.uid, step)
                                                   for sp, step in plan.fired_log],
                            outstanding=[sp.kind for sp in plan.outstanding()],
                            dispatches=checked[0], launches=counts, nested_launches=nsplit,
                            paged_combine_launches=_ops("paged_attention").combine_launches,
                            lifecycle=log_)}


def fault_check(label, r, want, margins) -> dict:
    """F1-F4's checks but the launches: streams by the exact and margin
    rules, finish reasons, the plan's accounting, the lifecycle calls' and
    the timeout's results, and the predicted counts ("ok": all of them)."""
    from repro_torch.serving.faults import FINISH_REASONS

    sm, plan = r["summary"], r["plan"]
    fs, st, sch = sm["fault_stats"], sm["stats"], sm["scheduler_stats"]
    fired = plan.counts()
    targeted = {sp.uid for sp, _ in plan.fired_log if sp.uid is not None}
    cut = r["log"].get("raised", {}).get("committed", {})
    rows = []
    for i, (got, reason) in enumerate(zip(r["outputs"], r["reasons"])):
        plain = not (i in targeted or r["retried"][i] or r["preempted"][i])
        row = margin_row((got or [])[:cut.get(i)], want[i], margins[i])
        if plain:
            row["ok"] = row["equal"]
        want_reason = FAULT_REASONS[label].get(i, "stop")
        row.update(request=i, plain=plain, reason=reason,
                   reason_ok=reason == want_reason and reason in FINISH_REASONS,
                   length_ok=(len(got or []) == SCHED_MAX_NEW) == (reason == "stop"))
        rows.append(row)
    reasons = list(FAULT_REASONS[label].values())
    accounting = {
        "injected": fs["injected"] == fired,
        "poison": fs["retried"] + fs["quarantined"] == fired.get("poison_logits", 0),
        "swap": fs["swap_fallbacks"] == fired.get("swap_corrupt", 0),
        "shed": fs["shed"] == reasons.count("deadline") + reasons.count("shutdown"),
        "cancelled": fs["cancelled"] == reasons.count("cancelled"),
        "outstanding": not plan.outstanding(),
        "straggler": fs["straggler_slow"] >= (1 if "straggler" in fired else 0),
    }
    life = r["log"]
    lifecycle_ok = {
        "F3": (life.get("queued") is True and life.get("prefilling") is True
               and life.get("prefill") is True and life.get("live") is True
               and life.get("ring_at_live_cancel", 0) >= 1
               and life.get("submit_after_close") == "raised"),
        "F4": life.get("raised", {}).get("kind") == "step_timeout"}.get(label, True)
    got = (sm["dispatches"], st["steps"], st["prefill_ticks"], sch["preempt_count"])
    counts_ok = got == FAULT_PREDICTED[label]
    return {"rows": rows, "accounting": accounting, "counts": got, "counts_ok": counts_ok,
            "lifecycle_ok": lifecycle_ok,
            "ok": (counts_ok and lifecycle_ok and all(accounting.values())
                   and all(x["ok"] and x["reason_ok"] and x["length_ok"] for x in rows))}


def fault_serve_path(torch, np, served):
    """The serving engine's fault tolerance at Mistral-7B width (phase 4c):
    runs F1-F4 (FAULT_SPECS) on the sched_serve path's compressed model and
    prompts, held to its run A's streams and teacher-forced margins; every
    finish reason, the plan's accounting, the predicted counts and launches,
    no sync in any dispatch.  Then the finite check's device time alone on
    the decode step's 8-row logits, and a profiled decode step."""
    from repro_torch.launch.steps import POISON_TOKEN
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.scheduler import SchedulerConfig

    model, params = served.pop("model"), served.pop("params")
    base = served.pop("sched")
    prompts, want, margins = base["prompts"], base["outputs"], base["margins"]
    cfg = model.cfg
    n_single, _ = nested_calls(model)
    layers = cfg.num_layers
    runs, ok = {}, True
    for label in FAULT_SPECS:
        r = fault_run(torch, np, model, params, prompts, label)
        chk = fault_check(label, r, want, margins)
        sm = r["summary"]
        d, ticks = sm["dispatches"], chk["counts"][2]
        expect = {"nested_lowrank": n_single * (d + ticks), "paged_attention": layers * d,
                  "gram": 0, "flash_attention": 0, "rwkv6": 0}
        nested_expect = {"stream": n_single * d, "mma": n_single * ticks, "tile": 0}
        run_ok = (chk["ok"] and sm["launches"] == expect
                  and sm["nested_launches"] == nested_expect
                  and sm["paged_combine_launches"] == layers * d)
        sm.update(check=chk, expected_launches=expect, expected_nested_launches=nested_expect,
                  predicted=FAULT_PREDICTED[label], ok=run_ok)
        margin_rows = [(x["request"], x["first_diff"], round(x["margin"], 4), round(x["gate"], 4))
                       for x in chk["rows"] if not x["equal"]]
        log(f"  run {label}: {sm['seconds']:.2f} s; dispatches / steps / prefill calls / "
            f"preemptions {chk['counts']} predicted {FAULT_PREDICTED[label]}; fired "
            f"{sm['fired']}; outstanding {sm['outstanding']}; faults "
            f"{ {k: v for k, v in sm['fault_stats'].items() if k != 'degraded'} }; "
            f"accounting {chk['accounting']}; reasons "
            f"{ {i: x['reason'] for i, x in enumerate(chk['rows']) if x['reason'] != 'stop'} }; "
            f"exact {sum(x['equal'] for x in chk['rows'])}/{len(chk['rows'])}, margin rows "
            f"{margin_rows}; "
            f"lifecycle {r['log']}; dispatches checked {sm['dispatches']}; step p50 "
            f"{sm['stats']['step_p50_s'] * 1e3:.2f} ms; launches {sm['launches']} nested "
            f"{sm['nested_launches']} combine {sm['paged_combine_launches']} "
            f"{'OK' if run_ok else 'FAIL'}")
        ok = ok and run_ok
        runs[label] = r
    # The always-on finite check alone (isfinite().all(-1) and the two
    # wheres) on the decode step's 8-row logits, and a whole decode step of
    # an engine with 8 rows live (depth 1), profiled.
    dev = params["embed"]["table"].device
    gen = torch.Generator(device=dev).manual_seed(0)
    logits = torch.randn((8, 1, cfg.vocab_size), generator=gen, device=dev).to(torch.bfloat16)
    act = torch.ones(8, dtype=torch.bool, device=dev)
    tok = torch.zeros(8, dtype=torch.int32, device=dev)

    def finite_check():
        bad = act & ~torch.isfinite(logits[:, 0]).all(-1)
        return torch.where(bad, POISON_TOKEN, tok), act & ~bad

    check = profile_step(torch, finite_check, quiet=True)
    eng = ServingEngine(model, params, max_batch=8, max_len=256, seed=0, block_size=16,
                        prefill_chunk=64, pipeline_depth=1,
                        sched_config=SchedulerConfig(admission="worst_case",
                                                     sort_decode_rows=False))
    for p in prompts[:8]:
        eng.submit(p, max_new_tokens=SCHED_MAX_NEW)
    while eng.sched or eng._prefilling:
        eng.run(max_steps=1)
    state = (eng.cache_len.clone(), eng.budget_dev.clone(), eng.key_data.clone(),
             eng.active_dev.clone(), *eng._host_inputs())
    step = profile_step(torch, lambda: eng._decode(params, eng.kv.pools, eng.kv.table_device(),
                                                   eng.last_token, *state),
                        label="decode step (engine, finite check included)")
    window = ring_window(torch, eng, "fault_serve (depth 1, worst case)")
    eng.drain()
    log(f"  finite check alone: device {check['device_busy_ms']:.4f} ms ({check['kernels']}); "
        f"decode step: device {step['device_busy_ms']:.3f} ms, {window['events_per_step']:.0f} "
        f"device events a step (measured earlier, in another call: the model's decode "
        f"0.918 ms, 299 events a step)")
    summary = dict(config=cfg.name, layers=layers,
                   runs={k: v["summary"] for k, v in runs.items()},
                   finite_check=check, decode_step=step, ring_window=window,
                   seconds={k: v["summary"]["seconds"] for k, v in runs.items()}, ok=bool(ok))
    return summary, runs["F1"]["summary"]["launches"]


def quality_path(torch, np, cfg, eval_n: int, gram_taps: tuple, mixer: str):
    """``build_entry`` on ``cfg`` with exact launch counts (``mixer``: the
    kernel every causal forward runs once per layer, flash_attention or
    rwkv6; ``gram_taps``: a calibration batch's (single, batched) Gram
    taps), then one eval batch's logits through the kernels against the
    plain versions, and profiles of an eval forward and a calibration batch."""
    from repro_torch import kernels
    from repro_torch.calib.gram import accumulate_taps
    from repro_torch.calib.runner import calibration_batches, collect_grams
    from repro_torch.eval.perplexity import eval_batches
    from repro_torch.models import build_model
    from repro_torch.models.moe import RoutingTrace, capacity_of
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
    split, split_ok = flash_split_ok(counts)
    rsplit, rsplit_ok = rwkv6_split_ok(counts)
    gsplit = gram_split()
    nsplit, bsplit = nested_split(), batched_split()
    gram_ok = gsplit == {"mma": counts["gram"], "fma": 0}  # every tap is bf16
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # Causal forwards: calibration, dense and compressed ppl per domain, the
    # two forwards of each KL batch (logit KL, then each target's patch), and
    # 2 domains x 4 batches of activation similarity.
    n_targets = len(model.compressible_targets())
    forwards = (256 // 16 + 2 * len(EVAL_DOMAINS) * eval_n + 2 * eval_n
                + 2 * n_targets * attr_n + 2 * 4)
    # Eval batches have 8192 rows, above the nested kernel's 1024-row gate
    # (the reference's): compressed linears run as plain matmuls there.  A
    # MoE layer's experts see capacity_of(8192) rows each (960 at 64
    # experts, top-6), under the gate: every compressed forward (ppl on each
    # domain, the KL batches) runs them through the batched mma kernel, and
    # each expert target's attribution patch runs that target alone.
    _, n_batched = nested_calls(model)
    expert_calls = 0
    if n_batched and capacity_of(eval_b * eval_s, cfg) <= _ops("nested_lowrank").MAX_KERNEL_ROWS:
        expert_calls = (n_batched * (len(EVAL_DOMAINS) + 1) * eval_n
                        + sum(math.prod(t.stacked[:-1]) for t in model.compressible_targets()
                              if "experts" in t.path) * attr_n)
    expect = {"nested_lowrank": expert_calls, "paged_attention": 0, "flash_attention": 0,
              "rwkv6": 0, "gram": sum(gram_taps) * (256 // 16)}
    expect[mixer] = cfg.num_layers * forwards
    batched_expect = {"nested": {"stream": 0, "mma": expert_calls, "tile": 0},
                      "gram": gram_taps[1] * (256 // 16)}
    nested_ok = (nsplit == {"stream": 0, "mma": expert_calls, "tile": 0}
                 and bsplit == batched_expect)
    tot = entry["decomposition"]
    numbers = [*entry["dense_ppl"].values(), *entry["compressed_ppl"].values(),
               *entry["ppl_ratio"].values(), entry["logit_kl"], entry["achieved_ratio"],
               *(r["logit_kl"] for r in entry["attribution"]),
               entry["activation_similarity"]["mean"], *tot.values()]
    finite = all(math.isfinite(float(x)) for x in numbers)
    ratio_ok = abs(tot["achieved_ratio"] - entry["achieved_ratio"]) < 1e-9
    ok = (finite and ratio_ok and counts == expect and split_ok and rsplit_ok and gram_ok
          and nested_ok and len(entry["attribution"]) == n_targets)
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
    log(f"  launches {counts} expected {expect}; flash_attention by kernel {split}; "
        f"gram by kernel {gsplit} {'OK' if gram_ok else 'FAIL'}; nested by kernel {nsplit}, "
        f"batched forms {bsplit} expected {batched_expect} {'OK' if nested_ok else 'FAIL'}; "
        f"rwkv6 by copy width {rsplit} {'OK' if rsplit_ok else 'FAIL'}; Gram-fallback "
        f"slices {tot['gram_fallback_slices']}; all numbers finite: {finite}")

    # One eval batch's dense logits through the kernels vs the plain versions.
    toks = torch.as_tensor(next(eval_batches(cfg.vocab_size, "en_a", 1, eval_b, eval_s)),
                           device="cuda")
    trace = RoutingTrace()  # the plain run routes as the kernel run (serve_path)
    with torch.no_grad():
        with trace.record():
            lk = model.apply(params, toks, mode="train").float()
        with kernels.plain(), trace.replay():
            lp = model.apply(params, toks, mode="train").float()
    err = float((lk - lp).abs().max())
    scale = float(lp.abs().max())
    agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    logit_ok = (lk.shape == (eval_b, eval_s, cfg.vocab_size)
                and bool(torch.isfinite(lk).all()) and err <= EVAL_LOGIT_TOL * scale)
    del lk, lp
    log(f"  eval-batch logits kernels vs plain: max abs err {err:.4e} (max |logit| "
        f"{scale:.3f}, tol {EVAL_LOGIT_TOL * scale:.4e}), argmax agreement "
        f"{agree:.4f}, expert routings pinned {trace.flips} "
        f"{'OK' if logit_ok else 'FAIL'}")
    # Where the quality path's time goes: one eval forward and one steady
    # calibration batch (forward, gram launches, fp64 adds into a store that
    # already holds every key, as in 15 of the 16 batches).
    calib_toks = list(calibration_batches(cfg.vocab_size, "en_a", 32, 16, 128))
    with torch.no_grad():
        prof_eval = profile_step(torch, lambda: model.apply(params, toks, mode="train"),
                                 f"eval forward ({eval_b} x {eval_s})")
    store = collect_grams(model, params, calib_toks[:1])
    batch = torch.as_tensor(calib_toks[1], device="cuda")

    @torch.no_grad()
    def calib_batch():
        taps = {}
        model.apply(params, batch, mode="train", taps=taps)
        accumulate_taps(store, taps)
    prof_calib = profile_step(torch, calib_batch, "steady calibration batch (16 x 128)")
    del store
    summary = dict(config=cfg.name, layers=cfg.num_layers, entry=entry, launches=counts,
                   expected_launches=expect, flash_launches=split, gram_launches=gsplit,
                   nested_launches=nsplit, batched_launches=bsplit,
                   expected_batched_launches=batched_expect,
                   gram_fallback_slices=tot["gram_fallback_slices"], rwkv6_launches=rsplit,
                   peak_memory_gb=peak_gb,
                   eval_profile=prof_eval, calib_profile=prof_calib,
                   eval_logit_max_abs_err=err, eval_logit_max_abs=scale,
                   eval_routings_pinned=trace.flips,
                   eval_argmax_agreement=agree, ok=bool(ok and logit_ok))
    return summary, counts


# Methods path: Table 4's ratio and its largest k2 (k1_frac 0.9), two eval
# domains (in- and out-of-domain), one (1, 1024) batch each: 1024 rows, at
# the nested kernel's gate, so every nested linear runs on the mma kernel.
METHODS_RATIO, METHODS_K1_FRAC = 0.3, 0.9
METHODS_DOMAINS = ("en_a", "jp")
METHODS_EVAL_SEQ = 1024
# Eckart-Young per target, on the fp64 factors' diagnostics: ASVD-I and
# ASVD-II are the same rank-k optimum of the damped whitened loss (their
# whitened errors agree to fp64 round-off of the eigen and Cholesky paths,
# far inside 1e-6), and no other method with a Gram (svd has none, and no
# whitened error) is below theirs by more than 1e-6 relative (the damping,
# 1e-6 of the mean diagonal, is all that separates their optimum from the
# undamped loss the diagnostics read); plain SVD's weight-space error is
# the minimum to fp64 round-off (1e-9).
EY_WHITENED_REL = 1e-6
EY_PLAIN_REL = 1e-9


def methods_path(torch, np, cfg, taps_per_layer: int):
    """Every method of ``ALL_METHODS`` on one model, as the paper's tables
    compare them: calibrate once (gram, flash_attention), then for each
    method ``compress_model`` (ratio 0.3, k1_frac 0.9, telemetry recording
    each target's diagnostics) and perplexity on an in-domain and an
    out-of-domain batch (the same tokens for every method and the dense
    model; nested linears on the mma kernel).  Checks Eckart-Young per
    target, equal achieved ratios, exact launch counts; then, on the nid1
    gate projection, that the residual's ID is exact and the nested kernel
    agrees per element with its plain version on the NID factors."""
    import math

    from repro_torch.calib.runner import calibration_batches, collect_grams
    from repro_torch.core import (ALL_METHODS, NESTED_METHODS, CompressionConfig,
                                  asvd_compress, column_id, compress_model, id_compress,
                                  make_whitener, split_rank, truncated_svd)
    from repro_torch.eval.perplexity import eval_batches, evaluate_ppl
    from repro_torch.kernels.nested_lowrank import ref as nlr_ref
    from repro_torch.models import build_model
    from repro_torch.obs.compression import CompressionTelemetry

    def sync():
        torch.cuda.synchronize()

    model = build_model(cfg)
    params = model.init(0, "cuda")
    targets = model.compressible_targets()
    batches = {d: next(eval_batches(cfg.vocab_size, d, 1, 1, METHODS_EVAL_SEQ))
               for d in METHODS_DOMAINS}
    sync()
    reset_counts()
    t0 = time.perf_counter()
    grams = collect_grams(model, params, calibration_batches(
        cfg.vocab_size, "en_a", n_samples=256, batch=16, seq=128))
    sync()
    calib_s = time.perf_counter() - t0
    dense_ppl = {d: evaluate_ppl(model, params, [batches[d]]) for d in METHODS_DOMAINS}
    rows, nid_leaf, nid_plan = {}, None, None
    gate = next(t for t in targets if t.path[-2:] == ("mlp", "wg"))
    for method in ALL_METHODS:
        tel = CompressionTelemetry(compare_plain=False)
        sync()
        t0 = time.perf_counter()
        cparams, plan = compress_model(params, targets, grams, CompressionConfig(
            method=method, ratio=METHODS_RATIO, k1_frac=METHODS_K1_FRAC, dtype=cfg.dtype),
            telemetry=tel)
        sync()
        secs = time.perf_counter() - t0
        ppl = {d: evaluate_ppl(model, cparams, [batches[d]]) for d in METHODS_DOMAINS}
        eval_s = time.perf_counter() - t0 - secs
        reps = tel.reports
        rows[method] = dict(
            compress_s=secs, eval_s=eval_s, ppl=ppl, achieved_ratio=plan.achieved_ratio,
            factored_ratio=factored_ratio(cparams, plan),
            k1k2={n: (r.k1, r.k2) for n, r in reps.items()},
            whitened={n: r.whitened_rel_err for n, r in reps.items()},
            plain={n: r.plain_rel_err for n, r in reps.items()},
            target_s={n: r.seconds for n, r in reps.items()})
        if method == "nid1":
            nid_leaf, nid_plan = cparams, plan
            for key in gate.path:
                nid_leaf = nid_leaf[key]
        del cparams
        torch.cuda.empty_cache()
    counts = read_counts()
    split, split_ok = flash_split_ok(counts)
    nsplit, gsplit = nested_split(), gram_split()

    layers = cfg.num_layers
    n_linear = sum(t.count for t in targets)  # nested linears a forward
    calib_batches = 256 // 16
    forwards = calib_batches + len(METHODS_DOMAINS) * (1 + len(ALL_METHODS))
    nested_calls = len(NESTED_METHODS) * n_linear * len(METHODS_DOMAINS)
    expect = {"nested_lowrank": nested_calls, "paged_attention": 0,
              "gram": (taps_per_layer * layers + 1) * calib_batches,
              "flash_attention": layers * forwards, "rwkv6": 0}
    nested_expect = {"stream": 0, "mma": nested_calls, "tile": 0}
    counts_ok = (counts == expect and split_ok and nsplit == nested_expect
                 and gsplit == {"mma": expect["gram"], "fma": 0})

    names = [t.name for t in targets]
    numbers = [calib_s, *dense_ppl.values()]
    for m, r in rows.items():
        # svd runs without a Gram, so its whitened error is nan by design.
        numbers += [r["compress_s"], *r["ppl"].values(), r["achieved_ratio"],
                    *r["plain"].values(), *(r["whitened"].values() if m != "svd" else ())]
    finite = all(math.isfinite(float(x)) for x in numbers)
    ratios = {m: r["achieved_ratio"] for m, r in rows.items()}
    ratio_ok = (len(set(ratios.values())) == 1
                and all(abs(r["factored_ratio"] - r["achieved_ratio"]) < 1e-9
                        for r in rows.values()))
    ey = {}
    for n in names:
        w = {m: r["whitened"][n] for m, r in rows.items() if m != "svd"}
        p = {m: r["plain"][n] for m, r in rows.items()}
        best = min(w["asvd1"], w["asvd2"])
        ey[n] = dict(
            asvd12_rel=abs(w["asvd1"] - w["asvd2"]) / w["asvd2"],
            whitened_margin=min(w[m] / best for m in w if m not in ("asvd1", "asvd2")) - 1.0,
            plain_margin=min(p[m] / p["svd"] for m in p if m != "svd") - 1.0,
            ok=(abs(w["asvd1"] - w["asvd2"]) <= EY_WHITENED_REL * w["asvd2"]
                and all(max(w["asvd1"], w["asvd2"]) <= w[m] * (1 + EY_WHITENED_REL)
                        for m in w)
                and all(p["svd"] <= p[m] * (1 + EY_PLAIN_REL) for m in p)))
    ey_ok = all(v["ok"] for v in ey.values())

    # NID exactness on the gate projection: the nid1 residual recomputed
    # from the same Gram (step (5a) by Cholesky whitening at k1), its column
    # ID, and the rank-k2 SVD of the same residual.
    if gate.stacked:
        raise ValueError("the NID check reads one unstacked slice (depth 1)")
    kernel = params
    for key in gate.path:
        kernel = kernel[key]
    a = kernel["kernel"].to(torch.float64).T
    k1, k2 = split_rank(nid_plan.rank_of(gate), METHODS_K1_FRAC)
    whit = make_whitener("asvd1", gram=grams.gram(gate.gram_key), damp=nid_plan.config.damp)
    first, _ = asvd_compress(a, k1, whit, use_randomized=nid_plan.config.use_randomized)
    residual = a - first.matrix()
    del whit, first
    sync()
    t0 = time.perf_counter()
    cols, t = column_id(residual, k2)
    sync()
    id_s = time.perf_counter() - t0
    f = id_compress(residual, k2)
    eye = torch.eye(k2, dtype=torch.float64, device="cuda")
    exact = (torch.equal(f.w, residual[:, cols]) and torch.equal(f.z[:, cols], eye)
             and torch.equal(f.z, t))
    id_err = float(torch.linalg.norm(residual - f.matrix()))
    svd_err = float(torch.linalg.norm(residual - truncated_svd(residual, k2).matrix()))
    # The path's own bf16 factors are this ID's, bit for bit: u2 = T^T and
    # v2 = C^T (the card's Cholesky, SVD and products repeat exactly).
    dt = nid_leaf["u2"].dtype
    path_same = (torch.equal(nid_leaf["u2"], f.z.T.to(dt))
                 and torch.equal(nid_leaf["v2"], f.w.T.to(dt)))
    id_ok = exact and path_same and id_err >= svd_err * (1 - EY_PLAIN_REL)
    del residual, f, t, a
    # The nested kernel on those factors, per element against its plain
    # version (outside the counted run).
    nlr = _ops("nested_lowrank")
    gen = torch.Generator(device="cuda").manual_seed(5)
    kern_rows = []
    for m in (8, 512):
        x = torch.randn((m, gate.in_dim), generator=gen, device="cuda").to(dt)
        fac = [nid_leaf[k] for k in ("u", "v", "u2", "v2")]
        before = nested_split()
        got = nlr.nested_lowrank_matmul(x, *fac)
        want = nlr_ref.nested_lowrank_matmul_ref(x, *fac)
        sync()
        after = nested_split()
        ran = next((k for k in after if after[k] > before[k]), "none")
        e_err = elem_err(torch, got, want)
        k_ok = (bool(torch.isfinite(got).all()) and e_err <= NESTED_ELEM_TOL["bfloat16"]
                and ran == ("stream" if m <= nlr.STREAM_ROWS else "mma"))
        kern_rows.append(dict(M=m, ran=ran, elem_err=e_err,
                              elem_tol=NESTED_ELEM_TOL["bfloat16"], ok=k_ok))
    kern_ok = all(r["ok"] for r in kern_rows)
    del nid_leaf, grams

    log(f"methods path: {cfg.name} layers={layers} (depth cut), ratio {METHODS_RATIO}, "
        f"k1_frac {METHODS_K1_FRAC}, {len(targets)} targets; calibrate {calib_s:.2f} s; "
        f"eval batches (1, {METHODS_EVAL_SEQ}) on {list(METHODS_DOMAINS)}; dense ppl "
        + ", ".join(f"{d} {v:.3f}" for d, v in dense_ppl.items()))
    for m, r in rows.items():
        wm = sum(r["whitened"].values()) / len(names)
        pm = sum(r["plain"].values()) / len(names)
        log(f"  {m:6s} compress {r['compress_s']:6.2f} s  eval {r['eval_s']:.2f} s  ppl "
            + " ".join(f"{d} {r['ppl'][d]:.3f}" for d in METHODS_DOMAINS)
            + f"  whitened err mean {wm:.5f}  plain err mean {pm:.5f}  achieved ratio "
            f"{r['achieved_ratio']:.6f}  target s: "
            + ", ".join(f"{n.split('/')[-1]} {s:.2f}" for n, s in r["target_s"].items()))
    for n, v in ey.items():
        log(f"  Eckart-Young {n}: |asvd1 - asvd2| / asvd2 {v['asvd12_rel']:.2e} (tol "
            f"{EY_WHITENED_REL:.0e}), least whitened margin {v['whitened_margin']:.3e}, least "
            f"plain margin over svd {v['plain_margin']:.3e} {'OK' if v['ok'] else 'FAIL'}")
    log(f"  nid1 {gate.name} ({gate.out_dim}x{gate.in_dim}, k1 {k1}, "
        f"k2 {k2}): C = residual[:, cols] and T[:, cols] = I exactly: {exact}; ID error "
        f"{id_err:.6e} >= rank-k2 SVD error {svd_err:.6e}; the path's bf16 factors are "
        f"this ID's: {path_same}; column_id {id_s:.3f} s {'OK' if id_ok else 'FAIL'}")
    for r in kern_rows:
        log(f"  nested kernel on nid1 {gate.name} factors, M={r['M']}: {r['ran']} elem err "
            f"{r['elem_err']:.3e} (tol {r['elem_tol']:.3e}) {'OK' if r['ok'] else 'FAIL'}")
    log(f"  launches {counts} expected {expect}; flash_attention by kernel {split}; "
        f"nested_lowrank by kernel {nsplit} expected {nested_expect}; gram by kernel "
        f"{gsplit} {'OK' if counts_ok else 'FAIL'}; all numbers finite: {finite}; "
        f"achieved ratios equal: {ratio_ok}")
    summary = dict(config=cfg.name, layers=layers, ratio=METHODS_RATIO,
                   k1_frac=METHODS_K1_FRAC, calibrate_s=calib_s, dense_ppl=dense_ppl,
                   methods=rows, eckart_young=ey,
                   nid_check=dict(target=gate.name, k1=k1, k2=k2, exact=exact,
                                  id_err=id_err, svd_err=svd_err,
                                  path_factors_identical=path_same, column_id_s=id_s),
                   nid_kernel=kern_rows, launches=counts, expected_launches=expect,
                   flash_launches=split, nested_launches=nsplit,
                   expected_nested_launches=nested_expect, gram_launches=gsplit,
                   ok=bool(finite and ratio_ok and ey_ok and id_ok and kern_ok
                           and counts_ok))
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
        from repro_torch.configs import MISTRAL_7B, MOONSHOT_V1_16B_A3B, RWKV6_1_6B
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
    nested_b = nested_batched_phase(torch, nlr_ops, nlr_ref)
    paged = paged_phase(torch, np, pa_ops, pa_ref)
    grams = gram_phase(torch, gram_ops, gram_ref)
    grams_b = gram_batched_phase(torch, gram_ops, gram_ref)
    flash = flash_phase(torch, fa_ops, fa_ref)
    rwkv = rwkv6_phase(torch, rwkv_ops, rwkv_ref)
    kernels_ok = all(r["ok"] for r in nested + nested_b + paged + grams + grams_b + flash
                     + rwkv)
    # mistral-7b cut to 2 of 32 layers (1 on the methods path); rwkv6-1.6b
    # cut to 4 of 24; moonshot-v1-16b-a3b cut to 3 of 48 (its dense first
    # layer and two MoE layers); widths untouched.  (path, function, args):
    # the mixer kernel and a calibration batch's (single, batched) Gram taps
    # (4 a layer and the final norm's on Mistral, 9 a layer and the final
    # norm's on RWKV-6; on moonshot 4 on the dense layer, and on each MoE
    # layer attn.in, attn.out_in, router_in, shared_in, shared_mid and the
    # batched expert_buf, expert_mid).
    mistral = dataclasses.replace(MISTRAL_7B, num_layers=2)
    rwkv6 = dataclasses.replace(RWKV6_1_6B, num_layers=4)
    moonshot = dataclasses.replace(MOONSHOT_V1_16B_A3B, num_layers=3)
    served = {}
    runs = (("serve", serve_path, (mistral, "flash_attention", (9, 0), served)),
            ("sched_serve", sched_serve_path, (served,)),
            ("fault_serve", fault_serve_path, (served,)),
            ("quality", quality_path, (mistral, 2, (9, 0), "flash_attention")),
            ("methods", methods_path, (dataclasses.replace(MISTRAL_7B, num_layers=1), 4)),
            ("rwkv_serve", serve_path, (rwkv6, "rwkv6", (37, 0))),
            ("rwkv_quality", quality_path, (rwkv6, 1, (37, 0), "rwkv6")),
            ("moe_serve", serve_path, (moonshot, "flash_attention", (15, 4))),
            ("moe_quality", quality_path, (moonshot, 2, (15, 4), "flash_attention")))
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
    # (largest factor bytes) in bf16 at 8 live decode rows (the nested
    # stream kernel) and at one 512-row prefill chunk (the nested mma
    # kernel), and the bf16 page pools (serve path); the gram wrapper at the
    # d_ff-wide bf16 tap and its mma kernel at the d_model-wide one (7 of a
    # batch's 9 taps), and the (4, 2048) eval batch in bf16 (quality path);
    # the rwkv6-1.6b eval batch in fp32 (the model's dtype for the
    # recurrence).  Launches are each kernel's count on its own path (nested:
    # by kernel on the Mistral serve path; gram: all of the wrapper's, then
    # the mma kernel's, on the Mistral quality path; rwkv6: the RWKV-6 serve
    # path).  The gram FMA kernel (fp32 taps) has no launch on the paths.
    nested_serve = summaries["serve"]["nested_launches"]
    nested_src = "src/repro_torch/csrc/nested_lowrank.cu"
    nested_tpu = "src/repro/kernels/nested_lowrank/nested_lowrank.py:84"

    def nested_pick(m):
        return next(r for r in nested if r["dtype"] == "bfloat16" and r["target"] == "gate"
                    and r["M"] == m)
    picks = (
        ("nested_lowrank", nested_pick(8), nested_serve["stream"], nested_src, nested_tpu),
        ("nested_lowrank_mma", nested_pick(512), nested_serve["mma"], nested_src, nested_tpu),
        ("paged_attention", next(r for r in paged if r["kernel"] == "paged_attention"
                                 and r["pool"] == "bfloat16" and r["case"] == "phase"),
         serve_counts["paged_attention"], "src/repro_torch/csrc/paged_attention.cu",
         "src/repro/kernels/paged_attention/paged_attention.py:243"),
        ("gram", next(r for r in grams if r["dtype"] == "bfloat16" and r["n"] == 14336),
         quality_counts["gram"], "src/repro_torch/csrc/gram.cu",
         "src/repro/kernels/gram/gram.py:54"),
        ("gram_mma", next(r for r in grams if r["dtype"] == "bfloat16" and r["n"] == 4096),
         summaries["quality"]["gram_launches"]["mma"], "src/repro_torch/csrc/gram.cu",
         "src/repro/kernels/gram/gram.py:54"),
        ("flash_attention", next(r for r in flash if r["dtype"] == "bfloat16"
                                 and r["S"] == 2048),
         quality_counts["flash_attention"], "src/repro_torch/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention/flash_attention.py:108"),
        ("rwkv6", next(r for r in rwkv if r["dtype"] == "float32" and r["case"] == "eval"),
         rwkv_serve_counts["rwkv6"], "src/repro_torch/csrc/rwkv6.cu",
         "src/repro/kernels/rwkv6/rwkv6.py:105"),
    )
    # The combine runs on the Mistral serve path when plan_splits gives its
    # decode step's table more than one split: its entry is the serve case's
    # combine alone (bf16), with that path's combine launches.
    if summaries["serve"]["paged_combine_launches"]:
        picks += (("paged_combine", next(r for r in paged if r["kernel"] == "paged_combine"
                                         and r["case"] == "serve" and r["pool"] == "bfloat16"),
                   summaries["serve"]["paged_combine_launches"],
                   "src/repro_torch/csrc/paged_attention.cu",
                   "src/repro/kernels/paged_attention/paged_attention.py:243"),)
    # The batched forms: the nested decode case (64 experts x 8 rows, stream)
    # with the MoE paths' batched stream launches, the 960-row gate case
    # (mma) with their batched mma launches, and the expert_buf-wide Gram
    # with their batched gram launches.
    moe_b = [summaries[k]["batched_launches"] for k in ("moe_serve", "moe_quality")]
    picks += (
        ("nested_lowrank_batched", next(r for r in nested_b if r["case"] == "decode"),
         sum(b["nested"]["stream"] for b in moe_b), nested_src, nested_tpu),
        ("nested_lowrank_batched_mma", next(r for r in nested_b if r["case"] == "eval_gate"),
         sum(b["nested"]["mma"] for b in moe_b), nested_src, nested_tpu),
        ("gram_batched", next(r for r in grams_b if r["n"] == 2048),
         sum(b["gram"] for b in moe_b), "src/repro_torch/csrc/gram.cu",
         "src/repro/kernels/gram/gram.py:54"))
    entries = []
    for name, row, launches, src, replaces in picks:
        entries.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches,
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"device": kind, "nvidia_smi": smi_line, "build_s": build_s,
                   "nested": nested, "nested_batched": nested_b, "paged": paged,
                   "gram": grams, "gram_batched": grams_b, "flash": flash,
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
