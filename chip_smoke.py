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
     per-element check, exact symmetry, two runs bit-identical, which
     kernel ran -- mma for bf16, tf32x3 for fp32, whose per-element error
     against an fp64 Gram is also held within GRAM_GATE of the plain fp32
     matmul's -- the device time of one call and of the library call, and
     the FMA kernel on the same rows, its event and device times and the
     same checks but the gate;
     paged_attention: also a per-element check and zeros on a length-0 row at
     lengths 1-700, at eight rows of 512-8192 tokens, at one row of 32768
     and at the serve path's decode step, and that step at chatglm3-6b's
     32/2 heads (G 16, the glm_serve path's), bf16 and int8 pools, with the
     split plan, which kernels ran, the device time of one call and of SDPA,
     the achieved bytes/s, and the combine kernel alone against its plain
     version on the split kernel's partials; rwkv6: also a per-element check
     of y and of the final state, and the device time of one call;
     flash_attention's backward (three kernels: D, dK/dV, dQ; tensor-core
     for bf16 at hd <= 128, CUDA-core for fp32, as ``bwd_plan`` picks)
     against the plain FA2 backward per element (FLASH_BWD_ELEM_TOL) at
     FLASH_BWD_SHAPES, two runs bit-identical, the forward's log-sum-exp
     against the plain one, beside SDPA's backward alone; the rwkv6
     backward (three kernels: chunk summaries, the scan over chunks, the
     gradients) against the plain reverse recurrence at RWKV_BWD_SHAPES
     (RWKV_SHAPES, long memory, K 8/16/32), every gradient globally and per
     element, two runs bit-identical, each kernel's device time beside the
     call's and both bounds);
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
  4d. spec_serve path: self-speculative decoding on *Serve*'s
     configuration and prompts (SPEC_RUNS): S1 ``serve()`` with the target
     at nsvd1 0.2 and a draft at nsvd1 0.6 from the same Grams, k = 4,
     worst case at depth 1 (as the serve path); S2 on demand at depth 2;
     S3 the dense slab; S4 dynamic k; S5 a draft kill (4 plain steps of
     cool-down) and one poisoned row (retried); S6 the target as its own
     draft.  Streams by the margin rule against the serve path's (its
     teacher-forced margins); every request "stop" with 32 tokens; prefill
     calls, first-token syncs and plain steps as predicted
     (SPEC_PREDICTED, from a CPU run); one sync a step and none in a
     dispatch (sync-debug "error"); launches exact from each run's spec
     steps (nested: 14 x (k+1) stream and 14 mma a spec step, 2 x 14 mma a
     chunk call; paged: 2 x (k+1) split and combine launches a spec step;
     tile 0); S5's fault_stats() against its plan and the degraded view;
     S6's rejections only at margins inside the gate.  Then one spec step
     profiled: the draft root, the verify root and both;
  4e. obs_serve path: serving observability on *Serve*'s compressed model,
     prompts and spec_serve's draft (nothing compressed again): O1
     *Serve*'s plan (worst case, depth 1) with telemetry off, O2t with a
     ``Telemetry`` (its hooks timed directly) and O2 with a ``Telemetry``
     and a ``MetricsServer`` on port 0 scraped over HTTP from a thread
     during the run and, in the first O2, a ``ProfileCapture`` of 8 steps,
     in turn OBS_PAIRS times; O3 sched_serve C's plan with F1's fault plan
     and O4 spec_serve S5, each off and on.  Gates: O2t's and O2's
     streams bit-identical to O1's with equal launches of every kernel;
     O3's and O4's tokens equal off and on; the counters reconciled with
     ``stats()``, ``scheduler_stats()``, ``fault_stats()`` and
     ``spec_stats()`` (spec rows by (k, accepted), the acceptance rate of
     ``bench_block()``); every request's events in lifecycle order;
     ``/healthz`` 503 naming ``draft`` during O4's cool-down, 200 after;
     no sync in a dispatch (sync-debug "error"); the captured Chrome trace
     holding ``serving_root.paged_decode`` ranges and the stream_partial,
     paged_split_kernel and paged_combine_kernel kernels.  Prints TTFT
     p50/p99, TPOT p50 and queue wait p50 from ``bench_block()``, step p50
     and tok/s off, with the hooks and with the scraped server, the hooks'
     own host time a step, ``wrap_root``'s µs a root call, and a profiled
     engine step's wall off and on.  Device times and idle gaps of every
     profile leave out the card-side mirrors of ``record_function`` ranges
     (``device_work``);
  4f. mesh_serve path: the parallelism layer (``torch.distributed``) on
     *Serve*'s compressed model and prompts (nothing compressed again): a
     one-rank NCCL process group through a ``FileStore`` in a temporary
     directory, ``make_serving_mesh(1, 1)`` on cuda, *Serve*'s params saved
     to a temporary checkpoint and restored onto the mesh by
     ``param_shardings`` (each leaf memory-mapped, its slice copied to the
     card), then *Serve*'s plan (worst case, depth 1) served over the mesh.
     Gates: the restored leaves bit-identical to the params, the streams
     bit-identical to the serve path's, every kernel's launches equal to
     *Serve*'s plan's (obs_serve's O1), the data group's all-gathers = the
     decode steps + the admissions' first-token reads of O1 and no TP
     collective (``parallel.collectives.counts``), no sync in a dispatch
     (sync-debug "error"); then one decode step profiled, the gather's
     device time apart.  The process group is destroyed at its end, so the
     later paths run meshless;
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
     version on those bf16 factors at 8 and 512 rows;
  8b. moe_serve and moe_quality paths: the serve and quality paths on
     moonshot-v1-16b-a3b at full width cut to 3 of 48 layers (the
     token-choice MoE on the dense K/V slab, exact-length admission);
     moe_serve then serves its prompts again on the same compressed model
     with the slab's K/V in int8 (``kv_quant``): every request finished,
     the streams by the margin rule against the bf16 slab's, the same
     nested launches, a decode step's logits on an int8 slab within 5% of
     max |logit| of the bf16 slab's with the expert choices pinned, and the
     slab's bytes a token both ways;
  9. glm_serve path (after the MoE paths): the serve path on chatglm3-6b at
     full width cut to 2 of 28 layers (32/2 heads x 128: paged_attention at
     G 16 with its combine, flash at G 16 in calibration, gram at n 4096
     and 13696), its exact counts held against GLM_PREDICTED, one 512-row
     prefill chunk's logits through the kernels against the plain versions
     beside the decode step's, and paged_attention's device ms a call, its
     split count and the combine's share, K/V bytes a token against
     Mistral-7B's;
 10. mla_serve path: the serve path on minicpm3-4b at full width cut to 4
     of 62 layers (Multi-head Latent Attention on the dense latent slab,
     bucketed admission: buckets 16-256 at max_len 256, one call a
     bucket's group at its size rounded up to a power of two, the padding
     rows' writes dropped; naive prefill, absorbed decode with wkv_b built
     by dense_kernel, so 8 nested calls a layer at prefill and 7 at decode,
     none above the 1024-row gate), its exact counts held against
     MLA_PREDICTED, its largest admission's logits (512 rows) through the
     kernels against the plain versions, admission calls by
     bucket, host syncs, and the latent slab's bytes a token against a GQA
     slab of its heads;
 11. dsv3_serve path: the serve path on deepseek-v3-671b at full width cut
     to 4 of 61 layers (its 3 dense (mla, mlp) layers and 1 (mla, moe)
     layer) and to 16 of 256 experts (top-8 kept: the calibration's fp64
     Grams of 256 experts would not fit), Multi-head Latent Attention over
     the token-choice MoE on the dense latent slab with exact-length
     admission (the MoE is pad-sensitive), its exact counts held against
     DSV3_PREDICTED, the longest admission's and a decode step's logits
     through the kernels against the plain versions with the expert
     choices pinned, and a (1, 1536) eval batch through the compressed
     experts (capacity 960: the batched mma kernel).  The kernel phase
     holds the single nested form at each of its linears' shapes and
     served ranks (8, 173 and 512 rows), the gram at its tap widths, the
     batched nested form at deepseek-v3's expert shapes over 16 experts
     (decode, the widest admission capacity) and over all 256 (with the
     experts a top-8 decode step fills), and the batched gram at its
     calibration capacity (16, 1280, n);
 12. jamba_serve path: the serve path on jamba-v0.1-52b at full width cut
     to 5 of 32 layers ((mamba, mlp), (mamba, moe), (mamba, mlp), (mamba,
     moe), (gqa, mlp): the fewest that hold every kind of layer in its
     period of 8) and to 8 of 16 experts (top-2 kept; the calibration's
     fp64 Grams of 16 experts would not fit beside the weights), the Mamba
     layers' recurrent state and the attention layer's K/V in one dense
     slab, one exact-length admission a prompt (pad-sensitive twice over),
     its exact counts held against JAMBA_PREDICTED, the longest
     admission's and a decode step's logits and a (1, 1536) eval batch's
     (capacity 480: the batched mma kernel) through the kernels against the
     plain versions with the expert choices pinned, and the device time of
     the selective scan and the causal conv (plain torch) within a decode
     step and the 173-token admission.  The kernel phase holds the single
     nested form at in_proj, x_proj, dt_proj and out_proj (8 and 173 rows),
     the batched nested form at jamba's experts (4096 <-> 14336) over 8 and
     all 16 experts x 8 rows and 8 x 55 rows, and the batched gram at its
     calibration capacity (8, 640, n);
 13. whisper path: whisper-small at full width and depth, no cut (12 + 12
     layers, 768 wide, 1500 frames), through the reference's entry points
     for the encoder-decoder (it has no serving path): calibrate over batch
     dicts with frames (gram), compress (nsvd1 0.2, 192 targets), perplexity
     on en_a and jp dense and compressed and the logit KL (flash in the
     decoder; the encoder's bidirectional and every cross attention plain
     torch; the nested linears above the 1024-row gate plain, counted
     apart), then greedy decoding of 8 rows through ``make_prefill_step``
     and ``make_decode_step`` (nested stream at decode, mma at the 128-row
     prefill); its exact counts held against WHISPER_PREDICTED; the streams
     by the margin rule, the prefill's self and cross K/V, a decode step's
     and an eval batch's logits against the plain versions; a profiled
     decode step and the bidirectional attention's share of a calibration
     batch.  The kernel phase holds flash at (16, 128), 12/12 heads x 64,
     the nested MLP linears at 8 and 128 rows and the gram at 24000 rows of
     n 768 and 3072;
 14. llava path: llava-next-mistral-7b at full width cut to 4 of 32 layers
     (its fp64 Grams: 2.05 GB a layer), the projector uncut, every row
     behind one image's 576 patch features (fp32, from a numpy seed):
     calibrate over batch dicts with patches (gram: the raw fp32
     ``projector.in`` tap on the tf32x3 kernel, the rest on mma), compress
     (nsvd1 0.2, the layers' and the projector's 30 targets), perplexity on
     en_a and jp dense and compressed and the logit KL, greedy decoding of
     8 rows through ``make_prefill_step`` and ``make_decode_step`` (decode
     at cache_len 576 + 16 + i), one image's prefill (the projector at 576
     rows on the mma kernel), and the compressed model served text-only
     through the paged engine (*Serve*'s plan); its exact counts held
     against LLAVA_PREDICTED (the nested calls above the 1024-row gate
     counted apart); the streams by the margin rule, a decode step's, the
     one-image prefill's and an eval batch's logits against the plain
     versions; a profiled decode step and calibration batch.  The kernel
     phase holds the gram at (9216, 1024) (fp32: the tf32x3 kernel) and the
     projector's wi and wo at 576 rows;
 15. train path: mistral-7b at full width cut to 2 layers (0.70 B params,
     bf16, fp32 AdamW state), batch 4 x 2048 from the data pipeline, the
     loss chunked by 512: step 1's loss and every leaf's grad through the
     kernels (flash forward with its log-sum-exp, the hand-written
     backward) against the same step under ``kernels.plain()``
     (TRAIN_GRAD_REL_TOL, TRAIN_LOSS_REL_TOL); one step, an async
     checkpoint to a temporary directory, TRAIN_RESUME_STEPS steps, and the
     same steps from the restored checkpoint bit for bit; launches exactly
     TRAIN_PREDICTED (no nested, paged, rwkv6 or gram launch; every
     backward on the tensor-core kernels); a profiled
     step (wall, device, tokens/s, the backward kernels' share); then
     small-llama (fp32) trained by the reference's recipe
     (``launch.train.train_small_lm``: 300 steps) with its loss falling by
     SMALL_LOSS_DROP (every backward on the CUDA-core kernels), and
     ``build_entry`` (nsvd1 0.2, k1 0.9) on its params with exact launches
     (``small_quality_expect``), printed beside BENCH_quality.json's
     JAX-trained entry; then ``build_entry`` on the committed
     reference-trained small-llama (``trained_quality``: its Grams in host
     memory) held to the reference's entry on the same weights within
     TRAINED_TOL;
 16. train_rwkv path: rwkv6-1.6b at full width cut to 4 of 24 layers,
     bf16, fp32 AdamW state, the train path's batch: step 1's loss and
     grads through the rwkv6 kernel and its hand-written backward against
     the plain scan and backward (TRAIN_LOSS_REL_TOL; the grads within
     TRAIN_GRAD_REL_TOL of a plain run replaying the kernel run's
     recurrence outputs, ``RecurrenceTrace``, and on an fp32 twin of 2
     layers with nothing pinned),
     1 + 2 steps, launches exactly TRAIN_PREDICTED["rwkv"] (rwkv6 and its
     backward once a layer and step, every forward on 16-byte copies; no
     nested, paged, gram or flash launch), a profiled step (wall, device,
     tokens/s, the backward kernel's share), peak GiB against the
     reckoning; then ``launch.train.train_loop(arch="rwkv6-1.6b",
     reduced=True)`` on the card for RWKV_CLI_STEPS steps, its loss on its
     first batch falling by RWKV_CLI_DROP, launches TRAIN_PREDICTED
     ["rwkv_cli"].  No other path launches the rwkv6 backward;
 17. full_depth path: mistral-7b at full width and all 32 layers (random
     weights from seed 0, bf16) with the calibration GramStore in host
     memory (67.69 GB of fp64 sums, more than the card holds beside the
     weights; the serve CLI's check refuses the device home and names the
     host one): the serve path's run with ``grams_on="host"`` (calibrate
     in layer groups sized from the card's free memory, every group
     running the 16 batches and folding only its layers' taps, nsvd1 0.2
     with each Gram read onto the card, 8 requests paged at worst case
     and depth 1, exact launches, a decode step's logits against plain;
     the peak held to calibration's own bound), then perplexity of the
     dense and compressed model on FULL_DEPTH_EVAL batches of en_a and the
     logit KL on one (flash once a layer and forward; the compressed
     linears above the nested gate, counted), then both homes at
     HOMES_LAYERS layers (``gram_homes_check``: layer keys and nsvd1
     params bit-identical, shared keys within HOMES_SHARED_REL).  Prints
     the host's MemTotal and MemAvailable (/proc/meminfo, read only), the
     store's host bytes and groups, the process's peak RSS and each
     phase's seconds.
Prints each path's seconds and peak device memory, a JSON kernel summary,
nvidia-smi's line, and as its last line
{"ok": true, "device": {...}}.  Any failed phase exits non-zero; without a
card (or outside the repository) it exits non-zero before printing results.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import math
import os
import subprocess
import sys
import time
from collections import Counter

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")

# H100 SXM published peaks (dense): HBM bytes/s and FLOP/s per input type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12, "int8": 1979e12}

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
# The narrower and wider shapes of the glm_serve and mla_serve paths, bf16
# only (their models' dtype), at ratio 0.2: chatglm3-6b's wk (wv alike; N
# 256 from 2 KV heads) and its d_ff 13696 (wi, wg alike, and wo back);
# minicpm3-4b's every compressed linear (wq_a, wq_b, wkv_a with N 288 =
# kv_lora 256 + rope 32, wkv_b with K 256, wo, wi and wg, wo back).  Rows: a
# decode step's 8 (stream), and 512 and 1024 (mma: a paged chunk, an
# admission call, the gate's edge).
NESTED_PATH_SHAPES = (
    ("glm_wk", 4096, 256, 192),
    ("glm_wi", 4096, 13696, 2522),
    ("glm_wo_ff", 13696, 4096, 2522),
    ("mla_wq_a", 2560, 768, 472),
    ("mla_wq_b", 768, 3840, 512),
    ("mla_wkv_a", 2560, 288, 207),
    ("mla_wkv_b", 256, 5120, 195),
    ("mla_wo", 2560, 2560, 1024),
    ("mla_wi", 2560, 6400, 1462),
    ("mla_wo_ff", 6400, 2560, 1462),
)
NESTED_PATH_ROWS = (8, 512, 1024)
# deepseek-v3-671b's single-form linears on the dsv3_serve path, at the
# served ranks (nsvd1 at 0.2): wq_a, wq_b (N 24576 = 128 heads x qk 192),
# wkv_a (N 576 = kv_lora 512 + rope 64), wkv_b (K 512, N 32768 = 128 x
# (nope 128 + v 128); the widest N on any path, at prefill), wo (K 16384),
# the dense layers' MLP (wi, wg alike, and wo back at 18432) and the
# shared expert (7168 <-> 2048).  Rows: a decode step's 8 (stream), the
# longest admission's 173 and a 512-row call (mma).
DSV3_PATH_SHAPES = (
    ("dsv3_wq_a", 7168, 1536, 1011),
    ("dsv3_wq_b", 1536, 24576, 1156),
    ("dsv3_wkv_a", 7168, 576, 426),
    ("dsv3_wkv_b", 512, 32768, 403),
    ("dsv3_wo", 16384, 7168, 3989),
    ("dsv3_wi", 7168, 18432, 4128),
    ("dsv3_wo_ff", 18432, 7168, 4128),
    ("dsv3_shared_wi", 7168, 2048, 1274),
    ("dsv3_shared_wo", 2048, 7168, 1274),
)
DSV3_PATH_ROWS = (8, 173, 512)
# jamba-v0.1-52b's Mamba linears on the jamba_serve path at the served ranks
# (nsvd1 at 0.2): in_proj (4096 -> 16384 = 2 x d_inner), x_proj (8192 ->
# 288 = dt_rank 256 + 2 x d_state 16), dt_proj (K 256, the narrowest K on
# any path) and out_proj.  Rows: a decode step's 8 (stream) and the longest
# admission's 173 (mma).
JAMBA_PATH_SHAPES = (
    ("jamba_in_proj", 4096, 16384, 2621),
    ("jamba_x_proj", 8192, 288, 222),
    ("jamba_dt_proj", 256, 8192, 198),
    ("jamba_out_proj", 8192, 4096, 2184),
)
JAMBA_PATH_ROWS = (8, 173)
# whisper-small's MLP linears on the whisper path at the served rank (nsvd1
# at 0.2: 491; its 768 x 768 linears take 307): wi (768 -> 3072) and wo
# (3072 -> 768).  Rows: a decode step's 8 (stream) and the prefill's 128
# (8 prompts of 16; mma).
WHISPER_PATH_SHAPES = (
    ("whisper_wi", 768, 3072, 491),
    ("whisper_wo_ff", 3072, 768, 491),
)
WHISPER_PATH_ROWS = (8, 128)
# llava-next-mistral-7b's projector on the llava path at the served ranks
# (nsvd1 at 0.2): wi (1024 -> 4096, the only K of 1024 on any path) and wo
# (4096 -> 4096).  Rows: one image's 576 patches (mma; a batch's are above
# the 1024-row gate).
LLAVA_PATH_SHAPES = (
    ("llava_proj_wi", 1024, 4096, 655),
    ("llava_proj_wo", 4096, 4096, 1638),
)
LLAVA_PATH_ROWS = (576,)
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
# (case, lengths, table columns or None for the longest row's pages, (query,
# KV) heads), hd 128, block 16; at Mistral-7B's heads (32/8): page-edge
# lengths up to 700
# and a dead row (5.29 MB of bf16 K/V, L2-resident across calls); eight long
# rows, 30016 tokens (123 MB, beyond the 50 MB L2); one row at Mistral-7B's
# max_seq (134 MB); and the serve path's decode step halfway through its 32
# new tokens (its 8 prompts + 16, in its 16-column table: max_len 256,
# block 16); and that step at chatglm3-6b's heads (32/2, G 16: the glm_serve
# path's decode step, 16 (row, head) pairs for plan_splits to spread).
PAGED_CASES = (("phase", (1, 15, 16, 17, 255, 256, 700, 0), None, (32, 8)),
               ("long8", (512, 1024, 2048, 3000, 4096, 5000, 6144, 8192), None, (32, 8)),
               ("one32k", (32768,), None, (32, 8)),
               ("serve", (189, 149, 126, 81, 88, 39, 45, 35), 16, (32, 8)),
               ("glm", (189, 149, 126, 81, 88, 39, 45, 35), 16, (32, 2)))
# Kernel vs plain rounding through a decode step (and below, one eval
# batch), a few layers deep.  A MoE model's plain run takes the kernel run's
# expert choices (models.moe.RoutingTrace): top-k routing flips at near-ties
# on rounding-level differences (random routers have many), which moves a
# token's logits by O(1) whatever the kernels' error.
STEP_LOGIT_TOL = 5e-2
# (rows, n): the taps of a calibration batch (16 x 128 rows) at rwkv6-1.6b's
# d_model, Mistral-7B's d_model, rwkv6-1.6b's d_ff and Mistral-7B's d_ff;
# and at minicpm3-4b's kv_lora (256), q_lora (768), d_model (2560) and d_ff
# (6400), chatglm3-6b's d_ff (13696), and deepseek-v3-671b's kv_lora (512),
# q_lora (1536), attention output (16384 = 128 heads x v 128) and d_ff
# (18432; its d_model is Mistral-7B's 7168); whisper-small's encoder
# taps over a calibration batch's 16 x 1500 frames, at its d_model (768)
# and d_ff (3072); and llava's ``projector.in`` over a calibration batch's
# 16 x 576 patches (fp32 on the path: the tf32x3 kernel).
GRAM_SHAPES = ((2048, 256), (2048, 512), (2048, 768), (2048, 1536), (2048, 2048),
               (2048, 2560), (2048, 4096), (2048, 6400), (2048, 7168), (2048, 13696),
               (2048, 14336), (2048, 16384), (2048, 18432), (24000, 768), (24000, 3072),
               (9216, 1024))
# Max |kernel - plain| / max |plain|, for G and for sum |x|: both sum the
# same exact products (bf16 x bf16 is exact in fp32) in another order.
GRAM_TOL = 1e-5
# And for every entry: |kernel - plain|_ij <= GRAM_ELEM_TOL * sqrt(plain_ii
# plain_jj), which a fault in one off-diagonal tile cannot hide under the
# outlier channels' max |G| (~8.8e5 here, against ~45 for an ordinary
# entry).  sqrt(G_ii G_jj) bounds sum_k |x_ki x_kj| (Cauchy-Schwarz), so a
# summation-order error over R rows is at most gamma_R of it: 1e-4 is
# gamma_2048 in fp32 (measured on the H100: up to 4.5e-6 for the mma
# kernel).  G must also equal G^T exactly, entry by entry, and two runs must
# give the same bits.  The FMA kernel is held to the same on fp32 rows.
GRAM_ELEM_TOL = 1e-4
# fp32 rows hold the kernel to fp32's precision, which GRAM_ELEM_TOL cannot
# see (a single-pass TF32 Gram passes it at most rows): its per-element error
# against an fp64 Gram of the same rows (``gram_elem_err``) at most
# GRAM_GATE times the plain fp32 matmul's.  On the H100 at the phase's
# fp32 rows: the tf32x3 kernel 0.19-1.8x the plain's, a single-pass TF32
# Gram 10-180x (tools/gram_fault_check.py's dropped lo products).
GRAM_GATE = 4.0
# (B, S, Hq, Hkv): calibration and evaluation batches at Mistral-7B's heads,
# a ragged S, and G = 1.
FLASH_SHAPES = ((16, 128, 32, 8), (4, 2048, 32, 8), (4, 1000, 32, 8), (4, 1000, 8, 8))
# (B, S, Hq, Hkv, hd), bf16 only: whisper-small's decoder at a calibration
# and eval batch (12/12 heads x 64: G 1 at hd 64).
WHISPER_FLASH_SHAPES = ((16, 128, 12, 12, 64),)
# (B, S, Hq, Hkv, hd), fp32 only: small-llama's training batch (the train
# path: 4/4 heads x 32 on the CUDA-core forward).
SMALL_FLASH_SHAPES = ((16, 128, 4, 4, 32),)
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
# The backward phase (dtype, B, S, Hq, Hkv, hd): the forward's (4, 2048)
# row, small-llama's (16, 128) in fp32, a ragged S, and G 16 (chatglm3's
# 32/2 heads).
FLASH_BWD_SHAPES = (("bfloat16", 4, 2048, 32, 8, 128), ("float32", 16, 128, 4, 4, 32),
                    ("bfloat16", 4, 1000, 32, 8, 128), ("bfloat16", 4, 2048, 32, 2, 128))
# Per element of dq, dk, dv against the plain backward on ``bwd_elem_err``
# (tests/test_torch_cuda.py's FLASH_BWD_ELEM_TOL): both compute the same
# fp32 FA2 formulas in other orders; bf16 rounds each gradient once at the
# end (a flip is one ulp, under 2^-7 of |want|), four ulps allowed; fp32:
# sum order over up to S keys or S x G query rows.
FLASH_BWD_ELEM_TOL = {"bfloat16": 2 ** -5, "float32": 1e-4}
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
# The backward phase (case, BH, T, K, dtype, fixed w): every RWKV_SHAPES
# case (the eval batch is train_rwkv's (4 x 32 heads, 2048 tokens) shape),
# long memory (w = 1 - 1e-3 over 512 tokens: S and G sum hundreds of
# terms, so dw and du add large terms of both signs), and K 8, 16, 32 (the
# CPU-reduced config's K 8 in a one-block cluster, K 16 one block, K 32 a
# cluster of two).
RWKV_BWD_SHAPES = RWKV_SHAPES + (("long_memory", 32, 512, 64, "float32", 1.0 - 1e-3),
                                 ("k8", 64, 200, 8, "float32", None),
                                 ("k16", 64, 200, 16, "float32", None),
                                 ("k32", 64, 200, 32, "float32", None))
# dr, dk, dv, dw and du against the plain backward: max |kernel - plain| /
# max |plain| for each, and per element ``bwd_elem_err`` (|plain| plus the
# rms of its row over K plus the tensor's rms).  fp32: the kernels do not
# step S and G token by token as the plain scan does; they associate the
# same sums by chunks of 32 tokens (chunk states from a scan over chunks,
# then each chunk's own terms through running products of w), and run the
# products on the tensor cores in 3xTF32, each operand split into two
# TF32 parts rounded to nearest, which carry it to ~2^-22 (single-pass
# TF32 reaches ~1e-3 per element: the check catches it).  So every
# gradient is the plain one up to fp32 rounding of sums in other orders:
# the same algebra in fp32 on the CPU sits within 1.1e-6 of the plain fp32
# backward per element, long memory (w = 1 - 1e-3) and extreme decay
# included; 1e-4 allowed.  bf16: widened exactly to fp32 on both
# sides, each side then rounds every gradient to bf16 once (RWKV_TOL's and
# RWKV_ELEM_TOL's bf16 reasons).
RWKV_BWD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
RWKV_BWD_ELEM_TOL = {"float32": 1e-4, "bfloat16": 2 ** -6}
DEVICE_REPS = 5  # calls a nested row's profiled device time is the mean of
# The batched (per-expert) forms at moonshot-v1-16b-a3b's expert shapes:
# 64 experts, rank 667 at ratio 0.2 (k1 634, k2 33 at k1_frac 0.95), and at
# deepseek-v3-671b's: rank 1274 (k1 1210, k2 64) over 16 experts (the
# dsv3_serve cut) and over all 256; and at jamba-v0.1-52b's: rank 2548 (k1
# 2421, k2 127) at 4096 <-> 14336 over 8 experts (the jamba_serve cut) and
# all 16.  (case, experts E, capacity rows C, in K, out N, k1, k2, dtype,
# the route, routed top-k or 0): a decode step's 8 rows
# (stream), an eval batch's capacity rows through the gate/up and down
# projections (mma: 960, moonshot's (4, 2048) batch and deepseek-v3's (1,
# 1536) one; a calibration batch's 1280 rows are above the 1024-row gate,
# where the wrapper runs plain matmuls), dsv3_serve's widest admission
# capacity (109 rows, the 173-token prompt; mma), jamba_serve's (55 rows;
# mma), and fp32 (the tile kernel).  A
# routed case fills its rows by a top-k dispatch of the tokens whose
# capacity is C (8 tokens at decode; ``routed_rows``), so an expert no token
# chose keeps empty rows; the others leave their last C / 8 rows empty.  Held to NESTED_TOL and
# NESTED_ELEM_TOL, as the single form.
MOE_EXPERTS, MOE_K1, MOE_K2 = 64, 634, 33
DSV3_K1, DSV3_K2 = 1210, 64
JAMBA_K1, JAMBA_K2 = 2421, 127
NESTED_BATCHED_CASES = (
    ("decode", 64, 8, 2048, 1408, MOE_K1, MOE_K2, "bfloat16", "stream", 0),
    ("eval_gate", 64, 960, 2048, 1408, MOE_K1, MOE_K2, "bfloat16", "mma", 0),
    ("eval_down", 64, 960, 1408, 2048, MOE_K1, MOE_K2, "bfloat16", "mma", 0),
    ("fp32", 64, 8, 2048, 1408, MOE_K1, MOE_K2, "float32", "tile", 0),
    ("dsv3_decode_gate", 16, 8, 7168, 2048, DSV3_K1, DSV3_K2, "bfloat16", "stream", 8),
    ("dsv3_decode_down", 16, 8, 2048, 7168, DSV3_K1, DSV3_K2, "bfloat16", "stream", 8),
    ("dsv3_eval_gate", 16, 960, 7168, 2048, DSV3_K1, DSV3_K2, "bfloat16", "mma", 8),
    ("dsv3_admit_gate", 16, 109, 7168, 2048, DSV3_K1, DSV3_K2, "bfloat16", "mma", 8),
    ("dsv3_256_decode_gate", 256, 8, 7168, 2048, DSV3_K1, DSV3_K2, "bfloat16", "stream",
     8),
    ("dsv3_256_decode_down", 256, 8, 2048, 7168, DSV3_K1, DSV3_K2, "bfloat16", "stream",
     8),
    ("jamba_decode_gate", 8, 8, 4096, 14336, JAMBA_K1, JAMBA_K2, "bfloat16", "stream", 2),
    ("jamba_decode_down", 8, 8, 14336, 4096, JAMBA_K1, JAMBA_K2, "bfloat16", "stream", 2),
    ("jamba_16_decode_gate", 16, 8, 4096, 14336, JAMBA_K1, JAMBA_K2, "bfloat16", "stream",
     2),
    ("jamba_16_decode_down", 16, 8, 14336, 4096, JAMBA_K1, JAMBA_K2, "bfloat16", "stream",
     2),
    ("jamba_admit_gate", 8, 55, 4096, 14336, JAMBA_K1, JAMBA_K2, "bfloat16", "mma", 2))
# (E, C, n): a calibration batch's expert_buf and expert_mid taps (2048
# tokens; top-6 of 64 experts at capacity factor 1.25: C 240 (moonshot);
# top-8 of 16: C 1280 (the dsv3_serve cut); top-2 of 8: C 640 (the
# jamba_serve cut, whose (8, 14336, 14336) fp32 output is 6.6 GB)), bf16,
# held to GRAM_TOL and GRAM_ELEM_TOL with exact symmetry, expert by expert.
GRAM_BATCHED_SHAPES = ((64, 240, 2048), (64, 240, 1408), (16, 1280, 7168), (16, 1280, 2048),
                       (8, 640, 14336), (8, 640, 4096))
# And in fp32 (the tf32x3 kernel, held also to GRAM_GATE): moonshot's and
# the dsv3_serve cut's expert_buf taps, as an fp32 model's calibration
# gives them.
GRAM_BATCHED_FP32_SHAPES = ((64, 240, 2048), (16, 1280, 2048))


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
    cases = [(d, NESTED_SHAPES, NESTED_ROWS) for d in ("bfloat16", "float32")]
    cases.append(("bfloat16", NESTED_PATH_SHAPES, NESTED_PATH_ROWS))
    cases.append(("bfloat16", DSV3_PATH_SHAPES, DSV3_PATH_ROWS))
    cases.append(("bfloat16", JAMBA_PATH_SHAPES, JAMBA_PATH_ROWS))
    cases.append(("bfloat16", WHISPER_PATH_SHAPES, WHISPER_PATH_ROWS))
    cases.append(("bfloat16", LLAVA_PATH_SHAPES, LLAVA_PATH_ROWS))
    for dname, shapes, row_counts in cases:
        dt = getattr(torch, dname)
        for target, k_in, n, r in shapes:
            k1 = int(round(0.95 * r))
            k2 = r - k1

            def mk(*shape, s):
                return (torch.randn(shape, generator=gen, device="cuda") * s).to(dt)
            u, u2 = mk(k_in, k1, s=k_in ** -0.5), mk(k_in, k2, s=k_in ** -0.5)
            v, v2 = mk(k1, n, s=r ** -0.5), mk(k2, n, s=r ** -0.5)
            big_u, big_v = torch.cat([u, u2], 1), torch.cat([v, v2], 0)
            for m in row_counts:
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


def paged_inputs(torch, np, lens, pool, cols=None, heads=(32, 8)):
    """(q, k_pages, v_pages, k_scales, v_scales, block_tables, lengths) of a
    paged case at ``heads`` (query, KV; default Mistral-7B's), hd 128: bf16
    q; bf16 pools, or int8 with fp32 scales; each row's pages scattered over
    a shuffled pool, -1 past them in a table of ``cols`` columns (default:
    the longest row's pages)."""
    (hq, hkv), b, hd, bs = heads, len(lens), 128, 16
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
    for case, lens, cols, heads in PAGED_CASES:
        for pool in ("bfloat16", "int8"):
            q, kp, vp, ks, vs, bt, ln = paged_inputs(torch, np, lens, pool, cols=cols,
                                                     heads=heads)
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


def gram_fp64_gate(torch, ref, x, got, want) -> dict:
    """fp32 rows: the kernel's and the plain fp32 matmul's per-element
    errors against an fp64 Gram of the same rows (a batch (E, C, n): per
    expert), and whether the kernel's is within GRAM_GATE of the plain's."""
    x64 = x.double()
    g64 = x64.transpose(-1, -2) @ x64
    k_err, p_err = ref.gram_elem_err(got, g64), ref.gram_elem_err(want, g64)
    return dict(fp64_err=k_err, plain_fp64_err=p_err, fp64_gate=GRAM_GATE,
                fp64_ok=k_err <= GRAM_GATE * p_err)


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
            want_ran = "mma" if dname == "bfloat16" else "tf32x3"
            err = float((got_g - want_g).abs().max())
            scale = float(want_g.abs().max())
            a_err = float((got_a - want_a).abs().max())
            a_scale = float(want_a.abs().max())
            e_err = ref.gram_elem_err(got_g, want_g)
            sym = bool(torch.equal(got_g, got_g.T))
            again = ops.gram_accumulate(x)
            same_bits = bool(torch.equal(again[0], got_g) and torch.equal(again[1], got_a))
            del again
            gate = gram_fp64_gate(torch, ref, x, got_g, want_g) if dname == "float32" else {}
            # The FMA kernel on the same rows (it ran all of them before the
            # mma kernel took bf16 and the tf32x3 kernel fp32, and still takes
            # ragged widths and unaligned rows), with its event and device
            # times beside the kernel's, from this run, held to GRAM_TOL,
            # GRAM_ELEM_TOL, exact symmetry and same bits on every row (its
            # sums of 1024 rows moved into a running sum keep 24000 bf16 rows
            # within GRAM_TOL, as gram_mma's do).
            fma_g, fma_a = ops.launch(x, "fma")
            fma_err = float((fma_g - want_g).abs().max())
            fma_a_err = float((fma_a - want_a).abs().max())
            fma_e_err = ref.gram_elem_err(fma_g, want_g)
            fma_again = ops.launch(x, "fma")
            fma_ok = (bool(torch.isfinite(fma_g).all()) and fma_err <= GRAM_TOL * scale
                      and fma_a_err <= GRAM_TOL * a_scale and fma_e_err <= GRAM_ELEM_TOL
                      and bool(torch.equal(fma_g, fma_g.T))
                      and bool(torch.equal(fma_again[0], fma_g)
                               and torch.equal(fma_again[1], fma_a)))
            ok = (bool(torch.isfinite(got_g).all()) and err <= GRAM_TOL * scale
                  and a_err <= GRAM_TOL * a_scale and e_err <= GRAM_ELEM_TOL and sym
                  and same_bits and gate.get("fp64_ok", True) and ran == want_ran and fma_ok)
            del got_g, want_g, fma_g, fma_a, fma_again
            ms = time_ms(lambda: ops.gram_accumulate(x), reps=5)
            plain = time_ms(lambda: ref.gram_accumulate_ref(x), reps=5)
            fma_ms = time_ms(lambda: ops.launch(x, "fma"), reps=5)
            lib_fn, lib_name = gram_library(torch, x)
            lib = time_ms(lib_fn, reps=5)
            # Device time of one call (the mean of DEVICE_REPS; the tf32x3
            # kernel's reduce apart), of the library call and of the FMA
            # kernel.
            prof = profile_step(torch, lambda: [ops.gram_accumulate(x) for _ in range(
                DEVICE_REPS)], quiet=True)
            dev_ms = prof["device_busy_ms"] / DEVICE_REPS
            reduce_dev = sum(v for k, v in prof["kernels"].items()
                             if "gram_tf32x3_reduce" in k) / DEVICE_REPS
            lib_dev = profile_step(torch, lambda: [lib_fn() for _ in range(DEVICE_REPS)],
                                   quiet=True)["device_busy_ms"] / DEVICE_REPS
            fma_dev = profile_step(torch, lambda: [ops.launch(x, "fma") for _ in range(
                DEVICE_REPS)], quiet=True)["device_busy_ms"] / DEVICE_REPS
            nbytes = x.numel() * x.element_size() + 4 * (n * n + n)
            flops = rows * n * (n + 1)  # upper triangle: products exact for bf16
            b, by = bound_ms(nbytes, flops, dname)
            # fp32: the bound of the arithmetic the tf32x3 kernel does (three
            # TF32 products a pair, at the TF32 peak).  The FFMA bound beside
            # it is the FMA kernel's (fp32 FMAs, whatever the rows' dtype).
            rate = dname
            b_ffma, by_ffma = bound_ms(nbytes, flops, "float32")
            if ran == "tf32x3":
                rate = "tf32x3"
                b, by = bound_ms(nbytes, 3 * flops, "tf32")
            row = dict(kernel="gram", dtype=dname, rows=rows, n=n, ran=ran, max_abs_err=err,
                       ref_max_abs=scale, tol=GRAM_TOL * scale, abs_sum_err=a_err,
                       abs_sum_tol=GRAM_TOL * a_scale, elem_err=e_err,
                       elem_tol=GRAM_ELEM_TOL, symmetric=sym, same_bits=same_bits, **gate,
                       ok=ok, ms=ms, device_ms=dev_ms, reduce_device_ms=reduce_dev,
                       splits=ops.plan_splits(rows, n, 1, ops.sm_count(x.device))
                       if ran == "tf32x3" else 1,
                       plain_ms=plain, library=lib_name, library_ms=lib,
                       library_device_ms=lib_dev, fma_max_abs_err=fma_err,
                       fma_abs_sum_err=fma_a_err, fma_elem_err=fma_e_err, fma_ok=fma_ok,
                       fma_ms=fma_ms, fma_device_ms=fma_dev, bytes=nbytes, flops=flops,
                       bound_ms=b, bound_by=by, bound_rate=rate, bound_ffma_ms=b_ffma,
                       bound_ffma_by=by_ffma,
                       tflops=flops / dev_ms * 1e-9 if dev_ms > 0 else None)
            rows_out.append(row)
            gate_txt = "" if not gate else (
                f" fp64 err {gate['fp64_err']:.3e} (plain {gate['plain_fp64_err']:.3e}, gate "
                f"{GRAM_GATE:g}x)")
            split_txt = "" if ran != "tf32x3" else (
                f", {row['splits']} splits, reduce {reduce_dev:.4f}")
            log(f"gram   {dname:8s} rows={rows} n={n:<5d} {ran} err={err:.3e} (tol "
                f"{row['tol']:.3e}) |x| err={a_err:.3e} (tol {row['abs_sum_tol']:.3e}) elem "
                f"err {e_err:.3e} (tol {GRAM_ELEM_TOL:.0e}){gate_txt} symmetric={sym} "
                f"same bits={same_bits} {'OK' if ok else 'FAIL'}  kernel {ms:.3f} ms (device "
                f"{dev_ms:.4f}{split_txt})  plain {plain:.3f} ms  library({lib_name}) "
                f"{lib:.3f} ms (device {lib_dev:.4f})  bound {b:.4f} ms ({by}, {rate}"
                f"; FFMA {b_ffma:.4f})  fma kernel device {fma_dev:.4f} (event "
                f"{fma_ms:.3f}, err {fma_err:.3e} |x| err {fma_a_err:.3e} elem err "
                f"{fma_e_err:.3e} {'OK' if fma_ok else 'FAIL'})")
    return rows_out


def routed_rows(torch, gen, e: int, cap: int, top_k: int):
    """(E, C) bool: the capacity slots a top-``top_k`` dispatch fills, of
    the tokens whose capacity at factor 1.25 is ``cap`` (a decode step's 8
    tokens at the floor of 8), their experts drawn by random router logits.
    Slots past an expert's tokens stay empty, as ``models.moe``'s dispatch
    leaves them."""
    from repro_torch.models.moe import _dispatch

    n = 8 if cap <= 8 else round(cap * e / (top_k * 1.25))
    logits = torch.randn((n, e), generator=gen, device="cuda")
    top_w, top_i = torch.topk(torch.softmax(logits, -1), top_k, dim=-1)
    ones = torch.ones((n, 1), device="cuda")
    return _dispatch(ones, top_w, top_i, e, cap).buf[..., 0] != 0


def nested_batched_phase(torch, ops, ref):
    """The batched nested form at the MoE expert shapes, one case per route,
    per element against the batched plain version, beside two bmms over
    the experts' concatenated factors (x [u|u2] [v;v2], the single form's
    ``multi_dot`` counterpart) and the bound."""
    rows_out = []
    gen = torch.Generator(device="cuda").manual_seed(5)
    for case, e, m, k_in, n, k1, k2, dname, route, routed in NESTED_BATCHED_CASES:
        dt = getattr(torch, dname)
        r = k1 + k2

        def mk(*shape, s):
            return (torch.randn(shape, generator=gen, device="cuda") * s).to(dt)
        u, u2 = mk(e, k_in, k1, s=k_in ** -0.5), mk(e, k_in, k2, s=k_in ** -0.5)
        v, v2 = mk(e, k1, n, s=r ** -0.5), mk(e, k2, n, s=r ** -0.5)
        x = mk(e, m, k_in, s=1.0)
        if routed:
            x *= routed_rows(torch, gen, e, m, routed)[..., None].to(dt)
        else:
            x[:, m - m // 8:] = 0  # capacity slots left empty
        held = int((x != 0).any(-1).any(-1).sum())
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
        # The bound counts what this run's data needs: the factors of the
        # experts holding a row, and the products of the rows held (an
        # empty capacity row is all zeros); beside it the bound with every
        # expert's factors read, as the kernel reads them.
        el = x.element_size()
        factor_bytes = el * (u.numel() + v.numel() + u2.numel() + v2.numel())
        rows_held = int((x != 0).any(-1).sum())
        nbytes = el * (x.numel() + e * m * n) + factor_bytes * held // e
        flops = 2 * rows_held * (k_in * r + r * n)
        b, by = bound_ms(nbytes, flops, dname)
        b_all = bound_ms(el * (x.numel() + e * m * n) + factor_bytes, flops, dname)[0]
        row = dict(kernel="nested_lowrank_batched", case=case, dtype=dname, E=e, M=m, K=k_in,
                   N=n, rank=r, k1=k1, k2=k2, experts_with_rows=held, rows_held=rows_held,
                   bound_all_experts_ms=b_all, ran=ran, max_abs_err=err, ref_max_abs=scale,
                   tol=NESTED_TOL[dname] * scale, elem_err=e_err,
                   elem_tol=NESTED_ELEM_TOL[dname], ok=ok, ms=ms, device_ms=dev_ms,
                   plain_ms=plain, library="bmm(bmm(x, [u|u2]), [v;v2])", library_ms=lib_ms,
                   library_device_ms=lib_dev, bytes=nbytes, flops=flops, bound_ms=b,
                   bound_by=by)
        rows_out.append(row)
        log(f"nested batched {dname:8s} {case:9s} E={e} ({held} holding rows) C={m:<3d} "
            f"{k_in}->{n} rank {r} {ran:6s} "
            f"err={err:.3e} (tol {row['tol']:.3e}) elem err {e_err:.3e} (tol "
            f"{row['elem_tol']:.3e}) {'OK' if ok else 'FAIL'}  kernel {ms:.4f} ms (device "
            f"{dev_ms:.4f})  plain {plain:.3f} ms  library {lib_ms:.4f} ms (device "
            f"{lib_dev:.4f})  bound {b:.4f} ms ({by}, {nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.1f} GFLOP; every expert's factors {b_all:.4f} ms)")
        del x, u, v, u2, v2, big_u, big_v
    return rows_out


def gram_batched_phase(torch, ops, ref):
    """Per-expert Grams of zero-padded capacity buffers in one launch, each
    expert per element and exactly symmetric, two runs bit-identical, fp32
    also within GRAM_GATE against fp64."""
    rows_out = []
    gen = torch.Generator(device="cuda").manual_seed(6)
    cases = ([(*shape, "bfloat16") for shape in GRAM_BATCHED_SHAPES]
             + [(*shape, "float32") for shape in GRAM_BATCHED_FP32_SHAPES])
    for e, rows, n, dname in cases:
        buf = torch.randn((e, rows, n), generator=gen, device="cuda")
        buf[:, :, ::97] *= 20.0  # outlier channels
        buf[:, rows - rows // 5:] = 0  # capacity slots left empty
        buf = buf.to(getattr(torch, dname))
        want_ran = "mma" if dname == "bfloat16" else "tf32x3"
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
        again = ops.gram_accumulate_batched(buf)
        same_bits = bool(torch.equal(again[0], got_g) and torch.equal(again[1], got_a))
        del again
        gate = gram_fp64_gate(torch, ref, buf, got_g, want_g) if dname == "float32" else {}
        ok = (bool(torch.isfinite(got_g).all()) and err <= GRAM_TOL * scale
              and a_err <= GRAM_TOL * a_scale and e_err <= GRAM_ELEM_TOL and sym
              and same_bits and gate.get("fp64_ok", True) and ran == want_ran
              and after[1] == before[1] + 1)
        del got_g, want_g
        # One PyTorch call for the same Grams: cuBLAS's bf16 tensor cores
        # with fp32 output, or its fp32 bmm (TF32 off).
        bt = buf.transpose(1, 2)
        if dname == "bfloat16":
            lib_fn, lib_name = (lambda: torch.bmm(bt, buf, out_dtype=torch.float32),
                                "bmm(out_dtype=fp32)")
        else:
            lib_fn, lib_name = (lambda: torch.bmm(bt, buf)), "fp32 bmm"
        ms = time_ms(lambda: ops.gram_accumulate_batched(buf), reps=5)
        plain = time_ms(lambda: ref.gram_accumulate_batched_ref(buf), reps=5)
        lib = time_ms(lib_fn, reps=5)
        dev_ms = profile_step(torch, lambda: [ops.gram_accumulate_batched(buf) for _ in range(
            DEVICE_REPS)], quiet=True)["device_busy_ms"] / DEVICE_REPS
        lib_dev = profile_step(torch, lambda: [lib_fn() for _ in range(DEVICE_REPS)],
                               quiet=True)["device_busy_ms"] / DEVICE_REPS
        nbytes = buf.numel() * buf.element_size() + 4 * e * (n * n + n)
        # Upper triangles (products exact for bf16; fp32: three TF32 products
        # a pair), of the rows held.
        flops = int((buf != 0).any(-1).sum()) * n * (n + 1)
        b, by = (bound_ms(nbytes, flops, "bfloat16") if dname == "bfloat16"
                 else bound_ms(nbytes, 3 * flops, "tf32"))
        row = dict(kernel="gram_batched", dtype=dname, E=e, rows=rows, n=n, ran=ran,
                   max_abs_err=err, ref_max_abs=scale, tol=GRAM_TOL * scale,
                   abs_sum_err=a_err, abs_sum_tol=GRAM_TOL * a_scale, elem_err=e_err,
                   elem_tol=GRAM_ELEM_TOL, symmetric=sym, same_bits=same_bits, **gate, ok=ok,
                   ms=ms, device_ms=dev_ms, plain_ms=plain, library=lib_name, library_ms=lib,
                   library_device_ms=lib_dev, bytes=nbytes, flops=flops, bound_ms=b,
                   bound_by=by)
        rows_out.append(row)
        gate_txt = "" if not gate else (
            f" fp64 err {gate['fp64_err']:.3e} (plain {gate['plain_fp64_err']:.3e})")
        log(f"gram batched {dname:8s} E={e} rows={rows} n={n:<5d} {ran} err={err:.3e} (tol "
            f"{row['tol']:.3e}) |x| err={a_err:.3e} elem err {e_err:.3e} (tol "
            f"{GRAM_ELEM_TOL:.0e}){gate_txt} symmetric={sym} same bits={same_bits} "
            f"{'OK' if ok else 'FAIL'}  kernel {ms:.3f} "
            f"ms (device {dev_ms:.4f})  plain {plain:.3f} ms  library({lib_name}) {lib:.3f} "
            f"ms (device {lib_dev:.4f})  bound {b:.4f} ms ({by}, {nbytes / 1e6:.1f} MB)")
        del buf
    return rows_out


def flash_phase(torch, ops, ref):
    rows_out = []
    gen = torch.Generator(device="cuda").manual_seed(3)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    cases = [(d, *shape, 128) for d in ("bfloat16", "float32") for shape in FLASH_SHAPES
             if not (d == "float32" and shape[1] == 1000)]  # ragged, G = 1: bf16 only
    cases += [("bfloat16", *shape) for shape in WHISPER_FLASH_SHAPES]
    cases += [("float32", *shape) for shape in SMALL_FLASH_SHAPES]
    for dname, b, s, hq, hkv, hd in cases:
        dt = getattr(torch, dname)

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
        # Device time of one call (the mean of DEVICE_REPS) and of SDPA's:
        # at small shapes the events above mostly time the host.
        dev_ms = profile_step(torch, lambda: [ops.flash_attention(q, k, v) for _ in range(
            DEVICE_REPS)], quiet=True)["device_busy_ms"] / DEVICE_REPS
        lib_dev = profile_step(torch, lambda: [sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
                                               for _ in range(DEVICE_REPS)],
                               quiet=True)["device_busy_ms"] / DEVICE_REPS
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        flops = 2 * b * hq * hd * s * (s + 1)
        bnd, by = bound_ms(nbytes, flops, dname)
        tflops = flops / ms * 1e-9
        row = dict(kernel="flash_attention", dtype=dname, B=b, S=s, Hq=hq, Hkv=hkv,
                   hd=hd, max_abs_err=err, ref_max_abs=scale,
                   tol=FLASH_TOL[dname] * scale, elem_err=e_err,
                   elem_tol=FLASH_ELEM_TOL[dname], ok=ok, ms=ms, device_ms=dev_ms,
                   plain_ms=plain, library_ms=lib, library_device_ms=lib_dev, bytes=nbytes,
                   flops=flops, bound_ms=bnd, bound_by=by, tflops=tflops,
                   bound_share=bnd / ms)
        rows_out.append(row)
        log(f"flash  {dname:8s} B={b:<2d} S={s:<4d} Hq/Hkv={hq}/{hkv} hd={hd} err={err:.3e} "
            f"(tol {row['tol']:.3e}) elem err {e_err:.3e} (tol {row['elem_tol']:.3e}) "
            f"{'OK' if ok else 'FAIL'}  kernel {ms:.3f} ms (device {dev_ms:.4f})  "
            f"({tflops:.1f} TFLOP/s, {bnd / ms:.1%} of bound)  plain {plain:.3f} ms  "
            f"library(sdpa) {lib:.3f} ms (device {lib_dev:.4f}; {flops / lib * 1e-9:.1f} "
            f"TFLOP/s)  bound {bnd:.4f} ms ({by})")
    return rows_out


def bwd_elem_err(torch, got, want) -> float:
    """Max over elements of |got - want| / (|want| + rms of want's row + rms
    of want): ``elem_err`` with the tensor's rms as a floor, since a
    gradient row can vanish by cancellation (position 0's dq is dS K with
    dS = dO.v0 - dO.o0 = 0 exactly: rounding noise in both versions)."""
    w = want.float()
    rms = w.pow(2).mean(-1, keepdim=True).sqrt()
    floor = w.pow(2).mean().sqrt()
    return float(((got.float() - w).abs() / (w.abs() + rms + floor).clamp_min(1e-30)).max())


def flash_bwd_phase(torch, ops, ref):
    """The three backward kernels against the plain FA2 backward on the
    same inputs (the plain forward's out and lse, a random dO), per
    element within FLASH_BWD_ELEM_TOL; the forward's lse against the plain
    one; timed (CUDA events and profiled device time) beside the plain
    backward, SDPA's backward alone and the bound: 2.5 times the forward's
    causal FLOPs (two products forward, five backward, of which S is
    recomputed: counted once) against every operand read once and every
    gradient written once."""
    rows_out = []
    gen = torch.Generator(device="cuda").manual_seed(5)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for dname, b, s, hq, hkv, hd in FLASH_BWD_SHAPES:
        dt = getattr(torch, dname)

        def mk(h):
            return torch.randn((b, s, h, hd), generator=gen, device="cuda").to(dt)
        q, k, v, dout = mk(hq), mk(hkv), mk(hkv), mk(hq)
        out, lse = ref.flash_attention_fwd_ref(q, k, v)
        klse = torch.empty_like(lse)
        kout = ops._forward(q, k, v, klse)
        kind = ops.bwd_plan(dt, hd, hq // hkv).kernel
        before = (ops.backward_tensor_core_launches, ops.backward_cuda_core_launches)
        got = ops.backward(q, k, v, out, lse, dout)
        ran = dict(zip(("tensor_core", "cuda_core"), (
            ops.backward_tensor_core_launches - before[0],
            ops.backward_cuda_core_launches - before[1])))
        want = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout)
        again = ops.backward(q, k, v, out, lse, dout)
        torch.cuda.synchronize()
        errs = {n: bwd_elem_err(torch, x, w) for n, x, w in zip(("dq", "dk", "dv"), got, want)}
        abs_err = max(float((x.float() - w.float()).abs().max()) for x, w in zip(got, want))
        lse_err = float((klse - lse).abs().max())
        same_bits = all(torch.equal(x, y) for x, y in zip(got, again))
        ok = (all(bool(torch.isfinite(x).all()) for x in got) and same_bits
              and ran == {n: int(n == kind) for n in ran}
              and max(errs.values()) <= FLASH_BWD_ELEM_TOL[dname]
              and lse_err <= 1e-5 * float(lse.abs().max()) + 1e-5)
        del got, want, again, kout, klse
        ms = time_ms(lambda: ops.backward(q, k, v, out, lse, dout), reps=5)
        dev = profile_step(torch, lambda: ops.backward(q, k, v, out, lse, dout), quiet=True,
                           windows=3)
        plain = time_ms(lambda: ref.flash_attention_bwd_ref(q, k, v, out, lse, dout), reps=3)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        ot = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
        dot = dout.transpose(1, 2)
        lib = time_ms(lambda: torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True),
                      reps=5)
        del ot, qt, kt, vt
        el = q.element_size()
        # Read q, k, v, out, dO and lse; write dq, dk, dv.
        nbytes = (4 * q.numel() + 2 * (k.numel() + v.numel())) * el + 4 * lse.numel()
        flops = 2.5 * 2 * b * hq * hd * s * (s + 1)
        bnd, by = bound_ms(nbytes, flops, dname)
        dev_ms = dev["device_busy_ms"]
        row = dict(kernel="flash_attention_bwd", dtype=dname, B=b, S=s, Hq=hq, Hkv=hkv, hd=hd,
                   ran=kind, elem_err=errs, elem_tol=FLASH_BWD_ELEM_TOL[dname],
                   max_abs_err=abs_err, lse_max_abs_err=lse_err,
                   bit_identical_reruns=same_bits, ok=ok, ms=ms, device_ms=dev_ms,
                   device_kernels=dev["kernels"], plain_ms=plain,
                   library_ms=lib, bytes=nbytes, flops=flops, bound_ms=bnd, bound_by=by,
                   tflops=flops / dev_ms * 1e-9, bound_share=bnd / dev_ms)
        rows_out.append(row)
        log(f"flash_bwd {dname:8s} B={b:<2d} S={s:<4d} Hq/Hkv={hq}/{hkv} hd={hd} ran {ran} "
            f"(plan {kind}) elem err "
            + " ".join(f"{n} {e:.2e}" for n, e in errs.items())
            + f" (tol {FLASH_BWD_ELEM_TOL[dname]:.2e}) lse err {lse_err:.2e} reruns "
            f"{'bit-identical' if same_bits else 'DIFFER'} {'OK' if ok else 'FAIL'}  kernels "
            f"{ms:.3f} ms, device {dev_ms:.3f} ms ({flops / dev_ms * 1e-9:.1f} TFLOP/s, "
            f"{bnd / dev_ms:.1%} of bound)  plain {plain:.3f} ms  library (sdpa backward) "
            f"{lib:.3f} ms  bound {bnd:.4f} ms ({by})")
        log("    device by kernel: " + ", ".join(f"{k[:40]} {v:.3f}" for k, v in sorted(
            dev["kernels"].items(), key=lambda kv: -kv[1])[:4]))
        del q, k, v, dout, out, lse
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


RWKV_BWD_NAMES = ("dr", "dk", "dv", "dw", "du")
# The backward's three kernels (csrc/rwkv6_bwd.cu), named with one prefix
# that no other kernel's name holds (the forward's is rwkv6_kernel).
RWKV_BWD_PREFIX = "rwkv6_bwd_"
RWKV_BWD_KERNELS = ("summaries", "scan", "grads")


def rwkv6_bwd_split(kernels: dict) -> dict:
    """Device ms of each of the backward's kernels from a profile's
    by-name sums."""
    return {n: sum(ms for kk, ms in kernels.items() if RWKV_BWD_PREFIX + n in kk)
            for n in RWKV_BWD_KERNELS}


def rwkv6_bwd_design_bound(nbytes: float, bh: int, t: int, k: int, chunk: int):
    """The chunked design's own bound (the row's ``bound_ms``): its products
    (per chunk the summaries' 2 x 2 C K^2, P's and Q's 2 x 2 C K^2, M's
    2 C^2 K, dv's 2 C K (K + C)) as three TF32 products at the TF32 peak,
    plus its CUDA-core FLOPs at the fp32 peak (per column and chunk: the Z
    and Y updates, 3 each, and A's 4 over the C (C - 1) / 2 pairs, T4's 4
    over each thread's half of them; the scan's 2 K^2), against the row's
    bytes.  Counted for T / C chunks: the tokens this run's data has."""
    c = chunk
    pairs = c * (c - 1) // 2
    t4_pairs = sum(c - 1 - i for i in range(c // 2))
    per_chunk_mma = 10 * c * k * k + 4 * c * c * k
    per_chunk_cuda = k * (pairs * (3 + 3 + 4) + 2 * t4_pairs * 4) + 2 * k * k
    n = bh * t / c
    t_ops = (3 * per_chunk_mma * n / PEAK_FLOPS["tf32"]
             + per_chunk_cuda * n / PEAK_FLOPS["float32"]) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rwkv6_bwd_phase(torch, ops, ref):
    """The backward's three kernels (one ``backward`` call) against the
    plain backward (``rwkv6_scan_bwd_ref``) on the same inputs and a random
    dy, every gradient within RWKV_BWD_TOL globally and RWKV_BWD_ELEM_TOL
    per element, two runs bit-identical; timed (CUDA events, and the
    profiled device time of each kernel and of the call) beside the plain
    backward and two bounds, each against r, k, v, w, dy read and dr, dk,
    dv, dw written once, u read and du written once.  ``bound_ms``: the
    design's own (``rwkv6_bwd_design_bound``: the arithmetic the kernels
    do, their products as three TF32 products), as the tf32x3 gram's.
    ``bound_ffma_ms``, kept from the per-token design so that its share
    means the same before and after: the recurrence stepped once (3 K^2
    FLOPs a token and head: two products and a sum an element of S), the
    four sums dr, dk, dw, dv (8 K^2), G's update (3 K^2) and the bonus
    terms (16 K) at the fp32 peak.  No PyTorch call computes this gradient
    (library none)."""
    rows_out = []
    gen = torch.Generator(device="cuda").manual_seed(6)
    for case, bh, t, k, dname, w_fixed in RWKV_BWD_SHAPES:
        args = rwkv6_inputs(torch, gen, bh, t, k, dname, w_fixed)
        dy = torch.randn((bh, t, k), generator=gen, device="cuda").to(args[0].dtype)
        heads = [x[:, None] for x in (*args, dy)]  # (BH, 1, T, K) views, u (BH, 1, K)
        before = ops.backward_launches
        got = [g[:, 0] for g in ops.backward(*heads)]
        launched = ops.backward_launches - before
        again = [g[:, 0] for g in ops.backward(*heads)]
        want = ref.rwkv6_scan_bwd_ref(*args, dy)
        torch.cuda.synchronize()
        glob = {n: float((g.float() - x.float()).abs().max()
                         / x.float().abs().max().clamp_min(1e-30))
                for n, g, x in zip(RWKV_BWD_NAMES, got, want)}
        elem = {n: bwd_elem_err(torch, g, x) for n, g, x in zip(RWKV_BWD_NAMES, got, want)}
        abs_err = max(float((g.float() - x.float()).abs().max()) for g, x in zip(got, want))
        same_bits = all(torch.equal(a, b) for a, b in zip(got, again))
        ok = (all(bool(torch.isfinite(g).all()) for g in got) and same_bits and launched == 1
              and all(x.dtype == a.dtype for x, a in zip(got, args))
              and max(glob.values()) <= RWKV_BWD_TOL[dname]
              and max(elem.values()) <= RWKV_BWD_ELEM_TOL[dname])
        del got, again, want
        ms = time_ms(lambda: ops.backward(*heads), reps=5)
        for _ in range(3):  # the profiler can drop every event of one kernel: profile again
            dev = profile_step(torch, lambda: ops.backward(*heads), quiet=True, windows=3)
            split = rwkv6_bwd_split(dev["kernels"])
            if all(split.values()):
                break
        kern_ms = sum(split.values())
        plain = time_ms(lambda: ref.rwkv6_scan_bwd_ref(*args, dy), reps=2, warmup=1)
        el = args[0].element_size()
        nbytes = 9 * bh * t * k * el + 2 * 4 * bh * k
        flops = bh * t * (14 * k * k + 16 * k)
        bnd, by = rwkv6_bwd_design_bound(nbytes, bh, t, k, ops.BWD_CHUNK)
        bnd_ffma, by_ffma = bound_ms(nbytes, flops, "float32")
        dev_ms = dev["device_busy_ms"]
        row = dict(kernel="rwkv6_bwd", case=case, dtype=dname, BH=bh, T=t, K=k, w=w_fixed,
                   rel_err=glob, tol=RWKV_BWD_TOL[dname], elem_err=elem,
                   elem_tol=RWKV_BWD_ELEM_TOL[dname], max_abs_err=abs_err,
                   bit_identical_reruns=same_bits, ok=ok, ms=ms, device_ms=dev_ms,
                   kernel_device_ms=kern_ms, kernel_split_ms=split,
                   split_complete=all(split.values()),
                   device_kernels=dev["kernels"], plain_ms=plain, library_ms=None,
                   bytes=nbytes, flops=flops, bound_ms=bnd, bound_by=by,
                   bound_ffma_ms=bnd_ffma, bound_ffma_by=by_ffma,
                   bound_share=bnd / kern_ms if kern_ms > 0 else None,
                   bound_ffma_share=bnd_ffma / kern_ms if kern_ms > 0 else None)
        rows_out.append(row)
        log(f"rwkv6_bwd {dname:8s} {case:11s} BH={bh:<3d} T={t:<4d} K={k:<2d} rel err "
            + " ".join(f"{n} {e:.2e}" for n, e in glob.items())
            + f" (tol {RWKV_BWD_TOL[dname]:.0e}) elem err "
            + " ".join(f"{n} {e:.2e}" for n, e in elem.items())
            + f" (tol {RWKV_BWD_ELEM_TOL[dname]:.1e}) reruns "
            f"{'bit-identical' if same_bits else 'DIFFER'} {'OK' if ok else 'FAIL'}  kernel "
            f"{ms:.3f} ms, device {kern_ms:.4f} ms ("
            + " ".join(f"{n} {v:.4f}" for n, v in split.items())
            + ("" if all(split.values()) else " (a kernel missing from the profile)")
            + f"; call {dev_ms:.4f}; {bnd / max(kern_ms, 1e-9):.1%} of bound, "
            f"{bnd_ffma / max(kern_ms, 1e-9):.1%} of FFMA's)  plain {plain:.3f} ms  library "
            f"none  bound {bnd:.4f} ms ({by}, {nbytes / 1e6:.1f} MB); FFMA's {bnd_ffma:.4f} ms "
            f"({by_ffma}, {flops / 1e9:.2f} GFLOP)")
        del args, dy, heads
        torch.cuda.empty_cache()
    return rows_out


KERNELS = ("nested_lowrank", "paged_attention", "gram", "flash_attention", "rwkv6")


def _ops(name):
    return importlib.import_module(f"repro_torch.kernels.{name}.ops")


def reset_counts() -> None:
    for name in KERNELS:
        _ops(name).launches = 0
    fa = _ops("flash_attention")
    fa.tensor_core_launches = fa.cuda_core_launches = fa.backward_launches = 0
    fa.backward_tensor_core_launches = fa.backward_cuda_core_launches = 0
    nlr = _ops("nested_lowrank")
    nlr.stream_launches = nlr.mma_launches = nlr.tile_launches = 0
    nlr.batched_by_kernel.update(stream=0, mma=0, tile=0)
    nlr.shape_launches.clear()
    nlr.gate_calls = nlr.split_calls = 0
    gram = _ops("gram")
    gram.mma_launches = gram.tf32x3_launches = gram.fma_launches = 0
    gram.batched_launches = gram.reduce_launches = 0
    gram.shape_launches.clear()
    _ops("paged_attention").combine_launches = 0
    rw = _ops("rwkv6")
    rw.vec16_launches = rw.vec4_launches = rw.backward_launches = 0


def read_counts() -> dict:
    return {name: _ops(name).launches for name in KERNELS}


def flash_split_ok(counts: dict) -> tuple:
    """flash_attention's launches by kernel since ``reset_counts``, and
    whether every one ran the bf16 tensor-core kernel (the models are bf16)."""
    fa = _ops("flash_attention")
    split = {"tensor_core": fa.tensor_core_launches, "cuda_core": fa.cuda_core_launches}
    return split, split == {"tensor_core": counts["flash_attention"], "cuda_core": 0}


def rwkv6_split_ok(counts: dict) -> tuple:
    """rwkv6's launches by copy width since ``reset_counts`` and its
    backward's, and whether every forward took 16-byte copies (the model's
    permuted views are aligned) and the backward ran as often as ``counts``
    says (train_counts' ``rwkv6_backward``; never on a path without it)."""
    rw = _ops("rwkv6")
    split = {"vec16": rw.vec16_launches, "vec4": rw.vec4_launches,
             "backward": rw.backward_launches}
    return split, split == {"vec16": counts["rwkv6"], "vec4": 0,
                            "backward": counts.get("rwkv6_backward", 0)}


def nested_split() -> dict:
    """nested_lowrank's launches by kernel since ``reset_counts``."""
    nlr = _ops("nested_lowrank")
    return {"stream": nlr.stream_launches, "mma": nlr.mma_launches,
            "tile": nlr.tile_launches}


def shape_split() -> dict:
    """nested_lowrank's launches since ``reset_counts`` by "kernel KxN" of
    the single form (the linear that ran), the batched form's apart."""
    return {f"{k}{' batched' if b else ''} {k_in}x{n}": c for (k, k_in, n, b), c
            in sorted(_ops("nested_lowrank").shape_launches.items())}


def mixer_layers(model, mixer) -> int:
    """Layers whose mixer runs the kernel ``mixer`` (flash_attention: the
    gqa layers; rwkv6: the rwkv ones; jamba has one gqa layer in 5)."""
    kind = {"flash_attention": "gqa", "rwkv6": "rwkv"}[mixer]
    return sum(m == kind for m, _ in model.specs)


def gram_split() -> dict:
    """gram's launches by kernel since ``reset_counts``."""
    gram = _ops("gram")
    return {"mma": gram.mma_launches, "tf32x3": gram.tf32x3_launches,
            "fma": gram.fma_launches}


def gram_shape_split() -> dict:
    """gram's launches since ``reset_counts`` by "n" of the single form and
    "batched n" of the batched form (n: the tap's width)."""
    return {f"{'batched ' if b else ''}{n}": c for (n, b), c
            in sorted(_ops("gram").shape_launches.items())}


def batched_gram_expect(cfg, model, batches: int) -> dict:
    """The batched gram's launches by "batched n" of ``batches`` calibration
    batches: each MoE layer's expert_buf (d_model wide) and expert_mid
    (d_ff_expert wide) taps, once a batch."""
    out: dict = {}
    moe_layers = sum(f == "moe" for _, f in model.specs)
    for n in ((cfg.d_model, cfg.moe.d_ff_expert) if moe_layers else ()):
        out[f"batched {n}"] = out.get(f"batched {n}", 0) + moe_layers * batches
    return out


def batched_split() -> dict:
    """The batched forms' launches since ``reset_counts``: nested by kernel,
    gram in all (every one of them is also in the per-kernel counts)."""
    return {"nested": dict(_ops("nested_lowrank").batched_by_kernel),
            "gram": _ops("gram").batched_launches}


def nested_calls(model, decode: bool = False) -> tuple:
    """Nested-linear calls of one forward: (single form, batched form).  A
    target is one call per layer of its stack; a MoE layer's expert target
    (stacked over experts too) is one batched call per layer.  ``decode``:
    a decode step's, where MLA builds ``wkv_b`` with ``dense_kernel`` (plain
    matmuls) instead of calling it."""
    single = batched = 0
    for t in model.compressible_targets():
        if decode and model.cfg.attention == "mla" and t.path[-1] == "wkv_b":
            continue
        if "experts" in t.path:
            batched += math.prod(t.stacked[:-1])
        else:
            single += math.prod(t.stacked)
    return single, batched


# Device kernels of one nested_lowrank call (both phases and reductions), of
# one gram call, and of one paged_attention call (split kernel and combine).
NESTED_KERNEL_NAMES = ("stream_partial", "mma_partial", "gemm_partial", "reduce_partials")
GRAM_KERNEL_NAMES = ("gram_mma", "gram_tf32x3", "gram_kernel")
PAGED_KERNEL_NAMES = ("paged_split_kernel", "paged_combine_kernel")


PROFILE_WINDOWS = 5  # profiler windows (and wall calls) a profile is the median of


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def device_work(ev, cuda) -> bool:
    """A profiler event of work on the card (a kernel or a copy), not the
    card-side mirror of a host ``record_function`` range (the engine's
    ``serving_root.*`` and ``serving.*`` spans), which spans its kernels
    and the gaps between them."""
    return (ev.device_type == cuda and not getattr(ev, "is_user_annotation", False)
            and not ev.key.startswith(("serving_root.", "serving.")))


def profile_step(torch, fn, label: str = "decode step", quiet: bool = False,
                 windows: int = PROFILE_WINDOWS, ranges=None) -> dict:
    """Device time by kernel name and device busy share of one call of
    ``fn`` (after a warm-up call), from torch.profiler's CUDA trace: the
    median over ``windows`` profiled calls, of the windows that kept every
    kernel (the most device events; the profiler sometimes drops some),
    beside the median wall of as many calls with the profiler off.  Only
    device events are summed: an aten op's row repeats its kernels' time.
    ``quiet``: log nothing.  ``ranges`` (module, function names): while
    profiled, each of those functions of the module runs inside a
    ``record_function`` range, and ``ranges_ms`` gives each range's device
    total (the kernels launched inside it) over the same kept windows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(windows):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = _median(walls)
    module, names = ranges or (None, ())
    saved = {name: getattr(module, name) for name in names}

    def ranged(name, f):
        def wrapped(*a, **k):
            with record_function(f"range.{name}"):
                return f(*a, **k)
        return wrapped
    for name, f in saved.items():
        setattr(module, name, ranged(name, f))
    seen, seen_ranges = [], []
    try:
        for _ in range(windows):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            per, in_range = {}, dict.fromkeys(names, 0.0)
            for ev in prof.key_averages():
                name = ev.key[len("range."):]
                if (ev.key.startswith("range.") and name in in_range
                        and ev.device_type != DeviceType.CUDA):  # the host range
                    in_range[name] += ev.device_time_total / 1e3
                if not device_work(ev, DeviceType.CUDA):
                    continue
                dev_us = ev.self_device_time_total
                if dev_us > 0:
                    per[ev.key] = (per.get(ev.key, (0.0, 0))[0] + dev_us / 1e3, ev.count)
            seen.append(per)
            seen_ranges.append(in_range)
    finally:
        for name, f in saved.items():
            setattr(module, name, f)
    n_events = [sum(n for _, n in per.values()) for per in seen]
    kept_at = [i for i, n in enumerate(n_events) if n == max(n_events)]
    kept = [seen[i] for i in kept_at]
    ranges_ms = {name: _median([seen_ranges[i][name] for i in kept_at]) for name in names}
    per = {k: (_median([p.get(k, (0.0, 0))[0] for p in kept]),
               max(p.get(k, (0.0, 0))[1] for p in kept))
           for k in set().union(*kept)}
    busy = _median([sum(ms for ms, _ in p.values()) for p in kept])
    top = sorted(per.items(), key=lambda kv: -kv[1][0])[:12]
    kernels = {k: ms for k, (ms, _) in per.items()}
    used = {"windows": windows, "windows_used": len(kept), "ranges_ms": ranges_ms}
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
    combine = sum(ms for k, (ms, _) in per.items() if "paged_combine" in k)
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "nested_ms": nested,
            "gram_ms": gram, "paged_ms": paged, "combine_ms": combine, "kernels": kernels,
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


def _tree_bytes(tree) -> int:
    return sum(_tree_bytes(v) if isinstance(v, dict) else v.numel() * v.element_size()
               for v in tree.values())


def cache_bytes_per_token(model) -> int:
    """Bytes one token takes in the model's decode cache over all layers
    (``models.api.cache_bytes_per_token``: K/V, or MLA's latents)."""
    from repro_torch.models.api import cache_bytes_per_token as per_token

    return per_token(model)


def cache_bytes_per_row(model) -> int:
    """Bytes of a row's cache that do not grow with its length: a recurrent
    state (jamba's Mamba ``h`` and conv tail)."""
    return _tree_bytes(model.init_cache(1, 1, device="meta")) - cache_bytes_per_token(model)


# The glm_serve and mla_serve paths (PR 28): serve_path on chatglm3-6b cut
# to 2 of 28 layers (paged, 32/2 heads: G 16) and on minicpm3-4b cut to 4 of
# 62 (MLA's latent slab, bucketed admission), *Serve*'s plan and prompts
# (worst case, depth 1, max_batch 8, max_len 256, block 16, chunk 64).
# Their exact counts, entered before the first chip run.  glm: *Serve*'s
# schedule (33 steps, 3 chunk calls, 36 syncs); 14 nested calls a forward,
# on the stream kernel at 8 rows and on mma at 512; paged_attention once a
# layer a step, plan_splits(8, 2, 16) = 4 splits, so every call runs the
# combine; 9 taps x 16 batches of gram, flash once a layer a calibration
# batch.  MLA: the 8 prompts (173, 133, 110, 65, 72, 23, 29, 19 tokens) in
# buckets 256 (2), 128 (3) and 32 (3), three admission calls in one
# admission round, of 2, 4 and 4 rows (a group's size rounded up to a
# power of two: 512, 512 and 128 nested rows), then 31 decode steps: 34
# syncs; 8 nested calls a layer at prefill, all on mma, 7 at decode (wkv_b
# through dense_kernel); 25 taps x 16 batches of gram, no mixer kernel, no
# paged_attention.
GLM_PREDICTED = dict(
    steps=33, prefill_calls=3, host_syncs=36, admissions={}, splits=4, combine=66,
    launches={"nested_lowrank": 504, "paged_attention": 66, "gram": 144,
              "flash_attention": 32, "rwkv6": 0},
    nested={"stream": 462, "mma": 42, "tile": 0})
MLA_PREDICTED = dict(
    steps=31, prefill_calls=3, host_syncs=34, admissions={32: 1, 128: 1, 256: 1},
    splits=1, combine=0,
    launches={"nested_lowrank": 964, "paged_attention": 0, "gram": 400,
              "flash_attention": 0, "rwkv6": 0},
    nested={"stream": 868, "mma": 96, "tile": 0})


# The dsv3_serve path: serve_path on deepseek-v3-671b cut to 4 of
# 61 layers (its 3 dense layers and 1 MoE layer) and to 16 of 256 experts,
# every width kept, *Serve*'s plan and prompts on the dense latent slab.
# Its exact counts, entered before the first chip run.  (mla, moe) is
# pad-sensitive, so the 8 prompts (173, 133, 110, 65, 72, 23, 29, 19
# tokens) go in 8 exact-length admission calls, then 31 decode steps: 39
# syncs.  A forward's nested calls: 32 single (5 MLA a layer, 3 MLP on a
# dense layer, 3 shared-expert on the MoE layer) and 3 batched; at decode
# 28 single (wkv_b through dense_kernel) and 3 batched.  Admissions: 8 x 32
# single on mma (19-173 rows); the experts' capacities ceil(L * 8 * 5 / 64)
# = 109, 84, 69, 41, 45, 15, 19, 12 rows, so 2 calls on the batched stream
# kernel and 6 on its mma, x 3.  Decode: 31 x 28 single and 31 x 3 batched
# (capacity max(8, 5) = 8 rows), all stream.  Calibration: 26 single Gram
# taps (6 a dense layer, 7 on the MoE layer: 4 attention, router_in,
# shared_in, shared_mid; the final norm's) and 2 batched a batch, x 16.
DSV3_PREDICTED = dict(
    steps=31, prefill_calls=8, host_syncs=39,
    admissions={173: 1, 133: 1, 110: 1, 65: 1, 72: 1, 23: 1, 29: 1, 19: 1},
    splits=1, combine=0,
    launches={"nested_lowrank": 1241, "paged_attention": 0, "gram": 448,
              "flash_attention": 0, "rwkv6": 0},
    nested={"stream": 967, "mma": 274, "tile": 0})


# The jamba_serve path: serve_path on jamba-v0.1-52b cut to 5 of 32 layers
# ((mamba, mlp), (mamba, moe), (mamba, mlp), (mamba, moe), (gqa, mlp)) and
# to 8 of 16 experts, every width kept, *Serve*'s plan and prompts on the
# dense slab (the Mamba layers' h and conv, the attention layer's K/V).
# Its exact counts, entered before the first chip run.  Pad-sensitive (a
# recurrent state and a MoE), so the 8 prompts (173, 133, 110, 65, 72, 23,
# 29, 19 tokens) go in 8 exact-length admission calls, then 31 decode
# steps: 39 syncs.  A forward's nested calls: 29 single (4 a Mamba layer,
# 4 on the attention layer, 3 an MLP on layers 0, 2, 4) and 6 batched (3 a
# MoE layer), the same at decode.  Admissions: 8 x 29 single on mma (19-173
# rows); the experts' capacities max(8, ceil(L * 2 * 5 / 32)) = 55, 42,
# 35, 21, 23, 8, 10, 8 rows, so 3 calls on the batched stream kernel and 5
# on its mma, x 6.  Decode: 31 x 29 single and 31 x 6 batched (capacity
# max(8, 3) = 8 rows), all stream.  Calibration: 27 single Gram taps (4 a
# Mamba layer, attn.in and attn.out_in, mlp.in and mlp.mid on each MLP,
# router_in on each MoE layer, the final norm's) and 4 batched (expert_buf
# and expert_mid a MoE layer) a batch, x 16; flash on the one attention
# layer, once a calibration batch and once an admission.
JAMBA_PREDICTED = dict(
    steps=31, prefill_calls=8, host_syncs=39,
    admissions={173: 1, 133: 1, 110: 1, 65: 1, 72: 1, 23: 1, 29: 1, 19: 1},
    splits=1, combine=0,
    launches={"nested_lowrank": 1365, "paged_attention": 0, "gram": 496,
              "flash_attention": 24, "rwkv6": 0},
    nested={"stream": 1103, "mma": 262, "tile": 0})


def nested_expect_of(cfg, model, steps: int, prefill_rows, max_batch: int = 8) -> tuple:
    """(nested launches by kernel, of them the batched form's) of ``steps``
    decode steps of ``max_batch`` rows and one prefill call of each
    ``prefill_rows``: a call's compressed linears see its rows, a MoE
    layer's experts the call's capacity rows; <= 16 rows run the stream
    kernel, more the mma kernel up to the gate (1024 rows; above it plain
    matmuls), none the tile kernel (the models are bf16)."""
    from repro_torch.models.moe import capacity_of

    nlr = _ops("nested_lowrank")
    gate = nlr.MAX_KERNEL_ROWS
    n_single, n_batched = nested_calls(model)
    n_decode = nested_calls(model, decode=True)[0]
    calls = [(max_batch, n_decode)] * steps + [(r, n_single) for r in prefill_rows]
    expert_rows = [capacity_of(r, cfg) for r, _ in calls] if n_batched else []
    batched = {"stream": n_batched * sum(c <= nlr.STREAM_ROWS for c in expert_rows),
               "mma": n_batched * sum(nlr.STREAM_ROWS < c <= gate for c in expert_rows),
               "tile": 0}
    nested = {"stream": sum(n for r, n in calls if r <= nlr.STREAM_ROWS) + batched["stream"],
              "mma": (sum(n for r, n in calls if nlr.STREAM_ROWS < r <= gate)
                      + batched["mma"]), "tile": 0}
    return nested, batched


# A MoE serve path's eval batch: the first shape whose expert capacity is
# under the nested gate.
EVAL_SHAPES = ((4, 2048), (1, 1536))


def admission_calls(plens, pad_safe: bool, max_batch: int = 8, max_len: int = 256) -> list:
    """(width, rows) of each dense admission call when the prompts of
    ``plens`` are all queued into as many free slots: a pad-sensitive
    model's one call a prompt at its exact length; a pad-safe model's one
    call a prompt-length bucket (16, doubling up to max_len), its rows the
    group's size rounded up to a power of two (at most max_batch)."""
    if not pad_safe:
        return [(int(n), 1) for n in plens]
    groups: dict = {}
    for n in plens:
        b = 16
        while b < min(n, max_len):
            b *= 2
        b = min(b, max_len)
        groups[b] = groups.get(b, 0) + 1
    return [(b, min(max_batch, 1 << (g - 1).bit_length())) for b, g in sorted(groups.items())]


def serve_report(cfg, eng, st, res, prof, layers: int, cache_bytes: int,
                 state_bytes: int = 0) -> dict:
    """The glm_serve and mla_serve paths' own readings.  Paged: the decode
    step's wall and device time, paged_attention's device ms a call, its
    split count and the combine's share, and the K/V bytes a token against
    Mistral-7B's (8 KV heads).  Slab: admission calls by bucket, host syncs
    (one an admission group and one a step), the latent slab's bytes a token
    against the K (nope + rope) and V a GQA slab of its heads would hold,
    and a recurrent state's bytes a row (jamba's Mamba layers).  Both: step
    p50 and tok/s."""
    from repro_torch.configs import MISTRAL_7B

    out = dict(step_p50_ms=st["step_p50_s"] * 1e3, tok_per_s=res["tok_per_s"],
               decode_wall_ms=prof["wall_ms"], decode_device_ms=prof["device_busy_ms"],
               cache_bytes_per_token=cache_bytes)
    if eng.layout == "paged":
        pa = _ops("paged_attention")
        per_call = prof["paged_ms"] / layers
        mistral = layers * 2 * MISTRAL_7B.num_kv_heads * MISTRAL_7B.head_dim * 2
        out.update(paged_ms_per_call=per_call,
                   paged_splits=pa.plan_splits(eng.max_batch, cfg.num_kv_heads,
                                               eng.kv.max_blocks_per_row)[0],
                   combine_share=prof["combine_ms"] / prof["paged_ms"] if prof["paged_ms"] else None,
                   mistral_cache_bytes_per_token=mistral)
        log(f"  G {cfg.num_heads // cfg.num_kv_heads}: decode step wall {prof['wall_ms']:.3f} ms, "
            f"device {prof['device_busy_ms']:.4f}; paged_attention {per_call:.4f} ms a call "
            f"({out['paged_splits']} splits, combine {out['combine_share'] or 0:.1%} of it); "
            f"K/V {cache_bytes} B a token against Mistral-7B's {mistral} at {layers} layers; "
            f"step p50 {out['step_p50_ms']:.3f} ms, {out['tok_per_s']:.1f} tok/s")
    else:
        m = cfg.mla
        gqa = layers * cfg.num_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim
                                        + m.v_head_dim) * 2 if m else None
        out.update(admissions_by_width=dict(eng.admissions_by_width),
                   host_syncs=st["host_syncs"], gqa_cache_bytes_per_token=gqa,
                   state_bytes_per_row=state_bytes)
        log(f"  slab: admission calls by bucket {dict(eng.admissions_by_width)}, host syncs "
            f"{st['host_syncs']} = {st['prefill_ticks']} admissions + {st['steps']} steps; "
            f"{cache_bytes} B a token ({eng.max_batch} x {eng.max_len} slab: "
            f"{cache_bytes * eng.max_batch * eng.max_len / 2 ** 20:.2f} MiB)"
            + (f" against {gqa} B for a GQA slab of its {cfg.num_heads} heads" if gqa else "")
            + (f"; {state_bytes} B of recurrent state a row" if state_bytes else "")
            + f"; step p50 {out['step_p50_ms']:.3f} "
            f"ms, {out['tok_per_s']:.1f} tok/s; decode step wall {prof['wall_ms']:.3f} ms, "
            f"device {prof['device_busy_ms']:.4f}")
    return out


MAMBA_PARTS = ("chunk_scan", "ssm_step", "causal_conv")


def mamba_share(prof: dict, label: str) -> dict:
    """The selective scan's (``chunk_scan`` at prefill, ``ssm_step`` at
    decode) and the causal conv's device ms and share of the busy time in
    one ``profile_step`` with ``ranges=(models.mamba, MAMBA_PARTS)``, all
    Mamba layers together."""
    parts, busy = prof["ranges_ms"], prof["device_busy_ms"]
    scan = parts["chunk_scan"] + parts["ssm_step"]
    log(f"  {label}: device busy {busy:.3f} ms; selective scan {scan:.4f} ms "
        f"({scan / max(busy, 1e-9):.1%}), causal conv {parts['causal_conv']:.4f} ms "
        f"({parts['causal_conv'] / max(busy, 1e-9):.1%}); medians of "
        f"{prof['windows_used']} of {prof['windows']} windows")
    return dict(device_busy_ms=busy, scan_ms=scan, conv_ms=parts["causal_conv"],
                scan_share=scan / max(busy, 1e-9),
                conv_share=parts["causal_conv"] / max(busy, 1e-9), **parts)


def int8_slab_run(torch, np, model, params, prompts, base: list, base_nested: dict,
                  prefill_calls: int) -> dict:
    """A second engine run on the serve path's compressed model and prompts
    with the dense slab's attention K/V in int8 (``kv_quant``; the engine
    as on the serve path: worst case, depth 1): every request finishes;
    its streams against the bf16 slab's (``base``, in request order) by the
    margin rule (the bf16 model's teacher-forced margins); the same nested
    launches by kernel as the bf16 run (``base_nested``: the schedule is
    the same) and flash once an attention layer an admission
    (``prefill_calls``); a decode step's logits on an int8 slab against the
    bf16 slab's within STEP_LOGIT_TOL of max |logit|, both prefilled with
    each prompt's first 15 tokens, the int8 run pinned to the bf16 run's
    expert choices; and the slab's bytes a token both ways."""
    from repro_torch.models.moe import RoutingTrace
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.scheduler import SchedulerConfig

    reset_counts()
    eng = ServingEngine(model, params, max_batch=8, max_len=256, seed=0, kv_quant=True,
                        pipeline_depth=1, sched_config=SchedulerConfig(admission="worst_case"))
    uids = [eng.submit(p, max_new_tokens=32) for p in prompts]
    t0 = time.perf_counter()
    try:
        eng.run()
    finally:
        eng.close()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, nsplit = read_counts(), nested_split()
    reqs = [eng.finished_requests[u] for u in uids]
    streams = [list(r.generated) for r in reqs]
    margins = teacher_margins(torch, np, model, params, prompts, base)
    rows = [margin_row(g, list(w), m) for g, w, m in zip(streams, base, margins)]
    st = eng.stats()
    launches_ok = (nsplit == base_nested and counts["paged_attention"] == 0
                   and counts["flash_attention"]
                   == mixer_layers(model, "flash_attention") * prefill_calls
                   and st["prefill_ticks"] == prefill_calls)
    finished_ok = all(r.finish_reason == "stop" and len(r.generated) == 32 for r in reqs)
    toks = torch.as_tensor(np.stack([p[:15] for p in prompts]), device="cuda")
    nxt = torch.as_tensor([[int(p[15])] for p in prompts], device="cuda")
    clen = torch.full((8,), 15, dtype=torch.int32, device="cuda")
    trace = RoutingTrace()
    with torch.no_grad():
        bf16 = model.init_cache(8, 256, device="cuda")
        with trace.record():
            model.apply(params, toks, mode="prefill", cache=bf16)
            lb = model.apply(params, nxt, mode="decode", cache=bf16, cache_len=clen).float()
        int8 = model.init_cache(8, 256, device="cuda", kv_quant=True)
        with trace.replay():
            model.apply(params, toks, mode="prefill", cache=int8)
            lq = model.apply(params, nxt, mode="decode", cache=int8, cache_len=clen).float()
    err, scale = float((lq - lb).abs().max()), float(lb.abs().max())
    step_ok = bool(torch.isfinite(lq).all()) and err <= STEP_LOGIT_TOL * scale
    del bf16, int8
    per_token = {"bfloat16": cache_bytes_per_token(model),
                 "int8": eng.cache_stats()["bytes_per_token"]}
    ok = (finished_ok and all(r["ok"] for r in rows) and launches_ok and step_ok
          and per_token["int8"] < per_token["bfloat16"])
    log(f"  int8 dense slab (kv_quant), same model and prompts: {len(reqs)} requests "
        f"finished {'OK' if finished_ok else 'FAIL'} in {wall:.2f} s ({st['steps']} steps, "
        f"step p50 {st['step_p50_s'] * 1e3:.2f} ms); streams against the bf16 slab's: "
        f"{sum(r['equal'] for r in rows)} of {len(rows)} equal, first differences "
        f"{[(r['first_diff'], round(r['margin'], 4), round(r['gate'], 4)) for r in rows if not r['equal']]}; "
        f"launches {counts}, nested by kernel {nsplit} (bf16 run {base_nested}) "
        f"{'OK' if launches_ok else 'FAIL'}; decode-step logits int8 vs bf16 slab: max abs "
        f"err {err:.4e} (max |logit| {scale:.3f}, tol {STEP_LOGIT_TOL * scale:.4e}), expert "
        f"routings pinned {trace.flips} {'OK' if step_ok else 'FAIL'}; bytes a token "
        f"{per_token} {'OK' if ok else 'FAIL'}")
    return dict(streams=rows, launches=counts, nested_launches=nsplit, engine=st,
                wall_s=wall, step_logit_max_abs_err=err, step_logit_max_abs=scale,
                routings_pinned=trace.flips, bytes_per_token=per_token, ok=bool(ok))


def serve_path(torch, np, cfg, mixer, gram_taps: tuple, keep=None, predicted=None,
               int8: bool = False, grams_on: str = "device"):
    """``serve()`` on ``cfg``: calibrate, compress (nsvd1, ratio 0.2) and
    serve 8 requests on the layout the model takes, with exact launch counts
    (``mixer``: the kernel each calibration forward runs once per layer,
    None for MLA, whose attention is plain torch; ``gram_taps``: a
    calibration batch's (single, batched) Gram taps); then one decode step's
    logits through the kernels against the plain versions, on a cache
    prefilled with each prompt's first 15 tokens, and for a MoE model one
    eval batch's logits through its compressed experts (the batched nested
    kernel at an eval batch's capacity).  The engine runs as before the
    scheduler (worst-case admission, pipeline depth 1), so counts and times
    compare across PRs; ``keep`` (a dict) receives the compressed model and
    params.  ``predicted`` (GLM_PREDICTED, MLA_PREDICTED): the path's exact
    counts, held beside the ones derived from the run's own steps, and one
    prefill call's logits through the kernels against the plain versions
    (a 64-token chunk of 8 rows on the pages, the admission call with the
    most rows under the nested gate on the slab).  ``int8`` (a dense-slab
    model): then ``int8_slab_run`` on the same model and prompts.
    ``grams_on``: the calibration GramStore's home (``serve(grams_on=)``);
    in host memory each of its layer groups runs every calibration batch
    through the mixer, and the memory reckoning is the host home's."""
    from repro_torch import kernels
    from repro_torch.launch.serve import run_bytes, serve
    from repro_torch.models.api import prefill_pad_safe
    from repro_torch.models.moe import RoutingTrace, capacity_of
    from repro_torch.serving.kvcache import PagedKVCache

    rng = np.random.default_rng(0)
    plens = rng.integers(16, 201, size=8)
    prompts = [rng.integers(2, cfg.vocab_size // 2, size=int(n)) for n in plens]
    reset_counts()
    res = serve(cfg, requests=8, max_new=32, max_batch=8, max_len=256,
                seed=0, compress=0.2, block_size=16, prefill_chunk=64,
                prompts=prompts, sched_policy="worst_case", pipeline_depth=1,
                grams_on=grams_on)
    # What the serve CLI's memory check reckons the run holds at most, beside
    # the peak it reached (calibration, compression and serving; the caller
    # reset the peak just before).
    fit_need, fit_what = run_bytes(cfg, [0.2], grams_on)
    store = res["gram_store"]
    if grams_on == "host":
        # Its groups take what the card has free, so calibration's own bound
        # stands beside the reckoning: the weights, the most fp64 sums a
        # group held, a tap's fp32 Gram and twice a batch's taps (the
        # runner's allowance for the forward), as the runner sized them.
        from repro_torch.launch.compress_shapes import calibration_bytes, gram_layers

        meta = res["model"]
        calib_need = (calibration_bytes(meta)["weights"] + store["device_bytes"]
                      + calibration_bytes(meta)["batch_gram"]
                      + 2 * 16 * 128 * gram_layers(meta)["tap_bytes_per_token"])
        if calib_need > fit_need:
            fit_need, fit_what = calib_need, (
                f"calibration {calib_need / 1e9:.2f}: the weights, a group's sums "
                f"{store['device_bytes'] / 1e9:.2f}, a tap's Gram and two batches' taps; "
                f"the serve CLI's host-home reckoning {fit_what}")
    run_peak = torch.cuda.max_memory_allocated()
    counts = read_counts()
    split, split_ok = flash_split_ok(counts)
    rsplit, rsplit_ok = rwkv6_split_ok(counts)
    nsplit = nested_split()
    gsplit = gram_split()
    bsplit = batched_split()
    shapes = shape_split()
    gshapes = gram_shape_split()
    eng, model, params, plan = res["engine"], res["model"], res["params"], res["plan"]
    # Every tap is bf16 (the mma kernel); the batched form ran at each MoE
    # layer's two expert tap widths, once a calibration batch each.
    gshapes_expect = batched_gram_expect(cfg, model, 256 // 16)
    gram_ok = (gsplit == {"mma": counts["gram"], "tf32x3": 0, "fma": 0}
               and {k: c for k, c in gshapes.items() if k.startswith("batched")}
               == gshapes_expect)
    if keep is not None:
        keep.update(model=model, params=params, prompts=prompts,
                    outputs=[res["outputs"][u] for u in sorted(res["outputs"])],
                    serve_stats=eng.stats(), serve_tok_per_s=res["tok_per_s"])
    st = eng.stats()
    paged = eng.layout == "paged"
    layers = cfg.num_layers
    n_batched = nested_calls(model)[1]
    # Calibration: 256 samples in batches of 16, each one causal forward
    # (the mixer kernel once per layer, gram_taps Gram taps).  Every
    # compressed linear of every prefill call and decode step runs the
    # nested kernel (a MoE layer's experts its batched form; at an MLA
    # decode step all but wkv_b) unless the call's rows are above its gate;
    # paged decode steps run paged attention once per layer; dense
    # admissions prefill through the mixer (paged prefill chunks attend
    # over gathered pages, as the reference, not through flash_attention).
    calib_batches = 256 // 16
    # A decode step's compressed linears see the engine's 8 rows (bf16), a
    # prefill call its rows (paged: every chunk is max_batch x prefill_chunk
    # = 512 rows; dense: each admission call's, from the prompt lengths by
    # admission_calls); nested_expect_of splits them by kernel.
    gate = _ops("nested_lowrank").MAX_KERNEL_ROWS
    admits = [] if paged else admission_calls(plens, prefill_pad_safe(model))
    admits_ok = paged or eng.admissions_by_width == Counter(w for w, _ in admits)
    prefill_rows = [8 * 64] * st["prefill_ticks"] if paged else [w * r for w, r in admits]
    nested_expect, batched_nested = nested_expect_of(cfg, model, st["steps"], prefill_rows,
                                                     eng.max_batch)
    batched_expect = {"nested": batched_nested, "gram": gram_taps[1] * calib_batches}
    expect = {"nested_lowrank": nested_expect["stream"] + nested_expect["mma"],
              "paged_attention": layers * st["steps"] if paged else 0,
              "gram": sum(gram_taps) * calib_batches,
              "flash_attention": 0, "rwkv6": 0}
    if mixer is not None:
        expect[mixer] = mixer_layers(model, mixer) * (
            calib_batches * store["groups"] + (0 if paged else st["prefill_ticks"]))
    nested_ok = (nsplit == nested_expect and bsplit == batched_expect
                 and len(prefill_rows) == st["prefill_ticks"] and admits_ok)
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
    # Dense: one sync a step and one an admission call (a bucket's group, or
    # one exact-length prompt).
    syncs_ok = (st["host_syncs"] <= st["steps"] + st["prefill_ticks"] if paged else
                st["host_syncs"] == st["steps"] + st["prefill_ticks"]
                and st["prefill_ticks"] == len(admits))
    pred_ok, pred_got = True, None
    if predicted is not None:
        pred_got = dict(steps=st["steps"], prefill_calls=st["prefill_ticks"],
                        host_syncs=st["host_syncs"], launches=counts, nested=nsplit,
                        combine=combine, splits=n_splits,
                        admissions=dict(eng.admissions_by_width))
        pred_ok = pred_got == predicted
    ok = (len(outs) == 8 and all(reasons.get(u) for u in outs)
          and all(1 <= len(v) <= 32 for v in outs.values())
          and all(0 <= t < cfg.vocab_size for v in outs.values() for t in v)
          and syncs_ok and abs(ratio - plan.achieved_ratio) < 1e-9
          and counts == expect and split_ok and rsplit_ok and nested_ok and gram_ok
          and combine_ok and expect["nested_lowrank"] > 0 and pred_ok
          and run_peak <= fit_need)
    log(f"serve path: {cfg.name} d_model={cfg.d_model} heads={cfg.num_heads}/"
        f"{cfg.num_kv_heads} hd={cfg.head_dim} d_ff={cfg.d_ff} vocab="
        f"{cfg.vocab_size} layers={layers} (depth cut); cache layout {eng.layout}")
    log(f"  prompt lengths {plens.tolist()}; plan achieved ratio "
        f"{plan.achieved_ratio:.4f} (counted from the factors: {ratio:.4f})")
    log("  phase seconds: " + ", ".join(f"{k}={v:.2f}" for k, v in res["seconds"].items()))
    log(f"  GramStore on the {store['grams_on']}: {store['groups']} group(s) of layers, "
        f"{store['bytes'] / 1e9:.2f} GB")
    log(f"  serve CLI's memory reckoning {fit_need / 2 ** 30:.2f} GiB ({fit_what} GB) "
        f"against the run's peak {run_peak / 2 ** 30:.2f} GiB "
        f"{'OK' if run_peak <= fit_need else 'FAIL'}")
    log(f"  {res['tokens']} tokens in {res['seconds']['serve']:.2f} s = "
        f"{res['tok_per_s']:.1f} tok/s; decode steps {st['steps']}, prefill "
        f"calls {st['prefill_ticks']}, host syncs {st['host_syncs']}, step p50 "
        f"{st['step_p50_s'] * 1e3:.2f} ms")
    log(f"  launches {counts} expected {expect}; flash_attention by kernel {split}; "
        f"nested_lowrank by kernel {nsplit} expected {nested_expect}, batched forms "
        f"{bsplit} expected {batched_expect} {'OK' if nested_ok else 'FAIL'}; gram by "
        f"kernel {gsplit}, by width {gshapes} (batched expected {gshapes_expect}) "
        f"{'OK' if gram_ok else 'FAIL'}; paged combine launches {combine} "
        f"expected {combine_expect} ({n_splits} splits) {'OK' if combine_ok else 'FAIL'}; "
        f"rwkv6 by copy width {rsplit} {'OK' if rsplit_ok else 'FAIL'}; "
        f"finish reasons {sorted(set(reasons.values()))}")
    cache_bytes = cache_bytes_per_token(model)
    if predicted is not None:
        log(f"  predicted {predicted}\n  got       {pred_got} {'OK' if pred_ok else 'FAIL'}")
        kv_layers = sum(m in ("gqa", "mla") for m, _ in model.specs)
        log(f"  cache bytes a token: {cache_bytes} ({cache_bytes // kv_layers} a layer of "
            f"{kv_layers}; {eng.layout}); admission calls by width "
            f"{dict(eng.admissions_by_width)}")

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
        # A Mamba model's scan and conv run inside profiler ranges.
        ranges = None
        if cfg.mamba is not None:
            from repro_torch.models import mamba as mamba_mod
            ranges = (mamba_mod, MAMBA_PARTS)
        prof = profile_step(torch, lambda: model.apply(
            params, nxt, mode="decode", cache=clone(saved), cache_len=clen, **extra),
            f"{eng.layout} decode step (8 rows)", ranges=ranges)
        # One prefill call as the engine makes it: paged, a chunk of 64
        # tokens for each of the 8 rows (512 nested rows; rewriting the same
        # positions each time); dense and bucketed, the run's admission call
        # with the most rows under the nested gate; dense and exact-length,
        # the longest prompt's admission into a fresh row cache.
        if paged:
            ptoks = torch.as_tensor(rng.integers(2, cfg.vocab_size // 2, size=(8, 64)),
                                    device="cuda")

            def prefill_call(c):
                return model.apply(params, ptoks, mode="decode", cache=c,
                                   cache_len=torch.zeros_like(clen), **extra)

            def fresh():
                return clone(saved)
            pre_label = "paged prefill chunk (8 x 64 = 512 rows)"
        else:
            if prefill_pad_safe(model):
                width, n_rows = max((c for c in admits if c[0] * c[1] <= gate),
                                    key=lambda c: c[0] * c[1])
                ptoks = torch.as_tensor(rng.integers(2, cfg.vocab_size // 2,
                                                     size=(n_rows, width)), device="cuda")
                pre_label = (f"dense bucketed admission prefill ({n_rows} x {width} = "
                             f"{n_rows * width} rows)")
            else:
                longest = max(prompts, key=len)
                ptoks = torch.as_tensor(longest[None], device="cuda")
                pre_label = f"dense admission prefill ({len(longest)} rows)"

            def prefill_call(c):
                return model.apply(params, ptoks, mode="prefill", cache=c)

            def fresh():
                return model.init_cache(ptoks.shape[0], 256, device="cuda")
        prof_prefill = profile_step(torch, lambda: prefill_call(cache if paged else fresh()),
                                    pre_label, ranges=ranges)
        mamba_time = None if ranges is None else {
            "decode": mamba_share(prof, "Mamba share of the decode step (8 rows)"),
            "admission": mamba_share(prof_prefill, f"Mamba share of the {pre_label}")}
        prefill_check = None
        if predicted is not None:
            # Routings pinned as at the decode step (a MoE model's prefill
            # has near-ties too: dsv3_serve's 173-token admission).
            before = dict(nested_split())
            trace = RoutingTrace()
            with trace.record():
                pk = prefill_call(fresh()).float()
            torch.cuda.synchronize()
            ran = {k: v - before[k] for k, v in nested_split().items()}
            with kernels.plain(), trace.replay():
                pp = prefill_call(fresh()).float()
            p_err, p_scale = float((pk - pp).abs().max()), float(pp.abs().max())
            prefill_check = dict(label=pre_label, rows=int(ptoks.numel()), nested_launches=ran,
                                 max_abs_err=p_err, max_abs=p_scale, routings_pinned=trace.flips,
                                 ok=bool(torch.isfinite(pk).all()) and ran["mma"] > 0
                                 and p_err <= STEP_LOGIT_TOL * p_scale)
            del pk, pp
            log(f"  {pre_label} logits kernels vs plain: max abs err {p_err:.4e} (max |logit| "
                f"{p_scale:.3f}, tol {STEP_LOGIT_TOL * p_scale:.4e}), nested launches {ran}, "
                f"expert routings pinned {trace.flips} "
                f"{'OK' if prefill_check['ok'] else 'FAIL'}")
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
        # One eval batch through the compressed model, the first of
        # EVAL_SHAPES whose expert capacity is under the nested gate ((4,
        # 2048) on moonshot: 960 rows; (1, 1536) at deepseek-v3's top-8 of
        # 16: 960): every MoE layer's experts on the batched mma kernel (the
        # dense and shared linears' rows are above the gate), against the
        # plain versions.
        eb, es = next(sh for sh in EVAL_SHAPES if capacity_of(sh[0] * sh[1], cfg) <= gate)
        etoks = torch.as_tensor(rng.integers(2, cfg.vocab_size // 2, size=(eb, es)),
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
        e_ok = (le.shape == (eb, es, cfg.vocab_size) and bool(torch.isfinite(le).all())
                and e_err <= EVAL_LOGIT_TOL * e_scale
                and ran == {"stream": 0, "mma": n_batched, "tile": 0})
        del le, lpe
        eval_check = dict(shape=[eb, es], capacity=capacity_of(eb * es, cfg),
                          batched_launches=ran,
                          max_abs_err=e_err, max_abs=e_scale, routings_pinned=trace.flips,
                          ok=e_ok)
        step_ok = step_ok and e_ok
        log(f"  compressed eval-batch logits ({eb} x {es}; expert capacity "
            f"{eval_check['capacity']} rows, batched launches {ran}) kernels vs plain: max "
            f"abs err {e_err:.4e} (max |logit| {e_scale:.3f}, tol "
            f"{EVAL_LOGIT_TOL * e_scale:.4e}), expert routings pinned {trace.flips} of "
            f"{eb * es * len(trace.choices)} {'OK' if e_ok else 'FAIL'}")
    int8_run = None
    if int8:
        int8_run = int8_slab_run(torch, np, model, params, prompts,
                                 [res["outputs"][u] for u in sorted(res["outputs"])], nsplit,
                                 st["prefill_ticks"])
        step_ok = step_ok and int8_run["ok"]
    report = None
    if predicted is not None:
        step_ok = step_ok and prefill_check["ok"]
        report = serve_report(cfg, eng, st, res, prof, layers, cache_bytes,
                              cache_bytes_per_row(model))
    summary = dict(config=cfg.name, layers=layers, layout=eng.layout,
                   predicted=predicted, predicted_got=pred_got, prefill_check=prefill_check,
                   report=report,
                   prompt_lengths=plens.tolist(), seconds=res["seconds"], gram_store=store,
                   fit_need_gib=fit_need / 2 ** 30, run_peak_gib=run_peak / 2 ** 30,
                   tokens=res["tokens"], tok_per_s=res["tok_per_s"], engine=st,
                   launches=counts, expected_launches=expect, flash_launches=split,
                   rwkv6_launches=rsplit,
                   nested_launches=nsplit, expected_nested_launches=nested_expect,
                   nested_shape_launches=shapes, mamba_time=mamba_time,
                   gram_launches=gsplit, gram_shape_launches=gshapes,
                   batched_launches=bsplit,
                   expected_batched_launches=batched_expect, eval_check=eval_check,
                   paged_splits=n_splits,
                   paged_combine_launches=combine,
                   expected_paged_combine_launches=combine_expect,
                   finish_reasons=reasons,
                   achieved_ratio=plan.achieved_ratio, factored_ratio=ratio,
                   step_logit_max_abs_err=step_err, step_logit_max_abs=step_scale,
                   step_argmax_agreement=agree, step_routings_pinned=step_flips,
                   step_profile=prof,
                   prefill_profile=prof_prefill, int8_slab=int8_run,
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
                    if device_work(ev, DeviceType.CUDA))  # kernels and copies
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


@contextlib.contextmanager
def dispatches_checked(torch, counts: dict):
    """Count every plain and spec decode dispatch of every engine in the
    block (``counts`` by method name); on the card each runs under torch's
    sync-debug mode "error", so a host sync inside one raises."""
    from repro_torch.serving.engine import ServingEngine

    saved = {n: getattr(ServingEngine, n) for n in ("_dispatch_spec", "_dispatch_decode")}

    def wrap(name, fn):
        def checked(self):
            cuda = self.device.type == "cuda"
            prev = torch.cuda.get_sync_debug_mode() if cuda else None
            if cuda:
                torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(self)
            finally:
                if cuda:
                    torch.cuda.set_sync_debug_mode(prev)
                counts[name] = counts.get(name, 0) + 1
        return checked

    for name, fn in saved.items():
        setattr(ServingEngine, name, wrap(name, fn))
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(ServingEngine, name, fn)


def sched_run(torch, np, model, params, prompts, label, kw, depth, pool, defrag_every,
              late) -> dict:
    """One engine run of the sched_serve path, its launch counts read
    around it; every dispatch runs under torch's sync-debug mode "error"."""
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.scheduler import SchedulerConfig

    eng = ServingEngine(model, params, max_batch=8, max_len=256, seed=0, block_size=16,
                        num_blocks=pool, prefill_chunk=64, pipeline_depth=depth,
                        sched_config=SchedulerConfig(**kw))
    checked = {}
    n_late = SCHED_LATE if late else 0
    cls = {"latency_class": "batch"} if late else {}
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with dispatches_checked(torch, checked):
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
                            paged_combine_launches=combine,
                            checked_dispatches=checked.get("_dispatch_decode", 0),
                            defrags=defrags, defrag_moved=moved)}


def _forced_logits(torch, np, model, params, prompt, stream):
    """One teacher-forced forward over ``prompt`` and ``stream``'s tokens:
    the fp32 logits that predict each of ``stream``'s tokens, and the gate
    (STEP_LOGIT_TOL of max |logit|) at each.  Two flash_attention launches
    a forward."""
    seq = torch.as_tensor(np.concatenate([prompt, stream[:-1]])[None],
                          device=params["embed"]["table"].device)
    with torch.no_grad():
        lg = model.apply(params, seq, mode="train")[0, len(prompt) - 1:].float()
    return lg, STEP_LOGIT_TOL * lg.abs().amax(-1)


def teacher_margins(torch, np, model, params, prompts, streams) -> list:
    """Per request, teacher-forced on ``streams``: at each generated
    position, the top-2 logit margin and the gate the margin rule holds it
    to."""
    out = []
    for p, s in zip(prompts, streams):
        lg, gate = _forced_logits(torch, np, model, params, p, s)
        top2 = torch.topk(lg, 2, dim=-1).values
        out.append(((top2[:, 0] - top2[:, 1]).cpu().numpy(), gate.cpu().numpy()))
    return out


def forced_gaps(torch, np, model, params, prompts, streams) -> list:
    """Per request, teacher-forced on its own greedy stream: at each
    generated position, how far the committed token's logit lies below the
    argmax (0 where it is the argmax), and the gate.  A greedy stream holds
    when every gap is within its gate, at every position, whatever stream
    another run gave."""
    out = []
    for p, s in zip(prompts, streams):
        if not s:
            out.append((np.zeros(0), np.zeros(0)))
            continue
        lg, gate = _forced_logits(torch, np, model, params, p, s)
        idx = torch.as_tensor(s, device=lg.device)[:, None]
        gap = lg.amax(-1) - lg.gather(-1, idx)[:, 0]
        out.append((gap.cpu().numpy(), gate.cpu().numpy()))
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
# The seconds of F1's stall, F3's short deadlines (and the sleep past them)
# and F4's timeout and stall, as the card runs them.
FAULT_TIMING = {"stall": FAULT_STALL_S, "deadline": 1e-3, "timeout": FAULT_TIMEOUT_S,
                "timeout_stall": FAULT_TIMEOUT_STALL_S}


def scaled_fault_timing(step_times) -> dict:
    """FAULT_TIMING for a host whose clean engine steps took ``step_times``
    (seconds, a clean run's): each time at least its card value, and more
    where the host is slower, so a slow or loaded host keeps the path's
    meaning.  The stall is 25 median steps (the watchdog flags 2.5 times
    its median, so the host may slow 10-fold mid-run); the timeout is 100
    median steps and 10 of the slowest (no clean step, spikes of a loaded
    host included, reaches it), and its stall outlasts it by the card's
    0.1 s."""
    med, slowest = sorted(step_times)[len(step_times) // 2], max(step_times)
    timeout = max(FAULT_TIMEOUT_S, 100 * med, 10 * slowest)
    return {"stall": max(FAULT_STALL_S, 25 * med), "deadline": max(1e-3, med),
            "timeout": timeout,
            "timeout_stall": timeout + FAULT_TIMEOUT_STALL_S - FAULT_TIMEOUT_S}


# (dispatched decode steps, consumed steps, prefill chunk calls, preemptions)
# and the finish reasons other than "stop", from the CPU run.
FAULT_PREDICTED = {"F1": (104, 104, 15, 0), "F2": (151, 151, 21, 13),
                   "F3": (71, 71, 7, 0), "F4": (60, 59, 5, 0)}
FAULT_REASONS = {"F1": {3: "error"}, "F2": {},
                 "F3": {0: "deadline", 1: "deadline", 4: "cancelled", 9: "cancelled",
                        12: "shutdown", 13: "shutdown", 14: "shutdown", 15: "cancelled"},
                 "F4": {2: "shutdown", 3: "shutdown"}}


def fault_run(torch, np, model, params, prompts, label, timing=None) -> dict:
    """One run of the fault path on a fresh engine, its launch counts read
    around it; on the card every dispatch runs under sync-debug "error".
    ``timing``: the run's seconds (default FAULT_TIMING)."""
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.faults import FaultPlan, FaultPolicy, FaultSpec, ServingFault
    from repro_torch.serving.scheduler import SchedulerConfig

    cuda = params["embed"]["table"].device.type == "cuda"
    timing = FAULT_TIMING if timing is None else timing
    specs = [FaultSpec(kind, step, uid,
                       timing["timeout_stall" if label == "F4" else "stall"]
                       if kind == "straggler" else delay)
             for kind, step, uid, delay in FAULT_SPECS[label]]
    plan = FaultPlan(specs)
    policy = FaultPolicy(max_retries=1, retry_backoff_steps=2) if label == "F1" else None
    eng = ServingEngine(model, params, max_batch=8, max_len=256, seed=0, block_size=16,
                        num_blocks=SCHED_POOL if label == "F2" else None,
                        prefill_chunk=64, pipeline_depth=2,
                        sched_config=SchedulerConfig(resume="swap" if label == "F2"
                                                     else "reprefill"),
                        faults=plan, fault_policy=policy)
    checked = {}

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
    with dispatches_checked(torch, checked):
        if label in ("F1", "F2"):
            uids = submit(range(SCHED_REQUESTS))
            eng.run()
        elif label == "F3":
            f3 = FAULT_F3
            uids = []
            for i in range(SCHED_REQUESTS):
                dl = (timing["deadline"] if i in f3["deadline"]
                      else 3600.0 if i == f3["hour"] else None)
                uids += submit([i], deadline_s=dl)
            log_["queued"] = eng.cancel(f3["queued"])
            time.sleep(10 * timing["deadline"])  # past the two short deadlines
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
                                                    step_timeout_s=timing["timeout"])
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
                            dispatches=checked.get("_dispatch_decode", 0), launches=counts, nested_launches=nsplit,
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

    model, params = served["model"], served["params"]
    base = served["sched"]  # the obs path takes it on
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


# Phase 4d (spec_serve): self-speculative decoding on the serve path's
# configuration: mistral-7b at full width, 2 layers, bf16; *Serve*'s 8
# prompts (16-200 tokens, seed 0), 32 new tokens, max_batch 8, max_len 256,
# block 16, chunk 64; target nsvd1 at 0.2 (k1_frac 0.95), draft nsvd1 at 0.6
# from the same Grams, k = 4 (the reference benchmark's draft_ratio and
# spec_k).  Runs: (label, SchedulerConfig fields, pipeline depth, paged,
# draft ("nsvd" or "target": the perfect draft), dynamic_k, faults).  S1
# goes through serve() at *Serve*'s worst case and depth 1, so its counts
# compare with *Serve*'s; S2-S6 reuse S1's target and draft.  S5 kills the
# draft at step 2 (SPEC_COOLDOWN plain steps follow) and poisons the
# shortest prompt's request (uid 7, 19 tokens: its re-prefill fits one
# chunk) at step 8, with one retry.
SPEC_K, SPEC_RATIO, SPEC_COOLDOWN = 4, 0.6, 4
SPEC_RUNS = (("S1", {"admission": "worst_case"}, 1, True, "nsvd", False, ()),
             ("S2", {}, 2, True, "nsvd", False, ()),
             ("S3", {}, 2, False, "nsvd", False, ()),
             ("S4", {}, 2, True, "nsvd", True, ()),
             ("S5", {}, 2, True, "nsvd", False,
              (("draft_kill", 2, None), ("poison_logits", 8, 7))),
             ("S6", {"admission": "worst_case"}, 1, True, "target", False, ()))
# (prefill calls, their first-token host syncs, plain decode steps) of each
# run: they depend only on the prompt lengths and the plan, not on
# acceptance (tests/test_torch_spec.py runs this path at a tiny width on
# the CPU).  Every other count follows from the spec steps a run took.
# S3's admissions are bucketed on the slab (PR 28): the 8 prompts fall in
# three buckets (256: 173 and 133 tokens; 128: 110, 65, 72; 32: 23, 29, 19),
# one call and one sync each (8 before, one exact-length call a prompt).
SPEC_PREDICTED = {"S1": (3, 3, 0), "S2": (3, 3, 0), "S3": (3, 3, 0), "S4": (3, 3, 0),
                  "S5": (4, 4, SPEC_COOLDOWN), "S6": (3, 3, 0)}


def spec_run(torch, np, label, cfg, prompts, device, base=None) -> dict:
    """One run of the spec_serve path with its launch counts read around it:
    S1 through ``serve()`` (calibrate, compress, build the draft), the
    others on an engine over ``base`` (S1's run: its model, target and
    draft).  Records each step's degraded view and, for the perfect draft,
    every rejection (uid, index of the rejected token in the stream)."""
    from repro_torch.launch.serve import serve
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.faults import FaultPlan, FaultPolicy, FaultSpec
    from repro_torch.serving.scheduler import SchedulerConfig
    from repro_torch.serving.spec import SpecConfig

    _, kw, depth, paged, draft, dynamic_k, faults = next(r for r in SPEC_RUNS if r[0] == label)
    cuda = torch.device(device).type == "cuda"
    plan = FaultPlan([FaultSpec(kind, step, uid) for kind, step, uid in faults]) if faults else None
    policy = (FaultPolicy(max_retries=1, retry_backoff_steps=2,
                          draft_cooldown_steps=SPEC_COOLDOWN) if faults else None)
    counted = {}
    if cuda:
        torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    views, rejections = [], []
    with dispatches_checked(torch, counted):
        if base is None:
            res = serve(cfg, requests=8, max_new=32, max_batch=8, max_len=256, seed=0,
                        compress=0.2, block_size=16, prefill_chunk=64, prompts=prompts,
                        device=device, sched_policy=kw["admission"], pipeline_depth=depth,
                        spec_ratio=SPEC_RATIO, spec_k=SPEC_K)
            eng, model, params = res["engine"], res["model"], res["params"]
            uids = sorted(res["outputs"])
            seconds = res["seconds"]
        else:
            model, params = base["model"], base["params"]
            dparams = params if draft == "target" else base["draft"]
            eng = ServingEngine(model, params, max_batch=8, max_len=256, seed=0, block_size=16,
                                prefill_chunk=64, paged=paged, pipeline_depth=depth,
                                sched_config=SchedulerConfig(**kw), faults=plan,
                                fault_policy=policy,
                                spec_config=SpecConfig(dparams, k=SPEC_K, dynamic_k=dynamic_k))
            if draft == "target":
                commit = eng._commit_spec

                def commit_logged(entry, toks):
                    before = {s: (r.uid, len(r.generated)) for s, r in enumerate(eng.slots)
                              if r is not None and entry.mask[s]}
                    out = commit(entry, toks)
                    for s, (uid, n) in before.items():
                        m, n_commit = int(toks[s, SPEC_K + 2]), int(toks[s, SPEC_K + 1])
                        if n_commit >= 0 and m < int(entry.k_row[s]) and n + m < 32:
                            rejections.append((uid, n + m))
                    return out

                eng._commit_spec = commit_logged
            uids = [eng.submit(p, max_new_tokens=32) for p in prompts]
            while eng.sched or eng._prefilling or eng.active.any() or eng._parked:
                eng.run(max_steps=1)
                views.append(eng.degraded_components().get("draft"))
            eng.drain()
            seconds = {}
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    reqs = [eng.finished_requests.get(u) for u in uids]
    st, ss = eng.stats(), eng.spec_stats()
    n_tok = sum(len(r.generated) for r in reqs if r is not None)
    serve_s = seconds.get("serve", wall)
    return {"engine": eng, "model": model, "params": params, "plan": plan,
            "plens": [len(p) for p in prompts],
            "outputs": [r.generated if r else None for r in reqs],
            "reasons": [r.finish_reason if r else None for r in reqs],
            "retried": [bool(r and r.retries) for r in reqs],
            "views": views, "rejections": rejections,
            "summary": dict(run=label, scheduler=dict(kw, pipeline_depth=depth),
                            layout=eng.layout, draft=draft, dynamic_k=dynamic_k,
                            seconds=wall, phase_seconds=seconds, tokens=n_tok,
                            tok_per_s=n_tok / serve_s, stats=st, spec_stats=ss,
                            fault_stats=eng.fault_stats() if plan else None,
                            outstanding=[sp.kind for sp in plan.outstanding()] if plan else [],
                            dispatches=dict(counted), launches=read_counts(),
                            admissions=dict(eng.admissions_by_width),
                            nested_launches=nested_split(), gram_launches=gram_split(),
                            paged_combine_launches=_ops("paged_attention").combine_launches,
                            degraded_steps=sum(v is not None for v in views),
                            rejections=rejections)}


def spec_check(label, r, want, margins, forced, model, n_splits, cuda) -> dict:
    """S1-S6's checks: every stream by the margin rule against *Serve*'s
    and, teacher-forced on its own tokens through the target (``forced``:
    ``forced_gaps``), every committed token within the gate of the argmax,
    every request finished ("stop"), the predicted calls and syncs, one
    sync a spec or plain step and none in a dispatch, the launch counts
    from the run's own spec steps (on the card), the fault accounting
    (S5) and the perfect draft's rejections (S6: each at a margin inside
    the gate)."""
    sm = r["summary"]
    st, ss = sm["stats"], sm["spec_stats"]
    rows = []
    for i, got in enumerate(r["outputs"]):
        row = dict(margin_row(got or [], want[i], margins[i]), request=i,
                   reason=r["reasons"][i], retried=r["retried"][i])
        gap, gate = forced[i]
        row.update(forced_worst=float((gap - gate).max()) if len(gap) else None,
                   forced_outside=int((gap > gate).sum()))
        row["ok"] = (row["ok"] and row["reason"] == "stop" and len(got or []) == 32
                     and len(gap) == 32 and row["forced_outside"] == 0)
        rows.append(row)
    spec_steps, steps = ss["steps"], st["steps"]
    plain = steps - spec_steps
    d = sm["dispatches"]
    kills = sm["fault_stats"]["draft_kills"] if sm["fault_stats"] else 0
    got = (st["prefill_ticks"], st["host_syncs"] - st["decode_syncs"], plain)
    counts_ok = (got == SPEC_PREDICTED[label] and st["decode_syncs"] == steps
                 and d.get("_dispatch_spec", 0) == spec_steps + kills
                 and d.get("_dispatch_decode", 0) == plain)
    layers, (n_single, _) = model.cfg.num_layers, nested_calls(model)
    paged = sm["layout"] == "paged"
    ticks = st["prefill_ticks"]
    forwards = (SPEC_K + 1) * spec_steps + plain  # 8-row decodes (stream kernel)
    # Chunk calls (paged: 512 rows, target and draft) or bucketed admissions
    # (dense: target and draft, each call's rows from the prompt lengths by
    # admission_calls) on the mma kernel, but for an admission above the
    # nested gate (plain matmuls), and the 40-row verify chunks.
    gate = _ops("nested_lowrank").MAX_KERNEL_ROWS
    admits = [] if paged else admission_calls(r["plens"], True)
    kernel_ticks = ticks if paged else sum(w * n <= gate for w, n in admits)
    counts_ok = counts_ok and (paged or sm["admissions"] == Counter(w for w, _ in admits))
    expect = {"nested_lowrank": n_single * (forwards + spec_steps + 2 * kernel_ticks),
              "paged_attention": layers * forwards if paged else 0,
              "gram": 9 * 16 if label == "S1" else 0,
              "flash_attention": (layers * 16 if label == "S1" else 0)
              + (0 if paged else 2 * layers * ticks), "rwkv6": 0}
    nested_expect = {"stream": n_single * forwards,
                     "mma": n_single * (spec_steps + 2 * kernel_ticks), "tile": 0}
    combine_expect = expect["paged_attention"] if n_splits > 1 else 0
    launches_ok = (not cuda or (sm["launches"] == expect
                                and sm["nested_launches"] == nested_expect
                                and sm["gram_launches"]["fma"] == 0
                                and sm["gram_launches"]["tf32x3"] == 0
                                and sm["paged_combine_launches"] == combine_expect))
    accounting = {}
    if sm["fault_stats"] is not None:
        fs, fired = sm["fault_stats"], r["plan"].counts()
        accounting = {"injected": fs["injected"] == fired == {"draft_kill": 1,
                                                              "poison_logits": 1},
                      "draft": fs["draft_kills"] == fs["draft_reenables"] == 1,
                      "poison": fs["retried"] == 1 and fs["quarantined"] == 0,
                      "degraded": sm["degraded_steps"] >= 1 and r["views"][-1] is None,
                      "outstanding": not sm["outstanding"]}
    s6 = []
    if label == "S6":
        for uid, j in r["rejections"]:
            row = rows[uid]
            if row["equal"] or j <= row["first_diff"]:  # later ones follow a diff
                s6.append({"request": uid, "index": j, "margin": float(margins[uid][0][j]),
                           "gate": float(margins[uid][1][j]),
                           "ok": bool(margins[uid][0][j] <= margins[uid][1][j])})
    ok = (counts_ok and launches_ok and all(accounting.values())
          and all(x["ok"] for x in rows) and all(x["ok"] for x in s6)
          and 0.0 <= ss["acceptance_rate"] <= 1.0 and ss["committed_per_row_step"] >= 1.0)
    worst = [x["forced_worst"] for x in rows if x["forced_worst"] is not None]
    return {"rows": rows, "forced_outside": sum(x["forced_outside"] for x in rows),
            "forced_worst": max(worst, default=float("nan")),
            "counts": got, "counts_ok": counts_ok, "expected_launches": expect,
            "expected_nested_launches": nested_expect, "expected_combine": combine_expect,
            "launches_ok": launches_ok, "accounting": accounting, "s6_rejections": s6,
            "ok": bool(ok)}


def spec_logits_check(torch, np, model, params, dparams, device) -> dict:
    """The spec path's own kernel shapes held against the plain versions on
    the same inputs, as the serve path's decode-step check: on paged caches
    of 8 rows, the draft's prefill chunk (8 x 64 = 512 rows, the mma kernel
    at the draft's ranks), then one draft decode (8 rows, the stream kernel
    at the draft's ranks, paged attention) and the target's verify chunk
    (8 x (k+1) = 40 rows, the mma kernel at the target's ranks) after 64
    tokens of context; each call's logits within STEP_LOGIT_TOL of its max
    |logit|, and on the card each call's compressed linears on the nested
    kernel named."""
    from repro_torch import kernels
    from repro_torch.serving.kvcache import PagedKVCache

    cfg, ctx = model.cfg, 64
    n_single = nested_calls(model)[0]
    rng = np.random.default_rng(1)

    def tokens(n):
        return torch.as_tensor(rng.integers(2, cfg.vocab_size // 2, size=(8, n)), device=device)

    def pools():
        kv = PagedKVCache(model, 8, 256, block_size=16, device=device)
        for slot in range(8):
            kv.reserve(slot, ctx + SPEC_K + 1)
        return kv

    def clone(tree):
        return ({k: clone(v) for k, v in tree.items()} if isinstance(tree, dict)
                else tree.clone())

    def held(name, p, kv, x, start, kernel):
        saved = clone(kv.pools)
        before = nested_split()
        with torch.no_grad():
            lk = model.apply(p, x, mode="decode", cache=kv.pools, cache_len=start,
                             block_tables=kv.table_device()).float()
            ran = {k: v - before[k] for k, v in nested_split().items()}
            with kernels.plain():
                lp = model.apply(p, x, mode="decode", cache=saved, cache_len=start,
                                 block_tables=kv.table_device()).float()
        err, scale = float((lk - lp).abs().max()), float(lp.abs().max())
        want = {"stream": 0, "mma": 0, "tile": 0}
        want[kernel] = n_single
        ok = (lk.shape == (8, x.shape[1], cfg.vocab_size) and bool(torch.isfinite(lk).all())
              and err <= STEP_LOGIT_TOL * scale
              and (torch.device(device).type != "cuda" or ran == want))
        return dict(call=name, rows=x.numel(), nested_launches=ran, expected=want,
                    max_abs_err=err, max_abs=scale, ok=bool(ok))

    zero = torch.zeros(8, dtype=torch.int32, device=device)
    clen = torch.full((8,), ctx, dtype=torch.int32, device=device)
    ctx_toks, nxt = tokens(ctx), tokens(SPEC_K + 1)
    draft_kv, target_kv = pools(), pools()
    checks = [held("draft prefill chunk", dparams, draft_kv, ctx_toks, zero, "mma"),
              held("draft decode", dparams, draft_kv, nxt[:, :1], clen, "stream")]
    with torch.no_grad():  # the target's context, through the kernels
        model.apply(params, ctx_toks, mode="decode", cache=target_kv.pools, cache_len=zero,
                    block_tables=target_kv.table_device())
    checks.append(held("verify chunk", params, target_kv, nxt, clen, "mma"))
    return {"calls": checks, "ok": all(c["ok"] for c in checks)}


def spec_serve_path(torch, np, served):
    """Self-speculative decoding at Mistral-7B width (phase 4d): runs S1-S6
    (SPEC_RUNS) on *Serve*'s prompts, held to *Serve*'s streams by the
    margin rule (teacher-forced on *Serve*'s params), with the predicted
    calls and syncs, exact launches, no sync in a dispatch, S5's fault
    accounting and S6's rejections.  Reports acceptance, committed tokens a
    row-step, the draft cache's bytes, S1's tok/s and step p50 beside
    *Serve*'s, and one profiled spec step split into its draft and verify
    roots."""
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.scheduler import SchedulerConfig
    from repro_torch.serving.spec import SpecConfig

    model, params = served["model"], served["params"]  # the obs path takes them on
    prompts, want = served["prompts"], served["outputs"]  # mesh_serve takes them on
    serve_st = served.pop("serve_stats")
    cfg = model.cfg
    margins = teacher_margins(torch, np, model, params, prompts, want)
    pa = _ops("paged_attention")
    n_splits = pa.plan_splits(8, cfg.num_kv_heads, -(-256 // 16))[0]
    runs, ok, base = {}, True, None
    for label, *_ in SPEC_RUNS:
        r = spec_run(torch, np, label, cfg, prompts, "cuda", base)
        if base is None:
            eng = r["engine"]
            base = {"model": r["model"], "params": r["params"], "draft": eng.draft.params}
            # S2-S6 reuse S1's target against margins taken on Serve's.
            same = all(torch.equal(a, b) for a, b in zip(_tensors(r["params"]), _tensors(params)))
            r["summary"]["target_bit_equal_serve"] = same
            ok = ok and same
        forced = forced_gaps(torch, np, base["model"], base["params"], prompts, r["outputs"])
        chk = spec_check(label, r, want, margins, forced, model, n_splits, True)
        sm = r["summary"]
        sm.update(check=chk)
        ss, st = sm["spec_stats"], sm["stats"]
        diff = [(x["request"], x["first_diff"], round(x["margin"], 4), round(x["gate"], 4))
                for x in chk["rows"] if not x["equal"]]
        log(f"  run {label} ({sm['layout']}, {sm['scheduler']}, draft {sm['draft']}"
            f"{', dynamic k' if sm['dynamic_k'] else ''}): {sm['tokens']} tokens, "
            f"{sm['tok_per_s']:.1f} tok/s; steps {st['steps']} (spec {ss['steps']}), prefill "
            f"calls / first-token syncs / plain steps {chk['counts']} predicted "
            f"{SPEC_PREDICTED[label]}; acceptance {ss['acceptance_rate']:.4f}, committed "
            f"{ss['committed_per_row_step']:.4f} a row-step (k+1 = {SPEC_K + 1}); draft cache "
            f"{ss['draft_hbm_bytes'] / 1e6:.2f} MB; host syncs {st['host_syncs']} (decode "
            f"{st['decode_syncs']}); dispatches checked {sm['dispatches']}; teacher-forced "
            f"tokens outside the gate {chk['forced_outside']}, worst gap - gate "
            f"{chk['forced_worst']:.4f}; step p50 "
            f"{st['step_p50_s'] * 1e3:.2f} p90 {st['step_p90_s'] * 1e3:.2f} ms = dispatch "
            f"{st['step_dispatch_s'] * 1e3:.2f} + wait {st['step_device_wait_s'] * 1e3:.2f} + "
            f"host {st['step_host_s'] * 1e3:.2f} (means); streams equal {sum(x['equal'] for x in chk['rows'])}"
            f"/8, margin rows {diff}; launches {sm['launches']} expected "
            f"{chk['expected_launches']}, nested {sm['nested_launches']} expected "
            f"{chk['expected_nested_launches']}, combine {sm['paged_combine_launches']} expected "
            f"{chk['expected_combine']}; accounting {chk['accounting']}; S6 rejections "
            f"{chk['s6_rejections']} {'OK' if chk['ok'] else 'FAIL'}")
        if label == "S1":
            log(f"  S1 phase seconds {sm['phase_seconds']}; target params bit-equal to "
                f"Serve's: {sm['target_bit_equal_serve']}; Serve: "
                f"{served['serve_tok_per_s']:.1f} tok/s, step p50 "
                f"{serve_st['step_p50_s'] * 1e3:.2f} ms, {serve_st['steps']} steps")
        ok = ok and chk["ok"]
        runs[label] = r
    # How often the draft's greedy choice is the target's, teacher-forced on
    # *Serve*'s streams (every generated position of the 8 requests): what
    # bounds a greedy row's acceptance.
    agree = []
    with torch.no_grad():
        for p, w in zip(prompts, want):
            seq = torch.as_tensor(np.concatenate([p, w[:-1]])[None], device="cuda")
            lt, ld = (base["model"].apply(t, seq, mode="train")[0, len(p) - 1:].argmax(-1)
                      for t in (base["params"], base["draft"]))
            agree.append((lt == ld).float().cpu().numpy())
    agreement = float(np.concatenate(agree).mean())
    log(f"  draft's greedy choice = target's at {agreement:.4f} of the {sum(map(len, agree))} "
        f"teacher-forced positions of Serve's streams (nsvd {SPEC_RATIO} against 0.2, "
        f"random weights)")
    logits = spec_logits_check(torch, np, base["model"], base["params"], base["draft"], "cuda")
    for c in logits["calls"]:
        log(f"  {c['call']} ({c['rows']} rows) logits kernels vs plain: max abs err "
            f"{c['max_abs_err']:.4e} (max |logit| {c['max_abs']:.3f}, tol "
            f"{STEP_LOGIT_TOL * c['max_abs']:.4e}), nested {c['nested_launches']} expected "
            f"{c['expected']} {'OK' if c['ok'] else 'FAIL'}")
    ok = ok and logits["ok"]
    # One spec step of a worst-case engine with its 8 rows live, profiled:
    # the draft root (5 decodes), the verify root (a 40-row chunk) and both.
    eng = ServingEngine(base["model"], base["params"], max_batch=8, max_len=256, seed=0,
                        block_size=16, prefill_chunk=64, pipeline_depth=1,
                        sched_config=SchedulerConfig(admission="worst_case"),
                        spec_config=SpecConfig(base["draft"], k=SPEC_K))
    for p in prompts:
        eng.submit(p, max_new_tokens=32)
    while eng.sched or eng._prefilling:
        eng.run(max_steps=1)
    keep, temps, eos = eng._host_inputs()[:3]
    d = eng.draft

    def draft_root():
        return eng._spec_draft(d.params, d.pools, d.table_device(), eng.last_token,
                               eng.cache_len, d.key_data, eng.active_dev, keep, temps)

    def verify_root(proposals, q):
        return eng._spec_verify(eng.params, eng.kv.pools, eng.kv.table_device(),
                                eng.last_token, proposals, q, eng.cache_len, eng.budget_dev,
                                eng.key_data, eng.active_dev, keep, temps, eos, eng._k_row_dev)

    proposals, q, _ = draft_root()
    prof = {"draft": profile_step(torch, draft_root, f"spec draft root ({SPEC_K + 1} decodes "
                                  "x 8 rows)"),
            "verify": profile_step(torch, lambda: verify_root(proposals, q),
                                   f"spec verify root (8 x {SPEC_K + 1} = 40 rows)"),
            "step": profile_step(torch, lambda: verify_root(*draft_root()[:2]),
                                 "spec step (draft + verify roots)")}
    eng.drain()
    served["draft"] = base["draft"]
    s1 = runs["S1"]["summary"]
    log(f"  spec step: wall {prof['step']['wall_ms']:.2f} ms, device "
        f"{prof['step']['device_busy_ms']:.3f} ms = draft root "
        f"{prof['draft']['device_busy_ms']:.3f} + verify root "
        f"{prof['verify']['device_busy_ms']:.3f} (profiled apart); S1 {s1['tok_per_s']:.1f} "
        f"tok/s, step p50 {s1['stats']['step_p50_s'] * 1e3:.2f} ms against Serve's "
        f"{served['serve_tok_per_s']:.1f} tok/s, {serve_st['step_p50_s'] * 1e3:.2f} ms")
    summary = dict(config=cfg.name, layers=cfg.num_layers, k=SPEC_K, draft_ratio=SPEC_RATIO,
                   prompt_lengths=[len(p) for p in prompts],
                   runs={k: v["summary"] for k, v in runs.items()}, profile=prof,
                   draft_target_agreement=agreement, logits_check=logits,
                   serve_tok_per_s=served["serve_tok_per_s"], serve_stats=serve_st,
                   ok=bool(ok))
    return summary, runs["S1"]["summary"]["launches"]


# Phase 4e (obs_serve): serving observability on *Serve*'s compressed model
# and spec_serve's 0.6 draft, nothing compressed again.  Runs: O1 *Serve*'s
# plan (8 prompts, 32 new tokens, worst case, depth 1) with telemetry off;
# O2t the same with a Telemetry (the hooks alone); O2 with a Telemetry and
# a MetricsServer on port 0 scraped over HTTP from a thread every
# OBS_SCRAPE_S while it runs, and in its first run a ProfileCapture of
# OBS_PROFILE_STEPS steps (O1, O2t and O2 in turn, OBS_PAIRS times); O3
# sched_serve C's plan (16 prompts, 48 new tokens, on demand at depth 2, a
# 56-block pool, swap resume, defrag every 8 steps) with F1's fault plan,
# off and on; O4 spec_serve S5 (a draft kill, a poisoned row) off and on,
# /healthz read between its steps.  The scrape interval is a stress
# setting (a Prometheus scrape is typically every 15 s), so that a run of
# under a second sees several.  Three pairs (medians of three) keep the
# whole script inside its time limit beside the mesh_serve path.
OBS_PAIRS, OBS_PROFILE_STEPS, OBS_SCRAPE_S = 3, 8, 0.1
OBS_PROFILE_DIR = os.path.join(OUT_DIR, "obs_profile")
OBS_TRACE_KEEP_BYTES = 8 << 20  # a larger captured trace is summarised, then removed


class Scraper:
    """GET /metrics, /metrics.json and /healthz of a MetricsServer from a
    thread, at once and then every OBS_SCRAPE_S seconds until ``stop()``;
    counts the answers and keeps the last /metrics body."""

    def __init__(self, port: int):
        import threading

        self.base = f"http://127.0.0.1:{port}"
        self.ok = self.failed = 0
        self.last = ""
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._loop, name="scraper", daemon=True)
        self._thread.start()

    def _loop(self):
        import urllib.error
        import urllib.request

        while True:  # the first scrape at once, the next every OBS_SCRAPE_S
            for path in ("/metrics", "/metrics.json", "/healthz"):
                try:
                    with urllib.request.urlopen(self.base + path, timeout=5) as r:
                        body = r.read().decode()
                    if path == "/metrics":
                        self.last = body
                    self.ok += 1
                except urllib.error.HTTPError:
                    self.ok += 1  # /healthz answers 503 while degraded
                except OSError:
                    self.failed += 1
            if self._done.wait(OBS_SCRAPE_S):
                return

    def stop(self) -> dict:
        self._done.set()
        self._thread.join(timeout=10)
        return {"scrapes_ok": self.ok, "scrapes_failed": self.failed,
                "last_metrics_lines": self.last.count("\n")}


def timed_telemetry():
    """A Telemetry whose ``on_*`` hooks add their own host seconds to
    ``hook_s`` and their calls to ``hook_calls``: the hooks' cost read
    directly, apart from the host's run-to-run noise."""
    from repro_torch.obs import Telemetry

    tel = Telemetry()
    tel.hook_s, tel.hook_calls = 0.0, 0
    for name in [n for n in dir(Telemetry) if n.startswith("on_")]:
        def timed(*args, _fn=getattr(tel, name), **kw):
            t0 = time.perf_counter()
            try:
                return _fn(*args, **kw)
            finally:
                tel.hook_s += time.perf_counter() - t0
                tel.hook_calls += 1
        setattr(tel, name, timed)
    return tel


def root_range_us(n: int = 20000) -> float:
    """Host µs that ``wrap_root``'s range adds to one root call (a wrapped
    no-op against the bare one), with telemetry on or off alike."""
    from repro_torch.obs import wrap_root

    def noop():
        return None

    walls = []
    for fn in (noop, wrap_root(noop, "bench")):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        walls.append((time.perf_counter() - t0) / n * 1e6)
    return walls[1] - walls[0]


def healthz(port: int) -> tuple:
    """(status, JSON body or text) of one GET /healthz."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=5) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def lifecycle(tel) -> dict:
    """Each request's lifecycle events (pid PID_REQUESTS, cat "request") in
    the order they were traced: submit, then admit, first_chunk,
    first_token and commits once, then per re-prefill (preemption or
    retry) admit, first_chunk, first_token and commits again, or per swap
    resume admit and commits, then finish; timestamps never go back."""
    import re

    code = {"submit": "S", "admit": "A", "first_chunk": "C", "first_token": "F",
            "commit": "K", "finish": "E"}
    seq, ts = {}, {}
    for e in tel.tracer.events():
        if e.cat == "request" and e.name in code:
            seq[e.tid] = seq.get(e.tid, "") + code[e.name]
            ts.setdefault(e.tid, []).append(e.ts_us)
    bad = {uid: s for uid, s in seq.items()
           if not re.fullmatch("SACFK*(A(CF)?K*)*E", s) or ts[uid] != sorted(ts[uid])}
    return {"requests": len(seq), "simple": sum(bool(re.fullmatch("SACFK*E", s))
                                                 for s in seq.values()),
            "out_of_order": bad, "ok": not bad and tel.tracer.dropped == 0}


def reconcile(tel, eng) -> dict:
    """The telemetry's counters against the engine's own accounts."""
    st, sch, fs, ss = eng.stats(), eng.scheduler_stats(), eng.fault_stats(), eng.spec_stats()
    reqs = eng.finished_requests.values()
    events = tel.tracer.events()
    sheds = [e.args["reason"] for e in events if e.name == "shed"]
    preempts = {labels["reason"]: c.value for labels, c in tel.preempts.series()}
    faults = {labels["kind"]: c.value for labels, c in tel.faults.series()}
    out = {
        "submitted": tel.requests_submitted.value == len(eng.finished_requests),
        "finished": tel.requests_finished.value == len(eng.finished_requests),
        "tokens": tel.tokens_emitted.value == sum(len(r.generated) for r in reqs),
        "steps": tel.steps_dispatched.value == st["steps"] == eng._step_idx,
        "preemptions": (sum(preempts.values()) == sch["preempt_count"]
                        and preempts.get("priority", 0) == sch["priority_preemptions"]),
        "swap_bytes": tel.swap_bytes.value == sch["swap_bytes"],
        "faults": faults == {k: float(v) for k, v in fs["injected"].items() if v},
        "retries": tel.retries.value == fs["retried"],
        "shed": (len([r for r in sheds if r != "cancelled"]) == fs["shed"]
                 and tel.deadline_shed.value == sheds.count("deadline")
                 and sheds.count("cancelled") == fs["cancelled"]),
    }
    if ss:
        rows = [(int(lb["k"]), int(lb["accepted"]), c.value) for lb, c in tel.spec_rows.series()]
        block = tel.bench_block()["spec"]
        out["spec_rows"] = (sum(n for *_, n in rows) == eng.spec_step_rows
                            and sum(k * n for k, _, n in rows) == ss["proposed"]
                            and sum(a * n for _, a, n in rows) == ss["accepted"]
                            and block["acceptance_rate"] == ss["acceptance_rate"])
    return out


def obs_run(torch, np, label, served, telemetry: bool, capture: bool = False,
            server: bool = False) -> dict:
    """One run of the obs_serve path (O1/O2 on *Serve*'s plan, O3, O4) on a
    fresh engine, its launch counts read around it and every dispatch
    under sync-debug "error"; with ``telemetry`` a Telemetry (with a
    capture: a ProfileCapture into OBS_PROFILE_DIR) and, with ``server``, a
    MetricsServer scraped from a thread (O4: /healthz read between steps,
    its answers per degraded view)."""
    import shutil

    from repro_torch.obs import MetricsServer, Telemetry
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.faults import FaultPlan, FaultPolicy, FaultSpec
    from repro_torch.serving.scheduler import SchedulerConfig
    from repro_torch.serving.spec import SpecConfig

    model, params = served["model"], served["params"]
    cuda = params["embed"]["table"].device.type == "cuda"
    kw = dict(max_batch=8, max_len=256, seed=0, block_size=16, prefill_chunk=64)
    plan = policy = spec = None
    defrag_every, max_new = 0, 32
    prompts = served["prompts"]
    if label in ("O1", "O2t", "O2"):
        kw.update(pipeline_depth=1, sched_config=SchedulerConfig(admission="worst_case"))
    elif label == "O3":
        prompts, max_new, defrag_every = served["sched"]["prompts"], SCHED_MAX_NEW, 8
        plan = FaultPlan([FaultSpec(*sp) for sp in FAULT_SPECS["F1"]])
        policy = FaultPolicy(max_retries=1, retry_backoff_steps=2)
        kw.update(pipeline_depth=2, num_blocks=SCHED_POOL,
                  sched_config=SchedulerConfig(resume="swap"))
    else:
        faults = next(r for r in SPEC_RUNS if r[0] == "S5")[6]
        plan = FaultPlan([FaultSpec(kind, step, uid) for kind, step, uid in faults])
        policy = FaultPolicy(max_retries=1, retry_backoff_steps=2,
                             draft_cooldown_steps=SPEC_COOLDOWN)
        spec = SpecConfig(served["draft"], k=SPEC_K, draft_ratio=SPEC_RATIO)
        kw.update(pipeline_depth=2, paged=True, sched_config=SchedulerConfig())
    tel = None
    if telemetry:
        if capture:
            shutil.rmtree(OBS_PROFILE_DIR, ignore_errors=True)
        tel = (Telemetry(profile_dir=OBS_PROFILE_DIR if capture else None,
                         profile_steps=OBS_PROFILE_STEPS) if label != "O2t"
               else timed_telemetry())
    eng = ServingEngine(model, params, faults=plan, fault_policy=policy, spec_config=spec,
                        telemetry=tel, **kw)
    srv = MetricsServer(tel.metrics, port=0, health=eng.degraded_components) if server else None
    scraper = Scraper(srv.port) if srv is not None and label != "O4" else None
    checked, health = {}, []
    if cuda:
        torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with dispatches_checked(torch, checked):
        uids = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
        next_defrag = defrag_every
        while eng.sched or eng._prefilling or eng.active.any() or eng._parked:
            eng.run(max_steps=1)
            if defrag_every and len(eng.step_times) >= next_defrag:
                eng.defrag()
                next_defrag += defrag_every
            if label == "O4" and srv is not None:
                view = eng.degraded_components()
                if "draft" in view or (health and health[-1][0] == 503):
                    health.append(healthz(srv.port) + (view.get("draft"),))
        eng.drain()
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(read_counts(), nested=nested_split(),
                  paged_combine=_ops("paged_attention").combine_launches)
    scrape = scraper.stop() if scraper is not None else None
    if srv is not None:
        srv.close()
    if tel is not None and tel.profile is not None:
        tel.profile.stop()
    reqs = [eng.finished_requests.get(u) for u in uids]
    n_tok = sum(len(r.generated) for r in reqs if r is not None)
    st = eng.stats()
    out = {"outputs": [r.generated if r else None for r in reqs], "telemetry": tel,
           "engine": eng, "health": health,
           "summary": dict(run=label, telemetry=telemetry, capture=capture, server=server,
                           seconds=wall, tokens=n_tok, tok_per_s=n_tok / wall,
                           step_p50_ms=st["step_p50_s"] * 1e3,
                           step_p90_ms=st["step_p90_s"] * 1e3, stats=st, launches=counts,
                           dispatches=dict(checked), scrape=scrape,
                           scrape_count=scrape["scrapes_ok"] if scrape else 0,
                           reasons=sorted({r.finish_reason for r in reqs if r is not None}))}
    if tel is not None:
        out["summary"].update(bench=tel.bench_block(), reconcile=reconcile(tel, eng),
                              lifecycle=lifecycle(tel), events=len(tel.tracer),
                              dropped=tel.tracer.dropped)
        if label == "O2t":
            out["summary"].update(hook_ms_per_step=tel.hook_s * 1e3 / st["steps"],
                                  hook_calls_per_step=tel.hook_calls / st["steps"])
    return out


def profile_trace_check(tel, cuda: bool = True) -> dict:
    """The capture's Chrome trace: its serving_root.paged_decode ranges and,
    on the card, the decode step's kernels (nested stream, paged split and
    combine)."""
    prof = tel.profile
    out = {"error": None if prof.error is None else repr(prof.error), "path": prof.trace_path}
    if prof.error is not None or prof.trace_path is None:
        return dict(out, ok=False)
    size = os.path.getsize(prof.trace_path)
    with open(prof.trace_path) as f:
        evs = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in evs]
    kernels = [e.get("name", "") for e in evs if e.get("cat") == "kernel"]
    found = {"serving_root.paged_decode": names.count("serving_root.paged_decode"),
             **{k: sum(k in n for n in kernels)
                for k in (("stream_partial", "paged_split_kernel", "paged_combine_kernel")
                          if cuda else ())}}
    if size > OBS_TRACE_KEEP_BYTES:
        os.remove(prof.trace_path)
    return dict(out, bytes=size, events=len(evs), kernel_events=len(kernels), found=found,
                kept=size <= OBS_TRACE_KEEP_BYTES, ok=all(v > 0 for v in found.values()))


def obs_runs(torch, np, served, pairs: int = OBS_PAIRS) -> tuple:
    """O1, O2t and O2 ``pairs`` times in turn (O2's first with the
    capture), then O3 and O4 off and on: (O1 runs, O2t runs, O2 runs, O3
    pair, O4 pair)."""
    offs, hooks, ons = [], [], []
    for i in range(pairs):
        offs.append(obs_run(torch, np, "O1", served, telemetry=False))
        hooks.append(obs_run(torch, np, "O2t", served, telemetry=True))
        ons.append(obs_run(torch, np, "O2", served, telemetry=True, capture=i == 0,
                           server=True))
    o3 = [obs_run(torch, np, "O3", served, telemetry=t) for t in (False, True)]
    o4 = [obs_run(torch, np, "O4", served, telemetry=t, server=t) for t in (False, True)]
    return offs, hooks, ons, o3, o4


def obs_gates(offs, hooks, ons, o3, o4, n_prompts: int, cuda: bool) -> tuple:
    """The obs_serve path's gates over its runs: (gates, O2's capture
    check, O4's /healthz answers)."""
    runs = offs + hooks + ons
    gates = {"O2_streams": all(r["outputs"] == offs[0]["outputs"] for r in runs),
             "O2_launches": all(r["summary"]["launches"] == offs[0]["summary"]["launches"]
                                for r in runs)}
    trace = profile_trace_check(ons[0]["telemetry"], cuda)
    gates["O2_trace"] = trace["ok"]
    gates["O2_scraped"] = all(r["summary"]["scrape"]["scrapes_ok"] > 0
                              and r["summary"]["scrape"]["scrapes_failed"] == 0 for r in ons)
    gates["O3_streams"] = o3[1]["outputs"] == o3[0]["outputs"]
    gates["O4_streams"] = o4[1]["outputs"] == o4[0]["outputs"]
    health = o4[1]["health"]
    during = [h for h in health if h[2] is not None]
    after = [h for h in health if h[2] is None]
    gates["O4_healthz"] = (bool(during) and all(c == 503 and "draft" in b["components"]
                                                for c, b, _ in during)
                           and bool(after) and after[-1][0] == 200)
    for name, r in (("O2t", hooks[0]), ("O2", ons[0]), ("O3", o3[1]), ("O4", o4[1])):
        sm = r["summary"]
        gates[f"{name}_reconcile"] = all(sm["reconcile"].values())
        gates[f"{name}_lifecycle"] = sm["lifecycle"]["ok"]
    gates["O2_lifecycle_simple"] = all(r["summary"]["lifecycle"]["simple"] == n_prompts
                                       for r in hooks + ons)
    gates["no_sync_in_dispatch"] = all(
        sum(r["summary"]["dispatches"].values()) == r["summary"]["stats"]["steps"]
        + r["engine"].fault_events["draft_kills"] for r in runs + o3 + o4)
    return gates, trace, health


def obs_serve_path(torch, np, served):
    """Serving observability at Mistral-7B width (phase 4e): runs O1-O4 on
    *Serve*'s compressed model and spec_serve's draft.  Gates: O2's streams
    bit-identical to O1's with equal launches of every kernel, O3's and
    O4's to their runs without telemetry; the counters reconciled with
    ``stats()``, ``scheduler_stats()``, ``fault_stats()`` and
    ``spec_stats()``; every request's events in lifecycle order; /healthz
    503 naming the draft during O4's cool-down and 200 after it; no sync
    in any dispatch; O2's captured trace holding serving_root.paged_decode
    ranges and the decode step's kernels.  Prints TTFT, TPOT and queue wait
    from bench_block(), and step p50 and tok/s with telemetry off and on,
    with the same pair for a profiled engine step's wall."""
    from repro_torch.obs import Telemetry
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.scheduler import SchedulerConfig

    model = served["model"]
    cfg = model.cfg
    offs, hooks, ons, o3, o4 = obs_runs(torch, np, served)
    gates, trace, health = obs_gates(offs, hooks, ons, o3, o4, len(served["prompts"]),
                                     cuda=True)
    for name, r in (("O1", offs[0]), ("O2t", hooks[0]), ("O2", ons[0]), ("O2", ons[1]),
                    ("O3 off", o3[0]), ("O3", o3[1]), ("O4 off", o4[0]), ("O4", o4[1])):
        sm = r["summary"]
        line = (f"  run {name}: {sm['tokens']} tokens in {sm['seconds']:.3f} s = "
                f"{sm['tok_per_s']:.1f} tok/s; steps {sm['stats']['steps']}, step p50 "
                f"{sm['step_p50_ms']:.3f} p90 {sm['step_p90_ms']:.3f} ms; reasons "
                f"{sm['reasons']}; launches {sm['launches']}")
        if sm["telemetry"]:
            bb = sm["bench"]
            line += (f"; TTFT p50 {bb['ttft_s']['p50'] * 1e3:.2f} p99 "
                     f"{bb['ttft_s']['p99'] * 1e3:.2f} ms, TPOT p50 "
                     f"{bb['tpot_s']['p50'] * 1e3:.3f} ms, queue wait p50 "
                     f"{bb['queue_wait_s']['p50'] * 1e3:.2f} ms ({bb['ttft_s']['count']} "
                     f"requests); events {sm['events']} (dropped {sm['dropped']}); "
                     f"reconcile {sm['reconcile']}; lifecycle {sm['lifecycle']}; "
                     f"scrape {sm['scrape']}")
        log(line)
    log(f"  O4 /healthz: {[(c, h) for c, _, h in health]}")
    log(f"  O2 capture ({OBS_PROFILE_STEPS} steps): {trace}")

    def med(rs, key):
        return _median([r["summary"][key] for r in rs])

    def bench(rs, key, stat):
        return _median([r["summary"]["bench"][key][stat] for r in rs])
    on_runs = {"O2t": hooks[0], "O2": ons[0], "O3": o3[1], "O4": o4[1]}
    # Overhead: the hooks alone (O2t), and with a scraped server (O2 but
    # the first, which writes a trace in the middle of its steps).
    scraped = ons[1:]
    overhead = {"step_p50_ms_off": med(offs, "step_p50_ms"),
                "step_p50_ms_on": med(hooks, "step_p50_ms"),
                "step_p50_ms_scraped": med(scraped, "step_p50_ms"),
                "tok_per_s_off": med(offs, "tok_per_s"), "tok_per_s_on": med(hooks, "tok_per_s"),
                "tok_per_s_scraped": med(scraped, "tok_per_s"),
                "scrape_gets_per_run": med(scraped, "scrape_count"),
                "step_p50_ms_on_capture": ons[0]["summary"]["step_p50_ms"],
                "tok_per_s_on_capture": ons[0]["summary"]["tok_per_s"],
                "hook_ms_per_step": med(hooks, "hook_ms_per_step"),
                "hook_calls_per_step": med(hooks, "hook_calls_per_step"),
                "root_range_us": root_range_us()}
    # One engine step (depth 1, 8 rows decoding) profiled, off and on.
    walls = {}
    for name, tel in (("off", None), ("on", Telemetry())):
        eng = ServingEngine(model, served["params"], max_batch=8, max_len=256, seed=0,
                            block_size=16, prefill_chunk=64, pipeline_depth=1,
                            sched_config=SchedulerConfig(admission="worst_case"), telemetry=tel)
        for p in served["prompts"]:
            eng.submit(p, max_new_tokens=32)
        while eng.sched or eng._prefilling:
            eng.run(max_steps=1)
        walls[name] = profile_step(torch, eng.step, quiet=True)
        eng.drain()
    overhead.update(step_wall_ms_off=walls["off"]["wall_ms"], step_wall_ms_on=walls["on"]["wall_ms"],
                    step_device_ms_off=walls["off"]["device_busy_ms"],
                    step_device_ms_on=walls["on"]["device_busy_ms"])
    overhead["step_p50_added_ms"] = overhead["step_p50_ms_on"] - overhead["step_p50_ms_off"]
    overhead["step_wall_added_ms"] = overhead["step_wall_ms_on"] - overhead["step_wall_ms_off"]
    latency = {f"{key}_{stat}_ms": bench(hooks, key, stat) * 1e3
               for key, stat in (("ttft_s", "p50"), ("ttft_s", "p99"), ("tpot_s", "p50"),
                                 ("queue_wait_s", "p50"))}
    log(f"  telemetry overhead (medians of {OBS_PAIRS} runs each; O2 without its capture "
        f"run): step p50 off {overhead['step_p50_ms_off']:.3f}, hooks "
        f"{overhead['step_p50_ms_on']:.3f} ({overhead['step_p50_added_ms']:+.3f}), hooks + "
        f"server scraped every {OBS_SCRAPE_S} s {overhead['step_p50_ms_scraped']:.3f} ms "
        f"({overhead['scrape_gets_per_run']:.0f} GETs a run); tok/s "
        f"{overhead['tok_per_s_off']:.1f} / {overhead['tok_per_s_on']:.1f} / "
        f"{overhead['tok_per_s_scraped']:.1f}; with the capture "
        f"{overhead['step_p50_ms_on_capture']:.3f} ms, {overhead['tok_per_s_on_capture']:.1f} "
        f"tok/s; profiled engine step wall {overhead['step_wall_ms_off']:.3f} -> "
        f"{overhead['step_wall_ms_on']:.3f} ms ({overhead['step_wall_added_ms']:+.3f}), device "
        f"{overhead['step_device_ms_off']:.3f} / {overhead['step_device_ms_on']:.3f} ms")
    log(f"  hooks read directly (O2t): {overhead['hook_ms_per_step'] * 1e3:.1f} us a step in "
        f"{overhead['hook_calls_per_step']:.1f} hook calls; wrap_root's range "
        f"{overhead['root_range_us']:.2f} us a root call (telemetry on or off)")
    log(f"  Serve's plan with telemetry (O2t, medians of {OBS_PAIRS} runs): TTFT p50 "
        f"{latency['ttft_s_p50_ms']:.2f} ms, p99 {latency['ttft_s_p99_ms']:.2f} ms, TPOT p50 "
        f"{latency['tpot_s_p50_ms']:.3f} ms, queue wait p50 "
        f"{latency['queue_wait_s_p50_ms']:.3f} ms")
    ok = all(gates.values())
    log(f"  gates {gates} {'OK' if ok else 'FAIL'}")
    for k in ("draft", "sched"):
        served.pop(k, None)
    # mesh_serve takes on the model, params, prompts and streams, and O1's
    # launches and stats (Serve's plan on a fresh engine).
    served.update(plan_launches=offs[0]["summary"]["launches"],
                  plan_stats=offs[0]["summary"]["stats"])
    summary = dict(config=cfg.name, layers=cfg.num_layers, pairs=OBS_PAIRS,
                   runs={f"{r['summary']['run']}_{i}": r["summary"]
                         for i, r in enumerate(offs + hooks + ons + o3 + o4)},
                   latency=latency,
                   o4_healthz=[(c, h) for c, _, h in health], profile_trace=trace,
                   overhead=overhead, profiled_step={"off": walls["off"], "on": walls["on"]},
                   bench={k: r["summary"]["bench"] for k, r in on_runs.items()},
                   gates=gates, ok=bool(ok))
    return summary, {k: ons[0]["summary"]["launches"][k] for k in KERNELS}


# Phase 4f (mesh_serve): the parallelism layer on *Serve*'s compressed model
MESH_SHAPE = (1, 1)  # the serving mesh one card holds (dp, tp)


def mesh_serve_path(torch, np, served, device: str = "cuda"):
    """*Serve*'s plan over a (1, 1) serving mesh on one NCCL rank (phase 4f):
    a checkpoint of *Serve*'s params restored onto the mesh, then the
    engine with ``parallelism=``.  Gates: the restored leaves, the streams
    and every kernel's launches equal to the meshless ones, the data
    group's all-gathers as predicted (one a decode step and one an
    admission's first-token read: O1's host syncs) and no TP collective, no
    sync in a dispatch.  Then one decode step profiled (depth 1, 8 rows),
    the NCCL gather's device time apart.  The process group is destroyed
    on every exit.  ``device="cpu"``: one gloo rank, no profile (the CPU
    tests' run of this path)."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.parallel import collectives, make_parallelism, param_shardings
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.scheduler import SchedulerConfig

    model, params, prompts = served.pop("model"), served.pop("params"), served.pop("prompts")
    want, plan = served.pop("outputs"), served.pop("plan_launches")
    plan_st = served.pop("plan_stats")
    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    tmp = tempfile.mkdtemp(prefix="mesh_serve_")
    kw = dict(max_batch=8, max_len=256, seed=0, block_size=16, prefill_chunk=64,
              pipeline_depth=1, sched_config=SchedulerConfig(admission="worst_case"))
    try:
        t0 = time.perf_counter()
        dist.init_process_group("nccl" if cuda else "gloo",
                                store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        mesh = make_serving_mesh(*MESH_SHAPE, device=device)
        par = make_parallelism(mesh)
        t_mesh = time.perf_counter() - t0
        t0 = time.perf_counter()
        mgr = CheckpointManager(os.path.join(tmp, "ckpt"), keep=1, async_save=False)
        mgr.save(0, params)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        local, _, _ = mgr.restore(shardings=param_shardings(params, mesh))
        sync()
        t_restore = time.perf_counter() - t0
        restored = all(a.device == b.device and a.dtype == b.dtype and torch.equal(a, b)
                       for a, b in zip(_tensors(local), _tensors(params)))
        ckpt_bytes = sum(t.numel() * t.element_size() for t in _tensors(local))
        del params
        eng = ServingEngine(model, local, parallelism=par, **kw)
        checked = {}
        sync()
        reset_counts()
        collectives.reset_counts()
        t0 = time.perf_counter()
        with dispatches_checked(torch, checked):
            uids = [eng.submit(p, max_new_tokens=32) for p in prompts]
            out = eng.run()
        sync()
        wall = time.perf_counter() - t0
        counts = dict(read_counts(), nested=nested_split(),
                      paged_combine=_ops("paged_attention").combine_launches)
        coll = {f"{k} {a}": n for (k, a), n in sorted(collectives.counts.items())}
        st = eng.stats()
        streams = [out[u] for u in uids]
        want_gathers = plan_st["host_syncs"]  # O1's decode steps + first-token reads
        tp_coll = sum(n for (k, a), n in collectives.counts.items() if a == "model")
        cs = eng.cache_stats()
        prof, gather_ms = {"wall_ms": 0.0, "device_busy_ms": 0.0}, {}
        if cuda:  # one decode step (depth 1, 8 rows decoding) on a fresh engine
            eng2 = ServingEngine(model, local, parallelism=par, **kw)
            for p in prompts:
                eng2.submit(p, max_new_tokens=32)
            while eng2.sched or eng2._prefilling:
                eng2.run(max_steps=1)
            prof = profile_step(torch, eng2.step, "mesh decode step (1, 1)")
            eng2.drain()
            gather_ms = {k: ms for k, ms in prof["kernels"].items()
                         if "nccl" in k.lower() or "Memcpy DtoD" in k}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    gates = {
        "restored_bit_identical": restored,
        "streams_bit_identical": streams == want,
        "launches_equal": counts == plan,
        "data_gathers": coll.get("all_gather data", 0) == want_gathers == st["host_syncs"],
        "no_tp_collective": tp_coll == 0,
        "no_sync_in_dispatch": checked.get("_dispatch_decode", 0) == st["steps"] > 0,
        "mesh": cs["mesh"] == {"dp": 1, "tp": 1, "devices": 1},
    }
    ok = all(gates.values())
    log(f"  mesh {MESH_SHAPE}: process group and mesh {t_mesh:.2f} s; checkpoint of "
        f"{ckpt_bytes / 1e9:.3f} GB saved {t_save:.2f} s, restored onto the mesh "
        f"{t_restore:.2f} s; served {sum(len(x) for x in streams)} tokens in {wall:.3f} s, "
        f"steps {st['steps']}, host syncs {st['host_syncs']} (O1 {want_gathers}); "
        f"collectives {coll}; launches {counts}")
    log(f"  mesh decode step: wall {prof['wall_ms']:.3f} ms, device "
        f"{prof['device_busy_ms']:.4f} ms; the token word's gather (NCCL, one rank): "
        f"{ {k: round(ms * 1e3, 2) for k, ms in gather_ms.items()} } us")
    log(f"  gates {gates} {'OK' if ok else 'FAIL'}")
    summary = dict(mesh=list(MESH_SHAPE), seconds_mesh=t_mesh, seconds_save=t_save,
                   seconds_restore=t_restore, checkpoint_bytes=ckpt_bytes,
                   serve_seconds=wall, stats=st, cache_stats=cs, collectives=coll,
                   predicted_data_gathers=want_gathers, launches=counts,
                   plan_launches=plan, profile=prof,
                   gather_device_us={k: ms * 1e3 for k, ms in gather_ms.items()},
                   gates=gates, ok=bool(ok))
    return summary, {k: counts[k] for k in KERNELS}


def _tensors(tree):
    for key in sorted(tree):
        v = tree[key]
        if isinstance(v, dict):
            yield from _tensors(v)
        else:
            yield v


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
    gsplit, gshapes = gram_split(), gram_shape_split()
    nsplit, bsplit = nested_split(), batched_split()
    gshapes_expect = batched_gram_expect(cfg, model, 256 // 16)
    gram_ok = (gsplit == {"mma": counts["gram"], "tf32x3": 0, "fma": 0}  # every tap is bf16
               and {k: c for k, c in gshapes.items() if k.startswith("batched")}
               == gshapes_expect)
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
                   gram_shape_launches=gshapes,
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
                 and gsplit == {"mma": expect["gram"], "tf32x3": 0, "fma": 0})

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


# The whisper path: whisper-small at full width and depth (12 + 12
# layers, 768 wide, 12/12 heads x 64, d_ff 3072, vocab 51865, 1500 frames;
# no cut), random bf16 weights from seed 0, through the reference's own
# entry points for the family (its serving engine has no encoder-decoder
# path, and the port's refuses one): calibrate (the paper's 256 x 128
# tokens of en_a in 16 batches of 16), compress (nsvd1 at 0.2, k1_frac 0.9,
# every one of the 192 targets), evaluate (perplexity on en_a and jp,
# dense and compressed, and the logit KL on en_a, 2 (16, 128) batches
# each) and decode (greedy, 8 rows, 16-token prompts, 32 new tokens: one
# ``make_prefill_step`` call, then 31 ``make_decode_step`` steps on the
# cross K/V the prefill built).  Frames stand in for the stubbed conv
# frontend: standard normal (B, 1500, 768) fp32 from a numpy seed a batch,
# as the reference's tests draw them.
WHISPER_RUN = dict(calib_batches=16, calib_batch=16, seq=128, eval_batches=2,
                   eval_batch=16, rows=8, prompt=16, new=32)
WHISPER_DOMAINS = ("en_a", "jp")
# Exact counts of the whisper path's main run, entered before its first
# chip call (``whisper_expect`` derives them from WHISPER_RUN's shapes;
# tests/test_torch_encdec.py holds that derivation to a CPU run of a
# reduced twin).  gram: 132 taps x 16 batches (4 a layer x 12 encoder, 7 x
# 12 decoder), all on the mma kernel (bf16, n 768 or 3072).  flash: 12
# decoder layers x 29 causal forwards (16 calibration, 2 domains x 2
# batches x dense and compressed, 2 x 2 KL, 1 prefill), all tensor-core;
# the encoder's bidirectional and every cross attention are plain torch.
# nested: 8 compressed linears a decoder layer at decode and over the
# prompt rows (self q/k/v/o, cross q/o, mlp wi/wo): stream 96 x 31 decode
# steps (8 rows), mma 96 x 1 prefill call (128 rows), tile 0; and apart,
# the wrapper's calls above its 1024-row gate, plain matmuls (the
# reference leaves them to XLA): 192 a compressed (16, 128) forward (the
# encoder's 72 over 24000 frame rows, cross wk/wv's 24 over them, the
# decoder's 96 over 2048 rows) x 6, and 96 at the prefill (the encoder's
# 72 over 12000 rows, cross wk/wv's 24).
WHISPER_PREDICTED = dict(gram=2112, flash=348, stream=2976, mma=96, gate=1248)


def whisper_expect(cfg, run, gate_rows: int = 1024, stream_rows: int = 16) -> dict:
    """The whisper path's counts from its shapes: gram calls a calibration
    batch (4 taps an encoder layer, 7 a decoder layer), flash calls (one a
    decoder layer a causal forward), and the compressed linears' calls by
    the route their rows take in the nested wrapper (bf16: "stream" up to
    ``stream_rows``, "mma" up to ``gate_rows``, "gate" above: plain)."""
    enc, dec, t = cfg.encoder_layers, cfg.num_layers, cfg.encoder_seq
    nested = Counter()

    def route(rows):
        return "stream" if rows <= stream_rows else "mma" if rows <= gate_rows else "gate"

    def forward(b, s):  # one compressed train or prefill forward
        nested[route(b * t)] += 6 * enc + 2 * dec  # encoder; cross wk, wv over memory
        nested[route(b * s)] += 8 * dec
    evals = len(WHISPER_DOMAINS) * run["eval_batches"]
    for _ in range(evals + run["eval_batches"]):  # compressed ppl, then the KL's
        forward(run["eval_batch"], run["seq"])
    forward(run["rows"], run["prompt"])
    nested[route(run["rows"])] += 8 * dec * (run["new"] - 1)
    causal = run["calib_batches"] + 2 * evals + 2 * run["eval_batches"] + 1
    return dict(gram=(4 * enc + 7 * dec) * run["calib_batches"], flash=dec * causal,
                stream=nested["stream"], mma=nested["mma"], gate=nested["gate"])


def whisper_frames(np, cfg, b: int, seed: int):
    """Stand-in frames for the stubbed conv frontend (B, encoder_seq,
    d_model), fp32, as the reference's tests draw them."""
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.encoder_seq, cfg.d_model), np.float32)


def plain_greedy(torch, model, params, batch: dict, new: int) -> dict:
    """Greedy decoding through the plain serve steps: one prefill of
    ``batch`` (the (B, P) "tokens" with an encoder-decoder's "frames" or a
    vision model's "patches"), then ``new`` - 1 decode steps at cache_len
    n + P + i (n: the image's patch rows in front of the prompt, else 0);
    the (B, new) tokens, each step's top-2 logit margin and the margin
    rule's gate (STEP_LOGIT_TOL of max |logit|) per row, and a copy of the
    cache as the prefill left it."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step

    b, p = batch["tokens"].shape
    start = p + (model.cfg.num_patches if "patches" in batch else 0)
    logits, cache = make_prefill_step(model, start + new)(params, batch)
    snapshot = _clone_tree(cache)
    decode = make_decode_step(model)
    toks, margins, gates = [], [], []
    cache_len = torch.full((b,), start, dtype=torch.int32, device=logits.device)
    for i in range(new):
        lg = logits[:, -1].float()
        top2 = torch.topk(lg, 2, dim=-1).values
        margins.append(top2[:, 0] - top2[:, 1])
        gates.append(STEP_LOGIT_TOL * lg.abs().amax(-1))
        toks.append(lg.argmax(-1))
        if i < new - 1:
            logits, cache = decode(params, cache, {"tokens": toks[-1][:, None],
                                                   "cache_len": cache_len + i})
    return dict(tokens=torch.stack(toks, 1).cpu().numpy(),
                margins=torch.stack(margins, 1).cpu().numpy(),
                gates=torch.stack(gates, 1).cpu().numpy(), prefill_cache=snapshot)


def _clone_tree(tree):
    return {k: _clone_tree(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def frontend_drive(torch, np, model, params, run: dict, key: str, draw, config,
                   domains) -> dict:
    """The main run of a path whose rows carry frontend inputs (``key``:
    whisper's "frames" or llava's "patches", drawn by ``draw(np, cfg, B,
    seed)``) on ``params``' device, through the entry points a user calls:
    ``collect_grams`` over batch dicts, ``build_plan`` + ``compress_params``
    under ``config``, ``evaluate_ppl`` dense and compressed on each of
    ``domains``, ``mean_logit_kl`` on the first, and greedy decoding of the
    compressed model (``plain_greedy``).  Inputs are drawn before the clock
    starts: calibration batch i's from seed i, eval batch i's (every
    domain's) from 100 + i, the prompts' from 200."""
    from repro_torch.calib.runner import calibration_batches, collect_grams
    from repro_torch.core import build_plan, compress_params
    from repro_torch.eval.attribution import mean_logit_kl
    from repro_torch.eval.perplexity import eval_batches, evaluate_ppl

    cfg = model.cfg
    device = params["embed"]["table"].device
    calib = [{"tokens": t, key: draw(np, cfg, run["calib_batch"], i)}
             for i, t in enumerate(calibration_batches(
                 cfg.vocab_size, "en_a", run["calib_batches"] * run["calib_batch"],
                 run["calib_batch"], run["seq"]))]
    eval_inputs = [draw(np, cfg, run["eval_batch"], 100 + i)
                   for i in range(run["eval_batches"])]

    def evals(domain):
        return [{"tokens": t, key: f} for t, f in zip(eval_batches(
            cfg.vocab_size, domain, run["eval_batches"], run["eval_batch"], run["seq"]),
            eval_inputs)]
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(2, cfg.vocab_size // 2, size=(run["rows"], run["prompt"])),
             key: draw(np, cfg, run["rows"], 200)}
    seconds = {}

    def phase(name, t0):
        if device.type == "cuda":
            torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
    t0 = time.perf_counter()
    grams = collect_grams(model, params, calib)
    phase("calibrate", t0)
    t0 = time.perf_counter()
    plan = build_plan(model.compressible_targets(), config)
    cparams = compress_params(params, plan, grams)
    phase("compress", t0)
    del grams
    t0 = time.perf_counter()
    ppl = {d: {"dense": evaluate_ppl(model, params, evals(d)),
               "compressed": evaluate_ppl(model, cparams, evals(d))}
           for d in domains}
    kl = mean_logit_kl(model, params, cparams, evals(domains[0]))
    phase("evaluate", t0)
    t0 = time.perf_counter()
    greedy = plain_greedy(torch, model, cparams, batch, run["new"])
    phase("decode", t0)
    return dict(seconds=seconds, plan=plan, cparams=cparams, ppl=ppl, kl=kl,
                greedy=greedy, batch=batch, eval_batch=evals(domains[0])[0])


def whisper_drive(torch, np, model, params, run: dict) -> dict:
    """The whisper path's main run: ``frontend_drive`` with frames, nsvd1
    at 0.2, k1_frac 0.9."""
    from repro_torch.core import CompressionConfig

    return frontend_drive(torch, np, model, params, run, "frames", whisper_frames,
                          CompressionConfig(method="nsvd1", ratio=0.2, k1_frac=0.9,
                                            dtype=model.cfg.dtype, use_randomized=False),
                          WHISPER_DOMAINS)


def whisper_path(torch, np, cfg):
    """The whisper path (see WHISPER_RUN): the main run with its launches
    held to WHISPER_PREDICTED; then on the same inputs the compressed model
    through the plain versions (``kernels.plain()``): the greedy streams by
    the margin rule, the prefill's self and cross K/V slabs, a decode
    step's and an eval batch's logits within STEP_LOGIT_TOL /
    EVAL_LOGIT_TOL of max |logit|; a profiled decode step (wall against
    device, the nested share) and a profiled steady calibration batch (the
    plain bidirectional attention's share of its device time)."""
    from repro_torch import kernels
    from repro_torch.calib.gram import accumulate_taps
    from repro_torch.calib.runner import collect_grams
    from repro_torch.eval.attribution import get_subtree
    from repro_torch.launch.steps import make_decode_step
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import build_model

    model = build_model(cfg)
    params = model.init(0, "cuda")
    run = WHISPER_RUN
    torch.cuda.synchronize()
    reset_counts()
    res = whisper_drive(torch, np, model, params, run)
    torch.cuda.synchronize()
    counts = read_counts()
    split, split_ok = flash_split_ok(counts)
    gsplit, gshapes, nsplit = gram_split(), gram_shape_split(), nested_split()
    shapes = shape_split()
    got = dict(gram=counts["gram"], flash=counts["flash_attention"],
               stream=nsplit["stream"], mma=nsplit["mma"],
               gate=_ops("nested_lowrank").gate_calls)
    expect = whisper_expect(cfg, run)
    counts_ok = (got == expect == WHISPER_PREDICTED and split_ok and nsplit["tile"] == 0
                 and gsplit == {"mma": counts["gram"], "tf32x3": 0, "fma": 0}
                 and counts["paged_attention"] == counts["rwkv6"] == 0
                 and counts["nested_lowrank"] == nsplit["stream"] + nsplit["mma"])
    plan, cparams = res["plan"], res["cparams"]
    n_slices = sum(math.prod(t.stacked) for t in plan.targets)
    nested_leaves = all("u2" in get_subtree(cparams, t.path) for t in plan.targets)
    ratio = factored_ratio(cparams, plan)
    numbers = [v for d in res["ppl"].values() for v in d.values()] + [res["kl"], ratio]
    finite = all(math.isfinite(float(x)) for x in numbers)
    quality_ok = finite and n_slices == 192 and nested_leaves and res["kl"] >= 0
    log(f"whisper path: {cfg.name} {cfg.encoder_layers} + {cfg.num_layers} layers, "
        f"{cfg.d_model} wide, {cfg.encoder_seq} frames (no cut); phase seconds "
        + ", ".join(f"{k}={v:.2f}" for k, v in res["seconds"].items()))
    log(f"  launches {got} expected {expect} (predicted {WHISPER_PREDICTED}); flash by "
        f"kernel {split}; gram by kernel {gsplit}, by width {gshapes}; nested by kernel "
        f"{nsplit}, by shape {shapes} {'OK' if counts_ok else 'FAIL'}")
    for d, v in res["ppl"].items():
        log(f"  ppl[{d}]: dense {v['dense']:.3f} compressed {v['compressed']:.3f}")
    log(f"  logit KL {res['kl']:.5f} nats/token; {n_slices} target slices, all nested: "
        f"{nested_leaves}; achieved ratio {plan.achieved_ratio:.5f} (factors {ratio:.5f}) "
        f"{'OK' if quality_ok else 'FAIL'}")

    # The same inputs through the plain versions.
    g_k = res["greedy"]
    with kernels.plain():
        g_p = plain_greedy(torch, model, cparams, res["batch"], run["new"])
    rows = [margin_row(list(a), list(b), (m, gt)) for a, b, m, gt in zip(
        g_k["tokens"], g_p["tokens"], g_p["margins"], g_p["gates"])]
    streams_ok = all(r["ok"] for r in rows)
    kv = {}
    for part in ("attn", "cross"):
        for leaf in ("k", "v"):
            a = g_k["prefill_cache"]["decoder"]["sub0"][part][leaf].float()
            b = g_p["prefill_cache"]["decoder"]["sub0"][part][leaf].float()
            kv[f"{part}.{leaf}"] = (float((a - b).abs().max()), float(b.abs().max()))
    kv_ok = all(e <= STEP_LOGIT_TOL * s for e, s in kv.values())
    # One decode step from the plain run's prefill cache, both ways.
    decode = make_decode_step(model)
    batch = {"tokens": torch.as_tensor(g_p["tokens"][:, :1], device="cuda"),
             "cache_len": torch.full((run["rows"],), run["prompt"], dtype=torch.int32,
                                     device="cuda")}
    lk, _ = decode(cparams, _clone_tree(g_p["prefill_cache"]), batch)
    with kernels.plain():
        lp, _ = decode(cparams, _clone_tree(g_p["prefill_cache"]), batch)
    step_err, step_scale = float((lk.float() - lp.float()).abs().max()), float(
        lp.float().abs().max())
    step_ok = (lk.shape == (run["rows"], 1, cfg.vocab_size)
               and bool(torch.isfinite(lk).all()) and step_err <= STEP_LOGIT_TOL * step_scale)
    eb = res["eval_batch"]
    etoks = torch.as_tensor(eb["tokens"], device="cuda")
    eframes = torch.as_tensor(eb["frames"], device="cuda")
    with torch.no_grad():
        le = model.apply(cparams, etoks, frames=eframes).float()
        with kernels.plain():
            lpe = model.apply(cparams, etoks, frames=eframes).float()
    e_err, e_scale = float((le - lpe).abs().max()), float(lpe.abs().max())
    e_ok = (le.shape == (*etoks.shape, cfg.vocab_size) and bool(torch.isfinite(le).all())
            and e_err <= EVAL_LOGIT_TOL * e_scale)
    del le, lpe
    log(f"  greedy streams (8 x {run['new']}) kernels vs plain: "
        f"{sum(r['equal'] for r in rows)} of {len(rows)} equal, first differences "
        f"{[(r['first_diff'], round(r['margin'], 4), round(r['gate'], 4)) for r in rows if not r['equal']]} "
        f"{'OK' if streams_ok else 'FAIL'}")
    log("  prefill K/V (layer stack) kernels vs plain, max abs err / max abs: "
        + ", ".join(f"{k} {e:.3e} / {s:.3f}" for k, (e, s) in kv.items())
        + f" {'OK' if kv_ok else 'FAIL'}")
    log(f"  decode-step logits kernels vs plain: max abs err {step_err:.4e} (max |logit| "
        f"{step_scale:.3f}, tol {STEP_LOGIT_TOL * step_scale:.4e}) "
        f"{'OK' if step_ok else 'FAIL'}; compressed eval-batch logits ({etoks.shape[0]} x "
        f"{etoks.shape[1]}): {e_err:.4e} (max |logit| {e_scale:.3f}, tol "
        f"{EVAL_LOGIT_TOL * e_scale:.4e}) {'OK' if e_ok else 'FAIL'}")

    # Where the time goes: a decode step (its cache as the prefill left
    # it; every call rewrites the same position) and a steady calibration
    # batch (the store already seeded), with the plain attention's ranges.
    cache = _clone_tree(g_p["prefill_cache"])
    prof_step = profile_step(torch, lambda: decode(cparams, cache, batch),
                             "whisper decode step (8 rows)")
    del cache
    calib = {"tokens": torch.as_tensor(eb["tokens"], device="cuda"), "frames": eframes}
    store = collect_grams(model, params, [calib])

    @torch.no_grad()
    def calib_batch():
        taps = {}
        model.apply(params, calib["tokens"], frames=calib["frames"], mode="train", taps=taps)
        accumulate_taps(store, taps)
    prof_calib = profile_step(torch, calib_batch, "steady calibration batch (16 x 128, "
                              f"{cfg.encoder_seq} frames)",
                              ranges=(attn_mod, ("_bidir_attention", "_cross_attention")))
    del store
    busy = max(prof_calib["device_busy_ms"], 1e-9)
    bidir_share = prof_calib["ranges_ms"]["_bidir_attention"] / busy
    cross_share = prof_calib["ranges_ms"]["_cross_attention"] / busy
    log(f"  calibration batch: bidirectional attention {prof_calib['ranges_ms']['_bidir_attention']:.3f} "
        f"ms ({bidir_share:.1%} of device busy), cross attention "
        f"{prof_calib['ranges_ms']['_cross_attention']:.3f} ms ({cross_share:.1%}); decode "
        f"step nested {prof_step['nested_ms'] / max(prof_step['device_busy_ms'], 1e-9):.1%} "
        "of device busy")
    ok = counts_ok and quality_ok and streams_ok and kv_ok and step_ok and e_ok
    summary = dict(config=cfg.name, encoder_layers=cfg.encoder_layers,
                   layers=cfg.num_layers, run=run, seconds=res["seconds"],
                   launches=counts, got=got, expected=expect, predicted=WHISPER_PREDICTED,
                   flash_launches=split, gram_launches=gsplit, gram_shape_launches=gshapes,
                   nested_launches=nsplit, nested_shape_launches=shapes,
                   ppl=res["ppl"], logit_kl=res["kl"], target_slices=n_slices,
                   achieved_ratio=plan.achieved_ratio, factored_ratio=ratio,
                   streams=rows, prefill_kv=kv, step_logit_max_abs_err=step_err,
                   step_logit_max_abs=step_scale, eval_logit_max_abs_err=e_err,
                   eval_logit_max_abs=e_scale, step_profile=prof_step,
                   calib_profile=prof_calib, bidir_share=bidir_share,
                   cross_share=cross_share, ok=bool(ok))
    return summary, counts


# The llava path (PR 32): llava-next-mistral-7b at full width, cut to 4 of
# 32 layers for memory (its fp64 Grams take 2.05 GB a layer, 65.5 GB at 32
# layers beside 14.5 GB of bf16 weights; 4 layers leave the compression's
# fp64 work room: ``launch.serve.run_bytes`` reckons 26.1 GB), the
# projector uncut, through the entry points a user calls: calibrate (the
# paper's 256 x 128 tokens of en_a in 16 batches of 16, each row behind
# one image's 576 patch features), compress (nsvd1 at 0.2, k1_frac 0.95,
# every layer target and the projector's wi and wo), evaluate (perplexity
# on en_a and jp, dense and compressed, and the logit KL on en_a, 2 (16,
# 128) batches each, every row behind an image), decode (greedy, 8 rows of
# an image and a 16-token prompt, 32 new tokens: one ``make_prefill_step``
# call, then 31 ``make_decode_step`` steps at cache_len 576 + 16 + i;
# then one image's prefill alone, 576 + 16 rows) and serve (*Serve*'s
# plan, text-only through the paged engine: the compressed params through
# ``serve(params=...)``, as the reference's engine admits no patches).
# Patches stand in for the stubbed vision tower: standard normal (B, 576,
# 1024) fp32 from a numpy seed a batch, as whisper's frames do.
LLAVA_LAYERS = 4
LLAVA_RUN = dict(calib_batches=16, calib_batch=16, seq=128, eval_batches=2,
                 eval_batch=16, rows=8, prompt=16, new=32,
                 engine=dict(requests=8, lo=16, hi=200, max_new=32, max_batch=8,
                             max_len=256, block=16, chunk=64))
LLAVA_DOMAINS = ("en_a", "jp")
# Exact counts of the llava path's main run, entered before its first chip
# call (``llava_expect`` derives them from LLAVA_RUN's shapes and the
# engine's schedule, 33 decode steps and 3 chunk calls as *Serve*'s plan
# gives on every paged path; tests/test_torch_llava.py holds that
# derivation to a CPU run of a reduced twin).  gram: 19 taps x 16 batches
# (4 a layer, the final norm's over all 704 rows of a row, the projector's
# two over its 576), of which the 16 ``projector.in`` taps (the raw fp32
# patches, 9216 x 1024 a batch) on the tf32x3 kernel, each over 11 row
# splits (so 16 reduce launches), and the rest, bf16, on the mma kernel.
# flash: 4 layers x 30 causal forwards (16 calibration, 2 domains x 2
# batches x dense and compressed, 2 x 2 KL, the greedy prefill and the
# one-image prefill), at (16, 704), (8, 592) and (1, 592), all
# tensor-core.  nested: 7 compressed linears a layer and the projector's 2:
# stream 28 x (31 greedy steps + 33 engine steps); mma 30 at the one-image
# prefill (592 and 576 rows) and 28 x 3 engine chunk calls (512 rows); and
# apart, the wrapper's calls above its 1024-row gate, plain matmuls: 30 a
# compressed (16, 704) forward x 6 and at the greedy prefill (8 x 592 and
# 8 x 576 rows).  paged: 4 layers x 33 engine steps, each with its combine.
LLAVA_PREDICTED = dict(gram=304, tf32x3=16, flash=120, stream=1792, mma=114, gate=210,
                       paged=132, steps=33, chunks=3)


def llava_compression(cfg):
    """The llava path's compression: nsvd1 at 0.2, k1_frac 0.95, factors in
    the model's dtype."""
    from repro_torch.core import CompressionConfig

    return CompressionConfig(method="nsvd1", ratio=0.2, k1_frac=0.95, dtype=cfg.dtype,
                             use_randomized=False)


def llava_nested_linears(cfg) -> tuple:
    """(the layers', the projector's) linears a forward calls through the
    nested wrapper under ``llava_compression``: the targets whose rank
    split keeps a second pair (u2, v2), one call a layer of a stacked
    target (at full width all of them: 7 a layer and the projector's 2)."""
    from repro_torch.core import build_plan
    from repro_torch.core.nsvd import split_rank
    from repro_torch.models import build_model

    config = llava_compression(cfg)
    plan = build_plan(build_model(cfg).compressible_targets(), config)
    text = proj = 0
    for t in plan.targets:
        if split_rank(plan.rank_of(t), config.k1_frac)[1] == 0:
            continue  # one pair: two plain matmuls
        if t.path[0] == "projector":
            proj += 1
        else:
            text += math.prod(t.stacked)
    return text, proj


def llava_expect(cfg, run, steps: int, chunks: int, gate_rows: int = 1024,
                 stream_rows: int = 16) -> dict:
    """The llava path's counts from its shapes and the engine's schedule
    (``steps`` decode steps, ``chunks`` prefill-chunk calls): gram calls a
    calibration batch (4 taps a (gqa, mlp) layer, the final norm's,
    ``projector.mid``, and ``projector.in``, the one fp32 tap: "tf32x3"),
    flash calls (one a layer a causal forward), paged calls (one a layer an
    engine step), and the nested linears' calls (``llava_nested_linears``)
    by the route their rows take in the nested wrapper (bf16: "stream" up
    to ``stream_rows``, "mma" up to ``gate_rows``, "gate" above: plain)."""
    layers, p = cfg.num_layers, cfg.num_patches
    n_text, n_proj = llava_nested_linears(cfg)
    nested = Counter()

    def route(rows):
        return "stream" if rows <= stream_rows else "mma" if rows <= gate_rows else "gate"

    def forward(b, s):  # one compressed forward, an image in front of each row
        nested[route(b * (p + s))] += n_text
        nested[route(b * p)] += n_proj

    evals = len(LLAVA_DOMAINS) * run["eval_batches"]
    for _ in range(evals + run["eval_batches"]):  # compressed ppl, then the KL's
        forward(run["eval_batch"], run["seq"])
    forward(run["rows"], run["prompt"])
    forward(1, run["prompt"])
    nested[route(run["rows"])] += n_text * (run["new"] - 1)
    eng = run["engine"]
    nested[route(eng["max_batch"])] += n_text * steps
    nested[route(eng["max_batch"] * eng["chunk"])] += n_text * chunks
    causal = run["calib_batches"] + 2 * evals + 2 * run["eval_batches"] + 2
    return dict(gram=(4 * layers + 3) * run["calib_batches"], tf32x3=run["calib_batches"],
                flash=layers * causal, stream=nested["stream"], mma=nested["mma"],
                gate=nested["gate"], paged=layers * steps, steps=steps, chunks=chunks)


def llava_patches(np, cfg, b: int, seed: int):
    """Stand-in patch features for the stubbed vision tower (B,
    num_patches, VISION_FEATURE_DIM), fp32."""
    from repro_torch.models.transformer import VISION_FEATURE_DIM

    return np.random.default_rng(seed).standard_normal(
        (b, cfg.num_patches, VISION_FEATURE_DIM), np.float32)


def llava_drive(torch, np, model, params, run: dict) -> dict:
    """The llava path's main run: ``frontend_drive`` with patches under
    ``llava_compression``, then one image's prefill through
    ``make_prefill_step`` and ``serve(params=...)`` of the compressed model
    on run["engine"]'s plan (text-only, worst case, depth 1; its prompts
    drawn as the serve path draws them)."""
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import make_prefill_step

    cfg = model.cfg
    res = frontend_drive(torch, np, model, params, run, "patches", llava_patches,
                         llava_compression(cfg), LLAVA_DOMAINS)
    eng = run["engine"]
    erng = np.random.default_rng(0)
    plens = erng.integers(eng["lo"], eng["hi"] + 1, size=eng["requests"])
    eprompts = [erng.integers(2, cfg.vocab_size // 2, size=int(n)) for n in plens]
    one = {k: v[:1] for k, v in res["batch"].items()}
    t0 = time.perf_counter()
    single, _ = make_prefill_step(model, cfg.num_patches + run["prompt"])(res["cparams"], one)
    if single.device.type == "cuda":
        torch.cuda.synchronize()
    res["seconds"]["prefill_one"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    served = serve(cfg, params=res["cparams"], requests=eng["requests"], prompts=eprompts,
                   max_new=eng["max_new"], max_batch=eng["max_batch"],
                   max_len=eng["max_len"], block_size=eng["block"],
                   prefill_chunk=eng["chunk"], sched_policy="worst_case",
                   pipeline_depth=1, device=params["embed"]["table"].device)
    res["seconds"]["serve"] = time.perf_counter() - t0
    return dict(res, single=single, one=one, served=served)


def llava_path(torch, np, cfg):
    """The llava path (see LLAVA_RUN): the main run with its launches held
    to LLAVA_PREDICTED; then on the same inputs the compressed model
    through the plain versions (``kernels.plain()``): the greedy streams by
    the margin rule, a decode step's logits (from the plain run's prefill
    cache), the one-image prefill's and an eval batch's logits within
    STEP_LOGIT_TOL / EVAL_LOGIT_TOL of max |logit|; every served request
    finished with its tokens in the vocabulary; a profiled decode step
    (wall against device, the nested share) and a profiled steady
    calibration batch (the gram kernels' share, the tf32x3 kernel's time on
    ``projector.in``)."""
    from repro_torch import kernels
    from repro_torch.calib.gram import accumulate_taps
    from repro_torch.calib.runner import collect_grams
    from repro_torch.eval.attribution import get_subtree
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import build_model

    model = build_model(cfg)
    params = model.init(0, "cuda")
    run = LLAVA_RUN
    torch.cuda.synchronize()
    reset_counts()
    res = llava_drive(torch, np, model, params, run)
    torch.cuda.synchronize()
    counts = read_counts()
    split, split_ok = flash_split_ok(counts)
    gsplit, gshapes, nsplit = gram_split(), gram_shape_split(), nested_split()
    shapes = shape_split()
    eng = res["served"]["engine"]
    st = eng.stats()
    pa = _ops("paged_attention")
    got = dict(gram=counts["gram"], tf32x3=gsplit["tf32x3"], flash=counts["flash_attention"],
               stream=nsplit["stream"], mma=nsplit["mma"],
               gate=_ops("nested_lowrank").gate_calls, paged=counts["paged_attention"],
               steps=st["steps"], chunks=st["prefill_ticks"])
    expect = llava_expect(cfg, run, st["steps"], st["prefill_ticks"])
    n_splits = pa.plan_splits(eng.max_batch, cfg.num_kv_heads, eng.kv.max_blocks_per_row)[0]
    combine_expect = counts["paged_attention"] if n_splits > 1 else 0
    counts_ok = (got == expect == LLAVA_PREDICTED and split_ok and nsplit["tile"] == 0
                 and gsplit == {"mma": counts["gram"] - run["calib_batches"],
                                "tf32x3": run["calib_batches"], "fma": 0}
                 and _ops("gram").reduce_launches == run["calib_batches"]
                 and gshapes.get(str(1024)) == run["calib_batches"]
                 and pa.combine_launches == combine_expect and counts["rwkv6"] == 0
                 and counts["nested_lowrank"] == nsplit["stream"] + nsplit["mma"])
    plan, cparams = res["plan"], res["cparams"]
    n_slices = sum(math.prod(t.stacked) for t in plan.targets)
    nested_leaves = all("u2" in get_subtree(cparams, t.path) for t in plan.targets)
    ratio = factored_ratio(cparams, plan)
    numbers = [v for d in res["ppl"].values() for v in d.values()] + [res["kl"], ratio]
    finite = all(math.isfinite(float(x)) for x in numbers)
    quality_ok = (finite and n_slices == 7 * cfg.num_layers + 2 and nested_leaves
                  and res["kl"] >= 0)
    outs = res["served"]["outputs"]
    reasons = {u: r.finish_reason for u, r in res["served"]["requests"].items()}
    serve_ok = (eng.layout == "paged" and len(outs) == run["engine"]["requests"]
                and all(reasons.get(u) for u in outs)
                and all(1 <= len(v) <= run["engine"]["max_new"] for v in outs.values())
                and all(0 <= t < cfg.vocab_size for v in outs.values() for t in v))
    log(f"llava path: {cfg.name} {cfg.num_layers} of 32 layers (memory cut), "
        f"{cfg.d_model} wide, {cfg.num_patches} patches a row (projector uncut); "
        "phase seconds " + ", ".join(f"{k}={v:.2f}" for k, v in res["seconds"].items()))
    log(f"  launches {got} expected {expect} (predicted {LLAVA_PREDICTED}); flash by "
        f"kernel {split}; gram by kernel {gsplit}, by width {gshapes}; nested by kernel "
        f"{nsplit}, by shape {shapes}; paged combine {pa.combine_launches} expected "
        f"{combine_expect} ({n_splits} splits) {'OK' if counts_ok else 'FAIL'}")
    for d, v in res["ppl"].items():
        log(f"  ppl[{d}]: dense {v['dense']:.3f} compressed {v['compressed']:.3f}")
    log(f"  logit KL {res['kl']:.5f} nats/token; {n_slices} target slices, all nested: "
        f"{nested_leaves}; achieved ratio {plan.achieved_ratio:.5f} (factors {ratio:.5f}) "
        f"{'OK' if quality_ok else 'FAIL'}")
    log(f"  served text-only: {res['served']['tokens']} tokens, {st['steps']} steps, "
        f"{st['prefill_ticks']} chunk calls, {res['served']['tok_per_s']:.1f} tok/s, step "
        f"p50 {st['step_p50_s'] * 1e3:.2f} ms; finish reasons "
        f"{sorted(set(reasons.values()))} {'OK' if serve_ok else 'FAIL'}")

    # The same inputs through the plain versions.
    g_k = res["greedy"]
    with kernels.plain():
        g_p = plain_greedy(torch, model, cparams, res["batch"], run["new"])
    rows = [margin_row(list(a), list(b), (m, gt)) for a, b, m, gt in zip(
        g_k["tokens"], g_p["tokens"], g_p["margins"], g_p["gates"])]
    streams_ok = all(r["ok"] for r in rows)
    # One decode step from the plain run's prefill cache, both ways (its
    # positions at cache_len 576 + 16).
    decode = make_decode_step(model)
    batch = {"tokens": torch.as_tensor(g_p["tokens"][:, :1], device="cuda"),
             "cache_len": torch.full((run["rows"],), cfg.num_patches + run["prompt"],
                                     dtype=torch.int32, device="cuda")}
    lk, _ = decode(cparams, _clone_tree(g_p["prefill_cache"]), batch)
    with kernels.plain():
        lp, _ = decode(cparams, _clone_tree(g_p["prefill_cache"]), batch)
    step_err, step_scale = float((lk.float() - lp.float()).abs().max()), float(
        lp.float().abs().max())
    step_ok = (lk.shape == (run["rows"], 1, cfg.vocab_size)
               and bool(torch.isfinite(lk).all()) and step_err <= STEP_LOGIT_TOL * step_scale)
    # The one-image prefill (the projector's linears at 576 rows and the
    # layers' at 592, on the mma kernel) both ways.
    with kernels.plain():
        sp, _ = make_prefill_step(model, cfg.num_patches + run["prompt"])(cparams, res["one"])
    sk = res["single"].float()
    s_err, s_scale = float((sk - sp.float()).abs().max()), float(sp.float().abs().max())
    single_ok = (sk.shape == (1, 1, cfg.vocab_size) and bool(torch.isfinite(sk).all())
                 and s_err <= STEP_LOGIT_TOL * s_scale)
    eb = res["eval_batch"]
    etoks = torch.as_tensor(eb["tokens"], device="cuda")
    epatches = torch.as_tensor(eb["patches"], device="cuda")
    with torch.no_grad():
        le = model.apply(cparams, etoks, patches=epatches).float()
        with kernels.plain():
            lpe = model.apply(cparams, etoks, patches=epatches).float()
    e_err, e_scale = float((le - lpe).abs().max()), float(lpe.abs().max())
    e_ok = (le.shape == (*etoks.shape, cfg.vocab_size) and bool(torch.isfinite(le).all())
            and e_err <= EVAL_LOGIT_TOL * e_scale)
    del le, lpe
    log(f"  greedy streams ({run['rows']} x {run['new']}, behind an image) kernels vs plain: "
        f"{sum(r['equal'] for r in rows)} of {len(rows)} equal, first differences "
        f"{[(r['first_diff'], round(r['margin'], 4), round(r['gate'], 4)) for r in rows if not r['equal']]} "
        f"{'OK' if streams_ok else 'FAIL'}")
    log(f"  decode-step logits kernels vs plain: max abs err {step_err:.4e} (max |logit| "
        f"{step_scale:.3f}, tol {STEP_LOGIT_TOL * step_scale:.4e}) "
        f"{'OK' if step_ok else 'FAIL'}; one-image prefill ({cfg.num_patches} + "
        f"{run['prompt']} rows): {s_err:.4e} (max |logit| {s_scale:.3f}, tol "
        f"{STEP_LOGIT_TOL * s_scale:.4e}) {'OK' if single_ok else 'FAIL'}; compressed "
        f"eval-batch logits ({etoks.shape[0]} x {etoks.shape[1]} behind images): "
        f"{e_err:.4e} (max |logit| {e_scale:.3f}, tol {EVAL_LOGIT_TOL * e_scale:.4e}) "
        f"{'OK' if e_ok else 'FAIL'}")

    # Where the time goes: a decode step (its cache as the prefill left it;
    # every call rewrites the same position) and a steady calibration batch
    # (the store already seeded).
    cache = _clone_tree(g_p["prefill_cache"])
    prof_step = profile_step(torch, lambda: decode(cparams, cache, batch),
                             "llava decode step (8 rows)")
    del cache
    calib = {"tokens": etoks, "patches": epatches}
    store = collect_grams(model, params, [calib])

    @torch.no_grad()
    def calib_batch():
        taps = {}
        model.apply(params, calib["tokens"], patches=calib["patches"], mode="train",
                    taps=taps)
        accumulate_taps(store, taps)
    prof_calib = profile_step(torch, calib_batch, "steady calibration batch (16 x (576 "
                              "+ 128))")
    del store
    busy = max(prof_calib["device_busy_ms"], 1e-9)
    x3_ms = sum(ms for k, ms in prof_calib["kernels"].items() if "gram_tf32x3" in k)
    log(f"  calibration batch: gram {prof_calib['gram_ms']:.3f} ms ({prof_calib['gram_ms'] / busy:.1%} "
        f"of device busy), of which the tf32x3 kernel and its reduce (projector.in, 9216 x "
        f"1024 fp32) {x3_ms:.3f} ms ({x3_ms / busy:.1%}); decode step nested "
        f"{prof_step['nested_ms'] / max(prof_step['device_busy_ms'], 1e-9):.1%} of device busy")
    ok = (counts_ok and quality_ok and serve_ok and streams_ok and step_ok and single_ok
          and e_ok)
    summary = dict(config=cfg.name, layers=cfg.num_layers, run=run, seconds=res["seconds"],
                   launches=counts, got=got, expected=expect, predicted=LLAVA_PREDICTED,
                   flash_launches=split, gram_launches=gsplit, gram_shape_launches=gshapes,
                   nested_launches=nsplit, nested_shape_launches=shapes,
                   paged_splits=n_splits, paged_combine_launches=pa.combine_launches,
                   ppl=res["ppl"], logit_kl=res["kl"], target_slices=n_slices,
                   achieved_ratio=plan.achieved_ratio, factored_ratio=ratio,
                   engine=st, tok_per_s=res["served"]["tok_per_s"], finish_reasons=reasons,
                   streams=rows, step_logit_max_abs_err=step_err,
                   step_logit_max_abs=step_scale, single_logit_max_abs_err=s_err,
                   single_logit_max_abs=s_scale, eval_logit_max_abs_err=e_err,
                   eval_logit_max_abs=e_scale, step_profile=prof_step,
                   calib_profile=prof_calib, tf32x3_ms=x3_ms, ok=bool(ok))
    return summary, counts



def ptxas_report(build_log: dict) -> list:
    """ptxas's register and spill lines of every kernel, each after the end
    of its mangled name (the template arguments: the paged kernel's KV
    type, G and DPL, ...; the anonymous namespace's prefix cut)."""
    out = []
    for name, text in build_log.items():
        fn = ""
        for line in text.splitlines():
            if "Function properties for " in line:
                fn = line.split("Function properties for ", 1)[1].strip()
            elif "registers" in line or "spill" in line:
                out.append(f"  ptxas[{name}] ...{fn[-56:]}: {line.strip()}")
    return out


# The train path.  Mistral-7B at full width cut to 2 of 32 layers (as the
# serve path: 0.70 B params), bf16 params with fp32 AdamW state (about 11.2
# GB of params, grads and state before activations), batch 4 x 2048 from
# the data pipeline, the loss chunked by 512 positions: step 1's loss and
# grads against the same step under ``kernels.plain()``, then one step, a
# checkpoint (async, to a temporary directory) and TRAIN_RESUME_STEPS more
# steps, against the same steps from the restored checkpoint.  Then
# small-llama (fp32) by the reference's recipe (``train_small_lm``) and
# ``build_entry`` on its params.
TRAIN_LAYERS = 2
TRAIN_BATCH, TRAIN_SEQ, TRAIN_CHUNK = 4, 2048, 512
TRAIN_RESUME_STEPS = 2
# Step 1 with the kernels against plain, bf16 model: the forward's flash
# kernel rounds P to bf16 at other points than the plain softmax (logits
# within ~1.2% of max |logit|, EVAL_LOGIT_TOL), and every grad leaf is bf16.
# Per leaf ||g - g_plain|| / ||g_plain|| within 5e-2; the loss within 1e-2.
TRAIN_GRAD_REL_TOL = 5e-2
TRAIN_LOSS_REL_TOL = 1e-2
# small-llama's loss must fall by this many nats from step 1 (ln 512 = 6.24
# at a uniform prediction) to step 300; the reference's JAX-trained model
# evaluates at ln 131.6 = 4.88 on en_a.
SMALL_LOSS_DROP = 1.0
SMALL_QUALITY = dict(method="nsvd1", ratio=0.2, k1_frac=0.9, eval_n_batches=4,
                     calib_samples=128, eval_batch=16, eval_seq=128)
# Launches of the two training runs: flash forward and backward once per
# attention layer and step (Mistral: step 1's kernel grads, then 1 + 2
# steps uninterrupted and 2 resumed; none in the plain comparison;
# small-llama: 4 layers x 300 steps), no nested, paged, rwkv6 or gram.  The
# backward's kernels by ``bwd_plan``: Mistral's bf16 at hd 128 all on the
# tensor cores, small-llama's fp32 all on CUDA cores.
_MISTRAL_STEPS = 2 * (1 + 1 + 2 * TRAIN_RESUME_STEPS)
# The train_rwkv path.  rwkv6-1.6b at full width cut to RWKV_TRAIN_LAYERS
# of its 24 layers (as rwkv_serve), bf16 params with fp32 AdamW state, the
# train path's batch (4 x 2048 of en_a, the loss chunked by 512): step 1's
# loss and grads against the same step under ``kernels.plain()`` (the plain
# scan and backward, whose T states of (128, 64, 64) fp32 take 4.3 GB a
# layer in turn), then 1 + 2 steps, one profiled; then the training entry
# point, ``launch.train.train_loop`` on the reduced config (2 layers, K 8),
# for RWKV_CLI_STEPS steps, its loss on its own first batch falling by
# RWKV_CLI_DROP from the init's (0.53 in a CPU run of the same steps).
# Step 1's grads are held three ways.  The bf16 model rounds the
# recurrence's fp32 output y to bf16 before its group norm, and at init that
# norm amplifies the few roundings that the forward's sum order flips (y
# within ~1e-7 of the plain scan's) into grads up to 0.16 apart by
# relative L2 (the bonus; H100 runs, and 0.022 for a 1e-7 perturbation of
# y on a CPU twin at d 512): that comparison is logged, not held.  Held to
# TRAIN_GRAD_REL_TOL: the bf16 grads against a plain run that replays the
# kernel run's y (``RecurrenceTrace``), which differs from it in the
# backward alone (measured 0.013-0.018, bf16 grads rounded on both sides),
# and an fp32 twin of RWKV_FP32_LAYERS layers, kernel against plain with
# nothing pinned (measured 1.7e-4; 1.8e-6 with y pinned).
RWKV_TRAIN_LAYERS = 4
RWKV_FP32_LAYERS = 2
RWKV_TRAIN_STEPS = 1 + 1 + 2  # step 1's kernel grads, then 1 + 2 steps
RWKV_CLI_STEPS = 40
RWKV_CLI_DROP = 0.25
# Launches of the training runs: flash forward and backward once per
# attention layer and step (Mistral: step 1's kernel grads, then 1 + 2
# steps uninterrupted and 2 resumed; none in the plain comparison;
# small-llama: 4 layers x 300 steps); rwkv6 forward and backward once per
# RWKV layer and step (full width: 4 layers x 4 steps; the entry point: 2
# reduced layers x RWKV_CLI_STEPS); no nested, paged or gram launch.  The
# flash backward's kernels by ``bwd_plan``: Mistral's bf16 at hd 128 all on
# the tensor cores, small-llama's fp32 all on CUDA cores.
_MISTRAL_STEPS = 2 * (1 + 1 + 2 * TRAIN_RESUME_STEPS)
_NO_FLASH = dict(flash_attention=0, flash_backward=0, flash_backward_tensor_core=0,
                 flash_backward_cuda_core=0)
TRAIN_PREDICTED = {
    "mistral": dict(flash_attention=_MISTRAL_STEPS, flash_backward=_MISTRAL_STEPS,
                    flash_backward_tensor_core=_MISTRAL_STEPS, flash_backward_cuda_core=0,
                    nested_lowrank=0, paged_attention=0, rwkv6=0, rwkv6_backward=0, gram=0),
    "small_llama": dict(flash_attention=4 * 300, flash_backward=4 * 300,
                        flash_backward_tensor_core=0, flash_backward_cuda_core=4 * 300,
                        nested_lowrank=0, paged_attention=0, rwkv6=0, rwkv6_backward=0,
                        gram=0),
    "rwkv": dict(rwkv6=RWKV_TRAIN_LAYERS * RWKV_TRAIN_STEPS,
                 rwkv6_backward=RWKV_TRAIN_LAYERS * RWKV_TRAIN_STEPS, **_NO_FLASH,
                 nested_lowrank=0, paged_attention=0, gram=0),
    "rwkv_cli": dict(rwkv6=2 * RWKV_CLI_STEPS, rwkv6_backward=2 * RWKV_CLI_STEPS, **_NO_FLASH,
                     nested_lowrank=0, paged_attention=0, gram=0),
}
FLASH_BWD_KERNEL_NAMES = ("flash_bwd_dsum", "flash_bwd_dkdv", "flash_bwd_dq")


def train_counts() -> dict:
    """Launch counts since ``reset_counts``, the flash and rwkv6 backwards'
    calls too (flash's by kernel)."""
    fa = _ops("flash_attention")
    return {**read_counts(), "flash_backward": fa.backward_launches,
            "flash_backward_tensor_core": fa.backward_tensor_core_launches,
            "flash_backward_cuda_core": fa.backward_cuda_core_launches,
            "rwkv6_backward": _ops("rwkv6").backward_launches}


def small_quality_expect(cfg, model, q: dict) -> dict:
    """Launches of ``build_entry`` with settings ``q`` on a dense (gqa, mlp)
    model: flash once a layer and causal forward (the quality path's count:
    calibration batches of 16, dense and compressed ppl per domain, the KL
    batches' two forwards, two per target and attribution batch, 2 x 4 of
    activation similarity), a gram call a tap (4 a layer and the final
    norm's) and calibration batch; nested none, for eval batches of 2048
    rows and more (above the kernel's 1024-row gate)."""
    from repro_torch.obs.quality_report import EVAL_DOMAINS

    batches = q["calib_samples"] // 16
    attr_n = 2  # build_entry's attribution_batches
    forwards = (batches + 2 * len(EVAL_DOMAINS) * q["eval_n_batches"]
                + 2 * q["eval_n_batches"] + 2 * len(model.compressible_targets()) * attr_n
                + 2 * 4)
    return {"nested_lowrank": 0, "paged_attention": 0, "rwkv6": 0,
            "flash_attention": cfg.num_layers * forwards,
            "gram": (4 * cfg.num_layers + 1) * batches}


# small-llama trained by the reference's recipe on the CPU, in the
# reference's checkpoint layout, and the reference's ``build_entry`` on it
# under SMALL_QUALITY's settings (jax 0.9.0 on the CPU;
# tests/test_torch_quality_trained.py holds these numbers to a live run of
# the reference and the port's CPU run to them within TRAINED_TOL).
TRAINED_CHECKPOINT = os.path.join(ROOT, "tests", "torch_data", "small-llama")
TRAINED_REFERENCE = dict(
    dense_ppl={"en_a": 132.1636374562816, "en_b": 162.18416021142133,
               "task": 80.97832205837315, "zh": 85.88657125572655, "jp": 71.80651808810266},
    compressed_ppl={"en_a": 132.39471495509582, "en_b": 162.3558583606309,
                    "task": 82.90583259638363, "zh": 93.07460445905824,
                    "jp": 86.38046691153151},
    logit_kl=0.0014470549940597266, achieved_ratio=0.20169005102040816,
    plain_rel_err_mean=0.5125425892247051, whitened_rel_err_mean=0.06281730282593152,
    outlier_absorption_mean=0.8037966278353117)
# Relative tolerances against the reference: fp32 forwards summed in
# another order (ppl), the KL of two nearly equal distributions, fp64
# decompositions of Grams that differ at fp32 rounding.
TRAINED_TOL = dict(ppl=1e-5, kl=1e-4, decomposition=1e-5)


def trained_quality(torch) -> dict:
    """``build_entry`` on the committed reference-trained small-llama
    (TRAINED_CHECKPOINT) on the card, its GramStore in host memory, with
    SMALL_QUALITY's settings and exact launches (``small_quality_expect``),
    held to the reference's entry on the same weights (TRAINED_REFERENCE)
    within TRAINED_TOL: every domain's dense and compressed ppl, the KL,
    the errors and absorption; the achieved ratio exactly."""
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.obs.quality_report import build_entry

    cfg = get_config("small-llama")
    params, _ = bridge.load_checkpoint(bridge.latest_checkpoint(TRAINED_CHECKPOINT), "cuda")
    reset_counts()
    entry = build_entry(cfg, params=params, grams_on="host", **SMALL_QUALITY)
    torch.cuda.synchronize()
    counts = read_counts()
    expect = small_quality_expect(cfg, build_model(cfg), SMALL_QUALITY)
    ref, dec = TRAINED_REFERENCE, entry["decomposition"]
    rel = {f"{k}[{d}]": abs(entry[k][d] / ref[k][d] - 1.0)
           for k in ("dense_ppl", "compressed_ppl") for d in ref[k]}
    rel["logit_kl"] = abs(entry["logit_kl"] / ref["logit_kl"] - 1.0)
    for k in ("plain_rel_err_mean", "whitened_rel_err_mean", "outlier_absorption_mean"):
        rel[k] = abs(dec[k] / ref[k] - 1.0)
    tol = {k: TRAINED_TOL["ppl" if "ppl" in k else "kl" if k == "logit_kl"
                          else "decomposition"] for k in rel}
    worst = max(rel, key=lambda k: rel[k] / tol[k])
    ok = (counts == expect and entry["achieved_ratio"] == ref["achieved_ratio"]
          and all(rel[k] <= tol[k] for k in rel))
    log(f"  small-llama trained by the reference's recipe (committed checkpoint), Grams in "
        f"host memory ({entry['meta']['grams_on']}): ppl en_a {entry['dense_ppl']['en_a']:.4f} "
        f"-> {entry['compressed_ppl']['en_a']:.4f}, jp {entry['dense_ppl']['jp']:.4f} -> "
        f"{entry['compressed_ppl']['jp']:.4f}, KL {entry['logit_kl']:.6f}, whitened err "
        f"{dec['whitened_rel_err_mean']:.5f} against plain {dec['plain_rel_err_mean']:.5f}; "
        f"against the reference's CPU entry: worst {worst} rel {rel[worst]:.2e} (tol "
        f"{tol[worst]:g}), achieved ratio {entry['achieved_ratio']!r}; launches {counts} "
        f"expected {expect} {'OK' if ok else 'FAIL'}")
    return dict(entry=entry, rel=rel, launches=counts, expected=expect, ok=bool(ok))


def small_quality(torch, params) -> tuple:
    """``build_entry`` on small-llama's trained params with its exact
    launches (the quality path's count of causal forwards; every Gram tap
    fp32 on the tf32x3 kernel; the compressed linears' 2048-row batches above
    the nested kernel's 1024-row gate, so no nested launch), beside the
    reference's entry in BENCH_quality.json (JAX-trained, on the CPU)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.obs.quality_report import EVAL_DOMAINS, build_entry

    cfg = get_config("small-llama")
    model = build_model(cfg)
    reset_counts()
    entry = build_entry(cfg, params=params, **SMALL_QUALITY)
    torch.cuda.synchronize()
    counts = read_counts()
    expect = small_quality_expect(cfg, model, SMALL_QUALITY)
    fa, gram = _ops("flash_attention"), _ops("gram")
    kinds_ok = (fa.cuda_core_launches == counts["flash_attention"]
                and gram.tf32x3_launches == counts["gram"])
    ref = None
    path = os.path.join(ROOT, "BENCH_quality.json")
    if os.path.exists(path):
        with open(path) as f:
            hist = json.load(f).get("history", [])
        ref = next((e for e in hist if e["meta"].get("model") == "small-llama"
                    and e["meta"].get("method") == "nsvd1"
                    and e["meta"].get("ratio") == 0.2), None)
    dec = entry["decomposition"]
    log(f"  small-llama build_entry (port-trained on this card, nsvd1 0.2, k1 0.9): achieved "
        f"ratio {entry['achieved_ratio']:.5f}, whitened rel err {dec['whitened_rel_err_mean']:.4f}"
        f" against plain {dec['plain_rel_err_mean']:.4f}, logit KL {entry['logit_kl']:.5f}; "
        f"phase seconds " + ", ".join(f"{k}={v:.2f}" for k, v in entry["seconds"].items()))
    for d in EVAL_DOMAINS:
        beside = ""
        if ref is not None:
            beside = (f"   reference (JAX-trained, CPU, {ref['git_sha'][:7]}): dense "
                      f"{ref['dense_ppl'][d]:.3f} compressed {ref['compressed_ppl'][d]:.3f}")
        log(f"    ppl[{d}]: dense {entry['dense_ppl'][d]:.3f} compressed "
            f"{entry['compressed_ppl'][d]:.3f} (x{entry['ppl_ratio'][d]:.4f}){beside}")
    if ref is not None:
        rdec = ref["decomposition"]
        log(f"    reference: achieved ratio {ref['achieved_ratio']:.5f}, whitened rel err "
            f"{rdec['whitened_rel_err_mean']:.4f} against plain {rdec['plain_rel_err_mean']:.4f}"
            f", logit KL {ref['logit_kl']:.5f}")
    numbers = [*entry["dense_ppl"].values(), *entry["compressed_ppl"].values(),
               entry["logit_kl"], entry["achieved_ratio"]]
    ok = (counts == expect and kinds_ok and all(math.isfinite(float(x)) for x in numbers)
          and dec["whitened_rel_err_mean"] < dec["plain_rel_err_mean"])
    log(f"    launches {counts} expected {expect}; flash all CUDA-core, gram all tf32x3: "
        f"{kinds_ok} {'OK' if ok else 'FAIL'}")
    return entry, ref, counts, expect, ok


def train_path(torch, np):
    """The train path (see TRAIN_LAYERS): Mistral-7B's train step at full
    width with its plain comparison and its resume check, then small-llama
    trained by the reference's recipe, compressed and evaluated; launches
    held to TRAIN_PREDICTED."""
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.checkpointer import flatten
    from repro_torch.configs import MISTRAL_7B
    from repro_torch.data.pipeline import LMDataPipeline, PipelineState
    from repro_torch.launch.steps import StepConfig, make_grad_fn, make_train_step
    from repro_torch.launch.train import train_small_lm
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, AdamWState, init_state, linear_warmup_cosine

    cfg = dataclasses.replace(MISTRAL_7B, num_layers=TRAIN_LAYERS)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(0, "cuda")
    n_params = sum(p.numel() for p in flatten(params).values())
    reckon = n_params * (2 + 2 + 3 * 4)  # bf16 params and grads, fp32 mu, nu, master
    pipe = LMDataPipeline(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ,
                          PipelineState(seed=0, step=0, domain="en_a"), device="cuda")
    batches = [next(pipe) for _ in range(2 + TRAIN_RESUME_STEPS)]
    step_cfg = StepConfig(chunked_loss=TRAIN_CHUNK)
    opt_cfg = AdamWConfig(lr=3e-4, schedule=linear_warmup_cosine(2, 20))
    grad_fn = make_grad_fn(model, step_cfg)
    step_fn = make_train_step(model, opt_cfg, step_cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()

    # Step 1's loss and grads: kernels, then plain versions.
    loss_k, loss_p, rel, finite = grads_against_plain(torch, grad_fn, params, batches[0])
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    grads_ok = (finite and max(rel.values()) <= TRAIN_GRAD_REL_TOL
                and loss_rel <= TRAIN_LOSS_REL_TOL)
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:3]
    log(f"train path: {cfg.name} layers={cfg.num_layers} (depth cut), {n_params / 1e9:.3f} B "
        f"params bf16, AdamW fp32, batch {TRAIN_BATCH} x {TRAIN_SEQ}, loss chunked by "
        f"{TRAIN_CHUNK}")
    log(f"  step 1 kernels vs plain: loss {loss_k:.5f} vs {loss_p:.5f} (rel "
        f"{loss_rel:.2e}, tol {TRAIN_LOSS_REL_TOL:.0e}); grads rel L2 max {max(rel.values()):.3e}"
        f" (tol {TRAIN_GRAD_REL_TOL:.0e}) over {len(rel)} leaves, worst {worst} "
        f"{'OK' if grads_ok else 'FAIL'}")

    # One step, an async checkpoint, then TRAIN_RESUME_STEPS steps; the same
    # steps again from the restored checkpoint.
    opt = init_state(params)
    p1, o1, m1 = step_fn(params, opt, batches[1])
    del params, opt
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(tmp, keep=1, async_save=True)
        t_save = time.perf_counter()
        mgr.save(1, (p1, o1), {"pipeline": {"seed": 0, "step": 2, "domain": "en_a"}})
        snap_s = time.perf_counter() - t_save
        pa, oa, losses_a = p1, o1, []
        for b in batches[2:]:
            pa, oa, ma = step_fn(pa, oa, b)
            losses_a.append(ma["loss"])
        mgr.wait()
        save_s = time.perf_counter() - t_save
        del p1, o1
        t_load = time.perf_counter()
        (pb, ob), extra, at = mgr.restore(device="cuda")
        ob = AdamWState(*ob)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t_load
        ckpt_bytes = sum(os.path.getsize(os.path.join(tmp, "step_00000001", n))
                         for n in os.listdir(os.path.join(tmp, "step_00000001")))
    losses_b = []
    for b in batches[2:]:
        pb, ob, mb = step_fn(pb, ob, b)
        losses_b.append(mb["loss"])
    torch.cuda.synchronize()
    counts = train_counts()
    peak = torch.cuda.max_memory_allocated()
    diffs = {}
    fb = flatten((pb, ob))
    for k, a in flatten((pa, oa)).items():
        if not torch.equal(a, fb[k]):
            diffs["/".join(k)] = float((a.float() - fb[k].float()).abs().max())
    resume_ok = not diffs and at == 1 and int(ob.step) == 1 + TRAIN_RESUME_STEPS
    losses = [float(x) for x in [m1["loss"], *losses_a]]
    counts_ok = counts == TRAIN_PREDICTED["mistral"]
    fa = _ops("flash_attention")
    kinds_ok = fa.tensor_core_launches == counts["flash_attention"]
    log(f"  resume: {TRAIN_RESUME_STEPS} steps after the step-1 checkpoint "
        f"({ckpt_bytes / 1e9:.2f} GB: snapshot {snap_s:.2f} s, on disk after {save_s:.2f} s, "
        f"restore {load_s:.2f} s) against the same steps uninterrupted: "
        f"{'bit-identical' if not diffs else f'{len(diffs)} leaves differ, max {max(diffs.values()):.3e}'}"
        f" {'OK' if resume_ok else 'FAIL'}; losses {[round(x, 5) for x in losses]}")
    log(f"  peak {peak / 2 ** 30:.2f} GiB allocated against the reckoning of {reckon / 2 ** 30:.2f}"
        f" GiB for params, grads and AdamW state (plus activations, the guard's old tree "
        f"and the plain comparison)")
    log(f"  launches {counts} expected {TRAIN_PREDICTED['mistral']}; flash forwards all "
        f"tensor-core: {kinds_ok}; backward all tensor-core: "
        f"{counts['flash_backward_tensor_core'] == counts['flash_backward']} "
        f"{'OK' if counts_ok and kinds_ok else 'FAIL'}")

    # Where a step's time goes (outside the counted run).
    prof = profile_step(torch, lambda: step_fn(pb, ob, batches[2]), "train step", windows=3)
    bwd_ms = sum(ms for k, ms in prof["kernels"].items()
                 if any(n in k for n in FLASH_BWD_KERNEL_NAMES))
    fwd_ms = sum(ms for k, ms in prof["kernels"].items() if "flash_mma_kernel" in k)
    tok_s = TRAIN_BATCH * TRAIN_SEQ / (prof["wall_ms"] / 1e3)
    log(f"  train step: wall {prof['wall_ms']:.2f} ms, device {prof['device_busy_ms']:.2f} ms, "
        f"{tok_s:.0f} tokens/s; flash backward kernels {bwd_ms:.2f} ms "
        f"({bwd_ms / prof['device_busy_ms']:.1%} of device), flash forward {fwd_ms:.3f} ms")
    mistral_s = time.perf_counter() - t0
    del pa, oa, pb, ob
    torch.cuda.empty_cache()

    # small-llama by the reference's recipe, then compressed and evaluated.
    t1 = time.perf_counter()
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        small, extra = train_small_lm("small-llama", device="cuda", ckpt_dir=tmp)
        torch.cuda.synchronize()
    small_s = time.perf_counter() - t1
    small_counts = train_counts()
    small_counts_ok = (small_counts == TRAIN_PREDICTED["small_llama"]
                       and fa.cuda_core_launches == small_counts["flash_attention"])
    first, last = extra["losses"]["1"], extra["final_loss"]
    drop_ok = math.isfinite(last) and first - last >= SMALL_LOSS_DROP
    log(f"  small-llama: train_small_lm ({extra['steps']} steps, batch 16 x 128, mix) {small_s:.2f} s "
        f"({small_s / extra['steps'] * 1e3:.1f} ms a step); loss {first:.4f} -> {last:.4f} "
        f"(drop {first - last:.4f}, at least {SMALL_LOSS_DROP}; ln 512 = {math.log(512):.4f}); "
        f"losses {extra['losses']} {'OK' if drop_ok else 'FAIL'}")
    log(f"    launches {small_counts} expected {TRAIN_PREDICTED['small_llama']} (flash and "
        f"its backward all CUDA-core) {'OK' if small_counts_ok else 'FAIL'}")
    entry, ref, q_counts, q_expect, q_ok = small_quality(torch, small)
    trained = trained_quality(torch)
    ok = (grads_ok and resume_ok and counts_ok and kinds_ok and small_counts_ok and drop_ok
          and q_ok and trained["ok"] and all(math.isfinite(x) for x in losses))
    summary = dict(config=cfg.name, layers=cfg.num_layers, params=n_params,
                   reckoned_state_gib=reckon / 2 ** 30, peak_gib=peak / 2 ** 30,
                   loss_kernel=loss_k, loss_plain=loss_p, loss_rel=loss_rel,
                   grad_rel=rel, losses=losses, resume_diffs=diffs, checkpoint_bytes=ckpt_bytes,
                   snapshot_s=snap_s, save_s=save_s, restore_s=load_s, launches=counts,
                   expected_launches=TRAIN_PREDICTED["mistral"], step_profile=prof,
                   flash_bwd_ms=bwd_ms, flash_fwd_ms=fwd_ms, tokens_per_s=tok_s,
                   mistral_s=mistral_s, small_s=small_s, small_losses=extra["losses"],
                   small_launches=small_counts, small_entry=entry, reference_entry=ref,
                   small_quality_launches=q_counts, small_quality_expected=q_expect,
                   trained_quality=trained, ok=bool(ok))
    return summary, counts


def grad_rel(torch, grads, want) -> dict:
    """Per leaf ||g - g_want|| / ||g_want|| of two grad trees."""
    from repro_torch.checkpoint.checkpointer import flatten

    flat = flatten(want)
    return {"/".join(k): float((g.float() - flat[k].float()).norm()
                               / flat[k].float().norm().clamp_min(1e-30))
            for k, g in flatten(grads).items()}


def grads_against_plain(torch, grad_fn, params, batch, pinned=None) -> tuple:
    """Step 1's loss and grads through the kernels, then under
    ``kernels.plain()``: (loss, plain loss, per-leaf relative L2 error of the
    grads, whether every kernel grad is finite).  ``pinned`` (a
    RecurrenceTrace) records the kernel run's recurrence outputs and adds a
    third run, plain with those outputs replayed: its per-leaf errors are
    returned in ``pinned.rel``."""
    from repro_torch import kernels
    from repro_torch.checkpoint.checkpointer import flatten

    with pinned.record() if pinned else contextlib.nullcontext():
        _, loss_k, _, grads_k = grad_fn(params, batch)
    with kernels.plain():
        _, loss_p, _, grads_p = grad_fn(params, batch)
        if pinned:
            with pinned.replay():
                pinned.rel = grad_rel(torch, grads_k, grad_fn(params, batch)[3])
    rel = grad_rel(torch, grads_k, grads_p)
    finite = all(bool(torch.isfinite(g).all()) for g in flatten(grads_k).values())
    return float(loss_k), float(loss_p), rel, finite


class RecurrenceTrace:
    """The output of every ``RWKV6`` forward of a run, in call order: inside
    ``record()`` each forward keeps its output; inside ``replay()`` each
    forward returns the next recorded output instead of computing its own
    (and launches nothing), its backward unchanged.  A plain run replaying
    the kernel run's outputs differs from it in the backward alone: the
    bf16 model rounds the recurrence's fp32 output to bf16, and the
    forward's sum order flips a few of those roundings, which its group
    norm at init amplifies far past any kernel error (see train_rwkv_path)."""

    def __init__(self, ops):
        self.ops, self.ys, self.rel = ops, [], None

    @contextlib.contextmanager
    def _use(self, fn):
        base = self.ops.RWKV6
        self.ops.RWKV6 = type("RWKV6", (base,), {"forward": staticmethod(fn(base))})
        try:
            yield self
        finally:
            self.ops.RWKV6 = base

    def record(self):
        self.ys = []

        def fn(base):
            def forward(ctx, *args):
                y = base.forward(ctx, *args)
                self.ys.append(y.detach())
                return y
            return forward
        return self._use(fn)

    def replay(self):
        ys = iter(self.ys)

        def fn(base):
            def forward(ctx, *args):
                ctx.save_for_backward(*args)
                return next(ys).clone()
            return forward
        return self._use(fn)


def train_rwkv_path(torch, np):
    """The train_rwkv path (see RWKV_TRAIN_LAYERS): rwkv6-1.6b's train step
    at full width through the rwkv6 kernel and its hand-written backward,
    against the plain versions, three steps and a profiled one; then
    ``train_loop`` on the reduced config, its loss falling; launches held to
    TRAIN_PREDICTED["rwkv"] and ["rwkv_cli"]."""
    from repro_torch.checkpoint.checkpointer import flatten
    from repro_torch.configs import RWKV6_1_6B, get_config
    from repro_torch.data.pipeline import LMDataPipeline, PipelineState
    from repro_torch.launch.steps import StepConfig, make_grad_fn, make_train_step
    from repro_torch.launch.train import train_loop
    from repro_torch.models import build_model
    from repro_torch.models.losses import next_token_xent
    from repro_torch.optim import AdamWConfig, init_state, linear_warmup_cosine

    t0 = time.perf_counter()
    step_cfg = StepConfig(chunked_loss=TRAIN_CHUNK)
    pipe = LMDataPipeline(RWKV6_1_6B.vocab_size, TRAIN_BATCH, TRAIN_SEQ,
                          PipelineState(seed=0, step=0, domain="en_a"), device="cuda")
    batches = [next(pipe) for _ in range(RWKV_TRAIN_STEPS - 1)]
    # The fp32 twin: kernels against plain, nothing pinned (its launches
    # before the counted run).
    cfg32 = dataclasses.replace(RWKV6_1_6B, num_layers=RWKV_FP32_LAYERS, dtype="float32")
    model32 = build_model(cfg32)
    loss32_k, loss32_p, rel32, finite32 = grads_against_plain(
        torch, make_grad_fn(model32, step_cfg), model32.init(0, "cuda"), batches[0])
    loss32_rel = abs(loss32_k - loss32_p) / abs(loss32_p)
    fp32_ok = (finite32 and max(rel32.values()) <= TRAIN_GRAD_REL_TOL
               and loss32_rel <= TRAIN_LOSS_REL_TOL)
    del model32
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(RWKV6_1_6B, num_layers=RWKV_TRAIN_LAYERS)
    model = build_model(cfg)
    params = model.init(0, "cuda")
    n_params = sum(p.numel() for p in flatten(params).values())
    reckon = n_params * (2 + 2 + 3 * 4)  # bf16 params and grads, fp32 mu, nu, master
    opt_cfg = AdamWConfig(lr=3e-4, schedule=linear_warmup_cosine(2, 20))
    step_fn = make_train_step(model, opt_cfg, step_cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()

    pinned = RecurrenceTrace(_ops("rwkv6"))
    loss_k, loss_p, rel, finite = grads_against_plain(
        torch, make_grad_fn(model, step_cfg), params, batches[0], pinned)
    pinned.ys = []
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    grads_ok = (finite and max(pinned.rel.values()) <= TRAIN_GRAD_REL_TOL
                and loss_rel <= TRAIN_LOSS_REL_TOL and fp32_ok)

    def worst(r):
        return [(k, round(v, 6)) for k, v in sorted(r.items(), key=lambda kv: -kv[1])[:3]]
    log(f"train_rwkv path: {cfg.name} layers={cfg.num_layers} (depth cut), "
        f"{n_params / 1e9:.3f} B params bf16, AdamW fp32, batch {TRAIN_BATCH} x {TRAIN_SEQ}, "
        f"loss chunked by {TRAIN_CHUNK}")
    log(f"  step 1 kernels vs plain: loss {loss_k:.5f} vs {loss_p:.5f} (rel {loss_rel:.2e}, tol "
        f"{TRAIN_LOSS_REL_TOL:.0e}); grads rel L2 against the plain run replaying the "
        f"kernel's y: max {max(pinned.rel.values()):.3e} (tol {TRAIN_GRAD_REL_TOL:.0e}) over "
        f"{len(rel)} leaves, worst {worst(pinned.rel)}; against the plain run, nothing "
        f"pinned (logged): max {max(rel.values()):.3e}, worst {worst(rel)}")
    log(f"  fp32 twin ({RWKV_FP32_LAYERS} layers): loss {loss32_k:.6f} vs {loss32_p:.6f} (rel "
        f"{loss32_rel:.2e}); grads rel L2 max {max(rel32.values()):.3e} (tol "
        f"{TRAIN_GRAD_REL_TOL:.0e}), worst {worst(rel32)}; {'OK' if grads_ok else 'FAIL'}")

    p, o, losses = params, init_state(params), []
    del params
    for b in batches:
        p, o, m = step_fn(p, o, b)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    counts = train_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    rsplit, rsplit_ok = rwkv6_split_ok(counts)
    counts_ok = counts == TRAIN_PREDICTED["rwkv"] and rsplit_ok
    log(f"  {len(batches)} steps: losses {[round(x, 5) for x in losses]}; peak "
        f"{peak / 2 ** 30:.2f} GiB allocated against the reckoning of {reckon / 2 ** 30:.2f} GiB "
        f"for params, grads and AdamW state (plus activations, the guard's old tree and the "
        f"plain comparison)")
    log(f"  launches {counts} expected {TRAIN_PREDICTED['rwkv']}; rwkv6 {rsplit} "
        f"{'OK' if counts_ok else 'FAIL'}")

    # Where a step's time goes (outside the counted run).
    prof = profile_step(torch, lambda: step_fn(p, o, batches[-1]), "rwkv train step",
                        windows=3)
    bwd_split = rwkv6_bwd_split(prof["kernels"])
    bwd_ms = sum(bwd_split.values())
    fwd_ms = sum(ms for k, ms in prof["kernels"].items() if "rwkv6_kernel" in k)
    tok_s = TRAIN_BATCH * TRAIN_SEQ / (prof["wall_ms"] / 1e3)
    log(f"  rwkv train step: wall {prof['wall_ms']:.2f} ms, device {prof['device_busy_ms']:.2f} "
        f"ms, {tok_s:.0f} tokens/s; rwkv6 backward kernels {bwd_ms:.2f} ms "
        f"({bwd_ms / prof['device_busy_ms']:.1%} of device; "
        + " ".join(f"{n} {v:.3f}" for n, v in bwd_split.items())
        + f"), forward {fwd_ms:.3f} ms")
    full_s = time.perf_counter() - t0
    del p, o, batches
    torch.cuda.empty_cache()

    # The training entry point on the reduced config (K 8: one-block clusters).
    cli_cfg = get_config("rwkv6-1.6b").reduced()
    cli_model = build_model(cli_cfg)
    t1 = time.perf_counter()
    reset_counts()
    pc, _, mc = train_loop(arch="rwkv6-1.6b", steps=RWKV_CLI_STEPS, reduced=True,
                           device="cuda")
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t1
    cli_counts = train_counts()
    csplit, csplit_ok = rwkv6_split_ok(cli_counts)
    cli_counts_ok = cli_counts == TRAIN_PREDICTED["rwkv_cli"] and csplit_ok
    # train_loop's own first batch (its pipeline: seed 0, en_a, 8 x 128),
    # before (its init, seed 0) and after.
    b0 = next(LMDataPipeline(cli_cfg.vocab_size, 8, 128,
                             PipelineState(seed=0, step=0, domain="en_a"), device="cuda"))

    def eval_loss(pp) -> float:
        with torch.no_grad():
            logits = cli_model.apply(pp, b0["tokens"], mode="train")
            return float(next_token_xent(logits, b0["tokens"], b0.get("loss_mask")))
    first, last = eval_loss(cli_model.init(0, "cuda")), eval_loss(pc)
    drop_ok = math.isfinite(last) and first - last >= RWKV_CLI_DROP
    log(f"  train_loop(arch='rwkv6-1.6b', reduced=True, device='cuda'): {RWKV_CLI_STEPS} steps "
        f"in {cli_s:.2f} s ({cli_s / RWKV_CLI_STEPS * 1e3:.1f} ms a step), last step's loss "
        f"{float(mc['loss']):.4f}; its first batch's loss {first:.4f} at init -> {last:.4f} "
        f"(drop {first - last:.4f}, at least {RWKV_CLI_DROP}) {'OK' if drop_ok else 'FAIL'}; "
        f"launches {cli_counts} expected {TRAIN_PREDICTED['rwkv_cli']}; rwkv6 {csplit} "
        f"{'OK' if cli_counts_ok else 'FAIL'}")
    ok = (grads_ok and counts_ok and cli_counts_ok and drop_ok
          and all(math.isfinite(x) for x in losses))
    summary = dict(config=cfg.name, layers=cfg.num_layers, params=n_params,
                   reckoned_state_gib=reckon / 2 ** 30, peak_gib=peak / 2 ** 30,
                   loss_kernel=loss_k, loss_plain=loss_p, loss_rel=loss_rel, grad_rel=rel,
                   grad_rel_pinned=pinned.rel, fp32_loss_rel=loss32_rel, fp32_grad_rel=rel32,
                   losses=losses, launches=counts, expected_launches=TRAIN_PREDICTED["rwkv"],
                   rwkv6_split=rsplit, step_profile=prof, rwkv6_bwd_ms=bwd_ms,
                   rwkv6_bwd_split_ms=bwd_split,
                   rwkv6_fwd_ms=fwd_ms, tokens_per_s=tok_s, full_width_s=full_s,
                   cli_s=cli_s, cli_steps=RWKV_CLI_STEPS, cli_launches=cli_counts,
                   cli_loss_first=first, cli_loss_last=last, cli_last_step_loss=float(mc["loss"]),
                   ok=bool(ok))
    return summary, counts


FULL_DEPTH_EVAL = dict(n_batches=2, batch=4, seq=2048)  # ppl; the KL on the first
HOMES_LAYERS = 2  # the depth at which both GramStore homes fit and are compared
HOMES_SHARED_REL = 1e-12  # a shared key's groups summed in another order (fp64)


def host_memory() -> dict:
    """The host's MemTotal and MemAvailable (/proc/meminfo, read only) and
    this process's peak resident set, in bytes."""
    import resource

    info = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, value = line.split(":", 1)
            if key in ("MemTotal", "MemAvailable"):
                info[key] = int(value.split()[0]) * 1024
    info["peak_rss"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    return info


def gram_homes_check(torch, np, cfg, device: str = "cuda") -> dict:
    """Both GramStore homes on ``cfg`` (random weights from seed 0 on
    ``device``), where both fit: the device store in one pass, the host
    store one layer a group (so its shared keys add the groups' sums in
    turn).  Every layer's keys bit-identical, the shared keys within
    HOMES_SHARED_REL of their largest entry, the counts equal; then nsvd1
    0.2 (factors in the model's dtype) from each store on ``device``, every
    factor there and bit-identical."""
    from repro_torch.calib.runner import calibration_batches, collect_grams
    from repro_torch.checkpoint.checkpointer import flatten
    from repro_torch.core import CompressionConfig, build_plan, compress_params
    from repro_torch.launch.compress_shapes import gram_layers
    from repro_torch.models import build_model

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()
    model = build_model(cfg)
    params = model.init(0, device)
    batches = list(calibration_batches(cfg.vocab_size, "en_a", n_samples=256, batch=16,
                                       seq=128))
    t0 = time.perf_counter()
    dev = collect_grams(model, params, batches)
    sync()
    dev_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = collect_grams(model, params, batches, grams_on="host",
                         group_bytes=max(gram_layers(model)["layers"].values()))
    host_s = time.perf_counter() - t0
    own = [k for k in dev.keys() if k.rsplit("/", 1)[-1].isdigit()]
    shared = [k for k in dev.keys() if k not in own]
    own_equal = all(torch.equal(host.gram(k), dev.gram(k).cpu())
                    and torch.equal(host.absmean(k), dev.absmean(k).cpu()) for k in own)
    shared_rel = max(float((host.gram(k) - dev.gram(k).cpu()).abs().max()
                           / dev.gram(k).abs().max()) for k in shared)
    counts_equal = all(host.count(k) == dev.count(k) for k in dev.keys())
    plan = build_plan(model.compressible_targets(), CompressionConfig(
        method="nsvd1", ratio=0.2, dtype=cfg.dtype, use_randomized=False))
    from_dev = flatten(compress_params(params, plan, dev))
    from_host = flatten(compress_params(params, plan, host))
    sync()
    on_card = all(t.device.type == device for t in from_host.values())
    params_equal = (from_dev.keys() == from_host.keys()
                    and all(torch.equal(from_dev[k], from_host[k]) for k in from_dev))
    ok = (host.device == torch.device("cpu") and host.groups == cfg.num_layers
          and set(host.keys()) == set(dev.keys()) and own_equal and counts_equal
          and shared_rel <= HOMES_SHARED_REL and on_card and params_equal)
    log(f"  GramStore homes at {cfg.num_layers} layers: device store {dev_s:.2f} s, host store "
        f"{host_s:.2f} s in {host.groups} groups; {len(own)} layer keys bit-identical: "
        f"{own_equal}, {len(shared)} shared keys max rel diff {shared_rel:.3e} (tol "
        f"{HOMES_SHARED_REL:g}), counts equal {counts_equal}; nsvd1 0.2 from each: "
        f"{len(from_dev)} leaves bit-identical {params_equal}, on {device} {on_card} "
        f"{'OK' if ok else 'FAIL'}")
    return dict(layers=cfg.num_layers, groups=host.groups, own_keys=len(own),
                shared_keys=len(shared), own_equal=own_equal, shared_max_rel=shared_rel,
                counts_equal=counts_equal, params_equal=params_equal, on_card=on_card,
                device_s=dev_s, host_s=host_s, ok=ok)


def full_depth_path(torch, np, cfg):
    """mistral-7b at full width and all its layers, random weights from
    seed 0, bf16, the calibration GramStore in host memory (67.7 GB of fp64
    sums: more than the card holds beside the weights): the serve path's
    run (calibrate in layer groups, nsvd1 0.2, 8 requests paged at worst
    case and depth 1, exact launches, a decode step's logits against
    plain); then perplexity of the dense and the compressed model on
    FULL_DEPTH_EVAL batches of en_a and the logit KL on the first (flash
    once a layer and forward; every compressed linear above the nested
    gate at 8192 rows: ``gate_calls``); then both homes at HOMES_LAYERS
    layers (``gram_homes_check``).  Prints the host's memory, the store's
    host bytes and groups, the peak device memory against the serve
    CLI's reckoning for the host home, and each phase's seconds."""
    from repro_torch.eval.attribution import mean_logit_kl
    from repro_torch.eval.perplexity import eval_batches, evaluate_ppl
    from repro_torch.launch.compress_shapes import calibration_bytes
    from repro_torch.launch.serve import fit_error
    from repro_torch.models import build_model

    before = host_memory()
    free = torch.cuda.mem_get_info()[0]
    refused = fit_error(cfg, [0.2], free)
    log(f"full_depth path: {cfg.name} at {cfg.num_layers} layers; host MemTotal "
        f"{before['MemTotal'] / 1e9:.2f} GB, MemAvailable {before['MemAvailable'] / 1e9:.2f} GB; "
        f"card free {free / 1e9:.2f} GB; the serve CLI with the Grams on the device: "
        f"{refused}")
    keep = {}
    summary, counts = serve_path(torch, np, cfg, "flash_attention", (4 * cfg.num_layers + 1, 0),
                                 keep=keep, grams_on="host")
    after = host_memory()
    model, cparams = keep["model"], keep["params"]
    store = summary["gram_store"]
    grams_bytes = calibration_bytes(build_model(cfg))["grams"]
    store_ok = (store["grams_on"] == "host" and store["bytes"] == grams_bytes
                and store["groups"] >= 1 and refused is not None)
    log(f"  host store {store['bytes'] / 1e9:.2f} GB (reckoned {grams_bytes / 1e9:.2f}) in "
        f"{store['groups']} groups; host peak RSS {after['peak_rss'] / 1e9:.2f} GB, "
        f"MemAvailable after {after['MemAvailable'] / 1e9:.2f} GB "
        f"{'OK' if store_ok else 'FAIL'}")

    dense = model.init(0, "cuda")
    batches = list(eval_batches(cfg.vocab_size, "en_a", **FULL_DEPTH_EVAL))
    reset_counts()
    nlr = _ops("nested_lowrank")
    t0 = time.perf_counter()
    with torch.no_grad():
        ppl_dense = evaluate_ppl(model, dense, batches)
        ppl_comp = evaluate_ppl(model, cparams, batches)
        kl = mean_logit_kl(model, dense, cparams, batches[:1])
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_counts = read_counts()
    forwards = 2 * len(batches) + 2
    eval_expect = {"nested_lowrank": 0, "paged_attention": 0, "gram": 0, "rwkv6": 0,
                   "flash_attention": cfg.num_layers * forwards}
    gate_expect = nested_calls(model)[0] * (len(batches) + 1)
    eval_ok = (eval_counts == eval_expect and nlr.gate_calls == gate_expect
               and all(math.isfinite(x) and x > 0 for x in (ppl_dense, ppl_comp))
               and math.isfinite(kl) and kl >= 0)
    log(f"  eval on {len(batches)} x {FULL_DEPTH_EVAL['batch']} x {FULL_DEPTH_EVAL['seq']} of "
        f"en_a: ppl dense {ppl_dense:.3f} compressed {ppl_comp:.3f}, logit KL {kl:.5f} "
        f"(random weights: wiring only); {eval_s:.2f} s; launches {eval_counts} expected "
        f"{eval_expect}, nested gate calls {nlr.gate_calls} expected {gate_expect} "
        f"{'OK' if eval_ok else 'FAIL'}")
    del dense, cparams, keep
    torch.cuda.empty_cache()

    homes = gram_homes_check(torch, np, dataclasses.replace(cfg, num_layers=HOMES_LAYERS))
    seconds = {**summary["seconds"], "evaluate": eval_s}
    log("  full_depth seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items())
        + f"; peak {summary['run_peak_gib']:.2f} GiB against the host home's reckoning "
        f"{summary['fit_need_gib']:.2f} GiB")
    out = dict(summary, host_memory_before=before, host_memory_after=after,
               device_refusal=refused, grams_bytes=grams_bytes,
               eval=dict(ppl_dense=ppl_dense, ppl_compressed=ppl_comp, logit_kl=kl,
                         seconds=eval_s, launches=eval_counts, expected=eval_expect,
                         gate_calls=nlr.gate_calls, expected_gate_calls=gate_expect),
               homes=homes, full_seconds=seconds,
               ok=bool(summary["ok"] and store_ok and eval_ok and homes["ok"]))
    return out, counts


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
        from repro_torch.configs import (CHATGLM3_6B, DEEPSEEK_V3_671B, JAMBA_V0_1_52B,
                                         LLAVA_NEXT_MISTRAL_7B, MINICPM3_4B, MISTRAL_7B,
                                         MOONSHOT_V1_16B_A3B, RWKV6_1_6B, WHISPER_SMALL)
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
    for line in ptxas_report(build.build_log):
        log(line)

    nested = nested_phase(torch, nlr_ops, nlr_ref)
    nested_b = nested_batched_phase(torch, nlr_ops, nlr_ref)
    paged = paged_phase(torch, np, pa_ops, pa_ref)
    grams = gram_phase(torch, gram_ops, gram_ref)
    grams_b = gram_batched_phase(torch, gram_ops, gram_ref)
    flash = flash_phase(torch, fa_ops, fa_ref)
    flash_bwd = flash_bwd_phase(torch, fa_ops, fa_ref)
    rwkv = rwkv6_phase(torch, rwkv_ops, rwkv_ref)
    rwkv_bwd = rwkv6_bwd_phase(torch, rwkv_ops, rwkv_ref)
    kernels_ok = all(r["ok"] for r in nested + nested_b + paged + grams + grams_b + flash
                     + flash_bwd + rwkv + rwkv_bwd)
    # mistral-7b cut to 2 of 32 layers (1 on the methods path); rwkv6-1.6b
    # cut to 4 of 24; moonshot-v1-16b-a3b cut to 3 of 48 (its dense first
    # layer and two MoE layers); chatglm3-6b cut to 2 of 28; minicpm3-4b cut
    # to 4 of 62; widths untouched.  (path, function, args): the mixer kernel
    # and a calibration batch's (single, batched) Gram taps (4 a layer and
    # the final norm's on Mistral and chatglm3, 9 a layer and the final
    # norm's on RWKV-6; on moonshot 4 on the dense layer, and on each MoE
    # layer attn.in, attn.out_in, router_in, shared_in, shared_mid and the
    # batched expert_buf, expert_mid; on minicpm3 attn.in, attn.q_lora_in,
    # attn.kv_lora_in, attn.out_in, mlp.in and mlp.mid a layer, no mixer
    # kernel: MLA attention is plain torch; on deepseek-v3 those six on each
    # dense layer, and on the MoE layer its 4 attention taps, router_in,
    # shared_in, shared_mid and the batched expert_buf, expert_mid).
    # deepseek-v3-671b takes two cuts, no width: 4 of 61 layers (its 3 dense
    # layers and 1 MoE layer) and 16 of 256 experts, top-8 kept.  The
    # calibration keeps an fp64 Gram an expert on the card (411 MB at d_model
    # 7168), so 256 experts would hold 105 GB of Grams in one MoE layer; 16
    # leave the weights (9.1 GB) and every Gram (28.5 GB) room for the
    # compression's own fp64 work.  Fewer than 16 would not do: top-8 of 8
    # routes every token to every expert.  The kernel phase runs the
    # batched nested form at all 256 experts.  jamba-v0.1-52b takes two
    # cuts, no width: 5 of 32 layers ((mamba, mlp), (mamba, moe), (mamba,
    # mlp), (mamba, moe), (gqa, mlp): the fewest that hold every kind of
    # layer in its period of 8, the attention layer at index 4 as in the
    # model) and 8 of 16 experts, top-2 kept.  An expert's expert_mid Gram
    # is 1.64 GB of fp64 at d_ff_expert 14336: 16 experts would hold 71.3
    # GB of Grams beside 14.3 GB of weights, 8 hold 42.9 GB beside 8.7
    # (``calibration_bytes``), which leaves the compression's fp64 work
    # room (``launch.serve.run_bytes``: 65.95 GiB at most, held against
    # the run's peak).  The kernel phase runs the batched nested form at
    # all 16.
    mistral = dataclasses.replace(MISTRAL_7B, num_layers=2)
    rwkv6 = dataclasses.replace(RWKV6_1_6B, num_layers=4)
    moonshot = dataclasses.replace(MOONSHOT_V1_16B_A3B, num_layers=3)
    glm = dataclasses.replace(CHATGLM3_6B, num_layers=2)
    minicpm3 = dataclasses.replace(MINICPM3_4B, num_layers=4)
    dsv3 = dataclasses.replace(DEEPSEEK_V3_671B, num_layers=4, moe=dataclasses.replace(
        DEEPSEEK_V3_671B.moe, num_experts=16))
    jamba = dataclasses.replace(JAMBA_V0_1_52B, num_layers=5, moe=dataclasses.replace(
        JAMBA_V0_1_52B.moe, num_experts=8))
    llava = dataclasses.replace(LLAVA_NEXT_MISTRAL_7B, num_layers=LLAVA_LAYERS)
    served = {}
    runs = (("serve", serve_path, (mistral, "flash_attention", (9, 0), served)),
            ("sched_serve", sched_serve_path, (served,)),
            ("fault_serve", fault_serve_path, (served,)),
            ("spec_serve", spec_serve_path, (served,)),
            ("obs_serve", obs_serve_path, (served,)),
            ("mesh_serve", mesh_serve_path, (served,)),
            ("quality", quality_path, (mistral, 2, (9, 0), "flash_attention")),
            ("methods", methods_path, (dataclasses.replace(MISTRAL_7B, num_layers=1), 4)),
            ("rwkv_serve", serve_path, (rwkv6, "rwkv6", (37, 0))),
            ("rwkv_quality", quality_path, (rwkv6, 1, (37, 0), "rwkv6")),
            ("moe_serve", serve_path, (moonshot, "flash_attention", (15, 4), None, None,
                                       True)),
            ("moe_quality", quality_path, (moonshot, 2, (15, 4), "flash_attention")),
            ("glm_serve", serve_path, (glm, "flash_attention", (9, 0), None, GLM_PREDICTED)),
            ("mla_serve", serve_path, (minicpm3, None, (25, 0), None, MLA_PREDICTED)),
            ("dsv3_serve", serve_path, (dsv3, None, (26, 2), None, DSV3_PREDICTED)),
            ("jamba_serve", serve_path, (jamba, "flash_attention", (27, 4), None,
                                         JAMBA_PREDICTED)),
            ("whisper", whisper_path, (WHISPER_SMALL,)),
            ("llava", llava_path, (llava,)),
            ("train", train_path, ()),
            ("train_rwkv", train_rwkv_path, ()),
            ("full_depth", full_depth_path, (MISTRAL_7B,)))
    summaries, path_counts, path_s, path_peak = {}, {}, {}, {}
    for name, fn, args in runs:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        summaries[name], path_counts[name] = fn(torch, np, *args)
        path_s[name] = time.perf_counter() - t0
        path_peak[name] = torch.cuda.max_memory_allocated() / 2 ** 30
        torch.cuda.empty_cache()
    log("path seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in path_s.items()))
    log("path peak GiB allocated: " + ", ".join(f"{k} {v:.2f}" for k, v in path_peak.items()))
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
    # path).  The gram tf32x3 kernel (fp32 taps) runs on the llava and train
    # paths (its row below).
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
    # with their batched gram launches at its width (2048).
    # The G 16 paged step (glm_serve's decode step at chatglm3-6b's 32/2
    # heads): the split kernel with glm_serve's launches, and its combine
    # alone with glm_serve's combine launches.
    glm_counts = path_counts["glm_serve"]
    picks += (
        ("paged_attention_g16", next(r for r in paged if r["kernel"] == "paged_attention"
                                     and r["pool"] == "bfloat16" and r["case"] == "glm"),
         glm_counts["paged_attention"], "src/repro_torch/csrc/paged_attention.cu",
         "src/repro/kernels/paged_attention/paged_attention.py:243"),
        ("paged_combine_g16", next(r for r in paged if r["kernel"] == "paged_combine"
                                   and r["case"] == "glm" and r["pool"] == "bfloat16"),
         summaries["glm_serve"]["paged_combine_launches"],
         "src/repro_torch/csrc/paged_attention.cu",
         "src/repro/kernels/paged_attention/paged_attention.py:243"))
    moe_b = [summaries[k]["batched_launches"] for k in ("moe_serve", "moe_quality")]
    picks += (
        ("nested_lowrank_batched", next(r for r in nested_b if r["case"] == "decode"),
         sum(b["nested"]["stream"] for b in moe_b), nested_src, nested_tpu),
        ("nested_lowrank_batched_mma", next(r for r in nested_b if r["case"] == "eval_gate"),
         sum(b["nested"]["mma"] for b in moe_b), nested_src, nested_tpu),
        ("gram_batched", next(r for r in grams_b if r["n"] == 2048
                              and r["dtype"] == "bfloat16"),
         sum(summaries[k]["gram_shape_launches"].get("batched 2048", 0)
             for k in ("moe_serve", "moe_quality")), "src/repro_torch/csrc/gram.cu",
         "src/repro/kernels/gram/gram.py:54"))
    # deepseek-v3's expert shapes (rank 1274): the 16-expert decode gate case
    # (stream) with dsv3_serve's batched stream launches; its 256-expert
    # twin, the same kernel at the real expert count, which no path runs (0
    # launches: the path serves 16 experts); the 109-row admission gate case
    # (mma) with its batched mma launches; the expert_buf-wide Gram (16,
    # 1280, 7168) with its batched gram launches at that width.
    dsv3_b = summaries["dsv3_serve"]["batched_launches"]
    picks += (
        ("nested_lowrank_batched_dsv3", next(r for r in nested_b
                                             if r["case"] == "dsv3_decode_gate"),
         dsv3_b["nested"]["stream"], nested_src, nested_tpu),
        ("nested_lowrank_batched_dsv3_256", next(r for r in nested_b
                                                 if r["case"] == "dsv3_256_decode_gate"),
         0, nested_src, nested_tpu),
        ("nested_lowrank_batched_mma_dsv3", next(r for r in nested_b
                                                 if r["case"] == "dsv3_admit_gate"),
         dsv3_b["nested"]["mma"], nested_src, nested_tpu),
        ("gram_batched_dsv3", next(r for r in grams_b if r["n"] == 7168
                                   and r["dtype"] == "bfloat16"),
         summaries["dsv3_serve"]["gram_shape_launches"].get("batched 7168", 0),
         "src/repro_torch/csrc/gram.cu",
         "src/repro/kernels/gram/gram.py:54"))
    # jamba's shapes: each Mamba linear's single form at 8 rows (stream) and
    # 173 (mma) with jamba_serve's launches of that kernel at its K x N; the
    # experts' batched form over 8 experts x 8 rows (stream, gate and down)
    # with its batched stream launches at that K x N, over all 16 (0: the
    # path serves 8), 8 x 55 rows (mma, the widest admission) with its
    # batched mma launches at 4096 x 14336; the batched gram at (8, 640,
    # 14336) and (8, 640, 4096) with its batched gram launches at that width.
    jamba_shapes = summaries["jamba_serve"]["nested_shape_launches"]
    jamba_gshapes = summaries["jamba_serve"]["gram_shape_launches"]
    for target, k_in, n, _ in JAMBA_PATH_SHAPES:
        for m, kern in ((8, "stream"), (173, "mma")):
            picks += ((f"nested_lowrank_{target}_{m}", next(
                r for r in nested if r["target"] == target and r["M"] == m),
                jamba_shapes.get(f"{kern} {k_in}x{n}", 0), nested_src, nested_tpu),)
    for case, kern, k_in, n in (("jamba_decode_gate", "stream", 4096, 14336),
                                ("jamba_decode_down", "stream", 14336, 4096),
                                ("jamba_16_decode_gate", None, 4096, 14336),
                                ("jamba_16_decode_down", None, 14336, 4096),
                                ("jamba_admit_gate", "mma", 4096, 14336)):
        picks += ((f"nested_lowrank_batched_{case}", next(
            r for r in nested_b if r["case"] == case),
            jamba_shapes.get(f"{kern} batched {k_in}x{n}", 0) if kern else 0,
            nested_src, nested_tpu),)
    for n in (14336, 4096):
        picks += ((f"gram_batched_jamba_{n}", next(
            r for r in grams_b if r["n"] == n and r["E"] == 8 and r["dtype"] == "bfloat16"),
            jamba_gshapes.get(f"batched {n}", 0), "src/repro_torch/csrc/gram.cu",
            "src/repro/kernels/gram/gram.py:54"),)
    # whisper-small's shapes (whisper path, no cut): flash at a (16, 128)
    # batch, 12/12 heads x 64, with the path's flash launches; each MLP
    # linear at 8 rows (stream) and 128 (mma) with its launches at its K x
    # N; the gram at 24000 rows (a calibration batch's frames) of n 768 and
    # 3072 with the path's gram launches at that width (its 2048-row
    # decoder taps of n 768 among them).
    whisper = summaries["whisper"]
    picks += (("flash_attention_whisper", next(
        r for r in flash if r["hd"] == 64 and r["B"] == 16 and r["S"] == 128),
        whisper["launches"]["flash_attention"], "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:108"),)
    for target, k_in, n, _ in WHISPER_PATH_SHAPES:
        for m, kern in ((8, "stream"), (128, "mma")):
            picks += ((f"nested_lowrank_{target}_{m}", next(
                r for r in nested if r["target"] == target and r["M"] == m),
                whisper["nested_shape_launches"].get(f"{kern} {k_in}x{n}", 0),
                nested_src, nested_tpu),)
    for n in (768, 3072):
        picks += ((f"gram_whisper_{n}", next(
            r for r in grams if r["dtype"] == "bfloat16" and r["rows"] == 24000
            and r["n"] == n), whisper["gram_shape_launches"].get(str(n), 0),
            "src/repro_torch/csrc/gram.cu", "src/repro/kernels/gram/gram.py:54"),)
    # llava's shapes (llava path, 4 of 32 layers): the gram tf32x3 kernel at
    # (9216, 1024) fp32 (``projector.in``: a calibration batch's patches)
    # with the path's tf32x3 launches, and the FMA kernel, which ran them
    # before, on the same rows (its error, times and FFMA bound from the
    # gram phase, the same library call) with the path's FMA launches; the
    # projector's wi and wo at one image's 576 rows (mma) with the path's
    # mma launches at that K x N (wo's 4096 x 4096 shared with the layers'
    # wq and wo).
    llava = summaries["llava"]
    x3_row = next(r for r in grams if r["dtype"] == "float32" and r["rows"] == 9216
                  and r["n"] == 1024)
    fma_row = {**x3_row, "max_abs_err": x3_row["fma_max_abs_err"], "ms": x3_row["fma_ms"],
               "bound_ms": x3_row["bound_ffma_ms"], "bound_by": x3_row["bound_ffma_by"]}
    picks += (("gram_tf32x3_llava", x3_row, llava["gram_launches"]["tf32x3"],
               "src/repro_torch/csrc/gram.cu", "src/repro/kernels/gram/gram.py:54"),
              ("gram_fma_llava", fma_row, llava["gram_launches"]["fma"],
               "src/repro_torch/csrc/gram.cu", "src/repro/kernels/gram/gram.py:54"))
    for target, k_in, n, _ in LLAVA_PATH_SHAPES:
        picks += ((f"nested_lowrank_{target}_576", next(
            r for r in nested if r["target"] == target and r["M"] == 576),
            llava["nested_shape_launches"].get(f"mma {k_in}x{n}", 0), nested_src,
            nested_tpu),)
    # The fp32 CUDA-core flash forward at small-llama's training batch,
    # with the train path's forwards on it (its recipe and its build_entry).
    train = summaries["train"]
    picks += (("flash_attention_fp32_small_llama", next(
        r for r in flash if r["dtype"] == "float32" and r["hd"] == 32),
        train["small_launches"]["flash_attention"]
        + train["small_quality_launches"]["flash_attention"],
        "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:108"),)
    # The flash backward (no TPU kernel: the reference differentiates its jnp
    # causal attention through XLA) at the forward's (4, 2048) bf16 row,
    # with the Mistral train run's backward calls.
    picks += (("flash_attention_bwd", next(r for r in flash_bwd if r["dtype"] == "bfloat16"
                                           and r["S"] == 2048 and r["Hkv"] == 8),
               summaries["train"]["launches"]["flash_backward"],
               "src/repro_torch/csrc/flash_attention_bwd.cu",
               "src/repro/models/attention.py:345 (none: XLA's autodiff of jnp attention)"),)
    # The rwkv6 backward (no TPU kernel: the reference differentiates its
    # lax.scan through XLA) at the eval batch's fp32 row (train_rwkv's
    # shape), with the train_rwkv run's backward calls.
    picks += (("rwkv6_bwd", next(r for r in rwkv_bwd if r["dtype"] == "float32"
                                 and r["case"] == "eval"),
               summaries["train_rwkv"]["launches"]["rwkv6_backward"],
               "src/repro_torch/csrc/rwkv6_bwd.cu",
               "src/repro/models/rwkv6.py:169 (none: XLA's autodiff of lax.scan)"),)
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
                   "flash_bwd": flash_bwd,
                   "rwkv6": rwkv, "rwkv6_bwd": rwkv_bwd,
                   **{f"{k}_path": v for k, v in summaries.items()},
                   "path_seconds": path_s, "path_peak_gib": path_peak,
                   "kernels": entries}, f, indent=1)
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
