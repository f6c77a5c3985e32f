#!/usr/bin/env python3
"""Device memory of calibration and compression against what the serve
CLI's memory check reckons (``launch.serve.run_bytes``).

    python3 tools/compress_memory.py            # decompositions, then jamba
    python3 tools/compress_memory.py decomp     # decompositions only

``decomp``: each (in, out) kernel of SHAPES (the served archs' target
shapes, bf16 weights, a random Gram: positive definite, or indefinite so
that the Cholesky whitener falls back to the eigen one) through
``core.compress.compress_matrix`` (``launch.serve``'s config: no
randomized SVD, ratio 0.2) with the peak allocated above what it started
with, beside ``compress_shapes.decomposition_bytes``; then the least
coefficients (steps of 1/8) of that model under which every estimate
bounds its peak, by the largest ratio of the cases it does not merely
bound (a Cholesky whitener that succeeds needs less than the model's
eigen build; a plain SVD, not the served method, less than its term).  ``jamba``: chip_smoke's jamba_serve cut (5 layers, 8
experts, full width) calibrated and compressed as ``serve()`` does, each
calibration batch's and each decomposition's peak, and the run's peak
beside ``run_bytes``'s parts.  Needs one H100.  Prints one JSON line a
measurement and exits non-zero if an estimate is below what it bounds.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

G = 2 ** 30
# (method, in, out, Gram): jamba's Mamba linears and experts, deepseek-v3's
# experts and chatglm3's wi, both orientations where they differ.
SHAPES = [("nsvd1", i, o, gram) for i, o in (
    (14336, 4096), (4096, 14336), (4096, 16384), (8192, 4096), (8192, 288), (256, 8192),
    (7168, 2048), (2048, 7168), (4096, 13696), (13696, 4096)) for gram in ("spd", "indefinite")
          ] + [("nsvd2", 14336, 4096, "spd"), ("nsvd2", 4096, 14336, "spd"),
               ("svd", 14336, 4096, "spd")]


def make_gram(torch, n: int, kind: str, g):
    """A random (n, n) fp64 Gram on the card: R R^T + n I (positive
    definite), or R R^T - n/100 I (indefinite: the smallest eigenvalues of
    R R^T lie under n/100, far past the whitener's damping)."""
    r = torch.randn((n, n), generator=g, device="cuda", dtype=torch.float64)
    shift = n if kind == "spd" else -n / 100
    return r @ r.T + shift * torch.eye(n, device="cuda", dtype=torch.float64)


def decomp(torch) -> list:
    from repro_torch.core import CompressionConfig
    from repro_torch.core.compress import compress_matrix
    from repro_torch.core.ratio import rank_for_ratio
    from repro_torch.launch.compress_shapes import decomposition_bytes

    rows = []
    for method, i, o, kind in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(i + o)
        kern = (torch.randn((i, o), generator=g, device="cuda") * i ** -0.5).to(
            torch.bfloat16).float()
        gram = make_gram(torch, i, kind, g)
        absmean = torch.rand(i, generator=g, device="cuda", dtype=torch.float64)
        cfg = CompressionConfig(method=method, ratio=0.2, use_randomized=False)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        compress_matrix(kern, rank_for_ratio(o, i, 0.2), cfg, gram, absmean)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        est = decomposition_bytes(i, o, method)
        row = dict(method=method, in_dim=i, out_dim=o, gram=kind, peak=peak, est=est,
                   ratio=est / peak, A=8 * i * o, N=8 * i * i, K=8 * min(i, o) ** 2)
        print(json.dumps(row), flush=True)
        rows.append(row)
        del kern, gram, absmean
    return rows


def fit(rows: list) -> dict:
    """The least (steps of 1/8) SVD_A, SVD_K and WHITEN_N under which
    decomposition_bytes' model bounds every row, by the largest ratio of
    the rows other than a Cholesky whitener on a positive definite Gram
    and a plain SVD."""
    best = None
    for sa in [x / 8 for x in range(16, 48)]:
        for sk in [x / 8 for x in range(0, 64)]:
            for wn in [x / 8 for x in range(40, 64)]:
                worst, low = 0.0, False
                for r in rows:
                    a, n, k = r["A"], r["N"], r["K"]
                    svd = sa * a + sk * k
                    if r["method"] == "svd":
                        est = a + svd
                    else:
                        est = max(a + wn * n, 3 * a + 2 * n + k + svd)
                    low = low or est < r["peak"]
                    if r["method"] != "svd" and not (r["method"] == "nsvd1"
                                                     and r["gram"] == "spd"):
                        worst = max(worst, est / r["peak"])
                if not low and (best is None or worst < best["worst_ratio"]):
                    best = dict(SVD_A=sa, SVD_K=sk, WHITEN_N=wn, worst_ratio=worst)
    return best


def jamba(torch) -> dict:
    from repro_torch.calib import runner
    from repro_torch.configs import JAMBA_V0_1_52B
    from repro_torch.core import CompressionConfig, build_plan, compress_params
    from repro_torch.launch.compress_shapes import calibration_bytes, compression_bytes
    from repro_torch.launch.serve import run_bytes
    from repro_torch.models import build_model

    cm = sys.modules["repro_torch.core.compress"]
    cut = dataclasses.replace(JAMBA_V0_1_52B, num_layers=5, moe=dataclasses.replace(
        JAMBA_V0_1_52B.moe, num_experts=8))
    model = build_model(cut)
    calls = {"calib": [], "decomp": []}
    orig_acc, orig_cm = runner.accumulate_taps, cm.compress_matrix

    def measured(kind, fn, label):
        def wrapped(*a, **k):
            torch.cuda.synchronize()
            before, since = torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            calls[kind].append(dict(label=label(*a, **k), before=before, since_last=since,
                                    peak=torch.cuda.max_memory_allocated()))
            torch.cuda.reset_peak_memory_stats()
            return out
        return wrapped
    runner.accumulate_taps = measured("calib", orig_acc, lambda *a, **k: len(calls["calib"]))
    cm.compress_matrix = measured("decomp", orig_cm, lambda *a, **k: (
        k.get("target", ""), list(k.get("slice_idx", ()))))
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = model.init(0, "cuda")
        t0 = time.perf_counter()
        grams = runner.collect_grams(model, params, runner.calibration_batches(
            cut.vocab_size, "en_a", n_samples=256, batch=16, seq=128))
        torch.cuda.synchronize()
        calib_s = time.perf_counter() - t0
        after_calib = torch.cuda.memory_allocated()
        config = CompressionConfig(method="nsvd1", ratio=0.2, dtype=cut.dtype,
                                   use_randomized=False)
        plan = build_plan(model.compressible_targets(), config)
        t0 = time.perf_counter()
        compressed = compress_params(params, plan, grams)
        torch.cuda.synchronize()
        compress_s = time.perf_counter() - t0
        after_compress = torch.cuda.memory_allocated()
        tail = torch.cuda.max_memory_allocated()
        del compressed, grams, params
    finally:
        runner.accumulate_taps, cm.compress_matrix = orig_acc, orig_cm
    need, what = run_bytes(cut, [0.2])
    calib_peak = max(max(c["peak"], c["since_last"]) for c in calls["calib"])
    compress_peak = max([tail] + [max(c["peak"], c["since_last"]) for c in calls["decomp"]])
    out = dict(calib_s=calib_s, compress_s=compress_s, calib_peak=calib_peak,
               after_calib=after_calib, compress_peak=compress_peak,
               after_compress=after_compress, run_bytes=need, run_bytes_parts=what,
               **calibration_bytes(model), **compression_bytes(model, config),
               top_calib=sorted(calls["calib"], key=lambda c: -c["peak"])[:3],
               top_decomp=sorted(calls["decomp"], key=lambda c: -c["peak"])[:3])
    print(json.dumps(out), flush=True)
    print(f"jamba cut: calibration peak {calib_peak / G:.2f} GiB, compression peak "
          f"{compress_peak / G:.2f} GiB; run_bytes {need / G:.2f} GiB ({what} GB)", flush=True)
    return out


def main() -> int:
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = decomp(torch)
    best = fit(rows)
    print("least coefficients: " + json.dumps(best), flush=True)
    ok = all(r["est"] >= r["peak"] for r in rows)
    if sys.argv[1:] != ["decomp"]:
        from repro_torch.kernels import build

        build.build_all(("gram", "flash_attention"))
        res = jamba(torch)
        ok = ok and res["run_bytes"] >= max(res["calib_peak"], res["compress_peak"])
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
