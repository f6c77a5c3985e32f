#!/usr/bin/env python3
"""Planted faults in the rwkv6 kernels, against chip_smoke.py's two checks of
each.  The forward: the global check (max |kernel - plain| <= RWKV_TOL x
max |plain| for y, RWKV_STATE_TOL for the final state; both 1e-4 in fp32)
and the per-element one (RWKV_ELEM_TOL for y, RWKV_STATE_ELEM_TOL for the
state, relative to |plain| plus the rms of the row).  The backward: the
same two on dr, dk, dv, dw and du (RWKV_BWD_TOL, RWKV_BWD_ELEM_TOL on
``bwd_elem_err``), against seven faults in the chunked backward: four of
the per-token design's re-planted (dk's bonus term, G's decay, a part of
dv's sum, a chunk's start state) and three of the chunked form's own
(single-pass TF32 products, d(s, t) off by one token, the scan over
chunks without W_c).

    python3 tools/rwkv6_fault_check.py [forward] [backward]   (default: both)
    python3 tools/rwkv6_fault_check.py splits

``splits`` is no fault check: it runs the backward with three 3xTF32
splits of ``csrc/mma_sm90.cuh`` (the shipped ``tf32_split_int``, rounding
by integer ops; truncation, hi = x with its low 13 bits cleared and lo
read by the tensor core as it reads any fp32 operand; ``tf32_split``'s two
``cvt.rna``), shipped first and last, and prints for each the per-element
error of every gradient on the fp32 cases, a digest of the gradients' bits
and the kernels' profiled device ms at the eval shape.

Needs one H100 and the CUDA toolkit.  Each fault is a one-line patch of
``csrc/rwkv6.cu`` or ``csrc/rwkv6_bwd.cu`` in a temporary copy of
``repro_torch`` (the checkout is never touched), built and run in its own
process on the rwkv6 (or rwkv6_bwd) phase's fp32 cases (the dtype the
model hands the kernel), the forward with the final state.  Prints one
line per fault and case -- for each check the worst of the outputs, the
per-element one as a multiple of its tolerance (fails above 1) -- and
exits non-zero unless the unpatched kernels pass both checks everywhere
and every fault fails the per-element check somewhere.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402
from flash_fault_check import check_faults, run_variant  # noqa: E402

FAULTS = {
    # The state update skips each chunk's last token.
    "state_drops_last_token": (
        "          sreg[jj] = __fadd_rn(__fmul_rn(wv[jj], sreg[jj]), __fmul_rn(kv[jj], vt));",
        "          sreg[jj] = t == L - 1 ? sreg[jj]\n"
        "              : __fadd_rn(__fmul_rn(wv[jj], sreg[jj]), __fmul_rn(kv[jj], vt));"),
    # Each token decays the state by its predecessor's w: off by one token.
    "decay_off_by_one": ("        load_row<JPT>(row(2, t, jl0), wv);",
                         "        load_row<JPT>(row(2, t > 0 ? t - 1 : 0, jl0), wv);"),
    # Every block stores its partial ys into its neighbour's slots, so each
    # block sums (and writes) the partials of its neighbour's columns.
    "partials_to_neighbour": ("      const int owner = vcol / Q;",
                              "      const int owner = (vcol / Q + 1) % NSLICE;"),
}
BWD_FAULTS = {
    # dk without its bonus term u r (dy . v).
    "dk_drops_u_term": (
        "fmaf(bt, qs[t * LD + colk], yt) + uc * rt * ms[t * LDC + t];",
        "fmaf(bt, qs[t * LD + colk], yt);"),
    # G's recurrence within a chunk (Y_{t-1} = w_t Y_t + r_t M[., t]) misses
    # its w decay in the chunk's second half.
    "g_update_skips_decay": ("update_row<0, C / 4>(y, ms + t * LDC, wt, rt);",
                             "update_row<0, C / 4>(y, ms + t * LDC, 1.f, rt);"),
    # dv's sum over the chunk's later tokens (A dy) leaves out its last 8.
    "dv_sum_skips_a_step": (
        "    for (int kq = 0; kq < C / 8; ++kq) {\n      uint32_t ah[4], al[4];\n      frag_a(at_am",
        "    for (int kq = 0; kq < C / 8 - 1; ++kq) {\n      uint32_t ah[4], al[4];\n      frag_a(at_am"),
    # The scan over chunks never stores a chunk's start state: each chunk
    # starts from its own summary.
    "chunk_start_not_stored": (
        "          reinterpret_cast<float4*>(base + (long long)chunk(i) * K * K)[e] = carry;\n", ""),
    # Single-pass TF32: the products drop their lo terms (hi * hi only).
    "single_pass_tf32": ("  mma_tf32(c, al, bh[0], bh[1]);\n  mma_tf32(c, ah, bl[0], bl[1]);\n", ""),
    # d(t, tau) off by one token: A's decays take w_tau for w_{tau-1}.
    "decay_off_by_one": ("ld_vec<S::VW>(ws + (tau - 1) * LDK + c0, wv);",
                         "ld_vec<S::VW>(ws + tau * LDK + c0, wv);"),
    # The scan over chunks skips the chunk's whole decay W_c.
    "scan_skips_w": ("          const float ww = wbuf[j];", "          const float ww = 1.f;"),
}

# The 3xTF32 splits ``splits`` compares, as patches of tf32_split_int's body.
SPLIT_BODY = ("  hi = tf32_round_bits(x);\n  lo = tf32_round_bits(x - __uint_as_float(hi));\n")
SPLITS = {
    "truncate": (SPLIT_BODY, "  hi = __float_as_uint(x) & 0xffffe000u;\n"
                             "  lo = __float_as_uint(x - __uint_as_float(hi));\n"),
    "cvt_rna": (SPLIT_BODY, "  tf32_split(x, hi, lo);\n"),
}


def measure() -> list:
    """Both checks of the kernel on the current PYTHONPATH's repro_torch."""
    import torch
    from repro_torch.kernels.rwkv6 import ops, ref

    out = []
    gen = torch.Generator(device="cuda").manual_seed(4)  # as chip_smoke's rwkv6 phase
    for case, bh, t, k, dname, w_fixed in chip_smoke.RWKV_SHAPES:
        args = chip_smoke.rwkv6_inputs(torch, gen, bh, t, k, dname, w_fixed)
        if dname != "float32":
            continue
        got, got_s = ops.rwkv6_attention(*args, return_state=True)
        want, want_s = ref.rwkv6_scan_ref(*args, return_state=True)

        def rel(a, b):
            return float((a.float() - b.float()).abs().max() / b.float().abs().max())
        out.append(dict(case=f"{case} ({bh}, {t}, {k})",
                        glob=max(rel(got, want), rel(got_s, want_s)),
                        elem=max(chip_smoke.elem_err(torch, got, want)
                                 / chip_smoke.RWKV_ELEM_TOL["float32"],
                                 chip_smoke.elem_err(torch, got_s, want_s)
                                 / chip_smoke.RWKV_STATE_ELEM_TOL),
                        finite=bool(torch.isfinite(got).all() and torch.isfinite(got_s).all())))
        del got, want, got_s, want_s, args
        torch.cuda.empty_cache()
    return out


def measure_bwd() -> list:
    """Both checks of the backward kernel on the current PYTHONPATH's
    repro_torch, on the rwkv6_bwd phase's fp32 cases."""
    import torch
    from repro_torch.kernels.rwkv6 import ops, ref

    out = []
    gen = torch.Generator(device="cuda").manual_seed(6)  # as chip_smoke's rwkv6_bwd phase
    for case, bh, t, k, dname, w_fixed in chip_smoke.RWKV_BWD_SHAPES:
        args = chip_smoke.rwkv6_inputs(torch, gen, bh, t, k, dname, w_fixed)
        dy = torch.randn((bh, t, k), generator=gen, device="cuda").to(args[0].dtype)
        if dname != "float32":
            continue
        got = [g[:, 0] for g in ops.backward(*(x[:, None] for x in (*args, dy)))]
        want = ref.rwkv6_scan_bwd_ref(*args, dy)
        out.append(dict(
            case=f"{case} ({bh}, {t}, {k})",
            glob=max(float((g - x).abs().max() / x.abs().max()) for g, x in zip(got, want)),
            elem=max(chip_smoke.bwd_elem_err(torch, g, x) for g, x in zip(got, want))
            / chip_smoke.RWKV_BWD_ELEM_TOL["float32"],
            finite=all(bool(torch.isfinite(g).all()) for g in got)))
        del got, want, args, dy
        torch.cuda.empty_cache()
    return out


def measure_split() -> list:
    """Per-element error of each gradient, a digest of their bits and (at
    the eval shape) the kernels' device ms, on the current PYTHONPATH's
    repro_torch, on the rwkv6_bwd phase's fp32 cases."""
    import torch
    from repro_torch.kernels.rwkv6 import ops, ref

    out = []
    gen = torch.Generator(device="cuda").manual_seed(6)  # as chip_smoke's rwkv6_bwd phase
    for case, bh, t, k, dname, w_fixed in chip_smoke.RWKV_BWD_SHAPES:
        args = chip_smoke.rwkv6_inputs(torch, gen, bh, t, k, dname, w_fixed)
        dy = torch.randn((bh, t, k), generator=gen, device="cuda").to(args[0].dtype)
        if dname != "float32":
            continue
        heads = [x[:, None] for x in (*args, dy)]
        got = [g[:, 0] for g in ops.backward(*heads)]
        want = ref.rwkv6_scan_bwd_ref(*args, dy)
        digest = hashlib.sha256()
        for g in got:
            digest.update(g.cpu().numpy().tobytes())
        row = dict(case=f"{case} ({bh}, {t}, {k})", digest=digest.hexdigest()[:16],
                   elem={n: chip_smoke.bwd_elem_err(torch, g, x)
                         for n, g, x in zip(chip_smoke.RWKV_BWD_NAMES, got, want)})
        del got, want
        if case == "eval":
            dev = chip_smoke.profile_step(torch, lambda: ops.backward(*heads), quiet=True,
                                          windows=5)
            row["device_ms"] = chip_smoke.rwkv6_bwd_split(dev["kernels"])
        out.append(row)
        del args, dy, heads
        torch.cuda.empty_cache()
    return out


def compare_splits() -> bool:
    """``splits``: each variant's rows, one line a case."""
    results = []
    for name, patch in [("shipped", None), *SPLITS.items(), ("shipped", None)]:
        rows = run_variant(f"split_{name}", patch, "mma_sm90.cuh", __file__, "--measure-split")
        results.append((name, rows))
        for r in rows:
            ms = r.get("device_ms")
            print(f"{name:9s} {r['case']:26s} elem "
                  + " ".join(f"{n} {e:.3e}" for n, e in r["elem"].items())
                  + f"  max {max(r['elem'].values()):.3e}  bits {r['digest']}"
                  + ("" if ms is None else "  device ms " + " ".join(
                      f"{n} {v:.4f}" for n, v in ms.items()) + f" total {sum(ms.values()):.4f}"),
                  flush=True)
    print(json.dumps({"splits": [{"split": n, "rows": rows} for n, rows in results]}))
    return all(max(r["elem"].values()) <= chip_smoke.RWKV_BWD_ELEM_TOL["float32"]
               for n, rows in results if n == "shipped" for r in rows)


def main() -> int:
    flags = {"--measure": measure, "--measure-bwd": measure_bwd, "--measure-split": measure_split}
    if len(sys.argv) == 2 and sys.argv[1] in flags:
        print("RESULT " + json.dumps(flags[sys.argv[1]]()), flush=True)
        return 0
    if sys.argv[1:] == ["splits"]:
        return 0 if compare_splits() else 1
    which = sys.argv[1:] or ["forward", "backward"]
    if not set(which) <= {"forward", "backward"}:
        print(__doc__, file=sys.stderr)
        return 2
    ok = True
    if "forward" in which:
        assert chip_smoke.RWKV_TOL["float32"] == chip_smoke.RWKV_STATE_TOL
        ok = check_faults(FAULTS, chip_smoke.RWKV_TOL["float32"], 1.0, "rwkv6.cu",
                          __file__) and ok
    if "backward" in which:
        ok = check_faults(BWD_FAULTS, chip_smoke.RWKV_BWD_TOL["float32"], 1.0, "rwkv6_bwd.cu",
                          __file__, "--measure-bwd") and ok
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
