#!/usr/bin/env python3
"""Planted faults in the rwkv6 kernels, against chip_smoke.py's two checks of
each.  The forward: the global check (max |kernel - plain| <= RWKV_TOL x
max |plain| for y, RWKV_STATE_TOL for the final state; both 1e-4 in fp32)
and the per-element one (RWKV_ELEM_TOL for y, RWKV_STATE_ELEM_TOL for the
state, relative to |plain| plus the rms of the row).  The backward: the
same two on dr, dk, dv, dw and du (RWKV_BWD_TOL, RWKV_BWD_ELEM_TOL on
``bwd_elem_err``).

    python3 tools/rwkv6_fault_check.py [forward] [backward]   (default: both)

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

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402
from flash_fault_check import check_faults  # noqa: E402

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
        "        else if (which == 1) a += u_s[jj] * rs[t * Q + jj] * dyvt;\n", ""),
    # G_{t-1} = G_t + r^T dy: the update misses its w decay.
    "g_update_skips_decay": (
        "          greg[e] = __fadd_rn(__fmul_rn(wj, greg[e]), __fmul_rn(rj, dyr[e]));",
        "          greg[e] = __fadd_rn(greg[e], __fmul_rn(rj, dyr[e]));"),
    # dv's cluster reduction leaves out the last block's rows.
    "dv_cluster_skips_a_block": ("        for (int src = 0; src < NSLICE; ++src)\n",
                                 "        for (int src = 0; src < NSLICE - 1; ++src)\n"),
    # Pass 2 starts each chunk but the last from the state it stepped to at
    # the end of the chunk after it, not from the stored start.
    "chunk_start_not_reloaded": ("      for (int e = 0; e < CPT; ++e) sreg[e] = snext[e];",
                                 "      for (int e = 0; e < CPT; ++e) sreg[e] = sreg[e];"),
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


def main() -> int:
    if sys.argv[1:] in (["--measure"], ["--measure-bwd"]):
        rows = measure() if sys.argv[1] == "--measure" else measure_bwd()
        print("RESULT " + json.dumps(rows), flush=True)
        return 0
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
