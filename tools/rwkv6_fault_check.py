#!/usr/bin/env python3
"""Planted faults in the rwkv6 kernel, against chip_smoke.py's two checks of
it: the global one (max |kernel - plain| <= RWKV_TOL x max |plain| for y,
RWKV_STATE_TOL for the final state; both 1e-4 in fp32) and the per-element
one (RWKV_ELEM_TOL for y, RWKV_STATE_ELEM_TOL for the state, relative to
|plain| plus the rms of the row).

    python3 tools/rwkv6_fault_check.py

Needs one H100 and the CUDA toolkit.  Each fault is a one-line patch of
``csrc/rwkv6.cu`` in a temporary copy of ``repro_torch`` (the checkout is
never touched), built and run in its own process on the rwkv6 phase's fp32
cases (the dtype the model hands the kernel), with the final state.  Prints
one line per fault and case -- for each check the worse of y and the state,
the per-element one as a multiple of its tolerance (fails above 1) -- and
exits non-zero unless the unpatched kernel passes both checks
everywhere and every fault fails the per-element check somewhere.
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


def main() -> int:
    if sys.argv[1:] == ["--measure"]:
        print("RESULT " + json.dumps(measure()), flush=True)
        return 0
    assert chip_smoke.RWKV_TOL["float32"] == chip_smoke.RWKV_STATE_TOL
    ok = check_faults(FAULTS, chip_smoke.RWKV_TOL["float32"], 1.0, "rwkv6.cu", __file__)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
