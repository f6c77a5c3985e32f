#!/usr/bin/env python3
"""Planted faults in the split paged-attention kernel and its combine,
against chip_smoke.py's two checks of it: the global one (max |kernel -
plain| <= PAGED_TOL x max |plain| over live rows) and the per-element one
(PAGED_ELEM_TOL, relative to |plain| plus the rms of that (row, head)'s
output).

    python3 tools/paged_fault_check.py

Needs one H100 and the CUDA toolkit.  Each fault is a one-line patch of
``csrc/paged_attention.cu`` in a temporary copy of ``repro_torch`` (the
checkout is never touched), built and run in its own process on the paged
phase's lengths 1-700 and long8 cases (Mistral-7B's 32/8 heads) and its
glm case (chatglm3-6b's 32/2 heads: G 16, the glm_serve decode step), bf16
and int8 pools.  Prints one
line per fault and case, and exits non-zero unless the unpatched kernel
passes both checks everywhere and every fault fails the per-element check
somewhere.
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
    # Every split stops one page short of its end.
    "split_skips_last_page": ("const int p1 = min(p0 + p.pps, n_pages);",
                              "const int p1 = min(p0 + p.pps, n_pages) - 1;"),
    # The combine adds split 1's (l, acc) without its exp2(m_s - m) rescale.
    "combine_without_rescale": (
        "w[s] = mv == -INFINITY ? 0.f : exp2f(mv - mx);",
        "w[s] = mv == -INFINITY ? 0.f : s == 1 ? 1.f : exp2f(mv - mx);"),
    # A warp's second token of each pair takes the first one's V row.
    "second_token_v_one_off": ("load_n<DPL>(vt + tok(u) * HDP + lane * DPL, vf);",
                               "load_n<DPL>(vt + tok(u & ~1) * HDP + lane * DPL, vf);"),
}


def measure() -> list:
    """Both checks of the kernel on the current PYTHONPATH's repro_torch."""
    import numpy as np
    import torch
    from repro_torch.kernels.paged_attention import ops, ref

    out = []
    cases = [c for c in chip_smoke.PAGED_CASES if c[0] in ("phase", "long8", "glm")]
    for case, lens, cols, heads in cases:
        for pool in ("bfloat16", "int8"):
            q, kp, vp, ks, vs, bt, ln = chip_smoke.paged_inputs(torch, np, lens, pool,
                                                                cols=cols, heads=heads)
            live = ln > 0
            got = ops.paged_attention(q, kp, vp, bt, ln, ks, vs)[live]
            want = ref.paged_attention_ref(q, kp, vp, bt, ln, ks, vs)[live]
            glob = float((got.float() - want.float()).abs().max() / want.float().abs().max())
            out.append(dict(case=f"{case} {pool}", glob=glob,
                            elem=chip_smoke.elem_err(torch, got, want),
                            finite=bool(torch.isfinite(got).all())))
            del q, kp, vp, ks, vs, got, want
            torch.cuda.empty_cache()
    return out


def main() -> int:
    if sys.argv[1:] == ["--measure"]:
        print("RESULT " + json.dumps(measure()), flush=True)
        return 0
    ok = check_faults(FAULTS, chip_smoke.PAGED_TOL, chip_smoke.PAGED_ELEM_TOL["bfloat16"],
                      "paged_attention.cu", __file__)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
