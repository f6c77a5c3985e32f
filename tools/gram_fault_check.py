#!/usr/bin/env python3
"""Planted faults in the gram mma kernel (bf16 taps, single and batched per
expert) against chip_smoke.py's two checks of it: the global one (max
|kernel - plain| <= GRAM_TOL x max |plain|) and the per-element one
(GRAM_ELEM_TOL x sqrt(plain_ii plain_jj) for every entry, and G exactly
equal to G^T).

    python3 tools/gram_fault_check.py

Needs one H100 and the CUDA toolkit.  Each fault is a one-line patch of
``csrc/gram.cu`` in a temporary copy of ``repro_torch`` (the checkout is
never touched), built and run in its own process on the gram phase's bf16
shapes (with its outlier channels), two card-test cases with ragged rows
and columns, and the gram batched phase's (64 experts, 240 rows) shapes.  Prints one line per fault and case, and exits non-zero unless
the unpatched kernel passes both checks everywhere and every fault fails
the per-element check somewhere.
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
    # An off-diagonal tile skips its last ring stage (the last 32 rows).
    "offdiag_last_stage_skipped": (
        "    const uint32_t si = ring + (ch % STAGES) * STAGE, sj = diag ? si : si + SLAB;",
        "    if (!diag && ch == nch - 1) continue;\n"
        "    const uint32_t si = ring + (ch % STAGES) * STAGE, sj = diag ? si : si + SLAB;"),
    # An off-diagonal tile's mirror is stored one column to the right.
    "mirror_shifted_one_column": ("tile[c * TPT + r] = acc[mi][nj][e];",
                                  "tile[c * TPT + r + 1] = acc[mi][nj][e];"),
    # A diagonal tile's mirror reads its upper half one row off.  (Its lower
    # half taken from the mma fragments instead changes no output on the
    # H100: they came out bit-symmetric, so no check of G can see it.)
    "diag_mirror_one_row_off": ("if (r > c) tile[r * TP + c] = tile[c * TP + r];",
                                "if (r > c) tile[r * TP + c] = tile[(c + 1) * TP + r];"),
    # Batched form: the expert stride of the rows one row short (expert e
    # reads from e rows early: the previous expert's last rows).
    "expert_stride_off_by_one": ("  return {e * rows * n, e * n * n, e * n};",
                                 "  return {e * (rows - 1) * n, e * n * n, e * n};"),
}


def measure() -> list:
    """Both checks of the kernel on the current PYTHONPATH's repro_torch."""
    import torch
    from repro_torch.kernels.gram import ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(2)
    shapes = [(f"phase {r} x {n}", (r, n)) for r, n in chip_smoke.GRAM_SHAPES]
    shapes += [("card 33 x 136", (33, 136)), ("card 4100 x 4104", (4100, 4104))]
    shapes += [(f"batched {e} x {r} x {n}", (e, r, n)) for e, r, n in
               chip_smoke.GRAM_BATCHED_SHAPES]
    out = []
    for name, shape in shapes:
        x = torch.randn(shape, generator=gen, device="cuda")
        x[..., ::97] *= 20.0  # outlier channels, as in the gram phases
        x = x.to(torch.bfloat16)
        fn, ref_fn = ((ops.gram_accumulate_batched, ref.gram_accumulate_batched_ref)
                      if x.ndim == 3 else (ops.gram_accumulate, ref.gram_accumulate_ref))
        before = ops.mma_launches
        got, _ = fn(x)
        want, _ = ref_fn(x)
        torch.cuda.synchronize()
        if ops.mma_launches != before + 1:
            raise RuntimeError(f"{name}: the mma kernel did not run")
        glob = float((got - want).abs().max() / want.abs().max())
        out.append(dict(case=name, glob=glob, elem=ref.gram_elem_err(got, want),
                        symmetric=bool(torch.equal(got, got.transpose(-1, -2))),
                        finite=bool(torch.isfinite(got).all())))
        del got, want
    return out


def main() -> int:
    if sys.argv[1:] == ["--measure"]:
        print("RESULT " + json.dumps(measure()), flush=True)
        return 0
    ok = check_faults(FAULTS, chip_smoke.GRAM_TOL, chip_smoke.GRAM_ELEM_TOL, "gram.cu",
                      __file__)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
