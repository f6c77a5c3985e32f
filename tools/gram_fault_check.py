#!/usr/bin/env python3
"""Planted faults in the gram kernels against chip_smoke.py's checks of
them: the global one (max |kernel - plain| <= GRAM_TOL x max |plain|), the
per-element one (GRAM_ELEM_TOL x sqrt(plain_ii plain_jj) for every entry,
and G exactly equal to G^T) and, for fp32 rows, the fp64 gate (the
kernel's per-element error against an fp64 Gram at most GRAM_GATE times
the plain fp32 matmul's).

    python3 tools/gram_fault_check.py

Needs one H100 and the CUDA toolkit.  Each fault is a one-line patch of
``csrc/gram.cu`` in a temporary copy of ``repro_torch`` (the checkout is
never touched), built and run in its own process on the gram phase's
shapes in bf16 (the mma kernel) and fp32 (the tf32x3 kernel), with its
outlier channels; two card-test cases with ragged rows and columns; the
gram batched phase's shapes (bf16 and fp32) and a batched fp32 case over
several row splits.  Prints one line per fault and case, and exits non-zero
unless the unpatched kernels pass every check everywhere, every fault fails
the per-element check or the fp64 gate somewhere, and the dropped lo
products (a single-pass TF32 Gram) fail the fp64 gate.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402
from flash_fault_check import run_variant  # noqa: E402

FAULTS = {
    # mma: an off-diagonal tile skips its last ring stage (the last 32 rows).
    "offdiag_last_stage_skipped": (
        "    const uint32_t si = ring + (ch % STAGES) * STAGE, sj = diag ? si : si + SLAB;",
        "    if (!diag && ch == nch - 1) continue;\n"
        "    const uint32_t si = ring + (ch % STAGES) * STAGE, sj = diag ? si : si + SLAB;"),
    # mma: an off-diagonal tile's mirror is stored one column to the right.
    "mirror_shifted_one_column": ("tile[c * TPT + r] = acc[mi][nj][e];",
                                  "tile[c * TPT + r + 1] = acc[mi][nj][e];"),
    # mma: a diagonal tile's mirror reads its upper half one row off.  (Its
    # lower half taken from the mma fragments instead changes no output on
    # the H100: they came out bit-symmetric, so no check of G can see it.)
    "diag_mirror_one_row_off": ("if (r > c) tile[r * TP + c] = tile[c * TP + r];",
                                "if (r > c) tile[r * TP + c] = tile[(c + 1) * TP + r];"),
    # Batched form, every kernel: the expert stride of the rows one row
    # short (expert e reads from e rows early: the previous expert's last
    # rows).
    "expert_stride_off_by_one": ("  return {e * rows * n, e * n * n, e * n};",
                                 "  return {e * (rows - 1) * n, e * n * n, e * n};"),
    # tf32x3: the lo products dropped, a single-pass TF32 Gram: within
    # GRAM_ELEM_TOL of the plain version but at 33- and 240-row taps, and
    # within GRAM_TOL at llava's and whisper's rows; the fp64 gate must
    # catch it everywhere.
    "tf32x3_lo_products_dropped": (
        "          mma_tf32(acc, al, bh[nj][0], bh[nj][1]);\n"
        "          mma_tf32(acc, ah, bl[nj][0], bl[nj][1]);\n", ""),
    # tf32x3: the reduce leaves out the last row split's partial.
    "tf32x3_last_split_skipped": ("    for (int sp = 1; sp < splits; ++sp) {",
                                  "    for (int sp = 1; sp < splits - 1; ++sp) {"),
    # tf32x3: the mirror of G takes its value from the next column.
    "tf32x3_mirror_shifted_one_column": (
        "g[(size_t)j * n + i] = tile[r * ELD + c];",
        "g[(size_t)j * n + i] = tile[r * ELD + c + 1];"),
}
# Faults the fp64 gate must catch.
GATE_FAULTS = ("tf32x3_lo_products_dropped",)


def measure() -> list:
    """The checks of the kernels on the current PYTHONPATH's repro_torch."""
    import torch
    from repro_torch.kernels.gram import ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = []
    for dname in ("bfloat16", "float32"):
        cases += [(f"phase {r} x {n}", (r, n), dname) for r, n in chip_smoke.GRAM_SHAPES]
        cases += [("card 33 x 136", (33, 136), dname), ("card 4100 x 4104", (4100, 4104), dname)]
    cases += [(f"batched {e} x {r} x {n}", (e, r, n), "bfloat16")
              for e, r, n in chip_smoke.GRAM_BATCHED_SHAPES]
    cases += [(f"batched {e} x {r} x {n}", (e, r, n), "float32")
              for e, r, n in (*chip_smoke.GRAM_BATCHED_FP32_SHAPES, (4, 2048, 256))]
    out = []
    for name, shape, dname in cases:
        x = torch.randn(shape, generator=gen, device="cuda")
        x[..., ::97] *= 20.0  # outlier channels, as in the gram phases
        x = x.to(getattr(torch, dname))
        fn, ref_fn = ((ops.gram_accumulate_batched, ref.gram_accumulate_batched_ref)
                      if x.ndim == 3 else (ops.gram_accumulate, ref.gram_accumulate_ref))
        kernel = "mma" if dname == "bfloat16" else "tf32x3"
        before = getattr(ops, f"{kernel}_launches")
        got, _ = fn(x)
        want, _ = ref_fn(x)
        torch.cuda.synchronize()
        if getattr(ops, f"{kernel}_launches") != before + 1:
            raise RuntimeError(f"{name}: the {kernel} kernel did not run")
        glob = float((got - want).abs().max() / want.abs().max())
        row = dict(case=f"{name} {dname[:4]}", glob=glob, elem=ref.gram_elem_err(got, want),
                   symmetric=bool(torch.equal(got, got.transpose(-1, -2))),
                   finite=bool(torch.isfinite(got).all()))
        if dname == "float32":
            row.update(chip_smoke.gram_fp64_gate(torch, ref, x, got, want))
        out.append(row)
        del got, want
    return out


def main() -> int:
    if sys.argv[1:] == ["--measure"]:
        print("RESULT " + json.dumps(measure()), flush=True)
        return 0
    g_tol, e_tol = chip_smoke.GRAM_TOL, chip_smoke.GRAM_ELEM_TOL
    ok = True
    for name, patch in [("unpatched", None), *FAULTS.items()]:
        rows = run_variant(name, patch, "gram.cu", __file__)
        caught = dict(glob=False, elem=False, gate=False)
        for r in rows:
            g_fail = not r["finite"] or r["glob"] > g_tol
            e_fail = not r["finite"] or r["elem"] > e_tol or not r["symmetric"]
            gate_fail = "fp64_ok" in r and not r["fp64_ok"]
            caught = dict(glob=caught["glob"] or g_fail, elem=caught["elem"] or e_fail,
                          gate=caught["gate"] or gate_fail)
            gate = "" if "fp64_ok" not in r else (
                f"  fp64 {r['fp64_err']:.3e} (plain {r['plain_fp64_err']:.3e}, gate "
                f"{r['fp64_gate']:g}x) {'FAIL' if gate_fail else 'pass'}")
            print(f"{name:33s} {r['case']:30s} global {r['glob']:.4e} (tol {g_tol:.0e}) "
                  f"{'FAIL' if g_fail else 'pass'}  elem {r['elem']:.4e} (tol {e_tol:.0e}) "
                  f"symmetric={r['symmetric']} {'FAIL' if e_fail else 'pass'}{gate}", flush=True)
        print(f"{name:33s} caught by the global check: {caught['glob']}; by the per-element "
              f"check: {caught['elem']}; by the fp64 gate: {caught['gate']}", flush=True)
        if patch is None:
            ok = ok and not any(caught.values())
        elif name in GATE_FAULTS:
            ok = ok and caught["gate"]
        else:
            ok = ok and (caught["elem"] or caught["gate"])
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
