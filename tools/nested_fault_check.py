#!/usr/bin/env python3
"""Planted faults in the nested_lowrank bf16 kernels -- the stream kernel
(<= 16 rows) and the mma kernel (17-1024 rows), single and batched (per
expert) -- against chip_smoke.py's two checks of them: the global one (max
|kernel - plain| <= NESTED_TOL x max |plain|) and the per-element one
(NESTED_ELEM_TOL, relative to |plain| plus the rms of the row).

    python3 tools/nested_fault_check.py

Needs one H100 and the CUDA toolkit.  Each fault is a one-line patch of
``csrc/nested_lowrank.cu`` in a temporary copy of ``repro_torch`` (the
checkout is never touched), built and run in its own process on the nested
phase's bf16 shapes at 1, 8 and 16 rows (stream) and 17, 64, 200 and 512
rows (mma), on two card-test cases of each kernel with u and u2 at odd
element offsets, and on the nested batched phase's bf16 cases at their
own expert counts and ranks (moonshot's 64 experts, deepseek-v3's 16 and
256, jamba's 8 and 16; 8 rows on the stream kernel, 55-960 on the mma
kernel), every expert holding all its rows.  Prints one line per fault and
case, and
exits non-zero unless the unpatched kernel passes both checks everywhere
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
    # Rows whose shift is odd read their columns one element early.
    "odd_shift_off_by_one": ("if (SHIFT && (sh & 1)) {", "if (SHIFT && false) {"),
    # The last split-K slice of every factor drops its final ring stage.
    "last_slice_stage_dropped": (
        "const int nst = (krows + kSK - 1) / kSK;",
        "const int nst = (krows + kSK - 1) / kSK - (kbeg + krows == kd);"),
    # The first column tile of u2 (and, in phase 2, v2's first tile) reads u (v).
    "first_u2_tile_reads_u": ("const bf16* __restrict__ b = second ? s1.b : s0.b;",
                              "const bf16* __restrict__ b = second && tile > 0 ? s1.b : s0.b;"),
    # mma: the last block stage drops its last 16-deep step.
    "mma_last_k16_step_skipped": ("for (int kk = 0; kk < kMK / 16; ++kk) {",
                                  "for (int kk = 0; kk < kMK / 16 - (st == nst - 1); ++kk) {"),
    # mma: the re-pack ignores odd shifts (those rows read one element early).
    "mma_odd_shift_ignored": ("if (sh & 1) word = __byte_perm(word, w[wl + 1], 0x5432);",
                              "if (false) word = __byte_perm(word, w[wl + 1], 0x5432);"),
    # mma: the second m16 tile of each pair (padded at 17 rows) is stored to
    # the first one's rows.
    "mma_second_m16_to_first_rows": ("const int row = wm * 64 + 16 * i + gid + 8 * h;",
                                     "const int row = wm * 64 + 16 * (i & ~1) + gid + 8 * h;"),
    # Batched form, both bf16 kernels: the expert stride of every factor one
    # row short (expert e reads its factors e rows early).
    "expert_stride_off_by_one": ("  return b + (size_t)blockIdx.y * kd * nc;",
                                 "  return b + (size_t)blockIdx.y * (kd - 1) * nc;"),
}
ROWS = (1, 8, 16, 17, 64, 200, 512)


def measure() -> list:
    """Both checks of the kernel on the current PYTHONPATH's repro_torch."""
    import torch
    from repro_torch.kernels.nested_lowrank import ops, ref

    def mk(g, *shape, s):
        return (torch.randn(shape, generator=g, device="cuda") * s).to(torch.bfloat16)

    def at_offset(t, off):
        buf = torch.zeros(off + t.numel() + 8, dtype=t.dtype, device=t.device)
        view = buf[off:off + t.numel()].view(t.shape)
        view.copy_(t)
        return view

    cases = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for target, k_in, n, r in chip_smoke.NESTED_SHAPES:
        k1 = int(round(0.95 * r))
        u, u2 = mk(gen, k_in, k1, s=k_in ** -0.5), mk(gen, k_in, r - k1, s=k_in ** -0.5)
        v, v2 = mk(gen, k1, n, s=r ** -0.5), mk(gen, r - k1, n, s=r ** -0.5)
        for m in ROWS:
            cases.append((f"phase {target} M={m}", mk(gen, m, k_in, s=1.0), u, v, u2, v2))
    for m, k_in, k1, k2 in ((8, 320, 61, 3), (16, 14336, 2421, 127), (17, 328, 61, 3),
                            (200, 14336, 2421, 127)):
        g = torch.Generator(device="cuda").manual_seed(m * 1000 + k1 + k_in)
        x, v, v2 = (mk(g, m, k_in, s=k_in ** -0.5), mk(g, k1, 776, s=k1 ** -0.5),
                    mk(g, k2, 776, s=k2 ** -0.5))
        u = at_offset(mk(g, k_in, k1, s=k_in ** -0.5), 3)
        u2 = at_offset(mk(g, k_in, k2, s=k_in ** -0.5), 5)
        cases.append((f"card M={m} K={k_in} k={k1}+{k2}", x, u, v, u2, v2))
    for case, e, m, k_in, n, k1, k2, dname, _, _ in chip_smoke.NESTED_BATCHED_CASES:
        if dname != "bfloat16":
            continue
        g = torch.Generator(device="cuda").manual_seed(m + k_in)
        cases.append((f"batched {case} E={e} C={m}", mk(g, e, m, k_in, s=1.0),
                      mk(g, e, k_in, k1, s=k_in ** -0.5), mk(g, e, k1, n, s=(k1 + k2) ** -0.5),
                      mk(g, e, k_in, k2, s=k_in ** -0.5), mk(g, e, k2, n, s=(k1 + k2) ** -0.5)))
    out = []
    for name, *args in cases:
        before = (ops.stream_launches, ops.mma_launches)
        batched = args[0].ndim == 3
        fn, ref_fn = ((ops.nested_lowrank_matmul_batched, ref.nested_lowrank_matmul_batched_ref)
                      if batched else (ops.nested_lowrank_matmul, ref.nested_lowrank_matmul_ref))
        got = fn(*args)
        want = ref_fn(*args)
        torch.cuda.synchronize()
        stream = args[0].shape[-2] <= ops.STREAM_ROWS
        if (ops.stream_launches, ops.mma_launches) != (before[0] + stream,
                                                       before[1] + (not stream)):
            raise RuntimeError(f"{name}: the planned bf16 kernel did not run")
        glob = float((got.float() - want.float()).abs().max() / want.float().abs().max())
        out.append(dict(case=name, glob=glob, elem=chip_smoke.elem_err(torch, got, want),
                        finite=bool(torch.isfinite(got).all())))
    return out


def main() -> int:
    if sys.argv[1:] == ["--measure"]:
        print("RESULT " + json.dumps(measure()), flush=True)
        return 0
    ok = check_faults(FAULTS, chip_smoke.NESTED_TOL["bfloat16"],
                      chip_smoke.NESTED_ELEM_TOL["bfloat16"], "nested_lowrank.cu", __file__)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
