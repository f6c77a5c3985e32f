#!/usr/bin/env python3
"""Planted faults in the bf16 flash_attention kernels, against chip_smoke.py's
checks of them.

    python3 tools/flash_fault_check.py [forward|backward]

forward: faults in ``csrc/flash_attention.cu``'s tensor-core kernel against
the global check (max |kernel - plain| <= FLASH_TOL x max |plain|) and the
per-element one (FLASH_ELEM_TOL, relative to |plain| plus the rms of the
row), on the flash phase's bf16 shapes and a (1, 2048) G = 8 case.

backward: faults in ``csrc/flash_attention_bwd.cu``'s tensor-core kernels
(dK/dV and dQ) against the per-element check of dq, dk and dv
(FLASH_BWD_ELEM_TOL on ``bwd_elem_err``; the global column is max |kernel -
plain| / max |plain| over the three, held to the same number), on the
flash_bwd phase's bf16 shapes (its inputs) and a (2, 300) 8/2 case at hd 72
(padded to 128 in shared memory), whose inputs lie in buffers with slack
after them so that a copy past hd reads memory that exists.

Needs one H100 and the CUDA toolkit.  Each fault is a one-line patch in a
temporary copy of ``repro_torch`` (the checkout is never touched), built
and run in its own process.  Prints one line per fault and case, and exits
non-zero unless the unpatched kernels pass every check everywhere and
every fault fails the per-element check somewhere.  With no argument, both.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

MASK = "if (crosses && k0 + 8 * j + 2 * tig + (e & 1) > lim[e / 2]) s[j][e] = NEG_INF;"
FAULTS = {
    # The first key of every KV tile from tile 16 on (key 1024 at hd 128) dropped.
    "drop_key_late_tiles": (MASK, "if ((crosses && k0 + 8 * j + 2 * tig + (e & 1) > lim[e / 2])"
                            " || (t >= 16 && j == 0 && tig == 0 && !(e & 1))) s[j][e] = NEG_INF;"),
    # The diagonal key masked off in tiles from 16 on: a mask edge one key early.
    "mask_edge_late_tiles": (MASK, "if (crosses && k0 + 8 * j + 2 * tig + (e & 1) > lim[e / 2]"
                             " - (t >= 16)) s[j][e] = NEG_INF;"),
    # No barrier before a half of the K/V ring is refilled: a race.
    "ring_race": ("        cp_async_wait<0>();\n        __syncthreads();\n",
                  "        cp_async_wait<0>();\n"),
}


BWD_FAULTS = {
    # The causal mask dropped in dK/dV: keys see queries before them.
    "dkdv_no_causal_mask": ("if (masked && (key[e >> 1] > qpos || qpos >= s_len)) p = 0.f;",
                            "if (masked && qpos >= s_len) p = 0.f;"),
    # The causal mask dropped in dQ.
    "dq_no_causal_mask": ("if (masked && kc + 8 * j + 2 * tig + (e & 1) > lim[e >> 1]) p = 0.f;",
                          "(void)masked;"),
    # P rebuilt without the row's lse.
    "dkdv_lse_not_subtracted": ("float p = exp2f(fmaf(s[j][e], scale_log2, nl));",
                                "float p = exp2f(s[j][e] * scale_log2);"),
    "dq_lse_not_subtracted": ("float p = exp2f(fmaf(s[j][e], scale_log2, -lse2[e >> 1]));",
                              "float p = exp2f(s[j][e] * scale_log2);"),
    # dS = P dP, without D.
    "dkdv_d_not_subtracted": ("dp[j][e] = p * (dp[j][e] - dd);", "dp[j][e] = p * dp[j][e];"),
    "dq_d_not_subtracted": ("dp[j][e] = p * (dp[j][e] - dd[e >> 1]);",
                            "dp[j][e] = p * dp[j][e];"),
    # A KV head paired with the next KV head's query heads (dK/dV), or a
    # query head reading the next KV head's K and V (dQ).
    "dkdv_wrong_kv_head": ("const int q0 = (kt + i / g) * TR, h = kvh * g + i % g;",
                           "const int q0 = (kt + i / g) * TR, h = ((kvh + 1) % hkv) * g + i % g;"),
    "dq_wrong_kv_head": ("const size_t off = (((size_t)b * s_len + k0) * hkv + kvh) * hd;",
                         "const size_t off = (((size_t)b * s_len + k0) * hkv + (kvh + 1) % hkv)"
                         " * hd;"),
    # The dims past hd of streamed and resident tiles copied, not zero-filled.
    "hd_tail_not_zero_filled": ("const bool lc_live = lc * 8 < hd;", "const bool lc_live = true;"),
}


def measure_bwd() -> list:
    """The backward's checks on the current PYTHONPATH's repro_torch."""
    import torch
    from repro_torch.kernels.flash_attention import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(5)  # as chip_smoke's flash_bwd phase
    cases = []
    for dname, b, s, hq, hkv, hd in chip_smoke.FLASH_BWD_SHAPES:
        def mk(h):
            return torch.randn((b, s, h, hd), generator=gen, device="cuda").to(
                getattr(torch, dname))
        args = (mk(hq), mk(hkv), mk(hkv), mk(hq))
        if dname == "bfloat16":
            cases.append((f"phase ({b}, {s}) {hq}/{hkv} hd {hd}", args))
    b, s, hq, hkv, hd = 2, 300, 8, 2, 72
    gen = torch.Generator(device="cuda").manual_seed(72)

    def slack(h):
        n = b * s * h * hd
        buf = torch.randn(n + 4096, generator=gen, device="cuda").to(torch.bfloat16)
        return buf[:n].view(b, s, h, hd)
    cases.append((f"slack ({b}, {s}) {hq}/{hkv} hd {hd}", (slack(hq), slack(hkv), slack(hkv),
                                                           slack(hq))))
    out = []
    for name, (q, k, v, dout) in cases:
        o, lse = ref.flash_attention_fwd_ref(q, k, v)
        got = ops.backward(q, k, v, o, lse, dout)
        want = ref.flash_attention_bwd_ref(q, k, v, o, lse, dout)
        out.append(dict(case=name, glob=max(float((x.float() - w.float()).abs().max()
                                                  / w.float().abs().max())
                                            for x, w in zip(got, want)),
                        elem=max(chip_smoke.bwd_elem_err(torch, x, w) for x, w in zip(got, want)),
                        finite=all(bool(torch.isfinite(x).all()) for x in got)))
        del o, lse, got, want
        torch.cuda.empty_cache()
    return out


def measure() -> list:
    """Both checks of the kernel on the current PYTHONPATH's repro_torch."""
    import torch
    from repro_torch.kernels.flash_attention import ops, ref

    cases = []
    gen = torch.Generator(device="cuda").manual_seed(3)  # as chip_smoke's flash phase
    for b, s, hq, hkv in chip_smoke.FLASH_SHAPES:
        cases.append((f"phase ({b}, {s}) {hq}/{hkv}", b, s, hq, hkv, gen))
    cases.append(("card test (1, 2048) 16/2", 1, 2048, 16, 2,
                  torch.Generator(device="cuda").manual_seed(2048 + 8)))
    out = []
    for name, b, s, hq, hkv, g in cases:
        def mk(h):
            return torch.randn((b, s, h, 128), generator=g, device="cuda").to(torch.bfloat16)
        q, k, v = mk(hq), mk(hkv), mk(hkv)
        got = ops.flash_attention(q, k, v)
        want = ref.flash_attention_ref(q, k, v)
        glob = float((got.float() - want.float()).abs().max() / want.float().abs().max())
        out.append(dict(case=name, glob=glob, elem=chip_smoke.elem_err(torch, got, want),
                        finite=bool(torch.isfinite(got).all())))
    return out


def run_variant(name: str, patch, source: str = "flash_attention.cu",
                script: str = __file__, flag: str = "--measure") -> list:
    """``script flag``'s results on ``repro_torch`` with ``patch`` (old,
    new) applied once to ``csrc/<source>`` in a temporary copy (None: the
    checkout as it is), built and run in a process of its own."""
    env = dict(os.environ)
    tmp = None
    if patch is None:
        env["PYTHONPATH"] = os.path.join(ROOT, "src")
    else:
        tmp = tempfile.mkdtemp(prefix=f"fault_{name}_")
        shutil.copytree(os.path.join(ROOT, "src", "repro_torch"),
                        os.path.join(tmp, "repro_torch"),
                        ignore=shutil.ignore_patterns("build", "__pycache__"))
        cu = os.path.join(tmp, "repro_torch", "csrc", source)
        with open(cu) as f:
            text = f.read()
        old, new = patch
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: the line to patch is not in {source} once")
        with open(cu, "w") as f:
            f.write(text.replace(old, new))
        env["PYTHONPATH"] = tmp
    try:
        p = subprocess.run([sys.executable, os.path.abspath(script), flag], env=env,
                           capture_output=True, text=True, timeout=600)
    finally:
        if tmp:
            shutil.rmtree(tmp, ignore_errors=True)
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("RESULT ")]
    if p.returncode or not lines:
        raise RuntimeError(f"{name}: exit {p.returncode}\n{p.stdout[-2000:]}{p.stderr[-2000:]}")
    return json.loads(lines[-1][len("RESULT "):])


def check_faults(faults: dict, g_tol: float, e_tol: float, source: str = "flash_attention.cu",
                 script: str = __file__, flag: str = "--measure") -> bool:
    """Both checks on the unpatched kernel and on each fault, one line per
    case: True when the unpatched kernel passes both everywhere and every
    fault fails the per-element check somewhere.  A case that reports
    ``symmetric`` (a Gram) fails the per-element check also where an entry
    differs from its mirror."""
    ok = True
    for name, patch in [("unpatched", None), *faults.items()]:
        rows = run_variant(name, patch, source, script, flag)
        caught_g = caught_e = False
        for r in rows:
            g_fail = not r["finite"] or r["glob"] > g_tol
            e_fail = not r["finite"] or r["elem"] > e_tol or not r.get("symmetric", True)
            caught_g, caught_e = caught_g or g_fail, caught_e or e_fail
            print(f"{name:25s} {r['case']:30s} global {r['glob']:.4e} (tol {g_tol:.0e}) "
                  f"{'FAIL' if g_fail else 'pass'}  elem {r['elem']:.4e} (tol {e_tol:.4e})"
                  + ("" if "symmetric" not in r else f" symmetric={r['symmetric']}")
                  + f" {'FAIL' if e_fail else 'pass'}", flush=True)
        print(f"{name:25s} caught by the global check: {caught_g}; by the per-element "
              f"check: {caught_e}", flush=True)
        ok = ok and ((not caught_g and not caught_e) if patch is None else caught_e)
    print(json.dumps({"ok": ok}))
    return ok


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
        ok = check_faults(FAULTS, chip_smoke.FLASH_TOL["bfloat16"],
                          chip_smoke.FLASH_ELEM_TOL["bfloat16"]) and ok
    if "backward" in which:
        tol = chip_smoke.FLASH_BWD_ELEM_TOL["bfloat16"]
        ok = check_faults(BWD_FAULTS, tol, tol, "flash_attention_bwd.cu", __file__,
                          "--measure-bwd") and ok
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
