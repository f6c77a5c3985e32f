"""Time ``torch.linalg.svd``'s cuSOLVER drivers at the compression shapes
and check each against ``gesvd`` (the QR-based reference driver).

    python -m repro_torch.launch.svd_drivers [--shapes 4096x4096,14336x4096]

For each (m, n) it draws a float64 matrix with a decaying spectrum (as
whitened LLM weights have), runs every driver once for warm-up and once
timed, and reports the seconds and the relative Frobenius difference of the
rank-k truncation (k = the ratio-0.2 rank of that shape) from gesvd's.
Prints one JSON object per shape.  Needs the card.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.core.ratio import rank_for_ratio

DRIVERS = ("gesvd", "gesvdj", "gesvda")


def _truncated(a: torch.Tensor, k: int, driver: str):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u, s, vt = torch.linalg.svd(a, full_matrices=False, driver=driver)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return dt, (u[:, :k] * s[:k]) @ vt[:k]


def probe(m: int, n: int, seed: int = 0) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    decay = torch.exp(-torch.arange(n, device="cuda", dtype=torch.float64) / (n / 8))
    a = torch.randn((m, n), generator=gen, device="cuda", dtype=torch.float64) * decay
    k = rank_for_ratio(m, n, 0.2)
    out = {"shape": [m, n], "rank": k, "drivers": {}}
    ref = None
    for driver in DRIVERS:
        if driver == "gesvda" and m < n:
            a_use = a.T  # gesvda takes tall matrices only
        else:
            a_use = a
        try:
            _truncated(a_use[:256, :256].contiguous(), 8, driver)  # warm-up
            dt, rec = _truncated(a_use, k, driver)
        except RuntimeError as e:  # a driver may refuse a shape
            out["drivers"][driver] = {"error": str(e)[:200]}
            continue
        if a_use is not a:
            rec = rec.T
        if ref is None:
            ref = rec
        err = float(torch.linalg.norm(rec - ref) / torch.linalg.norm(ref))
        out["drivers"][driver] = {"seconds": dt, "rel_diff_vs_gesvd": err}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shapes", default="4096x4096,14336x4096,1024x4096")
    args = ap.parse_args(argv)
    print(torch.cuda.get_device_name(0))
    for spec in args.shapes.split(","):
        m, n = (int(v) for v in spec.split("x"))
        print(json.dumps(probe(m, n)), flush=True)


if __name__ == "__main__":
    main()
