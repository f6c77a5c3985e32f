#!/usr/bin/env python3
"""chip_smoke.py's nested phase on two trees of this repository, on one
card, in turns: the other tree, this one, this one, the other.

    python3 tools/nested_ab.py OTHER_ROOT

OTHER_ROOT is another checkout (for example the parent commit, unpacked with
``git archive`` into a directory that .gitignore lists).  Each run is a
process of its own that builds that tree's kernels and runs its
``chip_smoke.nested_phase``.  Prints each row's profiled device ms in the
four runs and the ratio of this tree's mean to the other's, for every
(dtype, target, rows) both trees measure, and writes
chiprun_out/nested_ab.json.  Needs one H100 and the CUDA toolkit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = """
import json, sys, torch
sys.path[:0] = [{root!r}, {src!r}]
import chip_smoke
from repro_torch.kernels.nested_lowrank import ops, ref
torch.backends.cuda.matmul.allow_tf32 = False
print("RESULT " + json.dumps(chip_smoke.nested_phase(torch, ops, ref)), flush=True)
"""


def nested_rows(root: str) -> list:
    root = os.path.abspath(root)
    p = subprocess.run([sys.executable, "-c", RUN.format(root=root, src=os.path.join(root, "src"))],
                       cwd=root, capture_output=True, text=True, timeout=900)
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("RESULT ")]
    if p.returncode or not lines:
        raise RuntimeError(f"{root}: exit {p.returncode}\n{p.stdout[-2000:]}{p.stderr[-2000:]}")
    return json.loads(lines[-1][len("RESULT "):])


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = sys.argv[1]
    order = (("other", other), ("this", ROOT), ("this", ROOT), ("other", other))
    runs = [(name, nested_rows(root)) for name, root in order]
    key = lambda r: (r["dtype"], r["target"], r["M"])  # noqa: E731
    table = {}
    for i, (name, rows) in enumerate(runs):
        for r in rows:
            table.setdefault(key(r), {}).setdefault(name, []).append(
                dict(run=i, device_ms=r["device_ms"], ran=r["ran"], ok=r["ok"]))
    out = []
    for k, by in sorted(table.items()):
        if set(by) != {"other", "this"}:
            continue
        mean = {n: sum(x["device_ms"] for x in v) / len(v) for n, v in by.items()}
        ratio = mean["this"] / mean["other"]
        out.append(dict(dtype=k[0], target=k[1], M=k[2], other=by["other"], this=by["this"],
                        ratio=ratio))
        print(f"{k[0]:8s} {k[1]:4s} M={k[2]:<4d} other {by['other'][0]['ran']:6s} "
              + " ".join(f"{x['device_ms']:.4f}" for x in by["other"])
              + f"  this {by['this'][0]['ran']:6s} "
              + " ".join(f"{x['device_ms']:.4f}" for x in by["this"])
              + f"  this/other {ratio:.3f}", flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "nested_ab.json"), "w") as f:
        json.dump({"other": os.path.abspath(other), "rows": out,
                   "ok": all(x["ok"] for _, rows in runs for x in rows)}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
