#!/usr/bin/env python3
"""How fast a GramStore in host memory fills and is read back, on one
H100: an fp64 tensor of 1.64 GB (mistral-7b's largest Gram, the 14336-wide
``down`` input) and of 8.59 GB copied off the card into new host memory
by ``.to("cpu")`` and by ``core.compress.host_copy`` (the host store's
copy: a pinned staging buffer, a multi-threaded host copy), the two
steps of the latter apart (into pinned memory; faulting new host pages
in with ``zero_`` on every core), and read back onto the card from
pageable host memory (``GramStore.gram(key, device=)``).  Each copy is
checked bit for bit.  Prints one JSON object.

    python3 tools/host_copy_probe.py
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("host_copy_probe: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.compress import host_copy

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    rows = {}
    for label, n in (("down_gram", 14336), ("8GiB", 32768)):
        x = torch.randn((n, n), dtype=torch.float64, device="cuda")
        nbytes = x.numel() * 8
        row = {"bytes": nbytes}
        for name, fn in (("to_cpu", lambda: x.to("cpu")), ("host_copy", lambda: host_copy(x))):
            out, s = timed(fn)
            row[name] = {"s": s, "GB_per_s": nbytes / s / 1e9, "exact": bool(torch.equal(
                out, x.cpu()))}
            del out
        pinned, s = timed(lambda: torch.empty(x.shape, dtype=x.dtype, pin_memory=True))
        _, s2 = timed(lambda: pinned.copy_(x))
        row["into_pinned"] = {"alloc_s": s, "copy_GB_per_s": nbytes / s2 / 1e9}
        del pinned
        fresh, s = timed(lambda: torch.empty(x.shape, dtype=x.dtype).zero_())
        row["fault_in_zero"] = {"s": s, "GB_per_s": nbytes / s / 1e9}
        _, s = timed(lambda: fresh.copy_(x))
        row["into_faulted"] = {"s": s, "GB_per_s": nbytes / s / 1e9}
        back, s = timed(lambda: fresh.to("cuda"))
        row["to_card"] = {"s": s, "GB_per_s": nbytes / s / 1e9,
                          "exact": bool(torch.equal(back, x))}
        rows[label] = row
        del x, fresh, back
        torch.cuda.empty_cache()
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi.strip(),
                      "torch_threads": torch.get_num_threads(), "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
