"""Streaming Gram accumulation from model activation taps.

For each tapped activation x (..., n):  G += x^T x (fp32 product), a +=
sum |x|, c += rows — accumulated on the device into the GramStore's fp64
sums (the reference copies every per-batch Gram to the host as fp64).  The
Gram is a plain ``torch.matmul`` in full fp32: TF32 must stay off to match
the reference's ``Precision.HIGHEST`` (``calibration_precision`` sets it).

Tap names from stacked groups look like "g0/rep3/sub0.mlp.in";
``normalize_tap`` rewrites them to the per-layer GramStore key
"g0/sub0.mlp.in/3" (plus the shared key "g0/sub0.mlp.in" over all layers).
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import torch

from repro_torch.core.compress import GramStore

_REP_RE = re.compile(r"/rep(\d+)/")


def calibration_precision() -> None:
    """Full-fp32 matmuls on the card (no TF32), as the reference's HIGHEST."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def normalize_tap(name: str) -> Tuple[str, str]:
    """(base_key, layer suffix) — suffix is "" for unstacked taps."""
    m = _REP_RE.search(name)
    if not m:
        return name, ""
    return _REP_RE.sub("/", name), m.group(1)


def gram_update(x: torch.Tensor):
    """x (..., n) -> (G (n, n) fp32, sum |x| (n,) fp32, row count)."""
    flat = x.reshape(-1, x.shape[-1]).float()
    return flat.T @ flat, flat.abs().sum(0), float(flat.shape[0])


def accumulate_taps(store: GramStore, taps: Dict[str, torch.Tensor]) -> None:
    """Fold one batch of dense taps into ``store``."""
    for name, x in taps.items():
        base, suffix = normalize_tap(name)
        g, a, c = gram_update(x)
        if suffix:
            store.update(f"{base}/{suffix}", g, a, c)
        store.update(base, g, a, c)
