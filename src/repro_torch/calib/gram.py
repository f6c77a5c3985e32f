"""Streaming Gram accumulation from model activation taps.

For each tapped activation x (..., n):  G += x^T x (fp32 product), a +=
sum |x|, c += rows — accumulated on the device into the GramStore's fp64
sums (the reference copies every per-batch Gram to the host as fp64; a
host store here is filled a group of layers at a time, ``runner``).  The
per-batch Gram and sum |x| come from the ``gram`` kernel
(``kernels/gram``); its plain version is a full-fp32 matmul, for which TF32
must stay off to match the reference's ``Precision.HIGHEST``
(``calibration_precision`` sets it).

Tap names from stacked groups look like "g0/rep3/sub0.mlp.in";
``normalize_tap`` rewrites them to the per-layer GramStore key
"g0/sub0.mlp.in/3" (plus the shared key "g0/sub0.mlp.in" over all layers).

A MoE layer's ``expert_buf`` / ``expert_mid`` taps are zero-padded (E, C,
n) capacity buffers: each expert gets its own Gram, from the batched
``gram`` kernel (one launch for all experts), under "{base}/{layer}/{e}"
("{base}/{e}" unstacked), and the shared key ``base`` gets their sum, the
fallback for an expert that saw too few tokens.  An expert's row count is
the number of its rows with any non-zero element, as the reference counts
it (a slot left empty is all zeros).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core.compress import GramStore
from repro_torch.kernels.gram.ops import gram_accumulate, gram_accumulate_batched

_REP_RE = re.compile(r"/rep(\d+)/")
EXPERT_TAPS = ("expert_buf", "expert_mid")  # (E, C, n) capacity buffers


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


def tap_layer(name: str) -> Optional[str]:
    """The stacked layer a tap belongs to ("g0/rep3" for
    "g0/rep3/sub0.mlp.in"), or None for an unstacked tap."""
    m = _REP_RE.search(name)
    return name[:m.end() - 1] if m else None


def gram_keys(name: str, x: torch.Tensor) -> Tuple[str, List[str]]:
    """A tap's GramStore keys: (the shared key, its own keys).  An expert
    tap owns one key an expert, a stacked tap one for its layer, an
    unstacked tap none (only the shared key)."""
    base, suffix = normalize_tap(name)
    layer = f"{base}/{suffix}" if suffix else base
    if base.endswith(EXPERT_TAPS):
        return base, [f"{layer}/{e}" for e in range(x.shape[0])]
    return base, [layer] if suffix else []


def gram_update(x: torch.Tensor):
    """x (..., n) -> (G (n, n) fp32, sum |x| (n,) fp32, row count)."""
    g, a = gram_accumulate(x)
    return g, a, float(x.numel() // max(1, x.shape[-1]))


def accumulate_taps(store: GramStore, taps: Dict[str, torch.Tensor],
                    telemetry=None) -> Dict[str, float]:
    """Fold one batch of dense taps into ``store``; returns the rows folded
    per normalized tap.

    ``telemetry`` (``repro_torch.obs.compression.CompressionTelemetry``)
    gets the cheap per-batch signal only: those rows.  The expensive
    per-tap statistics run once at the end of calibration
    (``runner.collect_grams``)."""
    tap_rows: Dict[str, float] = {}
    for name, x in taps.items():
        base, own = gram_keys(name, x)
        if base.endswith(EXPERT_TAPS):
            g, a = gram_accumulate_batched(x)
            counts = (x != 0).any(-1).sum(1).tolist()  # one host copy per tap
            store.update_stacked(own, g, a, counts)
            # The shared key's fp64 sum over experts, one expert at a time:
            # sum(dtype=float64) would first cast all of g ((E, n, n): 12.3
            # GiB for 8 experts at n 14336).
            g_all = g[0].to(torch.float64, copy=True)
            for g_e in g[1:]:
                g_all += g_e
            store.update(base, g_all, a.sum(0, dtype=torch.float64), float(sum(counts)))
            del g, g_all
            tap_rows[base] = tap_rows.get(base, 0.0) + float(sum(counts))
            continue
        g, a, c = gram_update(x)
        for key in own:
            store.update(key, g, a, c)
        store.update(base, g, a, c)
        del g  # an fp32 Gram of a 14336-wide tap is 822 MB
        tap_rows[base] = tap_rows.get(base, 0.0) + c
    if telemetry is not None and telemetry.enabled:
        telemetry.on_calib_batch(tap_rows)
    return tap_rows
