"""Shape-level compression: a param tree -> the factored tree's shapes.

Sizing a compressed deployment needs only the factored parameters' shapes,
not the decompositions.  This mirrors ``core.compress.compress_params``
with the same plan and rank machinery, on ``device="meta"`` tensors: the
input leaves may be real or meta tensors (only their shapes and dtypes are
read), and every factored leaf comes back as a meta tensor holding no
memory.  Nested methods (nsvd*, nid*) split each rank by ``split_rank``.
``calibration_bytes`` sizes what a calibration holds on the device (the
weights and the fp64 GramStore) from one tapped forward on meta tensors.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch

from repro_torch.core.nsvd import split_rank
from repro_torch.core.plan import CompressionConfig, build_plan


def _meta(tree):
    if isinstance(tree, Mapping):
        return {k: _meta(v) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=tree.dtype, device="meta")


def compressed_param_shapes(model, params, ratio: float, method: str = "nsvd1",
                            k1_frac: float = 0.95, multiple_of: int = 128) -> Dict[str, Any]:
    """Every leaf as a meta tensor, each compressible kernel replaced by
    its factors {"u", "v"[, "u2", "v2"]} in the kernel's dtype."""
    plan = build_plan(model.compressible_targets(), CompressionConfig(
        method=method, ratio=ratio, k1_frac=k1_frac, multiple_of=multiple_of))
    out = _meta(params)
    nested = method.startswith(("nsvd", "nid"))
    for spec in plan.targets:
        node = out
        for p in spec.path[:-1]:
            node = node[p]
        dtype = node[spec.path[-1]]["kernel"].dtype
        k = plan.rank_of(spec)
        k1, k2 = split_rank(k, k1_frac) if nested else (k, 0)
        lead = tuple(spec.stacked)

        def meta(*shape):
            return torch.empty((*lead, *shape), dtype=dtype, device="meta")
        factored = {"u": meta(spec.in_dim, k1), "v": meta(k1, spec.out_dim)}
        if k2 > 0:
            factored["u2"] = meta(spec.in_dim, k2)
            factored["v2"] = meta(k2, spec.out_dim)
        node[spec.path[-1]] = factored
    return out


def tree_bytes(tree) -> int:
    """Bytes of a param tree's leaves (real or meta tensors)."""
    if isinstance(tree, Mapping):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def calibration_bytes(model) -> Dict[str, int]:
    """What calibrating ``model`` holds on the device, from one tapped
    forward on meta tensors (no memory): ``weights``, the param tree;
    ``grams``, the fp64 GramStore its taps leave (``calib.gram.gram_keys``,
    each key an (n, n) Gram and an (n,) absmean); ``batch_gram``, the
    largest fp32 Gram one tap makes and drops (a batched tap's (E, n, n)).
    None of them depends on the calibration batch's shape: a Gram's width
    is its tap's last dim, a batched tap's expert count its first."""
    from repro_torch import kernels
    from repro_torch.calib.gram import EXPERT_TAPS, gram_keys

    params = model.init(device="meta")
    taps: Dict[str, torch.Tensor] = {}
    with torch.no_grad(), kernels.plain():  # shapes only: no kernel on meta
        model.apply(params, torch.zeros((1, 8), dtype=torch.long, device="meta"),
                    mode="train", taps=taps)
    widths: Dict[str, int] = {}
    batch_gram = 0
    for name, x in taps.items():
        base, own = gram_keys(name, x)
        n = x.shape[-1]
        widths.update(dict.fromkeys([base, *own], n))
        experts = x.shape[0] if base.endswith(EXPERT_TAPS) else 1
        batch_gram = max(batch_gram, 4 * experts * n * n)
    return {"weights": tree_bytes(params),
            "grams": sum(8 * (n * n + n) for n in widths.values()),
            "batch_gram": batch_gram}
