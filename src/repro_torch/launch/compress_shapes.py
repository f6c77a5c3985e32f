"""Shape-level compression: a param tree -> the factored tree's shapes.

Sizing a compressed deployment needs only the factored parameters' shapes,
not the decompositions.  This mirrors ``core.compress.compress_params``
with the same plan and rank machinery, on ``device="meta"`` tensors: the
input leaves may be real or meta tensors (only their shapes and dtypes are
read), and every factored leaf comes back as a meta tensor holding no
memory.  Nested methods (nsvd*, nid*) split each rank by ``split_rank``.
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
