"""Quality-drift attribution: which targets pay for a compression ratio.

  * **Logit KL** — mean per-token KL(dense || test) in nats between two
    param trees' next-token distributions, both forwards on the same batch.
  * **Per-target patching** — for each compressed ``TargetSpec``, a tree
    that is dense everywhere except that one target (its factored leaf
    swapped in), and its logit KL: the drift that target alone causes.
    ``linear_apply`` dispatches per leaf on "kernel" vs "u", so partially
    compressed trees run as they are.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from repro_torch.models.api import batch_inputs

from .perplexity import params_device


def swap_subtree(params: Any, path: Tuple[str, ...], leaf: Any) -> Any:
    """Copy-on-path: a new tree sharing every leaf with ``params`` except
    the subtree at ``path``, which is replaced by ``leaf``."""
    if not path:
        return leaf
    out = dict(params)
    out[path[0]] = swap_subtree(params[path[0]], path[1:], leaf)
    return out


def get_subtree(params: Any, path: Tuple[str, ...]) -> Any:
    node = params
    for p in path:
        node = node[p]
    return node


@torch.no_grad()
def mean_logit_kl(model, params_ref: Any, params_test: Any,
                  batches: Iterable,
                  max_batches: Optional[int] = None) -> float:
    """Mean per-token KL(ref || test) over the batch stream (the
    reference's batch dicts or bare token arrays), in nats."""
    device = params_device(params_ref)
    tot, n = 0.0, 0
    for i, batch in enumerate(batches):
        if max_batches is not None and i >= max_batches:
            break
        toks, kw = batch_inputs(model, batch, device)
        la = torch.log_softmax(model.apply(params_ref, toks, mode="train", **kw).float(), -1)
        lb = torch.log_softmax(model.apply(params_test, toks, mode="train", **kw).float(), -1)
        tot += float((la.exp() * (la - lb)).sum(-1).mean())
        n += 1
    return tot / max(n, 1)


def per_target_attribution(model, dense_params: Any, compressed_params: Any,
                           targets: Sequence, make_batches) -> List[Dict]:
    """Logit KL of each single-target patch, plus each target's share of the
    summed per-target KL.  ``make_batches`` returns a fresh iterator of the
    same batches for every patch."""
    rows: List[Dict] = []
    for spec in targets:
        patched = swap_subtree(dense_params, spec.path,
                               get_subtree(compressed_params, spec.path))
        kl = mean_logit_kl(model, dense_params, patched, make_batches())
        rows.append({"target": spec.name, "logit_kl": kl})
    total = sum(max(r["logit_kl"], 0.0) for r in rows)
    for r in rows:
        r["share"] = max(r["logit_kl"], 0.0) / total if total > 0 else 0.0
    return sorted(rows, key=lambda r: -r["logit_kl"])
