"""Shape-level compression: a param tree -> the factored tree's shapes.

Sizing a compressed deployment needs only the factored parameters' shapes,
not the decompositions.  This mirrors ``core.compress.compress_params``
with the same plan and rank machinery, on ``device="meta"`` tensors: the
input leaves may be real or meta tensors (only their shapes and dtypes are
read), and every factored leaf comes back as a meta tensor holding no
memory.  Nested methods (nsvd*, nid*) split each rank by ``split_rank``.
``calibration_bytes`` sizes what a calibration holds on the device (the
weights and the fp64 GramStore) from one tapped forward on meta tensors,
``gram_layers`` / ``gram_groups`` how that store splits by layer for a
calibration into host memory;
``compression_bytes`` what compressing adds to it (the factored leaves and
the widest target's fp64 decomposition), from the plan alone.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping

import torch

from repro_torch import torch_dtype
from repro_torch.core.nsvd import split_rank
from repro_torch.core.plan import CompressionConfig, build_plan


def _meta(tree):
    if isinstance(tree, Mapping):
        return {k: _meta(v) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=tree.dtype, device="meta")


def compressed_param_shapes(model, params, ratio: float, method: str = "nsvd1",
                            k1_frac: float = 0.95, multiple_of: int = 128) -> Dict[str, Any]:
    """Every leaf as a meta tensor, each compressible kernel replaced by
    its factors {"u", "v"[, "u2", "v2"]} in the kernel's dtype, its sibling
    leaves kept (``dt_proj``'s bias), as ``compress_params`` keeps them."""
    plan = build_plan(model.compressible_targets(), CompressionConfig(
        method=method, ratio=ratio, k1_frac=k1_frac, multiple_of=multiple_of))
    out = _meta(params)
    nested = method.startswith(("nsvd", "nid"))
    for spec in plan.targets:
        node = out
        for p in spec.path[:-1]:
            node = node[p]
        leaf = node[spec.path[-1]]
        dtype = leaf["kernel"].dtype
        k = plan.rank_of(spec)
        k1, k2 = split_rank(k, k1_frac) if nested else (k, 0)
        lead = tuple(spec.stacked)

        def meta(*shape):
            return torch.empty((*lead, *shape), dtype=dtype, device="meta")
        factored = {"u": meta(spec.in_dim, k1), "v": meta(k1, spec.out_dim)}
        if k2 > 0:
            factored["u2"] = meta(spec.in_dim, k2)
            factored["v2"] = meta(k2, spec.out_dim)
        node[spec.path[-1]] = {**{k: v for k, v in leaf.items() if k != "kernel"},
                               **factored}
    return out


def tree_bytes(tree) -> int:
    """Bytes of a param tree's leaves (real or meta tensors)."""
    if isinstance(tree, Mapping):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


_META_TOKENS = 8  # the meta forward's (1, 8) tokens


def _meta_taps(model) -> Dict[str, torch.Tensor]:
    """One tapped forward of ``model`` on meta tensors: its taps, in the
    order the forward makes them (a vision model's behind one image)."""
    from repro_torch import kernels
    from repro_torch.models.transformer import VISION_FEATURE_DIM

    params = model.init(device="meta")
    taps: Dict[str, torch.Tensor] = {}
    kw = {}
    if model.cfg.frontend == "vision":
        kw["patches"] = torch.zeros((1, model.cfg.num_patches, VISION_FEATURE_DIM),
                                    device="meta")
    with torch.no_grad(), kernels.plain():  # shapes only: no kernel on meta
        model.apply(params, torch.zeros((1, _META_TOKENS), dtype=torch.long,
                                        device="meta"), mode="train", taps=taps, **kw)
    return taps


def _key_bytes(n: int) -> int:
    return 8 * (n * n + n)  # an (n, n) fp64 Gram and its (n,) absmean


def calibration_bytes(model) -> Dict[str, int]:
    """What calibrating ``model`` holds on the device, from one tapped
    forward on meta tensors (no memory): ``weights``, the param tree;
    ``grams``, the fp64 GramStore its taps leave (``calib.gram.gram_keys``,
    each key an (n, n) Gram and an (n,) absmean); ``batch_gram``, the most
    one tap makes and drops (its fp32 Gram; a batched tap's (E, n, n) and
    the (n, n) fp64 sum over experts its shared key takes).  None of them
    depends on the calibration batch's shape: a Gram's width
    is its tap's last dim, a batched tap's expert count its first.  A
    vision model's forward takes one image's patches, so its projector's
    taps (``projector.in``, ``projector.mid``) are counted too."""
    from repro_torch.calib.gram import EXPERT_TAPS, gram_keys

    widths: Dict[str, int] = {}
    batch_gram = 0
    for name, x in _meta_taps(model).items():
        base, own = gram_keys(name, x)
        n = x.shape[-1]
        widths.update(dict.fromkeys([base, *own], n))
        if base.endswith(EXPERT_TAPS):
            batch_gram = max(batch_gram, 4 * x.shape[0] * n * n + 8 * n * n)
        else:
            batch_gram = max(batch_gram, 4 * n * n)
    return {"weights": tree_bytes(model.init(device="meta")),
            "grams": sum(_key_bytes(n) for n in widths.values()),
            "batch_gram": batch_gram}


def gram_layers(model) -> Dict[str, Any]:
    """How ``model``'s fp64 GramStore splits by layer, for a calibration
    that fills a host store a group of layers at a time
    (``calib.runner.collect_grams(grams_on="host")``), from the same meta
    forward as ``calibration_bytes``: ``layers``, each stacked layer's own
    keys' bytes ({"g0/rep3": bytes}, in forward order); ``shared``, the
    keys every group's pass holds (the shared keys summed over layers, and
    the unstacked taps' keys); ``tap_bytes_per_token``, the taps one token
    of a batch leaves on the device until its Grams are taken."""
    from repro_torch.calib.gram import gram_keys, tap_layer

    layers: Dict[str, Dict[str, int]] = {}
    shared: Dict[str, int] = {}
    tap_bytes = 0
    for name, x in _meta_taps(model).items():
        base, own = gram_keys(name, x)
        n = x.shape[-1]
        layer = tap_layer(name)
        shared[base] = n
        (shared if layer is None else layers.setdefault(layer, {})).update(
            dict.fromkeys(own, n))
        tap_bytes += x.numel() * x.element_size()
    return {"layers": {k: sum(_key_bytes(n) for n in v.values()) for k, v in layers.items()},
            "shared": sum(_key_bytes(n) for n in shared.values()),
            "tap_bytes_per_token": -(-tap_bytes // _META_TOKENS)}


def gram_groups(model, budget: int) -> List[List[str]]:
    """``model``'s stacked layers (``gram_layers``) split, in forward
    order, into the fewest runs whose own keys' bytes each fit ``budget``
    (the device bytes one group's sums may take beside the shared keys).
    A model with no stacked layer is one empty group.  Raises ValueError
    when one layer's keys alone exceed the budget."""
    groups: List[List[str]] = [[]]
    held = 0
    for layer, nbytes in gram_layers(model)["layers"].items():
        if nbytes > budget:
            raise ValueError(f"{model.cfg.name}: layer {layer}'s Grams take "
                             f"{nbytes / 1e9:.2f} GB, over the {budget / 1e9:.2f} GB "
                             "a group may hold on the device")
        if held + nbytes > budget and groups[-1]:
            groups.append([])
            held = 0
        groups[-1].append(layer)
        held += nbytes
    return groups


# The fp64 decomposition's working set on the H100 (torch.linalg on
# cuSOLVER), in multiples of the kernel's fp64 bytes A, its Gram's N and
# the smaller square's K: one SVD (its input's copy, U, V^T and gesvda's
# workspace) SVD_A A + SVD_K K; a matrix whitener's build WHITEN_N N (the
# eigen one's; a Cholesky whitener takes less, but falls back to it on a
# Gram Cholesky cannot factor, as a rank-deficient expert's Gram can be).
# ``tools/compress_memory.py`` measures every case within 2% of these, or
# under them (a Cholesky whitener that succeeds; a plain SVD).
SVD_A, SVD_K = 3.875, 5.875
WHITEN_N = 6.125
_MATRIX_WHITENED = ("asvd1", "asvd2", "asvd3", "nsvd1", "nsvd2", "nid1", "nid2")


def decomposition_bytes(in_dim: int, out_dim: int, method: str = "nsvd1") -> int:
    """The most device bytes one (in_dim, out_dim) kernel's decomposition
    (``core.compress.compress_matrix``: fp64, a full thin SVD) holds at
    once beside the kernel and the Gram it reads, with A = 8 in out, N = 8
    in^2 and K = 8 min(in, out)^2: the fp64 kernel (A); a matrix-whitened
    method's whitener while it is built (WHITEN_N N), then S and S^-1 (2 N)
    through one SVD of A S (A S: A, the SVD: SVD_A A + SVD_K K); nested,
    a second SVD of the residual (A) while the first's U and V^T (A + K)
    are still held."""
    a = 8 * in_dim * out_dim
    n = 8 * in_dim * in_dim
    k = 8 * min(in_dim, out_dim) ** 2
    svd = int(SVD_A * a + SVD_K * k)
    if method in ("svd", "plain"):
        return a + svd
    matrix = method in _MATRIX_WHITENED
    first = 2 * a + (2 * n if matrix else 16 * in_dim) + svd
    build = a + int(WHITEN_N * n) if matrix else 0
    if not method.startswith(("nsvd", "nid")):
        return max(build, first)
    return max(build, first + a + k)


def compression_bytes(model, config) -> Dict[str, int]:
    """What compressing ``model`` under ``config`` (a CompressionConfig, as
    ``launch.serve`` builds it) adds on the device to what its calibration
    holds (``calibration_bytes``), from the plan on meta tensors:
    ``factors``, the factored leaves the new tree holds beside the dense
    one; ``work``, the most one target adds at once while it is compressed:
    its kernel cast to fp32, a stacked target's slice factors before they
    are stacked, and one slice's decomposition (``decomposition_bytes``)."""
    params = model.init(device="meta")
    plan = build_plan(model.compressible_targets(), config)
    out_size = torch.empty((), dtype=torch_dtype(config.dtype)).element_size()
    factors = work = 0
    for spec in plan.targets:
        leaf = params
        for p in spec.path:
            leaf = leaf[p]
        dense = spec.count * spec.in_dim * spec.out_dim
        own = spec.count * (spec.in_dim + spec.out_dim) * plan.rank_of(spec) * out_size
        factors += own
        fp32 = 4 * dense if leaf["kernel"].dtype != torch.float32 else 0
        work = max(work, fp32 + (own if spec.stacked else 0)
                   + decomposition_bytes(spec.in_dim, spec.out_dim, config.method))
    return {"factors": factors, "work": work}
