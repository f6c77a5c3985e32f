"""Compression orchestrator: dense param tree -> factored param tree.

The reference runs this on the host in numpy float64, matrix by matrix;
the port runs the same math in torch float64 on the device the params and
Grams live on.  Stacked (layers, in, out) kernels are compressed slice by
slice against their per-layer Gram with a shared rank, producing stacked
factors with the same leading dims.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from repro_torch import Device, bridge, resolve_device

from .lowrank import factors_to_params
from .nsvd import nested_compress
from .plan import CompressionConfig, CompressionPlan

logger = logging.getLogger(__name__)


class GramStore:
    """name -> (gram (n,n) fp64, absmean sum (n,), row count), on a device.

    Per-batch fp32 Grams are summed into fp64 accumulators on the device
    they were computed on — the reference's fp32-per-batch, fp64-across-
    batches arithmetic without a per-batch host copy.  The npz schema is
    the reference's (``bridge.read_gram_npz``/``write_gram_npz``)."""

    def __init__(self):
        self._grams: Dict[str, torch.Tensor] = {}
        self._absmean: Dict[str, torch.Tensor] = {}
        self._counts: Dict[str, float] = {}

    def update(self, key: str, gram: torch.Tensor, absmean: torch.Tensor,
               count: float):
        if key in self._grams:
            self._grams[key] += gram
            self._absmean[key] += absmean
            self._counts[key] += count
        else:
            self._grams[key] = gram.to(torch.float64).clone()
            self._absmean[key] = absmean.to(torch.float64).clone()
            self._counts[key] = float(count)

    def _pick(self, key: str, fallback: Optional[str], min_count: int) -> str:
        if key in self._grams and self._counts[key] >= min_count:
            return key
        if fallback is not None and fallback in self._grams:
            return fallback
        raise KeyError(f"no Gram for {key!r} (fallback={fallback!r})")

    def gram(self, key: str, fallback: Optional[str] = None,
             min_count: int = 0) -> torch.Tensor:
        return self._grams[self._pick(key, fallback, min_count)]

    def absmean(self, key: str, fallback: Optional[str] = None,
                min_count: int = 0) -> torch.Tensor:
        """Mean |x| per channel, from the same statistics gram() picks."""
        k = self._pick(key, fallback, min_count)
        return self._absmean[k] / max(self._counts[k], 1.0)

    def count(self, key: str) -> float:
        return self._counts.get(key, 0.0)

    def keys(self):
        return self._grams.keys()

    def save(self, path: str):
        bridge.write_gram_npz(path, {
            k: (self._grams[k].cpu().numpy(), self._absmean[k].cpu().numpy(),
                self._counts[k]) for k in self._grams})

    @classmethod
    def load(cls, path: str, device: Device = None) -> "GramStore":
        store = cls()
        dev = resolve_device(device)
        for name, (g, a, c) in bridge.read_gram_npz(path).items():
            store._grams[name] = torch.from_numpy(g).to(dev, torch.float64)
            store._absmean[name] = torch.from_numpy(a).to(dev, torch.float64)
            store._counts[name] = c
        return store


def _get_subtree(tree, path: Tuple[str, ...]):
    for p in path:
        tree = tree[p]
    return tree


def _set_subtree(tree, path: Tuple[str, ...], value):
    for p in path[:-1]:
        tree = tree[p]
    tree[path[-1]] = value


def _copy_dicts(tree):
    if isinstance(tree, Mapping):
        return {k: _copy_dicts(v) for k, v in tree.items()}
    return tree


def compress_matrix(kernel: torch.Tensor, rank: int, config: CompressionConfig,
                    gram: Optional[torch.Tensor],
                    absmean: Optional[torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Compress one (in, out) kernel -> factored params dict."""
    factors = nested_compress(
        kernel.to(torch.float64).T, rank, config.method, gram=gram,
        absmean=absmean, k1_frac=config.k1_frac, damp=config.damp,
        use_randomized=config.use_randomized)
    return factors_to_params(factors, dtype=config.dtype)


def compress_params(params: Mapping[str, Any], plan: CompressionPlan,
                    grams: GramStore) -> Dict[str, Any]:
    """A new param tree with every planned target factored; other leaves are
    passed through by reference.  Stacked kernels (L, in, out) compress
    slice by slice against f"{gram_key}/{i}" (falling back to gram_key)."""
    new_params = _copy_dicts(params)
    cfg = plan.config
    needs_gram = cfg.method not in ("svd", "plain")
    for spec in plan.targets:
        t0 = time.time()
        leaf = _get_subtree(new_params, spec.path)
        if "kernel" not in leaf:
            raise KeyError(f"target {spec.name} has no dense kernel (already compressed?)")
        kernel = leaf["kernel"].to(torch.float32)
        rank = plan.rank_of(spec)
        if spec.stacked:
            flat = kernel.reshape(-1, spec.in_dim, spec.out_dim)
            outs = []
            for flat_i in range(flat.shape[0]):
                g = a = None
                if needs_gram:
                    idx = _unravel(flat_i, spec.stacked)
                    key = (f"{spec.gram_key}/{'/'.join(map(str, idx))}"
                           if spec.per_layer_gram else spec.gram_key)
                    min_count = spec.in_dim // 4
                    g = grams.gram(key, fallback=spec.gram_key, min_count=min_count)
                    a = grams.absmean(key, fallback=spec.gram_key, min_count=min_count)
                outs.append(compress_matrix(flat[flat_i], rank, cfg, g, a))
            factored = {k: torch.stack([o[k] for o in outs]).reshape(
                *spec.stacked, *outs[0][k].shape) for k in outs[0]}
        else:
            g = a = None
            if needs_gram:
                g = grams.gram(spec.gram_key)
                a = grams.absmean(spec.gram_key)
            factored = compress_matrix(kernel, rank, cfg, g, a)
        _set_subtree(new_params, spec.path, factored)
        logger.info("compressed %s rank=%d in %.2fs", spec.name, rank,
                    time.time() - t0)
    return new_params


def _unravel(i: int, shape: Tuple[int, ...]) -> Tuple[int, ...]:
    """Row-major multi-index of flat index i (np.ndindex order)."""
    idx = []
    for s in reversed(shape):
        idx.append(i % s)
        i //= s
    return tuple(reversed(idx))
