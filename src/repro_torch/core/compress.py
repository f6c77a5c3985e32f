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
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch import Device, bridge, resolve_device

from .lowrank import factors_to_params
from .nsvd import decomposition_diagnostics, nested_compress
from .plan import CompressionConfig, CompressionPlan, build_plan
from .ratio import rank_for_ratio

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
        # keys -> the (E, n, n) and (E, n) sums whose slices they read
        self._stacks: Dict[Tuple[str, ...], Tuple[torch.Tensor, torch.Tensor]] = {}

    def update(self, key: str, gram: torch.Tensor, absmean: torch.Tensor,
               count: float):
        if key in self._grams:
            self._grams[key] += gram
            self._absmean[key] += absmean
            self._counts[key] += count
        else:
            self._grams[key] = gram.to(torch.float64, copy=True)
            self._absmean[key] = absmean.to(torch.float64, copy=True)
            self._counts[key] = float(count)

    def update_stacked(self, keys: Sequence[str], grams: torch.Tensor,
                       absmeans: torch.Tensor, counts: Sequence[float]):
        """``update(keys[e], grams[e], absmeans[e], counts[e])`` for every e,
        with one fp64 add for all of them: keys first seen together read
        slices of one (E, n, n) sum (a MoE layer's per-expert Grams)."""
        keys = tuple(keys)
        stack = self._stacks.get(keys)
        if stack is None:
            if any(k in self._grams for k in keys):
                raise ValueError("update_stacked: keys already summed one by one")
            stack = (grams.to(torch.float64, copy=True), absmeans.to(torch.float64, copy=True))
            self._stacks[keys] = stack
            for e, k in enumerate(keys):
                self._grams[k], self._absmean[k] = stack[0][e], stack[1][e]
                self._counts[k] = float(counts[e])
            return
        stack[0].add_(grams)
        stack[1].add_(absmeans)
        for k, c in zip(keys, counts):
            self._counts[k] += float(c)

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

    def resolve(self, key: str, fallback: Optional[str] = None,
                min_count: int = 0) -> Tuple[str, Optional[str]]:
        """The key gram()/absmean() would read, and the fallback reason:
        None for the primary key, else "missing" or "min_count"."""
        if key in self._grams:
            if self._counts[key] >= min_count:
                return key, None
            reason = "min_count"
        else:
            reason = "missing"
        if fallback is not None and fallback in self._grams:
            return fallback, reason
        raise KeyError(f"no Gram for {key!r} (fallback={fallback!r})")

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
                    absmean: Optional[torch.Tensor],
                    telemetry: Optional[Any] = None, target: str = "",
                    slice_idx: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    """Compress one (in, out) kernel -> factored params dict.

    ``telemetry`` (``repro_torch.obs.compression.CompressionTelemetry``,
    duck-typed so core never imports obs) is a pure observer: it records
    diagnostics computed after the factors exist, so the factored params
    are bit-identical with it on or off."""
    a = kernel.to(torch.float64).T  # paper orientation (out, in)
    factors = nested_compress(
        a, rank, config.method, gram=gram, absmean=absmean,
        k1_frac=config.k1_frac, damp=config.damp,
        use_randomized=config.use_randomized)
    if telemetry is not None and telemetry.enabled:
        telemetry.on_slice(target, slice_idx, decomposition_diagnostics(
            a, factors, gram=gram,
            compare_plain=getattr(telemetry, "compare_plain", True),
            use_randomized=config.use_randomized))
    return factors_to_params(factors, dtype=config.dtype)


def compress_params(params: Mapping[str, Any], plan: CompressionPlan,
                    grams: GramStore, telemetry: Optional[Any] = None) -> Dict[str, Any]:
    """A new param tree with every planned target factored (its kernel
    replaced by the factors, a sibling leaf such as Mamba's ``dt_proj``
    bias kept beside them); other leaves are passed through by reference.
    Stacked kernels (L, in, out) compress slice by slice against
    f"{gram_key}/{i}" (falling back to gram_key).

    ``telemetry`` observes the pass without affecting it: one report per
    target (errors, tail mass, k1/k2, absorption, achieved-vs-requested
    rank and params, Gram fallbacks)."""
    new_params = _copy_dicts(params)
    cfg = plan.config
    needs_gram = cfg.method not in ("svd", "plain")
    observing = telemetry is not None and telemetry.enabled
    for spec in plan.targets:
        t0 = time.time()
        leaf = _get_subtree(new_params, spec.path)
        if "kernel" not in leaf:
            raise KeyError(f"target {spec.name} has no dense kernel (already compressed?)")
        kernel = leaf["kernel"].to(torch.float32)
        rank = plan.rank_of(spec)
        fallback_slices = 0
        if spec.stacked:
            flat = kernel.reshape(-1, spec.in_dim, spec.out_dim)
            outs = []
            for flat_i in range(flat.shape[0]):
                idx = _unravel(flat_i, spec.stacked)
                g = a = None
                if needs_gram:
                    key = (f"{spec.gram_key}/{'/'.join(map(str, idx))}"
                           if spec.per_layer_gram else spec.gram_key)
                    min_count = spec.in_dim // 4
                    g = grams.gram(key, fallback=spec.gram_key, min_count=min_count)
                    a = grams.absmean(key, fallback=spec.gram_key, min_count=min_count)
                    if observing:
                        _, reason = grams.resolve(key, fallback=spec.gram_key,
                                                  min_count=min_count)
                        if reason is not None:
                            fallback_slices += 1
                            telemetry.on_gram_fallback(key, spec.gram_key, reason)
                outs.append(compress_matrix(flat[flat_i], rank, cfg, g, a,
                                            telemetry=telemetry, target=spec.name,
                                            slice_idx=idx))
            factored = {k: torch.stack([o[k] for o in outs]).reshape(
                *spec.stacked, *outs[0][k].shape) for k in outs[0]}
        else:
            g = a = None
            if needs_gram:
                g = grams.gram(spec.gram_key)
                a = grams.absmean(spec.gram_key)
            factored = compress_matrix(kernel, rank, cfg, g, a,
                                       telemetry=telemetry, target=spec.name)
        # The target's sibling leaves stay beside its factors (dt_proj's
        # bias; no other target has one).
        _set_subtree(new_params, spec.path,
                     {**{k: v for k, v in leaf.items() if k != "kernel"}, **factored})
        dt = time.time() - t0
        if observing:
            m, n = spec.out_dim, spec.in_dim
            dense_params = m * n * spec.count
            factored_params = spec.count * (m + n) * rank
            telemetry.on_target(
                name=spec.name, method=cfg.method, shape=(m, n),
                stacked=spec.stacked, rank=rank,
                requested_rank=rank_for_ratio(m, n, cfg.ratio),
                requested_ratio=cfg.ratio,
                achieved_ratio=1.0 - factored_params / dense_params,
                dense_params=dense_params, factored_params=factored_params,
                gram_fallback_slices=fallback_slices, seconds=dt)
        logger.info("compressed %s rank=%d in %.2fs", spec.name, rank, dt)
    return new_params


def compress_model(params: Mapping[str, Any], targets, grams: GramStore,
                   config: CompressionConfig, telemetry: Optional[Any] = None
                   ) -> Tuple[Dict[str, Any], CompressionPlan]:
    """Plan and execute in one call: (factored params, plan)."""
    plan = build_plan(targets, config)
    return compress_params(params, plan, grams, telemetry=telemetry), plan


def _unravel(i: int, shape: Tuple[int, ...]) -> Tuple[int, ...]:
    """Row-major multi-index of flat index i (np.ndindex order)."""
    idx = []
    for s in reversed(shape):
        idx.append(i % s)
        i //= s
    return tuple(reversed(idx))
