"""Compression orchestrator: dense param tree -> factored param tree.

The reference runs this on the host in numpy float64, matrix by matrix;
the port runs the same math in torch float64 on the params' device, and
takes each Gram there one key at a time from wherever its store lives (a
host store never sends a decomposition to the CPU).  Stacked (layers, in,
out) kernels are compressed slice by slice against their per-layer Gram
with a shared rank, producing stacked factors with the same leading dims.
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


GRAM_HOMES = ("device", "host")  # where a calibration keeps its GramStore
HOST_STAGE_BYTES = 1 << 28  # a host copy's pinned staging buffer


def host_copy(x: torch.Tensor) -> torch.Tensor:
    """A card tensor copied into new host memory through a pinned staging
    buffer: the card writes each piece into it at the link's rate, and a
    multi-threaded host copy moves it on, faulting the new pages in on
    every core (a plain ``.to("cpu")`` faults them in one thread, at about
    half the rate: ``tools/host_copy_probe.py``)."""
    out = torch.empty(x.shape, dtype=x.dtype)
    src, dst = x.reshape(-1), out.view(-1)
    step = max(1, HOST_STAGE_BYTES // x.element_size())
    stage = torch.empty(min(step, src.numel()), dtype=x.dtype, pin_memory=True)
    for i in range(0, src.numel(), step):
        k = min(step, src.numel() - i)
        stage[:k].copy_(src[i:i + k])
        dst[i:i + k].copy_(stage[:k])
    return out


class GramStore:
    """name -> (gram (n,n) fp64, absmean sum (n,), row count), on a home
    device.

    Per-batch fp32 Grams are summed into fp64 accumulators in batch order,
    the reference's fp32-per-batch, fp64-across-batches arithmetic.
    ``device`` is the store's home: the card (the sums stay where the
    Grams are computed, with no per-batch host copy), ``"cpu"`` (host
    memory, as the reference keeps its store: every Gram added is moved
    there first), or None (each key stays on the device its first update
    came from).  Readers take one key at a time to the device that uses it
    (``gram(..., device=)``), never the whole store.  The npz schema is
    the reference's (``bridge.read_gram_npz``/``write_gram_npz``)."""

    def __init__(self, device: Device = None):
        self.device = None if device is None else torch.device(device)
        self._grams: Dict[str, torch.Tensor] = {}
        self._absmean: Dict[str, torch.Tensor] = {}
        self._counts: Dict[str, float] = {}
        # keys -> the (E, n, n) and (E, n) sums whose slices they read
        self._stacks: Dict[Tuple[str, ...], Tuple[torch.Tensor, torch.Tensor]] = {}
        # What a calibration (``calib.runner.collect_grams``) reports: the
        # layer groups it filled the store in, and the most bytes of sums
        # it held on the device at once.
        self.groups = 1
        self.device_bytes = 0

    def _home(self, x: torch.Tensor) -> torch.Tensor:
        if self.device is None:
            return x
        if self.device.type == "cpu" and x.is_cuda:
            return host_copy(x)
        return x.to(self.device)

    def update(self, key: str, gram: torch.Tensor, absmean: torch.Tensor,
               count: float):
        gram, absmean = self._home(gram), self._home(absmean)
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
        grams, absmeans = self._home(grams), self._home(absmeans)
        stack = self._stacks.get(keys)
        if stack is None:
            if any(k in self._grams for k in keys):
                raise ValueError("update_stacked: keys already summed one by one")
            self._add_stack(keys, grams.to(torch.float64, copy=True),
                            absmeans.to(torch.float64, copy=True), counts)
            return
        stack[0].add_(grams)
        stack[1].add_(absmeans)
        for k, c in zip(keys, counts):
            self._counts[k] += float(c)

    def _add_stack(self, keys: Tuple[str, ...], grams: torch.Tensor,
                   absmeans: torch.Tensor, counts: Sequence[float]):
        self._stacks[keys] = (grams, absmeans)
        for e, k in enumerate(keys):
            self._grams[k], self._absmean[k] = grams[e], absmeans[e]
            self._counts[k] = float(counts[e])

    def merge(self, other: "GramStore"):
        """Add ``other``'s sums into this store, each moved to the home in
        one copy; ``other`` is consumed (a key new here takes its tensor: a
        stack of per-expert sums stays one tensor).  A key both hold is
        added, this store's sum first."""
        stacked = set()
        for keys, (g, a) in other._stacks.items():
            if any(k in self._grams for k in keys):
                raise ValueError("merge: stacked keys already in the store")
            self._add_stack(keys, self._home(g), self._home(a),
                            [other._counts[k] for k in keys])
            stacked.update(keys)
        for k in other._grams.keys() - stacked:
            g, a = self._home(other._grams[k]), self._home(other._absmean[k])
            if k in self._grams:
                self._grams[k] += g
                self._absmean[k] += a
                self._counts[k] += other._counts[k]
            else:
                self._grams[k], self._absmean[k] = g, a
                self._counts[k] = other._counts[k]

    def _pick(self, key: str, fallback: Optional[str], min_count: int) -> str:
        if key in self._grams and self._counts[key] >= min_count:
            return key
        if fallback is not None and fallback in self._grams:
            return fallback
        raise KeyError(f"no Gram for {key!r} (fallback={fallback!r})")

    def gram(self, key: str, fallback: Optional[str] = None,
             min_count: int = 0, device: Device = None) -> torch.Tensor:
        """The picked key's Gram, on ``device`` (None: where it lives)."""
        g = self._grams[self._pick(key, fallback, min_count)]
        return g if device is None else g.to(device)

    def absmean(self, key: str, fallback: Optional[str] = None,
                min_count: int = 0, device: Device = None) -> torch.Tensor:
        """Mean |x| per channel, from the same statistics gram() picks."""
        k = self._pick(key, fallback, min_count)
        a = self._absmean[k] if device is None else self._absmean[k].to(device)
        return a / max(self._counts[k], 1.0)

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

    def nbytes(self) -> int:
        """Bytes of the sums (Grams and absmeans) the store holds."""
        return sum(t.numel() * t.element_size()
                   for d in (self._grams, self._absmean) for t in d.values())

    def save(self, path: str):
        bridge.write_gram_npz(path, {
            k: (self._grams[k].cpu().numpy(), self._absmean[k].cpu().numpy(),
                self._counts[k]) for k in self._grams})

    @classmethod
    def load(cls, path: str, device: Device = None) -> "GramStore":
        """The npz at ``path`` in a store whose home is ``device``."""
        dev = resolve_device(device)
        store = cls(dev)
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
    f"{gram_key}/{i}" (falling back to gram_key).  Each Gram is read onto
    the kernel's device as its slice needs it, so the fp64 solvers run
    there whatever the store's home.

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
                    g = grams.gram(key, fallback=spec.gram_key, min_count=min_count,
                                   device=kernel.device)
                    a = grams.absmean(key, fallback=spec.gram_key, min_count=min_count,
                                      device=kernel.device)
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
                g = grams.gram(spec.gram_key, device=kernel.device)
                a = grams.absmean(spec.gram_key, device=kernel.device)
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
