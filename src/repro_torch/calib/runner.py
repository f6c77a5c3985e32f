"""Calibration runner: collect Grams over a calibration stream (the paper's
256 samples of the calibration domain, one tapped forward per batch)."""

from __future__ import annotations

import itertools
import logging
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from repro_torch.core.compress import GRAM_HOMES, GramStore
from repro_torch.data.synth import DomainSampler
from repro_torch.models.api import batch_inputs

from .gram import accumulate_taps, calibration_precision, tap_layer

logger = logging.getLogger(__name__)


@torch.no_grad()
def collect_grams(model, params, batches: Iterable,
                  max_batches: Optional[int] = None, telemetry=None,
                  grams_on: str = "device", group_bytes: Optional[int] = None) -> GramStore:
    """Accumulate Grams from the reference's batch dicts (``{"tokens"}``,
    plus ``"frames"`` for an encoder-decoder model) or bare (B, S) token
    arrays, in a store whose home ``grams_on`` names:

    - ``"device"``: the params' device, in one pass over the batches;
    - ``"host"``: host memory, as the reference keeps its store.  The
      stacked layers are split into groups whose fp64 sums fit the device
      (``launch.compress_shapes.gram_groups``; ``group_bytes`` a group's
      budget, None: the device's free memory less the shared keys, a
      batch's taps and its largest Gram, or no limit on the CPU).  Each
      group runs every batch, folds only its layers' taps (and the first
      group the unstacked ones) into a device store, and then moves it to
      the host store in one copy (``GramStore.merge``).  A layer's keys
      are bit-identical to the one-pass store's (the same fp64 adds in the
      same order on the same device); a shared key summed over layers
      adds its groups' partial sums in turn, so it agrees to fp64
      rounding when there is more than one group.

    ``telemetry`` (``repro_torch.obs.compression.CompressionTelemetry``)
    observes without changing the store: per-batch row counts, the
    per-tap activation statistics once over the final store, each key
    read onto the params' device."""
    if grams_on not in GRAM_HOMES:
        raise ValueError(f"grams_on must be one of {GRAM_HOMES}, got {grams_on!r}")
    calibration_precision()
    device = params["embed"]["table"].device
    if grams_on == "device":
        store = GramStore(device)
        n = 0
        for batch in itertools.islice(batches, max_batches):
            _fold(model, params, batch, device, store, telemetry)
            n += 1
        store.device_bytes = store.nbytes() if device.type == "cuda" else 0
    else:
        store = GramStore("cpu")
        batches = list(itertools.islice(batches, max_batches))
        n = len(batches)
        plan = _host_groups(model, batches, device, group_bytes)
        rows: List[Dict[str, float]] = [{} for _ in batches]
        for g, layers in enumerate(plan):
            part = GramStore(device)
            for b, batch in enumerate(batches):
                for tap, r in _fold(model, params, batch, device, part, None,
                                    keep=set(layers), unstacked=g == 0).items():
                    rows[b][tap] = rows[b].get(tap, 0.0) + r
            if device.type == "cuda":
                store.device_bytes = max(store.device_bytes, part.nbytes())
            store.merge(part)
            del part
        if telemetry is not None and telemetry.enabled:
            for r in rows:
                telemetry.on_calib_batch(r)
        store.groups = len(plan)
    logger.info("calibration: %d batches, %d gram keys, store on %s (%d group(s), "
                "%.2f GB)", n, len(store.keys()), grams_on, store.groups,
                store.nbytes() / 1e9)
    if telemetry is not None and telemetry.enabled:
        telemetry.on_calib_store(store, device)
    return store


def _fold(model, params, batch, device, store: GramStore, telemetry,
          keep=None, unstacked: bool = True) -> Dict[str, float]:
    """One tapped forward, its taps folded into ``store``: all of them, or
    (``keep``) only those of the layers named there and, if
    ``unstacked``, the unstacked ones; the rest are dropped before their
    Grams are taken.  Returns the rows folded per normalized tap."""
    taps: Dict[str, torch.Tensor] = {}
    tokens, kwargs = batch_inputs(model, batch, device)
    model.apply(params, tokens, mode="train", taps=taps, **kwargs)
    if keep is not None:
        taps = {k: x for k, x in taps.items()
                if (tap_layer(k) in keep if tap_layer(k) is not None else unstacked)}
    return accumulate_taps(store, taps, telemetry=telemetry)


# The share of the device's free memory a host-store calibration leaves to
# the caching allocator: the first batch of a group allocates its fp64 keys
# (up to 1.6 GB each) while the taps of that batch are live, and the blocks
# the batches free are split too finely to take a key that late.
GROUP_HEADROOM = 0.1


def _host_groups(model, batches: List, device: torch.device,
                group_bytes: Optional[int] = None) -> List[List[str]]:
    """The groups of stacked layers a host-store calibration runs
    (``launch.compress_shapes.gram_groups``), each group's sums within
    ``group_bytes``; None sizes it from the device's free memory (its
    cached blocks returned first), less GROUP_HEADROOM of it and what
    every pass holds besides: the shared keys, twice a batch's taps (the
    first batch's tokens) and the largest Gram a tap makes and drops
    (``calibration_bytes``).  On the CPU, None is no limit: one group."""
    from repro_torch.launch.compress_shapes import (calibration_bytes, gram_groups,
                                                    gram_layers)

    if group_bytes is None:
        if device.type != "cuda":
            return gram_groups(model, float("inf"))
        layers = gram_layers(model)
        first = batches[0]
        tokens = np.size(first["tokens"] if isinstance(first, dict) else first)
        torch.cuda.empty_cache()  # the allocator's cached blocks count as free
        free, _ = torch.cuda.mem_get_info(device)
        group_bytes = ((1.0 - GROUP_HEADROOM) * free - layers["shared"]
                       - calibration_bytes(model)["batch_gram"]
                       - 2 * tokens * layers["tap_bytes_per_token"])
    return gram_groups(model, group_bytes)


def calibration_batches(vocab: int, domain: str, n_samples: int = 256,
                        batch: int = 16, seq: int = 128, seed: int = 7):
    """The paper's 256-sample calibration set as (batch, seq) token arrays
    (the reference's stream: same sampler, seed and batching)."""
    sampler = DomainSampler(vocab, seed=seed)
    for _ in range(max(1, n_samples // batch)):
        yield sampler.batch(domain, batch, seq)
