"""Calibration runner: collect Grams over a calibration stream (the paper's
256 samples of the calibration domain, one tapped forward per batch)."""

from __future__ import annotations

import logging
from typing import Iterable, Optional

import torch

from repro_torch.core.compress import GramStore
from repro_torch.data.synth import DomainSampler
from repro_torch.models.api import batch_inputs

from .gram import accumulate_taps, calibration_precision

logger = logging.getLogger(__name__)


@torch.no_grad()
def collect_grams(model, params, batches: Iterable,
                  max_batches: Optional[int] = None, telemetry=None) -> GramStore:
    """Accumulate Grams on the params' device from the reference's batch
    dicts (``{"tokens"}``, plus ``"frames"`` for an encoder-decoder model)
    or bare (B, S) token arrays.

    ``telemetry`` (``repro_torch.obs.compression.CompressionTelemetry``)
    observes without changing the store: per-batch row counts during the
    pass, the per-tap activation statistics once over the final store."""
    calibration_precision()
    device = params["embed"]["table"].device
    store = GramStore()
    n = 0
    for i, batch in enumerate(batches):
        if max_batches is not None and i >= max_batches:
            break
        taps = {}
        tokens, kwargs = batch_inputs(model, batch, device)
        model.apply(params, tokens, mode="train", taps=taps, **kwargs)
        accumulate_taps(store, taps, telemetry=telemetry)
        del taps
        n += 1
    logger.info("calibration: %d batches, %d gram keys", n, len(store.keys()))
    if telemetry is not None and telemetry.enabled:
        telemetry.on_calib_store(store)
    return store


def calibration_batches(vocab: int, domain: str, n_samples: int = 256,
                        batch: int = 16, seq: int = 128, seed: int = 7):
    """The paper's 256-sample calibration set as (batch, seq) token arrays
    (the reference's stream: same sampler, seed and batching)."""
    sampler = DomainSampler(vocab, seed=seed)
    for _ in range(max(1, n_samples // batch)):
        yield sampler.batch(domain, batch, seq)
