"""Calibration runner: collect Grams over a calibration stream (the paper's
256 samples of the calibration domain, one tapped forward per batch)."""

from __future__ import annotations

import logging
from typing import Iterable, Optional

import numpy as np
import torch

from repro_torch.core.compress import GramStore
from repro_torch.data.synth import DomainSampler

from .gram import accumulate_taps, calibration_precision

logger = logging.getLogger(__name__)


@torch.no_grad()
def collect_grams(model, params, batches: Iterable[np.ndarray],
                  max_batches: Optional[int] = None) -> GramStore:
    """Accumulate Grams on the params' device from (B, S) token batches."""
    calibration_precision()
    device = params["embed"]["table"].device
    store = GramStore()
    n = 0
    for i, tokens in enumerate(batches):
        if max_batches is not None and i >= max_batches:
            break
        taps = {}
        model.apply(params, torch.as_tensor(tokens, device=device),
                    mode="train", taps=taps)
        accumulate_taps(store, taps)
        n += 1
    logger.info("calibration: %d batches, %d gram keys", n, len(store.keys()))
    return store


def calibration_batches(vocab: int, domain: str, n_samples: int = 256,
                        batch: int = 16, seq: int = 128, seed: int = 7):
    """The paper's 256-sample calibration set as (batch, seq) token arrays
    (the reference's stream: same sampler, seed and batching)."""
    sampler = DomainSampler(vocab, seed=seed)
    for _ in range(max(1, n_samples // batch)):
        yield sampler.batch(domain, batch, seq)
