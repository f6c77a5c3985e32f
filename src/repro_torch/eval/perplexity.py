"""Perplexity evaluation harness (the paper's metric, Tables 1 and 3-6).

Every forward is causal (``mode="train"``), so its attention runs through
the flash-attention kernel on the card (an encoder-decoder's decoder; its
encoder attends unmasked in plain torch).  Batches are the reference's
dicts (``{"tokens"}``, plus ``"frames"`` for an encoder-decoder model) or
bare (B, S) int token arrays, moved to the params' device.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np
import torch

from repro_torch.data.synth import DomainSampler
from repro_torch.models.api import batch_inputs
from repro_torch.models.losses import next_token_xent


def params_device(params) -> torch.device:
    return params["embed"]["table"].device


@torch.no_grad()
def evaluate_ppl(model, params, batches: Iterable,
                 max_batches: Optional[int] = None) -> float:
    """exp(mean nats/token) over the stream (mean of per-batch means)."""
    device = params_device(params)
    tot, n = 0.0, 0
    for i, batch in enumerate(batches):
        if max_batches is not None and i >= max_batches:
            break
        toks, kwargs = batch_inputs(model, batch, device)
        tot += float(next_token_xent(model.apply(params, toks, mode="train", **kwargs),
                                     toks))
        n += 1
    return float(np.exp(tot / max(n, 1)))


def eval_batches(vocab: int, domain: str, n_batches: int = 8, batch: int = 16,
                 seq: int = 128, seed: int = 1234):
    """The reference's eval stream: same sampler, seed and batching."""
    sampler = DomainSampler(vocab, seed=seed)
    for _ in range(n_batches):
        yield sampler.batch(domain, batch, seq)


@torch.no_grad()
def activation_similarity(model, params, domain_a: str, domain_b: str, vocab: int,
                          n_batches: int = 4, batch: int = 8,
                          seq: int = 64) -> Dict[str, float]:
    """Paper Table 2 / Figure 1: cosine similarity between the mean
    per-layer input-activation vectors (mean |x| per channel of every
    ``.in`` tap) of two domains."""
    device = params_device(params)

    def mean_taps(domain, seed):
        sampler = DomainSampler(vocab, seed=seed)
        acc: Dict[str, torch.Tensor] = {}
        for _ in range(n_batches):
            taps: Dict[str, torch.Tensor] = {}
            toks = torch.as_tensor(sampler.batch(domain, batch, seq), device=device)
            model.apply(params, toks, mode="train", taps=taps)
            for k, v in taps.items():
                if k.endswith(".in"):
                    m = v.reshape(-1, v.shape[-1]).float().abs().mean(0).double()
                    acc[k] = acc[k] + m if k in acc else m
        return acc

    ta = mean_taps(domain_a, seed=11)
    tb = mean_taps(domain_b, seed=22)
    sims = {}
    for k in ta:
        a, b = ta[k], tb[k]
        denom = float(torch.linalg.norm(a) * torch.linalg.norm(b))
        sims[k] = float(a @ b) / denom if denom > 0 else 0.0
    return sims
