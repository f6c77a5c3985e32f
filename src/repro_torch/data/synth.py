"""Synthetic multi-domain corpora (offline stand-ins for the paper's eight
datasets).

Each domain is a distinct order-2 Markov token source over a distinct token
sub-range with distinct transition temperature — giving genuinely different
activation statistics per domain (the paper's CMRC/JP regime).  Domain
similarity is measured with the paper's own activation-cosine metric in
benchmarks/table2_similarity.py to confirm the shift magnitude.

Domains:
  en_a  — "calibration language" (WikiText-2 analogue)
  en_b  — same token range, different transitions (PTB/C4 analogue)
  task  — instruction-ish mixture (SNIPS/Alpaca analogue)
  zh    — disjoint token range (CMRC-CN analogue)
  jp    — disjoint token range, different temperature (AlpacaEval-JP analogue)
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DomainSpec:
    name: str
    lo: int  # token range [lo, hi)
    hi: int
    temperature: float
    seed: int
    n_states: int = 64
    perturb: float = 0.0  # mix fraction of fresh transition noise
    perturb_seed: int = 0


def default_domains(vocab: int) -> Dict[str, DomainSpec]:
    v = vocab
    return {
        # en_b shares en_a's seed: a temperature-perturbed version of the
        # SAME transition table — "same language, different corpus"
        # (PTB/C4 vs WikiText in the paper).  task overlaps half the token
        # range; zh/jp live on the disjoint upper range with much sharper
        # transition structure (different "language").
        "en_a": DomainSpec("en_a", 2, v // 2, 0.8, 101, 64),
        "en_b": DomainSpec("en_b", 2, v // 2, 1.1, 101, 64,
                           perturb=0.6, perturb_seed=777),
        "task": DomainSpec("task", v // 4, 3 * v // 4, 0.7, 303, 48),
        "zh": DomainSpec("zh", v // 2, v - 1, 0.45, 404, 32),
        "jp": DomainSpec("jp", v // 2, v - 1, 0.4, 505, 96),
    }


# Mixture weights used for pretraining the small LMs: the calibration
# language dominates (as WikiText-ish English dominates LLaMA pretraining),
# but every domain contributes enough for its embeddings/activations to be
# *structured* — which is what makes calibration-set overfitting measurable.
MIX_WEIGHTS = {"en_a": 0.55, "en_b": 0.15, "task": 0.10, "zh": 0.10, "jp": 0.10}


class MarkovSource:
    """Order-2 Markov chain with a low-rank-ish structured transition table."""

    def __init__(self, spec: DomainSpec, n_states: int = 0):
        self.spec = spec
        n_states = n_states or spec.n_states
        rng = np.random.default_rng(spec.seed)
        self.vocab_slice = np.arange(spec.lo, spec.hi)
        n = len(self.vocab_slice)
        self.n_states = n_states
        # Structured state machine: state = hash(prev2, prev1) % n_states.
        logits = rng.standard_normal((n_states, n))
        # Sparsify: each state strongly prefers a few tokens (zipfy).  The
        # boosted positions dominate the token marginals, hence the
        # activation statistics — `perturb` rewires a fraction of them
        # ("same language, different corpus": correlated but not identical).
        boost = rng.standard_normal((n_states, n)) * 2.0
        mask = rng.random((n_states, n)) < 0.08
        if spec.perturb > 0.0:
            prng = np.random.default_rng(spec.perturb_seed)
            fresh_logits = prng.standard_normal((n_states, n))
            logits = (1 - spec.perturb) * logits + spec.perturb * fresh_logits
            fresh_mask = prng.random((n_states, n)) < 0.08
            rewire = prng.random((n_states, n)) < spec.perturb
            mask = np.where(rewire, fresh_mask, mask)
        logits = logits / spec.temperature
        logits = logits + np.where(mask, boost + 5.0, 0.0)
        p = np.exp(logits - logits.max(axis=1, keepdims=True))
        self.probs = p / p.sum(axis=1, keepdims=True)
        # Per-state CDFs, once: the same sequential cumsum the reference
        # takes per step, so the draws below are bit-identical to its.
        self.cdf = self.probs.cumsum(axis=1)
        self.mix_a = int(rng.integers(1, 1 << 16)) | 1
        self.mix_b = int(rng.integers(1, 1 << 16)) | 1

    def _state(self, t2: np.ndarray, t1: np.ndarray) -> np.ndarray:
        return (t2 * self.mix_a + t1 * self.mix_b) % self.n_states

    def sample(self, rng: np.random.Generator, batch: int, seq: int) -> np.ndarray:
        n = len(self.vocab_slice)
        out = np.empty((batch, seq), np.int64)
        t2 = rng.integers(0, n, batch)
        t1 = rng.integers(0, n, batch)
        for j in range(seq):
            st = self._state(t2, t1)
            # Categorical sampling per row: the count of CDF entries below
            # u, by binary search (the reference counts them per step).
            u = rng.random((batch, 1))
            idx = np.fromiter((np.searchsorted(self.cdf[s], x) for s, x in zip(st, u[:, 0])),
                              np.int64, batch).clip(0, n - 1)
            out[:, j] = idx
            t2, t1 = t1, idx
        return self.vocab_slice[out]


@functools.lru_cache(maxsize=16)
def markov_source(spec: DomainSpec) -> MarkovSource:
    """The source of ``spec``, built once per process.  Its tables depend
    only on the spec (its seeds, and the vocabulary through its token
    range), never on a sampler's seed, and sampling only reads them; at
    vocab 163840 building a domain's tables takes seconds."""
    return MarkovSource(spec)


class DomainSampler:
    def __init__(self, vocab: int, seed: int = 0):
        self.domains = {k: markov_source(v) for k, v in default_domains(vocab).items()}
        self.rng = np.random.default_rng(seed)

    def batch(self, domain: str, batch: int, seq: int) -> np.ndarray:
        if domain == "mix":
            return self.mixed_batch(batch, seq)
        return self.domains[domain].sample(self.rng, batch, seq).astype(np.int32)

    def mixed_batch(self, batch: int, seq: int) -> np.ndarray:
        names = list(MIX_WEIGHTS)
        w = np.array([MIX_WEIGHTS[n] for n in names])
        rows = []
        choices = self.rng.choice(len(names), size=batch, p=w / w.sum())
        for c in choices:
            rows.append(self.domains[names[c]].sample(self.rng, 1, seq)[0])
        return np.stack(rows).astype(np.int32)

    def stream(self, domain: str, batch: int, seq: int) -> Iterator[np.ndarray]:
        while True:
            yield self.batch(domain, batch, seq)
