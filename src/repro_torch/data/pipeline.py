"""Training data pipeline (the reference's ``data/pipeline.py``).

Deterministic and restart-safe: the pipeline state is (seed, step, domain),
so a checkpoint restores the exact stream position.  A step's tokens are
drawn on the host (numpy) from a generator seeded with (seed << 20) ^ step,
bit for bit the reference's, placed on ``device``, and optionally
prefetched by a background thread so host generation overlaps the device's
step.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch import Device, resolve_device

from .synth import DomainSampler


@dataclasses.dataclass
class PipelineState:
    seed: int
    step: int
    domain: str = "en_a"

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d) -> "PipelineState":
        return cls(**d)


class LMDataPipeline:
    """Next-token-prediction batches from the synthetic domain sampler
    ("mix" draws each row's domain by the reference's mixture weights)."""

    def __init__(self, vocab: int, batch: int, seq: int,
                 state: Optional[PipelineState] = None, device: Device = None,
                 prefetch: int = 2):
        self.vocab = vocab
        self.batch = batch
        self.seq = seq
        self.state = state or PipelineState(seed=0, step=0)
        self.device = resolve_device(device)
        self.prefetch = prefetch
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # --------------------------------------------------------- generation

    def _make_batch(self, step: int) -> Dict[str, np.ndarray]:
        # Per-step determinism: a generator of its own for each step (the
        # worker thread and the caller never share one; the domains' tables
        # are built once per process).
        sampler = DomainSampler(self.vocab)
        sampler.rng = np.random.default_rng((self.state.seed << 20) ^ step)
        tokens = sampler.batch(self.state.domain, self.batch, self.seq)
        return {"tokens": tokens, "loss_mask": np.ones_like(tokens, np.float32)}

    def _place(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}

    # ----------------------------------------------------------- iterator

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        return self

    def __next__(self) -> Dict[str, Any]:
        b = self._make_batch(self.state.step)
        self.state.step += 1
        return self._place(b)

    # Background prefetch (overlap host generation with the device step).
    def start_prefetch(self):
        def worker():
            step = self.state.step
            while not self._stop.is_set():
                b = self._make_batch(step)
                step += 1
                while not self._stop.is_set():
                    try:
                        self._q.put(b, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def next_prefetched(self) -> Dict[str, Any]:
        b = self._q.get()
        self.state.step += 1
        return self._place(b)

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            while not self._q.empty():
                self._q.get_nowait()
            self._thread.join()
            self._thread = None
