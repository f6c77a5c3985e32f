"""DraftState: the draft model's serving-side state.

The draft runs the SAME architecture as the target (self-speculative NSVD:
identical shapes, cheaper factored matmuls), so its cache leaves have the
target's shapes and mirror the engine's slot layout one for one.  Three
invariants keep the state small:

  * ``cache_len`` and ``last_token`` are SHARED with the target engine.
    They are equal by construction after prefill (both caches hold the
    prompt; the first sampled token is pending) and after every spec step
    (the verify step advances both caches' lengths to the accepted prefix
    n + m + 1, and both feed the same correction or bonus token next).
    The draft root feeds all k+1 drafted tokens through the draft (one
    more forward than it samples), so the draft cache always holds an
    entry for every committed token: no catch-up chunk is ever needed.
  * Only the cache itself and the draft keys are draft-private.
  * The paged layout reserves blocks in lockstep with the target: a
    request is admitted only when BOTH pools can hold what admission
    reserves, and growth extends both.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch import Device, resolve_device
from repro_torch.launch.steps import request_keys
from repro_torch.serving.kvcache import PagedKVCache


class DraftState:
    def __init__(self, model, params: Any, max_batch: int, max_len: int,
                 paged: bool, block_size: int = 16,
                 num_blocks: Optional[int] = None, kv_quant: bool = False,
                 seed: int = 1234, device: Device = None):
        self.params = params
        self.paged = paged
        self.seed = seed
        self.device = resolve_device(device)
        if paged:
            self.kv = PagedKVCache(model, max_batch, max_len, block_size=block_size,
                                   num_blocks=num_blocks, kv_quant=kv_quant,
                                   device=self.device)
            self.cache = None
        else:
            self.kv = None
            self.cache = model.init_cache(max_batch, max_len, device=self.device,
                                          kv_quant=kv_quant)
        # Admission sets each row's key to its request's draft chain.
        self.key_data = torch.zeros((max_batch, 2), dtype=torch.int64, device=self.device)

    def request_keys(self, uids) -> torch.Tensor:
        """(N, 2) draft key data of requests ``uids``: a function of the
        draft seed and the uid only, never of scheduling."""
        return request_keys(self.seed, uids, self.device)

    # ---------------------------------------------------------- block ops

    def reserve(self, slot: int, n_tokens: int) -> bool:
        return self.kv.reserve(slot, n_tokens) if self.paged else True

    def extend(self, slot: int, n_tokens: int) -> Optional[int]:
        """Grow the draft reservation in lockstep with the target's
        on-demand growth (0 blocks for the dense slab; None: pool dry)."""
        return self.kv.extend(slot, n_tokens) if self.paged else 0

    def rollback(self, slot: int, n_tokens: int) -> None:
        """Shrink the draft reservation with the target's (preemption)."""
        if self.paged:
            self.kv.rollback(slot, n_tokens)

    def free(self, slot: int) -> None:
        if self.paged:
            self.kv.free(slot)

    def hbm_bytes(self) -> int:
        if self.paged:
            return self.kv.hbm_bytes()

        def nbytes(tree):
            return sum(nbytes(v) if isinstance(v, dict) else v.numel() * v.element_size()
                       for v in tree.values())
        return nbytes(self.cache)

    def table_device(self) -> Optional[torch.Tensor]:
        return self.kv.table_device() if self.paged else None

    @property
    def pools(self):
        """The draft cache tree, whichever layout backs it."""
        return self.kv.pools if self.paged else self.cache
