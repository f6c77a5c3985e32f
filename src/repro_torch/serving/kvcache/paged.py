"""PagedKVCache: device block pools + host block-table bookkeeping.

The device side is the model's per-layer block pools (all leaves share one
physical block-id space; each pool also holds the model's write-sink block
past ``num_blocks``, which the allocator never hands out).  The block table
is a small host numpy array (max_batch, max_blocks_per_row), mirrored to
the device lazily: the mirror is rebuilt only after a reservation or free
rewrote the host table.

Host bookkeeping is authoritative.  ``reserve`` grabs a request's
worst-case block count at admission (prompt + max_new), so decode never
runs out of blocks mid-flight and exhaustion surfaces only as admission
backpressure; ``free`` returns a finished request's blocks at once.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch import Device, resolve_device

from .allocator import BlockAllocator


def upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> device tensor without a host sync: a copy from
    pageable memory would block the host until the stream drains, so CUDA
    uploads stage through pinned memory and copy asynchronously."""
    t = torch.from_numpy(np.ascontiguousarray(a).copy())
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def resolve_num_blocks(max_batch: int, max_len: int, block_size: int,
                       num_blocks: Optional[int] = None) -> int:
    """Pool size: capacity parity with a (max_batch, max_len) slab unless
    given."""
    return num_blocks if num_blocks is not None else _ceil_div(
        max_batch * max_len, block_size)


class PagedKVCache:
    def __init__(self, model, max_batch: int, max_len: int,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 kv_quant: bool = False, device: Device = None):
        self.device = resolve_device(device)
        self.block_size = block_size
        self.num_blocks = resolve_num_blocks(max_batch, max_len, block_size,
                                             num_blocks)
        self.max_batch = max_batch
        self.max_blocks_per_row = _ceil_div(max_len, block_size)
        self.pools = model.init_paged_cache(self.num_blocks, block_size,
                                            kv_quant=kv_quant, device=self.device)
        self.alloc = BlockAllocator(self.num_blocks)
        self.table_np = np.full((max_batch, self.max_blocks_per_row), -1, np.int32)
        self._table_dev: Optional[torch.Tensor] = None

    def blocks_for(self, n_tokens: int) -> int:
        return _ceil_div(max(1, n_tokens), self.block_size)

    def reserve(self, slot: int, n_tokens: int) -> bool:
        """Reserve blocks covering n_tokens for ``slot``; False (no state
        change) when the pool is exhausted."""
        n = self.blocks_for(n_tokens)
        if n > self.max_blocks_per_row:
            raise ValueError(f"{n_tokens} tokens need {n} blocks > "
                             f"max_blocks_per_row={self.max_blocks_per_row}")
        if self.alloc.alloc(slot, n) is None:
            return False
        owned = self.alloc.owned_by(slot)
        self.table_np[slot, :] = -1
        self.table_np[slot, :len(owned)] = owned
        self._table_dev = None
        return True

    def free(self, slot: int) -> List[int]:
        """Release a finished slot's blocks for reuse."""
        self.table_np[slot, :] = -1
        self._table_dev = None
        return self.alloc.free(slot)

    def table_device(self) -> torch.Tensor:
        if self._table_dev is None:
            self._table_dev = upload(self.table_np, self.device)
        return self._table_dev
