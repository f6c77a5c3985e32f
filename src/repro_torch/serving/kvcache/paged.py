"""PagedKVCache: device block pools + host block-table bookkeeping.

The device side is the model's per-layer block pools (all leaves share one
physical block-id space; each pool also holds the model's write-sink block
past ``num_blocks``, which the allocator never hands out).  The block table
is a small host numpy array (max_batch, max_blocks_per_row), mirrored to
the device lazily: the mirror is rebuilt only after a reservation or free
rewrote the host table.

Host bookkeeping is authoritative.  ``reserve`` grabs the blocks
admission asks for (the prompt under on-demand admission, prompt + max_new
under worst case), ``extend`` grows a live row's reservation at block
boundaries, ``rollback`` shrinks it to a prefix (``0``: preemption), and
``free`` returns a finished request's blocks at once.  ``defrag`` compacts
live blocks to the lowest ids and permutes the device pools to match.
One card holds one pool shard: ``slot_shard`` is always 0.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

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


# Pool leaves: name -> ndim of one layer's leaf; a stacked group adds a
# leading layer dim, so the block axis is ndim - base.
_POOL_LEAF_NDIM = {"k": 4, "v": 4, "k_scale": 3, "v_scale": 3}


def pool_leaves(pools, prefix=()):
    """(path, block axis, leaf) of every pool leaf, in a fixed order."""
    for name, c in pools.items():
        if isinstance(c, dict):
            yield from pool_leaves(c, prefix + (name,))
        else:
            yield prefix + (name,), c.ndim - _POOL_LEAF_NDIM[name], c


def _set_leaf(pools, path, value) -> None:
    for key in path[:-1]:
        pools = pools[key]
    pools[path[-1]] = value


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
        self.table_uploads = 0  # host table -> device mirror rebuilds

    @property
    def blocks_per_shard(self) -> int:
        return self.num_blocks

    def slot_shard(self, slot: int) -> int:
        return 0

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

    def can_reserve(self, n_tokens: int, slot: int = 0) -> bool:
        return self.alloc.can_alloc(self.blocks_for(n_tokens))

    def extend(self, slot: int, n_tokens: int) -> Optional[int]:
        """Grow slot's reservation to cover ``n_tokens`` positions (the
        on-demand path).  Returns the blocks appended (0 when coverage
        already suffices), or None (no state change) when the pool is dry.
        Appended blocks extend the table row in owned order, so positions
        already written stay mapped."""
        have = len(self.alloc.owned_by(slot))
        need = self.blocks_for(n_tokens)
        if need > self.max_blocks_per_row:
            raise ValueError(f"{n_tokens} tokens need {need} blocks > "
                             f"max_blocks_per_row={self.max_blocks_per_row}")
        if need <= have:
            return 0
        ids = self.alloc.grow(slot, need - have)
        if ids is None:
            return None
        self.table_np[slot, have:have + len(ids)] = ids
        self._table_dev = None
        return len(ids)

    def free(self, slot: int) -> List[int]:
        """Release a finished slot's blocks for reuse."""
        self.table_np[slot, :] = -1
        self._table_dev = None
        return self.alloc.free(slot)

    def rollback(self, slot: int, n_tokens: int) -> List[int]:
        """Shrink slot's reservation to the blocks covering its first
        ``n_tokens`` positions and free the suffix (``0``: all of them, a
        preempted row).  The pools need no touch: entries past a row's
        length are invisible to attention."""
        n_keep = 0 if n_tokens <= 0 else self.blocks_for(n_tokens)
        freed = self.alloc.release_suffix(slot, n_keep)
        if freed:
            owned = self.alloc.owned_by(slot)
            self.table_np[slot, :] = -1
            self.table_np[slot, :len(owned)] = owned
            self._table_dev = None
        return freed

    def table_device(self) -> torch.Tensor:
        if self._table_dev is None:
            self._table_dev = upload(self.table_np, self.device)
            self.table_uploads += 1
        return self._table_dev

    def defrag(self) -> Dict[int, int]:
        """Compact live blocks to the lowest pool ids: one index gather per
        pool leaf by the allocator's move map (the sink block stays last),
        and the host table rewritten through a lookup array.  No host
        sync: the permutation goes up as an asynchronous upload."""
        moves = self.alloc.defrag()
        if not moves:
            return moves
        old = np.fromiter(moves.keys(), np.int64, len(moves))
        new = np.fromiter(moves.values(), np.int64, len(moves))
        perm = np.arange(self.num_blocks + 1)  # + the sink
        perm[new] = old
        perm_dev = upload(perm, self.device)
        for path, ax, leaf in list(pool_leaves(self.pools)):
            _set_leaf(self.pools, path, leaf.index_select(ax, perm_dev))
        remap = np.arange(self.num_blocks, dtype=np.int32)
        remap[old] = new
        live = self.table_np >= 0
        self.table_np[live] = remap[self.table_np[live]]
        self._table_dev = None
        return moves

    def hbm_bytes(self) -> int:
        return sum(leaf.numel() * leaf.element_size()
                   for _, _, leaf in pool_leaves(self.pools))

    def stats(self) -> Dict[str, Any]:
        hbm = self.hbm_bytes()
        return {
            "block_size": self.block_size,
            "num_blocks": self.num_blocks,
            "blocks_in_use": self.alloc.in_use(),
            "blocks_peak": self.alloc.peak_in_use,
            "tokens_capacity": self.num_blocks * self.block_size,
            "tokens_reserved": self.alloc.in_use() * self.block_size,
            "cache_hbm_bytes": hbm,
            "dp_shards": 1,
            "per_device_cache_hbm_bytes": hbm,
            "table_uploads": self.table_uploads,
        }
