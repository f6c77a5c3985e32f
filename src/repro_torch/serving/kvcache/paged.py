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

Under a serving mesh (``dp_shards`` > 1, the reference's): the block id
space splits into ``dp_shards`` contiguous ranges, slot s maps to DP shard
``s * dp_shards // max_batch``, and its reservations come from that
shard's range.  Every rank keeps the whole host bookkeeping (the same on
every rank), but allocates only its own shard's sub-pool (``blocks_per_
shard`` blocks and its own sink), of the heads its model rank computes
(the model built on the mesh sizes them), and uploads only its slots'
table rows with ids local to that sub-pool.  Defrag moves never cross
shards, so each rank permutes only its own sub-pool.
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
                       num_blocks: Optional[int] = None, dp_shards: int = 1) -> int:
    """Pool size: capacity parity with a (max_batch, max_len) slab unless
    given, rounded up to a multiple of the DP shards (each holds an equal
    sub-pool)."""
    if num_blocks is None:
        num_blocks = _ceil_div(max_batch * max_len, block_size)
    return _ceil_div(num_blocks, dp_shards) * dp_shards


class PagedKVCache:
    def __init__(self, model, max_batch: int, max_len: int,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 kv_quant: bool = False, device: Device = None, dp_shards: int = 1,
                 par=None):
        self.device = resolve_device(device)
        self.block_size = block_size
        self.num_blocks = resolve_num_blocks(max_batch, max_len, block_size,
                                             num_blocks, dp_shards)
        self.dp_shards = dp_shards
        self.max_batch = max_batch
        self.max_blocks_per_row = _ceil_div(max_len, block_size)
        # This rank's shard, its slots [slot_lo, slot_hi) and its blocks'
        # first global id; and the ranks that hold the rest of the pool.
        self.shard = par.dp_rank if dp_shards > 1 else 0
        self.slot_lo = self.shard * max_batch // dp_shards
        self.slot_hi = (self.shard + 1) * max_batch // dp_shards
        self.block_base = self.shard * self.blocks_per_shard
        self.devices = dp_shards * (par.tp_size if par is not None and par.active else 1)
        self.pools = model.init_paged_cache(self.blocks_per_shard, block_size,
                                            kv_quant=kv_quant, device=self.device)
        self.alloc = BlockAllocator(self.num_blocks, num_shards=dp_shards)
        self.table_np = np.full((max_batch, self.max_blocks_per_row), -1, np.int32)
        self._table_dev: Optional[torch.Tensor] = None
        self.table_uploads = 0  # host table -> device mirror rebuilds

    @property
    def blocks_per_shard(self) -> int:
        return self.num_blocks // self.dp_shards

    def slot_shard(self, slot: int) -> int:
        """DP shard owning engine slot ``slot`` (slots split evenly and
        contiguously over the shards, as the engine's per-slot state)."""
        return slot * self.dp_shards // self.max_batch

    def local_ids(self, ids) -> np.ndarray:
        """Global block ids of this rank's shard -> indices into its pools."""
        return np.asarray(ids, np.int64) - self.block_base

    def blocks_for(self, n_tokens: int) -> int:
        return _ceil_div(max(1, n_tokens), self.block_size)

    def reserve(self, slot: int, n_tokens: int) -> bool:
        """Reserve blocks covering n_tokens for ``slot``; False (no state
        change) when the pool is exhausted."""
        n = self.blocks_for(n_tokens)
        if n > self.max_blocks_per_row:
            raise ValueError(f"{n_tokens} tokens need {n} blocks > "
                             f"max_blocks_per_row={self.max_blocks_per_row}")
        if self.alloc.alloc(slot, n, shard=self.slot_shard(slot)) is None:
            return False
        owned = self.alloc.owned_by(slot)
        self.table_np[slot, :] = -1
        self.table_np[slot, :len(owned)] = owned
        self._table_dev = None
        return True

    def can_reserve(self, n_tokens: int, slot: int = 0) -> bool:
        return self.alloc.can_alloc(self.blocks_for(n_tokens), shard=self.slot_shard(slot))

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
        ids = self.alloc.grow(slot, need - have, shard=self.slot_shard(slot))
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
        """This rank's slots' table rows, their ids local to its sub-pool."""
        if self._table_dev is None:
            rows = self.table_np[self.slot_lo:self.slot_hi]
            if self.block_base:
                rows = np.where(rows >= 0, rows - self.block_base, -1).astype(np.int32)
            self._table_dev = upload(rows, self.device)
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
        mine = (old >= self.block_base) & (old < self.block_base + self.blocks_per_shard)
        if mine.any():  # moves stay in their shard: permute this rank's sub-pool
            perm = np.arange(self.blocks_per_shard + 1)  # + the sink
            perm[self.local_ids(new[mine])] = self.local_ids(old[mine])
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
        """Pool accounting; the bytes are the pools' over every rank and
        this rank's (the per-device bytes: its shard's blocks, its heads)."""
        hbm = self.hbm_bytes()
        s = {
            "block_size": self.block_size,
            "num_blocks": self.num_blocks,
            "blocks_in_use": self.alloc.in_use(),
            "blocks_peak": self.alloc.peak_in_use,
            "tokens_capacity": self.num_blocks * self.block_size,
            "tokens_reserved": self.alloc.in_use() * self.block_size,
            "cache_hbm_bytes": hbm * self.devices,
            "dp_shards": self.dp_shards,
            "per_device_cache_hbm_bytes": hbm,
            "table_uploads": self.table_uploads,
        }
        if self.dp_shards > 1:
            # A device's peak is its shard's, not the aggregate over dp.
            s["blocks_peak_by_shard"] = list(self.alloc.peak_by_shard)
            s["blocks_per_shard"] = self.blocks_per_shard
        return s
