"""Host-side block allocator for the paged KV cache.

Pure bookkeeping — no device arrays.  Physical blocks are integer ids into
the device block pool; the allocator hands contiguous-in-ID-order *lists*
(not contiguous memory — the block table absorbs any fragmentation) to
owners (engine slots) and reclaims them when a request finishes.

Sharding: when the device pools are sharded over their block dim across a
DP mesh axis (``num_shards > 1``), block id space is partitioned into
``num_shards`` contiguous ranges — block ``b`` lives on device shard
``b // blocks_per_shard`` — and every allocation is pinned to one shard so
a slot's reads/writes stay device-local.  The allocator stays fully
host-authoritative per shard: each shard has its own free list, its own
backpressure, and its own peak, with ``num_shards == 1`` reproducing the
unsharded behavior exactly.

``defrag()`` compacts live blocks into the lowest ids OF THEIR SHARD RANGE
and returns the move map; moves never cross shards, so the engine's device
permutation is block-diagonal over the mesh (no cross-device traffic).
With block tables, compaction is never needed for correctness — it exists
so a pool can be shrunk (or a snapshot taken) from a per-shard prefix."""

from __future__ import annotations

from typing import Dict, Hashable, List, Optional


class BlockAllocator:
    def __init__(self, num_blocks: int, num_shards: int = 1):
        if num_blocks <= 0:
            raise ValueError(f"num_blocks must be positive, got {num_blocks}")
        if num_shards <= 0:
            raise ValueError(f"num_shards must be positive, got {num_shards}")
        if num_blocks % num_shards != 0:
            raise ValueError(
                f"num_blocks={num_blocks} not divisible by "
                f"num_shards={num_shards}"
            )
        self.num_blocks = num_blocks
        self.num_shards = num_shards
        self.blocks_per_shard = num_blocks // num_shards
        # Ascending free list per shard; allocation pops the lowest ids
        # first, which keeps live blocks clustered and defrag moves small.
        self._free: List[List[int]] = [
            list(range(s * self.blocks_per_shard,
                       (s + 1) * self.blocks_per_shard))
            for s in range(num_shards)
        ]
        self._owned: Dict[Hashable, List[int]] = {}
        # Peak accounting: aggregate (all shards, the historical metric) AND
        # per shard — per-DEVICE HBM truthfulness when pools are sharded.
        self.peak_in_use = 0
        self.peak_by_shard: List[int] = [0] * num_shards
        # Lifetime event counters (plain ints, no deps): scraped by the
        # observability layer (repro.obs) and snapshotted by the engine —
        # bookkeeping only, never consulted for allocation decisions.
        self.counters: Dict[str, int] = {
            "alloc_calls": 0, "alloc_denied": 0, "alloc_blocks": 0,
            "grow_calls": 0, "grow_denied": 0, "grown_blocks": 0,
            "free_calls": 0, "freed_blocks": 0,
            "release_suffix_calls": 0, "defrag_calls": 0,
            "defrag_moved_blocks": 0,
        }

    # ------------------------------------------------------------ queries

    def home_shard(self, block: int) -> int:
        return block // self.blocks_per_shard

    def in_use(self, shard: Optional[int] = None) -> int:
        if shard is None:
            return self.num_blocks - sum(len(f) for f in self._free)
        return self.blocks_per_shard - len(self._free[shard])

    def free_blocks(self, shard: Optional[int] = None) -> int:
        if shard is None:
            return sum(len(f) for f in self._free)
        return len(self._free[shard])

    def owned_by(self, owner: Hashable) -> List[int]:
        return list(self._owned.get(owner, ()))

    def can_alloc(self, n: int, shard: int = 0) -> bool:
        return n <= len(self._free[shard])

    # ------------------------------------------------------------ mutation

    def _note_peaks(self) -> None:
        self.peak_in_use = max(self.peak_in_use, self.in_use())
        for s in range(self.num_shards):
            self.peak_by_shard[s] = max(self.peak_by_shard[s], self.in_use(s))

    def alloc(self, owner: Hashable, n: int, shard: int = 0) -> Optional[List[int]]:
        """Allocate n blocks for owner from one shard's range (appending to
        any it already holds).  Returns the new block ids, or None (and no
        state change) when the shard cannot satisfy the request — admission
        backpressure is per shard."""
        if n < 0:
            raise ValueError(f"negative block count {n}")
        self.counters["alloc_calls"] += 1
        free = self._free[shard]
        if n > len(free):
            self.counters["alloc_denied"] += 1
            return None
        ids = free[:n]
        del free[:n]
        self.counters["alloc_blocks"] += n
        self._owned.setdefault(owner, []).extend(ids)
        self._note_peaks()
        return ids

    def grow(self, owner: Hashable, n: int, shard: int = 0) -> Optional[List[int]]:
        """Extend an EXISTING owner's reservation by n blocks from its home
        shard — the allocate-on-demand path: admission reserves the prompt,
        and decode grows the suffix one block boundary at a time.  Returns
        the appended ids, or None (no state change) when the shard is dry
        (caller stalls the row or preempts a victim).  Distinct counters
        from ``alloc`` so occupancy telemetry can split admission
        reservations from on-demand growth."""
        if n < 0:
            raise ValueError(f"negative block count {n}")
        if owner not in self._owned:
            raise KeyError(f"grow for unknown owner {owner!r}")
        self.counters["grow_calls"] += 1
        free = self._free[shard]
        if n > len(free):
            self.counters["grow_denied"] += 1
            return None
        ids = free[:n]
        del free[:n]
        self.counters["grown_blocks"] += n
        self._owned[owner].extend(ids)
        self._note_peaks()
        return ids

    def free(self, owner: Hashable) -> List[int]:
        """Release all blocks held by owner to their home shards (no-op for
        unknown owners)."""
        ids = self._owned.pop(owner, [])
        if ids:
            self.counters["free_calls"] += 1
            self.counters["freed_blocks"] += len(ids)
        self._return(ids)
        return ids

    def _return(self, ids: List[int]) -> None:
        if not ids:
            return
        touched = set()
        for b in ids:
            s = self.home_shard(b)
            self._free[s].append(b)
            touched.add(s)
        for s in touched:
            self._free[s].sort()

    def release_suffix(self, owner: Hashable, n_keep: int) -> List[int]:
        """Shrink an owner to its FIRST n_keep blocks, returning the freed
        suffix.  The block table maps logical positions to blocks in owned
        order, so a per-row length rollback frees exactly this suffix —
        the allocator half of the cache-rollback API."""
        if n_keep < 0:
            raise ValueError(f"negative n_keep {n_keep}")
        ids = self._owned.get(owner, [])
        freed = ids[n_keep:]
        if freed:
            self.counters["release_suffix_calls"] += 1
            self.counters["freed_blocks"] += len(freed)
            self._owned[owner] = ids[:n_keep]
            if not self._owned[owner]:
                del self._owned[owner]
            self._return(freed)
        return freed

    def defrag(self) -> Dict[int, int]:
        """Compact live blocks into the lowest ids of their shard range:
        returns {old: new} for every moved block and rewrites the per-owner
        lists in place.  Shard-local by construction (one shard == the
        historical whole-pool compaction)."""
        moves: Dict[int, int] = {}
        live_all = sorted(b for ids in self._owned.values() for b in ids)
        for s in range(self.num_shards):
            base = s * self.blocks_per_shard
            live = [b for b in live_all if self.home_shard(b) == s]
            moves.update({old: base + new for new, old in enumerate(live)
                          if old != base + new})
            self._free[s] = list(range(base + len(live),
                                       base + self.blocks_per_shard))
        if moves:
            for ids in self._owned.values():
                ids[:] = [moves.get(b, b) for b in ids]
        self.counters["defrag_calls"] += 1
        self.counters["defrag_moved_blocks"] += len(moves)
        return moves
