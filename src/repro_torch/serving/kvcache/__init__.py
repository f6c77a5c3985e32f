"""Paged KV-cache: host block allocator + device block pools."""

from .allocator import BlockAllocator
from .paged import PagedKVCache, pool_leaves, resolve_num_blocks, upload

__all__ = ["BlockAllocator", "PagedKVCache", "pool_leaves", "resolve_num_blocks", "upload"]
