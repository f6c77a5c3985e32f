"""Paged KV-cache: host block allocator + device block pools."""

from .allocator import BlockAllocator
from .paged import PagedKVCache, resolve_num_blocks, upload

__all__ = ["BlockAllocator", "PagedKVCache", "resolve_num_blocks", "upload"]
