"""Plain PyTorch version of paged-attention decode.

The KV cache lives in a shared block pool (num_blocks, block_size, Hkv, hd);
logical position p of row b sits at ``pool[block_tables[b, p // bs], p % bs]``.
The plain version gathers every row's pages into a dense (B, M*bs, Hkv, hd)
view and runs a masked softmax.  Table entries < 0 are clamped to block 0;
the length mask hides what that reads.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def gather_pages(pool: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """pool (N, bs, ...), block_tables (B, M) -> (B, M*bs, ...)."""
    g = pool[block_tables.clamp(min=0).long()]  # (B, M, bs, ...)
    return g.reshape(g.shape[0], -1, *pool.shape[2:])


def paged_attention_ref(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,
    lengths: torch.Tensor,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """q (B, Hq, hd); pools (N, bs, Hkv, hd) (int8 with (N, bs, Hkv) fp32
    scales); block_tables (B, M) int32; lengths (B,) = cache_len + 1.
    Returns (B, Hq, hd) in q.dtype."""
    b, hq, hd = q.shape
    hkv = k_pages.shape[2]
    g = hq // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    k = gather_pages(k_pages, block_tables)
    v = gather_pages(v_pages, block_tables)
    if k_scales is not None:
        k = (k.float() * gather_pages(k_scales, block_tables)[..., None]).to(q.dtype)
        v = (v.float() * gather_pages(v_scales, block_tables)[..., None]).to(q.dtype)
    qg = q.reshape(b, hkv, g, hd)
    scores = torch.einsum("bkgd,btkd->bkgt", qg.float(), k.float()) * scale
    t = k.shape[1]
    valid = torch.arange(t, device=q.device)[None, :] < lengths[:, None].long()
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", probs.to(v.dtype), v)
    return out.reshape(b, hq, hd).to(q.dtype)
