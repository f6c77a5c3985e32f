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


def split_partials_ref(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,
    lengths: torch.Tensor,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    n_splits: int = 1,
    pps: Optional[int] = None,
):
    """The split kernel's partials in plain PyTorch: split s of a row covers
    table columns [s*pps, (s+1)*pps); over its live tokens it keeps the fp32
    running max ``m`` of the scores in log2 units, ``l = sum 2^(s - m)`` and
    the unnormalized ``acc = sum 2^(s - m) v`` (m = -inf, l = 0, acc = 0 where
    it reaches no token).  K/V stay fp32 after dequantization.  Returns
    (acc (B*Hkv, n_splits, G, hd), ml (B*Hkv, n_splits, G, 2)), the
    kernel's workspace layout."""
    b, hq, hd = q.shape
    bs, hkv = k_pages.shape[1], k_pages.shape[2]
    g = hq // hkv
    m_cols = block_tables.shape[1]
    pps = pps if pps is not None else -(-m_cols // n_splits)
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    k = gather_pages(k_pages, block_tables).float()
    v = gather_pages(v_pages, block_tables).float()
    if k_scales is not None:
        k = k * gather_pages(k_scales, block_tables)[..., None]
        v = v * gather_pages(v_scales, block_tables)[..., None]
    t = k.shape[1]
    width = n_splits * pps * bs  # pad the token axis to whole splits
    k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, width - t))
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, width - t))
    log2e = 1.0 / math.log(2.0)
    scores = torch.einsum("bkgd,btkd->bkgt", q.reshape(b, hkv, g, hd).float(), k) \
        * (scale * log2e)
    live = torch.arange(width, device=q.device)[None, :] < lengths.clamp(0, t)[:, None].long()
    scores = scores.masked_fill(~live[:, None, None, :], -math.inf)
    s = scores.reshape(b, hkv, g, n_splits, pps * bs)
    m = s.amax(-1)  # (B, Hkv, G, n_splits); -inf where a split reaches no token
    p = torch.exp2(s - torch.where(torch.isinf(m), 0.0, m)[..., None])
    l = p.sum(-1)
    acc = torch.einsum("bkgsj,bsjkd->bkgsd", p, v.reshape(b, n_splits, pps * bs, hkv, hd))
    acc = acc.permute(0, 1, 3, 2, 4).reshape(b * hkv, n_splits, g, hd)
    ml = torch.stack([m, l], -1).permute(0, 1, 3, 2, 4).reshape(b * hkv, n_splits, g, 2)
    return acc, ml


def combine_partials_ref(acc: torch.Tensor, ml: torch.Tensor, lengths: torch.Tensor,
                         bs: int, max_blocks: int, pps: int,
                         dtype: torch.dtype) -> torch.Tensor:
    """The combine kernel in plain PyTorch: over the splits a row's length
    reaches, sum_s 2^(m_s - M) acc_s / sum_s 2^(m_s - M) l_s with M = max_s
    m_s; zeros for a row that reaches none.  Reads nothing of the splits
    past a row's length.  Returns (B, Hkv*G, hd) in ``dtype``."""
    bhkv, n_splits, g, hd = acc.shape
    b = lengths.shape[0]
    pages = -(-lengths.long().clamp(0, max_blocks * bs) // bs)
    n_live = torch.minimum(-(-pages // pps), torch.tensor(n_splits))  # (B,)
    reach = torch.arange(n_splits, device=acc.device)[None, :] < n_live[:, None]
    reach = reach.repeat_interleave(bhkv // b, 0)[..., None]  # (B*Hkv, S, 1)
    m = torch.where(reach, ml[..., 0], -math.inf)
    big = m.amax(1, keepdim=True)
    w = torch.where(torch.isinf(m), 0.0, torch.exp2(m - torch.where(torch.isinf(big), 0.0, big)))
    num = (w[..., None] * torch.where(reach[..., None], acc, 0.0)).sum(1)
    den = (w * torch.where(reach, ml[..., 1], 0.0)).sum(1)[..., None]
    out = torch.where(den > 0, num / den.clamp_min(1e-30), 0.0)
    return out.reshape(b, -1, hd).to(dtype)


def paged_attention_split_ref(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,
    lengths: torch.Tensor,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    n_splits: int = 1,
    pps: Optional[int] = None,
) -> torch.Tensor:
    """The split kernel's decomposition end to end in plain PyTorch (tests
    only): ``split_partials_ref``, then ``combine_partials_ref``.  A
    length-0 row yields zeros, as the kernel's does."""
    m_cols = block_tables.shape[1]
    pps = pps if pps is not None else -(-m_cols // n_splits)
    acc, ml = split_partials_ref(q, k_pages, v_pages, block_tables, lengths, k_scales,
                                 v_scales, scale, n_splits, pps)
    return combine_partials_ref(acc, ml, lengths, k_pages.shape[1], m_cols, pps, q.dtype)
