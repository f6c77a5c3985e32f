"""GQA attention: causal train/prefill (the flash-attention kernel) and the
paged decode / chunked-prefill path through a block table, with optional
int8 KV quantization.

Conventions (the reference's):
  x          (B, S, D)
  positions  (B, S) absolute positions
  paged pools {"k", "v"[, "k_scale", "v_scale"]}: (N + 1, bs, Hkv, hd)
             blocks, the last one a write sink (``init_paged_kv_cache``)
  block_tables (B, M) int32, -1 = no block
  cache_len  (B,) tokens already in each row's cache

Pools are updated IN PLACE (the reference's donated buffers): a decode or
prefill-chunk call writes its new K/V into the pool tensors it is given.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.paged_attention.ops import gather_pages, paged_attention

from .layers import apply_rope, linear, linear_init, rope_frequencies

NEG_INF = -1e30


def attention_init(gen, cfg: ModelConfig, dtype, device) -> Dict:
    d, hd = cfg.d_model, cfg.head_dim
    return {
        "wq": linear_init(gen, d, cfg.num_heads * hd, dtype, device),
        "wk": linear_init(gen, d, cfg.num_kv_heads * hd, dtype, device),
        "wv": linear_init(gen, d, cfg.num_kv_heads * hd, dtype, device),
        "wo": linear_init(gen, cfg.num_heads * hd, d, dtype, device),
    }


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device) -> Dict:
    """The reference's dense (batch, max_len) K/V slab.  The port decodes
    attention through the paged pools only; this slab names the leaves
    ``models.api.cache_layout`` reads."""
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_paged_kv_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                        dtype, device, quant: bool = False) -> Dict:
    """Block-pool KV cache shared by all rows (see serving/kvcache).

    Holds ``num_blocks + 1`` blocks: block ``num_blocks`` is a write sink.
    Writes that must drop are sent there — the reference's positive
    out-of-range sentinel, given memory — so dropping needs no data-dependent
    selection (which would sync with the host).  No table entry names it."""
    shape = (num_blocks + 1, block_size, cfg.num_kv_heads, cfg.head_dim)
    if quant:
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:3], dtype=torch.float32, device=device),
            "v_scale": torch.zeros(shape[:3], dtype=torch.float32, device=device),
        }
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (..., hd) -> (int8, scale (...)), symmetric per vector."""
    xf = x.float()
    scale = (xf.abs().amax(-1) / 127.0).clamp(min=1e-8)
    q = torch.round(xf / scale[..., None]).clamp(-127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


def _gqa_scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """q (B,S,Hq,hd), k (B,T,Hkv,hd) -> fp32 scores (B,Hkv,G,S,T)."""
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, hq // hkv, hd)
    return torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * scale


def _gqa_out(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs (B,Hkv,G,S,T), v (B,T,Hkv,hd) -> (B,S,Hq,hd)."""
    b, hkv, g, s, _ = probs.shape
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)
    return out.reshape(b, s, hkv * g, v.shape[-1])


def _naive_attention(q, k, v, mask, scale):
    scores = _gqa_scores(q, k, scale)
    scores = scores.masked_fill(~mask, NEG_INF)
    return _gqa_out(torch.softmax(scores, dim=-1), v)


def _paged_decode_attend(q, k, v, cache, cache_len, block_tables, scale):
    """Write the S new K/V positions of each row into the block pool through
    its table row, then attend each query over its row's logical prefix.

    A write whose table entry is -1 (unallocated, or forced -1 for a dead or
    padding row) or whose block index runs past the table DROPS: it lands
    in the pool's sink block (see ``init_paged_kv_cache``).  A -1 must never
    reach the flat index itself: torch indexing, like jnp's, wraps negatives
    onto the last slot.  S == 1 is a decode step through the paged-attention
    kernel; S > 1 is one chunk of streaming prefill over the gathered pages.
    """
    b, s = q.shape[:2]
    nb, bs = cache["k"].shape[0] - 1, cache["k"].shape[1]  # last block: sink
    m = block_tables.shape[1]
    pos = cache_len.long()[:, None] + torch.arange(s, device=q.device)  # (B, S)
    blk = pos // bs
    phys = torch.gather(block_tables.long(), 1, blk.clamp(max=m - 1))
    ok = (blk < m) & (phys >= 0)
    flat = torch.where(ok, phys, nb) * bs + pos % bs

    def scat(pool, new):
        pf = pool.view((nb + 1) * bs, *pool.shape[2:])
        pf.index_copy_(0, flat.reshape(-1),
                       new.reshape(b * s, *new.shape[2:]).to(pool.dtype))

    if "k_scale" in cache:
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        scat(cache["k"], kq)
        scat(cache["v"], vq)
        scat(cache["k_scale"], ks)
        scat(cache["v_scale"], vs)
        k_sc, v_sc = cache["k_scale"], cache["v_scale"]
    else:
        scat(cache["k"], k)
        scat(cache["v"], v)
        k_sc = v_sc = None

    if s == 1:
        out = paged_attention(
            q[:, 0].contiguous(), cache["k"], cache["v"], block_tables,
            (cache_len + 1).to(torch.int32), k_scales=k_sc, v_scales=v_sc,
            scale=scale)
        return out[:, None]
    kg = gather_pages(cache["k"], block_tables)
    vg = gather_pages(cache["v"], block_tables)
    if k_sc is not None:
        kg = dequantize_kv(kg, gather_pages(k_sc, block_tables), q.dtype)
        vg = dequantize_kv(vg, gather_pages(v_sc, block_tables), q.dtype)
    t = kg.shape[1]
    valid = torch.arange(t, device=q.device)[None, None, :] <= pos[:, :, None]
    return _naive_attention(q, kg, vg, valid[:, None, None], scale)


def attention_apply(
    params: Mapping[str, Any],
    x: torch.Tensor,
    cfg: ModelConfig,
    positions: torch.Tensor,
    mode: str = "causal",
    cache: Optional[Dict] = None,
    cache_len: Optional[torch.Tensor] = None,
    block_tables: Optional[torch.Tensor] = None,
    taps: Optional[Dict] = None,
    tap_prefix: str = "",
) -> torch.Tensor:
    """mode "causal" (train/prefill, no cache) or "decode" (paged)."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    scale = 1.0 / math.sqrt(hd)
    if taps is not None:
        taps[f"{tap_prefix}.in"] = x
    q = linear(params["wq"], x).reshape(b, s, cfg.num_heads, hd)
    k = linear(params["wk"], x).reshape(b, s, cfg.num_kv_heads, hd)
    v = linear(params["wv"], x).reshape(b, s, cfg.num_kv_heads, hd)
    if cfg.pos_emb == "rope":
        inv_freq = rope_frequencies(hd, cfg.rotary_pct, cfg.rope_theta, x.device)
        q = apply_rope(q, positions, inv_freq)
        k = apply_rope(k, positions, inv_freq)

    if mode == "decode":
        if block_tables is None or cache is None or cache_len is None:
            raise ValueError("decode needs a paged cache, cache_len and "
                             "block_tables (the dense-slab decode is not ported)")
        out = _paged_decode_attend(q, k, v, cache, cache_len, block_tables, scale)
    elif mode == "causal":
        out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    else:
        raise ValueError(f"attention mode {mode!r} is not ported")

    merged = out.reshape(b, s, -1)
    if taps is not None:
        taps[f"{tap_prefix}.out_in"] = merged
    return linear(params["wo"], merged)
