"""GQA attention: causal train/prefill (the flash-attention kernel), the
paged decode / chunked-prefill path through a block table (with optional
int8 KV quantization), the dense (batch, max_len) slab: a causal
prefill that writes each row's K/V from position 0, and decode of S >= 1
new positions per row; and the encoder-decoder's two unmasked modes:
"bidir" (encoder self-attention) and "cross" (decoder queries over the
encoder's ``memory``, no rotary; with a ``cache`` it writes the memory's
K/V into the cross slab for decode).  Both attend in plain torch
(``_bidir_attention``, ``_cross_attention``) as the reference does: the
flash-attention kernel is causal only.

Conventions (the reference's):
  x          (B, S, D)
  positions  (B, S) absolute positions
  paged pools {"k", "v"[, "k_scale", "v_scale"]}: (N + 1, bs, Hkv, hd)
             blocks, the last one a write sink (``init_paged_kv_cache``)
  block_tables (B, M) int32, -1 = no block
  dense slab {"k", "v"[, "k_scale", "v_scale"]}: (B, max_len, Hkv, hd)
  cache_len  (B,) tokens already in each row's cache

Caches are updated IN PLACE (the reference's donated buffers): a decode,
prefill or prefill-chunk call writes its new K/V into the tensors it is
given.  The slab attends with plain torch ops under the reference's mask
(``_naive_attention``, as the reference computes it outside any kernel).
Its int8 form (``k_scale``), as the reference's: a prefill attends with
its own full-precision K/V and writes them quantized; a decode writes its
new K/V quantized and attends over the whole slab dequantized to q's dtype.
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


def _kv_leaves(shape, dtype, device, quant: bool) -> Dict:
    """K/V leaves of ``shape`` (..., Hkv, hd): ``dtype``, or int8 with fp32
    per-(position, head) scales."""
    if quant:
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            "v_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
        }
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device,
                  quant: bool = False, tp: int = 1) -> Dict:
    """The reference's dense (batch, max_len) K/V slab; ``quant``: its int8
    form (symmetric per (position, head), halving the decode's cache reads);
    ``tp``: the ranks of a mesh's model axis, of whose KV heads a rank's
    slab holds its share."""
    return _kv_leaves((batch, max_len, cfg.num_kv_heads // tp, cfg.head_dim), dtype,
                      device, quant)


def init_paged_kv_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                        dtype, device, quant: bool = False, tp: int = 1) -> Dict:
    """Block-pool KV cache shared by all rows (see serving/kvcache), a rank's
    share of the KV heads under ``tp`` model ranks.

    Holds ``num_blocks + 1`` blocks: block ``num_blocks`` is a write sink.
    Writes that must drop are sent there — the reference's positive
    out-of-range sentinel, given memory — so dropping needs no data-dependent
    selection (which would sync with the host).  No table entry names it."""
    return _kv_leaves((num_blocks + 1, block_size, cfg.num_kv_heads // tp, cfg.head_dim),
                      dtype, device, quant)


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
    """Softmax attention in plain torch; ``mask`` None attends every key."""
    scores = _gqa_scores(q, k, scale)
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    return _gqa_out(torch.softmax(scores, dim=-1), v)


# The two unmasked modes, each its own function so that a profile can
# range them apart (chip_smoke's whisper path).
def _bidir_attention(q, k, v, scale):
    """Encoder self-attention: every frame attends every frame."""
    return _naive_attention(q, k, v, None, scale)


def _cross_attention(q, k, v, scale):
    """Decoder queries over the encoder memory's K/V, unmasked."""
    return _naive_attention(q, k, v, None, scale)


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


def _slab_leaves(cache: Dict, k: torch.Tensor, v: torch.Tensor):
    """(leaf name, new values) pairs to write into a slab: K/V, or on the
    int8 slab their int8 values and scales."""
    if "k_scale" not in cache:
        return (("k", k), ("v", v))
    kq, ks = quantize_kv(k)
    vq, vs = quantize_kv(v)
    return (("k", kq), ("v", vq), ("k_scale", ks), ("v_scale", vs))


def _slab_decode_attend(q, k, v, cache, cache_len, scale):
    """Write the S new K/V positions of each row at cache_len.. of its slab
    row (positions past max_len drop), then query i attends positions <=
    cache_len + i.  Position i of every row is written in one indexed
    store (distinct rows, so no index repeats); a dropped write stores the
    slab's last position back as it is.  The int8 slab is attended
    dequantized to q's dtype."""
    b, s = q.shape[:2]
    t_max = cache["k"].shape[1]
    pos = cache_len.long()[:, None] + torch.arange(s, device=q.device)  # (B, S)
    rows = torch.arange(b, device=q.device)
    new = _slab_leaves(cache, k, v)
    for i in range(s):
        keep = pos[:, i] < t_max
        at = pos[:, i].clamp(max=t_max - 1)
        for name, val in new:
            c = cache[name]
            kp = keep.view(b, *([1] * (c.ndim - 2)))
            c[rows, at] = torch.where(kp, val[:, i].to(c.dtype), c[rows, at])
    k_all, v_all = cache["k"], cache["v"]
    if "k_scale" in cache:
        k_all = dequantize_kv(k_all, cache["k_scale"], q.dtype)
        v_all = dequantize_kv(v_all, cache["v_scale"], q.dtype)
    valid = torch.arange(t_max, device=q.device)[None, None, :] <= pos[:, :, None]
    return _naive_attention(q, k_all, v_all, valid[:, None, None], scale)


def _slab_prefill_write(cache, k, v) -> None:
    """Each row's K/V (int8 and scales on the int8 slab) at positions
    0..S-1 of its slab row, zeros after (the reference returns the
    prefill's K/V padded to max_len)."""
    s = k.shape[1]
    for name, new in _slab_leaves(cache, k, v):
        c = cache[name]
        c[:, :s] = new.to(c.dtype)
        c[:, s:] = 0


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
    memory: Optional[torch.Tensor] = None,
    key: str = "attn",
) -> torch.Tensor:
    """mode "causal" (train, or prefill writing the dense slab ``cache``),
    "decode" (paged with ``block_tables``, else the dense slab), "bidir"
    (no mask, no cache) or "cross" (K/V from ``memory`` (B, T, D), no mask
    and no rotary; a ``cache`` is the cross slab, (B, T, Hkv, hd), written
    with the memory's K/V).  ``key`` is the params' key in the layer
    ("attn", or "cross"), the linears' path for the sharding rules."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    scale = 1.0 / math.sqrt(hd)
    if taps is not None:
        taps[f"{tap_prefix}.in"] = x
    if mode == "cross":
        if memory is None:
            raise ValueError("cross attention needs the encoder's memory")
        kv_src = memory
        if taps is not None:
            taps[f"{tap_prefix}.kv_in"] = memory
    else:
        kv_src = x
    t = kv_src.shape[1]
    # Heads from the projections' widths: under a tensor-parallel forward
    # they are this rank's heads (its slice of wq, wk, wv and of the cache).
    q = linear(params["wq"], x, f"{key}/wq").reshape(b, s, -1, hd)
    k = linear(params["wk"], kv_src, f"{key}/wk").reshape(b, t, -1, hd)
    v = linear(params["wv"], kv_src, f"{key}/wv").reshape(b, t, -1, hd)
    if cfg.pos_emb == "rope" and mode != "cross":
        inv_freq = rope_frequencies(hd, cfg.rotary_pct, cfg.rope_theta, x.device)
        q = apply_rope(q, positions, inv_freq)
        k = apply_rope(k, positions, inv_freq)

    if mode == "decode":
        if cache is None or cache_len is None:
            raise ValueError("decode needs a cache and cache_len")
        if block_tables is not None:
            out = _paged_decode_attend(q, k, v, cache, cache_len, block_tables, scale)
        else:
            out = _slab_decode_attend(q, k, v, cache, cache_len, scale)
    elif mode == "causal":
        out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
        if cache is not None:
            _slab_prefill_write(cache, k, v)
    elif mode == "bidir":
        out = _bidir_attention(q, k, v, scale)
    elif mode == "cross":
        out = _cross_attention(q, k, v, scale)
        if cache is not None:
            if cache["k"].shape[1] != t:
                raise ValueError(f"cross slab holds {cache['k'].shape[1]} memory "
                                 f"positions, the memory has {t}")
            cache["k"].copy_(k)
            cache["v"].copy_(v)
    else:
        raise ValueError(f"attention mode {mode!r} is not ported")

    merged = out.reshape(b, s, -1)
    if taps is not None:
        taps[f"{tap_prefix}.out_in"] = merged
    return linear(params["wo"], merged, f"{key}/wo")
