"""Multi-head Latent Attention (minicpm3 / deepseek-v3).

MLA compresses K/V into a small latent ``c_kv`` (kv_lora_rank) plus one
rope key shared by the heads; the cache stores only (c_kv, k_rope), a
dense (batch, max_len, .) slab (``models.api.cache_layout``: its leaves are
not pageable K/V).

Two paths, as the reference's:
  * naive (train, calibration, prefill): expand K and V from the latent for
    every token, then causal attention over them;
  * absorbed (decode, one new token a row): fold W_uk into the query and
    W_uv into the output, so attention runs in latent space over the cached
    c_kv without expanding it.  ``wkv_b`` is materialised for this with
    ``dense_kernel`` every step (u@v + u2@v2 on a compressed model), so at
    decode it launches no nested kernel; every other projection goes
    through ``linear`` (the nested kernel once compressed).

The attention itself is plain torch ops (the reference computes it in jnp
einsums outside any kernel).  Prefill and decode associate the products
differently, so prefill-then-decode matches the full forward only up to
rounding.  Caches are written in place, as ``attention.py``'s are.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional

import torch

from repro_torch.configs.base import ModelConfig

from .layers import linear, linear_init, norm_apply, norm_init
from .lowrank_utils import dense_kernel

NEG_INF = -1e30


def mla_init(gen, cfg: ModelConfig, dtype, device) -> Dict:
    m, d, h = cfg.mla, cfg.d_model, cfg.num_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq_a": linear_init(gen, d, m.q_lora_rank, dtype, device),
        "q_norm": norm_init("rmsnorm", m.q_lora_rank, dtype, device),
        "wq_b": linear_init(gen, m.q_lora_rank, h * qk, dtype, device),
        "wkv_a": linear_init(gen, d, m.kv_lora_rank + m.qk_rope_head_dim, dtype, device),
        "kv_norm": norm_init("rmsnorm", m.kv_lora_rank, dtype, device),
        "wkv_b": linear_init(gen, m.kv_lora_rank,
                             h * (m.qk_nope_head_dim + m.v_head_dim), dtype, device),
        "wo": linear_init(gen, h * m.v_head_dim, d, dtype, device),
    }


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device) -> Dict:
    m = cfg.mla
    return {"c_kv": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype,
                                device=device),
            "k_rope": torch.zeros((batch, max_len, m.qk_rope_head_dim), dtype=dtype,
                                  device=device)}


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate the whole last dim in fp32, pairing its two halves (not
    interleaved pairs); x (B, S, dim) or (B, S, H, dim), positions (B, S)."""
    dim = x.shape[-1]
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=x.device) / dim
    inv_freq = 1.0 / (theta ** exps)
    pos = positions.float()[..., None]
    if x.ndim != positions.ndim + 1:
        pos = pos[..., None]
    ang = pos * inv_freq
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _project_q(params, x, cfg: ModelConfig, positions):
    """(q_nope, q_rope, the normed q latent) with q (B, S, H, nope + rope)."""
    m = cfg.mla
    cq = norm_apply(params["q_norm"], linear(params["wq_a"], x))
    q = linear(params["wq_b"], cq).reshape(*x.shape[:-1], cfg.num_heads,
                                           m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_rope = _rope(q[..., m.qk_nope_head_dim:], positions, cfg.rope_theta)
    return q[..., :m.qk_nope_head_dim], q_rope, cq


def _project_kv_latent(params, x, cfg: ModelConfig, positions):
    """(c_kv (B, S, R) after its norm, k_rope (B, S, r) rotated)."""
    m = cfg.mla
    kv_a = linear(params["wkv_a"], x)
    c_kv = norm_apply(params["kv_norm"], kv_a[..., :m.kv_lora_rank])
    k_rope = _rope(kv_a[..., m.kv_lora_rank:], positions, cfg.rope_theta)
    return c_kv, k_rope


def _naive_attention(params, q_nope, q_rope, c_kv, k_rope, cfg: ModelConfig, scale):
    """Causal attention with K and V expanded from the latent (``wkv_b``
    through ``linear``); returns (B, S, H, v)."""
    m, h = cfg.mla, cfg.num_heads
    b, s = c_kv.shape[:2]
    kv = linear(params["wkv_b"], c_kv).reshape(b, s, h, m.qk_nope_head_dim + m.v_head_dim)
    k_nope, v = kv[..., :m.qk_nope_head_dim], kv[..., m.qk_nope_head_dim:]
    k_rope_h = k_rope[:, :, None, :].expand(b, s, h, m.qk_rope_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_h], dim=-1)
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    causal = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~causal, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhst,bthd->bshd", probs.to(v.dtype), v)


def _absorbed_attention(params, q_nope, q_rope, c_kv, k_rope, cfg: ModelConfig,
                        idx, scale):
    """Decode attention in latent space (W_uk and W_uv absorbed): q_nope
    (B, 1, H, nope), c_kv (B, T, R), k_rope (B, T, r); position t of row b
    is visible when t <= idx[b].  Returns (B, 1, H, v)."""
    m, h = cfg.mla, cfg.num_heads
    wkv_b = dense_kernel(params["wkv_b"]).reshape(m.kv_lora_rank, h,
                                                  m.qk_nope_head_dim + m.v_head_dim)
    w_uk, w_uv = wkv_b[..., :m.qk_nope_head_dim], wkv_b[..., m.qk_nope_head_dim:]
    q_eff = torch.einsum("bshn,rhn->bshr", q_nope, w_uk.to(q_nope.dtype))
    scores = torch.einsum("bshr,btr->bhst", q_eff.float(), c_kv.float())
    scores = scores + torch.einsum("bshr,btr->bhst", q_rope.float(), k_rope.float())
    scores = scores * scale
    t_max = c_kv.shape[1]
    valid = torch.arange(t_max, device=c_kv.device)[None, :] <= idx.long()[:, None]
    scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhst,btr->bshr", probs.to(c_kv.dtype), c_kv)
    return torch.einsum("bshr,rhv->bshv", ctx, w_uv.to(ctx.dtype))


def mla_apply(
    params: Mapping[str, Any],
    x: torch.Tensor,
    cfg: ModelConfig,
    positions: torch.Tensor,
    mode: str = "causal",
    cache: Optional[Dict] = None,
    cache_len: Optional[torch.Tensor] = None,
    taps: Optional[Dict] = None,
    tap_prefix: str = "",
) -> torch.Tensor:
    """mode "causal" (train, or prefill writing the fresh slab ``cache``
    from position 0, zeros after) or "decode" (one new token a row written
    at cache_len of its slab row; a write past max_len drops)."""
    m, h = cfg.mla, cfg.num_heads
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    b, s, _ = x.shape
    if taps is not None:
        taps[f"{tap_prefix}.in"] = x
    q_nope, q_rope, cq = _project_q(params, x, cfg, positions)
    c_kv_new, k_rope_new = _project_kv_latent(params, x, cfg, positions)
    if taps is not None:
        taps[f"{tap_prefix}.q_lora_in"] = cq
        taps[f"{tap_prefix}.kv_lora_in"] = c_kv_new

    if mode == "decode":
        if cache is None or cache_len is None:
            raise ValueError("MLA decode needs a cache and cache_len")
        if s != 1:
            raise ValueError(f"MLA decodes one token a row, got {s}")
        t_max = cache["c_kv"].shape[1]
        rows = torch.arange(b, device=x.device)
        keep = (cache_len.long() < t_max)[:, None]
        at = cache_len.long().clamp(max=t_max - 1)
        for name, new in (("c_kv", c_kv_new), ("k_rope", k_rope_new)):
            c = cache[name]
            c[rows, at] = torch.where(keep, new[:, 0].to(c.dtype), c[rows, at])
        out = _absorbed_attention(params, q_nope, q_rope, cache["c_kv"],
                                  cache["k_rope"], cfg, cache_len, scale)
    elif mode == "causal":
        out = _naive_attention(params, q_nope, q_rope, c_kv_new, k_rope_new, cfg, scale)
        if cache is not None:
            for name, new in (("c_kv", c_kv_new), ("k_rope", k_rope_new)):
                c = cache[name]
                c[:, :s] = new.to(c.dtype)
                c[:, s:] = 0
    else:
        raise ValueError(f"MLA mode {mode!r} is not ported")

    merged = out.reshape(b, s, h * m.v_head_dim)
    if taps is not None:
        taps[f"{tap_prefix}.out_in"] = merged
    return linear(params["wo"], merged)
