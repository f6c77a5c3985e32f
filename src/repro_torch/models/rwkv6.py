"""RWKV6 "Finch": attention-free time mix with data-dependent decay (the
reference's ``models/rwkv6.py``).

  * ddlerp token shift: x_i = x + (x_prev - x) * (mu_i + lora_i(lerp(x)))
    for i in {w, k, v, r, g}
  * data-dependent decay: w_t = exp(-exp(w0 + tanh(x_w W_d1) W_d2)), fp32
  * per-head recurrence on the state S (hd x hd), fp32:
      out_t = r_t . (S_{t-1} + diag(u) k_t^T v_t)
      S_t   = diag(w_t) S_{t-1} + k_t^T v_t
  * per-head group norm, gated by silu(g), then the output projection
  * channel mix: token-shifted squared-relu FFN with a receptance gate

The sequence path (train, and prefill into a fresh row cache) runs the
recurrence through the ``rwkv6`` kernel wrapper, reading the (B, S, H, hd)
projections in place; prefill takes the final state from the kernel.  The
reference scans here with ``lax.scan``; the kernel is held to that scan.
Decode is one plain step against the {shift_t, shift_c, state} cache.

Caches are written IN PLACE (the reference returns new ones): prefill and
decode copy the new state and shifts into the cache tensors they are given.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rwkv6.ops import rwkv6_heads

from .layers import linear, linear_init

MIX_NAMES = ("w", "k", "v", "r", "g")


def _normal(gen, shape, std, dtype, device):
    return (torch.randn(shape, generator=gen, device=device) * std).to(dtype)


def _uniform(gen, shape, lo, hi, dtype, device):
    return (torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo).to(dtype)


def rwkv_time_mix_init(gen, cfg: ModelConfig, dtype, device) -> Dict:
    """The reference's shapes and dtypes: ``decay_w0`` and ``bonus`` stay
    fp32 in a bf16 model."""
    rc, d = cfg.rwkv, cfg.d_model
    n_heads = d // rc.head_dim
    return {
        "mu_x": _uniform(gen, (d,), 0.0, 0.5, dtype, device),
        "mix_w1": _normal(gen, (d, 5 * rc.mix_lora), 0.02, dtype, device),
        "mix_w2": _normal(gen, (5, rc.mix_lora, d), 0.02, dtype, device),
        "mu": _uniform(gen, (5, d), 0.0, 0.5, dtype, device),
        "decay_w0": _uniform(gen, (d,), -8.0, -4.0, torch.float32, device),
        "decay_w1": _normal(gen, (d, rc.decay_lora), 0.02, dtype, device),
        "decay_w2": _normal(gen, (rc.decay_lora, d), 0.02, dtype, device),
        "bonus": _normal(gen, (n_heads, rc.head_dim), 0.02, torch.float32, device),
        "wr": linear_init(gen, d, d, dtype, device),
        "wk": linear_init(gen, d, d, dtype, device),
        "wv": linear_init(gen, d, d, dtype, device),
        "wg": linear_init(gen, d, d, dtype, device),
        "wo": linear_init(gen, d, d, dtype, device),
        "ln_scale": torch.ones(d, dtype=dtype, device=device),
        "ln_bias": torch.zeros(d, dtype=dtype, device=device),
    }


def rwkv_channel_mix_init(gen, cfg: ModelConfig, dtype, device) -> Dict:
    d = cfg.d_model
    return {
        "mu_k": _uniform(gen, (d,), 0.0, 0.5, dtype, device),
        "mu_r": _uniform(gen, (d,), 0.0, 0.5, dtype, device),
        "wk": linear_init(gen, d, cfg.d_ff, dtype, device),
        "wv": linear_init(gen, cfg.d_ff, d, dtype, device),
        "wr": linear_init(gen, d, d, dtype, device),
    }


def init_rwkv_cache(cfg: ModelConfig, batch: int, dtype, device) -> Dict:
    rc, d = cfg.rwkv, cfg.d_model
    n_heads = d // rc.head_dim
    return {
        "shift_t": torch.zeros((batch, d), dtype=dtype, device=device),
        "shift_c": torch.zeros((batch, d), dtype=dtype, device=device),
        "state": torch.zeros((batch, n_heads, rc.head_dim, rc.head_dim),
                             dtype=torch.float32, device=device),
    }


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]) -> torch.Tensor:
    """x_prev per position; position 0 takes ``prev`` (decode) or zeros."""
    first = torch.zeros_like(x[:, :1]) if prev is None else prev[:, None].to(x.dtype)
    return torch.cat([first, x[:, :-1]], dim=1)


def _ddlerp(params, x: torch.Tensor, x_prev: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Data-dependent lerp producing the five mixed inputs (w, k, v, r, g)."""
    xx = x_prev - x
    xxx = x + xx * params["mu_x"]
    lora = torch.tanh(torch.matmul(xxx, params["mix_w1"]))
    lora = lora.reshape(*x.shape[:-1], 5, -1).movedim(-2, 0)  # (5, B, S, lora)
    dyn = torch.einsum("nbsl,nld->nbsd", lora, params["mix_w2"])
    mixed = x[None] + xx[None] * (params["mu"][:, None, None, :] + dyn)
    return {name: mixed[i] for i, name in enumerate(MIX_NAMES)}


def _group_norm(x: torch.Tensor, scale, bias, n_heads: int, eps: float = 1e-5):
    """Per-head layernorm (population variance) in fp32 over the
    concatenated head outputs; the affine runs in fp32 and rounds once."""
    b, s, d = x.shape
    xh = x.reshape(b, s, n_heads, d // n_heads).float()
    mean = xh.mean(-1, keepdim=True)
    var = (xh - mean).square().mean(-1, keepdim=True)
    y = (xh - mean) * torch.rsqrt(var + eps)
    return (y.reshape(b, s, d) * scale.float() + bias.float()).to(x.dtype)


def rwkv_time_mix(params: Mapping, x: torch.Tensor, cfg: ModelConfig, mode: str = "causal",
                  cache: Optional[Dict] = None, taps: Optional[Dict] = None,
                  tap_prefix: str = "") -> torch.Tensor:
    """mode "causal" (train; with ``cache``, a prefill from a fresh zero
    state that writes the final state and shift into it) or "decode" (one
    token per row against ``cache``, updated in place)."""
    hd = cfg.rwkv.head_dim
    d = cfg.d_model
    n_heads = d // hd
    b, s, _ = x.shape

    decode = mode == "decode"
    x_prev = _token_shift(x, cache["shift_t"] if decode else None)
    mixed = _ddlerp(params, x, x_prev)
    if taps is not None:
        for nm in MIX_NAMES:
            taps[f"{tap_prefix}.{nm}_in"] = mixed[nm]

    rf = linear(params["wr"], mixed["r"]).reshape(b, s, n_heads, hd).float()
    kf = linear(params["wk"], mixed["k"]).reshape(b, s, n_heads, hd).float()
    vf = linear(params["wv"], mixed["v"]).reshape(b, s, n_heads, hd).float()
    g = linear(params["wg"], mixed["g"])
    decay = params["decay_w0"] + torch.matmul(
        torch.tanh(torch.matmul(mixed["w"], params["decay_w1"])), params["decay_w2"]).float()
    w = torch.exp(-torch.exp(decay)).reshape(b, s, n_heads, hd)  # in (0, 1)
    u = params["bonus"]  # (H, hd) fp32

    if decode:
        if s != 1:
            raise ValueError(f"rwkv decode takes one token per row, got S={s}")
        state0 = cache["state"]
        kv = kf[:, 0, :, :, None] * vf[:, 0, :, None, :]  # (B, H, hd, hd)
        out = torch.einsum("bhk,bhkv->bhv", rf[:, 0], state0 + u[None, :, :, None] * kv)
        state0.copy_(w[:, 0, :, :, None] * state0 + kv)
        cache["shift_t"].copy_(x[:, -1])
        y = out.reshape(b, 1, d)
    else:
        u_b = u.expand(b, n_heads, hd)
        heads = [t.permute(0, 2, 1, 3) for t in (rf, kf, vf, w)]  # views
        if cache is None:
            out = rwkv6_heads(*heads, u_b)
        else:
            out, state = rwkv6_heads(*heads, u_b, return_state=True)
            cache["state"].copy_(state)
            cache["shift_t"].copy_(x[:, -1])
        y = out.permute(0, 2, 1, 3).reshape(b, s, d)

    y = _group_norm(y.to(x.dtype), params["ln_scale"], params["ln_bias"], n_heads)
    y = y * F.silu(g)
    if taps is not None:
        taps[f"{tap_prefix}.out_in"] = y
    return linear(params["wo"], y)


def rwkv_channel_mix(params: Mapping, x: torch.Tensor, cfg: ModelConfig,
                     mode: str = "causal", cache: Optional[Dict] = None,
                     taps: Optional[Dict] = None, tap_prefix: str = "") -> torch.Tensor:
    """Squared-relu FFN on the token-shifted input; with ``cache`` it
    writes its shift in place (decode also reads it)."""
    x_prev = _token_shift(x, cache["shift_c"] if mode == "decode" else None)
    xx = x_prev - x
    xk = x + xx * params["mu_k"]
    xr = x + xx * params["mu_r"]
    if taps is not None:
        taps[f"{tap_prefix}.k_in"] = xk
        taps[f"{tap_prefix}.r_in"] = xr
    h = torch.square(torch.relu(linear(params["wk"], xk)))
    if taps is not None:
        taps[f"{tap_prefix}.mid"] = h
    v = linear(params["wv"], h)
    y = torch.sigmoid(linear(params["wr"], xr)) * v
    if cache is not None:
        cache["shift_c"].copy_(x[:, -1])
    return y
