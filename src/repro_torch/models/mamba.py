"""Mamba (S6) selective-state-space mixer, jamba's sequence layer (the
reference's ``models/mamba.py``).

The diagonal-A recurrence, per channel d and state n, in fp32:

    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t x_t,     y_t = C_t . h_t + D x_t

runs chunked, as the reference's: a loop over chunks carries the (B, Di, N)
state, and inside a chunk a log-depth prefix scan (Hillis-Steele over the
chunk axis) with the reference's combine (a1 a2, b2 + a2 b1) gives every
position's state.  Only one chunk's (B, chunk, Di, N) fp32 tensors are live;
``CHUNK`` (64, against the reference's 256) bounds them on the card: a
calibration batch of 16 x 128 tokens at jamba's Di 8192 makes 537 MB
tensors a chunk instead of 1.07 GB.  Chunking changes rounding only.  Any
length S is taken (the last chunk may be shorter); the reference's reshape
raises where S > 256 is not a multiple of S // 256.  The scan and the
depthwise conv are plain torch: the reference has no Pallas kernel for them.

``dt_proj`` goes through ``linear`` and then adds its bias: a dense leaf is
the reference's matmul, a factored one (``compress_params`` keeps the bias
beside the factors) runs the nested kernel.  The reference reads the dense
kernel directly, so a compressed jamba cannot run there.

Decode is a single-step state update against the {"h", "conv"} cache.
Prefill (causal with a cache) writes the final state and the conv tail (the
last d_conv - 1 inputs, left-padded with zeros when the prompt is shorter,
which is what decode from a zero tail computes).  Caches are written IN
PLACE (the reference returns new ones).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

from .layers import linear, linear_init

CHUNK = 64


def dt_rank_of(cfg: ModelConfig) -> int:
    """The config's dt_rank (0 there: ceil(d_model / 16))."""
    return cfg.mamba.dt_rank or -(-cfg.d_model // 16)


def _normal(gen, shape, std, dtype, device):
    return (torch.randn(shape, generator=gen, device=device) * std).to(dtype)


def mamba_init(gen, cfg: ModelConfig, dtype, device) -> Dict:
    """The reference's shapes and dtypes: ``a_log`` (S4D-real) and
    ``d_skip`` stay fp32 in a bf16 model."""
    mc, d = cfg.mamba, cfg.d_model
    di, ns, dt_rank = mc.d_inner, mc.d_state, dt_rank_of(cfg)
    a_init = torch.arange(1, ns + 1, dtype=torch.float32, device=device).repeat(di, 1)
    return {
        "in_proj": linear_init(gen, d, 2 * di, dtype, device),
        "conv": {"w": _normal(gen, (mc.d_conv, di), 0.1, dtype, device),
                 "b": torch.zeros(di, dtype=dtype, device=device)},
        "x_proj": linear_init(gen, di, dt_rank + 2 * ns, dtype, device),
        "dt_proj": {"kernel": _normal(gen, (dt_rank, di), dt_rank ** -0.5, dtype, device),
                    "bias": torch.full((di,), -4.6, dtype=dtype, device=device)},
        "a_log": torch.log(a_init),
        "d_skip": torch.ones(di, dtype=torch.float32, device=device),
        "out_proj": linear_init(gen, di, d, dtype, device),
    }


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype, device) -> Dict:
    """One row's state whatever the length: ``h`` fp32 (B, Di, N) and the
    conv tail (B, d_conv - 1, Di) in the model's dtype."""
    mc = cfg.mamba
    return {"h": torch.zeros((batch, mc.d_inner, mc.d_state), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, mc.d_conv - 1, mc.d_inner), dtype=dtype,
                                device=device)}


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                tail: Optional[torch.Tensor]) -> torch.Tensor:
    """x (B, S, Di), w (K, Di): causal, the K - 1 positions before x taken
    from ``tail`` (or zeros); summed tap by tap in x's dtype, as the
    reference."""
    k, s = w.shape[0], x.shape[1]
    if tail is None:
        tail = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([tail.to(x.dtype), x], dim=1)
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + xp[:, i:i + s] * w[i]
    return out + b


def _ssm_params(params: Mapping, xc: torch.Tensor, cfg: ModelConfig, taps=None,
                tap_prefix: str = ""):
    """(dt (B, S, Di), A (Di, N), B (B, S, N), C (B, S, N)), all fp32."""
    ns, dt_rank = cfg.mamba.d_state, dt_rank_of(cfg)
    if taps is not None:
        taps[f"{tap_prefix}.ssm_in"] = xc
    proj = linear(params["x_proj"], xc)
    dt_in = proj[..., :dt_rank]
    if taps is not None:
        taps[f"{tap_prefix}.dt_in"] = dt_in
    b_mat = proj[..., dt_rank:dt_rank + ns]
    c_mat = proj[..., dt_rank + ns:]
    dt = linear(params["dt_proj"], dt_in) + params["dt_proj"]["bias"]
    dt = F.softplus(dt.float())
    a = -torch.exp(params["a_log"].float())
    return dt, a, b_mat.float(), c_mat.float()


def _prefix_scan(da: torch.Tensor, dbx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan over axis 1 of the elements (a, b) under the
    reference's combine (a1, b1) . (a2, b2) = (a1 a2, b2 + a2 b1), e1 the
    earlier: Hillis-Steele, log2(L) passes over the whole chunk."""
    a, b = da, dbx
    step = 1
    while step < a.shape[1]:
        b = torch.cat([b[:, :step], b[:, step:] + a[:, step:] * b[:, :-step]], dim=1)
        a = torch.cat([a[:, :step], a[:, :-step] * a[:, step:]], dim=1)
        step *= 2
    return a, b


def chunk_scan(dt, a, b_mat, c_mat, xc, h0, chunk: int = CHUNK):
    """dt (B, S, Di), a (Di, N), b_mat / c_mat (B, S, N), xc (B, S, Di), h0
    (B, Di, N) -> (y (B, S, Di) fp32, the final state (B, Di, N)).  The
    decay and input-outer tensors are formed inside the chunk loop, so one
    chunk's (B, chunk, Di, N) tensors are live at a time."""
    s = dt.shape[1]
    bx = dt * xc.float()
    h, ys = h0, []
    for t0 in range(0, s, chunk):
        t1 = min(s, t0 + chunk)
        da = torch.exp(dt[:, t0:t1, :, None] * a)
        dbx = bx[:, t0:t1, :, None] * b_mat[:, t0:t1, None, :]
        acc_a, acc_b = _prefix_scan(da, dbx)
        h_t = acc_a * h[:, None] + acc_b
        ys.append(torch.einsum("bsdn,bsn->bsd", h_t, c_mat[:, t0:t1]))
        h = h_t[:, -1]
    return torch.cat(ys, dim=1), h


def ssm_step(dt, a, b_mat, c_mat, xc, h):
    """One decode step of the recurrence: (y (B, 1, Di) fp32, the new
    state (B, Di, N)) from the state ``h`` and one position's inputs."""
    da = torch.exp(dt[:, 0, :, None] * a)
    dbx = (dt[:, 0] * xc[:, 0].float())[..., None] * b_mat[:, 0, None, :]
    h = da * h + dbx
    return torch.einsum("bdn,bn->bd", h, c_mat[:, 0])[:, None, :], h


def mamba_apply(params: Mapping, x: torch.Tensor, cfg: ModelConfig, mode: str = "causal",
                cache: Optional[Dict] = None, chunk: int = CHUNK,
                taps: Optional[Dict] = None, tap_prefix: str = "") -> torch.Tensor:
    """mode "causal" (train; with ``cache``, a prefill from a zero state that
    writes the final state and the conv tail into it) or "decode" (one
    token per row against ``cache``, updated in place).  Taps ``….in``,
    ``.ssm_in``, ``.dt_in`` and ``.out_in``, as the reference's."""
    mc = cfg.mamba
    b, s, _ = x.shape
    if taps is not None:
        taps[f"{tap_prefix}.in"] = x
    xz = linear(params["in_proj"], x)
    xpart, z = xz.chunk(2, dim=-1)
    w, cb = params["conv"]["w"], params["conv"]["b"]
    if mode == "decode":
        if cache is None or s != 1:
            raise ValueError("Mamba decode takes one token a row against a cache")
        tail = cache["conv"]
        xc = F.silu(causal_conv(xpart, w, cb, tail))
        new_tail = torch.cat([tail[:, 1:], xpart.to(tail.dtype)], dim=1)
        dt, a, b_mat, c_mat = _ssm_params(params, xc, cfg, taps, tap_prefix)
        y, h = ssm_step(dt, a, b_mat, c_mat, xc, cache["h"])
        cache["h"].copy_(h)
        cache["conv"].copy_(new_tail)
    elif mode == "causal":
        xc = F.silu(causal_conv(xpart, w, cb, None))
        dt, a, b_mat, c_mat = _ssm_params(params, xc, cfg, taps, tap_prefix)
        h0 = torch.zeros((b, mc.d_inner, mc.d_state), dtype=torch.float32, device=x.device)
        y, h_final = chunk_scan(dt, a, b_mat, c_mat, xc, h0, chunk)
        if cache is not None:
            k = mc.d_conv - 1
            tail = xpart[:, -k:]
            if s < k:  # a short prompt: the zeros before it
                tail = torch.cat([tail.new_zeros((b, k - s, tail.shape[2])), tail], dim=1)
            cache["h"].copy_(h_final)
            cache["conv"].copy_(tail)
    else:
        raise ValueError(f"Mamba mode {mode!r}: 'causal' or 'decode'")
    y = y.to(x.dtype) + params["d_skip"].to(x.dtype) * xc
    y = y * F.silu(z)
    if taps is not None:
        taps[f"{tap_prefix}.out_in"] = y
    return linear(params["out_proj"], y)
