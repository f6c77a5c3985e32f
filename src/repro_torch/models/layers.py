"""Shared model layers: norms, rotary embeddings, MLPs, embeddings.

Plain functions over dict param trees (the reference's keys), so a
reference checkpoint drops in.  Every linear goes through
``core.lowrank.linear_apply``, so compressed params are drop-in too.

Under a mesh whose model axis has more than one rank (inside
``parallel.collectives.tensor_parallel``), a linear called with its path
takes its role, column or row parallel, from the sharding rules
(``parallel.sharding._match_linear``) and runs on the rank's local shards
(``core.lowrank.tp_linear_apply``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch
import torch.nn.functional as F

from repro_torch.core.lowrank import linear_apply, tp_linear_apply
from repro_torch.parallel.collectives import current_tp
from repro_torch.parallel.sharding import _match_linear


def linear_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype,
                device, scale: float = 1.0) -> Dict[str, torch.Tensor]:
    std = scale / (in_dim ** 0.5)
    w = torch.randn((in_dim, out_dim), generator=gen, device=device) * std
    return {"kernel": w.to(dtype)}


def linear(params: Mapping[str, Any], x: torch.Tensor, path: str = "") -> torch.Tensor:
    """y = x @ W; ``path`` ("attn/wq", "mlp/wo", "rwkv_c/wk", ...) names the
    linear for the sharding rules when a tensor-parallel forward runs."""
    par = current_tp()
    if par is not None and path:
        axes = _match_linear(path)
        if axes is not None and axes != (None, None):
            return tp_linear_apply(params, x, *axes, par)
    return linear_apply(params, x)


# ---------------------------------------------------------------- norms

def norm_init(kind: str, dim: int, dtype, device) -> Dict[str, torch.Tensor]:
    if kind == "rmsnorm":
        return {"scale": torch.ones(dim, dtype=dtype, device=device)}
    if kind == "layernorm":
        return {"scale": torch.ones(dim, dtype=dtype, device=device),
                "bias": torch.zeros(dim, dtype=dtype, device=device)}
    raise ValueError(kind)


def norm_apply(params: Mapping[str, Any], x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm or LayerNorm (by the presence of "bias"), computed in fp32."""
    xf = x.float()
    if "bias" in params:
        mean = xf.mean(-1, keepdim=True)
        var = (xf - mean).square().mean(-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + eps)
        y = y * params["scale"].float() + params["bias"].float()
    else:
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * params["scale"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------- rotary

def rope_frequencies(head_dim: int, rotary_pct: float, theta: float,
                     device=None) -> torch.Tensor:
    """Inverse frequencies of the rotated sub-dimension; rot_dim truncates
    to an even count."""
    rot_dim = int(head_dim * rotary_pct)
    rot_dim -= rot_dim % 2
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32, device=device) / rot_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor) -> torch.Tensor:
    """Rotate the leading 2*len(inv_freq) features of x (B, S, H, hd) in
    fp32, pairing the two HALVES of that block (not interleaved pairs)."""
    rot = 2 * inv_freq.shape[0]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    ang = positions[..., None, None].float() * inv_freq  # (B, S, 1, rot/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x_rot.float().chunk(2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([rotated.to(x.dtype), x_pass], dim=-1)


# ---------------------------------------------------------------- MLP

def mlp_init(gen, activation: str, d_model: int, d_ff: int, dtype, device) -> Dict:
    p = {"wi": linear_init(gen, d_model, d_ff, dtype, device)}
    if activation == "swiglu":
        p["wg"] = linear_init(gen, d_model, d_ff, dtype, device)
    p["wo"] = linear_init(gen, d_ff, d_model, dtype, device)
    return p


def _mlp_hidden(params, x, activation: str) -> torch.Tensor:
    if activation == "swiglu":
        return F.silu(linear(params["wg"], x, "mlp/wg")) * linear(params["wi"], x, "mlp/wi")
    if activation == "gelu":
        # jax.nn.gelu defaults to the tanh approximation.
        return F.gelu(linear(params["wi"], x, "mlp/wi"), approximate="tanh")
    raise ValueError(activation)


def mlp_apply(params: Mapping[str, Any], x: torch.Tensor, activation: str,
              taps: Dict | None = None, prefix: str = "") -> torch.Tensor:
    """MLP forward; with ``taps`` it records the linear inputs for
    calibration (``{prefix}.in`` and ``{prefix}.mid``)."""
    if taps is not None:
        taps[f"{prefix}.in"] = x
    h = _mlp_hidden(params, x, activation)
    if taps is not None:
        taps[f"{prefix}.mid"] = h
    return linear(params["wo"], h, "mlp/wo")


# ---------------------------------------------------------------- embeddings

def embedding_init(gen, vocab: int, dim: int, dtype, device) -> Dict:
    t = torch.randn((vocab, dim), generator=gen, device=device) * 0.02
    return {"table": t.to(dtype)}


def embed(params: Mapping[str, Any], tokens: torch.Tensor) -> torch.Tensor:
    table = params["table"]
    if torch.is_grad_enabled() and table.requires_grad:
        # Training: the same rows, but F.embedding's backward on the card (a
        # sort, then a sum per token in order) is deterministic where
        # indexing's (an accumulating index_put, atomics) is not, and a
        # resumed run must give the bits of an uninterrupted one.
        return F.embedding(tokens.long(), table)
    # Serving feeds negative ids (finished and poisoned rows), which
    # indexing wraps and F.embedding refuses.
    return table[tokens.long()]


def unembed(params: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
    """Logits: a tied embedding table or an output projection."""
    if "table" in params:
        return torch.matmul(x, params["table"].T)
    return linear(params, x)


def learned_pos(params: Mapping[str, Any], positions: torch.Tensor) -> torch.Tensor:
    """Learned positions, saturating at the table's last row."""
    pos = positions.long().clamp(max=params["table"].shape[0] - 1)
    return params["table"][pos]
