"""Gradient compression with error feedback (the reference's
``optim/grad.py``): before a data-parallel reduction each gradient is
quantized to int8 in blocks of 256 with an fp32 scale a block, and the
quantization error is carried into the next step's gradient.

``torch.round``, like ``jnp.round``, rounds half to even, so the int8 codes
equal the reference's bit for bit.  On one card there is no reduction:
``roundtrip`` (compress then decompress) is what the train step applies.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

BLOCK = 256


def _quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-wise symmetric int8 quantization.  Returns (q, scales)."""
    flat = g.reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.shape[0]) % BLOCK))
    blocks = flat.reshape(-1, BLOCK)
    scale = torch.clamp(blocks.abs().amax(dim=1, keepdim=True) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape)


def compress_grad(g: torch.Tensor, error: Optional[torch.Tensor] = None):
    """Quantize g (+ carried error); returns (payload, new_error).

    payload = (q, scale); new_error = g_eff - dequant(q, scale).
    """
    g32 = g.to(torch.float32)
    if error is not None:
        g32 = g32 + error
    q, scale = _quantize(g32)
    deq = _dequantize(q, scale, g32.shape)
    return (q, scale), g32 - deq


def decompress_grad(payload, shape) -> torch.Tensor:
    q, scale = payload
    return _dequantize(q, scale, shape)


def roundtrip(grads, errors=None):
    """Compress + decompress every leaf of a nested dict of gradients.
    Returns (dequantized grads in their own dtypes, fp32 errors)."""
    if isinstance(grads, dict):
        pairs = {k: roundtrip(grads[k], None if errors is None else errors[k]) for k in grads}
        return ({k: p[0] for k, p in pairs.items()}, {k: p[1] for k, p in pairs.items()})
    payload, new_e = compress_grad(grads, errors)
    return decompress_grad(payload, grads.shape).to(grads.dtype), new_e
