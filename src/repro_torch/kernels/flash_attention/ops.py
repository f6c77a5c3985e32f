"""Wrapper for the causal flash-attention CUDA kernel
(``csrc/flash_attention.cu``).

``flash_attention(q, k, v)``: q (B, S, Hq, hd), k/v (B, S, Hkv, hd) ->
(B, S, Hq, hd), causal, query head h reading KV head h // (Hq / Hkv).  On
the CPU (or inside ``kernels.plain()``) it is the plain version in
``ref.py``; on a CUDA tensor it launches the kernel or raises.  The kernel
masks a ragged S itself: nothing is padded here.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import build, check_launch, use_plain
from .ref import flash_attention_ref

MAX_HEAD_DIM = 256

launches = 0  # kernel launches (one per wrapper call that runs the kernel)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load("flash_attention").flash_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def max_group(hd: int) -> int:
    """Largest query-head group the kernel takes: its rows per block."""
    return 32 if hd > 128 else 64


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    if use_plain(q):
        return flash_attention_ref(q, k, v)
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    if k.shape != (b, s, hkv, hd) or v.shape != k.shape or hkv == 0 or hq % hkv:
        raise ValueError(f"flash_attention: q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    g = hq // hkv
    if hd % 8 or not 8 <= hd <= MAX_HEAD_DIM or g > max_group(hd):
        raise ValueError(f"flash_attention: hd={hd} (a multiple of 8 up to "
                         f"{MAX_HEAD_DIM}), G={g} (at most {max_group(hd)})")
    if b * hkv > 65535:  # the kernel's grid y
        raise ValueError(f"flash_attention: B*Hkv={b * hkv} > 65535")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype}")
    for t in (k, v):
        if t.device != q.device:
            raise ValueError("flash_attention: operands on different devices")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention: operands must be contiguous")
    global launches
    out = torch.empty_like(q)
    if b == 0 or s == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                      b, s, hkv, g, hd, 1.0 / math.sqrt(hd), _DTYPES[q.dtype], stream)
    check_launch(err, "flash_attention")
    launches += 1
    return out
