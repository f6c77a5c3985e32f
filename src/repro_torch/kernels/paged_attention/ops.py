"""Wrapper for the paged-attention CUDA kernel (``csrc/paged_attention.cu``).

Same arguments and result as ``ref.paged_attention_ref``.  On the CPU (or
inside ``kernels.plain()``) it is that plain version; on a CUDA tensor it
launches the kernel or raises.  One difference from the plain version, by
design: a length-0 row reads no pages and yields zeros (the plain version's
fully masked softmax averages block 0).  Callers never read such rows.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import build, check_launch, use_plain
from .ref import gather_pages, paged_attention_ref  # noqa: F401 (re-export)

GROUPS = (1, 2, 4, 8, 16)  # query heads per KV head the kernel instantiates
MAX_HEAD_DIM = 256
MAX_SMEM_BYTES = 48 * 1024

launches = 0  # kernel launches (one per wrapper call that runs the kernel)

_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load("paged_attention").paged_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def paged_attention(q, k_pages, v_pages, block_tables, lengths,
                    k_scales=None, v_scales=None, scale=None):
    if use_plain(q):
        return paged_attention_ref(q, k_pages, v_pages, block_tables, lengths,
                                   k_scales, v_scales, scale)
    global launches
    b, hq, hd = q.shape
    n, bs, hkv, hd_k = k_pages.shape
    quant = k_scales is not None
    if v_pages.shape != k_pages.shape or hd_k != hd or hq % hkv:
        raise ValueError(f"paged_attention: q{tuple(q.shape)} vs pools "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}")
    g = hq // hkv
    if g not in GROUPS or hd > MAX_HEAD_DIM:
        raise ValueError(f"paged_attention: G={g} (supported {GROUPS}), "
                         f"hd={hd} (max {MAX_HEAD_DIM})")
    if q.dtype not in _Q_DTYPES or k_pages.dtype != v_pages.dtype:
        raise TypeError(f"paged_attention: q {q.dtype}, pools "
                        f"{k_pages.dtype}/{v_pages.dtype}")
    if quant != (k_pages.dtype == torch.int8) or (v_scales is None) == quant:
        raise TypeError("paged_attention: int8 pools need k/v scales and "
                        "float pools take none")
    if not quant and k_pages.dtype != q.dtype:
        raise TypeError(f"paged_attention: pool dtype {k_pages.dtype} != "
                        f"q dtype {q.dtype}")
    if quant and (k_scales.shape != (n, bs, hkv) or v_scales.shape != (n, bs, hkv)
                  or k_scales.dtype != torch.float32 or v_scales.dtype != torch.float32):
        raise TypeError("paged_attention: scales must be fp32 (N, bs, Hkv)")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32 \
            or block_tables.shape[0] != b or lengths.shape != (b,):
        raise TypeError("paged_attention: block_tables (B, M) and lengths (B,) "
                        "must be int32")
    smem = 4 * (g * hd + g * bs + 3 * g)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"paged_attention: {smem} B of shared memory > "
                         f"{MAX_SMEM_BYTES}")
    tensors = [q, k_pages, v_pages, block_tables, lengths]
    if quant:
        tensors += [k_scales, v_scales]
    for t in tensors:
        if t.device != q.device:
            raise ValueError("paged_attention: operands on different devices")
        if not t.is_contiguous():
            raise ValueError("paged_attention: operands must be contiguous")
    out = torch.empty_like(q)
    if b == 0:
        return out
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _launcher()(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scales.data_ptr() if quant else None,
        v_scales.data_ptr() if quant else None,
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        b, hkv, g, hd, bs, block_tables.shape[1], float(scale),
        _Q_DTYPES[q.dtype], _KV_DTYPES[k_pages.dtype], stream)
    check_launch(err, "paged_attention")
    launches += 1
    return out
