"""Wrapper for the nested low-rank CUDA kernel (``csrc/nested_lowrank.cu``).

``nested_lowrank_matmul(x, u, v, u2, v2)`` computes
``(x @ u) @ v + (x @ u2) @ v2`` for x (..., K).  On the CPU (or inside
``kernels.plain()``) it is the plain version in ``ref.py``.  On a CUDA
tensor it launches the kernel for decode/prefill-chunk row counts
(<= MAX_KERNEL_ROWS, the reference's row gate) and leaves larger row counts
to plain matmuls, as the reference leaves them to XLA.  The reference's
VMEM gate has no counterpart: this kernel streams its factors and has no
rank limit.
"""

from __future__ import annotations

import ctypes

import torch

from .. import build, check_launch, use_plain
from .ref import nested_lowrank_matmul_ref

MAX_KERNEL_ROWS = 1024
SKINNY_ROWS = 16      # rows up to which the kernel uses its (16, 128) tile
BK = 16               # split-K chunks are multiples of the tile depth
TARGET_BLOCKS = 264   # ~2 blocks per SM of the H100's 132
MIN_SPLIT_DEPTH = 256

launches = 0  # kernel launches (one per wrapper call that runs the kernel)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load("nested_lowrank").nested_lowrank_launch
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 10
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def split_k(rows: int, depth: int, cols: int) -> tuple[int, int]:
    """(splits, chunk) for one phase: enough split-K slices that the grid
    reaches ~2 blocks per SM, each slice at least MIN_SPLIT_DEPTH deep."""
    bm, bn = (16, 128) if rows <= SKINNY_ROWS else (64, 64)
    tiles = _ceil(cols, bn) * _ceil(rows, bm)
    s = max(1, min(_ceil(TARGET_BLOCKS, tiles), depth // MIN_SPLIT_DEPTH))
    chunk = _ceil(_ceil(depth, s), BK) * BK
    return _ceil(depth, chunk), chunk


def _check(x, u, v, u2, v2):
    k_in, n = x.shape[-1], v.shape[-1]
    k1, k2 = u.shape[-1], u2.shape[-1]
    if u.shape != (k_in, k1) or v.shape != (k1, n) or u2.shape != (k_in, k2) \
            or v2.shape != (k2, n):
        raise ValueError(f"nested_lowrank: bad shapes x{tuple(x.shape)} "
                         f"u{tuple(u.shape)} v{tuple(v.shape)} "
                         f"u2{tuple(u2.shape)} v2{tuple(v2.shape)}")
    for t in (x, u, v, u2, v2):
        if t.device != x.device:
            raise ValueError("nested_lowrank: operands on different devices")
        if t.dtype != x.dtype:
            raise TypeError(f"nested_lowrank: mixed dtypes {t.dtype} / {x.dtype}")
    if not all(t.is_contiguous() for t in (u, v, u2, v2)):
        # A silent copy would re-read every factor byte on every call.
        raise ValueError("nested_lowrank: factors must be contiguous")
    if x.dtype not in _DTYPES:
        raise TypeError(f"nested_lowrank: unsupported dtype {x.dtype}")


def nested_lowrank_matmul(x, u, v, u2, v2):
    """x (..., K) -> (..., N); see the module docstring for dispatch."""
    rows = x.numel() // max(1, x.shape[-1])
    if use_plain(x) or rows > MAX_KERNEL_ROWS:
        return nested_lowrank_matmul_ref(x, u, v, u2, v2)
    _check(x, u, v, u2, v2)
    global launches
    k_in, n = x.shape[-1], v.shape[-1]
    k1, k2 = u.shape[-1], u2.shape[-1]
    k = k1 + k2
    x2 = x.reshape(rows, k_in).contiguous()
    y = torch.empty((rows, n), dtype=x.dtype, device=x.device)
    if rows == 0:
        return y.reshape(*x.shape[:-1], n)
    s1, c1 = split_k(rows, k_in, k)
    s2, c2 = split_k(rows, k, n)
    part1 = torch.empty((s1, rows, k), dtype=torch.float32, device=x.device)
    t = torch.empty((rows, k), dtype=x.dtype, device=x.device)
    part2 = torch.empty((s2, rows, n), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _launcher()(
        x2.data_ptr(), u.data_ptr(), v.data_ptr(), u2.data_ptr(), v2.data_ptr(),
        y.data_ptr(), part1.data_ptr(), t.data_ptr(), part2.data_ptr(),
        rows, k_in, k1, k2, n, s1, c1, s2, c2, _DTYPES[x.dtype], stream)
    check_launch(err, "nested_lowrank")
    launches += 1
    return y.reshape(*x.shape[:-1], n)
