"""Wrapper for the nested low-rank CUDA kernels (``csrc/nested_lowrank.cu``).

``nested_lowrank_matmul(x, u, v, u2, v2)`` computes
``(x @ u) @ v + (x @ u2) @ v2`` for x (..., K).  On the CPU (or inside
``kernels.plain()``) it is the plain version in ``ref.py``.  On a CUDA
tensor it launches a kernel for decode/prefill-chunk row counts
(<= MAX_KERNEL_ROWS, the reference's row gate) and leaves larger row counts
to plain matmuls, as the reference leaves them to XLA.  ``plan`` picks the
kernel: the stream kernel for bf16 decode rows (<= STREAM_ROWS) whose v/v2
rows are 16-byte aligned, the tile kernel for everything else.  The
reference's VMEM gate has no counterpart: both kernels stream their factors
and have no rank limit.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import build, check_launch, use_plain
from .ref import nested_lowrank_matmul_ref

MAX_KERNEL_ROWS = 1024
SKINNY_ROWS = 16      # rows up to which the tile kernel uses its (16, 128) tile
BK = 16               # tile-kernel split-K chunks are multiples of its depth
TARGET_BLOCKS = 264   # ~2 blocks per SM of the H100's 132
MIN_SPLIT_DEPTH = 256
# The stream kernel (bf16, rows <= STREAM_ROWS): STREAM_BN-column tiles,
# chunks a multiple of its STREAM_BK-row ring stage up to STREAM_MAX_CHUNK
# (the x slice it keeps in shared memory).
STREAM_ROWS = 16
STREAM_BN = 256
STREAM_BK = 32
STREAM_MAX_CHUNK = 512
# A block's fixed cost (ring fill, x slice, partial write and its reduction)
# in factor rows of one tile, for ``stream_chunk``'s cost model.
BLOCK_OVERHEAD_ROWS = 64
_INT_MAX = 2 ** 31 - 1

launches = 0  # kernel launches (one per wrapper call that runs a kernel)
stream_launches = 0  # of which the stream kernel
tile_launches = 0  # of which the tile kernel

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNELS = {"tile": 0, "stream": 1}
_fn = None


class Plan(NamedTuple):
    """What ``nested_lowrank_launch`` runs for one call."""

    kernel: str  # "stream" (bf16, <= 16 rows) or "tile"
    s1: int      # phase 1 (t = x @ [u|u2]): split-K slices and chunk depth
    c1: int
    s2: int      # phase 2 (y = t @ [v;v2]): slices (the stream kernel's
    c2: int      # cover v's and v2's depths separately) and chunk depth


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load("nested_lowrank").nested_lowrank_launch
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 11
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def split_k(rows: int, depth: int, cols: int) -> tuple[int, int]:
    """The tile kernel's (splits, chunk) for one phase: enough split-K
    slices that the grid reaches ~2 blocks per SM, each slice at least
    MIN_SPLIT_DEPTH deep."""
    bm, bn = (16, 128) if rows <= SKINNY_ROWS else (64, 64)
    tiles = _ceil(cols, bn) * _ceil(rows, bm)
    s = max(1, min(_ceil(TARGET_BLOCKS, tiles), depth // MIN_SPLIT_DEPTH))
    chunk = _ceil(_ceil(depth, s), BK) * BK
    return _ceil(depth, chunk), chunk


def stream_chunk(tiles: int, depths: tuple[int, ...]) -> int:
    """The stream kernel's chunk depth for one phase: ``tiles`` column tiles,
    each depth split into chunks of its own.  Of the multiples of STREAM_BK
    up to STREAM_MAX_CHUNK (and no deeper than the deepest depth needs), the
    one with the least estimated time: the waves of TARGET_BLOCKS blocks the
    grid takes, times a block's rows plus its fixed cost (ties: the deeper
    chunk, fewer partials)."""
    top = min(STREAM_MAX_CHUNK, _ceil(max(depths, default=0), STREAM_BK) * STREAM_BK)
    best = (None, STREAM_BK)
    for c in range(STREAM_BK, max(top, STREAM_BK) + 1, STREAM_BK):
        blocks = tiles * sum(_ceil(d, c) for d in depths)
        cost = _ceil(blocks, TARGET_BLOCKS) * (c + BLOCK_OVERHEAD_ROWS)
        if best[0] is None or cost <= best[0]:
            best = (cost, c)
    return best[1]


@functools.lru_cache(maxsize=4096)
def plan(rows: int, dtype: torch.dtype, k_in: int, n: int, k1: int, k2: int,
         aligned: bool) -> Plan:
    """The kernel and both phases' split-K plans for x (rows, k_in), u (k_in,
    k1), u2 (k_in, k2) and v/v2 (., n).  ``aligned``: v and v2 start on a
    16-byte boundary.  The stream kernel takes bf16 with 1..STREAM_ROWS rows,
    n % 8 == 0 (so every v/v2 row is aligned too) and element offsets below
    2^31; u and u2 may sit at any address.  The C launcher refuses a stream
    plan that breaks any of this."""
    k = k1 + k2
    stream = (dtype == torch.bfloat16 and 1 <= rows <= STREAM_ROWS and aligned
              and n % 8 == 0 and (k_in + STREAM_BK) * max(k1, k2) < _INT_MAX
              and (max(k1, k2) + STREAM_BK) * n < _INT_MAX)
    if not stream:
        return Plan("tile", *split_k(rows, k_in, k), *split_k(rows, k, n))
    c1 = stream_chunk(_ceil(k1, STREAM_BN) + _ceil(k2, STREAM_BN), (k_in,))
    c2 = stream_chunk(_ceil(n, STREAM_BN), (k1, k2))
    return Plan("stream", _ceil(k_in, c1), c1, _ceil(k1, c2) + _ceil(k2, c2), c2)


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
    global launches, stream_launches, tile_launches
    k_in, n = x.shape[-1], v.shape[-1]
    k1, k2 = u.shape[-1], u2.shape[-1]
    k = k1 + k2
    x2 = x.reshape(rows, k_in).contiguous()
    y = torch.empty((rows, n), dtype=x.dtype, device=x.device)
    if rows == 0:
        return y.reshape(*x.shape[:-1], n)
    aligned = v.data_ptr() % 16 == 0 and v2.data_ptr() % 16 == 0
    p = plan(rows, x.dtype, k_in, n, k1, k2, aligned)
    part1 = torch.empty((p.s1, rows, k), dtype=torch.float32, device=x.device)
    t = torch.empty((rows, k), dtype=x.dtype, device=x.device)
    part2 = torch.empty((p.s2, rows, n), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _launcher()(
        x2.data_ptr(), u.data_ptr(), v.data_ptr(), u2.data_ptr(), v2.data_ptr(),
        y.data_ptr(), part1.data_ptr(), t.data_ptr(), part2.data_ptr(),
        rows, k_in, k1, k2, n, p.s1, p.c1, p.s2, p.c2, _DTYPES[x.dtype],
        _KERNELS[p.kernel], stream)
    check_launch(err, "nested_lowrank")
    launches += 1
    if p.kernel == "stream":
        stream_launches += 1
    else:
        tile_launches += 1
    return y.reshape(*x.shape[:-1], n)
