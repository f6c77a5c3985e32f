"""Wrapper for the nested low-rank CUDA kernels (``csrc/nested_lowrank.cu``).

``nested_lowrank_matmul(x, u, v, u2, v2)`` computes
``(x @ u) @ v + (x @ u2) @ v2`` for x (..., K).  On the CPU (or inside
``kernels.plain()``) it is the plain version in ``ref.py``.  On a CUDA
tensor it launches a kernel for decode/prefill-chunk row counts
(<= MAX_KERNEL_ROWS, the reference's row gate) and leaves larger row counts
to plain matmuls, as the reference leaves them to XLA.  ``plan`` picks the
kernel: for bf16 whose v/v2 rows are 16-byte aligned, the stream kernel at
decode rows (<= STREAM_ROWS) and the tensor-core (mma) kernel above them;
the tile kernel for everything else (fp32 above all).  The reference's
VMEM gate has no counterpart: every kernel streams its factors and has no
rank limit.

``nested_lowrank_matmul_batched(x, u, v, u2, v2)`` is the form the MoE
expert FFN runs (the reference vmaps the single form over experts): x (E,
C, K) with per-expert factors u (E, K, k1), v (E, k1, N), u2 (E, K, k2),
v2 (E, k2, N), all E products in one launch.  The row gate and the kernel
choice read C, the rows of one expert, as the reference's gate does inside
its vmap; C above the gate runs plain batched matmuls.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import build, check_launch, refuse_grad, use_plain
from .ref import nested_lowrank_matmul_batched_ref, nested_lowrank_matmul_ref

MAX_KERNEL_ROWS = 1024
SKINNY_ROWS = 16      # rows up to which the tile kernel uses its (16, 128) tile
BK = 16               # tile-kernel split-K chunks are multiples of its depth
TARGET_BLOCKS = 264   # ~2 blocks per SM of the H100's 132
SM_COUNT = 132
MIN_SPLIT_DEPTH = 256
# The stream kernel (bf16, rows <= STREAM_ROWS): STREAM_BN-column tiles,
# chunks a multiple of its STREAM_BK-row ring stage up to STREAM_MAX_CHUNK
# (the x slice it keeps in shared memory).  Its 8-row tile runs 2 blocks an
# SM, its 16-row tile 1 (STREAM_MT8_ROWS).
STREAM_ROWS = 16
STREAM_MT8_ROWS = 8
STREAM_BN = 256
STREAM_BK = 32
STREAM_MAX_CHUNK = 512
# A block's fixed cost (ring fill, x slice, partial write and its reduction)
# in factor rows of one tile, for ``stream_chunk``'s cost model.
BLOCK_OVERHEAD_ROWS = 64
# The mma kernel (bf16, STREAM_ROWS < rows <= MAX_KERNEL_ROWS): (MMA_BM,
# MMA_BN) block tiles, 2 blocks an SM, chunks a multiple of its MMA_BK-deep
# ring stage.  A block's fixed cost, in rows of depth (its (128, 128) fp32
# partial written and read back by the reduction, the ring's fill): 512,
# the value whose plans came closest to the fastest chunks of a sweep on
# the H100 (tools/nested_profile.py, PERF.md).
MMA_BM = 128
MMA_BN = 128
MMA_BK = 32
MMA_OVERHEAD_ROWS = 512
_INT_MAX = 2 ** 31 - 1

launches = 0  # kernel launches (one per wrapper call that runs a kernel)
stream_launches = 0  # of which the stream kernel
mma_launches = 0  # of which the mma kernel
tile_launches = 0  # of which the tile kernel
# Of all launches, those of the batched (per-expert) form, by kernel.
batched_by_kernel = {"stream": 0, "mma": 0, "tile": 0}
# All launches by (kernel, K, N, batched): which linear of a model ran where.
shape_launches: dict = {}
# Calls on a CUDA tensor above MAX_KERNEL_ROWS, which take plain matmuls
# (no launch; the reference leaves them to XLA): an encoder's frame rows.
gate_calls = 0
# Nested products split over a mesh's model axis (``core.lowrank.
# tp_linear_apply``): plain matmuls around a rank-k all-reduce, no launch.
split_calls = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNELS = {"tile": 0, "stream": 1, "mma": 2}
_fn = None


class Plan(NamedTuple):
    """What ``nested_lowrank_launch`` runs for one call."""

    kernel: str  # "stream" (bf16, <= 16 rows), "mma" (bf16, 17-1024 rows),
    s1: int      # "tile", or "plain" (rows above the gate: no kernel).
    c1: int      # Phase 1 (t = x @ [u|u2]): split-K slices and chunk depth;
    s2: int      # phase 2 (y = t @ [v;v2]): slices (the stream and mma
    c2: int      # kernels cover v's and v2's depths separately) and chunk.


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load("nested_lowrank").nested_lowrank_launch
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 12
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def split_k(rows: int, depth: int, cols: int, batch: int = 1) -> tuple[int, int]:
    """The tile kernel's (splits, chunk) for one phase: enough split-K
    slices that the grid (``batch`` experts of tiles) reaches ~2 blocks per
    SM, each slice at least MIN_SPLIT_DEPTH deep."""
    bm, bn = (16, 128) if rows <= SKINNY_ROWS else (64, 64)
    tiles = _ceil(cols, bn) * _ceil(rows, bm) * batch
    s = max(1, min(_ceil(TARGET_BLOCKS, tiles), depth // MIN_SPLIT_DEPTH))
    chunk = _ceil(_ceil(depth, s), BK) * BK
    return _ceil(depth, chunk), chunk


def stream_wave(rows: int) -> int:
    """Blocks the card runs at once for the stream kernel's row tile at
    ``rows``: its 8-row tile fits 2 blocks an SM, its 16-row tile 1."""
    return TARGET_BLOCKS if rows <= STREAM_MT8_ROWS else SM_COUNT


def stream_chunk(tiles: int, depths: tuple[int, ...], wave: int) -> int:
    """The stream kernel's chunk depth for one phase: ``tiles`` column tiles,
    each depth split into chunks of its own.  Of the multiples of STREAM_BK
    up to STREAM_MAX_CHUNK (and no deeper than the deepest depth needs), the
    one with the least estimated time: the waves of ``wave`` blocks (those
    the card runs at once, ``stream_wave``) the grid takes, times a block's
    rows plus its fixed cost (ties: the deeper chunk, fewer partials)."""
    top = min(STREAM_MAX_CHUNK, _ceil(max(depths, default=0), STREAM_BK) * STREAM_BK)
    best = (None, STREAM_BK)
    for c in range(STREAM_BK, max(top, STREAM_BK) + 1, STREAM_BK):
        blocks = tiles * sum(_ceil(d, c) for d in depths)
        cost = _ceil(blocks, wave) * (c + BLOCK_OVERHEAD_ROWS)
        if best[0] is None or cost <= best[0]:
            best = (cost, c)
    return best[1]


def mma_chunk(tiles: int, depths: tuple[int, ...]) -> int:
    """The mma kernel's chunk depth for one phase: ``tiles`` (row x column)
    tiles, each depth split into chunks of its own.  Of the multiples of
    MMA_BK up to the deepest depth, the one with the least estimated time
    by the list-scheduling bound: every block's rows plus its fixed cost
    spread over TARGET_BLOCKS slots, plus the longest block (ties: the
    deeper chunk).  Unlike the stream kernel's wave count this lets a short
    u2/v2 block fill a gap that a long one leaves."""
    top = _ceil(max(depths, default=0), MMA_BK) * MMA_BK
    best = (None, MMA_BK)
    for c in range(MMA_BK, max(top, MMA_BK) + 1, MMA_BK):
        work = tiles * sum(d + _ceil(d, c) * MMA_OVERHEAD_ROWS for d in depths)
        cost = work / TARGET_BLOCKS + c + MMA_OVERHEAD_ROWS
        if best[0] is None or cost <= best[0]:
            best = (cost, c)
    return best[1]


def t_cols(kernel: str, k1: int, k2: int) -> int:
    """Columns of the rank-width scratch t (and of phase 1's partials): the
    mma kernel puts u2's columns at k1 rounded up to 8 and pads the row to a
    multiple of 8, so that phase 2 reads both K-ranges 16-byte aligned."""
    if kernel == "mma":
        return _ceil(k1, 8) * 8 + _ceil(k2, 8) * 8
    return k1 + k2


@functools.lru_cache(maxsize=4096)
def plan(rows: int, dtype: torch.dtype, k_in: int, n: int, k1: int, k2: int,
         aligned: bool, batch: int = 1) -> Plan:
    """The kernel and both phases' split-K plans for x (rows, k_in), u (k_in,
    k1), u2 (k_in, k2) and v/v2 (., n), or ``batch`` such products at once
    (the batched form: the grid holds ``batch`` x the blocks of one, so the
    chunk plans count them all).  ``aligned``: v and v2 start on a
    16-byte boundary.  The bf16 kernels take n % 8 == 0 (so every v/v2 row
    is aligned too) and element offsets below 2^31, u and u2 at any
    address: the stream kernel 1..STREAM_ROWS rows, the mma kernel up to
    MAX_KERNEL_ROWS with k_in % 8 == 0 (the wrapper hands it x 16-byte
    aligned).  Rows above MAX_KERNEL_ROWS run no kernel ("plain").  The C
    launcher refuses a stream or mma plan that breaks any of this."""
    if rows > MAX_KERNEL_ROWS:
        return Plan("plain", 0, 0, 0, 0)
    k = k1 + k2
    bf16 = (dtype == torch.bfloat16 and aligned and n % 8 == 0
            and (k_in + STREAM_BK) * max(k1, k2) < _INT_MAX
            and (max(k1, k2) + STREAM_BK) * n < _INT_MAX)
    if bf16 and 1 <= rows <= STREAM_ROWS:
        wave = stream_wave(rows)
        c1 = stream_chunk(batch * (_ceil(k1, STREAM_BN) + _ceil(k2, STREAM_BN)), (k_in,),
                          wave)
        c2 = stream_chunk(batch * _ceil(n, STREAM_BN), (k1, k2), wave)
        return Plan("stream", _ceil(k_in, c1), c1, _ceil(k1, c2) + _ceil(k2, c2), c2)
    if bf16 and rows > STREAM_ROWS and k_in % 8 == 0:
        mt = _ceil(rows, MMA_BM) * batch
        c1 = mma_chunk(mt * (_ceil(k1, MMA_BN) + _ceil(k2, MMA_BN)), (k_in,))
        c2 = mma_chunk(mt * _ceil(n, MMA_BN), (k1, k2))
        return Plan("mma", _ceil(k_in, c1), c1, _ceil(k1, c2) + _ceil(k2, c2), c2)
    return Plan("tile", *split_k(rows, k_in, k, batch), *split_k(rows, k, n, batch))


def _check(x, u, v, u2, v2, lead=()):
    """Shapes (``lead``: the batched form's (E,) on every operand), one
    device and dtype, contiguous factors."""
    k_in, n = x.shape[-1], v.shape[-1]
    k1, k2 = u.shape[-1], u2.shape[-1]
    if (u.shape != (*lead, k_in, k1) or v.shape != (*lead, k1, n)
            or u2.shape != (*lead, k_in, k2) or v2.shape != (*lead, k2, n)
            or (lead and (x.ndim != 3 or x.shape[0] != lead[0]))):
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


def _gated() -> None:
    global gate_calls
    gate_calls += 1


def nested_lowrank_matmul(x, u, v, u2, v2):
    """x (..., K) -> (..., N); see the module docstring for dispatch."""
    rows = x.numel() // max(1, x.shape[-1])
    if use_plain(x):
        return nested_lowrank_matmul_ref(x, u, v, u2, v2)
    if rows > MAX_KERNEL_ROWS:
        _gated()
        return nested_lowrank_matmul_ref(x, u, v, u2, v2)
    refuse_grad("nested_lowrank", x, u, v, u2, v2)
    _check(x, u, v, u2, v2)
    k_in, n = x.shape[-1], v.shape[-1]
    k1, k2 = u.shape[-1], u2.shape[-1]
    x2 = x.reshape(rows, k_in).contiguous()
    y = torch.empty((rows, n), dtype=x.dtype, device=x.device)
    if rows == 0:
        return y.reshape(*x.shape[:-1], n)
    aligned = v.data_ptr() % 16 == 0 and v2.data_ptr() % 16 == 0
    p = plan(rows, x.dtype, k_in, n, k1, k2, aligned)
    if p.kernel == "mma" and x2.data_ptr() % 16:
        x2 = x2.clone()  # a view at an odd offset: the mma kernel reads 16-byte rows
    launch(x2, u, v, u2, v2, y, p)
    return y.reshape(*x.shape[:-1], n)


def nested_lowrank_matmul_batched(x, u, v, u2, v2):
    """x (E, C, K) -> (E, C, N), expert e through its own factors u[e],
    v[e], u2[e], v2[e]; see the module docstring for dispatch."""
    if use_plain(x):
        return nested_lowrank_matmul_batched_ref(x, u, v, u2, v2)
    if x.shape[1] > MAX_KERNEL_ROWS:
        _gated()
        return nested_lowrank_matmul_batched_ref(x, u, v, u2, v2)
    refuse_grad("nested_lowrank (batched)", x, u, v, u2, v2)
    _check(x, u, v, u2, v2, lead=(u.shape[0],))
    e, rows, k_in = x.shape
    n, k1, k2 = v.shape[-1], u.shape[-1], u2.shape[-1]
    x3 = x.contiguous()
    y = torch.empty((e, rows, n), dtype=x.dtype, device=x.device)
    if rows == 0 or e == 0:
        return y
    aligned = v.data_ptr() % 16 == 0 and v2.data_ptr() % 16 == 0
    p = plan(rows, x.dtype, k_in, n, k1, k2, aligned, e)
    if p.kernel == "mma" and x3.data_ptr() % 16:
        x3 = x3.clone()  # a view at an odd offset: the mma kernel reads 16-byte rows
    launch(x3, u, v, u2, v2, y, p)
    return y


def launch(x2, u, v, u2, v2, y, p: Plan) -> None:
    """Run plan ``p`` (any kernel, as ``plan`` or a caller timing one kernel
    against another chose it) on x2 (rows, K) into y (rows, N), or on the
    batched form's x2 (E, rows, K) into y (E, rows, N), counting the
    launch."""
    global launches, stream_launches, mma_launches, tile_launches
    batch = x2.shape[0] if x2.ndim == 3 else 1
    rows, k_in = x2.shape[-2:]
    n, k1, k2 = v.shape[-1], u.shape[-1], u2.shape[-1]
    k = t_cols(p.kernel, k1, k2)
    dev = x2.device
    part1 = torch.empty((p.s1, batch, rows, k), dtype=torch.float32, device=dev)
    t = torch.empty((batch, rows, k), dtype=x2.dtype, device=dev)
    part2 = torch.empty((p.s2, batch, rows, n), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _launcher()(
        x2.data_ptr(), u.data_ptr(), v.data_ptr(), u2.data_ptr(), v2.data_ptr(),
        y.data_ptr(), part1.data_ptr(), t.data_ptr(), part2.data_ptr(),
        rows, k_in, k1, k2, n, p.s1, p.c1, p.s2, p.c2, batch, _DTYPES[x2.dtype],
        _KERNELS[p.kernel], stream)
    check_launch(err, "nested_lowrank")
    launches += 1
    key = (p.kernel, k_in, n, x2.ndim == 3)
    shape_launches[key] = shape_launches.get(key, 0) + 1
    if x2.ndim == 3:
        batched_by_kernel[p.kernel] += 1
    if p.kernel == "stream":
        stream_launches += 1
    elif p.kernel == "mma":
        mma_launches += 1
    else:
        tile_launches += 1
