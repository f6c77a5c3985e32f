"""Wrapper for the calibration Gram CUDA kernel (``csrc/gram.cu``).

``gram_accumulate(x)`` returns ``(G, abs_sum)``: the (n, n) fp32 Gram of
the flattened rows of x (..., n) and the (n,) fp32 sum |x|.  On the CPU (or
inside ``kernels.plain()``) it is the plain version in ``ref.py``; on a
CUDA tensor it launches a kernel or raises.  ``route`` picks the kernel:
the tensor-core (mma) kernel for bf16 rows whose width is a multiple of 8
and whose data starts 16-byte aligned; the tf32x3 kernel (tensor cores at
fp32's precision, three TF32 products a value pair, the rows split across
blocks by ``plan_splits``) for fp32 rows whose width is a multiple of 4
and whose data starts 16-byte aligned; the FMA kernel for everything else.

``gram_accumulate_batched(buf)`` is the MoE layer's per-expert form: buf
(E, C, n), a zero-padded capacity buffer, gives G (E, n, n) and sum |x|
(E, n), every expert in one launch of the same kernels.
"""

from __future__ import annotations

import ctypes

import torch

from .. import build, check_launch, refuse_grad, use_plain
from .ref import gram_accumulate_batched_ref, gram_accumulate_ref

launches = 0  # kernel launches (one per wrapper call that runs a kernel)
mma_launches = 0  # of which the mma kernel
tf32x3_launches = 0  # of which the tf32x3 kernel
fma_launches = 0  # of which the FMA kernel
reduce_launches = 0  # tf32x3 launches over more than one row split (its reduce kernel)
batched_launches = 0  # of all launches, those of the batched (per-expert) form
# All launches by (n, batched): which tap's width ran in which form.
shape_launches: dict = {}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNELS = {"fma": 0, "mma": 1, "tf32x3": 2}
_fn = None
TILE = 128  # csrc TILE: the output tile edge
# The tf32x3 kernel's row splits (tools/gram_profile.py on the H100): an SM
# runs one block or two at nearly the same rate, so a call takes about
# ceil(blocks / SMs) rounds of rows / splits rows each; a split also costs
# about SPLIT_COST_ROWS rows (its prologue, its partial tile, its share of
# the reduce).  At most MAX_BLOCKS_PER_SM blocks an SM (the scratch stays
# under 35 MB on the H100's 132 SMs), each split at least MIN_SPLIT_ROWS rows.
MAX_BLOCKS_PER_SM = 4
MIN_SPLIT_ROWS = 64
SPLIT_COST_ROWS = 4


def route(dtype: torch.dtype, n: int, data_ptr: int) -> str:
    """The kernel that takes rows of ``dtype`` and width ``n`` starting at
    address ``data_ptr``: "mma" (bf16, n % 8 == 0), "tf32x3" (fp32, n % 4
    == 0), both 16-byte aligned so that every row's 16-byte copies are
    aligned; or "fma"."""
    if data_ptr % 16 == 0:
        if dtype == torch.bfloat16 and n % 8 == 0:
            return "mma"
        if dtype == torch.float32 and n % 4 == 0:
            return "tf32x3"
    return "fma"


def upper_tiles(n: int) -> int:
    """Output tiles of the upper triangle (csrc: one block each a split)."""
    t = -(-n // TILE)
    return t * (t + 1) // 2


def sm_count(device: torch.device) -> int:
    """The SMs of ``device``, the card the kernel runs on."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def plan_splits(rows: int, n: int, batch: int, sms: int) -> int:
    """Row splits of the tf32x3 kernel for ``batch`` taps of (rows, n) on a
    card of ``sms`` SMs, from shapes alone: the count of least reckoned time, ceil(tiles x splits /
    sms) rounds of ceil(rows / splits) rows plus SPLIT_COST_ROWS a split,
    the fewest on a tie, with no split under MIN_SPLIT_ROWS rows (a tap of
    fewer than twice that stays whole) and at most MAX_BLOCKS_PER_SM
    blocks an SM."""
    tiles = max(upper_tiles(n) * batch, 1)
    most = max(1, min(rows // MIN_SPLIT_ROWS, MAX_BLOCKS_PER_SM * sms // tiles))

    def cost(s):
        return -(-tiles * s // sms) * -(-rows // s) + SPLIT_COST_ROWS * s
    return min(range(1, most + 1), key=cost)


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load("gram").gram_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def gram_accumulate(x: torch.Tensor):
    """x (..., n) bf16 or fp32 -> (G (n, n) fp32, sum |x| (n,) fp32)."""
    if use_plain(x):
        return gram_accumulate_ref(x)
    refuse_grad("gram", x)
    if x.dtype not in _DTYPES:
        raise TypeError(f"gram: unsupported dtype {x.dtype}")
    n = x.shape[-1]
    x2 = x.reshape(x.numel() // max(1, n), n).contiguous()
    return launch(x2, route(x2.dtype, n, x2.data_ptr()))


def gram_accumulate_batched(buf: torch.Tensor):
    """buf (E, C, n) bf16 or fp32 -> (G (E, n, n) fp32, sum |x| (E, n) fp32),
    expert by expert over its C rows."""
    if use_plain(buf):
        return gram_accumulate_batched_ref(buf)
    refuse_grad("gram (batched)", buf)
    if buf.dtype not in _DTYPES:
        raise TypeError(f"gram: unsupported dtype {buf.dtype}")
    if buf.ndim != 3:
        raise ValueError(f"gram: the batched form takes (E, C, n), got {tuple(buf.shape)}")
    x3 = buf.contiguous()
    return launch(x3, route(x3.dtype, x3.shape[-1], x3.data_ptr()))


def launch(x2: torch.Tensor, kernel: str):
    """Run ``kernel`` ("mma", "tf32x3" or "fma") on contiguous rows x2
    (rows, n), or on the batched form's x2 (E, rows, n), on the card; the
    kernel refuses (and this raises) what it does not take.  The tf32x3
    kernel runs ``plan_splits``' row splits."""
    global launches, mma_launches, tf32x3_launches, fma_launches, batched_launches
    global reduce_launches
    lead = x2.shape[:-2]
    rows, n = x2.shape[-2:]
    batch = x2.shape[0] if lead else 1
    g = torch.empty((*lead, n, n), dtype=torch.float32, device=x2.device)
    asum = torch.empty((*lead, n), dtype=torch.float32, device=x2.device)
    if n == 0 or g.numel() == 0:
        return g, asum
    splits = plan_splits(rows, n, batch, sm_count(x2.device)) if kernel == "tf32x3" else 1
    part = apart = None
    if splits > 1:  # the partial tiles and sums |x| its reduce kernel adds up
        part = torch.empty((batch, splits, upper_tiles(n), TILE, TILE), dtype=torch.float32,
                           device=x2.device)
        apart = torch.empty((batch, splits, -(-n // TILE), TILE), dtype=torch.float32,
                            device=x2.device)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    err = _launcher()(x2.data_ptr(), g.data_ptr(), asum.data_ptr(),
                      None if part is None else part.data_ptr(),
                      None if apart is None else apart.data_ptr(), rows, n, batch,
                      _DTYPES[x2.dtype], _KERNELS[kernel], splits, stream)
    check_launch(err, "gram")
    launches += 1
    key = (n, bool(lead))
    shape_launches[key] = shape_launches.get(key, 0) + 1
    if lead:
        batched_launches += 1
    if kernel == "mma":
        mma_launches += 1
    elif kernel == "tf32x3":
        tf32x3_launches += 1
        reduce_launches += int(splits > 1)
    else:
        fma_launches += 1
    return g, asum
