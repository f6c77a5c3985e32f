"""Wrapper for the calibration Gram CUDA kernel (``csrc/gram.cu``).

``gram_accumulate(x)`` returns ``(G, abs_sum)``: the (n, n) fp32 Gram of
the flattened rows of x (..., n) and the (n,) fp32 sum |x|.  On the CPU (or
inside ``kernels.plain()``) it is the plain version in ``ref.py``; on a
CUDA tensor it launches a kernel or raises.  ``route`` picks the kernel:
the tensor-core (mma) kernel for bf16 rows whose width is a multiple of 8
and whose data starts 16-byte aligned; the FMA kernel for everything else
(fp32 above all: tensor cores would compute it in TF32).

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
fma_launches = 0  # of which the FMA kernel
batched_launches = 0  # of all launches, those of the batched (per-expert) form
# All launches by (n, batched): which tap's width ran in which form.
shape_launches: dict = {}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNELS = {"fma": 0, "mma": 1}
_fn = None


def route(dtype: torch.dtype, n: int, data_ptr: int) -> str:
    """The kernel that takes rows of ``dtype`` and width ``n`` starting at
    address ``data_ptr``: "mma" (bf16, n % 8 == 0, 16-byte aligned, so
    every row's 16-byte copies are aligned) or "fma"."""
    if dtype == torch.bfloat16 and n % 8 == 0 and data_ptr % 16 == 0:
        return "mma"
    return "fma"


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load("gram").gram_launch
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
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
    """Run ``kernel`` ("mma" or "fma") on contiguous rows x2 (rows, n), or
    on the batched form's x2 (E, rows, n), on the card; the kernel refuses
    (and this raises) what it does not take."""
    global launches, mma_launches, fma_launches, batched_launches
    lead = x2.shape[:-2]
    rows, n = x2.shape[-2:]
    g = torch.empty((*lead, n, n), dtype=torch.float32, device=x2.device)
    asum = torch.empty((*lead, n), dtype=torch.float32, device=x2.device)
    if n == 0 or g.numel() == 0:
        return g, asum
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    err = _launcher()(x2.data_ptr(), g.data_ptr(), asum.data_ptr(), rows, n,
                      x2.shape[0] if lead else 1, _DTYPES[x2.dtype], _KERNELS[kernel], stream)
    check_launch(err, "gram")
    launches += 1
    key = (n, bool(lead))
    shape_launches[key] = shape_launches.get(key, 0) + 1
    if lead:
        batched_launches += 1
    if kernel == "mma":
        mma_launches += 1
    else:
        fma_launches += 1
    return g, asum
