"""Wrapper for the calibration Gram CUDA kernel (``csrc/gram.cu``).

``gram_accumulate(x)`` returns ``(G, abs_sum)``: the (n, n) fp32 Gram of
the flattened rows of x (..., n) and the (n,) fp32 sum |x|.  On the CPU (or
inside ``kernels.plain()``) it is the plain version in ``ref.py``; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from .. import build, check_launch, use_plain
from .ref import gram_accumulate_ref

launches = 0  # kernel launches (one per wrapper call that runs the kernel)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load("gram").gram_launch
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def gram_accumulate(x: torch.Tensor):
    """x (..., n) bf16 or fp32 -> (G (n, n) fp32, sum |x| (n,) fp32)."""
    if use_plain(x):
        return gram_accumulate_ref(x)
    if x.dtype not in _DTYPES:
        raise TypeError(f"gram: unsupported dtype {x.dtype}")
    global launches
    n = x.shape[-1]
    rows = x.numel() // max(1, n)
    x2 = x.reshape(rows, n).contiguous()
    g = torch.empty((n, n), dtype=torch.float32, device=x.device)
    asum = torch.empty((n,), dtype=torch.float32, device=x.device)
    if n == 0:
        return g, asum
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _launcher()(x2.data_ptr(), g.data_ptr(), asum.data_ptr(), rows, n,
                      _DTYPES[x.dtype], stream)
    check_launch(err, "gram")
    launches += 1
    return g, asum
