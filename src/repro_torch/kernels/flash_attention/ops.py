"""Wrapper for the causal flash-attention CUDA kernels
(``csrc/flash_attention.cu``).

``flash_attention(q, k, v)``: q (B, S, Hq, hd), k/v (B, S, Hkv, hd) ->
(B, S, Hq, hd), causal, query head h reading KV head h // (Hq / Hkv).  On
the CPU (or inside ``kernels.plain()``) it is the plain version in
``ref.py``; on a CUDA tensor it launches a kernel or raises: bf16 runs the
tensor-core kernel, fp32 the CUDA-core one (``plan``).  The kernels mask a
ragged S themselves: nothing is padded here.

When a gradient is asked for (grad mode on and an input that requires
grad) the call goes through ``FlashAttention``, an autograd Function: its
forward launches the same kernel with the row log-sum-exp written out, and
its backward launches the three backward kernels of
``csrc/flash_attention_bwd.cu``: bf16 at hd <= 128 the tensor-core ones,
fp32 and bf16 above hd 128 the CUDA-core ones (``bwd_plan``).  On the CPU
or under ``kernels.plain()`` that Function runs ``flash_attention_fwd_ref``
and ``flash_attention_bwd_ref``.
Without a gradient nothing changes: the same launch, no log-sum-exp.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from .. import build, check_launch, use_plain
from .ref import flash_attention_bwd_ref, flash_attention_fwd_ref, flash_attention_ref

MAX_HEAD_DIM = 256
MAX_GRID_Y = 65535  # the CUDA-core kernel's grid y is B * Hkv

launches = 0  # kernel launches (one per wrapper call that runs a kernel)
tensor_core_launches = 0  # of which bf16, mma.sync
cuda_core_launches = 0  # of which fp32, FMA
backward_launches = 0  # backward calls on the card, three kernels each
backward_tensor_core_launches = 0  # of which bf16 at hd <= 128, mma.sync
backward_cuda_core_launches = 0  # of which fp32 or bf16 above hd 128, FMA

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None
_bwd_fn = None


class Plan(NamedTuple):
    """What ``flash_attention_launch`` runs for one (dtype, hd, G)."""

    kernel: str  # "tensor_core" (bf16, mma.sync) or "cuda_core" (fp32 FMA)
    head_dim: int  # the padded head dim the kernel is instantiated for
    rows: int  # query rows a block holds: the largest G it takes


def plan(dtype: torch.dtype, hd: int, g: int) -> Plan:
    """The kernel, padded head dim and rows per block for (dtype, hd, G):
    the one table of what each kernel is instantiated for (the C launcher
    dispatches on the padded head dim it is given).  Raises on what no
    kernel takes: hd not a multiple of 8 in [8, 256], G above the kernel's
    rows (the largest G), or a dtype other than fp32 or bf16."""
    if hd % 8 or not 8 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: hd={hd} (a multiple of 8 up to {MAX_HEAD_DIM})")
    if dtype == torch.bfloat16:
        p = Plan("tensor_core", next(n for n in (64, 128, 256) if hd <= n), 128)
    elif dtype == torch.float32:
        p = Plan("cuda_core", next(n for n in (32, 64, 128, 256) if hd <= n),
                 32 if hd > 128 else 64)
    else:
        raise TypeError(f"flash_attention: dtype {dtype} (fp32 or bf16)")
    if not 1 <= g <= p.rows:
        raise ValueError(f"flash_attention: G={g} (at most {p.rows} at hd={hd}, {dtype})")
    return p


class BwdPlan(NamedTuple):
    """What ``flash_attention_bwd_launch`` runs for one (dtype, hd, G)."""

    kernel: str  # "tensor_core" (bf16, mma.sync) or "cuda_core" (FMA)
    head_dim: int  # the padded head dim the kernels are instantiated for


def bwd_plan(dtype: torch.dtype, hd: int, g: int) -> BwdPlan:
    """The backward's kernels and padded head dim for (dtype, hd, G), by
    dtype and shape alone: bf16 at hd <= 128 on the tensor cores (padded to
    64 or 128; any G), fp32 (tensor cores would round it to TF32) and bf16
    above hd 128 on CUDA cores (32, 64, 128 or 256).  Raises on what no
    kernel takes: hd not a multiple of 8 in [8, 256], G below 1, a dtype
    other than fp32 or bf16."""
    if hd % 8 or not 8 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention backward: hd={hd} (a multiple of 8 up to "
                         f"{MAX_HEAD_DIM})")
    if g < 1:
        raise ValueError(f"flash_attention backward: G={g}")
    if dtype == torch.bfloat16 and hd <= 128:
        return BwdPlan("tensor_core", 64 if hd <= 64 else 128)
    if dtype in (torch.bfloat16, torch.float32):
        return BwdPlan("cuda_core", next(n for n in (32, 64, 128, 256) if hd <= n))
    raise TypeError(f"flash_attention backward: dtype {dtype} (fp32 or bf16)")


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load("flash_attention").flash_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _bwd_launcher():
    global _bwd_fn
    if _bwd_fn is None:
        fn = build.load("flash_attention_bwd").flash_attention_bwd_launch
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _bwd_fn = fn
    return _bwd_fn


def check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> Plan:
    """The wrapper's gates on shapes, dtypes, devices and layout; the plan."""
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    if k.shape != (b, s, hkv, hd) or v.shape != k.shape or hkv == 0 or hq % hkv:
        raise ValueError(f"flash_attention: q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype}")
    p = plan(q.dtype, hd, hq // hkv)
    if p.kernel == "cuda_core" and b * hkv > MAX_GRID_Y:
        raise ValueError(f"flash_attention: B*Hkv={b * hkv} > {MAX_GRID_Y}")
    for t in (k, v):
        if t.device != q.device:
            raise ValueError("flash_attention: operands on different devices")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention: operands must be contiguous")
    if p.kernel == "tensor_core" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: bf16 operands must be 16-byte aligned (cp.async)")
    return p


def _forward(q, k, v, lse=None) -> torch.Tensor:
    """One forward launch; ``lse`` (B, Hq, S) fp32 receives the rows'
    log-sum-exp when given."""
    p = check(q, k, v)
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    global launches, tensor_core_launches, cuda_core_launches
    out = torch.empty_like(q)
    if b == 0 or s == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                      b, s, hkv, hq // hkv, hd, 1.0 / math.sqrt(hd), _DTYPES[q.dtype],
                      p.head_dim, None if lse is None else lse.data_ptr(), stream)
    check_launch(err, "flash_attention")
    launches += 1
    if p.kernel == "tensor_core":
        tensor_core_launches += 1
    else:
        cuda_core_launches += 1
    return out


def backward(q, k, v, out, lse, dout):
    """The three backward kernels ``bwd_plan`` picks: (dq, dk, dv) like
    (q, k, v)."""
    check(q, k, v)
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    out, dout, lse = out.contiguous(), dout.contiguous(), lse.contiguous()
    for t, want in ((out, q.shape), (dout, q.shape), (lse, (b, hq, s))):
        if t.shape != want or t.device != q.device:
            raise ValueError(f"flash_attention backward: an operand of shape "
                             f"{tuple(t.shape)} on {t.device}, want {tuple(want)} on "
                             f"{q.device}")
    if out.dtype != q.dtype or dout.dtype != q.dtype or lse.dtype != torch.float32:
        raise TypeError("flash_attention backward: out/dout in q's dtype, lse fp32")
    p = bwd_plan(q.dtype, hd, hq // hkv)
    if p.kernel == "cuda_core" and b * hq > MAX_GRID_Y:
        raise ValueError(f"flash_attention backward: B*Hq={b * hq} > {MAX_GRID_Y}")
    if p.kernel == "tensor_core" and dout.data_ptr() % 16:
        raise ValueError("flash_attention backward: bf16 dout must be 16-byte aligned "
                         "(cp.async)")
    global backward_launches, backward_tensor_core_launches, backward_cuda_core_launches
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if b == 0 or s == 0:
        return dq, dk, dv
    dsum = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _bwd_launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                          dout.data_ptr(), lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(),
                          dk.data_ptr(), dv.data_ptr(), b, s, hkv, hq // hkv, hd,
                          1.0 / math.sqrt(hd), _DTYPES[q.dtype], p.head_dim, stream)
    check_launch(err, "flash_attention backward")
    backward_launches += 1
    if p.kernel == "tensor_core":
        backward_tensor_core_launches += 1
    else:
        backward_cuda_core_launches += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Causal GQA attention with the hand-written backward (plain versions
    on the CPU or under ``kernels.plain()``)."""

    @staticmethod
    def forward(ctx, q, k, v):
        if use_plain(q):
            out, lse = flash_attention_fwd_ref(q, k, v)
        else:
            b, s, hq, _ = q.shape
            lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
            out = _forward(q, k, v, lse)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if use_plain(q):
            return flash_attention_bwd_ref(q, k, v, out, lse, dout)
        return backward(q, k, v, out, lse, dout)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v)
    if use_plain(q):
        return flash_attention_ref(q, k, v)
    return _forward(q, k, v)
