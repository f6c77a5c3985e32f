"""Wrapper for the chunked RWKV-6 recurrence CUDA kernel (``csrc/rwkv6.cu``).

``rwkv6_attention(r, k, v, w, u)``: r/k/v/w (BH, T, K), u (BH, K) ->
y (BH, T, K) in r's dtype, from a zero state; ``return_state=True`` also
returns the final state (BH, K, K) fp32.  ``rwkv6_heads`` is the same on
(B, H, T, K) views, so the model passes its (B, T, H, K) tensors permuted
and the kernel reads them in place (no transposed copies); u may then be a
broadcast (B, H, K) view of the per-head bonus.

On the CPU (or inside ``kernels.plain()``) both are the plain sequential
scan in ``ref.py``; on a CUDA tensor they launch the kernel or raise.  The
kernel masks a ragged T itself: nothing is padded here.
"""

from __future__ import annotations

import ctypes

import torch

from .. import build, check_launch, use_plain
from .ref import rwkv6_scan_ref

CHUNK = 16  # tokens per chunk in the kernel (the TPU kernel's default)
HEAD_DIMS = (8, 16, 32, 64)  # K the kernel instantiates

launches = 0  # kernel launches (one per wrapper call that runs the kernel)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load("rwkv6").rwkv6_launch
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                       + [ctypes.c_longlong] * 8 + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def rwkv6_attention(r, k, v, w, u, return_state: bool = False):
    """r/k/v/w (BH, T, K), u (BH, K) -> y (BH, T, K) [, S_T (BH, K, K)]."""
    out = rwkv6_heads(r[:, None], k[:, None], v[:, None], w[:, None], u[:, None],
                      return_state)
    if return_state:
        return out[0][:, 0], out[1][:, 0]
    return out[:, 0]


def rwkv6_heads(r, k, v, w, u, return_state: bool = False):
    """r/k/v/w (B, H, T, K) views with unit stride along K, u (B, H, K) ->
    y (B, H, T, K) [, S_T (B, H, K, K) fp32]."""
    b, h, t_len, kd = r.shape
    if use_plain(r):
        def flat(x):
            return x.reshape(b * h, *x.shape[2:])
        out = rwkv6_scan_ref(flat(r), flat(k), flat(v), flat(w), flat(u), return_state)
        if return_state:
            return out[0].view(b, h, t_len, kd), out[1].view(b, h, kd, kd)
        return out.view(b, h, t_len, kd)
    if any(x.shape != r.shape for x in (k, v, w)) or u.shape != (b, h, kd):
        raise ValueError(f"rwkv6: r{tuple(r.shape)} k{tuple(k.shape)} v{tuple(v.shape)} "
                         f"w{tuple(w.shape)} u{tuple(u.shape)}")
    if kd not in HEAD_DIMS:
        raise ValueError(f"rwkv6: K={kd} (the kernel takes {HEAD_DIMS})")
    if r.dtype not in _DTYPES or any(x.dtype != r.dtype for x in (k, v, w)):
        raise TypeError(f"rwkv6: dtypes {r.dtype}/{k.dtype}/{v.dtype}/{w.dtype}")
    if any(x.device != r.device for x in (k, v, w, u)):
        raise ValueError("rwkv6: operands on different devices")
    ins = (r, k, v, w)
    if r.stride(-1) != 1 or any(x.stride() != r.stride() for x in ins):
        ins = tuple(x.contiguous() for x in ins)
    uf = u.float()
    if uf.stride(-1) != 1:
        uf = uf.contiguous()
    y = torch.empty_like(ins[0])  # keeps a dense input's strides
    state = (torch.empty((b, h, kd, kd), dtype=torch.float32, device=r.device)
             if return_state else None)
    if b * h == 0 or t_len == 0:
        if state is not None:
            state.zero_()
        return (y, state) if return_state else y
    global launches
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = _launcher()(*(x.data_ptr() for x in ins), uf.data_ptr(), y.data_ptr(),
                      None if state is None else state.data_ptr(), b, h, t_len, kd,
                      *ins[0].stride()[:3], *uf.stride()[:2], *y.stride()[:3],
                      _DTYPES[r.dtype], stream)
    check_launch(err, "rwkv6")
    launches += 1
    return (y, state) if return_state else y
