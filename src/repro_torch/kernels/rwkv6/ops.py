"""Wrapper for the chunked RWKV-6 recurrence CUDA kernel (``csrc/rwkv6.cu``)
and its backward (``csrc/rwkv6_bwd.cu``).

``rwkv6_attention(r, k, v, w, u)``: r/k/v/w (BH, T, K), u (BH, K) ->
y (BH, T, K) in r's dtype, from a zero state; ``return_state=True`` also
returns the final state (BH, K, K) fp32.  ``rwkv6_heads`` is the same on
(B, H, T, K) views, so the model passes its (B, T, H, K) tensors permuted
and the kernel reads them in place (no transposed copies); u may then be a
broadcast (B, H, K) view of the per-head bonus.

On the CPU (or inside ``kernels.plain()``) both are the plain sequential
scan in ``ref.py``; on a CUDA tensor they launch the kernel or raise.  The
kernel masks a ragged T itself: nothing is padded here.  ``plan`` is the
launch the kernel makes (cluster, blocks, the rows and columns each block
owns, the copy width), kept here as a pure function so that the CPU tests
reach it.

When a gradient is asked for (grad mode on and an operand that requires
grad) the call goes through ``RWKV6``, an autograd Function: its forward
is the same launch, and its backward calls ``backward``: the chunked,
division-free backward's three kernels (chunk summaries, the scan over
chunks, the gradients; ``bwd_plan`` gives their grids and scratch, and
``ref.rwkv6_chunked_bwd_ref`` their algebra in plain torch), counted as
one launch a call.  They take fp32 only: bf16 operands are widened to fp32
for them and the gradients rounded back.  On the CPU or under
``kernels.plain()`` that Function runs ``rwkv6_scan_ref`` and
``rwkv6_scan_bwd_ref``.  No path asks for the final state's gradient:
``return_state=True`` with a gradient raises.  Without a gradient nothing
changes: the same launch as before.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Sequence

import torch

from .. import build, check_launch, use_plain
from .ref import rwkv6_scan_bwd_ref, rwkv6_scan_ref

HEAD_DIMS = (8, 16, 32, 64)  # K the kernel instantiates
SLICE = 16  # rows of S (and columns of y) one block owns
BWD_CHUNK = 32  # tokens a chunk of the backward kernels (csrc/rwkv6_bwd.cu: C)
BWD_THREADS = 128  # threads a block of each backward kernel

launches = 0  # kernel launches (one per wrapper call that runs the kernel)
vec16_launches = 0  # of those, with 16-byte cp.async copies
vec4_launches = 0  # with 4-byte copies (other strides or bases)
backward_launches = 0  # backward calls on the card (each launches the three kernels)


@dataclass(frozen=True)
class Plan:
    """The kernel's launch for one call (csrc/rwkv6.cu: ``Shape``, ``launch``)."""

    kd: int  # K
    cluster: int  # blocks a head, one cluster: K / 16, 1 for K <= 16
    threads: int  # threads a block
    vec: int  # bytes a cp.async copies: 16, 4, or 0 (inputs must be copied first)

    @property
    def rows(self) -> int:
        """Rows of S (columns of r, k, w, u) a block owns; also the columns
        of y it sums and writes."""
        return self.kd // self.cluster

    def blocks(self, heads: int) -> int:
        return heads * self.cluster

    def owned(self, block: int):
        """(head, rows of S, columns of y) of block ``block`` of the grid."""
        head, rank = divmod(block, self.cluster)
        span = range(rank * self.rows, (rank + 1) * self.rows)
        return head, span, span


def plan(shape: Sequence[int], elsize: int, ptrs: Sequence[int],
         strides: Sequence[int]) -> Plan:
    """The launch for inputs of ``shape`` (B, H, T, K) with elements of
    ``elsize`` bytes at ``ptrs``, sharing the element strides ``strides``
    (b, h, t; unit along K): 16-byte copies when every base, and the stride
    of every dimension longer than 1, is a multiple of 16 bytes; 4-byte ones
    when of 4; else 0 (a bf16 view at an odd element offset or stride)."""
    kd = shape[3]
    if kd not in HEAD_DIMS:
        raise ValueError(f"rwkv6: K={kd} (the kernel takes {HEAD_DIMS})")
    bits = 0
    for p in ptrs:
        bits |= int(p)
    for n, st in zip(shape[:3], strides[:3]):
        if n > 1:
            bits |= int(st) * elsize
    vec = 16 if bits % 16 == 0 else 4 if bits % 4 == 0 else 0
    return Plan(kd=kd, cluster=max(1, kd // SLICE), threads=128 if kd >= 32 else 4 * kd,
                vec=vec)

@dataclass(frozen=True)
class BwdPlan:
    """The backward's three launches for one call, as csrc/rwkv6_bwd.cu's
    launcher takes them (it refuses a chunk, chunk count, tile count or
    scratch size other than its kernels'): the chunk summaries and the
    gradients one block a (head, chunk), the scan one block a (tile of a
    head's K x K, head, direction), and the scratch they share: two states
    a (head, chunk), then W and du's share a (head, chunk)."""

    chunk: int  # tokens a chunk
    chunks: int  # chunks a head
    heads: int
    kd: int

    @property
    def scan_tiles(self) -> int:
        """Blocks of a head's K x K (a thread a float4) in one direction."""
        return -(-self.kd * self.kd // 4 // BWD_THREADS)

    @property
    def grids(self) -> tuple[int, int, int]:
        """Blocks of the summaries, the scan and the gradients."""
        return (self.heads * self.chunks, self.scan_tiles * self.heads * 2,
                self.heads * self.chunks)

    @property
    def scratch_floats(self) -> int:
        return self.heads * self.chunks * (2 * self.kd * self.kd + 2 * self.kd)

    @property
    def scratch_bytes(self) -> int:
        return 4 * self.scratch_floats


def bwd_plan(t_len: int, kd: int, heads: int) -> BwdPlan:
    """The backward's launches for ``heads`` (B H) heads of ``t_len`` tokens
    of width ``kd``."""
    if kd not in HEAD_DIMS:
        raise ValueError(f"rwkv6 backward: K={kd} (the kernel takes {HEAD_DIMS})")
    return BwdPlan(chunk=BWD_CHUNK, chunks=-(-t_len // BWD_CHUNK), heads=heads, kd=kd)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None
_bwd_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load("rwkv6").rwkv6_launch
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                       + [ctypes.c_longlong] * 8 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _bwd_launcher():
    global _bwd_fn
    if _bwd_fn is None:
        fn = build.load("rwkv6_bwd").rwkv6_bwd_launch
        fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 11
                       + [ctypes.c_int] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                               ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _bwd_fn = fn
    return _bwd_fn


def rwkv6_attention(r, k, v, w, u, return_state: bool = False):
    """r/k/v/w (BH, T, K), u (BH, K) -> y (BH, T, K) [, S_T (BH, K, K)]."""
    out = rwkv6_heads(r[:, None], k[:, None], v[:, None], w[:, None], u[:, None],
                      return_state)
    if return_state:
        return out[0][:, 0], out[1][:, 0]
    return out[:, 0]


def _check(r, k, v, w, u) -> None:
    """The gates on shapes, dtypes and devices that both kernels share."""
    b, h, _, kd = r.shape
    if any(x.shape != r.shape for x in (k, v, w)) or u.shape != (b, h, kd):
        raise ValueError(f"rwkv6: r{tuple(r.shape)} k{tuple(k.shape)} v{tuple(v.shape)} "
                         f"w{tuple(w.shape)} u{tuple(u.shape)}")
    if r.dtype not in _DTYPES or any(x.dtype != r.dtype for x in (k, v, w)):
        raise TypeError(f"rwkv6: dtypes {r.dtype}/{k.dtype}/{v.dtype}/{w.dtype}")
    if any(x.device != r.device for x in (k, v, w, u)):
        raise ValueError("rwkv6: operands on different devices")


def _plain(r, k, v, w, u, return_state: bool):
    """``rwkv6_scan_ref`` on (B, H, T, K) views."""
    b, h, t_len, kd = r.shape

    def flat(x):
        return x.reshape(b * h, *x.shape[2:])
    out = rwkv6_scan_ref(flat(r), flat(k), flat(v), flat(w), flat(u), return_state)
    if return_state:
        return out[0].view(b, h, t_len, kd), out[1].view(b, h, kd, kd)
    return out.view(b, h, t_len, kd)


def _forward(r, k, v, w, u, return_state: bool = False):
    """One forward launch on (B, H, T, K) views."""
    b, h, t_len, kd = r.shape
    _check(r, k, v, w, u)
    ins = (r, k, v, w)
    if r.stride(-1) != 1 or any(x.stride() != r.stride() for x in ins):
        ins = tuple(x.contiguous() for x in ins)
    launch = plan(r.shape, r.element_size(), [x.data_ptr() for x in ins], ins[0].stride())
    if launch.vec == 0:  # rows not even 4-byte aligned: fresh (aligned) copies
        ins = tuple(x.clone(memory_format=torch.contiguous_format) for x in ins)
        launch = plan(r.shape, r.element_size(), [x.data_ptr() for x in ins], ins[0].stride())
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
    global launches, vec16_launches, vec4_launches
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = _launcher()(*(x.data_ptr() for x in ins), uf.data_ptr(), y.data_ptr(),
                      None if state is None else state.data_ptr(), b, h, t_len, kd,
                      *ins[0].stride()[:3], *uf.stride()[:2], *y.stride()[:3],
                      _DTYPES[r.dtype], launch.vec, stream)
    check_launch(err, "rwkv6")
    launches += 1
    if launch.vec == 16:
        vec16_launches += 1
    else:
        vec4_launches += 1
    return (y, state) if return_state else y


def backward(r, k, v, w, u, dy):
    """The backward's kernels on (B, H, T, K) views: (dr, dk, dv, dw, du),
    each like its operand (du (B, H, K)).  fp32 in the kernels: bf16
    operands are widened and the gradients rounded back to their dtypes.
    The kernels read every input in place through its strides, with
    16-byte copies when every base and stride allows them."""
    b, h, t_len, kd = r.shape
    _check(r, k, v, w, u)
    bp = bwd_plan(t_len, kd, b * h)
    if dy.shape != r.shape or dy.device != r.device:
        raise ValueError(f"rwkv6 backward: dy{tuple(dy.shape)} on {dy.device}, want "
                         f"{tuple(r.shape)} on {r.device}")
    if dy.dtype not in _DTYPES:
        raise TypeError(f"rwkv6 backward: dy dtype {dy.dtype}")
    ins = tuple(x.float() for x in (r, k, v, w))
    if ins[0].stride(-1) != 1 or any(x.stride() != ins[0].stride() for x in ins):
        ins = tuple(x.contiguous() for x in ins)
    uf, dyf = u.float(), dy.float()
    if uf.stride(-1) != 1:
        uf = uf.contiguous()
    if dyf.stride(-1) != 1:
        dyf = dyf.contiguous()
    grads = [torch.empty_like(ins[0]) for _ in range(4)]  # dr, dk, dv, dw: one set of strides
    du = torch.empty((b, h, kd), dtype=torch.float32, device=r.device)
    if b * h == 0 or t_len == 0:
        for g in (*grads, du):
            g.zero_()
    else:
        scratch = torch.empty(bp.scratch_floats, dtype=torch.float32, device=r.device)
        # 16-byte copies when every input's base and strides allow them (the
        # forward's rule, dy with its own strides).
        vec16 = all(plan(x.shape, 4, [x.data_ptr()], x.stride()).vec == 16 for x in (*ins, dyf))
        global backward_launches
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = _bwd_launcher()(*(x.data_ptr() for x in ins), uf.data_ptr(), dyf.data_ptr(),
                              *(g.data_ptr() for g in grads), du.data_ptr(),
                              scratch.data_ptr(), b, h, t_len, kd, *ins[0].stride()[:3],
                              *uf.stride()[:2], *dyf.stride()[:3], *grads[0].stride()[:3],
                              bp.chunk, bp.chunks, bp.scan_tiles, bp.scratch_floats,
                              int(vec16), stream)
        check_launch(err, "rwkv6 backward")
        backward_launches += 1
    return (*(g.to(x.dtype) for g, x in zip(grads, (r, k, v, w))), du.to(u.dtype))


class RWKV6(torch.autograd.Function):
    """The recurrence from a zero state with the hand-written backward
    (plain versions on the CPU or under ``kernels.plain()``)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        y = _plain(r, k, v, w, u, False) if use_plain(r) else _forward(r, k, v, w, u)
        ctx.save_for_backward(r, k, v, w, u)
        return y

    @staticmethod
    def backward(ctx, dy):
        r, k, v, w, u = ctx.saved_tensors
        if not use_plain(r):
            return backward(r, k, v, w, u, dy)
        b, h, t_len, kd = r.shape
        grads = rwkv6_scan_bwd_ref(*(x.reshape(b * h, *x.shape[2:])
                                     for x in (r, k, v, w, u, dy)))
        return tuple(g.view(x.shape) for g, x in zip(grads, (r, k, v, w, u)))


def rwkv6_heads(r, k, v, w, u, return_state: bool = False):
    """r/k/v/w (B, H, T, K) views with unit stride along K, u (B, H, K) ->
    y (B, H, T, K) [, S_T (B, H, K, K) fp32]."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (r, k, v, w, u)):
        if return_state:
            raise RuntimeError("rwkv6: return_state=True with a gradient (no path asks "
                               "for the final state's gradient)")
        return RWKV6.apply(r, k, v, w, u)
    if use_plain(r):
        return _plain(r, k, v, w, u, return_state)
    return _forward(r, k, v, w, u, return_state)
