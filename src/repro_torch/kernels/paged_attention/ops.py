"""Wrapper for the paged-attention CUDA kernels (``csrc/paged_attention.cu``).

Same arguments and result as ``ref.paged_attention_ref``.  On the CPU (or
inside ``kernels.plain()``) it is that plain version; on a CUDA tensor it
launches the kernels or raises.  One difference from the plain version, by
design: a length-0 row reads no pages and yields zeros (the plain version's
fully masked softmax averages block 0).  Callers never read such rows.

A call runs the split kernel over ``plan_splits``' grid and, when that has
more than one split, the combine kernel after it.  ``split_partials`` and
``combine`` run the two alone (the card-side checks of the combine).
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import build, check_launch, refuse_grad, use_plain
from .ref import gather_pages, paged_attention_ref  # noqa: F401 (re-export)

GROUPS = (1, 2, 4, 8, 16)  # query heads per KV head the kernel instantiates
MAX_HEAD_DIM = 256
MAX_SMEM_BYTES = 227 * 1024  # a block's dynamic shared memory on the H100
WARPS = 4  # warps a block (csrc NT / 32)
STAGES = 2  # ring stages (csrc STAGES)
MAX_SPLITS = 1024  # splits a row the combine takes (csrc MAX_SPLITS)
# Split plan (plan_splits).  A one-row call's table is that row's length, so
# every block is live: aim at 2 blocks an SM (3 fit at the path's 168
# registers; a second wave costs more than it spreads).  A batch's rows are
# mostly shorter than the table, so most of its blocks exit at once: aim at
# 6 an SM.  Measured on the H100 80GB HBM3 at 700 W (tools/paged_profile.py,
# device ms with the combine, bf16, 32 query / 8 KV heads, hd 128): one row
# of 32768 tokens 0.0583 at the planned 33 splits, 0.0578 at 32, 0.0655 at
# 48, 0.0744 at 64; 8 rows of 512-8192 tokens 0.0558 at the planned 13,
# 0.0624 at 12, 0.0726 at 16, 0.0665 at 8; 8 rows of 1-700 tokens 0.0120 at
# the planned 11, 0.0134 at 8, 0.0124 at 15; the serve decode step (8 rows
# of 35-189 tokens, 16 columns) 0.0095 at the planned 4, 0.0104 at 8, 0.0112
# at 1.  MIN_PPS: fewest pages a split takes (4: one 64-token stage at
# block 16); MAX_PPS: most, which bounds the table entries a block stages
# in shared memory.
SMS = 132
TARGET_BLOCKS_ONE_ROW = 2 * SMS
TARGET_BLOCKS_BATCH = 6 * SMS
MIN_PPS = 4
MAX_PPS = 256

launches = 0  # split-kernel launches (one per wrapper call that runs the kernel)
combine_launches = 0  # combine-kernel launches (calls with more than one split)

_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_fns = {}


def _launcher(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.load("paged_attention"), name)
        if name == "paged_attention_launch":
            fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        else:  # paged_combine_launch
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def plan_splits(b: int, hkv: int, max_blocks: int):
    """(n_splits, pps): the split-KV grid for B rows of Hkv heads over a
    table of ``max_blocks`` columns, from shapes alone (never the lengths,
    so no host sync).  Enough splits that B * Hkv * n_splits reaches the
    target blocks, each of at least MIN_PPS pages and at most MAX_PPS, at
    most MAX_SPLITS; then as few splits as cover the table at that pps."""
    max_blocks = max(int(max_blocks), 1)
    target = TARGET_BLOCKS_ONE_ROW if b == 1 else TARGET_BLOCKS_BATCH
    n = -(-target // max(b * hkv, 1))
    n = min(n, -(-max_blocks // MIN_PPS))
    n = min(max(n, -(-max_blocks // MAX_PPS), 1), MAX_SPLITS)
    pps = -(-max_blocks // n)
    return -(-max_blocks // pps), pps


def padded_head_dim(hd: int) -> int:
    """The head dim a shared-memory row holds (csrc HDP = 32 * DPL): 64,
    128 or 256, zero-filled past hd."""
    return 64 if hd <= 64 else 128 if hd <= 128 else 256


def stage_tokens(hd: int, elem: int, g: int) -> int:
    """Tokens a ring stage holds (csrc stage_tokens): 64 where a padded row
    is at most 256 bytes and G <= 8, else 32."""
    return 64 if padded_head_dim(hd) * elem <= 256 and g <= 8 else 32


def smem_bytes(g: int, hd: int, elem: int, quant: bool, pps: int) -> int:
    """The split kernel's dynamic shared memory (csrc smem_total): the
    split's table entries, q (fp32), the warps' probabilities, and the
    larger of the ring and the warps' merge area."""
    hdp = padded_head_dim(hd)
    ts = stage_tokens(hd, elem, g)
    table = -(-pps * 4 // 16) * 16
    ring = STAGES * (2 * ts * hdp * elem + (8 * ts if quant else 0))
    merge = WARPS * g * (hdp + 2) * 4
    return table + g * hdp * 4 + ts * g * 4 + max(ring, merge)


def paged_attention(q, k_pages, v_pages, block_tables, lengths,
                    k_scales=None, v_scales=None, scale=None):
    if use_plain(q):
        return paged_attention_ref(q, k_pages, v_pages, block_tables, lengths,
                                   k_scales, v_scales, scale)
    refuse_grad("paged_attention", q, k_pages, v_pages, k_scales, v_scales)
    n_splits, pps = plan_splits(q.shape[0], k_pages.shape[2], block_tables.shape[1])
    return launch(q, k_pages, v_pages, block_tables, lengths, k_scales, v_scales,
                  scale, n_splits, pps)


def launch(q, k_pages, v_pages, block_tables, lengths, k_scales, v_scales,
           scale, n_splits, pps):
    """The split kernel (and, with n_splits > 1, the combine) on CUDA
    tensors with a given split plan; ``paged_attention`` takes
    ``plan_splits``'."""
    return _run(q, k_pages, v_pages, block_tables, lengths, k_scales, v_scales,
                scale, n_splits, pps, True)


def split_partials(q, k_pages, v_pages, block_tables, lengths, k_scales, v_scales,
                   scale, n_splits, pps):
    """The split kernel alone (n_splits > 1): its fp32 partials, ``acc``
    (B*Hkv, n_splits, G, hd) and ``ml`` (B*Hkv, n_splits, G, 2: running max
    in log2 units, sum), written only for the splits a row's length
    reaches."""
    if n_splits < 2:
        raise ValueError("paged_attention: partials need more than one split")
    return _run(q, k_pages, v_pages, block_tables, lengths, k_scales, v_scales,
                scale, n_splits, pps, False)


def combine(acc, ml, lengths, bs, max_blocks, pps, dtype):
    """The combine kernel alone on ``split_partials``' output: (B, Hkv*G,
    hd) in ``dtype``."""
    global combine_launches
    bhkv, n_splits, g, hd = acc.shape
    b = lengths.shape[0]
    if (ml.shape != (bhkv, n_splits, g, 2) or acc.dtype != torch.float32
            or ml.dtype != torch.float32 or lengths.dtype != torch.int32 or bhkv % b
            or dtype not in _Q_DTYPES or not (acc.is_contiguous() and ml.is_contiguous())):
        raise ValueError("paged_attention: combine takes fp32 partials (B*Hkv, S, G, hd) "
                         "and (B*Hkv, S, G, 2), int32 lengths (B,)")
    hkv = bhkv // b
    out = torch.empty((b, hkv * g, hd), dtype=dtype, device=acc.device)
    err = _launcher("paged_combine_launch")(
        acc.data_ptr(), ml.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        b, hkv, g, hd, bs, max_blocks, n_splits, pps, _Q_DTYPES[dtype],
        torch.cuda.current_stream(acc.device).cuda_stream)
    check_launch(err, "paged_attention combine")
    combine_launches += 1
    return out


def _run(q, k_pages, v_pages, block_tables, lengths, k_scales, v_scales,
         scale, n_splits, pps, do_combine):
    global launches, combine_launches
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
    max_blocks = block_tables.shape[1]
    if not 1 <= n_splits <= MAX_SPLITS or pps < 1 or n_splits * pps < max_blocks:
        raise ValueError(f"paged_attention: {n_splits} splits of {pps} pages do not "
                         f"cover {max_blocks} table columns")
    smem = smem_bytes(g, hd, k_pages.element_size(), quant, pps)
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
    ws_acc = ws_ml = None
    if n_splits > 1:  # one allocation for both partials
        n_acc = b * hkv * n_splits * g * hd
        ws = torch.empty(n_acc + b * hkv * n_splits * g * 2, dtype=torch.float32,
                         device=q.device)
        ws_acc = ws[:n_acc].view(b * hkv, n_splits, g, hd)
        ws_ml = ws[n_acc:].view(b * hkv, n_splits, g, 2)
    if b == 0 or max_blocks == 0:
        return out.zero_() if do_combine else (ws_acc, ws_ml)
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _launcher("paged_attention_launch")(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scales.data_ptr() if quant else None,
        v_scales.data_ptr() if quant else None,
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        ws_acc.data_ptr() if ws_acc is not None else None,
        ws_ml.data_ptr() if ws_ml is not None else None,
        b, hkv, g, hd, bs, max_blocks, n_splits, pps, int(do_combine), float(scale),
        _Q_DTYPES[q.dtype], _KV_DTYPES[k_pages.dtype], stream)
    check_launch(err, "paged_attention")
    launches += 1
    if not do_combine:
        return ws_acc, ws_ml
    combine_launches += n_splits > 1
    return out
