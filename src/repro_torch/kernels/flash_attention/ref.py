"""Plain PyTorch version of causal GQA attention: the naive path.

fp32 scores, a -1e30 causal mask, an fp32 softmax, and the probabilities
cast to v's dtype before P V — the reference's
``kernels/flash_attention/ref.py``.  Query head h reads KV head h // G.

``flash_attention_fwd_ref`` adds the row log-sum-exp the backward needs,
and ``flash_attention_bwd_ref`` is the FA2 backward written out: the plain
versions of the hand-written backward (``csrc/flash_attention_bwd.cu``).
Both compute in fp32, or in the inputs' dtype where that is wider (fp64
for ``torch.autograd.gradcheck``).
"""

import math

import torch

NEG_INF = -1e30


def _scores(q: torch.Tensor, k: torch.Tensor, acc: torch.dtype) -> torch.Tensor:
    """Scaled, causally masked scores (B, Hkv, G, S, S) in ``acc``."""
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, hq // hkv, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.to(acc), k.to(acc)) * (1.0 / math.sqrt(hd))
    causal = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    return scores.masked_fill(~causal, NEG_INF)


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def _attend(scores: torch.Tensor, v: torch.Tensor, shape) -> torch.Tensor:
    """softmax(scores), rounded to v's dtype, times V, as (B, S, Hq, hd)."""
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v).reshape(shape)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q (B, S, Hq, hd), k/v (B, S, Hkv, hd) -> (B, S, Hq, hd), causal."""
    return _attend(_scores(q, k, torch.float32), v, q.shape)


def flash_attention_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """(out, lse): ``out`` as ``flash_attention_ref`` (bit for bit in fp32
    and bf16) and ``lse`` (B, Hq, S), each row's log-sum-exp of its scaled,
    masked scores, fp32 (fp64 for fp64 inputs)."""
    b, s, hq, _ = q.shape
    scores = _scores(q, k, _acc_dtype(q.dtype))
    return _attend(scores, v, q.shape), torch.logsumexp(scores, dim=-1).reshape(b, hq, s)


def flash_attention_bwd_ref(q, k, v, out, lse, dout):
    """The FA2 backward: (dq, dk, dv) in q's dtype from the forward's
    ``out`` and ``lse`` and the output's gradient ``dout``.  D = rowsum(dO
    * O); P rebuilt from lse; dV = P^T dO; dS = P * (dO V^T - D); dQ = dS K
    scale; dK = dS^T Q scale; dK and dV summed over the G query heads of
    each KV head."""
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    acc = _acc_dtype(q.dtype)
    scale = 1.0 / math.sqrt(hd)
    p = torch.exp(_scores(q, k, acc) - lse.to(acc).reshape(b, hkv, g, s, 1))
    do = dout.to(acc).reshape(b, s, hkv, g, hd)
    dsum = (do * out.to(acc).reshape(b, s, hkv, g, hd)).sum(-1)  # (b, s, kv, g)
    dv = torch.einsum("bkgst,bskgd->btkd", p, do)
    dp = torch.einsum("bskgd,btkd->bkgst", do, v.to(acc))
    ds = p * (dp - dsum.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bkgst,btkd->bskgd", ds, k.to(acc)) * scale
    dk = torch.einsum("bkgst,bskgd->btkd", ds, q.to(acc).reshape(b, s, hkv, g, hd)) * scale
    return (dq.reshape(b, s, hq, hd).to(q.dtype), dk.to(q.dtype), dv.to(q.dtype))
