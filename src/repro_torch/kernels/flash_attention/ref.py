"""Plain PyTorch version of causal GQA attention: the naive path.

fp32 scores, a -1e30 causal mask, an fp32 softmax, and the probabilities
cast to v's dtype before P V — the reference's
``kernels/flash_attention/ref.py``.  Query head h reads KV head h // G.
"""

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q (B, S, Hq, hd), k/v (B, S, Hkv, hd) -> (B, S, Hq, hd), causal."""
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, hq // hkv, hd)
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * scale
    causal = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~causal, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)
    return out.reshape(b, s, hq, hd)
