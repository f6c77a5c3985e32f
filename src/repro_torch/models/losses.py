"""Next-token cross-entropy, from logits or, in sequence chunks, from the
final hidden states (the reference's ``models/losses.py``).

``chunked_xent_from_hidden`` never holds the (B, S, V) logits: each chunk's
(B, chunk, V) logits are computed, reduced to its summed loss and dropped,
and under autograd each chunk is recomputed in the backward pass
(``torch.utils.checkpoint``), so the peak beyond the hidden states is one
chunk's fp32 logits and their gradient (2 x B x chunk x V x 4 bytes).
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.lowrank import dense_equivalent


def next_token_xent(logits: torch.Tensor, tokens: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits (B, S, V) predicting tokens shifted by one; mean nats/token
    (over ``mask[:, 1:]`` when given)."""
    targets = tokens[:, 1:].long()
    logits = logits[:, :-1].float()
    logz = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None])[..., 0]
    nll = logz - tgt
    if mask is None:
        return nll.mean()
    m = mask[:, 1:].float()
    return (nll * m).sum() / m.sum().clamp(min=1.0)


def _chunk_nll(h: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
               m: torch.Tensor) -> torch.Tensor:
    """Summed masked nll of one chunk: h (B, C, D), w (D, V)."""
    logits = torch.matmul(h, w).float()
    logz = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None])[..., 0]
    return torch.sum((logz - tgt) * m)


def chunked_xent_from_hidden(hidden: torch.Tensor, unembed_params: Mapping,
                             tokens: torch.Tensor, chunk: int = 512,
                             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cross-entropy from final (post-norm) hidden states (B, S, D) in
    sequence chunks; ``unembed_params``: a tied ``{"table"}`` (V, D), an
    untied ``{"kernel"}`` or a factored unembed (its dense equivalent).
    Equals ``next_token_xent`` on the full logits; the padding of the last
    chunk is masked out."""
    b, s, d = hidden.shape
    n = s - 1
    nchunks = max(1, -(-n // chunk))
    pad = nchunks * chunk - n
    h = torch.nn.functional.pad(hidden[:, :-1], (0, 0, 0, pad))
    targets = torch.nn.functional.pad(tokens[:, 1:].long(), (0, pad))
    m = (torch.ones((b, n), dtype=torch.float32, device=hidden.device) if mask is None
         else mask[:, 1:].float())
    mm = torch.nn.functional.pad(m, (0, pad))
    if "table" in unembed_params:
        w = unembed_params["table"].T  # (D, V)
    else:
        w = dense_equivalent(unembed_params)
    grad = torch.is_grad_enabled() and (hidden.requires_grad or w.requires_grad)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(nchunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        args = (h[:, sl], w, targets[:, sl], mm[:, sl])
        tot = tot + (checkpoint(_chunk_nll, *args, use_reentrant=False) if grad
                     else _chunk_nll(*args))
    return tot / torch.clamp(mm.sum(), min=1.0)
