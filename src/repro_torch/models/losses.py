"""Next-token cross-entropy (the reference's ``models/losses.py``; the
chunked form from hidden states waits for the training slice)."""

from __future__ import annotations

from typing import Optional

import torch


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
