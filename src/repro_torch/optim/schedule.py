"""Learning-rate schedules (multiplier form: step -> scale in [0, 1]), the
reference's ``optim/schedule.py``.  Each takes the step as a 0-d tensor and
returns a 0-d fp32 tensor on its device, so no step reads the host."""

from __future__ import annotations

import math

import torch


def constant():
    return lambda step: torch.ones((), dtype=torch.float32, device=step.device)


def linear_warmup_cosine(warmup: int, total: int, floor: float = 0.1):
    def fn(step):
        s = step.to(torch.float32)
        warm = torch.clamp(s / max(warmup, 1), max=1.0)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return warm * cos

    return fn


def inverse_sqrt(warmup: int):
    def fn(step):
        s = torch.clamp(step.to(torch.float32), min=1.0)
        return torch.minimum(s / max(warmup, 1), torch.sqrt(warmup / s))

    return fn
