"""PyTorch/CUDA port of the NSVD compression + serving system.

Mirrors the JAX package ``repro`` module for module, keeps its param-tree
keys, target names and Gram keys (so a reference checkpoint and GramStore
load unchanged through ``repro_torch.bridge``), and runs its hot paths on
hand-written Hopper kernels (``repro_torch.kernels``).  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Union

import torch

Device = Union[str, torch.device, None]


def resolve_device(device: Device = None) -> torch.device:
    """``None`` means the card: entry points run on CUDA by default."""
    return torch.device("cuda" if device is None else device)


def torch_dtype(name: Union[str, torch.dtype]) -> torch.dtype:
    """Map a config dtype name ("bfloat16", "float32", ...) to torch."""
    if isinstance(name, torch.dtype):
        return name
    return getattr(torch, name)
