"""Hand-written Hopper kernels and their plain PyTorch versions.

Each kernel package holds ``ops.py`` (the wrapper: checks, launch on the
current stream, launch counter) and ``ref.py`` (the plain version).  A
wrapper takes the plain version only for a tensor on the CPU — or inside
``plain()``, which a caller enters to run the same computation through the
plain versions on purpose (the card-side kernel-vs-plain comparison).  On a
CUDA tensor it otherwise launches its kernel or raises.

``flash_attention`` and ``rwkv6`` have backward kernels (an autograd
Function each).  The other wrappers are forward-only: on a CUDA tensor
that requires grad under grad mode they raise (``refuse_grad``) rather
than return a tensor cut from the graph.
"""

from __future__ import annotations

import contextlib

import torch

_plain_depth = 0


@contextlib.contextmanager
def plain():
    """Route every wrapper through its plain PyTorch version."""
    global _plain_depth
    _plain_depth += 1
    try:
        yield
    finally:
        _plain_depth -= 1


def use_plain(t) -> bool:
    """True when a wrapper must take its plain version for tensor ``t``."""
    return t.device.type == "cpu" or _plain_depth > 0


def check_launch(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaGetLastError`` code returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def refuse_grad(name: str, *tensors) -> None:
    """Raise when a forward-only kernel is asked for a gradient: grad mode
    on and an operand that requires grad."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the CUDA kernel is forward-only (no backward kernel); "
                           "call it under torch.no_grad() or on tensors that do not "
                           "require grad")
