"""The collectives of the explicit SPMD path, counted, and the tensor-parallel
scope the model layers read.

Each collective runs over one mesh axis's process group (NCCL on the card,
gloo on the CPU) and adds one to ``counts[(kind, axis)]`` where it is
issued, as a kernel wrapper counts its launches; ``reset_counts`` zeroes
them.  The kinds: "all_reduce" (a row-parallel partial or a rank-k
factored partial over "model"), "all_gather" (split outputs and logits
over "model", the step's token word over "data") and "broadcast" (a
swapped row's blocks over "data").

``tensor_parallel(par)`` is entered by the model facade around a forward
when its mesh has more than one rank on the model axis; ``linear`` and the
embedding read ``current_tp()`` to split their work.  Outside it (every
meshless forward, and any mesh with one rank on "model") no layer issues a
collective.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import torch
import torch.distributed as dist

counts: Dict[Tuple[str, str], int] = {}

# torch 2.13 names all_gather_into_tensor all_gather_single (same call).
_gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def reset_counts() -> None:
    counts.clear()


def _count(kind: str, axis: str) -> None:
    counts[(kind, axis)] = counts.get((kind, axis), 0) + 1


def _group(par, axis: str):
    return par.mesh.get_group(axis)


def all_reduce(t: torch.Tensor, par, axis: str) -> torch.Tensor:
    """Sum of ``t`` over ``axis``'s group (a new tensor; ``t`` is kept)."""
    out = t.contiguous().clone()
    dist.all_reduce(out, group=_group(par, axis))
    _count("all_reduce", axis)
    return out


def gather_rows(t: torch.Tensor, par, axis: str) -> torch.Tensor:
    """Every rank's ``t`` stacked along dim 0 in rank order over ``axis``:
    one all_gather_into_tensor."""
    group = _group(par, axis)
    n = dist.get_world_size(group)
    t = t.contiguous()
    out = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    _gather_into(out, t, group=group)
    _count("all_gather", axis)
    return out


def all_gather(t: torch.Tensor, par, axis: str, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order over
    ``axis`` (one all_gather_into_tensor)."""
    dim = dim % t.ndim
    moved = t.movedim(dim, 0)
    stacked = gather_rows(moved, par, axis)
    return stacked.movedim(0, dim)


def broadcast(t: torch.Tensor, par, axis: str, src: int) -> torch.Tensor:
    """``t`` (in place) from the rank at index ``src`` of ``axis``'s group."""
    group = _group(par, axis)
    dist.broadcast(t, src=dist.get_global_rank(group, src), group=group)
    _count("broadcast", axis)
    return t


_tp = None


@contextlib.contextmanager
def tensor_parallel(par):
    """Split the layers' work over ``par``'s model axis inside the block."""
    global _tp
    prev, _tp = _tp, par
    try:
        yield
    finally:
        _tp = prev


def current_tp():
    """The Parallelism whose model axis the running forward splits over, or
    None."""
    return _tp


def tp_slice(n: int, par) -> Tuple[int, int]:
    """(start, stop) of this rank's part of a dim of ``n`` split over the
    model axis."""
    size = par.tp_size
    if n % size:
        raise ValueError(f"a dim of {n} does not split over {size} model ranks")
    step = n // size
    return par.tp_rank * step, (par.tp_rank + 1) * step
