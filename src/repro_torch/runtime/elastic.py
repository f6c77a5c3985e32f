"""Elastic scaling: remap a job onto a changed device set (the reference's
``runtime/elastic.py``, pure Python).

Checkpoints are topology-agnostic (logical arrays + spec rules), so elastic
rescale is: build the new mesh -> recompute shardings from the same rules
(``parallel.param_shardings``) -> restore
(``CheckpointManager.restore(shardings=)``: each rank reads its slices).
The policy layer here decides the new mesh shape when hosts are lost
(shrink the DP axes first — TP topology is fixed by the model), and
validates that the surviving device count supports it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def shrink_plan(
    current: MeshPlan, available_devices: int, tp_axis: str = "model"
) -> Optional[MeshPlan]:
    """Largest mesh fitting `available_devices` that keeps TP size fixed.

    DP-ish axes (everything but TP) absorb the loss, largest first; returns
    None when even TP alone no longer fits (job must abort).
    """
    tp_idx = current.axes.index(tp_axis)
    tp = current.shape[tp_idx]
    if available_devices < tp:
        return None
    budget = available_devices // tp
    dp_axes = [
        (i, s) for i, s in enumerate(current.shape) if i != tp_idx
    ]
    # Greedy: keep axis ratios, round down to powers of two of the original.
    new_shape = list(current.shape)
    total_dp = 1
    for i, s in dp_axes:
        total_dp *= s
    scale = budget / total_dp
    remaining = budget
    for i, s in sorted(dp_axes, key=lambda t: -t[1]):
        ns = max(1, min(s, int(s * scale)))
        # keep divisibility: largest power of two <= ns that divides budget
        while remaining % ns != 0 and ns > 1:
            ns -= 1
        new_shape[i] = ns
        remaining //= ns
    # Distribute any leftover onto the first DP axis.
    if remaining > 1:
        i0 = dp_axes[0][0]
        new_shape[i0] *= remaining
    plan = MeshPlan(tuple(new_shape), current.axes)
    if plan.size > available_devices:
        return None
    return plan


def validate_batch_divisibility(global_batch: int, plan: MeshPlan, dp_axes: Sequence[str]) -> bool:
    dp = 1
    for a, s in zip(plan.axes, plan.shape):
        if a in dp_axes:
            dp *= s
    return global_batch % dp == 0
