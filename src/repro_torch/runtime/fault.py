"""Fault tolerance: step guards, NaN/overflow policy, failure recovery.

The failure model: (a) hardware loss -> process dies -> job restarts from
the latest checkpoint; (b) silent data corruption / loss spikes ->
detected by the step guard below, which keeps the old state and
optionally rolls back; (c) stragglers -> watchdog in straggler.py.

The guard needs no host round-trip: the skip decision is a ``torch.where``
over every leaf, with the verdict a 0-d device tensor.
"""

from __future__ import annotations

import dataclasses
import logging
import time

import torch

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    max_loss: float = 1e4  # treat larger losses as divergence
    max_grad_norm: float = 1e4
    rollback_patience: int = 3  # consecutive bad steps before reload


def _tree_where(bad, new, old):
    if isinstance(new, dict):
        return {k: _tree_where(bad, new[k], old[k]) for k in new}
    return torch.where(bad, old, new)


def guarded_update(loss, grad_norm, new_tree, old_tree, cfg: GuardConfig):
    """Keep the old (params, optimizer state) when the step looks corrupt.

    ``loss`` and ``grad_norm`` are 0-d tensors; the trees are nested dicts
    of tensors with the same keys.  Returns (tree, bad) with ``bad`` a 0-d
    bool tensor on the loss's device: both trees are materialised, so this
    is one select per leaf and never waits for the device."""
    bad = (~torch.isfinite(loss) | (loss > cfg.max_loss)
           | ~torch.isfinite(grad_norm) | (grad_norm > cfg.max_grad_norm))
    return _tree_where(bad, new_tree, old_tree), bad


class FaultHandler:
    """Host-side policy: counts consecutive bad steps, triggers reload."""

    def __init__(self, cfg: GuardConfig, manager=None):
        self.cfg = cfg
        self.manager = manager
        self.consecutive_bad = 0
        self.total_bad = 0
        self.reloads = 0

    def observe(self, bad: bool) -> str:
        """Returns action: 'ok' | 'skipped' | 'reload'."""
        if not bad:
            self.consecutive_bad = 0
            return "ok"
        self.consecutive_bad += 1
        self.total_bad += 1
        if (
            self.manager is not None
            and self.consecutive_bad >= self.cfg.rollback_patience
        ):
            self.consecutive_bad = 0
            self.reloads += 1
            logger.warning("fault handler: rollback to latest checkpoint")
            return "reload"
        logger.warning("fault handler: skipped corrupt step")
        return "skipped"


class HeartbeatMonitor:
    """Tracks per-host liveness (multi-host deployments feed this from the
    coordinator; here it is unit-tested with injected clocks)."""

    def __init__(self, n_hosts: int, timeout_s: float = 60.0, clock=time.monotonic):
        self.timeout_s = timeout_s
        self.clock = clock
        self.last_seen = {h: clock() for h in range(n_hosts)}

    def beat(self, host: int):
        if host not in self.last_seen:
            raise KeyError(
                f"heartbeat from unknown host {host!r}; monitor tracks "
                f"hosts 0..{len(self.last_seen) - 1}")
        self.last_seen[host] = self.clock()

    def dead_hosts(self) -> list:
        now = self.clock()
        return [h for h, t in self.last_seen.items() if now - t > self.timeout_s]

    def healthy(self) -> bool:
        return not self.dead_hosts()
