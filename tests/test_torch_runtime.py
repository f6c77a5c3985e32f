"""Port parity for the runtime primitives: the step-time watchdog, the step
guard, the fault handler and the heartbeat monitor of
``repro_torch.runtime`` against ``repro.runtime`` on the same inputs."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import fault as jax_fault
from repro.runtime import straggler as jax_straggler
from repro_torch.runtime import fault as torch_fault
from repro_torch.runtime import straggler as torch_straggler


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _durations(seed=0, n=400):
    """Seeded step times: a noisy baseline with isolated spikes, runs of
    slow steps (trips) and a sustained slowdown."""
    rng = np.random.default_rng(seed)
    d = 0.01 * (1 + 0.2 * rng.random(n))
    d[rng.choice(n, 25, replace=False)] *= 4
    for start in (60, 150, 151, 260):
        d[start:start + 4] *= 6
    d[300:340] *= 3
    return d.tolist()


@pytest.mark.parametrize("cfg", [{}, {"window": 8, "slow_factor": 1.5, "trip_count": 2}])
def test_watchdog_verdicts_match_reference(cfg):
    """The same verdict at every step, through observe() and through the
    step_start/step_end pair on an injected clock."""
    logs = []
    for mod in (jax_straggler, torch_straggler):
        clock = _Clock()
        w = mod.StepTimeWatchdog(mod.StragglerConfig(**cfg), clock=clock)
        log = []
        for i, d in enumerate(_durations()):
            if i % 2:
                log.append(w.observe(d))
            else:
                w.step_start()
                clock.t += d
                log.append(w.step_end())
        logs.append((log, w.trips, w.median_step, list(w.history)))
    assert logs[1] == logs[0]
    assert {"ok", "slow", "trip"} <= set(logs[1][0]) and logs[1][1] >= 2


def _trees(seed=0):
    rng = np.random.default_rng(seed)
    new = {"w": rng.standard_normal((3, 4)).astype(np.float32),
           "opt": {"m": rng.standard_normal(5).astype(np.float32),
                   "step": np.array(7, np.int32)}}
    old = {"w": rng.standard_normal((3, 4)).astype(np.float32),
           "opt": {"m": rng.standard_normal(5).astype(np.float32),
                   "step": np.array(6, np.int32)}}
    return new, old


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


@pytest.mark.parametrize("loss,gnorm", [(1.5, 2.0), (math.nan, 1.0), (2e4, 1.0),
                                        (1.0, math.inf), (1.0, 3e4), (-math.inf, 1.0)])
def test_guarded_update_matches_reference(loss, gnorm):
    """Clean steps take the new tree, corrupt ones keep the old, leaf for
    leaf; the verdict is a 0-d bool tensor."""
    new, old = _trees()
    cfg_j, cfg_t = jax_fault.GuardConfig(), torch_fault.GuardConfig()
    ref_tree, ref_bad = jax_fault.guarded_update(
        jnp.float32(loss), jnp.float32(gnorm), _map(jnp.asarray, new), _map(jnp.asarray, old),
        cfg_j)
    tree, bad = torch_fault.guarded_update(
        torch.tensor(loss, dtype=torch.float32), torch.tensor(gnorm, dtype=torch.float32),
        _map(torch.from_numpy, new), _map(torch.from_numpy, old), cfg_t)
    assert bad.dtype == torch.bool and bad.dim() == 0
    assert bool(bad) == bool(ref_bad) == (not (loss == 1.5))
    flat = lambda t: [np.asarray(t["w"]), np.asarray(t["opt"]["m"]),  # noqa: E731
                      np.asarray(t["opt"]["step"])]
    for a, b in zip(flat(ref_tree), flat(_map(lambda x: x.numpy(), tree))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("manager", [None, object()], ids=["no_manager", "manager"])
def test_fault_handler_reload_cadence_matches_reference(manager):
    pattern = [False, True, True, False, True, True, True, True, True, True, True, False, True]
    logs = []
    for mod in (jax_fault, torch_fault):
        h = mod.FaultHandler(mod.GuardConfig(rollback_patience=3), manager=manager)
        logs.append(([h.observe(b) for b in pattern], h.total_bad, h.reloads,
                     h.consecutive_bad))
    assert logs[1] == logs[0]
    assert logs[1][2] == (0 if manager is None else 2)


def test_heartbeat_monitor_matches_reference():
    logs = []
    for mod in (jax_fault, torch_fault):
        clock = _Clock()
        m = mod.HeartbeatMonitor(3, timeout_s=10.0, clock=clock)
        log = [m.healthy()]
        for t, host in ((4.0, 0), (8.0, 1), (12.0, 0), (15.0, None), (19.0, 2), (30.0, None)):
            clock.t = t
            if host is not None:
                m.beat(host)
            log.append((m.dead_hosts(), m.healthy()))
        with pytest.raises(KeyError, match="unknown host"):
            m.beat(3)
        logs.append(log)
    assert logs[1] == logs[0]
    assert logs[1][4] == ([2], False) and logs[1][6] == ([0, 1, 2], False)
