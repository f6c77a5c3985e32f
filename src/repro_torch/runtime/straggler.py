"""Straggler mitigation: step-time watchdog + backup-step dispatch (the
port's own copy of the reference's pure-Python module).

On synchronous SPMD hardware a straggling host stalls every collective; the
mitigations that work at scale are (1) detecting the straggler fast, (2)
excluding it via elastic reshard, and (3) hiding transient stalls by
overlapping the data pipeline and checkpoint IO.  This module implements the
detection/decision layer; the serving engine feeds it its step times.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import List, Optional


@dataclasses.dataclass(frozen=True)
class StragglerConfig:
    window: int = 32  # step-time history window
    slow_factor: float = 2.5  # step slower than median*factor => suspicious
    trip_count: int = 3  # consecutive suspicious steps => act


class StepTimeWatchdog:
    def __init__(self, cfg: StragglerConfig = StragglerConfig(), clock=time.monotonic):
        self.cfg = cfg
        self.clock = clock
        self.history: List[float] = []
        self._start: Optional[float] = None
        self._suspicious = 0
        self.trips = 0

    def step_start(self):
        self._start = self.clock()

    def step_end(self) -> str:
        """Returns 'ok' | 'slow' | 'trip'."""
        assert self._start is not None
        dur = self.clock() - self._start
        self._start = None
        return self.observe(dur)

    def observe(self, dur: float) -> str:
        """Classify an externally-timed step duration: 'ok'|'slow'|'trip'.

        The serving engine times steps itself (a pipelined ring keeps
        several in flight, so the single-slot step_start/step_end pair
        cannot bracket them) and feeds durations here.

        Only clean durations enter the median window: folding flagged
        steps in would let sustained degradation drag the median up
        until the watchdog stops tripping on it.
        """
        verdict = "ok"
        if len(self.history) >= 8:
            med = statistics.median(self.history[-self.cfg.window :])
            if dur > med * self.cfg.slow_factor:
                self._suspicious += 1
                verdict = "slow"
                if self._suspicious >= self.cfg.trip_count:
                    self._suspicious = 0
                    self.trips += 1
                    verdict = "trip"
            else:
                self._suspicious = 0
        if verdict == "ok":
            self.history.append(dur)
            if len(self.history) > 4 * self.cfg.window:
                del self.history[: -2 * self.cfg.window]
        return verdict

    @property
    def median_step(self) -> float:
        return statistics.median(self.history) if self.history else 0.0
