"""Bounded structured event tracer for the serving engine.

Per-request lifecycle events (submit, admit, first-chunk, first-token,
per-step commit, preempt-ready, finish) and per-step events (dispatch,
ring sync, drain, defrag) land in a fixed-capacity ring buffer — the
oldest events drop, recording never blocks or grows — and export as

  * JSONL (one event object per line) for ad-hoc analysis, and
  * the Chrome trace-event format (``chrome://tracing`` / Perfetto's
    legacy JSON loader): step dispatch/sync as duration ("X") events on
    the engine track, request lifecycle as instants ("i") on one track
    per request uid.

Timestamps are ``time.perf_counter`` relative to the tracer's epoch
(microseconds in the export), so traces from one process line up across
tracks without wall-clock skew."""

from __future__ import annotations

import json
import time
from collections import deque
from typing import Dict, List, Optional

# Chrome trace pid lanes: one synthetic "process" for the engine's step
# machinery, one for request lifecycles (tid == request uid).
PID_ENGINE = 0
PID_REQUESTS = 1


class Event:
    __slots__ = ("name", "cat", "ph", "ts_us", "dur_us", "pid", "tid",
                 "args")

    def __init__(self, name, cat, ph, ts_us, dur_us, pid, tid, args):
        self.name = name
        self.cat = cat
        self.ph = ph
        self.ts_us = ts_us
        self.dur_us = dur_us
        self.pid = pid
        self.tid = tid
        self.args = args

    def to_chrome(self) -> Dict:
        d = {"name": self.name, "cat": self.cat, "ph": self.ph,
             "ts": self.ts_us, "pid": self.pid, "tid": self.tid}
        if self.ph == "X":
            d["dur"] = self.dur_us
        if self.ph == "i":
            d["s"] = "t"  # instant scope: thread
        if self.args:
            d["args"] = self.args
        return d


class EventTracer:
    """Fixed-capacity event ring.  ``dropped`` counts evictions, so an
    exported trace is honest about truncation."""

    def __init__(self, capacity: int = 65536):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._events: deque = deque(maxlen=capacity)
        self.epoch = time.perf_counter()
        self.total = 0

    # ------------------------------------------------------------- record

    def _now_us(self) -> float:
        return (time.perf_counter() - self.epoch) * 1e6

    def instant(self, name: str, cat: str, pid: int = PID_ENGINE,
                tid: int = 0, args: Optional[Dict] = None,
                ts_us: Optional[float] = None) -> None:
        self._push(Event(name, cat, "i",
                         self._now_us() if ts_us is None else ts_us,
                         0.0, pid, tid, args))

    def complete(self, name: str, cat: str, dur_s: float,
                 pid: int = PID_ENGINE, tid: int = 0,
                 args: Optional[Dict] = None) -> None:
        """A duration event that just ENDED (ts = now - dur)."""
        dur_us = dur_s * 1e6
        self._push(Event(name, cat, "X", self._now_us() - dur_us, dur_us,
                         pid, tid, args))

    def _push(self, ev: Event) -> None:
        self.total += 1
        self._events.append(ev)

    # ------------------------------------------------------------ queries

    def __len__(self) -> int:
        return len(self._events)

    @property
    def dropped(self) -> int:
        return self.total - len(self._events)

    def events(self) -> List[Event]:
        return list(self._events)

    # ------------------------------------------------------------- export

    def chrome_trace(self) -> Dict:
        """chrome://tracing / Perfetto-loadable document."""
        meta = [
            {"name": "process_name", "ph": "M", "pid": PID_ENGINE,
             "args": {"name": "serving-engine"}},
            {"name": "process_name", "ph": "M", "pid": PID_REQUESTS,
             "args": {"name": "requests"}},
        ]
        return {
            "traceEvents": meta + [e.to_chrome() for e in self._events],
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": self.dropped,
                          "total_events": self.total},
        }

    def export_chrome(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)

    def export_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for e in self._events:
                f.write(json.dumps(e.to_chrome()) + "\n")
