"""Dependency-free metrics registry: counters, gauges and histograms as
labelled families, with two export surfaces:

  * ``MetricsRegistry.snapshot()`` -- a plain-JSON dict (the file-based
    scrape ``launch/serve.py --metrics-json`` writes with
    ``write_metrics_json``);
  * ``MetricsRegistry.prometheus_text()`` -- Prometheus text exposition, served
    with the snapshot and a health probe by ``MetricsServer`` for
    ``--metrics-port``.

The port's copy of the reference's ``obs/metrics.py``, fed by compression
telemetry and the serving engine's host-side bookkeeping alike.
Histograms keep fixed cumulative buckets for the exposition plus a bounded
window of raw samples for exact percentiles in snapshots.
"""

from __future__ import annotations

import bisect
import http.server
import json
import os
import tempfile
import threading
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

# Default bucket ladders (seconds / counts).  Powers-of-~3 keep the ladder
# short while spanning CPU-emulation steps (ms) and real accelerator steps
# (tens of us).
TIME_BUCKETS = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.3, 1.0, 3.0, 10.0)
COUNT_BUCKETS = (0, 1, 2, 4, 8, 16, 32, 64, 128)
FRACTION_BUCKETS = (0.1, 0.25, 0.5, 0.75, 0.9, 0.95, 1.0)


class Counter:
    """Monotonic counter (one labeled child of a family)."""

    kind = "counter"
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def snapshot(self) -> Dict:
        return {"value": self.value}


class Gauge:
    """Point-in-time value (set wins; inc/dec for running levels)."""

    kind = "gauge"
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def snapshot(self) -> Dict:
        return {"value": self.value}


class Histogram:
    """Fixed-bucket histogram + bounded raw-sample window.

    ``counts[i]`` is the number of observations <= ``buckets[i]`` minus the
    ones in lower buckets (non-cumulative internally; the exposition
    cumulates), with one overflow bucket.  ``percentile`` is exact over the
    last ``window`` observations."""

    kind = "histogram"
    __slots__ = ("buckets", "counts", "sum", "count", "max", "_window")

    def __init__(self, buckets: Sequence[float] = TIME_BUCKETS,
                 window: int = 4096):
        self.buckets: Tuple[float, ...] = tuple(sorted(buckets))
        self.counts: List[int] = [0] * (len(self.buckets) + 1)
        self.sum = 0.0
        self.count = 0
        self.max = 0.0
        self._window: deque = deque(maxlen=window)

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.buckets, v)] += 1
        self.sum += v
        self.count += 1
        if v > self.max:
            self.max = v
        self._window.append(v)

    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Exact q-th percentile over the retained window (0 when empty)."""
        if not self._window:
            return 0.0
        xs = sorted(self._window)
        idx = min(len(xs) - 1, max(0, round(q / 100.0 * (len(xs) - 1))))
        return xs[idx]

    def snapshot(self) -> Dict:
        cum, out = 0, {}
        for b, c in zip(self.buckets, self.counts):
            cum += c
            out[repr(float(b))] = cum
        return {
            "count": self.count, "sum": self.sum, "mean": self.mean(),
            "max": self.max, "p50": self.percentile(50),
            "p90": self.percentile(90), "p99": self.percentile(99),
            "buckets": out,
        }


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Family:
    """One named metric family: children keyed by label-value tuples."""

    def __init__(self, name: str, help: str, kind: str,
                 labelnames: Tuple[str, ...] = (), **child_kw):
        self.name = name
        self.help = help
        self.kind = kind
        self.labelnames = tuple(labelnames)
        self._child_kw = child_kw
        self._children: Dict[Tuple[str, ...], object] = {}
        if not self.labelnames:  # unlabeled: materialize the sole child
            self._default = self.labels()
        else:
            self._default = None

    def labels(self, *values, **kv):
        if kv:
            values = tuple(str(kv[n]) for n in self.labelnames)
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {values}")
        child = self._children.get(values)
        if child is None:
            child = self._children[values] = _KINDS[self.kind](
                **self._child_kw)
        return child

    # Unlabeled families proxy the child's mutators so call sites read
    # like plain metrics (family.inc(), family.observe(v), ...).
    def inc(self, n: float = 1.0):
        self._default.inc(n)

    def set(self, v: float):
        self._default.set(v)

    def observe(self, v: float):
        self._default.observe(v)

    def mean(self) -> float:
        return self._default.mean()

    def percentile(self, q: float) -> float:
        return self._default.percentile(q)

    def snapshot(self) -> Dict:
        return self._default.snapshot()

    @property
    def value(self):
        return self._default.value

    @property
    def count(self):
        return self._default.count

    @property
    def max(self):
        return self._default.max

    def series(self):
        for values, child in sorted(self._children.items()):
            yield dict(zip(self.labelnames, values)), child


class MetricsRegistry:
    """Named families; snapshot + Prometheus text exposition."""

    def __init__(self):
        self._families: Dict[str, _Family] = {}

    def _register(self, name: str, help: str, kind: str, labelnames=(),
                  **kw) -> _Family:
        if name in self._families:
            fam = self._families[name]
            if fam.kind != kind or fam.labelnames != tuple(labelnames):
                raise ValueError(f"metric {name!r} re-registered with a "
                                 "different kind/labels")
            return fam
        fam = _Family(name, help, kind, labelnames, **kw)
        self._families[name] = fam
        return fam

    def counter(self, name: str, help: str = "", labelnames=()) -> _Family:
        return self._register(name, help, "counter", labelnames)

    def gauge(self, name: str, help: str = "", labelnames=()) -> _Family:
        return self._register(name, help, "gauge", labelnames)

    def histogram(self, name: str, help: str = "", labelnames=(),
                  buckets: Sequence[float] = TIME_BUCKETS,
                  window: int = 4096) -> _Family:
        return self._register(name, help, "histogram", labelnames,
                              buckets=buckets, window=window)

    def snapshot(self) -> Dict:
        out: Dict[str, Dict] = {}
        for name, fam in sorted(self._families.items()):
            out[name] = {
                "type": fam.kind,
                "help": fam.help,
                "series": [dict(labels=labels, **child.snapshot())
                           for labels, child in fam.series()],
            }
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        lines: List[str] = []
        for name, fam in sorted(self._families.items()):
            if fam.help:
                lines.append(f"# HELP {name} {fam.help}")
            lines.append(f"# TYPE {name} {fam.kind}")
            for labels, child in fam.series():
                if fam.kind == "histogram":
                    cum = 0
                    for b, c in zip(child.buckets, child.counts):
                        cum += c
                        lines.append(
                            f"{name}_bucket{_labels(labels, le=_fmt(b))}"
                            f" {cum}")
                    lines.append(
                        f"{name}_bucket{_labels(labels, le='+Inf')}"
                        f" {child.count}")
                    lines.append(f"{name}_sum{_labels(labels)}"
                                 f" {_fmt(child.sum)}")
                    lines.append(f"{name}_count{_labels(labels)}"
                                 f" {child.count}")
                else:
                    lines.append(f"{name}{_labels(labels)}"
                                 f" {_fmt(child.value)}")
        return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _labels(labels: Dict[str, str], **extra) -> str:
    merged = dict(labels, **extra)
    if not merged:
        return ""
    body = ",".join(f'{k}="{_escape(v)}"' for k, v in merged.items())
    return "{" + body + "}"


def _escape(v: str) -> str:
    return str(v).replace("\\", r"\\").replace('"', r"\"").replace(
        "\n", r"\n")


class MetricsServer:
    """Minimal scrape endpoint on a daemon thread: ``GET /metrics`` serves
    the Prometheus text exposition, ``GET /metrics.json`` the snapshot and
    ``GET /healthz`` a readiness probe; ``port=0`` binds a free port
    (``.port`` reports it).

    ``health`` is an optional zero-argument callable naming the components
    degraded now (``engine.degraded_components``): while it returns a
    non-empty dict, /healthz answers 503 with that dict in a JSON body
    instead of 200 "ok"."""

    def __init__(self, source, port: int = 0, host: str = "127.0.0.1", health=None):
        snapshot, prometheus = source.snapshot, source.prometheus_text

        class _Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                code = 200
                if self.path.startswith("/metrics.json"):
                    body, ctype = json.dumps(snapshot()).encode(), "application/json"
                elif self.path.startswith("/metrics"):
                    body = prometheus().encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif self.path.startswith("/healthz"):
                    degraded = health() if health is not None else {}
                    if degraded:
                        code = 503
                        body = json.dumps({"status": "degraded",
                                           "components": degraded}).encode()
                        ctype = "application/json"
                    else:
                        body, ctype = b"ok\n", "text/plain; charset=utf-8"
                else:
                    self.send_error(404)
                    return
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # keep the serving stdout clean
                pass

        self._httpd = http.server.ThreadingHTTPServer((host, port), _Handler)
        self.port = int(self._httpd.server_address[1])
        self.host = host
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="repro-metrics", daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


def write_metrics_json(source, path: str, extra: Optional[Dict] = None) -> None:
    """File-based scrape: ``{"metrics": source.snapshot(), **extra}``,
    written to a temporary file beside ``path`` and renamed over it, so a
    poller never reads half a file."""
    doc = {"metrics": source.snapshot()}
    if extra:
        doc.update(extra)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)), suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f, indent=1)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise
