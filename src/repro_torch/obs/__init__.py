"""Observability: serving telemetry (structured event tracing, a
dependency-free metrics registry, torch.profiler hooks) and compression
telemetry.  Serving telemetry is fed from the HOST-side bookkeeping the
engine already does (its scheduling state and the one token copy a step
makes), never an extra device sync.

Usage:

    from repro_torch.obs import Telemetry
    tel = Telemetry()
    eng = ServingEngine(model, params, telemetry=tel)
    eng.run()
    tel.snapshot(eng)        # JSON metrics + engine gauges
    tel.metrics.prometheus_text()
    tel.tracer.export_chrome("trace.json")

``ServingEngine(...)`` without ``telemetry=`` gets ``NULL_TELEMETRY`` -- a
shared no-op whose ``enabled`` flag gates every per-row and per-step hook
in the engine, so the disabled hot path does no tracing work at all.  The
port's copy of the reference's ``repro.obs``, under the same metric names.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

from repro_torch.obs.compression import (
    NULL_COMPRESSION_TELEMETRY,
    CompressionTelemetry,
    DecompositionReport,
    gram_activation_stats,
)
from repro_torch.obs.metrics import (
    COUNT_BUCKETS,
    FRACTION_BUCKETS,
    TIME_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    MetricsServer,
    write_metrics_json,
)
from repro_torch.obs.profiler import ProfileCapture, annotation, wrap_root
from repro_torch.obs.trace import PID_ENGINE, PID_REQUESTS, EventTracer

__all__ = [
    "Telemetry", "NULL_TELEMETRY", "disabled",
    "CompressionTelemetry", "DecompositionReport",
    "NULL_COMPRESSION_TELEMETRY", "gram_activation_stats",
    "EventTracer", "MetricsRegistry", "MetricsServer",
    "Counter", "Gauge", "Histogram", "ProfileCapture",
    "annotation", "wrap_root", "write_metrics_json",
    "TIME_BUCKETS", "COUNT_BUCKETS", "FRACTION_BUCKETS",
]

_NULLCTX = contextlib.nullcontext()


class Telemetry:
    """Facade the engine talks to: one tracer + one metrics registry +
    optional N-step profiler capture.  Every ``on_*`` hook is host-only
    and O(its arguments); the engine guards per-row work behind
    ``telemetry.enabled`` so the disabled path stays no-op."""

    enabled = True

    def __init__(self, trace_capacity: int = 65536, window: int = 4096,
                 profile_dir: Optional[str] = None, profile_steps: int = 8,
                 spec_meta: Optional[Dict] = None):
        self.tracer = EventTracer(trace_capacity)
        self.metrics = m = MetricsRegistry()
        self.spec_meta = dict(spec_meta or {})
        self.profile = (ProfileCapture(profile_dir, profile_steps)
                        if profile_dir else None)

        # -- request lifecycle
        self.requests_submitted = m.counter(
            "serving_requests_submitted_total", "requests entering the queue")
        self.requests_finished = m.counter(
            "serving_requests_finished_total", "requests fully generated")
        self.tokens_emitted = m.counter(
            "serving_tokens_emitted_total", "tokens committed to requests")
        self.queue_wait = m.histogram(
            "serving_queue_wait_seconds", "submit -> admission wait",
            buckets=TIME_BUCKETS, window=window)
        self.ttft = m.histogram(
            "serving_ttft_seconds", "submit -> first token",
            buckets=TIME_BUCKETS, window=window)
        self.tpot = m.histogram(
            "serving_tpot_seconds", "per-token latency after the first "
            "(time-per-output-token)", buckets=TIME_BUCKETS, window=window)
        self.preempt_ready = m.counter(
            "serving_preempt_ready_total", "rows flagged preemptible "
            "(fired for the victim the scheduler actually evicts, and for "
            "the most-blocks row when admission is backpressured)")

        # -- scheduler (serving/scheduler): growth, preemption, occupancy
        self.preempts = m.counter(
            "serving_preempt_total", "rows preempted (victim evicted)",
            labelnames=("reason",))
        self.swap_bytes = m.counter(
            "serving_swap_bytes_total", "KV bytes swapped to host by "
            "preemptions (resume='swap' only)")
        self.pool_reserved_vs_live = m.gauge(
            "serving_pool_reserved_vs_live_frac", "live committed tokens / "
            "reserved pool tokens at dispatch (on-demand admission drives "
            "this toward 1; worst-case reservation leaves it low)")

        # -- step machinery
        self.step_dispatch = m.histogram(
            "serving_step_dispatch_seconds", "root dispatch wall time",
            buckets=TIME_BUCKETS, window=window)
        self.step_sync = m.histogram(
            "serving_step_sync_seconds", "D2H ring-sync stall per consumed "
            "step", buckets=TIME_BUCKETS, window=window)
        self.step_host = m.histogram(
            "serving_step_host_seconds", "host emission/free bookkeeping "
            "per consumed step", buckets=TIME_BUCKETS, window=window)
        self.ring_depth = m.histogram(
            "serving_ring_depth", "in-flight steps at dispatch",
            buckets=COUNT_BUCKETS, window=window)
        self.batch_occupancy = m.histogram(
            "serving_batch_occupancy_rows", "live rows per dispatched step",
            buckets=COUNT_BUCKETS, window=window)
        self.drains = m.counter(
            "serving_ring_drain_total", "pipeline drains (admission, "
            "defrag, dynamic-k, tail flush)")
        self.steps_dispatched = m.counter(
            "serving_steps_dispatched_total", "decode/spec root dispatches")

        # -- paged block pool (per DP shard)
        self.pool_in_use = m.gauge(
            "serving_pool_blocks_in_use", "live blocks per DP shard",
            labelnames=("shard",))
        self.pool_peak = m.gauge(
            "serving_pool_blocks_peak", "peak live blocks per DP shard",
            labelnames=("shard",))
        self.pool_occupancy = m.histogram(
            "serving_pool_occupancy_frac", "pool fraction in use at "
            "dispatch (max over shards)", buckets=FRACTION_BUCKETS,
            window=window)
        self.defrags = m.counter(
            "serving_defrag_total", "defrag compactions")
        self.defrag_moves = m.counter(
            "serving_defrag_moved_blocks_total", "blocks moved by defrag")
        self.rollbacks = m.counter(
            "serving_rollback_total", "cache length rollbacks "
            "(allocator suffix releases)")

        # -- speculation: outcomes per (window, accepted) and the
        #    acceptance histogram keyed by (k, draft-ratio)
        self.spec_rows = m.counter(
            "serving_spec_rows_total", "speculative row-steps by window "
            "and accepted draft tokens", labelnames=("k", "accepted"))
        self.spec_accepted_hist = m.histogram(
            "serving_spec_accepted_tokens", "accepted draft tokens per "
            "row-step", labelnames=("k", "draft_ratio"),
            buckets=COUNT_BUCKETS, window=window)
        self.spec_committed = m.counter(
            "serving_spec_committed_tokens_total", "tokens committed by "
            "speculative steps (accepted + correction/bonus)")

        # -- fault tolerance (serving/faults): detections, retries,
        #    shedding, degraded components, straggler verdicts
        self.faults = m.counter(
            "serving_faults_total", "faults detected/injected by kind "
            "(poison_logits, alloc_fail, swap_corrupt, straggler, "
            "draft_kill)", labelnames=("kind",))
        self.retries = m.counter(
            "serving_retries_total", "poisoned requests requeued for a "
            "backed-off reprefill retry instead of retiring with an error")
        self.deadline_shed = m.counter(
            "serving_deadline_shed_total", "queued requests shed because "
            "their deadline expired before admission")
        self.degraded_mode = m.gauge(
            "serving_degraded_mode", "1 while a component runs degraded "
            "(draft: spec decode fell back to plain decode)",
            labelnames=("component",))
        self.straggler_steps = m.counter(
            "serving_straggler_steps_total", "watchdog-flagged step "
            "durations by verdict", labelnames=("verdict",))

    # ----------------------------------------------------- request hooks

    def on_submit(self, uid: int, prompt_len: int, max_new: int) -> None:
        self.requests_submitted.inc()
        self.tracer.instant("submit", "request", PID_REQUESTS, uid,
                            {"prompt_len": prompt_len, "max_new": max_new})

    def on_admit(self, uid: int, slot: int, wait_s: float) -> None:
        self.queue_wait.observe(wait_s)
        self.tracer.instant("admit", "request", PID_REQUESTS, uid,
                            {"slot": slot, "queue_wait_s": wait_s})

    def on_first_chunk(self, uid: int, slot: int) -> None:
        self.tracer.instant("first_chunk", "request", PID_REQUESTS, uid,
                            {"slot": slot})

    def on_first_token(self, uid: int, slot: int, ttft_s: float) -> None:
        self.ttft.observe(ttft_s)
        self.tokens_emitted.inc()
        self.tracer.instant("first_token", "request", PID_REQUESTS, uid,
                            {"slot": slot, "ttft_s": ttft_s})

    def on_commit(self, uid: int, slot: int, n_tokens: int) -> None:
        self.tokens_emitted.inc(n_tokens)
        self.tracer.instant("commit", "request", PID_REQUESTS, uid,
                            {"slot": slot, "tokens": n_tokens})

    def on_finish(self, uid: int, n_generated: int, ttft_s: float,
                  tpot_s: float) -> None:
        self.requests_finished.inc()
        if n_generated > 1:
            self.tpot.observe(tpot_s)
        self.tracer.instant("finish", "request", PID_REQUESTS, uid,
                            {"generated": n_generated, "ttft_s": ttft_s,
                             "tpot_s": tpot_s})

    def on_preempt_ready(self, uid: int, slot: int) -> None:
        """A row the scheduler could (or is about to) evict to relieve
        pool pressure — fired for the most-blocks row when admission is
        backpressured, and for the actual victim right before every
        ``on_preempt``."""
        self.preempt_ready.inc()
        self.tracer.instant("preempt_ready", "request", PID_REQUESTS, uid,
                            {"slot": slot})

    # --------------------------------------------------- scheduler hooks
    # (cat="sched": scheduler lifecycle events are engine policy, not part
    # of the per-request event multiset depth-invariance tests pin.)

    def on_grow(self, uid: int, slot: int, n_blocks: int,
                pool_in_use: int) -> None:
        """On-demand block growth extended a live row's reservation."""
        self.tracer.instant("grow", "sched", PID_ENGINE, 0,
                            {"uid": uid, "slot": slot, "blocks": n_blocks,
                             "pool_in_use": pool_in_use})

    def on_preempt(self, uid: int, slot: int, reason: str, blocks: int,
                   swap_bytes: int) -> None:
        """A live row was evicted (reason: "pool_dry" growth pressure or
        "priority" SLA admission); its blocks are free again."""
        self.preempts.labels(reason=reason).inc()
        if swap_bytes:
            self.swap_bytes.inc(swap_bytes)
        self.tracer.instant("preempt", "sched", PID_REQUESTS, uid,
                            {"slot": slot, "reason": reason,
                             "blocks": blocks, "swap_bytes": swap_bytes})

    def on_resume(self, uid: int, slot: int, mode: str) -> None:
        """A preempted request re-entered a slot (reprefill or swap)."""
        self.tracer.instant("resume", "sched", PID_REQUESTS, uid,
                            {"slot": slot, "mode": mode})

    # -------------------------------------------------------- step hooks

    def on_step_dispatch(self, kind: str, ring_depth: int, live_rows: int,
                         dispatch_s: float,
                         pool_in_use: Optional[List[int]] = None,
                         blocks_per_shard: Optional[int] = None,
                         live_tokens: Optional[int] = None,
                         reserved_tokens: Optional[int] = None) -> None:
        self.steps_dispatched.inc()
        self.step_dispatch.observe(dispatch_s)
        self.ring_depth.observe(ring_depth)
        self.batch_occupancy.observe(live_rows)
        args = {"ring_depth": ring_depth, "live_rows": live_rows}
        if pool_in_use is not None and blocks_per_shard:
            for s, used in enumerate(pool_in_use):
                self.pool_in_use.labels(shard=str(s)).set(used)
            frac = max(pool_in_use) / blocks_per_shard
            self.pool_occupancy.observe(frac)
            args["pool_frac"] = frac
        if live_tokens is not None and reserved_tokens:
            self.pool_reserved_vs_live.set(live_tokens / reserved_tokens)
        self.tracer.complete(f"dispatch:{kind}", "step", dispatch_s,
                             PID_ENGINE, 0, args)
        if self.profile is not None:
            self.profile.tick_dispatch()

    def on_step_consume(self, kind: str, sync_s: float,
                        host_s: float) -> None:
        self.step_sync.observe(sync_s)
        self.step_host.observe(host_s)
        self.tracer.complete(f"sync:{kind}", "step", sync_s, PID_ENGINE, 1)
        self.tracer.complete(f"host:{kind}", "step", host_s, PID_ENGINE, 1)
        if self.profile is not None:
            self.profile.tick_consume()

    def on_drain(self, n_in_flight: int) -> None:
        self.drains.inc()
        self.tracer.instant("drain", "step", PID_ENGINE, 0,
                            {"in_flight": n_in_flight})

    def on_defrag(self, moved: int) -> None:
        self.defrags.inc()
        self.defrag_moves.inc(moved)
        self.tracer.instant("defrag", "step", PID_ENGINE, 0,
                            {"moved": moved})

    def on_spec_row(self, k_eff: int, accepted: int) -> None:
        self.spec_rows.labels(k=str(k_eff), accepted=str(accepted)).inc()
        self.spec_accepted_hist.labels(
            k=str(self.spec_meta.get("k", k_eff)),
            draft_ratio=str(self.spec_meta.get("draft_ratio", "?")),
        ).observe(accepted)

    # ------------------------------------------------------- fault hooks
    # (cat="fault": fired where the fault OCCURS — poison at host
    # detection of the packed sentinel, the injected kinds at their
    # injection sites — so the trace timeline localizes each fault.)

    def on_fault(self, kind: str, uid: Optional[int], step: int) -> None:
        self.faults.labels(kind=kind).inc()
        self.tracer.instant(f"fault:{kind}", "fault", PID_ENGINE, 0,
                            {"uid": uid, "step": step})

    def on_retry(self, uid: int, attempt: int, backoff_steps: int) -> None:
        self.retries.inc()
        self.tracer.instant("fault_retry", "fault", PID_REQUESTS, uid,
                            {"attempt": attempt,
                             "backoff_steps": backoff_steps})

    def on_shed(self, uid: int, reason: str) -> None:
        if reason == "deadline":
            self.deadline_shed.inc()
        self.tracer.instant("shed", "fault", PID_REQUESTS, uid,
                            {"reason": reason})

    def on_degraded(self, component: str, active: bool) -> None:
        self.degraded_mode.labels(component=component).set(int(active))
        self.tracer.instant("degraded", "fault", PID_ENGINE, 0,
                            {"component": component, "active": active})

    def on_straggler(self, verdict: str, dur_s: float) -> None:
        self.straggler_steps.labels(verdict=verdict).inc()
        self.tracer.instant("straggler", "fault", PID_ENGINE, 1,
                            {"verdict": verdict, "dur_s": dur_s})

    def span(self, name: str):
        """Host-side profiler span around a dispatch/sync region."""
        return annotation(name)

    # ------------------------------------------------------------ export

    def snapshot(self, engine=None) -> Dict:
        """JSON metrics snapshot, plus engine-derived gauges (pool
        occupancy/peaks, allocator counters, mesh, spec meta) when an
        engine is supplied — all read from host state."""
        if engine is not None:
            self._scrape_engine(engine)
        out: Dict = {"metrics": self.metrics.snapshot(),
                     "trace": {"events": len(self.tracer),
                               "dropped": self.tracer.dropped}}
        if self.spec_meta:
            out["spec_meta"] = dict(self.spec_meta)
        if engine is not None:
            out["engine"] = {
                "stats": engine.stats(),
                "cache": engine.cache_stats(),
                "spec": engine.spec_stats(),
                "scheduler": engine.scheduler_stats(),
                "faults": engine.fault_stats(),
            }
            if engine.kv is not None:
                out["engine"]["allocator"] = dict(engine.kv.alloc.counters)
        return out

    def _scrape_engine(self, engine) -> None:
        if engine.kv is None:
            return
        alloc = engine.kv.alloc
        for s in range(alloc.num_shards):
            self.pool_in_use.labels(shard=str(s)).set(alloc.in_use(s))
            self.pool_peak.labels(shard=str(s)).set(alloc.peak_by_shard[s])
        self.rollbacks.inc(
            alloc.counters["release_suffix_calls"] - self.rollbacks.value)

    def bench_block(self) -> Dict:
        """The BENCH_serving.json schema-6 ``telemetry`` block: TTFT/TPOT
        percentiles, queue wait, occupancy mean/peak, spec win/loss per
        (k, accepted)."""
        def pct(h):
            return {"p50": h.percentile(50), "p99": h.percentile(99),
                    "mean": h.mean(), "count": h.count}

        block: Dict = {
            "ttft_s": pct(self.ttft),
            "tpot_s": pct(self.tpot),
            "queue_wait_s": pct(self.queue_wait),
            "occupancy": {
                "rows_mean": self.batch_occupancy.mean(),
                "rows_peak": self.batch_occupancy.max,
                "pool_frac_mean": self.pool_occupancy.mean(),
                "pool_frac_peak": self.pool_occupancy.max,
            },
            "steps": int(self.steps_dispatched.value),
            "tokens": int(self.tokens_emitted.value),
        }
        outcomes = [
            dict(k=int(labels["k"]), accepted=int(labels["accepted"]),
                 rows=int(child.value))
            for labels, child in self.spec_rows.series()
        ]
        if outcomes:
            total = sum(o["rows"] for o in outcomes)
            accepted = sum(o["accepted"] * o["rows"] for o in outcomes)
            proposed = sum(o["k"] * o["rows"] for o in outcomes)
            block["spec"] = {
                "k": self.spec_meta.get("k"),
                "draft_ratio": self.spec_meta.get("draft_ratio"),
                "outcomes": outcomes,
                "row_steps": total,
                "acceptance_rate": accepted / max(1, proposed),
            }
        else:
            block["spec"] = None
        return block


class _NullTelemetry:
    """Shared no-op: every hook is a pass, ``span`` hands back one reused
    nullcontext.  The engine stores this when no telemetry is supplied and
    additionally guards per-row work behind ``enabled``."""

    enabled = False
    __slots__ = ()

    def span(self, name):
        return _NULLCTX

    def on_submit(self, uid, prompt_len, max_new):
        pass

    def on_admit(self, uid, slot, wait_s):
        pass

    def on_first_chunk(self, uid, slot):
        pass

    def on_first_token(self, uid, slot, ttft_s):
        pass

    def on_commit(self, uid, slot, n_tokens):
        pass

    def on_finish(self, uid, n_generated, ttft_s, tpot_s):
        pass

    def on_preempt_ready(self, uid, slot):
        pass

    def on_grow(self, uid, slot, n_blocks, pool_in_use):
        pass

    def on_preempt(self, uid, slot, reason, blocks, swap_bytes):
        pass

    def on_resume(self, uid, slot, mode):
        pass

    def on_step_dispatch(self, kind, ring_depth, live_rows, dispatch_s,
                         pool_in_use=None, blocks_per_shard=None,
                         live_tokens=None, reserved_tokens=None):
        pass

    def on_step_consume(self, kind, sync_s, host_s):
        pass

    def on_drain(self, n_in_flight):
        pass

    def on_defrag(self, moved):
        pass

    def on_spec_row(self, k_eff, accepted):
        pass

    def on_fault(self, kind, uid, step):
        pass

    def on_retry(self, uid, attempt, backoff_steps):
        pass

    def on_shed(self, uid, reason):
        pass

    def on_degraded(self, component, active):
        pass

    def on_straggler(self, verdict, dur_s):
        pass

    def snapshot(self, engine=None):
        return {}


NULL_TELEMETRY = _NullTelemetry()


def disabled() -> _NullTelemetry:
    """The no-op telemetry singleton (the engine default)."""
    return NULL_TELEMETRY
