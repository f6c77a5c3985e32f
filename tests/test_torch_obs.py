"""Port parity for serving observability: the port's ``Telemetry`` against
the reference's on the same prompts and weights (equal non-timing
counters, histogram counts and per-request event-name sequences, across
pipeline depths 1-4, under preemption with swap, under faults and under a
draft kill); telemetry as a pure observer (streams bit-identical on and
off); the null singleton; the event ring and its exports; the Prometheus
text against the reference's for the same observations; the scrape
server; ``bench_block()``; the profiler capture on the CPU; and the serve
CLI's telemetry flags."""

import json
import re
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
from torch_parity import _spread_and_compress, tiny_cfgs, to_t

from repro.models import build_model as jax_build_model
from repro.obs import Telemetry as JaxTelemetry
from repro.serving import faults as jax_faults
from repro.serving import scheduler as jax_sched
from repro.serving.engine import ServingEngine as JaxEngine
from repro.serving.spec import SpecConfig as JaxSpecConfig
from repro_torch.launch import serve as torch_serve
from repro_torch.models import build_model
from repro_torch.obs import (NULL_TELEMETRY, EventTracer, MetricsRegistry, MetricsServer,
                             ProfileCapture, Telemetry, disabled, write_metrics_json)
from repro_torch.obs.trace import PID_REQUESTS
from repro_torch.serving import faults as torch_faults
from repro_torch.serving import scheduler as torch_sched
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.spec import SpecConfig

VOCAB = 64
LENS = (9, 3, 6, 4)
SIDES = ((JaxEngine, JaxTelemetry, jax_faults, jax_sched, JaxSpecConfig),
         (ServingEngine, Telemetry, torch_faults, torch_sched, SpecConfig))
# Families whose values are wall times (their counts still compare), and
# the watchdog's verdicts, which a loaded host's slow steps move.
TIMED = {"serving_queue_wait_seconds", "serving_ttft_seconds", "serving_tpot_seconds",
         "serving_step_dispatch_seconds", "serving_step_sync_seconds",
         "serving_step_host_seconds"}
VERDICTS = "serving_straggler_steps_total"


@pytest.fixture(scope="module")
def lm():
    """(reference model, params, port model, params, reference draft, port
    draft): a 2-layer d_model-64 LLaMA with spread logits, and a draft of
    the same weights plus seeded noise."""
    jcfg, tcfg = tiny_cfgs("small-llama", d_model=64, d_ff=96, vocab=VOCAB)
    jmodel = jax_build_model(jcfg)
    jparams = _spread_and_compress(jmodel, jmodel.init(jax.random.key(0)), "dense", VOCAB)
    rng = np.random.default_rng(99)
    jdraft = jax.tree.map(lambda x: x + 0.02 * rng.standard_normal(x.shape).astype(x.dtype)
                          if x.ndim >= 2 else x, jparams)
    return jmodel, jparams, build_model(tcfg), to_t(jparams), jdraft, to_t(jdraft)


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(1)
    return [rng.integers(2, VOCAB - 2, size=n) for n in (6, 18, 7, 5)]


def _serve(lm, side, prompts, lens=LENS, depth=2, telemetry=True, specs=None, policy=None,
           sched=None, spec=False, drive=None, **kw):
    """Serve ``prompts`` on one side (0: reference, 1: port) with a fresh
    Telemetry, none (False) or the one given; returns (streams, engine)."""
    cls, tel_cls, faults, sched_mod, spec_cls = SIDES[side]
    model, params, draft = lm[side * 2], lm[side * 2 + 1], lm[4 + side]
    plan = None if specs is None else faults.FaultPlan([faults.FaultSpec(**s) for s in specs])
    eng = cls(model, params, max_batch=2, max_len=64, seed=0, pipeline_depth=depth,
              telemetry=(tel_cls() if telemetry is True else telemetry or None), faults=plan,
              fault_policy=None if policy is None else faults.FaultPolicy(**policy),
              sched_config=sched_mod.SchedulerConfig(**(sched or {})),
              spec_config=spec_cls(draft_params=draft, k=3, draft_ratio=0.6) if spec else None,
              **kw)
    uids = [eng.submit(p, max_new_tokens=m) for p, m in zip(prompts, lens)]
    if drive is None:
        eng.run()
    else:
        drive(eng)
    return [eng.finished_requests[u].generated for u in uids], eng


def _view(tel):
    """Everything of a Telemetry that does not depend on host timing:
    counters and gauges by series (but the watchdog's verdicts), each
    histogram's count (and, for non-time histograms, its buckets and sum),
    and every request's event names in order (pid ``PID_REQUESTS``, by
    uid)."""
    out = {}
    for name, fam in tel.metrics.snapshot().items():
        if name == VERDICTS:
            continue
        for s in fam["series"]:
            key = (name, tuple(sorted(s["labels"].items())))
            if fam["type"] == "histogram":
                out[key] = (s["count"] if name in TIMED
                            else (s["count"], s["sum"], s["buckets"]))
            elif name != "serving_pool_reserved_vs_live_frac" or s["value"] == 0:
                out[key] = s["value"]
    events = {}
    for e in tel.tracer.events():
        if e.pid == PID_REQUESTS:
            events.setdefault(e.tid, []).append(e.name)
    return out, events


def _both(lm, prompts, **kw):
    (jout, jeng), (tout, teng) = (_serve(lm, side, prompts, **kw) for side in (0, 1))
    return jout, tout, jeng, teng


# ------------------------------------------------------ pure observer


@pytest.mark.parametrize("paged", [True, False])
def test_streams_identical_with_telemetry(lm, prompts, paged):
    base, _ = _serve(lm, 1, prompts, depth=1, telemetry=False, paged=paged)
    for depth in (1, 2, 4):
        got, eng = _serve(lm, 1, prompts, depth=depth, paged=paged)
        assert got == base, (depth, paged)
        assert eng.obs.enabled and eng.telemetry_snapshot()["engine"]["stats"]["steps"] > 0


def test_spec_streams_identical_with_telemetry(lm, prompts):
    base, _ = _serve(lm, 1, prompts, depth=1, telemetry=False, spec=True)
    got, eng = _serve(lm, 1, prompts, depth=2, spec=True)
    assert got == base and eng.obs.spec_meta == {"k": 3, "draft_ratio": 0.6}


# ------------------------------------------------ against the reference


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
def test_telemetry_matches_reference_across_depths(lm, prompts, depth):
    jout, tout, jeng, teng = _both(lm, prompts, depth=depth)
    assert tout == jout
    assert _view(teng.obs) == _view(jeng.obs)
    assert teng.obs.tokens_emitted.value == sum(LENS)


def test_telemetry_matches_reference_under_swap_preemption(lm, prompts):
    """A 6-block pool on demand with swap resume: preemptions, swap bytes,
    growth and resumes (the sched events) equal the reference's."""
    kw = dict(lens=(20, 20, 20, 20), num_blocks=6, block_size=8,
              sched={"resume": "swap"})
    jout, tout, jeng, teng = _both(lm, prompts, **kw)
    assert tout == jout
    assert _view(teng.obs) == _view(jeng.obs)
    names = {e.name for e in teng.obs.tracer.events()}
    assert {"preempt", "resume", "grow", "preempt_ready"} <= names
    sch = teng.scheduler_stats()
    assert teng.obs.preempts.labels(reason="pool_dry").value == sch["preempt_count"] > 0
    assert teng.obs.swap_bytes.value == sch["swap_bytes"] > 0


def test_telemetry_matches_reference_under_faults(lm, prompts):
    """Poison with a retry, failed reservations and a straggler: faults by
    kind, retries and the lifecycle events equal the reference's."""
    specs = [dict(kind="poison_logits", step=2, uid=0), dict(kind="alloc_fail", step=0),
             dict(kind="alloc_fail", step=5), dict(kind="straggler", step=9, delay_s=0.01)]
    jout, tout, jeng, teng = _both(lm, prompts, specs=specs,
                                   policy=dict(max_retries=1, retry_backoff_steps=2))
    assert tout == jout
    # The straggler's flag depends on host timing (_view leaves it out);
    # its injection does not.
    assert _view(teng.obs) == _view(jeng.obs)
    fs = teng.fault_stats()
    for kind, n in fs["injected"].items():
        assert teng.obs.faults.labels(kind=kind).value == n
    assert teng.obs.retries.value == fs["retried"] == 1


def test_telemetry_matches_reference_under_draft_kill(lm, prompts):
    """Speculative serving with a draft kill (2 plain steps of cool-down)
    and a poisoned row: spec rows by (k, accepted), the degraded gauge and
    the events equal the reference's; acceptance as spec_stats()."""
    kw = dict(spec=True, specs=[dict(kind="draft_kill", step=1),
                                dict(kind="poison_logits", step=3, uid=0)],
              policy=dict(max_retries=1, retry_backoff_steps=1, draft_cooldown_steps=2))
    jout, tout, jeng, teng = _both(lm, prompts, **kw)
    assert tout == jout
    assert _view(teng.obs) == _view(jeng.obs)
    block, ss = teng.obs.bench_block()["spec"], teng.spec_stats()
    assert block["acceptance_rate"] == ss["acceptance_rate"]
    assert sum(o["accepted"] * o["rows"] for o in block["outcomes"]) == ss["accepted"]
    assert sum(o["k"] * o["rows"] for o in block["outcomes"]) == ss["proposed"]
    assert teng.obs.degraded_mode.labels(component="draft").value == 0
    degraded = [e.args["active"] for e in teng.obs.tracer.events() if e.name == "degraded"]
    assert degraded == [True, False]


def test_preempt_ready_under_backpressure_like_reference(lm):
    """A 4-block pool under worst-case admission (3 blocks a request): the
    head waits on the pool with a slot free, and the row holding the most
    blocks is flagged preempt_ready once, as the reference flags it."""
    rng = np.random.default_rng(3)
    ps = [rng.integers(2, VOCAB - 2, size=12) for _ in range(3)]
    jout, tout, jeng, teng = _both(lm, ps, lens=(30, 30, 30), num_blocks=4, block_size=16,
                                   sched={"admission": "worst_case"})
    assert tout == jout and _view(teng.obs) == _view(jeng.obs)
    assert teng.obs.preempt_ready.value >= 1


def test_lifecycle_order_and_timestamps(lm, prompts):
    _, eng = _serve(lm, 1, prompts, depth=2)
    rank = {"submit": 0, "admit": 1, "first_chunk": 2, "first_token": 3, "commit": 4,
            "finish": 5}
    by_uid = {}
    for e in eng.obs.tracer.events():
        if e.cat == "request":
            by_uid.setdefault(e.tid, []).append((e.name, e.ts_us))
    assert set(by_uid) == set(range(len(prompts)))
    for uid, evs in by_uid.items():
        names = [n for n, _ in evs]
        assert re.fullmatch("S(ACFK*)+E", "".join(
            "SACFKE"[rank[n]] for n in names)), (uid, names)
        assert [t for _, t in evs] == sorted(t for _, t in evs)


def test_snapshot_scrapes_the_allocator(lm, prompts):
    _, eng = _serve(lm, 1, prompts)
    snap = eng.telemetry_snapshot()
    c = eng.kv.alloc.counters
    assert snap["engine"]["allocator"] == c and c["freed_blocks"] == c["alloc_blocks"] > 0
    assert set(snap["engine"]) == {"stats", "cache", "spec", "scheduler", "faults",
                                   "allocator"}
    assert snap["trace"] == {"events": len(eng.obs.tracer), "dropped": 0}
    peak = snap["metrics"]["serving_pool_blocks_peak"]["series"][0]
    assert peak["value"] == eng.kv.alloc.peak_by_shard[0] > 0
    json.dumps(snap)


def test_bench_block_shape(lm, prompts):
    _, eng = _serve(lm, 1, prompts)
    bb = eng.obs.bench_block()
    assert bb["ttft_s"]["count"] == bb["queue_wait_s"]["count"] == len(prompts)
    assert bb["tpot_s"]["count"] == sum(n > 1 for n in LENS)
    assert bb["tokens"] == sum(LENS) and bb["steps"] == eng.stats()["steps"]
    assert 0 < bb["occupancy"]["rows_peak"] <= 2
    assert 0.0 < bb["occupancy"]["pool_frac_peak"] <= 1.0
    assert bb["spec"] is None
    assert set(bb) == {"ttft_s", "tpot_s", "queue_wait_s", "occupancy", "steps", "tokens",
                       "spec"}
    json.dumps(bb)


# ------------------------------------------------------- disabled path


def test_engine_default_is_null_singleton(lm):
    eng = ServingEngine(lm[2], lm[3], max_batch=2, max_len=64)
    assert eng.obs is NULL_TELEMETRY is disabled() and not eng.obs.enabled
    assert eng.telemetry_snapshot() == {}


def test_null_span_is_one_reused_nullcontext():
    a, b = NULL_TELEMETRY.span("x"), NULL_TELEMETRY.span("y")
    assert a is b
    with a:
        pass
    NULL_TELEMETRY.on_submit(0, 1, 2)
    NULL_TELEMETRY.on_step_dispatch("decode", 1, 2, 0.1)
    assert NULL_TELEMETRY.snapshot() == {} and not hasattr(NULL_TELEMETRY, "__dict__")


# ------------------------------------------------- event ring, exports


def test_ring_buffer_bound_and_dropped_count():
    tr = EventTracer(capacity=8)
    for i in range(20):
        tr.instant(f"e{i}", "step", 0, 0)
    assert len(tr) == 8 and tr.dropped == 12 and tr.total == 20
    assert [e.name for e in tr.events()] == [f"e{i}" for i in range(12, 20)]
    assert tr.chrome_trace()["otherData"] == {"dropped_events": 12, "total_events": 20}
    with pytest.raises(ValueError):
        EventTracer(capacity=0)


def test_chrome_and_jsonl_exports_round_trip(lm, prompts, tmp_path):
    _, eng = _serve(lm, 1, prompts)
    tr = eng.obs.tracer
    tr.export_chrome(str(tmp_path / "t.json"))
    tr.export_jsonl(str(tmp_path / "t.jsonl"))
    doc = json.loads((tmp_path / "t.json").read_text())
    evs = [e for e in doc["traceEvents"] if e["ph"] != "M"]
    lines = [json.loads(ln) for ln in (tmp_path / "t.jsonl").read_text().splitlines()]
    assert evs == lines == [e.to_chrome() for e in tr.events()]
    assert {"submit", "finish", "dispatch:decode", "sync:decode", "host:decode"} <= {
        e["name"] for e in evs}
    for e in evs:
        assert e["dur"] >= 0 if e["ph"] == "X" else e["s"] == "t"


def test_prometheus_text_equal_to_reference():
    """The same observations through both facades give the same text."""
    texts = []
    for tel in (JaxTelemetry(spec_meta={"k": 4, "draft_ratio": 0.6}),
                Telemetry(spec_meta={"k": 4, "draft_ratio": 0.6})):
        tel.on_submit(0, 12, 8)
        tel.on_admit(0, 1, 0.002)
        tel.on_first_chunk(0, 1)
        tel.on_first_token(0, 1, 0.25)
        tel.on_commit(0, 1, 3)
        tel.on_step_dispatch("spec", 2, 5, 0.004, [7, 3], 16, 40, 112)
        tel.on_step_consume("spec", 0.001, 0.0005)
        tel.on_spec_row(4, 2)
        tel.on_spec_row(3, 3)
        tel.on_preempt(0, 1, "pool_dry", 4, 4096)
        tel.on_fault("alloc_fail", -1, 7)
        tel.on_retry(0, 1, 2)
        tel.on_shed(2, "deadline")
        tel.on_degraded("draft", True)
        tel.on_straggler("slow", 0.3)
        tel.on_drain(2)
        tel.on_defrag(5)
        tel.on_finish(0, 4, 0.25, 0.01)
        texts.append(tel.metrics.prometheus_text())
        assert tel.bench_block()["spec"]["acceptance_rate"] == 5 / 7
    assert texts[1] == texts[0]
    assert 'serving_spec_rows_total{k="4",accepted="2"} 1' in texts[1]


def test_metrics_server_http(tmp_path):
    """/metrics, /metrics.json, a 404, /healthz 503 naming the degraded
    component and then 200; close() releases the port."""
    reg = MetricsRegistry()
    reg.counter("smoke_total", "x").inc(3)
    degraded = {"draft": {"off_until_step": 9}}
    srv = MetricsServer(reg, port=0, health=lambda: dict(degraded))
    base = f"http://127.0.0.1:{srv.port}"
    try:
        with urllib.request.urlopen(base + "/metrics") as r:
            assert "smoke_total 3" in r.read().decode()
            assert r.headers["Content-Type"].startswith("text/plain")
        with urllib.request.urlopen(base + "/metrics.json") as r:
            assert json.loads(r.read())["smoke_total"]["series"][0]["value"] == 3
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(base + "/healthz")
        assert ei.value.code == 503
        assert json.loads(ei.value.read()) == {"status": "degraded", "components": degraded}
        degraded.clear()
        with urllib.request.urlopen(base + "/healthz") as r:
            assert r.status == 200 and r.read() == b"ok\n"
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(base + "/nope")
    finally:
        srv.close()
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(base + "/healthz", timeout=2)
    path = tmp_path / "m.json"
    write_metrics_json(reg, str(path), extra={"engine": {"steps": 1}})
    assert json.loads(path.read_text()) == {"metrics": reg.snapshot(), "engine": {"steps": 1}}


# ----------------------------------------------------- profiler, CLI


def test_roots_are_named_like_the_reference(lm):
    """Every root the engines build carries ``__obs_name__``, the
    reference's root names."""
    from repro.launch.steps import serving_root_registry

    want = {spec.name for layout in ("dense", "paged")
            for spec in serving_root_registry(layout, spec=True)}
    got = set()
    for paged in (True, False):
        eng = ServingEngine(lm[2], lm[3], max_batch=2, max_len=64, paged=paged,
                            spec_config=SpecConfig(draft_params=lm[5], k=3) if paged else None)
        roots = [eng._decode, eng._chunk_step if paged else eng._prefill]
        if paged:
            roots += [eng._spec_draft, eng._spec_verify, eng._draft_prefill]
        got |= {fn.__obs_name__ for fn in roots}
    assert got <= want and {"paged_decode", "paged_prefill_chunk", "decode", "prefill_admit",
                            "spec_draft", "spec_verify"} <= got


def test_profile_capture_writes_trace_on_cpu(lm, prompts, tmp_path):
    tel = Telemetry(profile_dir=str(tmp_path / "prof"), profile_steps=2)
    _serve(lm, 1, prompts, depth=1, telemetry=tel)
    prof = tel.profile
    assert prof.error is None and prof.finished and prof.trace_path is not None
    doc = json.loads(open(prof.trace_path).read())
    names = {e.get("name") for e in doc["traceEvents"]}
    assert "serving_root.paged_decode" in names and "serving.dispatch.decode" in names
    (tmp_path / "file").write_text("")
    bad = ProfileCapture(str(tmp_path / "file" / "prof"))  # a directory under a file
    bad.tick_dispatch()
    assert bad.finished and bad.error is not None and bad.trace_path is None


def test_serve_cli_telemetry_flags_write_files(tmp_path, capsys):
    out = {k: str(tmp_path / k) for k in ("m.json", "t.json", "t.jsonl", "prof")}
    torch_serve.main(["--arch", "mistral-7b", "--device", "cpu", "--requests", "2",
                      "--max-new", "4", "--layers", "1", "--metrics-port", "0",
                      "--metrics-json", out["m.json"], "--trace-chrome", out["t.json"],
                      "--trace-jsonl", out["t.jsonl"], "--profile-dir", out["prof"],
                      "--profile-steps", "2", "--paged", "on"])
    text = capsys.readouterr().out
    assert "telemetry: ttft p50=" in text and "metrics: http://127.0.0.1:" in text
    doc = json.loads(open(out["m.json"]).read())
    assert doc["metrics"]["serving_ttft_seconds"]["series"][0]["count"] == 2
    assert doc["engine"]["stats"]["steps"] > 0 and doc["telemetry"]["tokens"] == 8
    assert json.loads(open(out["t.json"]).read())["traceEvents"]
    assert open(out["t.jsonl"]).read().count("\n") > 0
    assert any(p.name.endswith(".pt.trace.json") for p in (tmp_path / "prof").iterdir())


def test_transfer_guard_refused_on_cpu(lm, capsys):
    with pytest.raises(SystemExit):
        torch_serve.main(["--device", "cpu", "--transfer-guard"])
    assert "--transfer-guard" in capsys.readouterr().err
    with pytest.raises(ValueError, match="transfer_guard"):
        ServingEngine(lm[2], lm[3], max_batch=2, max_len=64, transfer_guard=True)


def test_chip_obs_path_holds_on_cpu(tmp_path, monkeypatch):
    """chip_smoke's obs_serve path (phase 4e) on a tiny Mistral-family
    model on the CPU, with a noisy copy of its weights as the draft: every
    gate of the card but the kernels in the captured trace."""
    import torch

    import chip_smoke as cs
    from repro_torch.configs import paper_models as torch_paper

    monkeypatch.setattr(cs, "OBS_PROFILE_DIR", str(tmp_path / "prof"))
    cfg = torch_paper.small_lm(family_of=torch_paper.MISTRAL_7B, name="small-mistral",
                               num_layers=2, d_model=32, d_ff=48, vocab_size=64, num_heads=4)
    model = build_model(cfg)
    params = model.init(0, "cpu")
    gen = torch.Generator().manual_seed(1)

    def noisy(t):
        if isinstance(t, dict):
            return {k: noisy(v) for k, v in t.items()}
        return t + 0.02 * torch.randn(t.shape, generator=gen) if t.ndim >= 2 else t

    draft = noisy(params)
    rng = np.random.default_rng(0)
    served = {"model": model, "params": params, "draft": draft,
              "prompts": [rng.integers(2, 32, size=int(n)) for n in rng.integers(16, 201, 8)],
              "sched": {"prompts": [rng.integers(2, 32, size=int(n))
                                    for n in rng.integers(16, 201, cs.SCHED_REQUESTS)]}}
    offs, hooks, ons, o3, o4 = cs.obs_runs(torch, np, served, pairs=1)
    gates, trace, health = cs.obs_gates(offs, hooks, ons, o3, o4, 8, cuda=False)
    assert all(gates.values()), (gates, trace, health)
    assert trace["found"]["serving_root.paged_decode"] >= cs.OBS_PROFILE_STEPS - 1
    assert o3[1]["summary"]["stats"]["steps"] > 0 and o3[1]["engine"].sched_events["preemptions"]
