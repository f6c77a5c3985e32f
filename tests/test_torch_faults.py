"""Port parity for the fault-tolerance slice: the port's engine gives the
reference engine's greedy streams, finish reasons, ``fault_stats()`` and
scheduler counters under the same ``FaultPlan`` (poisoned logits with
quarantine and retry on both cache layouts at depths 1 and 2, failed
reservations, corrupted swap payloads, stragglers and the hard step
timeout, deadlines, cancel, drain and close); the decode step's finite
check against the reference's; the plan, spec and policy copies; and the
swap CRC fallback at a block-multiple context, where the two engines
differ by design."""

import dataclasses
import json
import time

import numpy as np
import pytest
import torch
from torch_parity import tiny_lm

import jax.numpy as jnp
from repro.launch import steps as jax_steps
from repro.serving import faults as jax_faults
from repro.serving import scheduler as jax_sched
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch.launch import steps as torch_steps
from repro_torch.serving import faults as torch_faults
from repro_torch.serving import scheduler as torch_sched
from repro_torch.serving.engine import ServingEngine

# Compared by equality; the straggler counters depend on host timing.
TIMED = ("straggler_slow", "straggler_trips")
SCHED_COUNTERS = ("preempt_count", "resumes", "grown_blocks", "stalls", "swap_bytes",
                  "queued")
PAGED_KW = dict(max_batch=3, max_len=64, block_size=8, prefill_chunk=8)
PACKAGES = ((JaxEngine, jax_faults, jax_sched), (ServingEngine, torch_faults, torch_sched))


@pytest.fixture(scope="module")
def lm():
    return tiny_lm("dense")


def _prompts(seed, n, lo=4, hi=10):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, 60, size=int(rng.integers(lo, hi))) for _ in range(n)]


def _engines(lm, specs=None, policy=None, sched=None, **kw):
    """(reference engine, port engine) with the same plan, policy and
    scheduler config; each engine gets its own plan (a plan is consumed)."""
    jmodel, jparams, tmodel, tparams = lm
    out = []
    for (cls, faults, sched_mod), model, params in zip(
            PACKAGES, (jmodel, tmodel), (jparams, tparams)):
        plan = (None if specs is None
                else faults.FaultPlan([faults.FaultSpec(**s) for s in specs]))
        pol = None if policy is None else faults.FaultPolicy(**policy)
        out.append(cls(model, params, faults=plan, fault_policy=pol,
                       sched_config=sched_mod.SchedulerConfig(**(sched or {})),
                       **dict(PAGED_KW, **kw)))
    return out


def _outcome(eng, uids):
    """Streams and finish reasons by uid, and every counter but the timed."""
    fs = {k: v for k, v in eng.fault_stats().items() if k not in TIMED}
    st = eng.scheduler_stats()
    return ([eng.finished_requests[u].generated for u in uids],
            [eng.finished_requests[u].finish_reason for u in uids],
            fs, {k: st[k] for k in SCHED_COUNTERS})


def _run_both(lm, prompts, max_new=12, drive=None, **kw):
    """Submit ``prompts`` to both engines and run them (or ``drive(eng,
    faults)``, which returns the uids); returns (reference, port) outcomes
    and the two engines."""
    outs, engs = [], _engines(lm, **kw)
    for eng, (_, faults, _) in zip(engs, PACKAGES):
        if drive is None:
            uids = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
            eng.run()
        else:
            uids = drive(eng, faults)
        outs.append(_outcome(eng, uids))
    return outs, engs


def _fault_free(lm, prompts, max_new=12, **kw):
    _, _, tmodel, tparams = lm
    eng = ServingEngine(tmodel, tparams, **dict(PAGED_KW, **kw))
    uids = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    eng.run()
    return [eng.finished_requests[u].generated for u in uids]


# ------------------------------------------------- the decode step's check


def test_sample_advance_exit_finite_check_matches_reference():
    """NaN and Inf rows (live, inactive and host-masked), finishing and
    healthy rows: the same tokens, lengths, budgets and active flags, and
    the same rows' keys advance; POISON_TOKEN is -2 in both packages."""
    assert torch_steps.POISON_TOKEN == jax_steps.POISON_TOKEN == -2
    rng = np.random.default_rng(0)
    b, v = 10, 32
    logits = rng.standard_normal((b, 1, v)).astype(np.float32)
    logits[1, 0, 3] = np.nan
    logits[2, 0, 7] = np.inf
    logits[3, 0, 0] = -np.inf
    logits[4, 0, :] = np.nan           # NaN row, inactive
    logits[5, 0, 9] = np.inf           # Inf row, host-masked
    last = rng.integers(0, v, b).astype(np.int32)
    cache_len = rng.integers(1, 20, b).astype(np.int32)
    cache_len[6] = 30                  # reaches max_len - 1 this step
    budget = rng.integers(2, 9, b).astype(np.int32)
    budget[7] = 1                      # spends its budget this step
    active = np.ones(b, bool)
    active[4] = False
    keep = np.ones(b, bool)
    keep[5] = False
    temps = np.zeros(b, np.float32)
    eos = np.full(b, -1, np.int32)
    eos[8] = int(np.argmax(logits[8, 0]))  # samples its eos
    ref = jax_steps._sample_advance_exit(
        jnp.asarray(logits), jnp.asarray(last), jnp.asarray(cache_len),
        jnp.asarray(budget), jnp.zeros((b, 2), jnp.uint32) + 7, jnp.asarray(active),
        jnp.asarray(keep), jnp.asarray(temps), jnp.asarray(eos), 32)
    port = torch_steps._sample_advance_exit(
        torch.from_numpy(logits), torch.from_numpy(last), torch.from_numpy(cache_len),
        torch.from_numpy(budget), torch.full((b, 2), 7, dtype=torch.int64),
        torch.from_numpy(active), torch.from_numpy(keep), torch.from_numpy(temps),
        torch.from_numpy(eos), 32)
    for i in (0, 1, 2, 4):  # sampled, cache_len, budget, active
        np.testing.assert_array_equal(np.asarray(ref[i]), port[i].numpy())
    np.testing.assert_array_equal(np.asarray(ref[3] != 7).any(-1),
                                  (port[3] != 7).any(-1).numpy())
    tok, act = port[0].numpy(), port[4].numpy()
    assert (tok[1:4] == -2).all() and not act[1:4].any()
    assert tok[4] == last[4] and tok[5] == last[5] and act[5]  # frozen
    assert not act[6:9].any() and act[0] and act[9]


class _FixedLogits:
    """A model whose decode returns fixed logits (for make_decode_sample_step)."""

    def __init__(self, logits):
        self.logits = logits

    def apply(self, params, tokens, **kw):
        return self.logits


def test_poison_input_zero_is_identity_on_bf16_logits():
    """bf16 logits plus the fp32 poison vector promote to fp32: a zero
    vector leaves every token as without the input; a NaN row reports
    POISON_TOKEN and clears its active flag, the other rows unchanged."""
    gen = torch.Generator().manual_seed(0)
    b, v = 8, 64
    logits = torch.randn((b, 1, v), generator=gen).to(torch.bfloat16)
    logits[:, 0, 5] = logits[:, 0, 9]  # exact ties keep the first index
    step = torch_steps.make_decode_sample_step(_FixedLogits(logits), 64)
    state = (torch.zeros(b, dtype=torch.int32), torch.full((b,), 4, dtype=torch.int32),
             torch.full((b,), 9, dtype=torch.int32), torch.zeros((b, 2), dtype=torch.int64),
             torch.ones(b, dtype=torch.bool), torch.ones(b, dtype=torch.bool),
             torch.zeros(b), torch.full((b,), -1, dtype=torch.int32))
    plain = step(None, None, *state)
    zero = step(None, None, *state, torch.zeros(b))
    for a, z in zip(plain, zero):
        assert torch.equal(a, z)
    poison = torch.zeros(b)
    poison[3] = float("nan")
    hit = step(None, None, *state, poison)
    assert hit[0][3] == torch_steps.POISON_TOKEN and not hit[4][3]
    keep = torch.arange(b) != 3
    assert torch.equal(hit[0][keep], plain[0][keep]) and hit[4][keep].all()


# ------------------------------------------------ plan, spec and policy copies


@pytest.mark.parametrize("faults", [jax_faults, torch_faults], ids=["reference", "port"])
def test_spec_plan_and_policy_units(faults, tmp_path):
    """The reference's plan units, on both copies."""
    assert faults.FAULT_KINDS == ("poison_logits", "alloc_fail", "swap_corrupt",
                                  "straggler", "draft_kill")
    assert faults.FINISH_REASONS == ("stop", "error", "deadline", "cancelled", "shutdown")
    with pytest.raises(ValueError, match="unknown fault kind"):
        faults.FaultSpec("meteor_strike")
    with pytest.raises(ValueError, match="uid"):
        faults.FaultSpec("poison_logits")
    for kw in ({"step": -1}, {"delay_s": -0.1}):
        with pytest.raises(ValueError):
            faults.FaultSpec("straggler", **kw)
    plan = faults.FaultPlan([faults.FaultSpec("alloc_fail", step=3),
                             faults.FaultSpec("swap_corrupt", uid=7),
                             faults.FaultSpec("straggler", step=999)])
    assert plan.take("alloc_fail", 2) is None and plan.take("alloc_fail", 3).step == 3
    assert plan.take("alloc_fail", 4) is None
    assert plan.take("swap_corrupt", 0, uid=3) is None
    assert plan.take("swap_corrupt", 0, uid=None) is None
    assert plan.take("swap_corrupt", 0, uid=7) is not None
    assert plan.counts() == {"alloc_fail": 1, "swap_corrupt": 1}
    assert [s.kind for s in plan.outstanding()] == ["straggler"]
    path = tmp_path / "plan.json"
    path.write_text(plan.to_json())
    assert faults.FaultPlan.from_json(str(path)).specs == plan.specs
    path.write_text(json.dumps({"faults": [{"kind": "alloc_fail"},
                                           {"kind": "straggler", "step": 3}]}))
    assert faults.FaultPlan.from_json(str(path)).specs[1].step == 3
    pol = faults.FaultPolicy(max_retries=8, retry_backoff_steps=4, retry_backoff_cap=64)
    assert [pol.backoff(a) for a in range(1, 7)] == [4, 8, 16, 32, 64, 64]
    for kw in ({"max_retries": -1}, {"retry_backoff_steps": 0}, {"retry_backoff_cap": 0}):
        with pytest.raises(ValueError):
            faults.FaultPolicy(**kw)
    h = faults.ServingFaultHandler(faults.FaultPolicy(max_retries=2))
    r = type("R", (), {"retries": 0})()
    assert [h.disposition(r) for _ in range(3)] == [("retry", 4), ("retry", 8),
                                                    ("quarantine", 0)]
    assert (h.retried, h.quarantined, r.retries) == (2, 1, 2)


def test_reference_plan_json_loads_in_the_port(tmp_path):
    plan = jax_faults.FaultPlan([
        jax_faults.FaultSpec("poison_logits", step=2, uid=1),
        jax_faults.FaultSpec("straggler", step=4, delay_s=0.5),
        jax_faults.FaultSpec("swap_corrupt"), jax_faults.FaultSpec("draft_kill", step=9)])
    path = tmp_path / "plan.json"
    path.write_text(plan.to_json())
    back = torch_faults.FaultPlan.from_json(str(path))
    assert [dataclasses.asdict(s) for s in back.specs] == [
        dataclasses.asdict(s) for s in plan.specs]
    assert back.to_json() == plan.to_json()


# ----------------------------------------------- the engine against the reference


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("depth", [1, 2])
def test_quarantine_matches_reference(lm, paged, depth):
    """A poisoned request ends with "error"; the others' streams are the
    fault-free run's; streams, reasons and counters are the reference's."""
    prompts = _prompts(20, 3)
    (ref, port), _ = _run_both(lm, prompts, specs=[dict(kind="poison_logits", step=2, uid=1)],
                               paged=paged, pipeline_depth=depth)
    assert port == ref
    assert port[1] == ["stop", "error", "stop"]
    assert port[2]["injected"] == {"poison_logits": 1} and port[2]["quarantined"] == 1
    base = _fault_free(lm, prompts, paged=paged, pipeline_depth=depth)
    assert port[0][0] == base[0] and port[0][2] == base[2]
    assert len(port[0][1]) < 12


def test_retry_then_quarantine_matches_reference(lm):
    """max_retries 1: uid 1 is poisoned twice (a retry, then "error" after
    its re-prefill), uid 2 once (a retry that finishes with the fault-free
    stream)."""
    prompts = _prompts(21, 4)
    specs = [dict(kind="poison_logits", step=2, uid=1), dict(kind="poison_logits", step=8, uid=1),
             dict(kind="poison_logits", step=5, uid=2)]
    (ref, port), (_, eng) = _run_both(lm, prompts, specs=specs, pipeline_depth=2,
                                      policy=dict(max_retries=1, retry_backoff_steps=2))
    assert port == ref
    assert port[1] == ["stop", "error", "stop", "stop"]
    assert (port[2]["retried"], port[2]["quarantined"]) == (2, 1)
    assert eng.finished_requests[2].retries == 1
    base = _fault_free(lm, prompts)
    assert [port[0][i] for i in (0, 2, 3)] == [base[i] for i in (0, 2, 3)]


def test_alloc_fail_matches_reference(lm):
    """Failed reservations at admission and growth back off; streams and
    reasons are unchanged."""
    prompts = _prompts(22, 4)
    specs = [dict(kind="alloc_fail", step=s) for s in (0, 2, 4)]
    (ref, port), _ = _run_both(lm, prompts, specs=specs, num_blocks=24)
    assert port == ref
    assert port[0] == _fault_free(lm, prompts, num_blocks=24)
    assert port[2]["injected"] == {"alloc_fail": 3} and set(port[1]) == {"stop"}


def test_swap_corrupt_matches_reference(lm):
    """Two corrupted swap payloads (one untargeted, one matched to a uid)
    fail their CRC and re-prefill; the streams are the fault-free run's."""
    prompts = _prompts(9, 6)
    specs = [dict(kind="swap_corrupt"), dict(kind="swap_corrupt", uid=4)]
    (ref, port), _ = _run_both(lm, prompts, max_new=16, specs=specs, num_blocks=8,
                               sched={"resume": "swap"})
    assert port == ref
    assert port[2]["swap_fallbacks"] == 2 and port[2]["injected"] == {"swap_corrupt": 2}
    assert port[3]["preempt_count"] >= 2
    assert port[0] == _fault_free(lm, prompts, max_new=16, num_blocks=8,
                                  sched_config=torch_sched.SchedulerConfig(resume="swap"))


def test_swap_crc_fallback_at_block_multiple_context(lm):
    """The port checks a swap payload's CRC before reserving, so its
    re-prefill reserves the folded prompt (context + 1 token); the
    reference reserves the 8-token context's one block, and the folded
    token's KV write past it is dropped: its stream for the corrupted
    request leaves the fault-free one and it grows one block more."""
    prompts = _prompts(0, 6)
    kw = dict(max_new=16, specs=[dict(kind="swap_corrupt", uid=1, step=1)], num_blocks=6,
              sched={"resume": "swap"})
    (ref, port), _ = _run_both(lm, prompts, **kw)
    base = _fault_free(lm, prompts, max_new=16, num_blocks=6,
                       sched_config=torch_sched.SchedulerConfig(resume="swap"))
    assert port[0] == base and port[2]["swap_fallbacks"] == ref[2]["swap_fallbacks"] == 1
    assert ref[0][1] != base[1] and [ref[0][i] for i in (0, 2, 3, 4, 5)] == [
        base[i] for i in (0, 2, 3, 4, 5)]
    assert (port[3]["grown_blocks"], ref[3]["grown_blocks"]) == (15, 16)


def test_straggler_flagged_like_reference(lm):
    """The watchdog flags a 0.5 s stall after its 8 clean steps; the streams
    are unchanged."""
    prompts = _prompts(24, 2)
    (ref, port), engs = _run_both(lm, prompts, max_new=16,
                                  specs=[dict(kind="straggler", step=11, delay_s=0.5)])
    assert port == ref and port[0] == _fault_free(lm, prompts, max_new=16)
    assert port[2]["injected"] == {"straggler": 1}
    assert all(e.fault_stats()["straggler_slow"] >= 1 for e in engs)


def test_step_timeout_raises_like_reference(lm):
    """Armed after a warm run, the hard step timeout raises ServingFault
    with a JSON-serialisable snapshot, at the same step on both engines."""
    snaps = []
    for eng in _engines(lm, specs=[dict(kind="straggler", step=20, delay_s=0.6)],
                        policy={}, max_batch=1):
        eng.submit(_prompts(25, 1)[0], max_new_tokens=4)
        eng.run()
        eng._fault_policy = dataclasses.replace(eng._fault_policy, step_timeout_s=0.5)
        eng.submit(_prompts(26, 1)[0], max_new_tokens=32)
        with pytest.raises(Exception) as ei:
            eng.run()
        assert type(ei.value).__name__ == "ServingFault" and ei.value.kind == "step_timeout"
        json.dumps(ei.value.snapshot)
        snaps.append({k: v for k, v in ei.value.snapshot.items() if k != "faults"})
    assert snaps[0] == snaps[1] and snaps[1]["step"] >= 20


def test_fault_stats_reconcile_with_plan_like_reference(lm):
    prompts = _prompts(32, 3)
    specs = [dict(kind="poison_logits", step=2, uid=1), dict(kind="alloc_fail", step=1),
             dict(kind="straggler", step=4, delay_s=0.05)]
    (ref, port), (_, eng) = _run_both(lm, prompts, specs=specs)
    assert port == ref
    fs = eng.fault_stats()
    assert fs["injected"] == eng._faults.counts() == {
        "poison_logits": 1, "alloc_fail": 1, "straggler": 1}
    assert fs["injected_total"] == 3 and eng._faults.outstanding() == []
    assert fs["quarantined"] == 1 and fs["parked"] == 0 and fs["degraded"] == {}
    snap = eng.engine_snapshot()
    json.dumps(snap)
    assert set(snap) == {"step", "ring_depth", "pipeline_depth", "slots", "queued", "parked",
                         "prefilling", "pool_free_blocks", "degraded", "faults"}


# ------------------------------------------- deadlines, cancel, drain and close


def test_deadline_shed_like_reference(lm):
    prompts = _prompts(27, 2)

    def drive(eng, faults):
        uids = [eng.submit(prompts[0], max_new_tokens=8),
                eng.submit(prompts[1], max_new_tokens=8, deadline_s=1e-4),
                eng.submit(prompts[1], max_new_tokens=8, deadline_s=3600)]
        time.sleep(0.01)
        eng.run()
        with pytest.raises(ValueError):
            eng.submit(prompts[0], deadline_s=0.0)
        return uids

    (ref, port), _ = _run_both(lm, prompts, drive=drive, policy={}, max_batch=1)
    assert port == ref
    assert port[1] == ["stop", "deadline", "stop"] and port[0][1] == []
    assert port[2]["shed"] == 1


def test_cancel_queued_prefilling_and_live_like_reference(lm):
    """At depth 2: a queued request, one mid-prefill (a 30-token prompt in
    8-token chunks) and a live row with steps in flight."""
    rng = np.random.default_rng(28)
    prompts = [rng.integers(2, 60, size=n) for n in (6, 30, 5, 7)]

    def drive(eng, faults):
        uids = [eng.submit(p, max_new_tokens=12) for p in prompts]
        log = [eng.cancel(uids[3]), eng.cancel(uids[3]), eng.cancel(999)]
        eng.run(max_steps=1)
        log.append(len(eng._prefilling))
        log.append(eng.cancel(uids[1]))
        eng.run(max_steps=4)
        log.append((len(eng._ring), any(r is not None and r.uid == uids[0]
                                        for r in eng.slots)))
        log.append(eng.cancel(uids[0]))
        eng.run()
        return uids, log

    logs = []

    def logged(eng, faults):
        uids, log = drive(eng, faults)
        logs.append(log)
        return uids

    (ref, port), (_, eng) = _run_both(lm, prompts, drive=logged, max_batch=2,
                                      pipeline_depth=2)
    assert port == ref and logs[0] == logs[1]
    assert logs[1] == [True, False, False, 1, True, (1, True), True]
    assert port[1] == ["cancelled", "cancelled", "stop", "cancelled"]
    assert port[2]["cancelled"] == 3 and port[0][1] == [] and port[0][3] == []
    assert 0 < len(port[0][0]) < 12 and eng.kv.alloc.in_use() == 0


def test_cancel_parked_retry_like_reference(lm):
    """A poisoned request parked for a long backoff is cancelled there."""
    prompts = _prompts(29, 2)

    def drive(eng, faults):
        uids = [eng.submit(p, max_new_tokens=12) for p in prompts]
        while eng.fault_stats()["parked"] == 0:
            eng.run(max_steps=1)
        assert eng.cancel(uids[1])
        eng.run()
        return uids

    (ref, port), _ = _run_both(lm, prompts, drive=drive,
                               specs=[dict(kind="poison_logits", step=1, uid=1)],
                               policy=dict(max_retries=1, retry_backoff_steps=50))
    assert port == ref
    assert port[1] == ["stop", "cancelled"] and port[2]["parked"] == 0
    assert (port[2]["retried"], port[2]["cancelled"]) == (1, 1)


def test_request_drain_and_close_like_reference(lm):
    """Drain after 3 iterations: the live rows finish, the queue sheds as
    "shutdown".  Then close() ends a second engine's live, prefilling and
    queued requests, is idempotent, and submit() raises after it."""
    prompts = _prompts(30, 5)

    def drain(eng, faults):
        uids = [eng.submit(p, max_new_tokens=6) for p in prompts]
        eng.run(max_steps=3)
        eng.request_drain()
        eng.run()
        assert eng.degraded_components() == {"draining": True}
        return uids

    (ref, port), _ = _run_both(lm, prompts, drive=drain, max_batch=2)
    assert port == ref
    assert port[1] == ["stop", "stop", "shutdown", "shutdown", "shutdown"]
    assert port[2]["shed"] == 3

    def close(eng, faults):
        uids = [eng.submit(p, max_new_tokens=6) for p in prompts[:3]]
        uids.append(eng.submit(np.arange(2, 40), max_new_tokens=6))
        eng.run(max_steps=2)
        eng.close()
        eng.close()
        with pytest.raises(RuntimeError, match="closed"):
            eng.submit(prompts[0])
        return uids

    (ref, port), (_, eng) = _run_both(lm, prompts, drive=close)
    assert port == ref
    assert set(port[1]) == {"shutdown"} and port[2]["shed"] == 4
    assert eng.kv.alloc.in_use() == 0 and not eng.active.any()


def test_chip_fault_path_holds_on_cpu():
    """chip_smoke's fault path (phase 4c) on a tiny Mistral-family model on
    the CPU, against its own uninterrupted worst-case run: the predicted
    counts (they depend only on prompt lengths and the plans), finish
    reasons, accounting but the straggler flag, lifecycle results and the
    exact and margin rules."""
    import chip_smoke as cs
    from repro_torch.configs import paper_models as torch_paper
    from repro_torch.models import build_model

    cfg = torch_paper.small_lm(family_of=torch_paper.MISTRAL_7B, name="small-mistral",
                               num_layers=2, d_model=32, d_ff=48, vocab_size=64, num_heads=4)
    model = build_model(cfg)
    params = model.init(0, "cpu")
    rng = np.random.default_rng(0)
    plens = rng.integers(16, 201, size=cs.SCHED_REQUESTS)
    prompts = [rng.integers(2, cfg.vocab_size // 2, size=int(n)) for n in plens]
    eng = ServingEngine(model, params, max_batch=8, max_len=256, block_size=16,
                        prefill_chunk=64, pipeline_depth=1,
                        sched_config=torch_sched.SchedulerConfig(admission="worst_case"))
    uids = [eng.submit(p, max_new_tokens=cs.SCHED_MAX_NEW) for p in prompts]
    eng.run()
    want = [eng.finished_requests[u].generated for u in uids]
    margins = cs.teacher_margins(torch, np, model, params, prompts, want)
    for label in cs.FAULT_SPECS:
        chk = cs.fault_check(label, cs.fault_run(torch, np, model, params, prompts, label),
                             want, margins)
        bad_rows = [x for x in chk["rows"]
                    if not (x["ok"] and x["reason_ok"] and x["length_ok"])]
        # The straggler flag is held on the card: on a busy CPU the tiny
        # model's own slow steps can hide a 0.05 s stall from the watchdog.
        accounting = {k: v for k, v in chk["accounting"].items() if k != "straggler"}
        assert chk["counts_ok"] and chk["lifecycle_ok"] and all(accounting.values()), (
            label, chk["counts"], accounting, chk["lifecycle_ok"])
        assert not bad_rows, (label, bad_rows)
