"""Port parity for the serving-policy slice: the port's scheduler copy makes
the reference scheduler's decisions; the port's engine gives the reference
engine's greedy streams and scheduler counters under on-demand admission,
preemption (re-prefill and swap), priority classes, stalls, row order,
defrag and pipeline depths 1-4, on the paged pools and the RWKV-6 dense
slab; invariants the port holds alone (temperature streams under swap
and depth, the ring's drain discipline, one token copy per step); and
the paged cache's growth, rollback and defrag against the reference's."""

import types

import numpy as np
import pytest
import torch
from torch_parity import tiny_lm, tiny_rwkv

from repro.serving import scheduler as jax_sched
from repro.serving.engine import ServingEngine as JaxEngine
from repro.serving.kvcache import PagedKVCache as JaxPagedKVCache
from repro_torch.serving import engine as engine_mod
from repro_torch.serving import scheduler as torch_sched
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.kvcache import BlockAllocator, PagedKVCache, pool_leaves

COUNTERS = ("preempt_count", "resumes", "grown_blocks", "stalls", "swap_bytes")


# ------------------------------------------------------ the scheduler copy


@pytest.mark.parametrize("kw", [
    None,  # the defaults
    {"admission": "lazy"},
    {"resume": "restart"},
    {"priority_classes": ()},
    {"priority_classes": ("a", "a")},
    {"aging_rounds": -1},
])
def test_scheduler_config_validation(kw):
    """The reference's TestSchedulerConfig cases, on both copies."""
    for mod in (jax_sched, torch_sched):
        assert mod.ADMISSION_POLICIES == ("on_demand", "worst_case")
        assert mod.RESUME_MODES == ("reprefill", "swap")
        if kw is None:
            cfg = mod.SchedulerConfig()
            assert (cfg.admission, cfg.preempt, cfg.resume, cfg.priority_classes,
                    cfg.aging_rounds, cfg.sort_decode_rows) == (
                "on_demand", True, "reprefill", ("default",), 32, True)
        else:
            with pytest.raises(ValueError):
                mod.SchedulerConfig(**kw)


class _Req:
    def __init__(self, uid, class_idx, prefix, max_new, generated):
        self.uid, self.class_idx, self.prefix_len = uid, class_idx, prefix
        self.max_new_tokens, self.generated = max_new, list(generated)


def _drive(mod, seed, classes, aging, admission):
    """A seeded sequence of every scheduler operation; returns the log of
    its decisions."""
    rng = np.random.default_rng(seed)
    s = mod.Scheduler(mod.SchedulerConfig(admission=admission, priority_classes=classes,
                                          aging_rounds=aging))
    alloc = BlockAllocator(16)
    kv = types.SimpleNamespace(alloc=alloc, slot_shard=lambda slot: 0)
    log, popped, uid = [], [], 0
    for _ in range(300):
        op = rng.integers(0, 9)
        if op <= 2:
            cls = [None] + list(classes)
            name = cls[rng.integers(0, len(cls))]
            req = _Req(uid, s.class_index(name), int(rng.integers(1, 40)),
                       int(rng.integers(1, 20)), range(int(rng.integers(0, 5))))
            uid += 1
            s.submit(req)
        elif op == 3 and s:
            popped.append(s.pop_head())
            log.append(("pop", popped[-1].uid))
        elif op == 4 and popped:
            s.requeue(popped.pop(int(rng.integers(0, len(popped)))))
        elif op == 5:
            s.note_blocked()
        elif op == 6:
            grp = s.take_bucket(int(rng.integers(1, 4)), lambda r: r.prefix_len // 16)
            log.append(("bucket", [r.uid for r in grp]))
            popped += grp
        elif op == 7:
            cands = [(int(rng.integers(0, 8)), int(rng.integers(0, 6)),
                      int(rng.integers(0, len(classes)))) for _ in range(rng.integers(0, 5))]
            log.append(("victim", s.pick_victim(cands)))
            if rng.random() < 0.5:
                alloc.alloc(uid + 1000, int(rng.integers(0, 3)))
            log.append(("slots", s.slot_order([5, 1, 3, 0], kv, [7, 2, 9, 4, 0, 1])))
        else:
            lens = rng.integers(0, 50, 8)
            act = rng.random(8) < 0.6
            order = s.row_order(lens, act, 8, 1)
            log.append(("rows", None if order is None else order.tolist()))
        head = s.head()
        log.append(("head", None if head is None else head.uid, len(s),
                     [r.uid for r in s.queued()],
                     None if head is None else s.admit_tokens(head, 64)))
    with pytest.raises(ValueError):
        s.class_index("gold")
    return log


@pytest.mark.parametrize("seed,classes,aging,admission", [
    (0, ("default",), 32, "on_demand"),
    (1, ("interactive", "batch"), 3, "on_demand"),
    (2, ("a", "b", "c"), 2, "worst_case"),
    (3, ("a", "b", "c"), 0, "worst_case"),
])
def test_scheduler_copy_makes_the_reference_decisions(seed, classes, aging, admission):
    assert _drive(torch_sched, seed, classes, aging, admission) == _drive(
        jax_sched, seed, classes, aging, admission)


def test_row_order_disabled_and_sorted():
    for mod in (jax_sched, torch_sched):
        assert mod.Scheduler(mod.SchedulerConfig(sort_decode_rows=False)).row_order(
            np.arange(4), np.ones(4, bool), 4, 1) is None
        order = mod.Scheduler().row_order(np.array([3, 9, 5, 9]),
                                          np.array([True, True, False, True]), 4, 1)
        assert order.tolist() == [1, 3, 0, 2]


# ------------------------------------------- the engine against the reference


def _prompts(seed, n, lo, hi):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, 60, size=int(rng.integers(lo, hi))) for _ in range(n)]


def _run_both(lm, sched_kw, depth, prompts, budgets, engine_kw, drive=None):
    """The same requests through the reference engine and the port's under
    one SchedulerConfig and depth; returns (reference, port), each a pair
    (streams in submit order, scheduler counters), after asserting that
    every request finished.  ``drive(engine, submit)`` replaces
    submit-all-then-run."""
    jmodel, jparams, tmodel, tparams = lm
    out = []
    for cls, model, params, mod in ((JaxEngine, jmodel, jparams, jax_sched),
                                    (ServingEngine, tmodel, tparams, torch_sched)):
        eng = cls(model, params, pipeline_depth=depth,
                  sched_config=mod.SchedulerConfig(**sched_kw), **engine_kw)

        def submit(idx, latency_class=None, eng=eng):
            return [eng.submit(prompts[i], max_new_tokens=budgets[i],
                               latency_class=latency_class) for i in idx]

        if drive is None:
            uids = submit(range(len(prompts)))
            eng.run()
        else:
            uids = drive(eng, submit)
        reqs = [eng.finished_requests[u] for u in uids]
        assert all(r.finish_reason == "stop" for r in reqs)
        st = eng.scheduler_stats()
        out.append(([r.generated for r in reqs], {k: st[k] for k in COUNTERS}))
    return out


LM_KW = dict(max_batch=3, max_len=64, block_size=8, prefill_chunk=8)


@pytest.fixture(scope="module")
def lm():
    return tiny_lm("dense")


@pytest.mark.parametrize("depth,sort", [(1, True), (2, True), (4, True), (2, False)])
def test_on_demand_without_pressure_matches_reference(lm, depth, sort):
    prompts = _prompts(0, 5, 3, 31)
    ref, port = _run_both(lm, {"sort_decode_rows": sort}, depth, prompts, [10] * 5,
                          dict(LM_KW, max_len=48))
    assert port == ref
    assert ref[1]["preempt_count"] == 0 and ref[1]["grown_blocks"] > 0


@pytest.mark.parametrize("resume", ["reprefill", "swap"])
@pytest.mark.parametrize("depth", [1, 3])
def test_tight_pool_preemption_matches_reference(lm, resume, depth):
    """A pool far below the worst case: victims are evicted and resumed by
    re-prefill or swap; the streams, preemptions, resumes, growth and swap
    bytes are the reference's."""
    prompts = _prompts(9, 6, 4, 10)
    ref, port = _run_both(lm, {"resume": resume}, depth, prompts, [16] * 6,
                          dict(LM_KW, num_blocks=8))
    assert port == ref
    assert ref[1]["preempt_count"] > 0 and ref[1]["resumes"] == ref[1]["preempt_count"]
    assert (ref[1]["swap_bytes"] > 0) == (resume == "swap")


def test_priority_class_preempts_lower_like_reference(lm):
    """Two batch-class rows fill the batch; an interactive request arriving
    after 4 iterations evicts one."""
    prompts = _prompts(11, 3, 4, 8)

    def drive(eng, submit):
        uids = submit([0, 1], "batch")
        eng.run(max_steps=4)
        uids += submit([2], "interactive")
        eng.run()
        return uids

    ref, port = _run_both(lm, {"priority_classes": ("interactive", "batch")}, 2, prompts,
                          [12, 12, 6], dict(LM_KW, max_batch=2, num_blocks=16), drive)
    assert port == ref
    assert ref[1]["preempt_count"] >= 1


def test_stall_without_preemption_matches_reference(lm):
    """preempt=False: the long row runs out of blocks, freezes on the
    device, and resumes when the short rows retire."""
    rng = np.random.default_rng(12)
    prompts = [rng.integers(2, 60, size=6) for _ in range(3)]
    ref, port = _run_both(lm, {"preempt": False}, 2, prompts, [10, 10, 20],
                          dict(LM_KW, num_blocks=6))
    assert port == ref
    assert ref[1]["stalls"] > 0 and ref[1]["preempt_count"] == 0


def test_symmetric_deadlock_raises_like_reference(lm):
    jmodel, jparams, tmodel, tparams = lm
    rng = np.random.default_rng(13)
    prompts = [rng.integers(2, 60, size=10) for _ in range(2)]
    for cls, model, params, mod in ((JaxEngine, jmodel, jparams, jax_sched),
                                    (ServingEngine, tmodel, tparams, torch_sched)):
        eng = cls(model, params, max_batch=2, max_len=64, block_size=8, num_blocks=4,
                  sched_config=mod.SchedulerConfig(preempt=False))
        for p in prompts:
            eng.submit(p, max_new_tokens=16)
        with pytest.raises(RuntimeError, match="deadlock"):
            eng.run()


def test_defrag_mid_flight_matches_reference(lm):
    """defrag() at depth 2 with steps in flight (it drains the ring): the
    same blocks move, and the streams and counters are the reference's."""
    prompts = _prompts(5, 6, 4, 20)
    moved = []

    def drive(eng, submit):
        uids = submit(range(6))
        for _ in range(6):
            eng.run(max_steps=5)
            moved.append(eng.defrag())
        eng.run()
        return uids

    ref, port = _run_both(lm, {}, 2, prompts, [6, 20, 10, 16, 8, 12],
                          dict(LM_KW, num_blocks=12), drive)
    assert port == ref
    assert moved[:6] == moved[6:] and sum(moved) > 0


@pytest.mark.parametrize("depth", [1, 3])
def test_rwkv_dense_slab_ring_matches_reference(depth):
    """RWKV-6 on the dense slab behind the ring (exact-length admission,
    drained before each admission), 3 slots for 5 requests."""
    prompts = [np.random.default_rng(0).integers(2, 200, size=n) for n in (3, 17, 9, 30, 12)]
    ref, port = _run_both(tiny_rwkv("dense"), {}, depth, prompts, [8] * 5,
                          dict(max_batch=3, max_len=48))
    assert port == ref


def test_engine_defaults_and_refusals(lm, monkeypatch):
    _, _, tmodel, tparams = lm
    eng = ServingEngine(tmodel, tparams, max_batch=1, max_len=32)
    assert eng.pipeline_depth == 2 and eng.sched.cfg == torch_sched.SchedulerConfig()
    monkeypatch.setenv("REPRO_SERVING_PIPELINE_DEPTH", "3")
    assert ServingEngine(tmodel, tparams, max_batch=1, max_len=32).pipeline_depth == 3
    with pytest.raises(ValueError, match="pipeline_depth"):
        ServingEngine(tmodel, tparams, max_batch=1, max_len=32, pipeline_depth=0)
    with pytest.raises(ValueError, match="unknown latency class"):
        eng.submit(np.array([3, 4, 5]), max_new_tokens=2, latency_class="gold")


# ------------------------------------------------------- port-only invariants


def _port_streams(lm, n_req=5, temperature=1.0, **kw):
    _, _, tmodel, tparams = lm
    eng = ServingEngine(tmodel, tparams, seed=5, **dict(LM_KW, **kw))
    ids = [eng.submit(p, max_new_tokens=16, temperature=temperature)
           for p in _prompts(10, n_req, 4, 10)]
    eng.run()
    return [eng.finished_requests[u].generated for u in ids], eng


def test_swap_resume_keeps_temperature_streams(lm):
    """Swap resume restores the blocks and the key chain, so a sampled
    stream equals the same request's stream without preemption."""
    base, eng = _port_streams(lm, num_blocks=24)
    assert eng.scheduler_stats()["preempt_count"] == 0
    press, eng = _port_streams(lm, num_blocks=8,
                               sched_config=torch_sched.SchedulerConfig(resume="swap"))
    st = eng.scheduler_stats()
    assert st["preempt_count"] > 0 and st["swap_bytes"] > 0 and st["swap_fallbacks"] == 0
    assert press == base


def test_temperature_streams_identical_across_depths(lm):
    """Depths 1-4 with slot reuse (2 slots, 5 requests) give the same
    sampled streams."""
    streams = [_port_streams(lm, max_batch=2, pipeline_depth=d)[0] for d in (1, 2, 3, 4)]
    assert all(s == streams[0] for s in streams)


def test_swap_crc_mismatch_falls_back_to_reprefill(lm, monkeypatch):
    """A corrupted swap payload is never scattered: the request re-prefills
    its committed prefix (greedy: the same stream) and the fallback counts."""
    base, _ = _port_streams(lm, temperature=0.0, num_blocks=24)
    real = engine_mod._swap_checksum
    calls = []

    def flaky(blocks):
        calls.append(1)
        return real(blocks) ^ (len(calls) == 2)  # the first resume's check fails

    monkeypatch.setattr(engine_mod, "_swap_checksum", flaky)
    got, eng = _port_streams(lm, temperature=0.0, num_blocks=8,
                             sched_config=torch_sched.SchedulerConfig(resume="swap"))
    assert eng.scheduler_stats()["swap_fallbacks"] == 1
    assert got == base


@pytest.mark.parametrize("depth", [1, 3])
def test_eos_flush_emits_each_token_once(lm, depth):
    """Rows finishing on an eos inside the ring: every stream is its solo
    stream cut at the first eos, each token emitted exactly once."""
    _, _, tmodel, tparams = lm
    prompts = _prompts(14, 5, 4, 12)
    full = []
    for p in prompts:
        eng = ServingEngine(tmodel, tparams, max_batch=1, max_len=64, pipeline_depth=1)
        uid = eng.submit(p, max_new_tokens=12)
        full.append(eng.run()[uid])
    eos = max(set(t for f in full for t in f[1:]), key=lambda t: sum(t in f for f in full))
    eng = ServingEngine(tmodel, tparams, pipeline_depth=depth, **dict(LM_KW, max_batch=2))
    ids = [eng.submit(p, max_new_tokens=12, eos_id=eos) for p in prompts]
    out = {}
    while len(out) < len(ids):
        out.update(eng.run())
    want = [f[:f.index(eos) + 1] if eos in f else f for f in full]
    assert [out[u] for u in ids] == want
    assert sum(eos in f for f in full) >= 2


def test_admission_and_defrag_drain_the_ring(lm, monkeypatch):
    """Admission and defrag run only on an empty ring; growth may run with
    steps in flight."""
    _, _, tmodel, tparams = lm
    eng = ServingEngine(tmodel, tparams, pipeline_depth=3, **dict(LM_KW, num_blocks=10))
    seen = {"admit": [], "defrag": []}
    admit, defrag = eng._admit_paged, eng.kv.defrag
    monkeypatch.setattr(eng, "_admit_paged",
                        lambda: seen["admit"].append(len(eng._ring)) or admit())
    monkeypatch.setattr(eng.kv, "defrag",
                        lambda: seen["defrag"].append(len(eng._ring)) or defrag())
    for p in _prompts(3, 6, 4, 20):
        eng.submit(p, max_new_tokens=14)
    for _ in range(40):
        eng.run(max_steps=3)
        eng.step() if eng.active.any() else None
        eng.defrag()
    eng.run()
    assert len(eng.finished_requests) == 6
    assert seen["admit"] and set(seen["admit"]) == {0}
    assert seen["defrag"] and set(seen["defrag"]) == {0}


def test_one_token_copy_per_consumed_step(lm, monkeypatch):
    """Each dispatched step copies its token vector once, and each is
    consumed once: copies == consumed steps == decode syncs; host syncs
    add one per finishing prefill chunk."""
    copies = []
    real = engine_mod._to_host
    monkeypatch.setattr(engine_mod, "_to_host", lambda t: copies.append(1) or real(t))
    _, eng = _port_streams(lm, temperature=0.0, pipeline_depth=3, num_blocks=10)
    st = eng.stats()
    assert st["steps"] > 0 and len(copies) == st["steps"] == st["decode_syncs"]
    assert st["swap_syncs"] == 0 and st["host_syncs"] <= st["steps"] + st["prefill_ticks"]
    assert not eng._ring and eng.kv.alloc.in_use() == 0


# -------------------------------------------------- the paged cache's ops


def test_paged_cache_ops_match_reference_and_defrag_keeps_pages(lm):
    """The same reserve / extend / rollback / free / defrag sequence leaves
    the reference's block table; defrag leaves every live row's gathered
    pages bit-identical."""
    jmodel, _, tmodel, _ = lm
    ref = JaxPagedKVCache(jmodel, 4, 64, block_size=8, num_blocks=20)
    port = PagedKVCache(tmodel, 4, 64, block_size=8, num_blocks=20, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for _, _, leaf in pool_leaves(port.pools):
        leaf.copy_(torch.randn(leaf.shape, generator=gen))
    ops = [("reserve", 0, 20), ("reserve", 1, 9), ("reserve", 2, 30), ("extend", 1, 30),
           ("free", 0), ("reserve", 3, 12), ("extend", 2, 50), ("rollback", 2, 17),
           ("extend", 3, 40), ("rollback", 1, 0), ("reserve", 0, 8), ("extend", 0, 64),
           ("free", 3)]
    for op, *args in ops:
        assert getattr(ref, op)(*args) == getattr(port, op)(*args), op
        np.testing.assert_array_equal(ref.table_np, port.table_np)
    assert ref.can_reserve(40) == port.can_reserve(40)
    table = port.table_np.copy()

    def pages():
        return [leaf.index_select(ax, torch.as_tensor(row[row >= 0], dtype=torch.long))
                for row in port.table_np for _, ax, leaf in pool_leaves(port.pools)]

    before = pages()
    moves = port.defrag()
    assert moves == ref.defrag() and moves
    np.testing.assert_array_equal(ref.table_np, port.table_np)
    assert not np.array_equal(table, port.table_np)
    assert all(torch.equal(a, b) for a, b in zip(before, pages()))
    assert port.stats()["blocks_in_use"] == ref.stats()["blocks_in_use"]
