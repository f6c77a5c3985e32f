"""Port parity for self-speculative decoding: ``verify_tail`` against the
reference's (greedy rows bit for bit; temperature rows by the target
distribution, TV < 0.03), the draft and verify roots against the
reference's, ``output="hidden"`` and ``build_draft_params``, and the
engine's spec path against the reference engine: greedy streams on both
cache layouts across block and chunk boundaries and under mid-flight
admission, ``spec_stats()``, dynamic windows, EOS inside a committed chunk,
the one device-to-host copy a step, lockstep draft reservation under
growth and preemption, the refusals, and the ``draft_kill`` and spec
poison faults under the same ``FaultPlan``.  The draft of the engine tests
is the target's weights plus small seeded noise (the reference's own
tests' stand-in for a higher-ratio twin), which rejects and accepts at
the tiny width; an NSVD draft at ratio 0.6 accepts almost nothing there."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import t2np, to_t, tiny_lm

from repro.calib.runner import collect_grams as jax_collect_grams
from repro.core import GramStore as JaxGramStore
from repro.core.lowrank import dense_equivalent as jax_dense_equivalent
from repro.launch import steps as jax_steps
from repro.models.api import build_draft_params as jax_build_draft_params
from repro.serving import faults as jax_faults
from repro.serving import scheduler as jax_sched
from repro.serving.engine import ServingEngine as JaxEngine
from repro.serving.spec import SpecConfig as JaxSpecConfig
from repro.serving.spec import verify_tail as jax_verify_tail
from repro_torch.configs import get_config
from repro_torch.core import GramStore, dense_equivalent
from repro_torch.launch import steps as torch_steps
from repro_torch.models import build_model
from repro_torch.models.api import build_draft_params
from repro_torch.serving import faults as torch_faults
from repro_torch.serving import scheduler as torch_sched
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.spec import SpecConfig, verify_tail

K = 3
Q_TOL = 1e-4  # fp32 draft probs: the logits agree to 1e-4 (test_torch_model.py)
HIDDEN_TOL = 1e-4
SPEC_KEYS = ("k", "dynamic_k", "proposed", "accepted", "committed", "acceptance_rate",
             "committed_per_row_step")
PACKAGES = ((JaxEngine, JaxSpecConfig, jax_faults, jax_sched),
            (ServingEngine, SpecConfig, torch_faults, torch_sched))


@functools.lru_cache(maxsize=None)
def _spec_lm():
    """(reference model, params, draft, port model, params, draft): the
    tiny fp32 LLaMA and a draft of its weights plus N(0, 0.002) noise."""
    jmodel, jparams, tmodel, tparams = tiny_lm("dense")
    rng = np.random.default_rng(99)
    jdraft = jax.tree.map(lambda x: jnp.asarray(
        np.asarray(x) + 0.002 * rng.standard_normal(np.shape(x)).astype(np.float32)
        if np.ndim(x) >= 2 else np.asarray(x)), jparams)
    return jmodel, jparams, jdraft, tmodel, tparams, to_t(jdraft)


@pytest.fixture(scope="module")
def lm():
    return _spec_lm()


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, 60, size=n) for n in lens]


def _serve(eng, prompts, max_new, **submit):
    ids = [eng.submit(p, max_new_tokens=n, **submit)
           for p, n in zip(prompts, max_new if isinstance(max_new, list)
                           else [max_new] * len(prompts))]
    eng.run()
    return [eng.finished_requests[u].generated for u in ids]


def _pair(lm, k=K, dynamic_k=False, draft=True, specs=None, policy=None, sched=None,
          **kw):
    """(reference engine, port engine) with the same spec config (``draft``
    False: plain engines; "target": the draft is the target), plan, policy
    and scheduler config."""
    jmodel, jparams, jdraft, tmodel, tparams, tdraft = lm
    out = []
    for (cls, spec_cls, faults, sched_mod), model, params, dparams in zip(
            PACKAGES, (jmodel, tmodel), (jparams, tparams), (jdraft, tdraft)):
        spec = None
        if draft:
            spec = spec_cls(draft_params=params if draft == "target" else dparams, k=k,
                            dynamic_k=dynamic_k)
        plan = (None if specs is None
                else faults.FaultPlan([faults.FaultSpec(**s) for s in specs]))
        pol = None if policy is None else faults.FaultPolicy(**policy)
        out.append(cls(model, params, spec_config=spec, faults=plan, fault_policy=pol,
                       sched_config=sched_mod.SchedulerConfig(**(sched or {})), **kw))
    return out


def _spec_stats(eng):
    ss = eng.spec_stats()
    return {k: ss[k] for k in SPEC_KEYS}


# ------------------------------------------------------------ verify_tail


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_verify_tail_greedy_rows_bit_equal_reference(seed):
    """Greedy rows: the same accepted counts, correction tokens and
    committed-token matrices as the reference's, bit for bit, beside
    temperature rows (rows are independent), with windows 1..K and every
    prefix length from 0 to K accepted."""
    rng = np.random.default_rng(seed)
    b, kk, v = 10, 4, 24
    logits = rng.standard_normal((b, kk + 1, v)).astype(np.float32) * 3
    greedy = np.argmax(logits, -1)
    proposals = rng.integers(0, v, (b, kk)).astype(np.int32)
    for r in range(b):  # row r agrees with the argmax path on its first r % 5
        n = r % (kk + 1)
        proposals[r, :n] = greedy[r, :n]
    q = rng.random((b, kk, v)).astype(np.float32)
    q /= q.sum(-1, keepdims=True)
    temps = np.where(np.arange(b) % 3 == 2, 0.8, 0.0).astype(np.float32)
    k_row = (np.arange(b) % kk + 1).astype(np.int32)
    k_row[:5] = kk
    jkd = jax.random.key_data(jax.random.split(jax.random.key(seed), b))
    _, jm, jt, jout = jax_verify_tail(jkd, jnp.asarray(logits), jnp.asarray(q),
                                      jnp.asarray(proposals), jnp.asarray(temps),
                                      jnp.asarray(k_row))
    kd = torch_steps.request_keys(seed, range(b), "cpu")
    kd2, m, t, out = verify_tail(kd, torch.as_tensor(logits), torch.as_tensor(q),
                                 torch.as_tensor(proposals), torch.as_tensor(temps),
                                 torch.as_tensor(k_row))
    g = temps <= 0
    assert m.dtype == t.dtype == out.dtype == torch.int32
    np.testing.assert_array_equal(m.numpy()[g], np.asarray(jm)[g])
    np.testing.assert_array_equal(t.numpy()[g], np.asarray(jt)[g])
    np.testing.assert_array_equal(out.numpy()[g], np.asarray(jout)[g])
    assert sorted(set(m.numpy()[g].tolist())) == list(range(kk + 1))
    # Two counter draws a call, for every row.
    np.testing.assert_array_equal(kd2.numpy(), kd.numpy() + [0, 2])


@pytest.mark.parametrize("k_row", [1, 2])
def test_verify_tail_temperature_holds_target_distribution(k_row):
    """The Leviathan guarantee, statistically: over 20000 independent rows
    (one request key each) whose proposals come from a different draft
    distribution, the first committed token is distributed as the target's
    P0 (TV < 0.03), with a full window of 1 (the bonus draw from P_m) and
    of 2 (rejections resample from the residual)."""
    v, kk, n, temp = 8, 2, 20000, 1.3
    rng = np.random.default_rng(0)
    t_logits = (rng.standard_normal((kk + 1, v)) * 1.5).astype(np.float32)
    q_logits = rng.standard_normal((kk, v)) * 1.5
    q = np.exp(q_logits / temp)
    q /= q.sum(-1, keepdims=True)
    props = np.stack([rng.choice(v, size=n, p=q[i]) for i in range(kk)], 1).astype(np.int32)
    _, _, _, out = verify_tail(
        torch_steps.request_keys(42, range(n), "cpu"),
        torch.as_tensor(np.broadcast_to(t_logits, (n, kk + 1, v)).copy()),
        torch.as_tensor(np.broadcast_to(q.astype(np.float32), (n, kk, v)).copy()),
        torch.as_tensor(props), torch.full((n,), temp), torch.full((n,), k_row))
    emp = np.bincount(out[:, 0].numpy(), minlength=v) / n
    p0 = np.exp(t_logits[0] / temp)
    p0 /= p0.sum()
    tv = 0.5 * np.abs(emp - p0).sum()
    assert tv < 0.03, tv


# ------------------------------------------------------------------ roots


def _admitted(lm, lens, **kw):
    """Both spec engines with ``lens``-long prompts prefilled and live."""
    ref, eng = _pair(lm, max_batch=len(lens), max_len=64, block_size=8, prefill_chunk=8,
                     **kw)
    for e in (ref, eng):
        for p in _prompts(5, lens):
            e.submit(p, max_new_tokens=12)
        while e._prefilling or e.sched:
            e._admit()
        assert e.active.all()
    return ref, eng


def test_draft_and_verify_roots_match_reference(lm):
    """The draft root (k+1 decodes): the same greedy proposals, draft probs
    within Q_TOL (a temperature row's first), a host-masked row's key
    frozen.  The verify root on the reference's proposals, with a finishing
    eos, a small budget, a host-masked row, a poisoned row and the max_len
    bound: the same pack, lengths, budgets, active flags and last tokens."""
    jmodel, _, jdraft, tmodel, _, tdraft = lm
    lens = (20, 5, 9, 7, 12)
    ref, eng = _admitted(lm, lens)
    b = len(lens)
    temps = np.zeros(b, np.float32)
    temps[2] = 0.7
    keep = np.ones(b, bool)
    keep[3] = False
    jd = jax.jit(jax_steps.make_spec_draft_step(jmodel, K))(
        jdraft, ref.draft.pools, ref.draft.table_device(), ref.last_token, ref.cache_len,
        ref.draft.key_data, ref._active_dev, jnp.asarray(keep), jnp.asarray(temps))
    kd_in = eng.draft.key_data.clone()
    tprop, tq, tkd = torch_steps.make_spec_draft_step(tmodel, K)(
        tdraft, eng.draft.pools, eng.draft.table_device(), eng.last_token, eng.cache_len,
        kd_in, eng.active_dev, torch.as_tensor(keep), torch.as_tensor(temps))
    jprop, jq = np.array(jd[0]), np.array(jd[1])
    g = (temps <= 0) & keep
    assert tprop.shape == (b, K) and tq.shape == (b, K, 64) and tq.dtype == torch.float32
    np.testing.assert_array_equal(tprop.numpy()[g], jprop[g])
    np.testing.assert_allclose(tq.numpy()[g], jq[g], atol=Q_TOL)
    np.testing.assert_allclose(tq.numpy()[2, 0], jq[2, 0], atol=Q_TOL)
    assert torch.equal(tkd[3], kd_in[3]) and not torch.equal(tkd[0], kd_in[0])

    prop = np.where(g[:, None], jprop, 5).astype(np.int32)  # fixed proposals elsewhere
    budget = np.full(b, 9, np.int32)
    budget[2] = 1
    k_row = np.full(b, K, np.int32)
    k_row[2] = 2
    poison = np.zeros(b, np.float32)
    poison[4] = np.nan
    max_len = int(np.asarray(ref.cache_len)[0]) + 2  # row 0 reaches the bound
    temps[:] = 0.0

    jverify = jax.jit(jax_steps.make_spec_verify_step(jmodel, K, max_len))

    def verify(eos):
        jv = jverify(
            ref.params, ref.kv.pools, ref.kv.table_device(), ref.last_token,
            jnp.asarray(prop), jnp.asarray(jq), ref.cache_len, jnp.asarray(budget),
            ref.key_data, ref._active_dev, jnp.asarray(keep), jnp.asarray(temps),
            jnp.asarray(eos), jnp.asarray(k_row), jnp.asarray(poison))
        tv = torch_steps.make_spec_verify_step(tmodel, K, max_len)(
            eng.params, eng.kv.pools, eng.kv.table_device(), eng.last_token,
            torch.as_tensor(prop), torch.as_tensor(jq), eng.cache_len,
            torch.as_tensor(budget), eng.key_data, eng.active_dev, torch.as_tensor(keep),
            torch.as_tensor(temps), torch.as_tensor(eos), torch.as_tensor(k_row),
            torch.as_tensor(poison))
        return [np.asarray(x) for x in jv], [x.numpy() for x in tv]

    eos = np.full(b, -1, np.int32)
    _, (pack, *_) = verify(eos)
    eos[1] = pack[1, 0]  # row 1's first committed token ends it
    (jpack, _, jlen, jlast, jbud, _, jact), (tpack, tlen, tlast, tbud, _, tact) = verify(eos)
    live = keep.copy()
    np.testing.assert_array_equal(tpack[live], jpack[live])
    np.testing.assert_array_equal(tpack[:, K + 1:], jpack[:, K + 1:])
    for got, want in ((tlen, jlen), (tlast, jlast), (tbud, jbud), (tact, jact)):
        np.testing.assert_array_equal(got, want)
    assert tpack[4, K + 1] == -1 and tpack[1, K + 1] == 1 and not tact[[0, 1, 2, 4]].any()
    assert tact[3] and tpack[3, K + 1] == 0  # host-masked: frozen


def test_hidden_output_and_build_draft_params_match_reference(lm, tmp_path):
    """``output="hidden"`` is the final-norm hidden state (B, S, d_model);
    ``build_draft_params`` plans and factors as the reference's at the
    model's dtype (fp32 here), dense equivalents within 1e-5."""
    jmodel, jparams, _, tmodel, tparams, _ = lm
    toks = np.random.default_rng(3).integers(0, 64, (4, 32)).astype(np.int32)
    jh, _, _ = jmodel.apply(jparams, jnp.asarray(toks), mode="train", output="hidden")
    th = tmodel.apply(tparams, torch.as_tensor(toks), mode="train", output="hidden")
    assert th.shape == (4, 32, tmodel.cfg.d_model)
    np.testing.assert_allclose(t2np(th), np.asarray(jh), atol=HIDDEN_TOL * np.abs(jh).max())
    with pytest.raises(ValueError, match="output"):
        tmodel.apply(tparams, torch.as_tensor(toks), output="probs")
    grams = jax_collect_grams(jmodel, jparams, [{"tokens": jnp.asarray(toks)}])
    path = str(tmp_path / "grams.npz")
    grams.save(path)
    want = jax_build_draft_params(jmodel, jparams, JaxGramStore.load(path), 0.6)
    got = build_draft_params(tmodel, tparams, GramStore.load(path, device="cpu"), 0.6)
    with pytest.raises(ValueError, match="ratio"):
        build_draft_params(tmodel, tparams, None, 1.0)
    for i in range(tmodel.cfg.num_layers):
        for sub in ("attn", "mlp"):
            for name, w in want["g0"]["sub0"][sub].items():
                if not (isinstance(w, dict) and "u" in w):
                    continue
                g = got["g0"]["sub0"][sub][name]
                assert g["u"].dtype == torch.float32 and g["u"].shape == w["u"].shape
                jd = np.asarray(jax_dense_equivalent({k: v[i] for k, v in w.items()}))
                td = t2np(dense_equivalent({k: v[i] for k, v in g.items()}))
                assert np.linalg.norm(td - jd) / np.linalg.norm(jd) < 1e-5, (i, sub, name)


# --------------------------------------------------------------- streams


@pytest.mark.parametrize("paged", [True, False])
def test_greedy_spec_streams_across_block_and_chunk_boundaries(lm, paged):
    """Prompt lengths around the block (16) and prefill-chunk (16)
    boundaries, one request at a time: the port's spec streams equal the
    reference engine's and the port's plain streams, with the reference's
    spec_stats."""
    prompts = _prompts(1, (1, 15, 16, 17, 31, 33))
    kw = dict(max_batch=1, max_len=64, paged=paged, prefill_chunk=16)
    ref, eng = _pair(lm, **kw)
    want, got = _serve(ref, prompts, 8), _serve(eng, prompts, 8)
    plain = _serve(_pair(lm, draft=False, **kw)[1], prompts, 8)
    assert got == want == plain
    assert _spec_stats(eng) == _spec_stats(ref)
    assert 0 < eng.spec_stats()["acceptance_rate"] < 1


@pytest.mark.parametrize("paged, dynamic_k", [(True, False), (False, True)])
def test_mid_flight_admission_and_dynamic_k_match_reference(lm, paged, dynamic_k):
    """Continuous batching with staggered finishes (2 slots, 4 requests):
    the spec streams equal the reference engine's and the port's plain
    ones, spec_stats equal the reference's, the windows stay in [1, k]
    and the caches' blocks come back."""
    prompts = _prompts(2, (6, 18, 7, 5))
    lens = [9, 3, 6, 4]
    kw = dict(max_batch=2, max_len=64, paged=paged)
    ref, eng = _pair(lm, k=4, dynamic_k=dynamic_k, **kw)
    want, got = _serve(ref, prompts, lens), _serve(eng, prompts, lens)
    plain = _serve(_pair(lm, draft=False, **kw)[1], prompts, lens)
    assert got == want == plain
    assert _spec_stats(eng) == _spec_stats(ref)
    assert (eng._k_row >= 1).all() and (eng._k_row <= 4).all()
    if paged:
        assert eng.kv.alloc.in_use() == eng.draft.kv.alloc.in_use() == 0


def test_perfect_draft_accepts_everything(lm):
    """Draft == target: every proposal is accepted, so each step commits
    k+1 tokens (the budget allowing) and the stream is the plain one."""
    prompts = _prompts(3, (6,))
    kw = dict(max_batch=1, max_len=64)
    _, eng = _pair(lm, draft="target", **kw)
    assert _serve(eng, prompts, 9) == _serve(_pair(lm, draft=False, **kw)[1], prompts, 9)
    ss = eng.spec_stats()
    assert ss["acceptance_rate"] == 1.0 and ss["committed_per_row_step"] == K + 1
    req = next(iter(eng.finished_requests.values()))
    assert req.spec_proposed == req.spec_accepted == 2 * K
    assert ss["committed"] == len(req.generated) - 1  # all but the prefill's token


@pytest.mark.parametrize("paged", [True, False])
def test_eos_inside_a_committed_chunk(lm, paged):
    """An eos in a step's committed prefix ends the stream at (and with)
    its first occurrence, as plain decoding does."""
    prompts = _prompts(5, (7,))
    kw = dict(max_batch=1, max_len=64, paged=paged)
    full = _serve(_pair(lm, draft=False, **kw)[1], prompts, 8)[0]
    eos = full[2]
    _, eng = _pair(lm, draft="target", eos_id=eos, **kw)  # k+1 tokens a step
    assert _serve(eng, prompts, 8) == [full[:full.index(eos) + 1]]
    assert eng.finished_requests[0].finish_reason == "stop"


def test_temperature_spec_streams_reproducible_and_in_vocab(lm):
    """Temperature rows: a stream depends only on (seed, uid, prompt): the
    same engine twice, and the same request alone in a bigger batch."""
    prompts = _prompts(4, (6, 6, 6))

    def once(max_batch):
        _, eng = _pair(lm, max_batch=max_batch, max_len=64, seed=9)
        return _serve(eng, prompts, 6, temperature=0.7)

    a = once(2)
    assert a == once(2) == once(3)
    assert all(0 <= t < 64 for s in a for t in s)


# ------------------------------------------------------ engine contracts


@pytest.mark.parametrize("depth", [1, 2])
def test_one_device_to_host_copy_a_step(lm, depth, monkeypatch):
    """A spec step is two root calls but ONE packed copy to the host and
    one sync, taken when the ring is full (depth 2: the first step only
    dispatches)."""
    from repro_torch.serving import engine as engine_mod

    _, eng = _pair(lm, max_batch=2, max_len=64, pipeline_depth=depth)
    for p in _prompts(8, (6, 6)):
        eng.submit(p, max_new_tokens=12)
    eng._admit()
    copies = []
    real = engine_mod._to_host
    monkeypatch.setattr(engine_mod, "_to_host",
                        lambda t: copies.append(tuple(t.shape)) or real(t))
    per_step = []
    for _ in range(3):
        before = eng.decode_syncs
        eng.step()
        per_step.append(eng.decode_syncs - before)
    assert copies == [(2, K + 3)] * 3
    assert per_step == ([1, 1, 1] if depth == 1 else [0, 1, 1])
    eng.drain()
    assert eng.host_syncs - eng.decode_syncs == 1  # the prefill's first tokens


def test_lockstep_draft_reservation_under_growth_and_preemption(lm):
    """On demand on a small pool: the draft pool is reserved, grown,
    rolled back at preemption and freed in lockstep with the target's
    (equal blocks per slot after every step), the growth lookahead covers
    k+1, and streams, preemptions, resumes and grown blocks (both pools)
    equal the reference engine's."""
    prompts = _prompts(6, (12, 20, 9, 14))
    kw = dict(max_batch=3, max_len=64, block_size=8, prefill_chunk=8, num_blocks=9)
    ref, eng = _pair(lm, **kw)
    want = _serve(ref, prompts, 20)
    ids = [eng.submit(p, max_new_tokens=20) for p in prompts]
    eng._admit()
    assert eng.draft.kv.alloc.in_use() == eng.kv.alloc.in_use() > 0
    while eng.sched or eng._prefilling or eng.active.any():
        eng.run(max_steps=1)
        for s in range(eng.max_batch):
            assert (len(eng.draft.kv.alloc.owned_by(s)) == len(eng.kv.alloc.owned_by(s)))
            assert (eng.draft.kv.table_np[s] >= 0).sum() == (eng.kv.table_np[s] >= 0).sum()
            # Every dispatched write (k+1 a step) was covered.
            assert len(eng.kv.alloc.owned_by(s)) * 8 >= min(eng._dev_len[s], 64)
    eng.drain()
    assert [eng.finished_requests[u].generated for u in ids] == want
    st, rst = eng.scheduler_stats(), ref.scheduler_stats()
    assert st["preempt_count"] > 0
    for key in ("preempt_count", "resumes", "grown_blocks", "stalls"):
        assert st[key] == rst[key], key
    assert eng.kv.alloc.in_use() == eng.draft.kv.alloc.in_use() == 0
    assert (eng.draft.kv.table_np == -1).all()
    assert eng.defrag() == 0 and eng.cache_stats()["draft_hbm_bytes"] > 0


def test_refusals(lm):
    """Spec is refused on a recurrent (RWKV-6) and a MoE layout, with swap
    resume, and for k < 1, as the reference refuses them."""
    _, _, _, tmodel, tparams, _ = lm
    for arch in ("rwkv6-1.6b", "moonshot-v1-16b-a3b"):
        model = build_model(get_config(arch).reduced())
        params = model.init(0, "cpu")
        with pytest.raises(ValueError, match="speculative"):
            ServingEngine(model, params, max_batch=1, max_len=32,
                          spec_config=SpecConfig(params))
    with pytest.raises(ValueError, match="swap"):
        ServingEngine(tmodel, tparams, max_batch=1, max_len=32, spec_config=SpecConfig(tparams),
                      sched_config=torch_sched.SchedulerConfig(resume="swap"))
    with pytest.raises(ValueError, match="k must be"):
        SpecConfig(tparams, k=0)


# ----------------------------------------------------------------- faults


def test_draft_kill_degrades_and_reenables_like_reference(lm):
    """A killed draft dispatch decodes plainly for the cool-down's steps
    (``degraded_components()["draft"]`` meanwhile), then speculates again:
    the streams are unchanged, and the draft counters, fired plan, spec
    stats and degraded view equal the reference engine's at every step."""
    prompts = _prompts(30, (7, 5))
    kw = dict(max_batch=3, max_len=64)
    base = _serve(_pair(lm, **kw)[1], prompts, 16)
    ref, eng = _pair(lm, specs=[dict(kind="draft_kill", step=2)],
                     policy=dict(draft_cooldown_steps=3), **kw)
    seen = []
    for e in (ref, eng):
        ids = [e.submit(p, max_new_tokens=16) for p in prompts]
        view = []
        while e.sched or e._prefilling or e.active.any():
            e.run(max_steps=1)
            view.append(e.degraded_components().get("draft"))
        e.drain()
        seen.append(([e.finished_requests[u].generated for u in ids], view,
                     {k: v for k, v in e.fault_stats().items()
                      if k not in ("straggler_slow", "straggler_trips")},
                     _spec_stats(e)))
    assert seen[1] == seen[0]
    got, view, fs, _ = seen[1]
    assert got == base and fs["draft_kills"] == fs["draft_reenables"] == 1
    assert {"off_until_step": 5} in view and view[-1] is None
    assert not eng.degraded_components()


def test_draft_failure_on_cpu_degrades_like_reference(lm):
    """A draft root that raises on the CPU (not an injected kill) degrades
    to plain decode for the cool-down's steps as the reference's does: the
    same streams, draft counters and spec stats."""
    prompts = _prompts(32, (6, 9))
    kw = dict(max_batch=3, max_len=64)
    engines = _pair(lm, policy=dict(draft_cooldown_steps=2), **kw)
    for e in engines:
        root, calls = e._spec_draft, [0]

        def failing(*args, root=root, calls=calls):
            calls[0] += 1
            if calls[0] == 2:
                raise RuntimeError("draft root failed")
            return root(*args)

        e._spec_draft = failing
    want, got = (_serve(e, prompts, 14) for e in engines)
    ref, eng = engines
    assert got == want == _serve(_pair(lm, draft=False, **kw)[1], prompts, 14)
    assert eng.fault_stats()["draft_kills"] == ref.fault_stats()["draft_kills"] == 1
    assert eng.fault_stats()["draft_reenables"] == ref.fault_stats()["draft_reenables"]
    assert _spec_stats(eng) == _spec_stats(ref)


def test_spec_poison_quarantines_and_retries_like_reference(lm):
    """A NaN in one row's verify logits reports n_commit == -1: the row
    retires at once (its budget uncharged), re-prefills once and finishes;
    a second poisoning ends it with "error".  Healthy rows keep their
    streams; every stream, reason and counter equals the reference's."""
    prompts = _prompts(31, (5, 8, 6))
    kw = dict(max_batch=3, max_len=64)
    base = _serve(_pair(lm, **kw)[1], prompts, 12)
    for specs, reason in (([dict(kind="poison_logits", step=2, uid=0)], "stop"),
                          ([dict(kind="poison_logits", step=2, uid=0),
                            dict(kind="poison_logits", step=7, uid=0)], "error")):
        ref, eng = _pair(lm, specs=specs, policy=dict(max_retries=1), **kw)
        want, got = _serve(ref, prompts, 12), _serve(eng, prompts, 12)
        assert got == want and got[1:] == base[1:]
        assert eng.finished_requests[0].finish_reason == reason
        assert [r.finish_reason for r in eng.finished_requests.values()] == [
            r.finish_reason for r in ref.finished_requests.values()]
        fs, rfs = eng.fault_stats(), ref.fault_stats()
        for key in ("retried", "quarantined", "injected", "draft_kills"):
            assert fs[key] == rfs[key], key
        assert fs["retried"] == 1 and fs["quarantined"] == (reason == "error")
        assert _spec_stats(eng) == _spec_stats(ref)


def test_chip_spec_path_holds_on_cpu():
    """chip_smoke's spec_serve path (phase 4d) on a tiny Mistral-family model
    on the CPU, against its own *Serve* run: the predicted prefill calls,
    first-token syncs and plain steps (they depend only on prompt lengths
    and the plan), one sync a step, the dispatch counts, S5's fault
    accounting and degraded view, S6's rejections and every stream by the
    margin rule."""
    import chip_smoke as cs
    from repro_torch.configs import paper_models as torch_paper
    from repro_torch.launch.serve import serve

    # Not a small-* name: serve() draws random weights instead of loading
    # the reference's trained checkpoint.
    cfg = torch_paper.small_lm(family_of=torch_paper.MISTRAL_7B, name="tiny-mistral",
                               num_layers=2, d_model=32, d_ff=48, vocab_size=64, num_heads=4)
    rng = np.random.default_rng(0)
    plens = rng.integers(16, 201, size=8)
    prompts = [rng.integers(2, cfg.vocab_size // 2, size=int(n)) for n in plens]
    res = serve(cfg, requests=8, max_new=32, max_batch=8, max_len=256, seed=0, compress=0.2,
                block_size=16, prefill_chunk=64, prompts=prompts, device="cpu",
                sched_policy="worst_case", pipeline_depth=1)
    want = [res["outputs"][u] for u in sorted(res["outputs"])]
    margins = cs.teacher_margins(torch, np, res["model"], res["params"], prompts, want)
    base = None
    for label, *_ in cs.SPEC_RUNS:
        r = cs.spec_run(torch, np, label, cfg, prompts, "cpu", base)
        if base is None:
            base = {"model": r["model"], "params": r["params"],
                    "draft": r["engine"].draft.params}
            assert all(torch.equal(a, b) for a, b in zip(cs._tensors(r["params"]),
                                                          cs._tensors(res["params"])))
        forced = cs.forced_gaps(torch, np, base["model"], base["params"], prompts,
                                r["outputs"])
        chk = cs.spec_check(label, r, want, margins, forced, r["model"], 1, False)
        assert chk["forced_outside"] == 0, (label, chk["forced_worst"])
        bad = [x for x in chk["rows"] if not x["ok"]]
        assert chk["counts_ok"] and all(chk["accounting"].values()), (
            label, chk["counts"], r["summary"]["dispatches"], chk["accounting"])
        assert not bad and all(x["ok"] for x in chk["s6_rejections"]), (label, bad)
        assert chk["ok"], label
    ss = r["summary"]["spec_stats"]  # S6: the target drafts for itself
    assert ss["acceptance_rate"] > 0.9 and ss["committed_per_row_step"] > 4
    logits = cs.spec_logits_check(torch, np, base["model"], base["params"], base["draft"],
                                  "cpu")
    assert [c["rows"] for c in logits["calls"]] == [512, 8, 8 * (cs.SPEC_K + 1)]
    assert logits["ok"], logits
