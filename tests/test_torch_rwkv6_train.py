"""Port parity for training RWKV-6: the plain backward of the recurrence
(``rwkv6_scan_bwd_ref``) against ``jax.vjp`` of the reference's scan, the
``RWKV6`` autograd Function (fp64 ``gradcheck``; taken only for
gradients), one reduced rwkv6-1.6b train step and five steps' losses
against the reference's, and chip_smoke's train_rwkv launch counts, all on
the CPU from numpy-seeded inputs with the tolerance stated where it is used."""

import functools
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import t2np, to_t

from repro.configs import get_config as jax_get_config
from repro.data.pipeline import LMDataPipeline as JaxPipeline
from repro.data.pipeline import PipelineState as JaxPipelineState
from repro.kernels.rwkv6.ref import rwkv6_scan_ref as jax_rwkv6_scan_ref
from repro.launch.steps import StepConfig as JaxStepConfig
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models import build_model as jax_build_model
from repro.models.losses import next_token_xent as jax_next_token_xent
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import init_state as jax_init_state
from repro.optim import schedule as jax_schedule
from repro_torch import optim
from repro_torch.configs import get_config
from repro_torch.data.pipeline import LMDataPipeline, PipelineState
from repro_torch.kernels.rwkv6 import ops as rwkv_ops
from repro_torch.kernels.rwkv6.ref import rwkv6_scan_bwd_ref, rwkv6_scan_ref
from repro_torch.launch import train as train_mod
from repro_torch.launch.steps import StepConfig, make_grad_fn, make_train_step
from repro_torch.models import build_model
from repro_torch.models import rwkv6 as rwkv6_model
from repro_torch.optim import schedule

NAMES = ("dr", "dk", "dv", "dw", "du")


def _inputs(bh, t, k, seed, w=None):
    rng = np.random.default_rng(seed)
    r, kk, v = (rng.standard_normal((bh, t, k)).astype(np.float32) * 0.5 for _ in range(3))
    if w is None:  # decays in (0, 1), strong ones included
        w = rng.uniform(0.01, 0.999, (bh, t, k)).astype(np.float32)
    u = (rng.standard_normal((bh, k)) * 0.5).astype(np.float32)
    dy = rng.standard_normal((bh, t, k)).astype(np.float32)
    return r, kk, v, np.broadcast_to(np.float32(w), (bh, t, k)).copy(), u, dy


# The same fp32 reverse recurrence as XLA's autodiff of the reference's
# scan, sums in another order: rtol 1e-4 with atol 1e-5 of the tensor's max
# |grad|.  Long memory (w = 1 - 1e-3 over 300 tokens) sums hundreds of
# terms of both signs into dw and du; extreme decay (1e-6) leaves one.
@pytest.mark.parametrize("bh,t,k,w", [(3, 37, 8, None), (2, 45, 64, None), (2, 20, 8, 1e-6),
                                      (2, 33, 64, 1e-6), (2, 300, 8, 1.0 - 1e-3),
                                      (1, 130, 64, 1.0 - 1e-3)])
def test_plain_backward_matches_jax_vjp(bh, t, k, w):
    args = _inputs(bh, t, k, seed=t * k, w=w)
    _, vjp = jax.vjp(jax_rwkv6_scan_ref, *(jnp.asarray(a) for a in args[:5]))
    want = vjp(jnp.asarray(args[5]))
    got = rwkv6_scan_bwd_ref(*(torch.as_tensor(a) for a in args))
    for name, g, x in zip(NAMES, got, want):
        x = np.asarray(x)
        assert g.dtype == torch.float32 and g.shape == x.shape, name
        np.testing.assert_allclose(t2np(g), x, rtol=1e-4, atol=1e-5 * np.abs(x).max(),
                                   err_msg=name)


def test_plain_backward_keeps_dtypes_and_matches_bf16_widened():
    """bf16 operands: the gradients come back in bf16, each the fp32
    gradient of the widened operands rounded once."""
    args = [torch.as_tensor(a) for a in _inputs(2, 19, 8, seed=5)]
    args16 = [a.to(torch.bfloat16) if i != 4 else a for i, a in enumerate(args)]
    got = rwkv6_scan_bwd_ref(*args16)
    want = rwkv6_scan_bwd_ref(*(a.float() for a in args16))
    for name, g, x in zip(NAMES, got, want):
        assert g.dtype == (torch.float32 if name == "du" else torch.bfloat16), name
        assert torch.equal(g, x.to(g.dtype)), name


@pytest.mark.parametrize("t", [1, 6])
def test_rwkv6_function_gradcheck_fp64(t):
    """The autograd Function (its plain forward and backward on the CPU)
    under ``torch.autograd.gradcheck`` in fp64, u a broadcast view as the
    model passes it."""
    gen = torch.Generator().manual_seed(t)
    b, h, k = 2, 2, 8
    r, kk, v = (torch.randn((b, h, t, k), generator=gen, dtype=torch.float64,
                            requires_grad=True) for _ in range(3))
    w = (torch.rand((b, h, t, k), generator=gen, dtype=torch.float64) * 0.9 + 0.05
         ).requires_grad_()
    bonus = torch.randn((h, k), generator=gen, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda *x: rwkv_ops.RWKV6.apply(*x[:4], x[4].expand(b, h, k)), (r, kk, v, w, bonus))


def test_wrapper_takes_the_function_only_for_gradients():
    """No gradient asked: the plain call, no graph; asked: the Function,
    whose output equals the plain scan's bit for bit and whose gradients
    are the plain backward's; no launch counted on the CPU; the final state
    with a gradient raises."""
    r, k, v, w, u, dy = (torch.as_tensor(a)[:, None] for a in _inputs(3, 11, 8, seed=9))
    counts = (rwkv_ops.launches, rwkv_ops.backward_launches)
    plain = rwkv_ops.rwkv6_heads(r, k, v, w, u)
    assert plain.grad_fn is None
    rg = r.clone().requires_grad_()
    out = rwkv_ops.rwkv6_heads(rg, k, v, w, u)
    assert type(out.grad_fn).__name__ == "RWKV6Backward"
    assert torch.equal(out.detach(), plain)
    assert torch.equal(plain[:, 0], rwkv6_scan_ref(r[:, 0], k[:, 0], v[:, 0], w[:, 0], u[:, 0]))
    (dr,) = torch.autograd.grad(out, rg, dy)
    want = rwkv6_scan_bwd_ref(r[:, 0], k[:, 0], v[:, 0], w[:, 0], u[:, 0], dy[:, 0])
    assert torch.equal(dr[:, 0], want[0])
    with torch.no_grad():
        assert rwkv_ops.rwkv6_heads(rg, k, v, w, u).grad_fn is None
        rwkv_ops.rwkv6_heads(rg, k, v, w, u, return_state=True)
    with pytest.raises(RuntimeError, match="^rwkv6: return_state=True with a gradient"):
        rwkv_ops.rwkv6_heads(rg, k, v, w, u, return_state=True)
    assert (rwkv_ops.launches, rwkv_ops.backward_launches) == counts


# ------------------------------------------------------------- train step

@functools.lru_cache(maxsize=None)
def _reduced_rwkv():
    """The reference's reduced rwkv6-1.6b at its init (seed 0) and the
    port's model holding the same weights through the bridge."""
    jcfg = jax_get_config("rwkv6-1.6b").reduced()
    jmodel = jax_build_model(jcfg)
    return jmodel, jmodel.init(jax.random.key(0)), build_model(
        get_config("rwkv6-1.6b").reduced())


def _batches(n, b=2, s=24, domain="en_a"):
    pipe = JaxPipeline(256, b, s, JaxPipelineState(seed=7, step=0, domain=domain))
    return [{k: np.array(a) for k, a in next(pipe).items()} for _ in range(n)]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def test_reduced_train_step_grads_then_step_match_reference():
    """One step on the reduced rwkv6-1.6b (2 layers, d 32, 4 heads x 8, fp32)
    from the reference's init: the loss and every leaf's grad against
    ``jax.grad`` of the reference's loss (sums in other orders through 2
    layers and a 24-token scan: loss rtol 1e-5, grads rtol 1e-3 with atol
    1e-5 of the leaf's max |grad|, as small-llama's in
    tests/test_torch_train.py); then the whole ``make_train_step``: its
    loss, grad_norm and lr against the reference step's (rtol 1e-5)."""
    jmodel, jparams, tmodel = _reduced_rwkv()
    tparams = to_t(jparams)
    batch = _batches(1)[0]

    def loss_fn(p):
        tok = jnp.asarray(batch["tokens"])
        logits, _, aux = jmodel.apply(p, tok, mode="train")
        return jax_next_token_xent(logits, tok, jnp.asarray(batch["loss_mask"]))
    loss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(jparams)
    _, tloss, _, tgrads = make_grad_fn(tmodel)(
        tparams, {k: torch.as_tensor(a) for k, a in batch.items()})
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-5)
    want, got = _flat(jgrads), _flat(tgrads)
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(t2np(got[k]), w, rtol=1e-3, atol=1e-5 * np.abs(w).max(),
                                   err_msg=k)
    jcfg = JaxAdamWConfig(lr=1e-3, schedule=jax_schedule.linear_warmup_cosine(20, 300))
    tcfg = optim.AdamWConfig(lr=1e-3, schedule=schedule.linear_warmup_cosine(20, 300))
    jstep = jax.jit(jax_make_train_step(jmodel, jcfg, JaxStepConfig()))
    _, _, jm = jstep(jparams, jax_init_state(jparams), jax.tree.map(jnp.asarray, batch))
    _, _, tm = make_train_step(tmodel, tcfg)(tparams, optim.init_state(tparams),
                                             {k: torch.as_tensor(a) for k, a in batch.items()})
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5, err_msg=key)
    assert not bool(tm["bad_step"]) and not bool(jm["bad_step"])


def test_five_steps_loss_trajectory_matches_reference():
    """Five steps of each package's own train step from the same init and
    batches: the losses agree to rtol 1e-4 (the small-llama test's bound)."""
    jmodel, jparams, tmodel = _reduced_rwkv()
    jcfg = JaxAdamWConfig(lr=1e-3, weight_decay=0.01,
                          schedule=jax_schedule.linear_warmup_cosine(2, 5))
    tcfg = optim.AdamWConfig(lr=1e-3, weight_decay=0.01,
                             schedule=schedule.linear_warmup_cosine(2, 5))
    jstep = jax.jit(jax_make_train_step(jmodel, jcfg, JaxStepConfig()))
    tstep = make_train_step(tmodel, tcfg)
    jp, js = jparams, jax_init_state(jparams)
    tp = to_t(jparams)
    ts = optim.init_state(tp)
    jl, tl = [], []
    for batch in _batches(5, domain="mix"):
        jp, js, jm = jstep(jp, js, jax.tree.map(jnp.asarray, batch))
        tp, ts, tm = tstep(tp, ts, {k: torch.as_tensor(a) for k, a in batch.items()})
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)


# ------------------------------------------------------------------ chip_smoke

def test_chip_train_rwkv_counts_hold_on_cpu(monkeypatch):
    """chip_smoke's train_rwkv path: TRAIN_PREDICTED["rwkv"] and
    ["rwkv_cli"] are one rwkv6 forward and one backward an RWKV layer and
    step, and nothing else: a chunked train step on a 4-layer reduced
    rwkv6-1.6b twin makes exactly those calls, counted at the wrappers, and
    so does ``train_loop`` on the reduced config; and the step-1 comparison
    (kernels, plain, plain replaying the kernel run's recurrence outputs)
    agrees exactly on the CPU, where all three are plain."""
    import dataclasses

    import chip_smoke as cs
    import repro_torch.calib.gram as calib_gram
    import repro_torch.kernels.nested_lowrank.ops as nlr
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import attention

    calls = Counter()

    def counted(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(rwkv6_model, "rwkv6_heads", counted("rwkv6", rwkv6_model.rwkv6_heads))
    monkeypatch.setattr(rwkv_ops, "rwkv6_scan_bwd_ref", counted(
        "rwkv6_backward", rwkv_ops.rwkv6_scan_bwd_ref))
    for mod, name in ((attention, "flash_attention"), (attention, "paged_attention"),
                      (fa_ops, "flash_attention_bwd_ref"), (calib_gram, "gram_accumulate"),
                      (nlr, "nested_lowrank_matmul")):
        monkeypatch.setattr(mod, name, counted(name, getattr(mod, name)))
    cfg = dataclasses.replace(get_config("rwkv6-1.6b").reduced(),
                              num_layers=cs.RWKV_TRAIN_LAYERS)
    model = build_model(cfg)
    params = model.init(0, "cpu")
    step_cfg = StepConfig(chunked_loss=8)
    pipe = LMDataPipeline(cfg.vocab_size, 2, 16, PipelineState(0, 0, "en_a"), device="cpu")
    batches = [next(pipe) for _ in range(cs.RWKV_TRAIN_STEPS - 1)]
    pinned = cs.RecurrenceTrace(rwkv_ops)
    loss_k, loss_p, rel, finite = cs.grads_against_plain(
        torch, make_grad_fn(model, step_cfg), params, batches[0], pinned)
    assert finite and loss_k == loss_p and max(rel.values()) == 0.0
    assert len(pinned.ys) == cfg.num_layers and max(pinned.rel.values()) == 0.0
    assert rwkv_ops.RWKV6.__name__ == "RWKV6" and rwkv_ops.RWKV6.__bases__ == (
        torch.autograd.Function,)  # the trace restored the Function
    calls.clear()
    step = make_train_step(model, optim.AdamWConfig(), step_cfg)
    opt = optim.init_state(params)
    make_grad_fn(model, step_cfg)(params, batches[0])  # step 1's kernel grads
    for b in batches:
        params, opt, _ = step(params, opt, b)
    pred = cs.TRAIN_PREDICTED["rwkv"]
    assert dict(calls) == {"rwkv6": pred["rwkv6"], "rwkv6_backward": pred["rwkv6_backward"]}
    assert pred["rwkv6"] == cs.RWKV_TRAIN_LAYERS * cs.RWKV_TRAIN_STEPS
    calls.clear()
    train_mod.train_loop(arch="rwkv6-1.6b", steps=3, batch=2, seq=16, device="cpu")
    layers = get_config("rwkv6-1.6b").reduced().num_layers
    assert dict(calls) == {"rwkv6": layers * 3, "rwkv6_backward": layers * 3}
    cli = cs.TRAIN_PREDICTED["rwkv_cli"]
    assert cli["rwkv6"] == cli["rwkv6_backward"] == layers * cs.RWKV_CLI_STEPS
    for p in (pred, cli):
        assert not any(v for k, v in p.items() if k not in ("rwkv6", "rwkv6_backward"))
