"""Port parity for training: the optimizer (schedules, AdamW, int8 gradient
roundtrip), the chunked loss, the flash-attention backward's plain
version, ``make_train_step`` on small-llama, the MoE aux loss, the data
pipeline, checkpoints across the two packages, ``train_loop``'s resume and
``load_small``'s first-run training, each against the JAX reference on
numpy-seeded inputs with the tolerance stated where it is used."""

import dataclasses
import functools
import json
import os
import threading
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import t2np, to_t

from repro.checkpoint import checkpointer as jax_checkpointer
from repro.checkpoint.checkpointer import load_checkpoint as jax_load_checkpoint
from repro.checkpoint.checkpointer import save_checkpoint as jax_save_checkpoint
from repro.checkpoint.manager import CheckpointManager as JaxCheckpointManager
from repro.configs import get_config as jax_get_config
from repro.configs import paper_models as jax_paper
from repro.data.pipeline import LMDataPipeline as JaxPipeline
from repro.data.pipeline import PipelineState as JaxPipelineState
from repro.launch.steps import StepConfig as JaxStepConfig
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models import build_model as jax_build_model
from repro.models import moe as jax_moe
from repro.models.attention import _naive_attention as jax_naive_attention
from repro.models.attention import chunked_causal_attention as jax_chunked_attention
from repro.models.losses import chunked_xent_from_hidden as jax_chunked_xent
from repro.models.losses import next_token_xent as jax_next_token_xent
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import AdamWState as JaxAdamWState
from repro.optim import apply_updates as jax_apply_updates
from repro.optim import grad as jax_grad_mod
from repro.optim import init_state as jax_init_state
from repro.optim import schedule as jax_schedule
from repro_torch import optim
from repro_torch.checkpoint import CheckpointManager, load_checkpoint, save_checkpoint
from repro_torch.checkpoint import checkpointer as port_checkpointer
from repro_torch.configs import get_config
from repro_torch.data.pipeline import LMDataPipeline, PipelineState
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import train as train_mod
from repro_torch.launch.steps import StepConfig, make_grad_fn, make_train_step
from repro_torch.models import build_model, moe
from repro_torch.models.losses import chunked_xent_from_hidden, next_token_xent
from repro_torch.optim import grad as grad_mod
from repro_torch.optim import schedule
from repro_torch.optim.adamw import tree_map


def _flat(tree, prefix=""):
    """{path: leaf} of nested dicts (and tuples, by index)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}#{i}/"))
        return out
    return {prefix[:-1]: tree}


def _np(x) -> np.ndarray:
    return t2np(x) if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _bits(x) -> np.ndarray:
    """The raw bits of a torch or JAX/numpy leaf (bf16 as int16)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.itemsize == 2 and x.dtype.kind == "V" or \
        x.dtype.name == "bfloat16" else x


# ---------------------------------------------------------------- schedules

@pytest.mark.parametrize("name,args", [("constant", ()), ("linear_warmup_cosine", (20, 300)),
                                       ("linear_warmup_cosine", (0, 50, 0.0)),
                                       ("inverse_sqrt", (20,))])
def test_schedules_match_reference(name, args):
    """Steps 0-400 as 0-d int32 tensors.  fp32 both sides; cos and sqrt of
    the two libraries agree to a few ulps (rtol 1e-6)."""
    jfn, tfn = getattr(jax_schedule, name)(*args), getattr(schedule, name)(*args)
    for step in range(401):
        want = float(jfn(jnp.asarray(step, jnp.int32)))
        got = tfn(torch.tensor(step, dtype=torch.int32))
        assert got.shape == () and got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------------- AdamW

def _random_tree(rng, dtype):
    shapes = {"a": {"kernel": (7, 5)}, "b": {"table": (33, 4), "scale": (4,)},
              "g0": {"sub0": {"w": (2, 3, 300)}}}
    return tree_map(lambda s: rng.standard_normal(s).astype(np.float32), shapes)


@pytest.mark.parametrize("clip", [1.0, 1e6])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_updates_matches_reference(dtype, clip):
    """Three AdamW steps on random fp32 and bf16 trees, clipping on (grads
    of norm ~30 against 1.0) and off, with a warmup-cosine schedule: mu, nu,
    master, params, grad_norm and lr.  Both sides start from the same
    state and take the same grads at every step (the reference's grads are
    not the point).  fp32 sums in another order: rtol 1e-5 (mu, nu, master,
    norm); bf16 params are master rounded to bf16, within one bf16 ulp."""
    rng = np.random.default_rng(3)
    p0 = _random_tree(rng, dtype)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), p0)
    tp = to_t(jp)
    jcfg = JaxAdamWConfig(lr=1e-2, grad_clip=clip, weight_decay=0.1,
                          schedule=jax_schedule.linear_warmup_cosine(2, 10))
    tcfg = optim.AdamWConfig(lr=1e-2, grad_clip=clip, weight_decay=0.1,
                             schedule=schedule.linear_warmup_cosine(2, 10))
    js, ts = jax_init_state(jp), optim.init_state(tp)
    for i in range(3):
        g = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 2.0).astype(np.float32)
                         .astype(a.dtype), p0)
        jg = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), g)
        jp, js, jm = jax_apply_updates(jp, jg, js, jcfg)
        tp, ts, tm = optim.apply_updates(tp, to_t(jg), ts, tcfg)
        assert int(ts.step) == i + 1 and ts.step.dtype == torch.int32
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
        for name in ("mu", "nu", "master"):
            got, want = _flat(getattr(ts, name)), _flat(getattr(js, name))
            for k in want:
                assert got[k].dtype == torch.float32
                np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), rtol=1e-5,
                                           atol=1e-7, err_msg=f"{name} {k}")
        got, want = _flat(tp), _flat(jp)
        for k in want:
            w = np.asarray(want[k], np.float32)
            tol = 2 ** -7 if dtype == "bfloat16" else 1e-5
            np.testing.assert_allclose(_np(got[k]), w, rtol=tol, atol=1e-7, err_msg=k)
    assert float(tm["grad_norm"]) > (30 if clip == 1.0 else 0)


def test_global_norm_and_init_state():
    rng = np.random.default_rng(4)
    tp = to_t(jax.tree.map(jnp.asarray, _random_tree(rng, "float32")))
    st = optim.init_state(tp)
    assert int(st.step) == 0 and st.step.shape == ()
    assert all(torch.equal(a, b) for a, b in zip(_flat(st.master).values(),
                                                 _flat(tp).values()))
    want = np.sqrt(sum(float((t2np(x) ** 2).sum()) for x in _flat(tp).values()))
    np.testing.assert_allclose(float(optim.global_norm(tp)), want, rtol=1e-6)


# ------------------------------------------------------ gradient roundtrip

@pytest.mark.parametrize("shape", [(300,), (17, 40), (2, 3, 256)])
def test_roundtrip_matches_reference(shape):
    """int8 codes and block scales bit-exact; the carried error and the
    dequantized grads at rtol 1e-6 (one fp32 product, another order of the
    error add)."""
    rng = np.random.default_rng(sum(shape))
    g = rng.standard_normal(shape).astype(np.float32) * 3
    e = rng.standard_normal(shape).astype(np.float32) * 0.01
    (jq, js), je = jax_grad_mod.compress_grad(jnp.asarray(g), jnp.asarray(e))
    (tq, tsc), te = grad_mod.compress_grad(torch.as_tensor(g), torch.as_tensor(e))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(js))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-6, atol=1e-9)
    jd, jerr = jax_grad_mod.roundtrip({"w": jnp.asarray(g)}, {"w": jnp.asarray(e)})
    td, terr = grad_mod.roundtrip({"w": torch.as_tensor(g)}, {"w": torch.as_tensor(e)})
    np.testing.assert_allclose(td["w"].numpy(), np.asarray(jd["w"]), rtol=1e-6)
    np.testing.assert_allclose(terr["w"].numpy(), np.asarray(jerr["w"]), rtol=1e-6,
                               atol=1e-9)


def test_roundtrip_rounds_half_to_even_like_reference():
    """A block whose max is 127 has scale 1.0, so x / scale hits the .5
    ties exactly: both frameworks round them to even."""
    g = np.zeros(256, np.float32)
    g[:9] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 126.5]
    (jq, _), _ = jax_grad_mod.compress_grad(jnp.asarray(g))
    (tq, tsc), _ = grad_mod.compress_grad(torch.as_tensor(g))
    assert float(tsc[0, 0]) == 1.0
    assert tq[0, :9].tolist() == [127, 0, 2, 2, 0, -2, -2, 4, 126]
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))


# ----------------------------------------------------------- chunked loss

def _unembeds(rng, d, v):
    w = rng.standard_normal((d, v)).astype(np.float32) * 0.3
    return {
        "tied": {"table": rng.standard_normal((v, d)).astype(np.float32) * 0.3},
        "untied": {"kernel": w},
        "factored": {"u": w[:, :6] * 0 + rng.standard_normal((d, 6)).astype(np.float32),
                     "v": rng.standard_normal((6, v)).astype(np.float32) * 0.2,
                     "u2": rng.standard_normal((d, 3)).astype(np.float32),
                     "v2": rng.standard_normal((3, v)).astype(np.float32) * 0.1},
    }


@pytest.mark.parametrize("chunk", [4, 7, 64])
@pytest.mark.parametrize("kind", ["tied", "untied", "factored"])
@pytest.mark.parametrize("masked", [False, True])
def test_chunked_xent_matches_reference_and_full_logits(kind, chunk, masked):
    """S 20 (19 targets: chunks of 4 and 7 pad the last, 64 is one padded
    chunk), with and without a mask.  Equal to ``next_token_xent`` on the
    full logits and to the reference's, and its gradient (hidden and the
    unembed leaves) to ``jax.grad`` of the reference's.  fp32, sums in
    other orders: rtol 1e-5 (loss), 1e-4 (grads, atol 1e-6 of their max)."""
    rng = np.random.default_rng(chunk + len(kind))
    b, s, d, v = 2, 20, 8, 40
    hidden = rng.standard_normal((b, s, d)).astype(np.float32)
    tokens = rng.integers(0, v, (b, s))
    mask = (rng.random((b, s)) > 0.3).astype(np.float32) if masked else None
    un = _unembeds(rng, d, v)[kind]
    jmask = None if mask is None else jnp.asarray(mask)

    def jloss(h, u):
        return jax_chunked_xent(h, u, jnp.asarray(tokens, jnp.int32), chunk=chunk, mask=jmask)
    want, (jgh, jgu) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(hidden), jax.tree.map(jnp.asarray, un))
    th = torch.as_tensor(hidden).requires_grad_()
    tu = {k: torch.as_tensor(a).requires_grad_() for k, a in un.items()}
    tmask = None if mask is None else torch.as_tensor(mask)
    got = chunked_xent_from_hidden(th, tu, torch.as_tensor(tokens), chunk=chunk, mask=tmask)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    w = tu["table"].T if kind == "tied" else (
        tu["kernel"] if kind == "untied" else tu["u"] @ tu["v"] + tu["u2"] @ tu["v2"])
    full = next_token_xent(th @ w, torch.as_tensor(tokens), tmask)
    np.testing.assert_allclose(float(got.detach()), float(full.detach()), rtol=1e-5)
    np.testing.assert_allclose(float(got.detach()), float(jax_next_token_xent(
        jnp.asarray(hidden) @ jnp.asarray(t2np(w)), jnp.asarray(tokens, jnp.int32), jmask)),
        rtol=1e-5)
    grads = torch.autograd.grad(got, [th, *tu.values()])
    for name, g, jg in zip(["hidden", *tu], grads, [jgh, *(jgu[k] for k in tu)]):
        jg = np.asarray(jg)
        np.testing.assert_allclose(t2np(g), jg, rtol=1e-4, atol=1e-6 * np.abs(jg).max(),
                                   err_msg=name)


def test_chunked_xent_without_grad_keeps_no_graph():
    rng = np.random.default_rng(0)
    h = torch.as_tensor(rng.standard_normal((1, 9, 4)).astype(np.float32))
    tab = {"table": torch.as_tensor(rng.standard_normal((10, 4)).astype(np.float32))}
    out = chunked_xent_from_hidden(h, tab, torch.as_tensor(rng.integers(0, 10, (1, 9))),
                                   chunk=3)
    assert not out.requires_grad and out.shape == ()


# ------------------------------------------------------- flash backward

def _qkv(rng, b, s, hkv, g, hd):
    return [rng.standard_normal((b, s, h, hd)).astype(np.float32) for h in (hkv * g, hkv, hkv)]


def _jax_vjp(fn, q, k, v, dout, dtype):
    cast = (lambda a: jnp.asarray(a).astype(jnp.bfloat16)) if dtype == torch.bfloat16 \
        else jnp.asarray
    out, vjp = jax.vjp(fn, cast(q), cast(k), cast(v))
    return out, vjp(cast(dout).astype(out.dtype))


# fp32: the FA2 formulas against autodiff of the naive softmax, another
# order of sums (rtol 1e-4, atol 1e-5 of the max).  bf16: the reference's
# autodiff rounds P to bf16 before P V and differentiates through that
# rounding, the FA2 backward works from P rebuilt in fp32; both end in
# bf16 (2e-2 of the tensor's max |grad|).
BWD_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (0.0, 2e-2)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,hkv,g,hd", [(2, 16, 2, 1, 8), (1, 37, 2, 4, 16),
                                          (1, 24, 1, 16, 8)])
def test_plain_backward_matches_jax_vjp_of_naive(b, s, hkv, g, hd, dtype):
    """The plain forward's out and lse, and the plain FA2 backward, against
    the reference's naive causal attention and ``jax.vjp`` of it: G 1, 4
    and 16, ragged S 37."""
    rng = np.random.default_rng(s * g)
    q, k, v = _qkv(rng, b, s, hkv, g, hd)
    dout = rng.standard_normal(q.shape).astype(np.float32)
    scale = 1.0 / np.sqrt(hd)
    mask = jnp.tril(jnp.ones((s, s), bool))[None, None, None]
    want, (dq, dk, dv) = _jax_vjp(lambda a, b_, c: jax_naive_attention(a, b_, c, mask, scale),
                                  q, k, v, dout, dtype)
    tq, tk, tv, tdo = (torch.as_tensor(a).to(dtype) for a in (q, k, v, dout))
    out, lse = fa_ref.flash_attention_fwd_ref(tq, tk, tv)
    assert lse.shape == (b, hkv * g, s) and lse.dtype == torch.float32
    assert torch.equal(out, fa_ref.flash_attention_ref(tq, tk, tv))
    scores = np.einsum("bskgd,btkd->bkgst", t2np(tq).reshape(b, s, hkv, g, hd),
                       t2np(tk)) * scale
    scores = np.where(np.tril(np.ones((s, s), bool)), scores, -np.inf)
    want_lse = np.log(np.exp(scores - scores.max(-1, keepdims=True)).sum(-1)) \
        + scores.max(-1)
    np.testing.assert_allclose(t2np(lse), want_lse.reshape(b, hkv * g, s), rtol=1e-5,
                               atol=1e-5)
    rtol, atol = BWD_TOL[dtype]
    np.testing.assert_allclose(t2np(out), _np(jnp.asarray(want, jnp.float32)), rtol=rtol,
                               atol=atol * np.abs(_np(jnp.asarray(want, jnp.float32))).max()
                               + (2e-2 if dtype == torch.bfloat16 else 0))
    got = fa_ref.flash_attention_bwd_ref(tq, tk, tv, out, lse, tdo)
    for name, x, w in zip(("dq", "dk", "dv"), got, (dq, dk, dv)):
        assert x.dtype == dtype and x.shape == w.shape
        w = np.asarray(jnp.asarray(w, jnp.float32))
        np.testing.assert_allclose(t2np(x), w, rtol=rtol, atol=atol * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("g", [1, 4])
def test_plain_backward_matches_jax_vjp_of_chunked(g):
    """Against ``jax.vjp`` of the reference's chunked (online-softmax)
    causal attention at chunk 8 over S 32: fp32, tolerances as above."""
    rng = np.random.default_rng(40 + g)
    b, s, hkv, hd = 2, 32, 2, 8
    q, k, v = _qkv(rng, b, s, hkv, g, hd)
    dout = rng.standard_normal(q.shape).astype(np.float32)
    _, (dq, dk, dv) = _jax_vjp(lambda a, b_, c: jax_chunked_attention(
        a, b_, c, 1.0 / np.sqrt(hd), chunk=8), q, k, v, dout, torch.float32)
    tq, tk, tv, tdo = (torch.as_tensor(a) for a in (q, k, v, dout))
    out, lse = fa_ref.flash_attention_fwd_ref(tq, tk, tv)
    got = fa_ref.flash_attention_bwd_ref(tq, tk, tv, out, lse, tdo)
    for x, w in zip(got, (dq, dk, dv)):
        w = np.asarray(w)
        np.testing.assert_allclose(t2np(x), w, rtol=1e-4, atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("g", [1, 3])
def test_flash_autograd_function_gradcheck_fp64(g):
    """The autograd Function (its plain forward and backward on the CPU)
    under ``torch.autograd.gradcheck`` in fp64, ragged S."""
    gen = torch.Generator().manual_seed(g)
    ins = [torch.randn((2, 7, h, 8), generator=gen, dtype=torch.float64, requires_grad=True)
           for h in (2 * g, 2, 2)]
    assert torch.autograd.gradcheck(fa_ops.FlashAttention.apply, ins)


def test_flash_wrapper_takes_the_function_only_for_gradients():
    """No gradient asked: the forward-only plain call, no graph; asked: the
    Function, whose output equals the plain forward's bit for bit."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.as_tensor(a) for a in _qkv(rng, 1, 11, 2, 2, 8))
    plain = fa_ops.flash_attention(q, k, v)
    assert plain.grad_fn is None
    qg = q.clone().requires_grad_()
    out = fa_ops.flash_attention(qg, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    assert torch.equal(out.detach(), plain)
    with torch.no_grad():
        assert fa_ops.flash_attention(qg, k, v).grad_fn is None


# ------------------------------------------------------------- train step

def _small_cfgs(**kw):
    jcfg = jax_paper.small_lm(name="small-llama", vocab_size=512, family_of=jax_paper.LLAMA_7B,
                              num_layers=4, d_model=128, d_ff=352)
    tcfg = get_config("small-llama")
    if kw:
        jcfg, tcfg = dataclasses.replace(jcfg, **kw), dataclasses.replace(tcfg, **kw)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _small_llama():
    """The reference's small-llama at its init (seed 0) and the port's model
    holding the same weights through the bridge."""
    jcfg, tcfg = _small_cfgs()
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    return jmodel, jparams, build_model(tcfg)


def _batches(n, b=2, s=32, domain="en_a"):
    pipe = JaxPipeline(512, b, s, JaxPipelineState(seed=5, step=0, domain=domain))
    return [{k: np.array(a) for k, a in next(pipe).items()} for _ in range(n)]


def _jax_loss_and_grads(jmodel, jparams, batch, chunked):
    """The reference's train-step loss (steps.py's loss_fn) and jax.grad."""
    def loss_fn(p):
        tok = jnp.asarray(batch["tokens"])
        mask = jnp.asarray(batch["loss_mask"])
        if chunked:
            hidden, _, aux = jmodel.apply(p, tok, mode="train", output="hidden")
            loss = jax_chunked_xent(hidden, p.get("unembed", p["embed"]), tok, chunk=chunked,
                                    mask=mask)
        else:
            logits, _, aux = jmodel.apply(p, tok, mode="train")
            loss = jax_next_token_xent(logits, tok, mask)
        return loss + 0.01 * aux, (loss, aux)
    (_, (loss, aux)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jparams)
    return loss, aux, grads


@pytest.mark.parametrize("chunked", [0, 32])
def test_train_step_grads_then_update_match_reference(chunked):
    """One step on small-llama (4 x 128, vocab 512) from the reference's
    init: loss and every leaf's grad against ``jax.grad`` of the
    reference's loss (fp32, sums in other orders through 4 layers: loss
    rtol 1e-5, grads rtol 1e-3 with atol 1e-5 of the leaf's max |grad|);
    then ``apply_updates`` fed the SAME (reference) grads on both sides
    (rtol 1e-5: at step 1 mhat/sqrt(vhat) is sign(g), so the port's own
    grads would flip elements whose |g| is at fp32 noise by lr); then the
    whole ``make_train_step`` with its own grads: its loss, grad_norm and
    lr against the reference step's."""
    jmodel, jparams, tmodel = _small_llama()
    tparams = to_t(jparams)
    batch = _batches(1)[0]
    loss, aux, jgrads = _jax_loss_and_grads(jmodel, jparams, batch, chunked)
    _, tloss, taux, tgrads = make_grad_fn(tmodel, StepConfig(chunked_loss=chunked))(
        tparams, {k: torch.as_tensor(a) for k, a in batch.items()})
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-5)
    assert float(taux) == float(aux) == 0.0
    want, got = _flat(jgrads), _flat(tgrads)
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(t2np(got[k]), w, rtol=1e-3, atol=1e-5 * np.abs(w).max(),
                                   err_msg=k)
    jcfg = JaxAdamWConfig(lr=1e-3, schedule=jax_schedule.linear_warmup_cosine(20, 300))
    tcfg = optim.AdamWConfig(lr=1e-3, schedule=schedule.linear_warmup_cosine(20, 300))
    jp, js, jm = jax_apply_updates(jparams, jgrads, jax_init_state(jparams), jcfg)
    tp, ts, tm = optim.apply_updates(tparams, to_t(jgrads), optim.init_state(tparams), tcfg)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    for name, a, b in (("params", tp, jp), ("mu", ts.mu, js.mu), ("nu", ts.nu, js.nu),
                       ("master", ts.master, js.master)):
        fa, fb = _flat(a), _flat(b)
        for k in fb:
            np.testing.assert_allclose(t2np(fa[k]), np.asarray(fb[k]), rtol=1e-5, atol=1e-8,
                                       err_msg=f"{name} {k}")
    jstep = jax.jit(jax_make_train_step(jmodel, jcfg, JaxStepConfig(chunked_loss=chunked)))
    _, _, jm = jstep(jparams, jax_init_state(jparams), jax.tree.map(jnp.asarray, batch))
    tstep = make_train_step(tmodel, tcfg, StepConfig(chunked_loss=chunked))
    _, _, tm = tstep(tparams, optim.init_state(tparams),
                     {k: torch.as_tensor(a) for k, a in batch.items()})
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5, err_msg=key)
    assert not bool(tm["bad_step"]) and not bool(jm["bad_step"])


def test_five_steps_loss_trajectory_matches_reference():
    """Five steps of each package's own train step from the same init and
    batches: the losses agree to rtol 1e-4 (a few elements a step flip by
    lr between frameworks, see above; the loss moves by far less)."""
    jmodel, jparams, tmodel = _small_llama()
    jcfg = JaxAdamWConfig(lr=1e-3, weight_decay=0.01,
                          schedule=jax_schedule.linear_warmup_cosine(2, 5))
    tcfg = optim.AdamWConfig(lr=1e-3, weight_decay=0.01,
                             schedule=schedule.linear_warmup_cosine(2, 5))
    jstep = jax.jit(jax_make_train_step(jmodel, jcfg, JaxStepConfig()))
    tstep = make_train_step(tmodel, tcfg, StepConfig())
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
    assert tl[-1] < tl[0]


def test_guard_keeps_old_tree_on_nan_loss_in_both_packages():
    """A NaN in the final norm's scale makes the loss NaN: both steps
    report a bad step and return the old params and optimizer state."""
    jmodel, jparams, tmodel = _small_llama()
    bad = jax.tree.map(lambda a: a, jparams)
    bad["final_norm"]["scale"] = bad["final_norm"]["scale"].at[3].set(jnp.nan)
    batch = _batches(1)[0]
    jstep = jax_make_train_step(jmodel, JaxAdamWConfig(), JaxStepConfig())
    jst = jax_init_state(bad)
    jp, js, jm = jstep(bad, jst, jax.tree.map(jnp.asarray, batch))
    tp0 = to_t(bad)
    ts0 = optim.init_state(tp0)
    tp, ts, tm = make_train_step(tmodel, optim.AdamWConfig(), StepConfig())(
        tp0, ts0, {k: torch.as_tensor(a) for k, a in batch.items()})
    assert bool(jm["bad_step"]) and bool(tm["bad_step"])
    assert np.isnan(float(jm["loss"])) and np.isnan(float(tm["loss"]))
    assert int(js.step) == 0 and int(ts.step) == 0
    for a, b in ((tp, tp0), (ts.master, ts0.master), (ts.mu, ts0.mu)):
        for k, x in _flat(a).items():
            np.testing.assert_array_equal(_bits(x), _bits(_flat(b)[k]), err_msg=k)
    for k, x in _flat(jp).items():
        np.testing.assert_array_equal(np.asarray(x), np.asarray(_flat(bad)[k]), err_msg=k)


# ---------------------------------------------------------------- MoE aux

def _reference_choices(jmodel, jparams, tokens):
    """The reference's top-k experts of every MoE layer on ``tokens``, in
    call order (from its router_in taps)."""
    taps = {}
    jmodel.apply(jparams, jnp.asarray(tokens, jnp.int32), mode="train", taps=taps)
    out = []
    for name in (k for k in taps if k.endswith(".moe.router_in")):
        parts = name.split(".")[0].split("/")
        lp = jparams[parts[0]][parts[-1]]["moe"]
        if len(parts) == 3:  # g{i}/rep{r}/sub{j}: a stacked group
            r = int(parts[1][3:])
            lp = jax.tree.map(lambda a: a[r], lp)
        probs = jax_moe.router_probs(lp, taps[name])
        out.append(torch.as_tensor(np.array(jax.lax.top_k(probs, jmodel.cfg.moe.top_k)[1]))
                   .long())
    return out


def test_moe_aux_loss_and_grads_match_reference():
    """The reduced moonshot-v1-16b-a3b (a dense layer, then MoE layers):
    the train-step loss with the aux term (weight 0.01) and every leaf's
    grad against the reference's, the port's experts pinned to the
    reference's choices (``RoutingTrace``).  fp32; tolerances as the dense
    step's.  The aux is summed over the MoE layers, as the reference's."""
    jcfg = jax_get_config("moonshot-v1-16b-a3b").reduced()
    tcfg = get_config("moonshot-v1-16b-a3b").reduced()
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    jparams = jmodel.init(jax.random.key(1))
    tokens = np.random.default_rng(6).integers(0, jcfg.vocab_size, (2, 24))
    batch = {"tokens": tokens.astype(np.int32),
             "loss_mask": np.ones(tokens.shape, np.float32)}
    loss, aux, jgrads = _jax_loss_and_grads(jmodel, jparams, batch, 0)
    assert float(aux) > 0
    trace = moe.RoutingTrace()
    trace.choices = _reference_choices(jmodel, jparams, tokens)
    assert len(trace.choices) == sum(f == "moe" for _, f in tmodel.specs) >= 2
    with trace.replay():
        total, tloss, taux, tgrads = make_grad_fn(tmodel, StepConfig())(
            to_t(jparams), {k: torch.as_tensor(a) for k, a in batch.items()})
    assert trace.flips <= 2
    np.testing.assert_allclose(float(taux), float(aux), rtol=1e-5)
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-5)
    np.testing.assert_allclose(float(total), float(loss) + 0.01 * float(aux), rtol=1e-6)
    want, got = _flat(jgrads), _flat(tgrads)
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(t2np(got[k]), w, rtol=1e-3, atol=1e-5 * np.abs(w).max(),
                                   err_msg=k)
    router = [k for k in want if "router" in k]
    assert router and all(np.abs(np.asarray(want[k])).max() > 0 for k in router)


def test_serving_and_eval_calls_carry_no_aux():
    """``apply`` without ``aux`` is the forward it was: a list passed in
    receives one 0-d loss a MoE layer; the logits are the same bits."""
    tcfg = get_config("moonshot-v1-16b-a3b").reduced()
    tmodel = build_model(tcfg)
    tp = tmodel.init(0, "cpu")
    tok = torch.as_tensor(np.random.default_rng(1).integers(0, tcfg.vocab_size, (1, 9)))
    auxs = []
    a = tmodel.apply(tp, tok, mode="train")
    b = tmodel.apply(tp, tok, mode="train", aux=auxs)
    assert torch.equal(a, b)
    assert len(auxs) == sum(f == "moe" for _, f in tmodel.specs)
    assert all(x.shape == () for x in auxs)


# ---------------------------------------------------------------- pipeline

@pytest.mark.parametrize("domain", ["en_a", "jp", "mix"])
def test_pipeline_tokens_equal_reference(domain):
    """(seed, step, domain) -> the reference's tokens bit for bit, and the
    loss mask of ones."""
    j = JaxPipeline(512, 4, 24, JaxPipelineState(seed=7, step=11, domain=domain))
    t = LMDataPipeline(512, 4, 24, PipelineState(seed=7, step=11, domain=domain),
                       device="cpu")
    for _ in range(3):
        want, got = next(j), next(t)
        assert got["tokens"].dtype == torch.int32
        np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
        np.testing.assert_array_equal(got["loss_mask"].numpy(), np.asarray(want["loss_mask"]))
    assert t.state.to_dict() == {"seed": 7, "step": 14, "domain": domain}


def test_pipeline_restart_and_prefetch_are_deterministic():
    """A pipeline rebuilt from a saved state dict continues the stream; the
    prefetch thread's batches equal the synchronous ones."""
    a = LMDataPipeline(512, 2, 16, PipelineState(seed=1, step=0, domain="mix"), device="cpu")
    first = [next(a)["tokens"] for _ in range(5)]
    saved = PipelineState(seed=1, step=0, domain="mix")
    b = LMDataPipeline(512, 2, 16, saved, device="cpu")
    [next(b) for _ in range(2)]
    c = LMDataPipeline(512, 2, 16, PipelineState.from_dict(json.loads(json.dumps(
        b.state.to_dict()))), device="cpu")
    assert all(torch.equal(next(c)["tokens"], first[i]) for i in range(2, 5))
    d = LMDataPipeline(512, 2, 16, PipelineState(seed=1, step=0, domain="mix"), device="cpu")
    d.start_prefetch()
    try:
        got = [d.next_prefetched()["tokens"] for _ in range(5)]
    finally:
        d.stop()
    assert all(torch.equal(x, y) for x, y in zip(got, first))
    assert d.state.step == 5


# ------------------------------------------------------------- checkpoints

def _train_tree(dtype):
    rng = np.random.default_rng(8)
    p = {"embed": {"table": rng.standard_normal((6, 4))},
         "g0": {"sub0": {"attn": {"wq": {"kernel": rng.standard_normal((2, 4, 4))}}}}}
    jp = jax.tree.map(lambda a: jnp.asarray(a, dtype), p)
    return jp, jax_init_state(jp)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_port_training_checkpoint_loads_in_reference(tmp_path, dtype):
    """(params, AdamWState) written by the port reads back in the
    reference's ``load_checkpoint`` with equal leaves (bf16 bit for bit),
    the state's tuple rebuilt."""
    jp, js = _train_tree(dtype)
    tp = to_t(jp)
    ts = optim.init_state(tp)
    ts = ts._replace(step=torch.tensor(7, dtype=torch.int32))
    path = str(tmp_path / "ck")
    save_checkpoint(path, (tp, ts), {"pipeline": {"seed": 0, "step": 7, "domain": "mix"}})
    (rp, ro), extra = jax_load_checkpoint(path)
    assert extra["pipeline"]["step"] == 7
    ro = JaxAdamWState(*ro)
    assert int(ro.step) == 7 and np.asarray(ro.step).shape == ()
    assert rp["embed"]["table"].dtype == dtype
    for k, want in _flat(tp).items():
        np.testing.assert_array_equal(_bits(_flat(rp)[k]), _bits(want), err_msg=k)
    for k, want in _flat(ts.master).items():
        np.testing.assert_array_equal(np.asarray(_flat(ro.master)[k]), want.numpy())


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_reference_training_checkpoint_loads_in_port(tmp_path, dtype):
    jp, js = _train_tree(dtype)
    path = str(tmp_path / "ck")
    jax_save_checkpoint(path, (jp, js._replace(step=jnp.asarray(3, jnp.int32))),
                        {"steps": 3})
    (tp, to), extra = load_checkpoint(path, device="cpu")
    to = optim.AdamWState(*to)
    assert extra == {"steps": 3}
    assert to.step.shape == () and int(to.step) == 3 and to.step.dtype == torch.int32
    assert tp["embed"]["table"].dtype == (torch.bfloat16 if dtype == jnp.bfloat16
                                          else torch.float32)
    for k, want in _flat(jp).items():
        np.testing.assert_array_equal(_bits(_flat(tp)[k]), _bits(want), err_msg=k)
    for name in ("mu", "nu", "master"):
        for k, want in _flat(getattr(js, name)).items():
            np.testing.assert_array_equal(_flat(getattr(to, name))[k].numpy(),
                                          np.asarray(want))


@pytest.mark.parametrize("async_save", [False, True])
def test_manager_rotation_latest_and_wait(tmp_path, monkeypatch, async_save):
    """keep=2 rotates the oldest away as the reference's manager does on
    the same saves (an async save rotates before its own directory lands,
    so it keeps one more until the next save), ``latest_step`` names the
    newest, no ``.tmp`` stays after a save, and an async save is on disk
    after ``wait`` (the reference's manager reads it).

    Each async writer is held until its ``save`` has returned, for both
    managers: a save rotates right after it starts its writer, so a
    writer left free could land its directory before that rotation and
    let it remove step 1 early."""
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=async_save)
    ref = JaxCheckpointManager(str(tmp_path / "ref"), keep=2, async_save=async_save)
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore()
    release = threading.Semaphore(0)

    def held(write):
        def run(*args, **kwargs):
            release.acquire()
            return write(*args, **kwargs)
        return run
    with monkeypatch.context() as m:
        if async_save:
            # The writer threads' targets only: the port's thread calls
            # ``_write``, the reference's is ``save_checkpoint`` itself.
            m.setattr(port_checkpointer, "_write", held(port_checkpointer._write))
            m.setattr(jax_checkpointer, "save_checkpoint",
                      held(jax_checkpointer.save_checkpoint))
        for step in (1, 2, 3):
            mgr.save(step, {"w": torch.full((3,), float(step))}, {"step": step})
            ref.save(step, {"w": jnp.full((3,), float(step))}, {"step": step})
            if async_save:
                assert step not in mgr.all_steps() and step not in ref.all_steps()
                release.release(2)
        mgr.wait()
        ref.wait()
    assert mgr.all_steps() == ref.all_steps() == ([1, 2, 3] if async_save else [2, 3])
    mgr.save(4, {"w": torch.full((3,), 4.0)}, {"step": 4}, block=True)
    ref.save(4, {"w": jnp.full((3,), 4.0)}, {"step": 4}, block=True)
    assert mgr.all_steps() == ref.all_steps() == [3, 4]
    mgr.save(3, {"w": torch.full((3,), 3.0)}, {"step": 3})
    mgr.wait()
    assert mgr.latest_step() == 4
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]
    tree, extra, step = mgr.restore(device="cpu")
    assert step == 4 and extra == {"step": 4} and tree["w"].tolist() == [4.0] * 3
    tree, extra, step = mgr.restore(3, device="cpu")
    assert extra == {"step": 3} and tree["w"].tolist() == [3.0] * 3
    jtree, jextra, jstep = JaxCheckpointManager(str(tmp_path)).restore()
    assert jstep == 4 and np.asarray(jtree["w"]).tolist() == [4.0] * 3


def test_async_save_snapshots_at_the_call(tmp_path):
    """The async save copies the tree on the caller's thread: a later
    in-place change does not reach the file."""
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=True)
    w = torch.zeros(1000)
    mgr.save(1, {"w": w})
    w.add_(1.0)
    mgr.wait()
    assert mgr.restore(device="cpu")[0]["w"].sum() == 0


# -------------------------------------------------------------- train loop

def test_train_loop_resume_is_bit_identical(tmp_path):
    """6 steps straight equal 3 steps and a resume for 3 more, bit for bit
    on the CPU (params, every optimizer leaf and the pipeline position).
    All 6 steps lie inside the 20-step warmup, so a 3-step schedule gives
    the same rates as a 6-step one (the reference's own test does 6 then 9)."""
    kw = dict(arch="small-llama", batch=2, seq=32, device="cpu", ckpt_every=3)
    p1, o1, m1 = train_mod.train_loop(steps=6, ckpt_dir=str(tmp_path / "a"), **kw)
    train_mod.train_loop(steps=3, ckpt_dir=str(tmp_path / "b"), **kw)
    assert CheckpointManager(str(tmp_path / "b")).all_steps() == [3]
    p2, o2, m2 = train_mod.train_loop(steps=6, ckpt_dir=str(tmp_path / "b"), **kw)
    assert int(o2.step) == 6
    for a, b in ((p1, p2), (o1.mu, o2.mu), (o1.nu, o2.nu), (o1.master, o2.master)):
        fa, fb = _flat(a), _flat(b)
        assert set(fa) == set(fb)
        for k in fa:
            assert torch.equal(fa[k], fb[k]), k
    assert float(m1["loss"]) == float(m2["loss"])
    (_, _), extra = load_checkpoint(str(tmp_path / "b" / "step_00000006"), "cpu")
    assert extra["pipeline"] == {"seed": 0, "step": 6, "domain": "en_a"}


def test_train_loop_grad_compress_stays_finite():
    _, opt, metrics = train_mod.train_loop(arch="small-llama", steps=4, batch=2, seq=32,
                                           grad_compress=True, device="cpu")
    assert np.isfinite(float(metrics["loss"])) and int(opt.step) == 4
    assert not bool(metrics["bad_step"])


def test_load_small_trains_when_no_checkpoint(tmp_path, monkeypatch):
    """No checkpoint under the models directory: ``load_small`` trains (the
    recipe at a patched 3 steps) on the CPU, saves in the reference's
    layout, and the reference's manager reads the same params back."""
    monkeypatch.setattr(serve_mod, "MODELS_DIR", str(tmp_path))
    monkeypatch.setattr(serve_mod, "train_small_lm",
                        functools.partial(train_mod.train_small_lm, steps=3, batch=2,
                                          log_every=1))
    params = serve_mod.load_small("small-llama", device="cpu")
    assert os.listdir(tmp_path / "small-llama") == ["step_00000000"]
    jtree, extra, step = JaxCheckpointManager(str(tmp_path / "small-llama")).restore()
    assert step == 0 and extra["steps"] == 3 and len(extra["losses"]) == 3
    assert set(_flat(jtree)) == set(_flat(params))
    for k, leaf in _flat(params).items():
        np.testing.assert_array_equal(np.asarray(_flat(jtree)[k]), leaf.numpy(), err_msg=k)
    again = serve_mod.load_small("small-llama", device="cpu")  # loads, no training
    assert all(torch.equal(a, b) for a, b in zip(_flat(again).values(),
                                                 _flat(params).values()))


# ------------------------------------------------------------------ chip_smoke

def test_chip_train_path_counts_hold_on_cpu(monkeypatch):
    """chip_smoke's train path: TRAIN_PREDICTED is one flash forward and one
    backward an attention layer and step (a train step on small-llama at
    (2, 16) makes exactly those calls, counted at the wrappers, and no
    nested, paged, rwkv6 or gram call), and ``small_quality_expect`` is
    what ``build_entry`` calls at SMALL_QUALITY's batch shape (16 x 128:
    2048 rows, above the nested kernel's 1024-row gate) on a short run of
    one calibration batch and one eval batch a domain."""
    import chip_smoke as cs
    import repro_torch.calib.gram as calib_gram
    import repro_torch.kernels.nested_lowrank.ops as nlr
    from repro_torch.models import attention
    from repro_torch.obs.quality_report import build_entry

    calls = Counter()

    def counted(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    def routed(x, *a):
        rows = x.numel() // x.shape[-1]
        calls["nested_lowrank" if rows <= nlr.MAX_KERNEL_ROWS else "gate"] += 1
        return nested(x, *a)
    nested = nlr.nested_lowrank_matmul
    monkeypatch.setattr(attention, "flash_attention", counted("flash_attention",
                                                               attention.flash_attention))
    monkeypatch.setattr(attention, "paged_attention", counted("paged_attention",
                                                               attention.paged_attention))
    monkeypatch.setattr(fa_ops, "flash_attention_bwd_ref", counted(
        "flash_backward", fa_ops.flash_attention_bwd_ref))
    monkeypatch.setattr(calib_gram, "gram_accumulate", counted("gram",
                                                               calib_gram.gram_accumulate))
    monkeypatch.setattr(nlr, "nested_lowrank_matmul", routed)
    cfg = get_config("small-llama")
    model = build_model(cfg)
    params = model.init(0, "cpu")
    step = make_train_step(model, optim.AdamWConfig(), StepConfig(chunked_loss=8))
    opt = optim.init_state(params)
    pipe = LMDataPipeline(cfg.vocab_size, 2, 16, PipelineState(0, 0, "mix"), device="cpu")
    for _ in range(2):
        params, opt, _ = step(params, opt, next(pipe))
    assert dict(calls) == {"flash_attention": 2 * cfg.num_layers,
                           "flash_backward": 2 * cfg.num_layers}
    assert cs.TRAIN_PREDICTED["small_llama"]["flash_attention"] == cfg.num_layers * 300
    assert cs.TRAIN_PREDICTED["mistral"]["flash_backward"] == cs.TRAIN_LAYERS * (
        2 + 2 * cs.TRAIN_RESUME_STEPS)
    for pred in (cs.TRAIN_PREDICTED["mistral"], cs.TRAIN_PREDICTED["small_llama"]):
        assert pred["flash_attention"] == pred["flash_backward"]
        assert not any(pred[k] for k in ("nested_lowrank", "paged_attention", "rwkv6",
                                         "rwkv6_backward", "gram"))
    # Which backward kernels each path runs: the one ``bwd_plan`` picks for
    # its config (Mistral bf16 at hd 128 on the tensor cores, small-llama
    # fp32 on CUDA cores), every call, and the other none.
    kinds = {}
    for path, pcfg in (("mistral", get_config("mistral-7b")), ("small_llama", cfg)):
        pred = cs.TRAIN_PREDICTED[path]
        kinds[path] = fa_ops.bwd_plan(getattr(torch, pcfg.dtype), pcfg.head_dim,
                                      pcfg.num_heads // pcfg.num_kv_heads).kernel
        other = {"tensor_core": "cuda_core", "cuda_core": "tensor_core"}[kinds[path]]
        assert pred[f"flash_backward_{kinds[path]}"] == pred["flash_backward"]
        assert pred[f"flash_backward_{other}"] == 0
    assert kinds == {"mistral": "tensor_core", "small_llama": "cuda_core"}
    calls.clear()
    q = dict(cs.SMALL_QUALITY, eval_n_batches=1, calib_samples=16)
    entry = build_entry(cfg, params=params, device="cpu", **q)
    expect = cs.small_quality_expect(cfg, model, q)
    assert calls["gate"] > 0
    del calls["gate"]
    assert {k: calls.get(k, 0) for k in expect if k != "rwkv6"} == {
        k: v for k, v in expect.items() if k != "rwkv6"}
    assert entry["decomposition"]["whitened_rel_err_mean"] < entry["decomposition"][
        "plain_rel_err_mean"]
