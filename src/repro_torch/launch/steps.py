"""Serving step builders, with batched sampling and device-side finish
exits: the paged decode step and the paged prefill-chunk step (attention
stacks), the dense-slab decode step and prefill-admit step (RWKV-6's
recurrent state, token-choice MoE's K/V slab, MLA's latent slab, and any
attention stack served with ``paged=False``), and speculative decoding's
draft and verify roots with the draft's two prefill twins; and the
reference's plain serve steps (``make_prefill_step``, ``make_decode_step``:
no sampling, no slots), the one way an encoder-decoder model decodes,
since the serving engine has no encoder-decoder path.

All per-slot state lives on the device: cache_len, last_token, budget,
sampling keys and active flags.  A decode step samples every live row,
advances lengths and budgets, and clears ``active`` for a row that sampled
its eos id, spent its budget, or reached the max_len-1 cache bound — on the
device, in the same step — and a row whose logits are not all finite
reports ``POISON_TOKEN`` in place of a token and retires itself too.  The host learns of finishes from the one token
vector it copies per step.

Sampling keys: greedy rows take the argmax, bit for bit the reference's.
Temperature rows cannot reproduce the reference's threefry streams; each
row instead draws Gumbel noise from a counter-based hash of (request key,
draw counter, vocab id), where the request key hashes (engine seed, uid).
So a stream depends only on (seed, uid, prompt) — not on slot, batch or
admission timing — which is the invariant the reference pins.

Every root a ``make_*`` function returns is wrapped in
``obs.profiler.wrap_root`` under the reference's root name
(``serving_root.paged_decode``, ...), so a profiler timeline names the
root each launch came from.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.models.api import CACHE_LEAF_NDIM, batch_inputs
from repro_torch.models.losses import chunked_xent_from_hidden, next_token_xent
from repro_torch.obs.profiler import wrap_root
from repro_torch.optim import AdamWConfig, apply_updates, roundtrip, state_pspecs
from repro_torch.optim.adamw import tree_leaves, tree_map, tree_unflatten
from repro_torch.parallel.sharding import (NamedSharding, P, Parallelism, mesh_axis_sizes,
                                           param_pspecs, param_shardings, sanitized)
from repro_torch.runtime.fault import GuardConfig, guarded_update

_M32 = 0xFFFFFFFF


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer on int64 tensors holding 32-bit values
    (products wrap mod 2**64; the mask keeps the low 32 bits exact)."""
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _M32
    return h ^ (h >> 16)


def request_keys(seed: int, uids, device) -> torch.Tensor:
    """(N, 2) int64 key data [request key, draw counter = 0] per request."""
    u = torch.as_tensor(list(uids), dtype=torch.int64, device=device)
    key = _fmix32((_fmix32(torch.full_like(u, seed & _M32)) ^ (u & _M32)) & _M32)
    return torch.stack([key, torch.zeros_like(key)], dim=1)


def _uniform(key_data: torch.Tensor, vocab: int) -> torch.Tensor:
    """(B, V) uniforms in (0, 1) for each row's current draw."""
    base = _fmix32(key_data[:, 0] ^ _fmix32((key_data[:, 1] + 0x632BE5AB) & _M32))
    col = (torch.arange(vocab, device=key_data.device, dtype=torch.int64)
           * 0x27D4EB2D) & _M32
    bits = _fmix32(base[:, None] ^ col[None, :])
    return (bits.double() + 0.5) / 4294967296.0


def sample_tokens(key_data: torch.Tensor, logits: torch.Tensor,
                  temps: torch.Tensor):
    """Greedy where temps <= 0, categorical at logits/temp otherwise.
    key_data (B, 2) int64, logits (B, V), temps (B,) fp32.
    Returns (advanced key_data, tokens (B,) int32)."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    # Drawn for every row (no host-side branch: a step syncs only once).
    gumbel = -torch.log(-torch.log(_uniform(key_data, logits.shape[-1])))
    scaled = logits.float() / temps.clamp(min=1e-6)[:, None]
    drawn = torch.argmax(scaled.double() + gumbel, dim=-1).to(torch.int32)
    tok = torch.where(temps > 0, drawn, greedy)
    new_kd = key_data.clone()
    new_kd[:, 1] += 1
    return new_kd, tok


@dataclasses.dataclass(frozen=True)
class StepConfig:
    aux_weight: float = 0.01  # MoE load-balance loss weight
    chunked_loss: int = 0  # >0: seq-chunked xent (memory optimization)
    grad_compress: bool = False  # int8+error-feedback gradients
    guard: Optional[GuardConfig] = GuardConfig()


def make_grad_fn(model, step_cfg: StepConfig = StepConfig()) -> Callable:
    """``grad_fn(params, batch)`` -> (total, loss, aux, grads): the train
    step's loss (next-token cross-entropy over ``batch["loss_mask"]`` when
    given, sequence-chunked from the hidden states with ``chunked_loss``,
    plus ``aux_weight`` times the MoE layers' load-balance loss) and its
    gradient from ``torch.autograd.grad`` over every param leaf; a leaf
    the loss does not reach gets zeros, as ``jax.grad`` gives."""
    cfg = model.cfg

    def loss_fn(params, batch):
        device = params["embed"]["table"].device
        tokens, kwargs = batch_inputs(model, batch, device)
        mask = batch.get("loss_mask") if isinstance(batch, dict) else None
        if mask is not None:
            mask = torch.as_tensor(mask, device=device)
        auxs: list = []
        if step_cfg.chunked_loss and not cfg.is_encdec:
            hidden = model.apply(params, tokens, mode="train", output="hidden", aux=auxs,
                                 **kwargs)
            loss = chunked_xent_from_hidden(hidden, params.get("unembed", params["embed"]),
                                            tokens, chunk=step_cfg.chunked_loss, mask=mask)
        else:
            logits = model.apply(params, tokens, mode="train", aux=auxs, **kwargs)
            loss = next_token_xent(logits, tokens, mask)
        aux = (torch.stack(auxs).sum() if auxs
               else torch.zeros((), dtype=torch.float32, device=device))
        return loss + step_cfg.aux_weight * aux, loss, aux

    def grad_fn(params, batch):
        with torch.enable_grad():
            live = tree_map(lambda p: p.detach().requires_grad_(), params)
            leaves = tree_leaves(live)
            total, loss, aux = loss_fn(live, batch)
            flat = torch.autograd.grad(total, leaves, allow_unused=True)
        grads = tree_unflatten(params, iter([
            torch.zeros_like(p) if g is None else g for g, p in zip(flat, leaves)]))
        return total.detach(), loss.detach(), aux.detach(), grads

    return grad_fn


def make_train_step(model, opt_cfg: AdamWConfig,
                    step_cfg: StepConfig = StepConfig()) -> Callable:
    """The reference's train step: ``train_step(params, opt_state, batch[,
    grad_error])`` -> ``(params, opt_state, metrics[, grad_error])``: the
    gradient of ``make_grad_fn``'s loss, then the optional int8 roundtrip
    with error feedback, AdamW, and the step guard, which keeps the old
    params and state on a corrupt step.  Metrics (grad_norm, lr, loss,
    aux, bad_step) are 0-d device tensors: the step reads nothing from the
    host."""
    grad_fn = make_grad_fn(model, step_cfg)

    def train_step(params, opt_state, batch, grad_error=None):
        _, loss, aux, grads = grad_fn(params, batch)
        with torch.no_grad():
            new_error = grad_error
            if step_cfg.grad_compress:
                grads, new_error = roundtrip(grads, grad_error)
            new_params, new_opt, metrics = apply_updates(params, grads, opt_state, opt_cfg)
            metrics = dict(metrics, loss=loss, aux=aux)
            if step_cfg.guard is not None:
                (new_params, new_opt), bad = guarded_update(
                    loss, metrics["grad_norm"], (new_params, new_opt),
                    (params, opt_state), step_cfg.guard)
                metrics["bad_step"] = bad
        if step_cfg.grad_compress:
            return new_params, new_opt, metrics, new_error
        return new_params, new_opt, metrics

    return train_step


def make_prefill_step(model, max_len: int) -> Callable:
    """The reference's plain prefill: ``prefill_step(params, batch)`` builds
    a fresh (B, max_len) dense cache, runs ``batch["tokens"]`` (B, S)
    through it (with ``batch["frames"]`` for an encoder-decoder model,
    which also fills the cross slabs) and returns (the last position's
    logits (B, 1, V), the cache).  Batch arrays move to the params'
    device."""

    @torch.no_grad()
    def prefill_step(params, batch):
        device = params["embed"]["table"].device
        tokens, kwargs = batch_inputs(model, batch, device)
        cache = model.init_cache(tokens.shape[0], max_len, device=device)
        logits = model.apply(params, tokens, mode="prefill", cache=cache, **kwargs)
        return logits[:, -1:], cache

    return prefill_step


def make_decode_step(model) -> Callable:
    """The reference's plain decode: ``decode_step(params, cache, batch)``
    runs ``batch["tokens"]`` (B, 1) at ``batch["cache_len"]`` (B,) through
    the cache, written in place, and returns (logits (B, 1, V), cache)."""

    @torch.no_grad()
    def decode_step(params, cache, batch):
        device = params["embed"]["table"].device
        logits = model.apply(params, torch.as_tensor(batch["tokens"], device=device),
                             mode="decode", cache=cache,
                             cache_len=torch.as_tensor(batch["cache_len"], device=device))
        return logits, cache

    return decode_step


# The poison sentinel in the token word a decode step copies to the host.
# Sampled ids are >= 0 and the disabled-eos sentinel is -1, so -2 is free:
# a live row whose logits are not all finite reports POISON_TOKEN instead
# of a token and clears its own active flag, so the host learns of it from
# the copy it already makes (no extra transfer, no host check).
POISON_TOKEN = -2


def _sample_advance_exit(logits, last_token, cache_len, budget, key_data,
                         active, host_keep, temps, eos, max_len):
    """Sampling, inactive-row freezing, length advance and the device-side
    finish update (EOS, exhausted budget, or the max_len-1 cache bound),
    with the always-on finite check: a live row with a NaN or Inf logit
    reports ``POISON_TOKEN`` and retires itself.  Healthy rows take their
    sampled values unchanged (the selects pass them through bit for bit)."""
    act = active & host_keep
    bad = act & ~torch.isfinite(logits[:, 0]).all(-1)
    new_kd, sampled = sample_tokens(key_data, logits[:, 0], temps)
    sampled = torch.where(act, sampled, last_token)
    sampled = torch.where(bad, POISON_TOKEN, sampled)
    key_data = torch.where(act[:, None], new_kd, key_data)
    adv = act.to(torch.int32)
    cache_len = cache_len + adv
    budget = budget - adv
    alive = (budget > 0) & (cache_len < max_len - 1)
    new_active = act & (sampled != eos) & alive & ~bad
    active = torch.where(host_keep, new_active, active)
    return sampled, cache_len, budget, key_data, active


def make_decode_sample_step(model, max_len: int) -> Callable:
    """One decode step over the dense cache slab for all max_batch rows.
    Rows that are not effectively active decode garbage into their own slab
    rows; that is harmless because admission replaces a slot's rows
    wholesale (``set_cache_rows``), and it needs no data-dependent
    selection (which would sync with the host).  Their token, length,
    budget and key stay frozen in ``_sample_advance_exit``.

    ``poison`` (optional, (B,) fp32) is added to the logits: the fault
    harness's NaN row.  A zero vector leaves finite logits exactly as they
    were (bf16 logits promote to fp32, which sampling uses anyway)."""

    @torch.no_grad()
    def decode_sample_step(params, cache, last_token, cache_len, budget, key_data,
                           active, host_keep, temps, eos, poison=None):
        logits = model.apply(params, last_token[:, None], mode="decode",
                             cache=cache, cache_len=cache_len)
        if poison is not None:
            logits = logits + poison[:, None, None]
        return _sample_advance_exit(logits, last_token, cache_len, budget,
                                    key_data, active, host_keep, temps, eos,
                                    max_len)

    return wrap_root(decode_sample_step, "decode")


# Dense-slab cache leaves: name -> ndim of one layer's leaf; a stacked group
# adds a leading layer dim, so the batch axis is ndim - base.
_CACHE_LEAF_NDIM = CACHE_LEAF_NDIM


def _drop_pad_rows(slots: torch.Tensor, n: int):
    """(dst, src) int64 index vectors that write row r of an admission's
    R rows to slot ``slots[r]``, and drop the rows whose slot is >= n (the
    reference's mode="drop" for padding rows): a padding row writes the
    first real row's values to that row's slot again, so a duplicate index
    always stores equal values and no selection depends on the data (which
    would sync with the host).  At least one row must be real."""
    real = slots.long() < n
    first = torch.argmax(real.to(torch.int32))
    rows = torch.arange(slots.shape[0], device=slots.device)
    src = torch.where(real, rows, first)
    return slots.long().index_select(0, src), src


def set_cache_rows(cache, rows, dst: torch.Tensor, src: torch.Tensor) -> None:
    """Write row ``src[i]`` of the per-row cache slices ``rows`` into batch
    row ``dst[i]`` of ``cache``, in place, one index_copy_ per leaf (the
    index pair of ``_drop_pad_rows``)."""
    for name, c in cache.items():
        if isinstance(c, dict):
            set_cache_rows(c, rows[name], dst, src)
        else:
            ax = c.ndim - _CACHE_LEAF_NDIM[name]
            c.index_copy_(ax, dst, rows[name].index_select(ax, src).to(c.dtype))


def make_prefill_admit_step(model, max_len: int, kv_quant: bool = False) -> Callable:
    """Admission of R requests in one call: prefill R prompts right-padded
    to a shared length P (``tokens`` (R, P), ``plens`` (R,) their real
    lengths) into a FRESH row cache, write its rows into the engine cache at
    ``slots`` (replacing any previous occupant's rows wholesale), set
    per-slot length (``plens``) / last token / budget / key / active, and
    sample each row's first token from its last REAL position.  Rows whose
    slot is >= the slot count are padding: every write of theirs drops, so
    a pad-safe model's admissions keep one (max_batch, P) shape per prompt
    bucket.  Padding positions are written into the slab but lie at or past
    cache_len, where attention masks them and the next decode overwrites
    them.  The engine calls a pad-sensitive model (a recurrent state folds
    in every position, MoE capacity is budgeted over the call's tokens)
    with one exact-length request a call.  One cache tree may mix both
    kinds of leaf (jamba: the Mamba layers' ``h`` and ``conv`` beside the
    attention layer's ``k`` and ``v``); each is written by its own rank.
    ``kv_quant``: the engine's slab is int8 (the fresh row cache too)."""

    @torch.no_grad()
    def prefill_admit_step(params, cache, tokens, plens, slots, budgets, row_keys,
                           cache_len, last_token, budget, key_data, temps,
                           active):
        r = tokens.shape[0]
        row_cache = model.init_cache(r, max_len, device=tokens.device, kv_quant=kv_quant)
        logits = model.apply(params, tokens, mode="prefill", cache=row_cache)
        rows = torch.arange(r, device=tokens.device)
        last = logits[rows, (plens.long() - 1).clamp(min=0)]
        row_keys, first = sample_tokens(row_keys, last, temps)
        dst, src = _drop_pad_rows(slots, cache_len.shape[0])
        set_cache_rows(cache, row_cache, dst, src)

        def put(state, vals):
            return state.index_copy(0, dst, vals.index_select(0, src).to(state.dtype))

        return (first, put(cache_len, plens), put(last_token, first),
                put(budget, budgets), put(key_data, row_keys),
                put(active, torch.ones_like(slots, dtype=torch.bool)))

    return wrap_root(prefill_admit_step, "prefill_admit")


def make_paged_decode_step(model, max_len: int) -> Callable:
    """One decode step over the paged cache for every slot.  Rows that are
    not effectively active get their table row forced to -1 (their cache
    writes drop: a freed slot's blocks may already belong to another
    request) and their attention length to cache_len 0.

    The model runs its rows in the scheduler's ``row_order`` (a
    permutation of the slots, int64; None keeps slot order); the logits
    are put back in slot order before sampling, and every state tensor
    stays in slot order.
    Each row's arithmetic does not depend on its position, so the order
    leaves every token unchanged.  ``poison`` as in
    ``make_decode_sample_step``, added in slot order."""

    @torch.no_grad()
    def paged_decode_step(params, pools, block_tables, last_token, cache_len,
                          budget, key_data, active, host_keep, temps, eos,
                          row_order, poison=None):
        act = active & host_keep
        bt_eff = torch.where(act[:, None], block_tables,
                             torch.full_like(block_tables, -1))
        cl_eff = torch.where(act, cache_len, torch.zeros_like(cache_len))
        tok = last_token
        if row_order is not None:
            tok, cl_eff, bt_eff = (t.index_select(0, row_order)
                                   for t in (last_token, cl_eff, bt_eff))
        logits = model.apply(params, tok[:, None], mode="decode", cache=pools,
                             cache_len=cl_eff, block_tables=bt_eff)
        if row_order is not None:
            logits = logits.index_select(0, torch.argsort(row_order))
        if poison is not None:
            logits = logits + poison[:, None, None]
        return _sample_advance_exit(logits, last_token, cache_len, budget,
                                    key_data, active, host_keep, temps, eos,
                                    max_len)

    return wrap_root(paged_decode_step, "paged_decode")


def make_paged_prefill_chunk_step(model) -> Callable:
    """One chunk of streaming prefill for up to R requests at once: row r
    writes ``tokens[r]`` at positions starts[r].. of its table row and
    attends causally over its own prefix.  Only ``nvalid[r]`` leading tokens
    are real; ``fslots[r]`` is the row's engine slot when this chunk
    finishes its prompt (>= the slot count otherwise, dropped): finishing
    rows commit cache_len/last_token/budget/key/active and sample their
    first token from the last real position's logits."""

    @torch.no_grad()
    def paged_prefill_chunk_step(params, pools, bt_rows, tokens, starts,
                                 nvalid, fslots, budgets, row_keys, cache_len,
                                 last_token, budget, key_data, temps, active):
        logits = model.apply(params, tokens, mode="decode", cache=pools,
                             cache_len=starts, block_tables=bt_rows)
        idx = (nvalid.long() - 1).clamp(min=0)
        last = logits[torch.arange(logits.shape[0], device=logits.device), idx]
        row_keys, first = sample_tokens(row_keys, last, temps)
        n = cache_len.shape[0]
        # Non-finishing rows write to a scratch slot n that is cut off again
        # (a sync-free "drop"; boolean indexing would sync with the host).
        s = fslots.long().clamp(max=n)

        def put(state, vals):
            ext = torch.cat([state, state[:1]])
            ext[s] = vals.to(state.dtype)
            return ext[:n]

        return (first, put(cache_len, starts + nvalid), put(last_token, first),
                put(budget, budgets), put(key_data, row_keys),
                put(active, torch.ones_like(fslots, dtype=torch.bool)))

    return wrap_root(paged_prefill_chunk_step, "paged_prefill_chunk")


# ------------------------------------------------- speculative decoding
#
# Self-speculative roots (serving/spec): the draft root runs k+1 sequential
# S=1 decodes of the DRAFT model over the draft's cache in one call (no
# host round trip: the proposals and draft probs stay on the device and
# flow into the verify root), and the verify root feeds the proposals
# through the target's S>1 chunk-decode path, accepts or resamples on the
# device (serving/spec/verify.py) and advances each row's length by what
# it committed.  The length IS the cache rollback: entries past cache_len
# are invisible to attention and overwritten by the next chunk.  Both roots
# take ``block_tables=None`` for the dense slab (its decode path takes
# S >= 1 chunks).


def make_spec_draft_step(model, k: int) -> Callable:
    """Draft root: k+1 sequential single-token decodes of the DRAFT model
    (feed t0, sample d_1; ... feed d_{k-1}, sample d_k; feed d_k to cache
    it), returning the (B, k) proposals and the (B, k, V) fp32 draft probs
    the verifier needs.  Feeding all k+1 tokens keeps the draft cache a
    superset of every committable prefix, so draft and target lengths stay
    equal and no catch-up chunk exists.  The last forward only writes the
    cache (``output="hidden"``: no unembed, no sample), so a row's draft
    key advances k draws a step.  Inactive rows' paged writes drop through
    the -1-forced table; their dense writes land at the head of their own
    slab row, which admission rewrites wholesale.  The draft cache is
    written in place."""

    @torch.no_grad()
    def spec_draft_step(params, pools, block_tables, last_token, cache_len,
                        key_data, active, host_keep, temps):
        act = active & host_keep
        bt_eff = None
        if block_tables is not None:
            bt_eff = torch.where(act[:, None], block_tables,
                                 torch.full_like(block_tables, -1))
        # Dead rows attend at length 0 and their key chain freezes.
        cl_eff = torch.where(act, cache_len, torch.zeros_like(cache_len))
        tok, kd = last_token, key_data
        toks, qs = [], []
        for i in range(k + 1):
            out = model.apply(params, tok[:, None], mode="decode", cache=pools,
                              cache_len=cl_eff + i, block_tables=bt_eff,
                              output="logits" if i < k else "hidden")
            if i == k:
                break
            lg = out[:, 0]
            qs.append(torch.softmax(lg.float() / temps.clamp(min=1e-6)[:, None], dim=-1))
            kd, tok = sample_tokens(kd, lg, temps)
            toks.append(tok)
        key_data = torch.where(act[:, None], kd, key_data)
        return torch.stack(toks, dim=1), torch.stack(qs, dim=1), key_data

    return wrap_root(spec_draft_step, "spec_draft")


def make_spec_verify_step(model, k: int, max_len: int) -> Callable:
    """Verify root: the target on [t0, d_1..d_k] (one S=k+1 chunk decode:
    the paged S>1 path over gathered pages, or the slab's chunk), the
    always-on finite check, accept/resample on the device (greedy = exact
    prefix match; temperature = Leviathan accept u < p/q with residual
    resample), each row's cache_len advanced by the m+1 committed entries
    [t0, d_1..d_m] (the cache-rollback contract), and the finish scan over
    the committed tokens (EOS, exhausted ``budget``, or the max_len-1
    bound, as the plain decode root), so pipelined spec steps stay
    depth-invariant.  ``poison`` as in ``make_decode_sample_step``.

    Returns one packed int32 matrix for the step's ONE device-to-host copy,
    ``[out_tokens (k+1) | n_commit | m]`` per row: out_tokens is [d_1..d_m,
    t_new, fill], n_commit truncates at the first committed EOS (-1: the
    row's logits were not all finite; it commits nothing and retires
    itself), and m is the raw acceptance count for the accounting.  Then
    cache_len, the new last token, budget, key_data and active."""
    from repro_torch.serving.spec.verify import verify_tail

    @torch.no_grad()
    def spec_verify_step(params, pools, block_tables, last_token, proposals,
                         q_probs, cache_len, budget, key_data, active,
                         host_keep, temps, eos, k_row, poison=None):
        act = active & host_keep
        bt_eff = None
        if block_tables is not None:
            bt_eff = torch.where(act[:, None], block_tables,
                                 torch.full_like(block_tables, -1))
        chunk = torch.cat([last_token[:, None], proposals], dim=1)
        logits = model.apply(params, chunk, mode="decode", cache=pools,
                             cache_len=cache_len, block_tables=bt_eff)
        if poison is not None:
            logits = logits + poison[:, None, None]
        bad = act & ~torch.isfinite(logits).flatten(1).all(dim=1)
        new_kd, m, t_new, out_tokens = verify_tail(key_data, logits, q_probs,
                                                   proposals, temps, k_row)
        # Dead rows freeze their keys, so extra pipelined dispatches cannot
        # perturb a reused slot's chain.
        key_data = torch.where(act[:, None], new_kd, key_data)
        t_new = torch.where(act, t_new, last_token)
        n_raw = torch.where(act, m + 1, torch.zeros_like(m))
        cache_len = cache_len + n_raw
        idx = torch.arange(k + 1, device=chunk.device)[None, :]
        is_eos = (out_tokens == eos[:, None]) & (idx < n_raw[:, None])
        any_eos = is_eos.any(dim=1)
        first_eos = torch.argmax(is_eos.to(torch.int32), dim=1).to(torch.int32) + 1
        n_commit = torch.where(any_eos, first_eos, n_raw)
        # Poisoned rows commit nothing: the budget freezes and the pack
        # carries -1 in place of a commit count.
        budget = budget - torch.where(bad, torch.zeros_like(n_commit), n_commit)
        n_commit = torch.where(bad, torch.full_like(n_commit, -1), n_commit)
        alive = (budget > 0) & (cache_len < max_len - 1)
        # A host-masked (stalled) row keeps its active flag frozen.
        new_active = act & ~any_eos & alive & ~bad
        active = torch.where(host_keep, new_active, active)
        m_out = torch.where(act & ~bad, m, torch.zeros_like(m))
        pack = torch.cat([out_tokens, n_commit[:, None], m_out[:, None]], dim=1)
        return pack, cache_len, t_new, budget, key_data, active

    return wrap_root(spec_verify_step, "spec_verify")


def make_paged_draft_prefill_step(model) -> Callable:
    """Draft twin of the paged prefill-chunk root: stream the SAME token
    chunk into the draft pools through the draft's table rows
    (``output="hidden"``: no unembed, no sampling), and set finishing rows'
    draft keys to their requests' own chains (``fslots`` as in the chunk
    root: >= the slot count drops).  Writes past a row's draft reservation
    drop on -1 table entries."""

    @torch.no_grad()
    def paged_draft_prefill_step(params, pools, bt_rows, tokens, starts, fslots,
                                 key_data, row_keys):
        model.apply(params, tokens, mode="decode", cache=pools, cache_len=starts,
                    block_tables=bt_rows, output="hidden")
        n = key_data.shape[0]
        ext = torch.cat([key_data, key_data[:1]])
        ext[fslots.long().clamp(max=n)] = row_keys
        return ext[:n]

    return wrap_root(paged_draft_prefill_step, "draft_prefill")


def make_dense_draft_prefill_step(model, max_len: int, kv_quant: bool = False) -> Callable:
    """Draft twin of the dense prefill-admit root: prefill the same padded
    (R, P) prompt batch through the DRAFT params into a fresh row cache,
    write its rows into the draft slab at ``slots``, and set the admitted
    rows' draft keys to their requests' chains; padding rows (slot >= the
    slot count) drop every write, as in admission.  Padding positions lie
    past the row's length, which the target's cache_len (shared) masks."""

    @torch.no_grad()
    def dense_draft_prefill_step(params, cache, tokens, slots, key_data, row_keys):
        row_cache = model.init_cache(tokens.shape[0], max_len, device=tokens.device,
                                     kv_quant=kv_quant)
        model.apply(params, tokens, mode="prefill", cache=row_cache, output="hidden")
        dst, src = _drop_pad_rows(slots, key_data.shape[0])
        set_cache_rows(cache, row_cache, dst, src)
        return key_data.index_copy(0, dst, row_keys.index_select(0, src))

    return wrap_root(dense_draft_prefill_step, "draft_prefill")


# -------------------------------------------------------------- shardings
#
# The reference's partition specs for caches, batches, logits and the train
# step, and its serving placement bundle.  The port runs explicit SPMD, so
# a spec says what each rank holds (``NamedSharding.local_slice``), not
# what a jit boundary pins.

# KV caches are SEQUENCE-sharded over the model axis (context parallelism)
# in the reference's train-time specs; batch == 1 long-context cells fold the
# DP axes into the sequence dim instead.
_CACHE_LEAF_RULES = {
    # leaf name -> (base ndim, seq_dim, chan_dim)
    "k": (4, 1, None),
    "v": (4, 1, None),
    "c_kv": (3, 1, None),
    "k_rope": (3, 1, None),
    "h": (3, None, 1),
    "conv": (3, None, 2),
    "state": (4, None, 1),
    "shift_t": (2, None, None),
    "shift_c": (2, None, None),
    "k_scale": (3, 1, None),
    "v_scale": (3, 1, None),
}


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = mesh_axis_sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def _map_specs(fn, specs, shapes):
    if isinstance(specs, dict):
        return {k: _map_specs(fn, specs[k], shapes[k]) for k in specs}
    return fn(specs, shapes)


def cache_pspecs(cache_shapes, par: Parallelism):
    """PartitionSpec tree for a cache tree (stack dims -> None prefix)."""
    mesh = par.mesh
    dp = par.dp
    tp = par.tp_axis

    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        base_ndim, seq_dim, chan_dim = _CACHE_LEAF_RULES[name]
        pad = len(tree.shape) - base_ndim
        spec = [None] * len(tree.shape)
        shape = tree.shape
        b = shape[pad]
        batch_ok = mesh is None or b % _axis_size(mesh, dp) == 0
        if batch_ok and mesh is not None:
            spec[pad] = dp
        if seq_dim is not None and mesh is not None:
            t = shape[pad + seq_dim]
            if batch_ok:
                if t % _axis_size(mesh, tp) == 0:
                    spec[pad + seq_dim] = tp
            else:
                # batch=1 long-context: fold DP axes into the sequence dim.
                all_axes = tuple(par.dp_axes) + (tp,)
                if t % _axis_size(mesh, all_axes) == 0:
                    spec[pad + seq_dim] = all_axes
                elif t % _axis_size(mesh, tp) == 0:
                    spec[pad + seq_dim] = tp
        if chan_dim is not None and mesh is not None:
            c = shape[pad + chan_dim]
            if c % _axis_size(mesh, tp) == 0:
                spec[pad + chan_dim] = tp
        return P(*spec)

    return walk(cache_shapes)


def batch_pspecs(batch_shapes, par: Parallelism):
    mesh = par.mesh

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        ok = mesh is None or tree.shape[0] % _axis_size(mesh, par.dp) == 0
        lead = par.dp if (ok and mesh is not None) else None
        return P(*([lead] + [None] * (len(tree.shape) - 1)))

    return walk(batch_shapes)


def logits_pspec(batch: int, vocab: int, par: Parallelism) -> P:
    mesh = par.mesh
    b_ok = mesh is not None and batch % _axis_size(mesh, par.dp) == 0
    v_ok = mesh is not None and vocab % _axis_size(mesh, par.tp_axis) == 0
    return P(par.dp if b_ok else None, None, par.tp_axis if v_ok else None)


def sanitize_pspecs(pspec_tree, shape_tree, mesh):
    """Drop sharding entries that don't divide the dim (every rank holds
    equal parts)."""
    sizes = mesh_axis_sizes(mesh)
    return _map_specs(lambda spec, leaf: sanitized(spec, leaf.shape, sizes),
                      pspec_tree, shape_tree)


def named(tree_pspec, mesh):
    if isinstance(tree_pspec, dict):
        return {k: named(v, mesh) for k, v in tree_pspec.items()}
    return NamedSharding(mesh, tree_pspec)


def _dp_entry(par: Parallelism, max_batch: int):
    """Spec entry for slot-indexed dims; None when the slots do not divide
    DP (every rank then runs every slot, and the engine keeps one pool
    shard so its bookkeeping matches)."""
    n = _axis_size(par.mesh, par.dp)
    return par.dp if max_batch % n == 0 else None


class ServingShardings:
    """What each rank of a serving mesh holds, as NamedSharding bundles (the
    reference pins them as its serving roots' in/out shardings): ``params``
    the param tree's (the rules, sanitized against the leaves' shapes:
    factored NSVD layers hold a slice of u's input and v's output dims),
    ``row`` per-slot state (B,) and ``mat`` / ``mat3`` per-slot matrices,
    split over DP when the slots divide it, ``rep`` what every rank holds
    whole, and ``cache`` the cache tree's as the caller gives it
    (``models.api.serving_cache_pspecs``; the engine allocates its shard
    directly and gives none).  On a (1, 1) mesh each is the whole tree."""

    def __init__(self, par: Parallelism, params, cache_shardings, max_batch: int):
        mesh = par.mesh
        dp = _dp_entry(par, max_batch)

        def ns(*spec):
            return NamedSharding(mesh, P(*spec))

        self.par = par
        self.max_batch = max_batch
        self.rep = ns()
        self.row = ns(dp)
        self.mat = ns(dp, None)
        self.mat3 = ns(dp, None, None)
        self.params = self.tree(params)
        self.cache = cache_shardings

    def tree(self, shapes):
        """Param shardings for a (possibly factored) params tree."""
        return param_shardings(shapes, self.par.mesh)

    def slot_range(self):
        """(first slot, stop) of the slots this rank runs."""
        sl = self.row.local_slice((self.max_batch,))[0]
        return sl.start, sl.stop


def train_shardings(params_shape, par: Parallelism, batch_shapes, fsdp: bool = False):
    """(in_shardings, out_shardings) pspec trees for the train step."""
    p_specs = param_pspecs(params_shape, fsdp_axes=par.dp_axes if fsdp else None)
    opt_specs = state_pspecs(params_shape, p_specs, par.dp_axes)
    b_specs = batch_pspecs(batch_shapes, par)
    metrics = {"loss": P(), "aux": P(), "grad_norm": P(), "lr": P(), "bad_step": P()}
    return (p_specs, opt_specs, b_specs), (p_specs, opt_specs, metrics)
