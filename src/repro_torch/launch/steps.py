"""Serving step builders, with batched sampling and device-side finish
exits: the paged decode step and the paged prefill-chunk step (attention
stacks), and the dense-slab decode step and prefill-admit step (the
pad-sensitive stacks: RWKV-6's recurrent state, token-choice MoE's K/V
slab).

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
"""

from __future__ import annotations

from typing import Callable

import torch

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

    return decode_sample_step


# Dense-slab cache leaves: name -> ndim of one layer's leaf; a stacked group
# adds a leading layer dim, so the batch axis is ndim - base.
_CACHE_LEAF_NDIM = {"state": 4, "shift_t": 2, "shift_c": 2, "k": 4, "v": 4}


def set_cache_rows(cache, rows, slots: torch.Tensor) -> None:
    """Write R per-row cache slices ``rows`` into batch rows ``slots`` (R,)
    of ``cache``, in place, one index_copy_ per leaf.  Every slot must be a
    real row: the port admits dense-layout requests one at a time, so it
    has no padding rows to drop."""
    idx = slots.long()
    for name, c in cache.items():
        if isinstance(c, dict):
            set_cache_rows(c, rows[name], slots)
        else:
            c.index_copy_(c.ndim - _CACHE_LEAF_NDIM[name], idx, rows[name].to(c.dtype))


def make_prefill_admit_step(model, max_len: int) -> Callable:
    """Admission of R requests in one call: prefill R prompts of one exact
    length (R, P) into a FRESH row cache, write its rows into the engine
    cache at ``slots`` (replacing any previous occupant's rows wholesale),
    set per-slot length / last token / budget / key / active, and sample
    each row's first token from its last position.  The engine calls it
    with R = 1: a recurrent state folds in every position, and MoE
    capacity is budgeted over the call's tokens, so prompts of other
    lengths cannot share a padded call."""

    @torch.no_grad()
    def prefill_admit_step(params, cache, tokens, slots, budgets, row_keys,
                           cache_len, last_token, budget, key_data, temps,
                           active):
        r, plen = tokens.shape
        row_cache = model.init_cache(r, max_len, device=tokens.device)
        logits = model.apply(params, tokens, mode="prefill", cache=row_cache)
        row_keys, first = sample_tokens(row_keys, logits[:, -1], temps)
        set_cache_rows(cache, row_cache, slots)
        idx = slots.long()

        def put(state, vals):
            return state.index_copy(0, idx, vals.to(state.dtype))

        return (first, put(cache_len, torch.full_like(idx, plen)), put(last_token, first),
                put(budget, budgets), put(key_data, row_keys),
                put(active, torch.ones_like(idx, dtype=torch.bool)))

    return prefill_admit_step


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

    return paged_decode_step


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

    return paged_prefill_chunk_step
