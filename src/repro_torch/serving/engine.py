"""Batched serving engine (continuous batching) over (compressed) weights
— the reference engine's scheduling policy and step pipeline — on either
of the reference's cache layouts, chosen by ``models.api.cache_layout``:

* "paged" (attention stacks): requests are admitted into free slots and
  their prompts stream into KV blocks ``prefill_chunk`` tokens per engine
  iteration (one fixed-shape chunk call for all prefilling rows).  The
  scheduling policy is ``serving/scheduler`` (the reference's default
  ``SchedulerConfig()``): on-demand admission reserves only the prompt's
  blocks and a live row's reservation grows at block boundaries (one
  block of slack when it fits, so the table re-uploads half as often);
  when growth or a higher-priority admission finds the pool dry, the row
  holding the most blocks is preempted and resumed later by re-prefill of
  prompt + generated, or by swapping its blocks to pinned host memory and
  back (CRC32-checked; a mismatch falls back to re-prefill).  Latency
  classes queue apart with aging; ``preempt=False`` stalls a starved row
  (frozen on the device) until blocks free.  ``admission="worst_case"``
  reserves prompt + max_new up front instead.  Decode rows run in the
  scheduler's order (longest first; ``sort_decode_rows``), which leaves
  every token unchanged.  ``defrag()`` compacts live blocks.
* "dense" (the pad-sensitive stacks: RWKV-6's recurrent state, and
  token-choice MoE, whose attention K/V live in a (max_batch, max_len)
  slab): one slab per cache leaf.  Each admission prefills ONE request at
  its exact length into a fresh row cache that then replaces its slot's
  rows wholesale (a recurrent state folds in every position, and MoE
  capacity is budgeted over a call's tokens, so prompts are never padded
  or bucketed).  ``paged=False`` puts a pure-attention stack on this
  layout too; ``paged=True`` is refused for a model whose layout is dense.

Every engine step decodes one token for all live rows, and finished rows
free their slot (and blocks) immediately, so new requests join mid-flight.

All per-slot state lives on the device (cache_len, last_token, budget,
sampling keys, active), and every finish (EOS, budget, max_len-1) is
decided there.  So the step loop is a ring of ``pipeline_depth`` in-flight
steps (default 2, or ``REPRO_SERVING_PIPELINE_DEPTH``): a step dispatches
its decode call and an asynchronous copy of its token vector into pinned
host memory, and the host waits on the OLDEST entry's copy only once the
ring is full.  Depth 1 is the unpipelined engine; every depth gives the
same tokens.  Admission, growth that must preempt, and defrag read a
synced view of the host's bookkeeping, so they drain the ring first.

Not ported yet (later slices): bucketed dense-slab admission (exact-length
admission serves every dense-layout model), speculative decoding, meshes,
the poison finite-check, deadlines, cancel and drain-on-shutdown, fault
injection, and the telemetry hooks.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import time
import zlib
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.launch.steps import (
    make_decode_sample_step,
    make_paged_decode_step,
    make_paged_prefill_chunk_step,
    make_prefill_admit_step,
    request_keys,
)
from repro_torch.models.api import cache_layout
from repro_torch.serving.kvcache import PagedKVCache, pool_leaves, upload
from repro_torch.serving.scheduler import Scheduler, SchedulerConfig

_PIPELINE_DEPTH_ENV = "REPRO_SERVING_PIPELINE_DEPTH"


def _swap_checksum(blocks) -> int:
    """CRC32 chained over a swap payload's host tensors (pool-leaf order),
    so a corrupted copy is caught at resume instead of scattered back."""
    crc = 0
    for b in blocks:
        crc = zlib.crc32(b.contiguous().view(torch.uint8).numpy(), crc)
    return crc


def _to_host(t: torch.Tensor):
    """(host copy of ``t``, event to wait on or None).  On the card the
    copy lands asynchronously in fresh pinned memory, so the caller's
    stream is not synchronised; on the CPU it is made at once."""
    if t.device.type != "cuda":
        return t.clone(), None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record()
    return host, ready


@dataclasses.dataclass
class _SwapPayload:
    """A preempted row's KV prefix on the host: the leading blocks of every
    pool leaf covering its committed context, and the row's sampling-key
    state, so its stream continues where eviction stopped."""
    n_ctx: int                  # committed context length the blocks cover
    n_blocks: int
    blocks: List[torch.Tensor]  # one per pool leaf (``pool_leaves`` order)
    key_row: torch.Tensor       # (2,) int64 key data
    checksum: int

    @property
    def nbytes(self) -> int:
        return sum(b.numel() * b.element_size() for b in self.blocks)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int = 32
    temperature: float = 0.0
    eos_id: Optional[int] = None
    generated: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    finish_reason: Optional[str] = None
    class_idx: int = 0  # the latency class's queue index (serving/scheduler)
    # Preemption: eviction count; a re-prefill resume folds ``generated``
    # into ``prompt`` (``prompt_absorbed`` of them so far); a swap resume
    # carries the host copy of the row's blocks.
    preemptions: int = 0
    prompt_absorbed: int = 0
    swap: Optional[_SwapPayload] = None

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens

    @property
    def prefix_len(self) -> int:
        """Tokens admission must cover: the prompt (re-prefill resumes fold
        generated tokens into it) or the swapped context length."""
        return self.swap.n_ctx if self.swap is not None else len(self.prompt)


@dataclasses.dataclass
class _PrefillTask:
    req: Request
    slot: int
    pos: int = 0  # next prompt position to feed


@dataclasses.dataclass
class _InFlight:
    """One dispatched, unconsumed decode step: the host tensor its token
    vector lands in, the event to wait on (None on the CPU), and the host's
    view of the live rows at dispatch.  FIFO consumption keeps the
    reference's invariant: a row live on the host at consume time was
    device-active at this entry's dispatch."""
    tokens: torch.Tensor
    ready: Optional[torch.cuda.Event]
    mask: np.ndarray
    dispatch_s: float


class ServingEngine:
    def __init__(self, model, params, max_batch: int = 8, max_len: int = 512,
                 seed: int = 0, block_size: int = 16,
                 num_blocks: Optional[int] = None, prefill_chunk: int = 64,
                 eos_id: Optional[int] = None, kv_quant: bool = False,
                 paged: Optional[bool] = None,
                 pipeline_depth: Optional[int] = None,
                 sched_config: Optional[SchedulerConfig] = None):
        if pipeline_depth is None:
            pipeline_depth = int(os.environ.get(_PIPELINE_DEPTH_ENV, "2"))
        if pipeline_depth < 1:
            raise ValueError(f"pipeline_depth must be >= 1, got {pipeline_depth}")
        self.pipeline_depth = pipeline_depth
        self.sched = Scheduler(sched_config)
        self.model = model
        self.params = params
        self.device = params["embed"]["table"].device
        self.max_batch = max_batch
        self.max_len = max_len
        self.seed = seed
        self.eos_id = eos_id
        self.prefill_chunk = prefill_chunk
        layout = cache_layout(model)
        if paged and layout != "paged":
            raise ValueError(
                f"model {model.cfg.name!r} has cache layout {layout!r}; "
                "paging requires a pure-attention cache (models.api.cache_layout)")
        self.layout = "dense" if paged is False else layout
        if self.layout == "paged":
            self.kv = PagedKVCache(model, max_batch, max_len, block_size=block_size,
                                   num_blocks=num_blocks, kv_quant=kv_quant,
                                   device=self.device)
            self._decode = make_paged_decode_step(model, max_len)
            self._chunk_step = make_paged_prefill_chunk_step(model)
        else:
            if kv_quant:
                raise ValueError(f"{model.cfg.name}: kv_quant quantizes paged "
                                 "attention K/V; this engine's cache is the dense slab")
            self.kv = None
            self.cache = model.init_cache(max_batch, max_len, device=self.device)
            self._decode = make_decode_sample_step(model, max_len)
            self._prefill = make_prefill_admit_step(model, max_len)

        dev = self.device
        self.cache_len = torch.zeros(max_batch, dtype=torch.int32, device=dev)
        self.last_token = torch.zeros(max_batch, dtype=torch.int32, device=dev)
        self.budget_dev = torch.zeros(max_batch, dtype=torch.int32, device=dev)
        self.key_data = torch.zeros((max_batch, 2), dtype=torch.int64, device=dev)
        self.active_dev = torch.zeros(max_batch, dtype=torch.bool, device=dev)

        # Host mirrors for scheduling, updated from bookkeeping and the one
        # token vector each step copies.  ``_dev_len`` mirrors each row's
        # DEVICE cache length at dispatch (``_len_host`` lags it by the
        # ring), so growth never undershoots a write the device is about
        # to make; ``_stalled`` rows are live but frozen (host_keep off).
        self.active = np.zeros(max_batch, bool)
        self.temps = np.zeros(max_batch, np.float32)
        self._eos = np.full(max_batch, -1, np.int32)
        self._len_host = np.zeros(max_batch, np.int64)
        self._dev_len = np.zeros(max_batch, np.int64)
        self._stalled = np.zeros(max_batch, bool)
        self._host_dirty = True
        self._host_dev = None

        self.slots: List[Optional[Request]] = [None] * max_batch
        self._prefilling: List[_PrefillTask] = []
        self._ring: deque[_InFlight] = deque()
        self._pending_finished: List[Request] = []
        self._uid = itertools.count()
        # Free slots are handed out in the order they freed (as the
        # reference does); token streams never depend on the slot.
        self._free_clock = itertools.count()
        self._freed_at = np.arange(max_batch, dtype=np.int64) - max_batch
        self.finished_requests: Dict[int, Request] = {}

        self.sched_events: Dict[str, int] = {
            "preemptions": 0, "swap_bytes": 0, "grown_blocks": 0,
            "resumes": 0, "stalls": 0}
        self.swap_fallbacks = 0
        self.priority_preemptions = 0
        self._occ_live_frac_sum = 0.0
        self._occ_samples = 0
        self._occ_rows_sum = 0
        self._occ_rows_steps = 0

        # Per consumed step: wall (dispatch + device wait + host), and its
        # three parts.
        self.step_times: List[float] = []
        self._dispatch_s: List[float] = []
        self._wait_s: List[float] = []
        self._host_s: List[float] = []
        self.prefill_ticks = 0
        self.host_syncs = 0    # decode consumes + first-token reads at admission
        self.decode_syncs = 0  # of which one per consumed decode step
        self.swap_syncs = 0    # swap-outs (apart from host_syncs)

    # ------------------------------------------------------------------ API

    @property
    def queue(self) -> Scheduler:
        """The admission queue (truthy while requests wait; ``len()``)."""
        return self.sched

    def submit(self, prompt, max_new_tokens: int = 32, temperature: float = 0.0,
               eos_id: Optional[int] = None,
               latency_class: Optional[str] = None) -> int:
        """Queue one request; returns its uid.  ``latency_class`` names one
        of the scheduler's priority classes (None: the lowest)."""
        prompt = np.asarray(prompt, np.int32)
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        if max_new_tokens <= 0:
            raise ValueError(f"max_new_tokens must be positive, got {max_new_tokens}")
        if len(prompt) > self.max_len - 1:
            raise ValueError(f"prompt length {len(prompt)} exceeds "
                             f"max_len-1={self.max_len - 1}")
        if self.kv is not None:
            # A worst case beyond the pool could never finish under either
            # policy; this bound is also what lets a preempted request
            # always resume.
            need = self.kv.blocks_for(min(self.max_len, len(prompt) + max_new_tokens))
            if need > self.kv.blocks_per_shard:
                raise ValueError(f"request needs {need} blocks worst-case but the "
                                 f"pool only has {self.kv.num_blocks}")
        req = Request(next(self._uid), prompt, max_new_tokens, temperature,
                      eos_id if eos_id is not None else self.eos_id,
                      class_idx=self.sched.class_index(latency_class))
        self.sched.submit(req)
        return req.uid

    def run(self, max_steps: int = 100_000) -> Dict[int, List[int]]:
        """Drive until queue, prefills and slots drain: uid -> generated.
        Admission runs only when it could progress: calling it while the
        batch is full or the pool backpressured would drain the ring every
        iteration."""
        finished: Dict[int, List[int]] = {}

        def take(reqs):
            for req in reqs:
                finished[req.uid] = req.generated

        for _ in range(max_steps):
            take(self._pop_finished())
            if self._admission_could_progress():
                take(self._admit())
            if not (self.active & ~self._stalled).any():
                # The host may only think rows are done pending in-flight
                # copies: flush the ring, which may also free the blocks a
                # stalled row waits on.
                take(self.drain())
                if self.kv is not None and self._stalled.any():
                    self._ensure_coverage()
                if not (self.active & ~self._stalled).any():
                    if not self.active.any():
                        if not self.sched and not self._prefilling:
                            break
                        continue
                    if self._prefilling or self._admission_could_progress():
                        continue
                    raise RuntimeError(
                        "KV pool deadlock: every live row is stalled on an "
                        "exhausted block pool with preemption disabled and "
                        "nothing left to drain — enable preemption "
                        "(SchedulerConfig.preempt) or use admission='worst_case'")
            take(self.step())
        return finished

    def step(self) -> List[Request]:
        """Dispatch one decode step for every live row, then consume the
        oldest in-flight step once the ring holds ``pipeline_depth``;
        returns the requests finished."""
        if self.kv is not None and self.sched.on_demand:
            self._ensure_coverage()
        self._dispatch_decode()
        if len(self._ring) >= self.pipeline_depth:
            self._consume_one()
        return self._pop_finished()

    def drain(self) -> List[Request]:
        """Consume every in-flight step (oldest first); returns the
        requests finished since the last public call."""
        self._drain_ring()
        return self._pop_finished()

    def defrag(self) -> int:
        """Compact live blocks to the lowest pool ids (paged only); returns
        the blocks moved.  Drains the ring first: the move map comes from
        the allocator, which must have seen every in-flight step's frees."""
        if self.kv is None:
            return 0
        self._drain_ring()
        return len(self.kv.defrag())

    def _drain_ring(self) -> None:
        while self._ring:
            self._consume_one()

    def _pop_finished(self) -> List[Request]:
        out, self._pending_finished = self._pending_finished, []
        return out

    # ------------------------------------------------------------- admission

    def _free_slots(self, busy=frozenset()) -> List[int]:
        return sorted((i for i in range(self.max_batch)
                       if not self.active[i] and i not in busy),
                      key=lambda i: self._freed_at[i])

    def _admission_could_progress(self) -> bool:
        """A prefill is mid-flight, or the scheduler's head could land in a
        free slot on today's free blocks, or a priority preemption could
        make room.  A blocked round ages the waiting class heads."""
        if self._prefilling:
            return True
        head = self.sched.head()
        if head is None:
            return False
        blocked = bool(self.active.all())
        if not blocked and self.kv is not None:
            blocked = self.kv.alloc.free_blocks() < self.kv.blocks_for(
                self.sched.admit_tokens(head, self.max_len))
        if not blocked:
            return True
        if self.kv is not None and self.sched.preempt and self._outranked_victims(head):
            return True
        self.sched.note_blocked()
        return False

    def _admit(self) -> List[Request]:
        """Admit queued requests, after draining the ring: admission reads
        the host's free slots and blocks and scatters fresh per-slot state,
        so no in-flight step may straddle a slot's change of occupant."""
        self._drain_ring()
        finished = self._pop_finished()
        finished.extend(self._admit_paged() if self.kv is not None
                        else self._admit_dense())
        return finished

    def _admit_paged(self) -> List[Request]:
        """Reserve blocks for the scheduler's head (its prompt on demand,
        its worst case otherwise) in the first free slot that takes them,
        preempting a strictly lower class for it when the batch or pool is
        full; then advance every prefilling request by one chunk."""
        busy = {t.slot for t in self._prefilling}
        while True:
            req = self.sched.head()
            if req is None:
                break
            if req.swap is not None and _swap_checksum(req.swap.blocks) != req.swap.checksum:
                # A corrupted payload is never scattered: the request
                # re-prefills its committed prefix.  Checked before the
                # reservation, which must cover the folded prompt (one
                # token more than the swapped context).
                req.swap = None
                self._fold_generated(req)
                self.swap_fallbacks += 1
            need = self.sched.admit_tokens(req, self.max_len)
            free = self._free_slots(busy)
            if not free:
                victim = (self.sched.pick_victim(self._outranked_victims(req))
                          if self.sched.preempt else None)
                if victim is None:
                    break
                self._preempt(victim, "priority")
                continue
            slot = None
            for cand in self.sched.slot_order(free, self.kv, self._freed_at):
                if self.kv.reserve(cand, need):
                    slot = cand
                    break
                if self.kv.alloc.in_use() == 0:
                    raise RuntimeError(f"request {req.uid} needs "
                                       f"{self.kv.blocks_for(need)} blocks but the "
                                       f"idle pool has {self.kv.num_blocks}")
            if slot is None:
                victim = (self.sched.pick_victim(self._outranked_victims(req))
                          if self.sched.preempt else None)
                if victim is None:
                    break  # backpressure: wait for blocks to free
                self._preempt(victim, "priority")
                continue
            self.sched.pop_head()
            busy.add(slot)
            if req.swap is not None:
                self._resume_swap(req, slot)
            else:
                if req.preemptions:
                    self.sched_events["resumes"] += 1
                self._prefilling.append(_PrefillTask(req, slot))
        return self._prefill_tick() if self._prefilling else []

    def _admit_dense(self) -> List[Request]:
        """The scheduler's head into a free slot, one request per
        prefill-admit call at the prompt's exact length; each call's first
        token is read back at once (one host sync per admission, as the
        reference's dense admission)."""
        dev = self.device
        t = lambda a: upload(np.asarray(a), dev)  # noqa: E731
        finished: List[Request] = []
        while self.sched:
            free = self._free_slots()
            if not free:
                break
            req, slot = self.sched.pop_head(), free[0]
            (first, self.cache_len, self.last_token, self.budget_dev, self.key_data,
             self.active_dev) = self._prefill(
                self.params, self.cache, t(req.prompt[None]), t([slot]),
                t([max(0, req.max_new_tokens - 1)]), request_keys(self.seed, [req.uid], dev),
                self.cache_len, self.last_token, self.budget_dev, self.key_data,
                t(np.asarray([req.temperature], np.float32)), self.active_dev)
            self.prefill_ticks += 1
            tok = int(first.cpu()[0])
            self.host_syncs += 1
            self._finish_or_activate(req, slot, tok, finished)
        return finished

    def _prefill_tick(self) -> List[Request]:
        """Advance up to max_batch prefills by ONE chunk (one step call)."""
        c, r_rows, dev = self.prefill_chunk, self.max_batch, self.device
        tasks = self._prefilling[:r_rows]
        tokens = np.zeros((r_rows, c), np.int32)
        starts = np.zeros(r_rows, np.int32)
        nvalid = np.ones(r_rows, np.int32)
        fslots = np.full(r_rows, self.max_batch, np.int32)  # pad = dropped
        budgets = np.zeros(r_rows, np.int32)
        temps = np.zeros(r_rows, np.float32)
        bt_rows = np.full((r_rows, self.kv.max_blocks_per_row), -1, np.int32)
        fin = []
        for r, task in enumerate(tasks):
            p = task.req.prompt
            n = min(len(p) - task.pos, c)
            tokens[r, :n] = p[task.pos:task.pos + n]
            starts[r] = task.pos
            nvalid[r] = n
            temps[r] = task.req.temperature
            bt_rows[r] = self.kv.table_np[task.slot]
            task.pos += n
            if task.pos >= len(p):
                fslots[r] = task.slot
                # The budget after the first sampled token; a re-prefilled
                # request's prompt already holds its generated tokens.
                budgets[r] = max(0, task.req.max_new_tokens
                                 - len(task.req.generated) - 1)
                fin.append((r, task))
        rkeys = torch.zeros((r_rows, 2), dtype=torch.int64, device=dev)
        if fin:
            rkeys[[r for r, _ in fin]] = request_keys(
                self.seed, [t.req.uid for _, t in fin], dev)
        t = lambda a: upload(a, dev)  # noqa: E731
        (first, self.cache_len, self.last_token, self.budget_dev, self.key_data,
         self.active_dev) = self._chunk_step(
            self.params, self.kv.pools, t(bt_rows), t(tokens), t(starts),
            t(nvalid), t(fslots), t(budgets), rkeys, self.cache_len,
            self.last_token, self.budget_dev, self.key_data, t(temps),
            self.active_dev)
        self.prefill_ticks += 1
        finished: List[Request] = []
        if fin:
            toks = first.cpu().numpy()
            self.host_syncs += 1
            for r, task in fin:
                self._finish_or_activate(task.req, task.slot, int(toks[r]), finished)
            done = {id(t) for _, t in fin}
            self._prefilling = [t for t in self._prefilling if id(t) not in done]
        return finished

    def _finish_or_activate(self, req: Request, slot: int, tok: int,
                            finished: List[Request]) -> None:
        req.slot = slot
        req.generated.append(tok)
        self.temps[slot] = req.temperature
        self._eos[slot] = -1 if req.eos_id is None else req.eos_id
        self._len_host[slot] = len(req.prompt)
        self._dev_len[slot] = len(req.prompt)
        self._stalled[slot] = False
        self._host_dirty = True
        if (req.done or self._len_host[slot] >= self.max_len - 1
                or tok == self._eos[slot]):
            finished.append(req)
            self._mark_finished(req)
            self._retire_slot(slot)
        else:
            self.slots[slot] = req
            self.active[slot] = True

    def _mark_finished(self, req: Request) -> None:
        """Every normal exit (eos, budget, max_len) is finish reason "stop",
        as in the reference."""
        req.finish_reason = "stop"
        self.finished_requests[req.uid] = req

    def _retire_slot(self, slot: int) -> None:
        """Free a slot and its blocks at once (every finish path)."""
        self.slots[slot] = None
        self.active[slot] = False
        self._stalled[slot] = False
        self._dev_len[slot] = 0
        self._host_dirty = True
        self._freed_at[slot] = next(self._free_clock)
        if self.kv is not None:
            self.kv.free(slot)

    # ------------------------------------------- on-demand growth, preemption

    def _ensure_coverage(self) -> None:
        """Grow every live row's reservation to cover its next dispatch.
        Growth only appends table entries (the table re-uploads at the next
        dispatch), so it is safe with steps in flight.  A row the pool
        cannot grow stalls (preemption off) or evicts a victim."""
        if self.kv is None or not self.sched.on_demand:
            return
        bs = self.kv.block_size
        for slot in np.flatnonzero(self.active).tolist():
            if not self.active[slot]:
                continue  # preempted by an earlier row's growth
            target = min(int(self._dev_len[slot]) + 1, self.max_len)
            covered = len(self.kv.alloc.owned_by(slot)) * bs
            if target <= covered:
                ok = True
            else:
                # One block of slack when it fits without stalling or
                # evicting anyone; under pressure the exact target.
                slacked = min(target + bs, self.max_len)
                ok = slacked > target and self._extend(slot, slacked)
                if not ok:
                    ok = self._grow_row(slot, target)
            if not self.active[slot]:
                continue  # the row itself was evicted to make room
            if ok:
                if self._stalled[slot]:
                    self._stalled[slot] = False
                    self._host_dirty = True
            elif not self._stalled[slot]:
                self._stalled[slot] = True
                self._host_dirty = True
                self.sched_events["stalls"] += 1

    def _grow_row(self, slot: int, target: int) -> bool:
        """True once slot's reservation covers ``target`` tokens (or the
        slot is gone).  On a dry pool with preemption on: drain the ring
        (pending finishes may free blocks), then evict most-blocks victims
        until the growth fits; the growing row is itself a candidate."""
        if self._extend(slot, target):
            return True
        if not self.sched.preempt:
            return False
        self._drain_ring()
        while self.slots[slot] is not None:
            if self._extend(slot, target):
                return True
            victim = self.sched.pick_victim(self._victim_candidates())
            if victim is None:
                return False
            self._preempt(victim, "pool_dry")
        return True  # the drain retired the row; nothing left to cover

    def _extend(self, slot: int, target: int) -> bool:
        """Extend slot's coverage to ``target`` tokens; False on a dry pool."""
        added = self.kv.extend(slot, target)
        if added is None:
            return False
        self.sched_events["grown_blocks"] += added
        return True

    def _victim_candidates(self):
        """(slot, blocks, class_idx) for every live row."""
        return [(s, len(self.kv.alloc.owned_by(s)), r.class_idx)
                for s, r in enumerate(self.slots) if r is not None]

    def _outranked_victims(self, head: Request):
        """Live rows whose class the head's STRICTLY outranks: the only
        rows an admission may evict (equal classes wait, never thrash)."""
        return [(s, len(self.kv.alloc.owned_by(s)), r.class_idx)
                for s, r in enumerate(self.slots)
                if r is not None and r.class_idx > head.class_idx]

    def _preempt(self, slot: int, reason: str) -> None:
        """Evict a live row (the ring is drained) for a dry pool
        ("pool_dry") or a higher class ("priority"): swap its KV prefix to
        the host, or fold its generated tokens into its prompt for
        re-prefill; release every block and requeue it at the front of its
        class."""
        req = self.slots[slot]
        n_ctx = int(self._len_host[slot])
        swap_bytes = 0
        if self.sched.resume_mode == "swap":
            req.swap = self._swap_out(slot, n_ctx)
            swap_bytes = req.swap.nbytes
        else:
            self._fold_generated(req)
        self.kv.rollback(slot, 0)
        self.slots[slot] = None
        self.active[slot] = False
        self._stalled[slot] = False
        self._dev_len[slot] = 0
        self._len_host[slot] = 0
        self._host_dirty = True
        self._freed_at[slot] = next(self._free_clock)
        req.slot = None
        req.preemptions += 1
        self.sched.requeue(req)
        self.sched_events["preemptions"] += 1
        self.priority_preemptions += reason == "priority"
        self.sched_events["swap_bytes"] += swap_bytes

    @staticmethod
    def _fold_generated(req: Request) -> None:
        """Re-prefill resume: the committed prefix becomes the prompt.
        Greedy streams continue as they were (up to rounding: the chunk
        path recomputes KV the decode path wrote); temperature streams
        restart their key chain."""
        fold = req.generated[req.prompt_absorbed:]
        req.prompt = np.concatenate([req.prompt, np.asarray(fold, np.int32)])
        req.prompt_absorbed = len(req.generated)

    def _swap_out(self, slot: int, n_ctx: int) -> _SwapPayload:
        """Copy the blocks covering slot's committed context (one gather
        per pool leaf) and its key state to pinned host memory, with one
        wait for the copies (counted in ``swap_syncs``), and checksum them."""
        n_blocks = self.kv.blocks_for(max(1, n_ctx))
        ids = upload(np.asarray(self.kv.alloc.owned_by(slot)[:n_blocks], np.int64),
                     self.device)
        copies = [_to_host(leaf.index_select(ax, ids))
                  for _, ax, leaf in pool_leaves(self.kv.pools)]
        key_row, ready = _to_host(self.key_data[slot])
        if ready is not None:
            ready.synchronize()  # after every copy above, on one stream
        self.swap_syncs += 1
        blocks = [b for b, _ in copies]
        return _SwapPayload(n_ctx=n_ctx, n_blocks=n_blocks, blocks=blocks,
                            key_row=key_row, checksum=_swap_checksum(blocks))

    def _resume_swap(self, req: Request, slot: int) -> None:
        """Scatter a swapped request's blocks (their CRC checked at
        admission) into its new reservation and restore its row state: no
        recompute, and its key chain continues."""
        pay, dev = req.swap, self.device
        req.swap = None
        self.sched_events["resumes"] += 1
        ids = upload(np.asarray(self.kv.alloc.owned_by(slot)[:pay.n_blocks], np.int64),
                     dev)
        for (_, ax, leaf), host in zip(pool_leaves(self.kv.pools), pay.blocks):
            leaf.index_copy_(ax, ids, host.to(dev, non_blocking=True))
        self.cache_len[slot] = pay.n_ctx
        self.last_token[slot] = req.generated[-1]
        self.budget_dev[slot] = req.max_new_tokens - len(req.generated)
        self.key_data[slot] = pay.key_row.to(dev, non_blocking=True)
        self.active_dev[slot] = True
        self.slots[slot] = req
        self.active[slot] = True
        self._stalled[slot] = False
        req.slot = slot
        self.temps[slot] = req.temperature
        self._eos[slot] = -1 if req.eos_id is None else req.eos_id
        self._len_host[slot] = pay.n_ctx
        self._dev_len[slot] = pay.n_ctx
        self._host_dirty = True

    # ---------------------------------------------------------------- decode

    def _host_inputs(self):
        """Device copies of (host_keep, temps, eos[, row order]), rebuilt
        only after bookkeeping changed them.  Each rebuild uploads fresh
        pinned buffers, so no in-flight copy reads a buffer the host
        rewrites.  Stalled rows are live but drop out of host_keep, which
        freezes their state on the device.  A fixed row order stays valid
        between rebuilds: any permutation leaves the tokens unchanged."""
        if self._host_dirty:
            dev = self.device
            keep = self.active & ~self._stalled
            self._host_dev = (upload(keep, dev), upload(self.temps, dev),
                              upload(self._eos, dev))
            if self.kv is not None:
                order = self.sched.row_order(self._dev_len, keep, self.max_batch, 1)
                self._host_dev += (None if order is None
                                   else upload(order.astype(np.int64), dev),)
            self._host_dirty = False
        return self._host_dev

    def _dispatch_decode(self) -> None:
        """Launch one decode step and ring its token copy; no host sync."""
        t0 = time.perf_counter()
        mask = self.active & ~self._stalled
        state = (self.cache_len, self.budget_dev, self.key_data, self.active_dev,
                 *self._host_inputs())
        if self.kv is None:
            out = self._decode(self.params, self.cache, self.last_token, *state)
        else:
            out = self._decode(self.params, self.kv.pools, self.kv.table_device(),
                               self.last_token, *state)
            self._dev_len += mask  # each dispatched row writes one entry
        sampled, self.cache_len, self.budget_dev, self.key_data, self.active_dev = out
        self.last_token = sampled
        host, ready = _to_host(sampled)
        self._note_occupancy(mask)
        self._ring.append(_InFlight(host, ready, mask, time.perf_counter() - t0))

    def _note_occupancy(self, mask: np.ndarray) -> None:
        """Live rows per step, and live committed tokens over reserved pool
        tokens per dispatch (the on-demand payoff)."""
        self._occ_rows_sum += int(mask.sum())
        self._occ_rows_steps += 1
        if self.kv is None:
            return
        reserved = self.kv.alloc.in_use() * self.kv.block_size
        if reserved > 0:
            self._occ_live_frac_sum += int(self._len_host[mask].sum()) / reserved
            self._occ_samples += 1

    def _consume_one(self) -> None:
        """Wait for the oldest in-flight step's token copy (the step's one
        host sync) and run its emission and finish bookkeeping."""
        entry = self._ring.popleft()
        t0 = time.perf_counter()
        if entry.ready is not None:
            entry.ready.synchronize()
        toks = entry.tokens.numpy()
        t_wait = time.perf_counter() - t0
        self.host_syncs += 1
        self.decode_syncs += 1
        self._pending_finished.extend(self._commit_decode(entry, toks))
        t_host = time.perf_counter() - t0 - t_wait
        self._dispatch_s.append(entry.dispatch_s)
        self._wait_s.append(t_wait)
        self._host_s.append(t_host)
        self.step_times.append(entry.dispatch_s + t_wait + t_host)

    def _commit_decode(self, entry: _InFlight, toks: np.ndarray) -> List[Request]:
        # A slot live in entry.mask whose request was retired by an OLDER
        # entry carries a token the device masked: skip it.
        live = np.fromiter((r is not None for r in self.slots), bool, self.max_batch)
        adv = entry.mask & live
        self._len_host += adv
        finished: List[Request] = []
        for slot, req in enumerate(self.slots):
            if req is None or not adv[slot]:
                continue
            tok = int(toks[slot])
            req.generated.append(tok)
            if (req.done or self._len_host[slot] >= self.max_len - 1
                    or tok == self._eos[slot]):
                finished.append(req)
                self._mark_finished(req)
                self._retire_slot(slot)
        return finished

    # ----------------------------------------------------------------- stats

    def stats(self) -> Dict[str, float]:
        """Step counts and times (seconds): a consumed step's wall is its
        dispatch, its wait for the token copy (device wait) and the host's
        bookkeeping after it (host); the three means are reported apart."""
        ts = np.asarray(self.step_times) if self.step_times else np.zeros(1)

        def mean(xs):
            return float(np.mean(xs)) if xs else 0.0

        return {
            "steps": len(self.step_times),
            "prefill_ticks": self.prefill_ticks,
            "host_syncs": self.host_syncs,
            "decode_syncs": self.decode_syncs,
            "swap_syncs": self.swap_syncs,
            "step_p50_s": float(np.percentile(ts, 50)),
            "step_p90_s": float(np.percentile(ts, 90)),
            "step_mean_s": float(ts.mean()),
            "pipeline_depth": self.pipeline_depth,
            "step_dispatch_s": mean(self._dispatch_s),
            "step_device_wait_s": mean(self._wait_s),
            "step_host_s": mean(self._host_s),
        }

    def scheduler_stats(self) -> Dict[str, object]:
        """Policy and lifecycle counters (the reference's keys, the priority
        preemptions among them and the swap CRC fallbacks), with the occupancy means: live committed over
        reserved tokens per dispatch, live rows per step."""
        occ = (self._occ_live_frac_sum / self._occ_samples
               if self._occ_samples else None)
        rows = (self._occ_rows_sum / self._occ_rows_steps
                if self._occ_rows_steps else 0.0)
        cfg = self.sched.cfg
        return {
            "admission_policy": cfg.admission,
            "preempt_enabled": self.sched.preempt,
            "resume_mode": self.sched.resume_mode,
            "priority_classes": list(cfg.priority_classes),
            "preempt_count": self.sched_events["preemptions"],
            "priority_preemptions": self.priority_preemptions,
            "swap_bytes": self.sched_events["swap_bytes"],
            "grown_blocks": self.sched_events["grown_blocks"],
            "resumes": self.sched_events["resumes"],
            "stalls": self.sched_events["stalls"],
            "swap_fallbacks": self.swap_fallbacks,
            "occupancy_live_frac": occ,
            "mean_live_rows": rows,
            "queued": len(self.sched),
        }

    def cache_stats(self) -> Dict[str, object]:
        """Cache bytes and live/reserved tokens (one device: no mesh)."""
        live = int((self._len_host * self.active).sum())
        if self.kv is not None:
            s = dict(self.kv.stats(), layout="paged")
        else:
            slab = sum(c.numel() * c.element_size() for c in _leaves(self.cache))
            s = {"layout": "dense", "tokens_capacity": self.max_batch * self.max_len,
                 "cache_hbm_bytes": slab, "dp_shards": 1,
                 "per_device_cache_hbm_bytes": slab}
        s["mesh"] = {"dp": 1, "tp": 1, "devices": 1}
        s["live_tokens"] = live
        return s


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v
