"""Batched serving engine (continuous batching) over (compressed) weights
— the core of the reference engine, at pipeline depth 1 with worst-case
admission — on either of the reference's cache layouts, chosen by
``models.api.cache_layout``:

* "paged" (attention stacks): requests are admitted into free slots and
  their prompts stream into reserved KV blocks ``prefill_chunk`` tokens per
  engine iteration (one fixed-shape chunk call for all prefilling rows).
* "dense" (recurrent stacks: RWKV-6): one (max_batch, ...) slab per cache
  leaf.  Each admission prefills ONE request at its exact length into a
  fresh row cache that then replaces its slot's rows wholesale (a recurrent
  state folds in every position, so prompts are never padded or bucketed).

Every engine step decodes one token for all live rows, and finished rows
free their slot (and blocks) immediately, so new requests join mid-flight.

All per-slot state lives on the device (cache_len, last_token, budget,
sampling keys, active).  A step is one decode call — sampling and the
EOS / budget / max_len-1 exits happen on the device — followed by ONE
device-to-host copy of the sampled token vector, from which the host
learns every finish.  Admission reserves a request's worst case
(prompt + max_new) up front, so a live row never runs out of blocks.

Not ported yet (later slices): bucketed dense-slab admission (no ported
dense-layout model is pad-safe), speculative decoding, meshes, on-demand
block growth and preemption, fault injection, telemetry and the depth-K
dispatch ring.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
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
from repro_torch.serving.kvcache import PagedKVCache, upload


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

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens


@dataclasses.dataclass
class _PrefillTask:
    req: Request
    slot: int
    pos: int = 0  # next prompt position to feed


class ServingEngine:
    def __init__(self, model, params, max_batch: int = 8, max_len: int = 512,
                 seed: int = 0, block_size: int = 16,
                 num_blocks: Optional[int] = None, prefill_chunk: int = 64,
                 eos_id: Optional[int] = None, kv_quant: bool = False):
        self.model = model
        self.params = params
        self.device = params["embed"]["table"].device
        self.max_batch = max_batch
        self.max_len = max_len
        self.seed = seed
        self.eos_id = eos_id
        self.prefill_chunk = prefill_chunk
        self.layout = cache_layout(model)
        if self.layout == "paged":
            self.kv = PagedKVCache(model, max_batch, max_len, block_size=block_size,
                                   num_blocks=num_blocks, kv_quant=kv_quant,
                                   device=self.device)
            self._decode = make_paged_decode_step(model, max_len)
            self._chunk_step = make_paged_prefill_chunk_step(model)
        else:
            if kv_quant:
                raise ValueError(f"{model.cfg.name}: kv_quant quantizes paged "
                                 "attention K/V; this model's cache is recurrent")
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
        # token vector each step copies.
        self.active = np.zeros(max_batch, bool)
        self.temps = np.zeros(max_batch, np.float32)
        self._eos = np.full(max_batch, -1, np.int32)
        self._len_host = np.zeros(max_batch, np.int64)
        self._host_dirty = True
        self._host_dev = None

        self.queue: deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * max_batch
        self._prefilling: List[_PrefillTask] = []
        self._uid = itertools.count()
        # Free slots are handed out in the order they freed (as the
        # reference does); token streams never depend on the slot.
        self._free_clock = itertools.count()
        self._freed_at = np.arange(max_batch, dtype=np.int64) - max_batch
        self.finished_requests: Dict[int, Request] = {}

        self.step_times: List[float] = []
        self.prefill_ticks = 0
        self.host_syncs = 0

    # ------------------------------------------------------------------ API

    def submit(self, prompt, max_new_tokens: int = 32, temperature: float = 0.0,
               eos_id: Optional[int] = None) -> int:
        """Queue one request; returns its uid."""
        prompt = np.asarray(prompt, np.int32)
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        if max_new_tokens <= 0:
            raise ValueError(f"max_new_tokens must be positive, got {max_new_tokens}")
        if len(prompt) > self.max_len - 1:
            raise ValueError(f"prompt length {len(prompt)} exceeds "
                             f"max_len-1={self.max_len - 1}")
        if self.kv is not None:
            need = self.kv.blocks_for(min(self.max_len, len(prompt) + max_new_tokens))
            if need > self.kv.num_blocks:
                raise ValueError(f"request needs {need} blocks worst-case but the "
                                 f"pool only has {self.kv.num_blocks}")
        req = Request(next(self._uid), prompt, max_new_tokens, temperature,
                      eos_id if eos_id is not None else self.eos_id)
        self.queue.append(req)
        return req.uid

    def run(self, max_steps: int = 100_000) -> Dict[int, List[int]]:
        """Drive until queue, prefills and slots drain: uid -> generated."""
        finished: Dict[int, List[int]] = {}
        for _ in range(max_steps):
            if self._prefilling or self._admission_could_progress():
                for req in self._admit():
                    finished[req.uid] = req.generated
            if not self.active.any():
                if not self.queue and not self._prefilling:
                    break
                continue
            for req in self.step():
                finished[req.uid] = req.generated
        return finished

    # ------------------------------------------------------------- admission

    def _free_slots(self, busy=frozenset()) -> List[int]:
        return sorted((i for i in range(self.max_batch)
                       if not self.active[i] and i not in busy),
                      key=lambda i: self._freed_at[i])

    def _need(self, req: Request) -> int:
        return min(self.max_len, len(req.prompt) + req.max_new_tokens)

    def _admission_could_progress(self) -> bool:
        if not self.queue or self.active.all():
            return False
        if self.kv is None:
            return True
        return self.kv.alloc.free_blocks() >= self.kv.blocks_for(
            self._need(self.queue[0]))

    def _admit(self) -> List[Request]:
        """Reserve blocks for queued requests (FIFO, worst case), then
        advance every prefilling request by one chunk (paged); or prefill
        queued requests into free slots (dense)."""
        if self.kv is None:
            return self._admit_dense()
        busy = {t.slot for t in self._prefilling}
        while self.queue:
            req = self.queue[0]
            free = self._free_slots(busy)
            if not free:
                break
            slot = free[0]
            if not self.kv.reserve(slot, self._need(req)):
                if self.kv.alloc.in_use() == 0:
                    raise RuntimeError(f"request {req.uid} needs "
                                       f"{self.kv.blocks_for(self._need(req))} "
                                       f"blocks but the idle pool has "
                                       f"{self.kv.num_blocks}")
                break  # backpressure: wait for blocks to free
            self.queue.popleft()
            busy.add(slot)
            self._prefilling.append(_PrefillTask(req, slot))
        return self._prefill_tick() if self._prefilling else []

    def _admit_dense(self) -> List[Request]:
        """FIFO into free slots, one request per prefill-admit call at the
        prompt's exact length; each call's first token is read back at once
        (one host sync per admission, as the reference's dense admission)."""
        dev = self.device
        t = lambda a: upload(np.asarray(a), dev)  # noqa: E731
        finished: List[Request] = []
        while self.queue:
            free = self._free_slots()
            if not free:
                break
            req, slot = self.queue.popleft(), free[0]
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
                budgets[r] = max(0, task.req.max_new_tokens - 1)
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
        self._host_dirty = True
        if (req.done or self._len_host[slot] >= self.max_len - 1
                or tok == self._eos[slot]):
            finished.append(req)
            self._finish(req, slot)
        else:
            self.slots[slot] = req
            self.active[slot] = True

    def _finish(self, req: Request, slot: int) -> None:
        """Every normal exit (eos, budget, max_len) is finish reason "stop",
        as in the reference; the slot and its blocks free at once."""
        req.finish_reason = "stop"
        self.finished_requests[req.uid] = req
        self.slots[slot] = None
        self.active[slot] = False
        self._host_dirty = True
        self._freed_at[slot] = next(self._free_clock)
        if self.kv is not None:
            self.kv.free(slot)

    # ---------------------------------------------------------------- decode

    def _host_inputs(self):
        """Device copies of (host_keep, temps, eos), rebuilt only after
        admission or a finish changed them."""
        if self._host_dirty:
            dev = self.device
            self._host_dev = (upload(self.active, dev), upload(self.temps, dev),
                              upload(self._eos, dev))
            self._host_dirty = False
        return self._host_dev

    def step(self) -> List[Request]:
        """One decode step for every live row; returns requests finished."""
        t0 = time.perf_counter()
        mask = self.active.copy()
        host_keep, temps, eos = self._host_inputs()
        state = (self.cache_len, self.budget_dev, self.key_data, self.active_dev,
                 host_keep, temps, eos)
        if self.kv is None:
            out = self._decode(self.params, self.cache, self.last_token, *state)
        else:
            out = self._decode(self.params, self.kv.pools, self.kv.table_device(),
                               self.last_token, *state)
        sampled, self.cache_len, self.budget_dev, self.key_data, self.active_dev = out
        self.last_token = sampled
        toks = sampled.cpu().numpy()  # the step's one host sync
        self.host_syncs += 1
        self._len_host += mask
        finished: List[Request] = []
        for slot, req in enumerate(self.slots):
            if req is None or not mask[slot]:
                continue
            tok = int(toks[slot])
            req.generated.append(tok)
            if (req.done or self._len_host[slot] >= self.max_len - 1
                    or tok == self._eos[slot]):
                finished.append(req)
                self._finish(req, slot)
        self.step_times.append(time.perf_counter() - t0)
        return finished

    def stats(self) -> Dict[str, float]:
        ts = np.asarray(self.step_times) if self.step_times else np.zeros(1)
        return {
            "steps": len(self.step_times),
            "prefill_ticks": self.prefill_ticks,
            "host_syncs": self.host_syncs,
            "step_p50_s": float(np.percentile(ts, 50)),
            "step_p90_s": float(np.percentile(ts, 90)),
            "step_mean_s": float(ts.mean()),
        }
