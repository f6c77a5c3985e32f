"""Scheduling policy for the continuous-batching engine (the port's own
copy of the reference's pure-Python scheduler, decision for decision).

The engine owns device state and executes steps; this module owns every
scheduling *decision*: which queued request is admitted next (per-class
SLA queues with starvation-free aging), how many blocks admission must
cover (on-demand = prompt only, worst-case = prompt + max_new), where a
new row lands on a DP mesh (emptiest shard's sub-pool), which live row
is evicted when the pool runs dry (most-blocks victim, matching the
``preempt_ready`` observability flag), and in what order decode rows are
packed for dispatch (longest-first per shard, so the packed
paged-attention kernel's shared page loop runs ragged packs less often).

Requests are duck-typed: the scheduler reads ``uid``, ``class_idx``,
``generated``, ``max_new_tokens`` and the engine-maintained
``prefix_len`` (prompt length, or saved context length for a
swap-resumed row).  It never touches device state.

On one card the pool is one shard, so ``slot_order`` reduces to the
freed-order handout and ``row_order`` to one longest-first sort.  The
port's split-KV paged kernel plans its grid from the table's width, not
from row lengths, so the order costs it a few gathers a step and buys
nothing; it is kept as the reference's default.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, List, Optional, Sequence, Tuple

import numpy as np

ADMISSION_POLICIES = ("on_demand", "worst_case")
RESUME_MODES = ("reprefill", "swap")


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Policy knobs for the continuous-batching scheduler.

    admission: "on_demand" admits a request on blocks for its prompt
        alone and grows the reservation at block boundaries as the row
        decodes, so pool occupancy tracks live tokens.  "worst_case"
        reserves prompt + max_new up front (the pre-scheduler contract,
        kept for bit-compat pins and as a no-surprises fallback).
    preempt: allow evicting a live row (most blocks first) when block
        growth or a higher-priority admission cannot be satisfied.  Off,
        a starved row stalls (frozen on device) until blocks free up,
        and a full-pool deadlock raises instead of thrashing.
    resume: how a preempted request comes back.  "reprefill" re-runs
        prefill over prompt + generated (cheap bookkeeping, recompute on
        resume); "swap" copies the victim's KV blocks to host and
        scatters them back on re-admission (no recompute, preserves the
        sampling-key chain; unsupported with speculative decoding).
    priority_classes: latency classes, highest priority first.
        ``submit(latency_class=...)`` names one; None maps to the last
        (lowest) class.  A single class degenerates to FIFO.
    aging_rounds: a queued class-head gains one priority rank per this
        many blocked admission rounds, so low classes cannot starve.
        0 disables aging.
    sort_decode_rows: pack decode rows longest-first within each DP
        shard before dispatch (token streams are invariant under the
        permutation; pinned by tests).
    """

    admission: str = "on_demand"
    preempt: bool = True
    resume: str = "reprefill"
    priority_classes: Tuple[str, ...] = ("default",)
    aging_rounds: int = 32
    sort_decode_rows: bool = True

    def __post_init__(self):
        if self.admission not in ADMISSION_POLICIES:
            raise ValueError(
                f"admission must be one of {ADMISSION_POLICIES}, "
                f"got {self.admission!r}")
        if self.resume not in RESUME_MODES:
            raise ValueError(
                f"resume must be one of {RESUME_MODES}, got {self.resume!r}")
        if not self.priority_classes:
            raise ValueError("priority_classes must be non-empty")
        if len(set(self.priority_classes)) != len(self.priority_classes):
            raise ValueError("priority_classes must be unique")
        if self.aging_rounds < 0:
            raise ValueError("aging_rounds must be >= 0")


class Scheduler:
    """Per-class admission queues + placement/victim policy.

    The queues hold engine ``Request`` objects.  ``head()`` is the
    admission candidate: the front of the best effective-priority class,
    where a class-head's effective priority improves by one rank per
    ``aging_rounds`` blocked admission rounds (``note_blocked()``).
    Resumed requests re-enter at the FRONT of their class — a preempted
    row outranks everything queued behind it at equal class.
    """

    def __init__(self, config: Optional[SchedulerConfig] = None):
        self.cfg = config or SchedulerConfig()
        self._queues: Tuple[Deque, ...] = tuple(
            deque() for _ in self.cfg.priority_classes)
        self._wait_rounds: List[int] = [0] * len(self.cfg.priority_classes)
        self._seq = 0

    # -- config views ---------------------------------------------------
    @property
    def on_demand(self) -> bool:
        return self.cfg.admission == "on_demand"

    @property
    def preempt(self) -> bool:
        return self.cfg.preempt

    @property
    def resume_mode(self) -> str:
        return self.cfg.resume

    @property
    def sort_decode_rows(self) -> bool:
        return self.cfg.sort_decode_rows

    def class_index(self, latency_class: Optional[str]) -> int:
        """Map a submit()-supplied class name to its queue index."""
        if latency_class is None:
            return len(self.cfg.priority_classes) - 1
        try:
            return self.cfg.priority_classes.index(latency_class)
        except ValueError:
            raise ValueError(
                f"unknown latency class {latency_class!r}; configured "
                f"classes: {self.cfg.priority_classes}") from None

    # -- queue ops ------------------------------------------------------
    def submit(self, req) -> None:
        req._sched_seq = self._seq
        self._seq += 1
        self._queues[req.class_idx].append(req)

    def requeue(self, req) -> None:
        """Re-admit a preempted request at the front of its class."""
        self._queues[req.class_idx].appendleft(req)

    def remove(self, uid: int):
        """Pull a queued request out by uid (cancel / deadline shed).

        Returns the removed request, or None if no queued request has
        that uid.  Relative order of everything else is preserved."""
        for q in self._queues:
            for req in q:
                if req.uid == uid:
                    q.remove(req)
                    return req
        return None

    def pending(self) -> int:
        return sum(len(q) for q in self._queues)

    def __bool__(self) -> bool:
        return self.pending() > 0

    def __len__(self) -> int:
        return self.pending()

    def queued(self) -> List:
        """All queued requests, admission order (best class first)."""
        order = sorted(range(len(self._queues)),
                       key=lambda c: self._effective(c))
        out: List = []
        for c in order:
            out.extend(self._queues[c])
        return out

    def _effective(self, class_idx: int) -> Tuple[int, int]:
        """Effective rank of a class-head: smaller admits first."""
        rank = class_idx
        if self.cfg.aging_rounds:
            rank -= self._wait_rounds[class_idx] // self.cfg.aging_rounds
        q = self._queues[class_idx]
        seq = q[0]._sched_seq if q else 0
        return (max(0, rank), seq)

    def head(self):
        """The next admission candidate, or None if nothing is queued."""
        best = None
        best_key = None
        for c, q in enumerate(self._queues):
            if not q:
                continue
            key = self._effective(c)
            if best_key is None or key < best_key:
                best, best_key = q[0], key
        return best

    def pop_head(self):
        head = self.head()
        if head is None:
            raise IndexError("pop_head on empty scheduler")
        self._queues[head.class_idx].popleft()
        self._wait_rounds[head.class_idx] = 0
        return head

    def note_blocked(self) -> None:
        """One blocked admission round: age every waiting class-head."""
        if not self.cfg.aging_rounds:
            return
        for c, q in enumerate(self._queues):
            if q:
                self._wait_rounds[c] += 1

    def take_bucket(self, max_r: int, bucket_of) -> List:
        """Pop up to ``max_r`` requests sharing the head's bucket.

        Scans the head's class queue FIFO (non-matching requests keep
        their relative order) — the dense engine's batched-prefill
        grouping, now per latency class.  ``bucket_of(req)`` is the
        engine's prompt-length bucket function."""
        head = self.head()
        if head is None:
            return []
        q = self._queues[head.class_idx]
        want = bucket_of(head)
        group: List = []
        rest: Deque = deque()
        while q:
            req = q.popleft()
            if len(group) < max_r and bucket_of(req) == want:
                group.append(req)
            else:
                rest.append(req)
        q.extend(rest)
        if group:
            self._wait_rounds[head.class_idx] = 0
        return group

    # -- admission sizing ----------------------------------------------
    def admit_tokens(self, req, max_len: int) -> int:
        """Tokens admission must cover before the row can activate.

        on_demand: the request's current prefix (prompt, or saved
        context for a swap resume) — growth covers the rest.
        worst_case: prefix plus every token the row could still emit.
        """
        prefix = req.prefix_len
        if self.on_demand:
            return prefix
        remaining = req.max_new_tokens - len(req.generated)
        return min(max_len, prefix + remaining)

    # -- placement ------------------------------------------------------
    def slot_order(self, free_slots: Sequence[int], kv,
                   freed_at: Sequence[int]) -> List[int]:
        """Order free slots for admission: emptiest DP shard first.

        Ties (always, on a 1-shard pool) fall back to freed-order, which
        is exactly the pre-scheduler handout — so single-shard admission
        is bit-identical to the old first-free scan.
        """
        alloc = kv.alloc
        return sorted(
            free_slots,
            key=lambda s: (-alloc.free_blocks(kv.slot_shard(s)),
                           freed_at[s]))

    # -- preemption -----------------------------------------------------
    def pick_victim(self, candidates: Sequence[Tuple[int, int, int]]
                    ) -> Optional[int]:
        """Pick the eviction victim from (slot, owned_blocks, class_idx).

        Most-blocks first (the row whose eviction frees the most pool,
        and the same row the ``preempt_ready`` hook flags), breaking
        ties toward the lower-priority class, then the higher slot.
        """
        if not candidates:
            return None
        slot, _, _ = max(candidates, key=lambda c: (c[1], c[2], c[0]))
        return slot

    def row_order(self, dev_len, eff_active, max_batch: int,
                  dp_shards: int):
        """Dispatch-order permutation of decode rows, or None to skip.

        Within each DP shard's contiguous slot range, live rows sort by
        device cache length descending (stable), dead/stalled rows sink
        to the end — so each packed-kernel row pack shares page-loop
        trip counts instead of the longest row dragging short ones.
        """
        if not self.cfg.sort_decode_rows:
            return None
        order = np.empty(max_batch, np.int32)
        per = max_batch // dp_shards
        for s in range(dp_shards):
            lo = s * per
            hi = lo + per
            keys = np.where(eff_active[lo:hi], dev_len[lo:hi], -1)
            order[lo:hi] = lo + np.argsort(-keys, kind="stable")
        return order
