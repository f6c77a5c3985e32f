"""Deterministic fault injection + degradation policy for the serving engine
(the port's own copy of the reference's pure-Python module; a plan's JSON
loads unchanged in either package).

The serving stack for aggressively compressed models (NSVD at low ratio,
int8 dequant in-kernel, a higher-compression draft twin) operates near
numerical cliffs, so the engine treats faults as a first-class input: a
seeded :class:`FaultPlan` injects each failure mode at a chosen engine
step, and the engine's always-on degradation machinery (device-side
finite check, swap checksums, draft cool-down, deadline shedding, the
step-time watchdog) must absorb it without perturbing any healthy row's
token stream.

The harness is a pure test/chaos surface: an engine constructed without
a plan takes no extra branches on the hot path beyond a single ``is
None`` check per injection site, and its decode steps take the extra
poison input only when the plan contains a ``poison_logits`` spec.

Fault kinds
-----------
``poison_logits``
    Add a NaN to the targeted request's logits at the chosen step, via
    the decode step's trailing poison input.  The device-side finite
    check folds the verdict into the token word the step already copies
    (``POISON_TOKEN``; a speculative verify step reports
    ``n_commit == -1`` in its packed matrix), so detection needs no extra
    transfer.  Requires ``uid``.  Fires at
    the first dispatch at/after ``step`` where the row is live and
    unstalled; a uid that never reaches the device leaves the spec
    unfired (see :meth:`FaultPlan.outstanding`).
``alloc_fail``
    Fail the next ``BlockAllocator`` reservation (admission) or grow
    attempt at/after ``step``.  Admission retries the next round; a
    live row stalls exactly like a genuinely dry pool.
``swap_corrupt``
    Flip one byte in the next swap-out payload at/after ``step``
    (optionally matched to ``uid``).  The checksum mismatch at resume
    falls back to reprefill-resume.
``straggler``
    Sleep ``delay_s`` before the next D2H sync at/after ``step``,
    simulating a hung transfer; the watchdog flags it.
``draft_kill``
    Raise inside the next speculative draft dispatch at/after ``step``;
    the engine degrades to plain decode and re-enables the draft after
    a cool-down.  Its only site is the speculative dispatch: on an engine
    without a speculative config the spec never fires and stays in
    :meth:`FaultPlan.outstanding`, as in the reference engine.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.runtime.straggler import StragglerConfig

FAULT_KINDS = (
    "poison_logits",
    "alloc_fail",
    "swap_corrupt",
    "straggler",
    "draft_kill",
)

#: finish_reason values a Request can end with.
FINISH_REASONS = ("stop", "error", "deadline", "cancelled", "shutdown")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault.

    step: engine dispatch-step counter at/after which the fault fires
        (each spec fires at most once, at the first opportunity).
    uid: target request (required for poison_logits; optional filter
        for swap_corrupt; ignored otherwise).
    delay_s: straggler sleep duration.
    """

    kind: str
    step: int = 0
    uid: Optional[int] = None
    delay_s: float = 0.25

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; one of {FAULT_KINDS}")
        if self.kind == "poison_logits" and self.uid is None:
            raise ValueError("poison_logits requires a target uid")
        if self.step < 0:
            raise ValueError("step must be >= 0")
        if self.delay_s < 0:
            raise ValueError("delay_s must be >= 0")


class FaultPlan:
    """A seeded, deterministic set of faults consumed by the engine.

    The plan is pure bookkeeping: the engine asks ``take(kind, step,
    uid=...)`` at each injection site and a matching unfired spec is
    returned (and marked fired) or None.  ``counts()`` reports fired
    faults by kind — the accounting the tests and the chip path check
    against the engine's quarantine/retry/shed counters.
    """

    def __init__(self, specs: Sequence[FaultSpec] = ()):
        self.specs: List[FaultSpec] = list(specs)
        self._fired = [False] * len(self.specs)
        self.fired_log: List[Tuple[FaultSpec, int]] = []

    def __len__(self) -> int:
        return len(self.specs)

    def has(self, kind: str) -> bool:
        return any(s.kind == kind for s in self.specs)

    def take(self, kind: str, step: int,
             uid: Optional[int] = None) -> Optional[FaultSpec]:
        """Claim the first unfired spec of ``kind`` due at ``step``.

        For uid-matched kinds, a spec with uid=None matches any request
        while a spec with a uid only matches that request.
        """
        for i, sp in enumerate(self.specs):
            if self._fired[i] or sp.kind != kind or step < sp.step:
                continue
            if sp.uid is not None and uid is not None and sp.uid != uid:
                continue
            if sp.uid is not None and uid is None:
                continue
            self._fired[i] = True
            self.fired_log.append((sp, step))
            return sp
        return None

    def counts(self) -> Dict[str, int]:
        """Fired-fault counts by kind (only kinds that fired appear)."""
        out: Dict[str, int] = {}
        for sp, _ in self.fired_log:
            out[sp.kind] = out.get(sp.kind, 0) + 1
        return out

    def outstanding(self) -> List[FaultSpec]:
        """Specs that never found an injection site."""
        return [sp for i, sp in enumerate(self.specs) if not self._fired[i]]

    # -- JSON (the serve CLI's --chaos PLAN.json) -----------------------
    def to_json(self) -> str:
        return json.dumps({"faults": [dataclasses.asdict(s)
                                      for s in self.specs]}, indent=2)

    @classmethod
    def from_json(cls, path: str) -> "FaultPlan":
        with open(path) as f:
            doc = json.load(f)
        raw = doc["faults"] if isinstance(doc, dict) else doc
        return cls([FaultSpec(**{k: v for k, v in s.items()
                                 if v is not None}) for s in raw])


@dataclasses.dataclass(frozen=True)
class FaultPolicy:
    """Degradation knobs: what the engine does once a fault is detected.

    max_retries: poisoned requests retry (reprefill from committed
        context) up to this many times before retiring with
        ``finish_reason="error"``.  0 quarantines immediately.
    retry_backoff_steps / retry_backoff_cap: capped exponential backoff
        in engine steps between retries (base * 2**(attempt-1)).
    draft_cooldown_steps: plain-decode steps before a killed draft path
        is re-enabled.
    step_timeout_s: hard per-step wall-clock limit (dispatch + sync);
        exceeding it raises a structured :class:`ServingFault` with an
        engine snapshot.  None disables the hard limit.
    straggler: watchdog thresholds for soft slow-step detection.
    """

    max_retries: int = 0
    retry_backoff_steps: int = 4
    retry_backoff_cap: int = 64
    draft_cooldown_steps: int = 16
    step_timeout_s: Optional[float] = None
    straggler: StragglerConfig = dataclasses.field(
        default_factory=StragglerConfig)

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.retry_backoff_steps < 1 or self.retry_backoff_cap < 1:
            raise ValueError("retry backoff must be >= 1 step")

    def backoff(self, attempt: int) -> int:
        """Park duration in engine steps for retry number ``attempt``."""
        return min(self.retry_backoff_cap,
                   self.retry_backoff_steps * (2 ** max(0, attempt - 1)))


class ServingFault(RuntimeError):
    """A structured, post-mortem-friendly engine failure.

    Raised when degradation cannot contain a fault (today: the hard
    step-timeout).  Carries the fault kind, the engine step, and a
    JSON-serializable engine-state snapshot for post-mortem.
    """

    def __init__(self, message: str, kind: str, step: int,
                 snapshot: Optional[dict] = None):
        super().__init__(message)
        self.kind = kind
        self.step = step
        self.snapshot = snapshot or {}


class ServingFaultHandler:
    """Serving adaptation of :class:`repro_torch.runtime.fault.FaultHandler`.

    The training handler counts consecutive bad *steps* against one
    model; serving quarantines per *request*.  This tracks per-uid
    retry budgets and total dispositions so the engine's accounting has
    one owner.
    """

    def __init__(self, policy: FaultPolicy):
        self.policy = policy
        self.quarantined = 0
        self.retried = 0

    def disposition(self, req) -> Tuple[str, int]:
        """('retry', backoff_steps) or ('quarantine', 0) for a poisoned
        request.  Mutates ``req.retries`` on retry."""
        if req.retries < self.policy.max_retries:
            req.retries += 1
            self.retried += 1
            return "retry", self.policy.backoff(req.retries)
        self.quarantined += 1
        return "quarantine", 0
