"""Speculative-decoding configuration for the serving engine."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass
class SpecConfig:
    """Self-speculative decoding: a higher-compression NSVD twin (or any
    param tree of the same architecture) drafts ``k`` tokens per engine
    step; the target verifies them in one chunk-decode call and commits
    the accepted prefix plus one correction or bonus token.

    draft_params: param tree for the draft forward.  Same model object as
        the target: factored leaves dispatch through ``linear_apply`` like
        any compressed checkpoint.  ``models.api.build_draft_params``
        builds one from a compression plan.
    k: speculation window, draft tokens proposed per step.  Each step
        commits between 1 and k+1 tokens.
    dynamic_k: per-row adaptive window.  Rows start at ``k``; a step that
        accepts its whole window grows the row's window by one (capped at
        ``k``), a step that accepts nothing shrinks it (floored at 1).
        Shapes stay fixed (the window masks acceptance; the draft loop
        keeps its length), so this trades committed tokens for acceptance
        rate, not FLOPs.
    seed: draft-side key seed, independent of the target's sampling keys
        (proposals draw from draft keys, accept/resample from target keys).
    draft_ratio: optional metadata, the NSVD ratio the draft was built at;
        the decode path never reads it.
    """

    draft_params: Any
    k: int = 4
    dynamic_k: bool = False
    seed: int = 1234
    draft_ratio: Optional[float] = None

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"spec k must be >= 1, got {self.k}")
