"""Self-speculative decoding (the reference's ``serving/spec``).

NSVD's training-free compression gives every checkpoint a free draft model:
the same weights at a higher compression ratio.  The draft proposes ``k``
tokens per engine step (k+1 sequential cheap decodes over its own cache),
the target verifies them in one S=k+1 chunk-decode call, and batched
accept/resample on the device commits the accepted prefix plus one
correction or bonus token, rolling both caches' lengths back to the
committed prefix.

Pieces:
  config.SpecConfig  -- k, dynamic per-row windows, draft params and seed
  draft.DraftState   -- the draft's cache (paged or dense slab) and keys
  verify.verify_tail -- batched greedy / Leviathan accept-resample

The step roots are in ``launch/steps.py`` (``make_spec_draft_step``,
``make_spec_verify_step`` and the two draft prefill twins);
``serving/engine.py`` wires them into ``step()`` and admission.
"""

from repro_torch.serving.spec.config import SpecConfig
from repro_torch.serving.spec.draft import DraftState
from repro_torch.serving.spec.verify import verify_tail

__all__ = ["SpecConfig", "DraftState", "verify_tail"]
