"""AdamW with ZeRO-1's state specs, learning-rate schedules and gradient
compression (the reference's ``optim``)."""

from .adamw import (AdamWConfig, AdamWState, apply_updates, global_norm, init_state,
                    state_pspecs, zero_pspec)
from .grad import compress_grad, decompress_grad, roundtrip
from .schedule import constant, inverse_sqrt, linear_warmup_cosine
