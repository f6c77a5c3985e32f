"""AdamW, learning-rate schedules and gradient compression (the
reference's ``optim``; its ZeRO-1 sharding helpers wait for the
parallelism slice)."""

from .adamw import AdamWConfig, AdamWState, apply_updates, global_norm, init_state
from .grad import compress_grad, decompress_grad, roundtrip
from .schedule import constant, inverse_sqrt, linear_warmup_cosine
