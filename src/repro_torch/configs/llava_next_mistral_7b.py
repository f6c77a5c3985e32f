"""llava-next-mistral-7b — mistral-7b backbone + anyres vision stub.

[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000.  The vision tower /
anyres tiling is a stub: callers supply precomputed patch features (B,
num_patches, 1024), which the projector maps to d_model and puts in front
of the token embeddings.
The reference's config, copied: the port imports nothing of the reference.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    head_dim=128,
    attention="gqa",
    pos_emb="rope",
    rope_theta=1000000.0,
    norm="rmsnorm",
    activation="swiglu",
    frontend="vision",
    num_patches=576,
    max_seq=131072,
)
