"""phi3-medium-14b — dense, RoPE + SwiGLU + GQA.  [arXiv:2404.14219; unverified]

40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352.  The reference's config,
copied: the port imports nothing of the reference.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=10,
    d_ff=17920,
    vocab_size=100352,
    head_dim=128,
    attention="gqa",
    pos_emb="rope",
    rope_theta=10000.0,
    norm="rmsnorm",
    activation="swiglu",
    max_seq=131072,
)
