"""chatglm3-6b — RoPE 2d (half-dim rotary), aggressive GQA kv=2.

[arXiv:2406.12793; hf]
28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024.  The reference's config,
copied: the port imports nothing of the reference.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    head_dim=128,
    attention="gqa",
    pos_emb="rope",
    rotary_pct=0.5,  # ChatGLM's 2d rope rotates half of each head dim
    rope_theta=10000.0,
    norm="rmsnorm",
    activation="swiglu",
    max_seq=131072,
)
