"""deepseek-67b — dense llama-arch.  [arXiv:2401.02954; hf]

95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400.  The reference's config,
copied: the port imports nothing of the reference.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    num_layers=95,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=102400,
    head_dim=128,
    attention="gqa",
    pos_emb="rope",
    rope_theta=10000.0,
    norm="rmsnorm",
    activation="swiglu",
    max_seq=131072,
)
