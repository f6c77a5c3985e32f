"""rwkv6-1.6b (Finch) — attention-free, data-dependent decay.

[arXiv:2404.05892; unverified]
24L d_model=2048 d_ff=7168 vocab=65536.  RWKV6 time-mix (64-dim heads,
data-dependent decay via LoRA) + channel-mix.  The reference's config,
copied: the port imports nothing of the reference.
"""

from .base import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,  # 2048 / 64 rwkv heads
    num_kv_heads=0,
    d_ff=7168,
    vocab_size=65536,
    head_dim=64,
    attention="none",
    pos_emb="none",
    norm="layernorm",
    activation="relu_sq",  # rwkv channel-mix uses squared relu
    mixer_pattern=("rwkv",),
    rwkv=RWKVConfig(head_dim=64, decay_lora=64, mix_lora=32),
    subquadratic=True,
    max_seq=1048576,
)
