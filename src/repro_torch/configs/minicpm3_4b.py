"""minicpm3-4b — dense with MLA.  [hf:openbmb/MiniCPM3-4B; hf]

62L d_model=2560 40H d_ff=6400 vocab=73448; MLA q_lora 768, kv_lora 256,
qk nope 64 + rope 32, v 64.  The reference's config,
copied: the port imports nothing of the reference.
"""

from .base import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    num_layers=62,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,
    d_ff=6400,
    vocab_size=73448,
    head_dim=64,
    attention="mla",
    pos_emb="rope",
    rope_theta=10000.0,
    norm="rmsnorm",
    activation="swiglu",
    mla=MLAConfig(
        q_lora_rank=768,
        kv_lora_rank=256,
        qk_nope_head_dim=64,
        qk_rope_head_dim=32,
        v_head_dim=64,
    ),
    max_seq=131072,
)
