"""moonshot-v1-16b-a3b — Kimi / Moonlight MoE, 64 experts top-6.

[hf:moonshotai/Moonlight-16B-A3B]
48L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=163840, MoE 64e top-6,
2 shared experts, a dense first layer.  The reference's config, copied: the
port imports nothing of the reference.
"""

from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=11264,  # dense first layer FFN (moonlight: 8 * 1408)
    vocab_size=163840,
    head_dim=128,
    attention="gqa",
    pos_emb="rope",
    rope_theta=50000.0,
    norm="rmsnorm",
    activation="swiglu",
    moe=MoEConfig(
        num_experts=64,
        top_k=6,
        d_ff_expert=1408,
        num_shared_experts=2,
        first_k_dense=1,
        moe_every=1,
    ),
    max_seq=131072,
)
