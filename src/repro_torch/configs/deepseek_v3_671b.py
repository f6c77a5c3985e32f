"""deepseek-v3-671b — MLA + MoE 256e top-8, 1 shared expert.

[arXiv:2412.19437; hf]
61L d_model=7168 128H d_ff=2048(expert) vocab=129280, MoE 256e top-8,
MLA (q_lora 1536, kv_lora 512, nope 128, rope 64, v 128), first 3 layers
dense FFN (d_ff 18432).  The MTP head is omitted, as in the reference.
The reference's config, copied: the port imports nothing of the reference.
"""

from .base import MLAConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    d_ff=18432,  # dense layers 0-2
    vocab_size=129280,
    head_dim=128,
    attention="mla",
    pos_emb="rope",
    rope_theta=10000.0,
    norm="rmsnorm",
    activation="swiglu",
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        num_experts=256,
        top_k=8,
        d_ff_expert=2048,
        num_shared_experts=1,
        first_k_dense=3,
        moe_every=1,
        capacity_factor=1.25,
    ),
    max_seq=131072,
)
