"""jamba-v0.1-52b — Mamba+attention 1:7 interleave with MoE 16e top-2.

[arXiv:2403.19887; hf]
32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536.  Jamba period-8
blocks: attention at index 4 of each 8-layer block, Mamba elsewhere; MoE on
every other layer (odd indices), dense MLP otherwise.  Sub-quadratic.
The reference's config, copied: the port imports nothing of the reference.
"""

from .base import MambaConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    head_dim=128,
    attention="gqa",
    pos_emb="none",  # jamba uses no positional encoding (mamba provides order)
    norm="rmsnorm",
    activation="swiglu",
    mixer_pattern=(
        "mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba",
    ),
    moe=MoEConfig(
        num_experts=16,
        top_k=2,
        d_ff_expert=14336,
        num_shared_experts=0,
        first_k_dense=1,
        moe_every=2,
    ),
    mamba=MambaConfig(d_inner=8192, d_state=16, d_conv=4, dt_rank=256),
    subquadratic=True,
    max_seq=1048576,
)
