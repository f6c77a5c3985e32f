"""The paper's own model families (LLaMA / OPT / Mistral), as configs."""

import dataclasses

from .base import ModelConfig

LLAMA_7B = ModelConfig(
    name="llama-7b", family="dense", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=32, d_ff=11008, vocab_size=32000,
    head_dim=128, attention="gqa", pos_emb="rope", norm="rmsnorm",
    activation="swiglu", max_seq=4096,
)

OPT_6_7B = ModelConfig(
    name="opt-6.7b", family="dense", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=32, d_ff=16384, vocab_size=50272,
    head_dim=128, attention="gqa", pos_emb="learned", norm="layernorm",
    activation="gelu", max_seq=2048,
)

MISTRAL_7B = ModelConfig(
    name="mistral-7b", family="dense", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=8, d_ff=14336, vocab_size=32000,
    head_dim=128, attention="gqa", pos_emb="rope", norm="rmsnorm",
    activation="swiglu", max_seq=32768,
)


def small_lm(
    name: str = "small-llama",
    family_of: ModelConfig = LLAMA_7B,
    num_layers: int = 4,
    d_model: int = 128,
    d_ff: int = 352,
    vocab_size: int = 512,
    num_heads: int = 4,
) -> ModelConfig:
    """Trainable-on-CPU analogue of a paper family (keeps norm/act/pos-emb)."""
    kv = num_heads
    if family_of.num_kv_heads and family_of.num_heads % family_of.num_kv_heads == 0:
        group = family_of.num_heads // family_of.num_kv_heads
        kv = max(1, num_heads // min(group, num_heads))
    return dataclasses.replace(
        family_of,
        name=name,
        num_layers=num_layers,
        d_model=d_model,
        d_ff=d_ff,
        vocab_size=vocab_size,
        num_heads=num_heads,
        num_kv_heads=kv,
        head_dim=d_model // num_heads,
        max_seq=512,
        dtype="float32",
    )
