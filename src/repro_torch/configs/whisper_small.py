"""whisper-small — encoder-decoder with stubbed conv/audio frontend.

[arXiv:2212.04356; unverified]
12L(dec)+12L(enc) d_model=768 12H d_ff=3072 vocab=51865, LayerNorm + GELU,
learned positions.  The conv frontend is a stub: callers supply
precomputed frame embeddings (B, encoder_seq, d_model).
The reference's config, copied: the port imports nothing of the reference.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    head_dim=64,
    attention="gqa",
    pos_emb="learned",
    norm="layernorm",
    activation="gelu",
    encoder_layers=12,
    encoder_seq=1500,
    frontend="audio",
    max_seq=448 * 128,  # decoder positions stretched to cover assigned shapes
)
