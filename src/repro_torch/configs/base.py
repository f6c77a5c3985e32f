"""Model configuration: the subset of the reference config the port reads.

The port serves the paper's dense families (LLaMA / OPT / Mistral) and the
RWKV-6 family, so the frozen dataclass keeps the reference's field names and
defaults for every field those families read; the other family sub-configs
(MoE, MLA, Mamba) are not ported yet.  ``reduced()`` is the reference's
smoke-test shrink.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    decay_lora: int = 64
    mix_lora: int = 32


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 => d_model // num_heads

    attention: str = "gqa"
    pos_emb: str = "rope"  # rope | learned | none
    rotary_pct: float = 1.0
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    activation: str = "swiglu"  # swiglu | gelu
    tie_embeddings: bool = False
    mixer_pattern: Tuple[str, ...] = ("attn",)  # "attn" | "rwkv", cycled

    rwkv: Optional[RWKVConfig] = None

    max_seq: int = 131072
    dtype: str = "bfloat16"
    subquadratic: bool = False  # sub-quadratic mixer (recurrent state)

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    def layer_specs(self) -> Tuple[Tuple[str, str], ...]:
        """(mixer, ffn) per decoder layer — drives layer-stack grouping."""
        return tuple(
            (self.mixer_pattern[i % len(self.mixer_pattern)], "mlp")
            for i in range(self.num_layers)
        )

    def reduced(self) -> "ModelConfig":
        """Smoke-test config: same family/topology, tiny dimensions."""
        scale_heads = max(2, min(self.num_heads, 4))
        kv = max(1, min(self.num_kv_heads, scale_heads)) if self.num_kv_heads else 0
        if self.num_kv_heads and self.num_heads % self.num_kv_heads == 0:
            group = self.num_heads // self.num_kv_heads
            kv = max(1, scale_heads // min(group, scale_heads))
        rwkv = None
        if self.rwkv is not None:
            rwkv = RWKVConfig(head_dim=8, decay_lora=8, mix_lora=4)
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=max(2 * len(self.mixer_pattern), 2),
            d_model=32,
            num_heads=scale_heads,
            num_kv_heads=kv,
            d_ff=64,
            vocab_size=256,
            head_dim=8,
            rwkv=rwkv,
            max_seq=128,
            dtype="float32",
        )
