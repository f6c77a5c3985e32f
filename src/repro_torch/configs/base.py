"""Model configuration: the subset of the reference config the port reads.

The port serves the paper's dense families (LLaMA / OPT / Mistral), the
dense GQA archs, Multi-head Latent Attention (minicpm3, and deepseek-v3
over a token-choice MoE), the RWKV-6 family, the token-choice MoE family
and the Mamba / attention hybrid (jamba over a top-2 MoE), calibrates,
compresses, evaluates and decodes the encoder-decoder (whisper), and runs
the vision frontend (llava: ``frontend == "vision"``, a projector over
``num_patches`` patch features in front of the tokens), so the frozen
dataclass keeps the reference's field names and defaults for every field
those families read.  ``reduced()`` is the reference's smoke-test shrink
(``num_patches`` 8).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    first_k_dense: int = 0  # leading layers use the dense FFN
    moe_every: int = 1  # MoE on layers with (i - first_k_dense) % moe_every == 0
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_inner: int
    d_state: int = 16
    d_conv: int = 4
    dt_rank: int = 0  # 0 => ceil(d_model / 16)


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

    attention: str = "gqa"  # gqa | mla
    pos_emb: str = "rope"  # rope | learned | none
    rotary_pct: float = 1.0
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    activation: str = "swiglu"  # swiglu | gelu
    tie_embeddings: bool = False
    mixer_pattern: Tuple[str, ...] = ("attn",)  # "attn" | "mamba" | "rwkv", cycled

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    mamba: Optional[MambaConfig] = None
    rwkv: Optional[RWKVConfig] = None

    # Encoder-decoder (whisper): encoder_layers > 0 enables it.
    encoder_layers: int = 0
    encoder_seq: int = 1500  # audio frames after the (stubbed) conv frontend
    frontend: str = "none"  # none | audio | vision
    num_patches: int = 576  # llava anyres base tile

    max_seq: int = 131072
    dtype: str = "bfloat16"
    subquadratic: bool = False  # sub-quadratic mixer (recurrent state)

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def mixer_of(self, layer: int) -> str:
        return self.mixer_pattern[layer % len(self.mixer_pattern)]

    def ffn_of(self, layer: int) -> str:
        if self.moe is None or layer < self.moe.first_k_dense:
            return "mlp"
        if (layer - self.moe.first_k_dense) % self.moe.moe_every == 0:
            return "moe"
        return "mlp"

    def layer_specs(self) -> Tuple[Tuple[str, str], ...]:
        """(mixer, ffn) per decoder layer — drives layer-stack grouping."""
        return tuple((self.mixer_of(i), self.ffn_of(i)) for i in range(self.num_layers))

    def reduced(self) -> "ModelConfig":
        """Smoke-test config: same family/topology, tiny dimensions."""
        scale_heads = max(2, min(self.num_heads, 4))
        kv = max(1, min(self.num_kv_heads, scale_heads)) if self.num_kv_heads else 0
        if self.num_kv_heads and self.num_heads % self.num_kv_heads == 0:
            group = self.num_heads // self.num_kv_heads
            kv = max(1, scale_heads // min(group, scale_heads))
        n_layers = max(2 * len(self.mixer_pattern), 2)
        moe = None
        if self.moe is not None:
            n_layers = max(n_layers, self.moe.first_k_dense + 2 * self.moe.moe_every)
            moe = dataclasses.replace(
                self.moe,
                num_experts=min(self.moe.num_experts, 8),
                top_k=min(self.moe.top_k, 2),
                d_ff_expert=32,
                num_shared_experts=min(self.moe.num_shared_experts, 1),
                # Lossless capacity, so prefill + decode equals the full
                # forward (dropping depends on the batch's composition).
                capacity_factor=8.0,
            )
        mla = None
        if self.mla is not None:
            mla = MLAConfig(q_lora_rank=16, kv_lora_rank=8, qk_nope_head_dim=8,
                            qk_rope_head_dim=4, v_head_dim=8)
        mamba = None
        if self.mamba is not None:
            mamba = MambaConfig(d_inner=64, d_state=4, d_conv=4, dt_rank=4)
        rwkv = None
        if self.rwkv is not None:
            rwkv = RWKVConfig(head_dim=8, decay_lora=8, mix_lora=4)
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=n_layers,
            d_model=32,
            num_heads=scale_heads,
            num_kv_heads=kv,
            d_ff=64,
            vocab_size=256,
            head_dim=8,
            moe=moe,
            mla=mla,
            mamba=mamba,
            rwkv=rwkv,
            encoder_layers=2 if self.encoder_layers else 0,
            encoder_seq=16 if self.encoder_layers else self.encoder_seq,
            num_patches=8,
            max_seq=128,
            dtype="float32",
        )
