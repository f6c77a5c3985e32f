"""Model facade: build a registered arch and the serving-layout queries."""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig

from .transformer import DecoderLM


def build_model(cfg: ModelConfig) -> DecoderLM:
    return DecoderLM(cfg)


def prefill_pad_safe(model: DecoderLM) -> bool:
    """True when right-padding a prompt cannot change real positions'
    outputs.  Every ported (gqa, mlp) stack is pad-safe: attention caches
    are per position and masked by length (no recurrent state, no MoE)."""
    return True


def cache_layout(model: DecoderLM) -> str:
    """How the serving engine lays out this model's decode cache.  Every
    ported model is a pure-attention stack, so "paged" (block-table pools);
    the reference's dense-slab layout serves families not yet ported."""
    return "paged"
