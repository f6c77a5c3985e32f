"""Architecture registry: ``--arch <id>`` lookup for the launchers.

The paper's three families at full width, the other ported families at
their published width (``FAMILIES``), plus the ``small-*`` variants whose
trained checkpoints the reference keeps under ``experiments/models/<name>/``
(same widths as the reference benchmarks' SMALL_CONFIGS, vocabulary 512)."""

from __future__ import annotations

from typing import Dict

from .base import ModelConfig
from .paper_models import LLAMA_7B, MISTRAL_7B, OPT_6_7B, small_lm
from .rwkv6_1_6b import CONFIG as RWKV6_1_6B

PAPER: Dict[str, ModelConfig] = {
    "llama-7b": LLAMA_7B,
    "opt-6.7b": OPT_6_7B,
    "mistral-7b": MISTRAL_7B,
}

FAMILIES: Dict[str, ModelConfig] = {
    "rwkv6-1.6b": RWKV6_1_6B,
}

SMALL_VOCAB = 512
SMALL: Dict[str, ModelConfig] = {
    "small-llama": small_lm("small-llama", LLAMA_7B, 4, 128, 352, SMALL_VOCAB),
    "small-llama-13b": small_lm("small-llama-13b", LLAMA_7B, 6, 192, 512,
                                SMALL_VOCAB),
    "small-opt": small_lm("small-opt", OPT_6_7B, 4, 128, 512, SMALL_VOCAB),
    "small-mistral": small_lm("small-mistral", MISTRAL_7B, 4, 128, 352,
                              SMALL_VOCAB),
}

ALL: Dict[str, ModelConfig] = {**PAPER, **FAMILIES, **SMALL}


def get_config(arch: str) -> ModelConfig:
    if arch not in ALL:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(ALL)}")
    return ALL[arch]
