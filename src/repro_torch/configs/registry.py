"""Architecture registry: ``--arch <id>`` lookup for the launchers.

The paper's three families at full width, the other ported decoder
families at their published width (``FAMILIES``; llava-next-mistral-7b's
projector takes image patches in calibration, evaluation and the plain
serve steps, while the serving engine serves it text-only), the encoder-decoder
(``ENCDEC``: whisper-small, calibrated, compressed, evaluated and decoded
but not served: the serving engine has no encoder-decoder path), plus the ``small-*`` variants whose
trained checkpoints the reference keeps under ``experiments/models/<name>/``
(same widths as the reference benchmarks' SMALL_CONFIGS, vocabulary 512)."""

from __future__ import annotations

from typing import Dict

from .base import ModelConfig
from .chatglm3_6b import CONFIG as CHATGLM3_6B
from .deepseek_67b import CONFIG as DEEPSEEK_67B
from .deepseek_v3_671b import CONFIG as DEEPSEEK_V3_671B
from .jamba_v0_1_52b import CONFIG as JAMBA_V0_1_52B
from .llava_next_mistral_7b import CONFIG as LLAVA_NEXT_MISTRAL_7B
from .minicpm3_4b import CONFIG as MINICPM3_4B
from .moonshot_v1_16b_a3b import CONFIG as MOONSHOT_V1_16B_A3B
from .phi3_medium_14b import CONFIG as PHI3_MEDIUM_14B
from .paper_models import LLAMA_7B, MISTRAL_7B, OPT_6_7B, small_lm
from .rwkv6_1_6b import CONFIG as RWKV6_1_6B
from .whisper_small import CONFIG as WHISPER_SMALL

PAPER: Dict[str, ModelConfig] = {
    "llama-7b": LLAMA_7B,
    "opt-6.7b": OPT_6_7B,
    "mistral-7b": MISTRAL_7B,
}

FAMILIES: Dict[str, ModelConfig] = {
    "chatglm3-6b": CHATGLM3_6B,
    "phi3-medium-14b": PHI3_MEDIUM_14B,
    "deepseek-67b": DEEPSEEK_67B,
    "minicpm3-4b": MINICPM3_4B,
    "rwkv6-1.6b": RWKV6_1_6B,
    "moonshot-v1-16b-a3b": MOONSHOT_V1_16B_A3B,
    "deepseek-v3-671b": DEEPSEEK_V3_671B,
    "jamba-v0.1-52b": JAMBA_V0_1_52B,
    "llava-next-mistral-7b": LLAVA_NEXT_MISTRAL_7B,
}

ENCDEC: Dict[str, ModelConfig] = {
    "whisper-small": WHISPER_SMALL,
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

ALL: Dict[str, ModelConfig] = {**PAPER, **FAMILIES, **ENCDEC, **SMALL}


def get_config(arch: str) -> ModelConfig:
    if arch not in ALL:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(ALL)}")
    return ALL[arch]
