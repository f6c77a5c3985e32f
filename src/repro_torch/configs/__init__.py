from .base import MambaConfig, MLAConfig, ModelConfig, MoEConfig, RWKVConfig
from .paper_models import LLAMA_7B, MISTRAL_7B, OPT_6_7B, small_lm
from .registry import (ALL, CHATGLM3_6B, DEEPSEEK_67B, DEEPSEEK_V3_671B, ENCDEC, FAMILIES,
                       JAMBA_V0_1_52B, LLAVA_NEXT_MISTRAL_7B, MINICPM3_4B,
                       MOONSHOT_V1_16B_A3B, PAPER, PHI3_MEDIUM_14B, RWKV6_1_6B, SMALL,
                       WHISPER_SMALL, get_config)
