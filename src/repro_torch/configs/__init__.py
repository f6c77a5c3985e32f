from .base import ModelConfig, MoEConfig, RWKVConfig
from .paper_models import LLAMA_7B, MISTRAL_7B, OPT_6_7B, small_lm
from .registry import (ALL, FAMILIES, MOONSHOT_V1_16B_A3B, PAPER, RWKV6_1_6B, SMALL,
                       get_config)
