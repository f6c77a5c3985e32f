from .base import ModelConfig, RWKVConfig
from .paper_models import LLAMA_7B, MISTRAL_7B, OPT_6_7B, small_lm
from .registry import ALL, FAMILIES, PAPER, RWKV6_1_6B, SMALL, get_config
