from .base import ModelConfig
from .paper_models import LLAMA_7B, MISTRAL_7B, OPT_6_7B, small_lm
from .registry import ALL, PAPER, SMALL, get_config
