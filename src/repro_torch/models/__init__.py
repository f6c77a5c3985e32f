from .api import build_model, cache_layout, prefill_pad_safe
from .transformer import DecoderLM
