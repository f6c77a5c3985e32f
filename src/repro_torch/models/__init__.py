from .api import batch_inputs, build_model, cache_layout, prefill_pad_safe
from .encdec import EncDecLM
from .transformer import DecoderLM
