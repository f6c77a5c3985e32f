"""Model facade: build a registered arch and the serving-layout queries."""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig

from .transformer import DecoderLM


def build_model(cfg: ModelConfig) -> DecoderLM:
    return DecoderLM(cfg)


# Cache leaves holding RECURRENT state (SSM/RWKV): their post-prefill value
# depends on every input position, so right-padding a prompt corrupts them.
# Attention leaves (k/v) are per-position and masked by cache_len.
RECURRENT_CACHE_LEAVES = frozenset({"h", "conv", "state", "shift_t", "shift_c"})

# Cache leaves a block-pool (paged) layout can host: per-position attention
# K/V plus their int8 dequant scales.  Anything else keeps the dense slab.
PAGEABLE_CACHE_LEAVES = frozenset({"k", "v", "k_scale", "v_scale"})


def cache_leaf_names(model: DecoderLM) -> frozenset:
    """Distinct cache leaf names of a model (meta tensors: no allocation)."""
    names = set()

    def walk(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v)
            else:
                names.add(k)

    walk(model.init_cache(1, 8, device="meta"))
    return frozenset(names)


def has_recurrent_cache(model: DecoderLM) -> bool:
    """True when the model carries recurrent state in its cache, i.e.
    prompts cannot be right-padded to bucketed prefill lengths."""
    return bool(cache_leaf_names(model) & RECURRENT_CACHE_LEAVES)


def prefill_pad_safe(model: DecoderLM) -> bool:
    """True when right-padding a prompt cannot change real positions'
    outputs, i.e. the serving engine may bucket prompt lengths.  Recurrent
    caches are pad-sensitive (the state folds in every input position);
    the ported attention stacks have no MoE, the reference's other
    pad-sensitive family."""
    return not has_recurrent_cache(model)


def cache_layout(model: DecoderLM) -> str:
    """How the serving engine lays out this model's decode cache.

    "paged": every cache leaf is per-position attention K/V (pure-GQA
    stacks), so the engine uses the block-table pools of ``serving/kvcache``
    with chunked prefill.  "dense": one (max_batch, ...) slab per leaf, for
    recurrent caches (RWKV), which are pad-sensitive at prefill."""
    if not prefill_pad_safe(model):
        return "dense"
    if not cache_leaf_names(model) <= PAGEABLE_CACHE_LEAVES:
        return "dense"
    return "paged"
