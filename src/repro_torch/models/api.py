"""Model facade: build a registered arch, a batch's model inputs and the
serving-layout queries."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.parallel.sharding import NONE_PARALLEL, P, Parallelism

from .encdec import EncDecLM
from .transformer import DecoderLM, tensor_parallel_refusal

Model = Union[DecoderLM, EncDecLM]


def build_model(cfg: ModelConfig, par: Parallelism = NONE_PARALLEL) -> Model:
    """The model facade; ``par``: the mesh it runs on (``DecoderLM``)."""
    if cfg.is_encdec:
        if par.active and par.tp_size > 1:
            raise ValueError(tensor_parallel_refusal(cfg, par.tp_size))
        return EncDecLM(cfg)
    return DecoderLM(cfg, par)


def batch_inputs(model: Model, batch, device) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """(tokens, apply kwargs) on ``device`` of one calibration or eval batch:
    the reference's dict, ``{"tokens"}`` plus ``"frames"`` for an
    encoder-decoder model or, when it has them, ``"patches"`` (B, P, 1024)
    for a decoder-only model (llava's image features, fp32 as given), or a
    bare (B, S) token array, taken as the tokens (a decoder-only model's)."""
    if not isinstance(batch, dict):
        batch = {"tokens": batch}
    kwargs = {}
    if model.cfg.is_encdec:
        if "frames" not in batch:
            raise ValueError(f"{model.cfg.name} is an encoder-decoder: its batches are "
                             "dicts with 'tokens' and 'frames' (B, encoder_seq, d_model)")
        kwargs["frames"] = torch.as_tensor(batch["frames"], device=device)
    elif "patches" in batch:
        kwargs["patches"] = torch.as_tensor(batch["patches"], device=device)
    return torch.as_tensor(batch["tokens"], device=device), kwargs


# Cache leaves holding RECURRENT state (SSM/RWKV): their post-prefill value
# depends on every input position, so right-padding a prompt corrupts them.
# Attention leaves (k/v) are per-position and masked by cache_len.
RECURRENT_CACHE_LEAVES = frozenset({"h", "conv", "state", "shift_t", "shift_c"})

# Cache leaves a block-pool (paged) layout can host: per-position attention
# K/V plus their int8 dequant scales.  Anything else (recurrent state, MLA's
# latents c_kv and k_rope) keeps the dense slab.
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


def cache_bytes_per_token(model: Model, kv_quant: bool = False) -> int:
    """Bytes one token takes in the model's decode cache over all layers:
    what a one-row slab on the meta device grows by from one position to
    two (K/V, int8 K/V and their scales with ``kv_quant``, or MLA's
    latents; the paged pools hold the same bytes a token)."""
    def nbytes(tree):
        return sum(nbytes(v) if isinstance(v, dict) else v.numel() * v.element_size()
                   for v in tree.values())
    return (nbytes(model.init_cache(1, 2, device="meta", kv_quant=kv_quant))
            - nbytes(model.init_cache(1, 1, device="meta", kv_quant=kv_quant)))


# Cache leaves: name -> ndim of one layer's leaf (a stacked group adds a
# leading layer dim, so the batch or block axis is ndim - base), and, for
# the leaves that hold heads, the head dim's index past that axis.
CACHE_LEAF_NDIM = {"state": 4, "shift_t": 2, "shift_c": 2, "h": 3, "conv": 3,
                   "k": 4, "v": 4, "k_scale": 3, "v_scale": 3, "c_kv": 3, "k_rope": 3}
_CACHE_HEAD_DIM = {"k": 2, "v": 2, "k_scale": 2, "v_scale": 2, "state": 1}


def serving_cache_pspecs(model: Model, par: Parallelism, *,
                         max_batch: Optional[int] = None, max_len: Optional[int] = None,
                         num_blocks: Optional[int] = None,
                         block_size: Optional[int] = None,
                         kv_quant: bool = False) -> Any:
    """PartitionSpec tree of what each rank of a serving mesh holds of the
    decode cache.  Pass (num_blocks, block_size) for the paged layout or
    (max_batch, max_len) for the dense slab.  As the reference's: the pools'
    block dim (each DP shard a range of blocks, beside its own write sink)
    or the slab's batch dim over the DP axes when it divides them.  Unlike
    the reference's, which keeps the cache whole over TP, the heads of the
    attention K/V (and RWKV-6's state) split over the model axis: a rank's
    pools hold the heads its attention computes."""
    if (num_blocks is None) == (max_batch is None):
        raise ValueError("pass exactly one of num_blocks (paged) or max_batch (dense)")
    whole = build_model(model.cfg)
    shapes = (whole.init_paged_cache(num_blocks, block_size, kv_quant=kv_quant,
                                     device="meta") if num_blocks is not None
              else whole.init_cache(max_batch, max_len, kv_quant=kv_quant, device="meta"))
    lead = num_blocks if num_blocks is not None else max_batch
    dp_ok = par.active and lead % par.dp_size == 0
    tp = par.tp_size if par.active else 1

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) if isinstance(v, dict) else spec(k, v)
                    for k, v in tree.items()}

    def spec(name, leaf):
        ax = leaf.ndim - CACHE_LEAF_NDIM[name]
        entries = [None] * leaf.ndim
        if dp_ok:
            entries[ax] = par.dp
        head = _CACHE_HEAD_DIM.get(name)
        if head is not None and tp > 1 and leaf.shape[ax + head] % tp == 0:
            entries[ax + head] = par.tp_axis
        return P(*entries)

    return walk(shapes)


def has_recurrent_cache(model: DecoderLM) -> bool:
    """True when the model carries recurrent state in its cache, i.e.
    prompts cannot be right-padded to bucketed prefill lengths."""
    return bool(cache_leaf_names(model) & RECURRENT_CACHE_LEAVES)


def prefill_pad_safe(model: DecoderLM) -> bool:
    """True when right-padding a prompt cannot change real positions'
    outputs, i.e. the serving engine may bucket prompt lengths.  Two
    families are pad-sensitive: recurrent caches (the state folds in every
    input position) and token-choice MoE (expert capacity is budgeted over
    the flattened token batch, so padding tokens compete for, and can evict
    real tokens from, expert slots), whatever the mixer: deepseek-v3's
    (mla, moe) layers make it pad-sensitive although MLA alone is not, and
    jamba is so twice over (the Mamba layers' ``h`` and ``conv``, and its
    MoE layers)."""
    return not has_recurrent_cache(model) and model.cfg.moe is None


def cache_layout(model: Model) -> str:
    """How the serving engine lays out this model's decode cache.

    "paged": every cache leaf is per-position attention K/V (pure-GQA
    stacks), so the engine uses the block-table pools of ``serving/kvcache``
    with chunked prefill.  "dense": one (max_batch, ...) slab per leaf, for
    the families that are pad-sensitive at prefill (recurrent caches (RWKV)
    and token-choice MoE: exact-length admission) and for MLA, whose latent
    leaves are not paged K/V but which is pad-safe (bucketed admission,
    ``prefill_pad_safe``).  deepseek-v3's (mla, moe) stack takes the dense
    latent slab with exact-length admission (its MoE layers are
    pad-sensitive); like minicpm3 it has no paged or int8 form, so the
    engine refuses ``paged=True`` and ``kv_quant``.  jamba's cache tree
    mixes the Mamba layers' recurrent ``{h, conv}`` with its attention
    layer's (max_batch, max_len) K/V slab: dense, one exact-length
    admission a prompt; ``paged=True`` and speculative decoding are
    refused, as for RWKV-6, and ``kv_quant`` quantizes the attention
    layer's slab only.  A vision model (llava) adds no cache leaf: its
    projector runs only where patches are given, and the engine serves it
    text-only, as the reference's.  An encoder-decoder's cross slabs
    are not paged K/V: "dense", as the reference says (its serving engine
    has no encoder-decoder path, and the port's refuses one)."""
    if model.cfg.is_encdec:
        return "dense"
    if not prefill_pad_safe(model):
        return "dense"
    if not cache_leaf_names(model) <= PAGEABLE_CACHE_LEAVES:
        return "dense"
    return "paged"


def build_draft_params(model: DecoderLM, params, grams, ratio: float,
                       method: str = "nsvd1"):
    """The self-speculative draft: ``params`` factored at a HIGHER
    compression ratio than the serving target (same architecture, cheaper
    matmuls; the factored leaves dispatch through ``linear_apply``).  One
    more ``build_plan`` + ``compress_params`` over the Grams the target's
    compression already collected.  The factors take the model's dtype, as
    ``launch.serve`` builds its target: bf16 factors keep the draft's
    decodes on the nested stream and mma kernels.  Pass the result as
    ``SpecConfig(draft_params=...)`` (serving/spec)."""
    from repro_torch.core import CompressionConfig, build_plan, compress_params

    if not 0.0 < ratio < 1.0:
        raise ValueError(f"draft compression ratio must be in (0, 1), got {ratio}")
    plan = build_plan(model.compressible_targets(), CompressionConfig(
        method=method, ratio=ratio, dtype=model.cfg.dtype, use_randomized=False))
    return compress_params(params, plan, grams)
