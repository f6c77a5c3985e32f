"""Block assembly + layer stacking for the ported layer kinds: (gqa, mlp),
(gqa, moe), (mla, mlp), (mla, moe), (mamba, mlp), (mamba, moe) and (rwkv,
cmix).

A layer is pre-norm: x = x + mixer(norm1(x)); x = x + ffn(norm2(x)), the
mixer one of GQA attention, Multi-head Latent Attention, the Mamba (S6)
mixer or the RWKV-6 time mix, the ffn an MLP, a token-choice MoE or the
RWKV-6 channel mix.  An encoder-decoder's decoder layer (``cross``) puts
cross-attention over the encoder's memory between the two:
x = x + cross(norm_cross(x), memory), its K/V written into the layer's
cross slab at prefill and read from it at decode; its encoder layer runs
the gqa mixer unmasked ("bidir").  The mixer and the ffn are resolved and built
independently, as the reference's: (mla, moe) is deepseek-v3's MoE layer
(MLA's latent slab and taps ``…attn.*`` beside the MoE's ``…moe.*``), and
jamba's period of 8 holds (mamba, mlp), (mamba, moe) and one (gqa, mlp)
layer whose K/V slab sits in the same cache tree as the Mamba layers'
recurrent ``{h, conv}`` (key ``"mamba"``).  Layers with identical specs
are stacked exactly as the reference stacks them for ``lax.scan`` (params
carry a leading repeats dim), so the param tree keys and shapes match a
reference checkpoint; here the stack runs as a Python loop over layer
slices.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig

from . import attention as attn_mod
from . import mamba as mamba_mod
from . import mla as mla_mod
from . import moe as moe_mod
from . import rwkv6 as rwkv_mod
from .layers import linear, mlp_apply, mlp_init, norm_apply, norm_init

BlockSpec = Tuple[str, str]  # (mixer, ffn)


def resolve_specs(cfg: ModelConfig) -> Tuple[BlockSpec, ...]:
    """Config-level layer specs -> (mixer, ffn) pairs, the mixer and the ffn
    resolved independently as the reference's: "attn" is "mla" when the
    config's attention is MLA, else "gqa", over an "mlp" or "moe" ffn (so
    deepseek-v3 gives (mla, mlp) x 3 then (mla, moe)); "mamba" keeps its
    ffn (jamba: (mamba, mlp), (mamba, moe) and (gqa, mlp) in its period);
    "rwkv" takes the channel mix."""
    out = []
    for mixer, ffn in cfg.layer_specs():
        if mixer == "attn" and cfg.attention in ("gqa", "mla") and ffn in ("mlp", "moe"):
            out.append((cfg.attention, ffn))
        elif mixer == "mamba" and cfg.mamba is not None and ffn in ("mlp", "moe"):
            out.append(("mamba", ffn))
        elif mixer == "rwkv" and cfg.rwkv is not None:
            out.append(("rwkv", "cmix"))
        else:
            raise ValueError(f"{cfg.name}: only (gqa|mla|mamba, mlp|moe) and (rwkv, cmix) "
                             f"layers are ported, got ({mixer}/{cfg.attention}, {ffn})")
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class StackGroup:
    period: Tuple[BlockSpec, ...]
    repeats: int
    first_layer: int

    @property
    def num_layers(self) -> int:
        return len(self.period) * self.repeats


def group_layers(specs: Sequence[BlockSpec], max_prefix: int = 8) -> List[StackGroup]:
    """Decompose layer specs into [prefix runs] + [periodic stack group]."""
    n = len(specs)
    best = None  # (cost, prefix, q)
    for prefix in range(0, min(max_prefix, n) + 1):
        rem = n - prefix
        if rem == 0:
            cand = (prefix, prefix, 0)
        else:
            q = next(qq for qq in range(1, rem + 1) if rem % qq == 0 and all(
                specs[prefix + i] == specs[prefix + (i % qq)] for i in range(rem)))
            cand = (prefix + q, prefix, q)
        if best is None or cand[0] < best[0]:
            best = cand
    _, prefix, q = best
    groups: List[StackGroup] = []
    i = 0
    while i < prefix:
        j = i
        while j < prefix and specs[j] == specs[i]:
            j += 1
        groups.append(StackGroup((specs[i],), j - i, i))
        i = j
    if q:
        groups.append(StackGroup(tuple(specs[prefix:prefix + q]),
                                 (n - prefix) // q, prefix))
    return groups


def block_init(gen, spec: BlockSpec, cfg: ModelConfig, dtype, device,
               cross: bool = False) -> Dict:
    """One layer's params; ``cross`` adds an encoder-decoder's cross-attention
    (``norm_cross``, ``cross``) to a (gqa, mlp) layer."""
    if cross and spec != ("gqa", "mlp"):
        raise ValueError(f"cross-attention is ported for (gqa, mlp) layers, got {spec}")
    if spec == ("rwkv", "cmix"):
        return {
            "norm1": norm_init(cfg.norm, cfg.d_model, dtype, device),
            "rwkv_t": rwkv_mod.rwkv_time_mix_init(gen, cfg, dtype, device),
            "norm2": norm_init(cfg.norm, cfg.d_model, dtype, device),
            "rwkv_c": rwkv_mod.rwkv_channel_mix_init(gen, cfg, dtype, device),
        }
    key, mixer_init = {"mla": ("attn", mla_mod.mla_init),
                       "gqa": ("attn", attn_mod.attention_init),
                       "mamba": ("mamba", mamba_mod.mamba_init)}[spec[0]]
    p = {"norm1": norm_init(cfg.norm, cfg.d_model, dtype, device),
         key: mixer_init(gen, cfg, dtype, device),
         "norm2": norm_init(cfg.norm, cfg.d_model, dtype, device)}
    if cross:
        p["norm_cross"] = norm_init(cfg.norm, cfg.d_model, dtype, device)
        p["cross"] = attn_mod.attention_init(gen, cfg, dtype, device)
    if spec[1] == "moe":
        p["moe"] = moe_mod.moe_init(gen, cfg, dtype, device)
    else:
        p["mlp"] = mlp_init(gen, cfg.activation, cfg.d_model, cfg.d_ff, dtype, device)
    return p


def _stack(trees: List[Dict]) -> Dict:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def group_init(gen, group: StackGroup, cfg: ModelConfig, dtype, device,
               cross: bool = False) -> Dict:
    """{"sub{j}": block params}, with a leading repeats dim when stacked."""
    def one():
        return {f"sub{j}": block_init(gen, spec, cfg, dtype, device, cross)
                for j, spec in enumerate(group.period)}
    if group.repeats == 1:
        return one()
    return _stack([one() for _ in range(group.repeats)])


def block_cache_init(spec: BlockSpec, cfg: ModelConfig, batch: int, max_len: int,
                     dtype, device, cross: bool = False, kv_quant: bool = False,
                     tp: int = 1) -> Dict:
    """One layer's dense-slab cache rows: the recurrent state for rwkv and
    mamba (``h`` and the conv tail, whatever ``max_len``), the (batch,
    max_len) latent slab (c_kv, k_rope) for mla, the (batch, max_len) K/V
    slab for gqa (int8 with ``kv_quant``, as the reference's: only this
    slab is quantized); a decoder layer with ``cross`` also its (batch,
    encoder_seq) cross K/V slab, in ``dtype``.  ``tp``: a rank's share of
    the heads under a mesh's model axis (gqa and rwkv)."""
    if spec[0] == "rwkv":
        return {"rwkv": rwkv_mod.init_rwkv_cache(cfg, batch, dtype, device, tp)}
    if spec[0] == "mamba":
        return {"mamba": mamba_mod.init_mamba_cache(cfg, batch, dtype, device)}
    if spec[0] == "mla":
        return {"attn": mla_mod.init_mla_cache(cfg, batch, max_len, dtype, device)}
    c = {"attn": attn_mod.init_kv_cache(cfg, batch, max_len, dtype, device, kv_quant, tp)}
    if cross:
        c["cross"] = attn_mod.init_kv_cache(cfg, batch, cfg.encoder_seq, dtype, device)
    return c


def group_cache_init(group: StackGroup, cfg: ModelConfig, batch: int, max_len: int,
                     dtype, device, cross: bool = False, kv_quant: bool = False,
                     tp: int = 1) -> Dict:
    def one():
        return {f"sub{j}": block_cache_init(spec, cfg, batch, max_len, dtype, device,
                                            cross, kv_quant, tp)
                for j, spec in enumerate(group.period)}
    if group.repeats == 1:
        return one()
    return _stack([one() for _ in range(group.repeats)])


def group_paged_cache_init(group: StackGroup, cfg: ModelConfig, num_blocks: int,
                           block_size: int, dtype, device,
                           kv_quant: bool = False, tp: int = 1) -> Dict:
    if any(spec[0] != "gqa" for spec in group.period):
        raise ValueError(f"paged KV cache requires attention (gqa) layers, got "
                         f"{group.period}; see models.api.cache_layout")

    def one():
        return {f"sub{j}": {"attn": attn_mod.init_paged_kv_cache(
            cfg, num_blocks, block_size, dtype, device, kv_quant, tp)}
            for j in range(len(group.period))}
    if group.repeats == 1:
        return one()
    return _stack([one() for _ in range(group.repeats)])


def _index(tree, r: int):
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return tree[r]


def _cross_cached(params: Mapping, x: torch.Tensor, cfg: ModelConfig,
                  cross_cache: Dict) -> torch.Tensor:
    """Decode-time cross-attention against the K/V the prefill wrote."""
    b, s, _ = x.shape
    q = linear(params["wq"], x).reshape(b, s, cfg.num_heads, cfg.head_dim)
    out = attn_mod._cross_attention(q, cross_cache["k"], cross_cache["v"],
                                    1.0 / math.sqrt(cfg.head_dim))
    return linear(params["wo"], out.reshape(b, s, -1))


def block_apply(params: Mapping, x: torch.Tensor, spec: BlockSpec, cfg: ModelConfig, *,
                positions, mode: str, cache=None, cache_len=None,
                block_tables=None, taps=None, tap_prefix: str = "",
                memory: Optional[torch.Tensor] = None,
                encoder: bool = False, aux: Optional[List] = None) -> torch.Tensor:
    """mode "train" (causal, no cache), "prefill" (causal, writing a fresh
    dense cache) or "decode" (paged with ``block_tables``, else the dense
    slab).  ``encoder``: the gqa mixer runs unmasked.  A block with
    ``cross`` params attends ``memory`` after its mixer (train and
    prefill; prefill also writes the cross slab) or, at decode, the cross
    slab the prefill wrote."""
    if spec == ("rwkv", "cmix"):
        c = None if cache is None else cache["rwkv"]
        mixer_mode = "decode" if mode == "decode" else "causal"
        h = norm_apply(params["norm1"], x)
        x = x + rwkv_mod.rwkv_time_mix(params["rwkv_t"], h, cfg, mode=mixer_mode,
                                       cache=c, taps=taps,
                                       tap_prefix=f"{tap_prefix}.rwkv_t")
        h = norm_apply(params["norm2"], x)
        return x + rwkv_mod.rwkv_channel_mix(params["rwkv_c"], h, cfg, mode=mixer_mode,
                                             cache=c, taps=taps,
                                             tap_prefix=f"{tap_prefix}.rwkv_c")
    h = norm_apply(params["norm1"], x)
    mixer_mode = "decode" if mode == "decode" else "causal"
    if spec[0] == "mamba":
        if block_tables is not None:
            raise ValueError("Mamba's recurrent state has no paged form; see "
                             "models.api.cache_layout")
        x = x + mamba_mod.mamba_apply(params["mamba"], h, cfg, mode=mixer_mode,
                                      cache=None if cache is None else cache["mamba"],
                                      taps=taps, tap_prefix=f"{tap_prefix}.mamba")
    elif spec[0] == "mla":
        if block_tables is not None:
            raise ValueError("MLA's latent cache has no paged form; see "
                             "models.api.cache_layout")
        x = x + mla_mod.mla_apply(params["attn"], h, cfg, positions, mode=mixer_mode,
                                  cache=None if cache is None else cache["attn"],
                                  cache_len=cache_len, taps=taps,
                                  tap_prefix=f"{tap_prefix}.attn")
    else:
        x = x + attn_mod.attention_apply(
            params["attn"], h, cfg, positions, mode="bidir" if encoder else mixer_mode,
            cache=None if cache is None else cache["attn"],
            cache_len=cache_len, block_tables=block_tables, taps=taps,
            tap_prefix=f"{tap_prefix}.attn")
    if "cross" in params:
        h = norm_apply(params["norm_cross"], x)
        if mode == "decode":
            x = x + _cross_cached(params["cross"], h, cfg, cache["cross"])
        else:
            x = x + attn_mod.attention_apply(
                params["cross"], h, cfg, positions, mode="cross", memory=memory,
                cache=None if cache is None else cache["cross"], taps=taps,
                tap_prefix=f"{tap_prefix}.cross", key="cross")
    h = norm_apply(params["norm2"], x)
    if spec[1] == "moe":
        y, layer_aux = moe_mod.moe_apply(params["moe"], h, cfg, taps=taps,
                                         tap_prefix=f"{tap_prefix}.moe")
        if aux is not None:
            aux.append(layer_aux)
        return x + y
    return x + mlp_apply(params["mlp"], h, cfg.activation, taps,
                         f"{tap_prefix}.mlp")


def group_apply(params: Mapping, x: torch.Tensor, group: StackGroup,
                cfg: ModelConfig, *, positions, mode: str, cache=None,
                cache_len=None, block_tables=None, taps: Optional[Dict] = None,
                tap_group: str = "", memory: Optional[torch.Tensor] = None,
                encoder: bool = False, aux: Optional[List] = None) -> torch.Tensor:
    """Run a stack group layer by layer.  Tap names follow the reference's
    unrolled calibration naming: "g0/rep3/sub0.mlp.in" for stacked groups,
    "g0/sub0.mlp.in" otherwise."""
    stacked = group.repeats > 1
    for r in range(group.repeats):
        p_r = _index(params, r) if stacked else params
        c_r = None if cache is None else (_index(cache, r) if stacked else cache)
        for j, spec in enumerate(group.period):
            tp = f"{tap_group}/rep{r}/sub{j}" if stacked else f"{tap_group}/sub{j}"
            x = block_apply(p_r[f"sub{j}"], x, spec, cfg, positions=positions,
                            mode=mode,
                            cache=None if c_r is None else c_r[f"sub{j}"],
                            cache_len=cache_len, block_tables=block_tables,
                            taps=taps, tap_prefix=tp, memory=memory, encoder=encoder,
                            aux=aux)
    return x
