"""Block assembly + layer stacking for (gqa, mlp) and (rwkv, cmix) layers.

A layer is pre-norm: x = x + mixer(norm1(x)); x = x + ffn(norm2(x)), with
mixer/ffn one of (GQA attention, MLP) or (RWKV-6 time mix, channel mix).
Layers with identical specs are stacked exactly as the reference stacks
them for ``lax.scan`` (params carry a leading repeats dim), so the param
tree keys and shapes match a reference checkpoint; here the stack runs as a
Python loop over layer slices.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig

from . import attention as attn_mod
from . import rwkv6 as rwkv_mod
from .layers import mlp_apply, mlp_init, norm_apply, norm_init

BlockSpec = Tuple[str, str]  # (mixer, ffn)


def resolve_specs(cfg: ModelConfig) -> Tuple[BlockSpec, ...]:
    """Config-level layer specs -> (mixer, ffn) pairs: ("gqa", "mlp") or
    ("rwkv", "cmix"), the two ported layer kinds."""
    out = []
    for mixer, ffn in cfg.layer_specs():
        if mixer == "attn" and cfg.attention == "gqa" and ffn == "mlp":
            out.append(("gqa", "mlp"))
        elif mixer == "rwkv" and cfg.rwkv is not None:
            out.append(("rwkv", "cmix"))
        else:
            raise ValueError(f"{cfg.name}: only (gqa, mlp) and (rwkv, cmix) layers "
                             f"are ported, got ({mixer}/{cfg.attention}, {ffn})")
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


def block_init(gen, spec: BlockSpec, cfg: ModelConfig, dtype, device) -> Dict:
    if spec == ("rwkv", "cmix"):
        return {
            "norm1": norm_init(cfg.norm, cfg.d_model, dtype, device),
            "rwkv_t": rwkv_mod.rwkv_time_mix_init(gen, cfg, dtype, device),
            "norm2": norm_init(cfg.norm, cfg.d_model, dtype, device),
            "rwkv_c": rwkv_mod.rwkv_channel_mix_init(gen, cfg, dtype, device),
        }
    return {
        "norm1": norm_init(cfg.norm, cfg.d_model, dtype, device),
        "attn": attn_mod.attention_init(gen, cfg, dtype, device),
        "norm2": norm_init(cfg.norm, cfg.d_model, dtype, device),
        "mlp": mlp_init(gen, cfg.activation, cfg.d_model, cfg.d_ff, dtype, device),
    }


def _stack(trees: List[Dict]) -> Dict:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def group_init(gen, group: StackGroup, cfg: ModelConfig, dtype, device) -> Dict:
    """{"sub{j}": block params}, with a leading repeats dim when stacked."""
    def one():
        return {f"sub{j}": block_init(gen, spec, cfg, dtype, device)
                for j, spec in enumerate(group.period)}
    if group.repeats == 1:
        return one()
    return _stack([one() for _ in range(group.repeats)])


def block_cache_init(spec: BlockSpec, cfg: ModelConfig, batch: int, max_len: int,
                     dtype, device) -> Dict:
    """One layer's dense-slab cache rows: the recurrent state for rwkv, the
    (batch, max_len) K/V slab for gqa (allocated as the reference does;
    attention decodes only through the paged pools here)."""
    if spec[0] == "rwkv":
        return {"rwkv": rwkv_mod.init_rwkv_cache(cfg, batch, dtype, device)}
    return {"attn": attn_mod.init_kv_cache(cfg, batch, max_len, dtype, device)}


def group_cache_init(group: StackGroup, cfg: ModelConfig, batch: int, max_len: int,
                     dtype, device) -> Dict:
    def one():
        return {f"sub{j}": block_cache_init(spec, cfg, batch, max_len, dtype, device)
                for j, spec in enumerate(group.period)}
    if group.repeats == 1:
        return one()
    return _stack([one() for _ in range(group.repeats)])


def group_paged_cache_init(group: StackGroup, cfg: ModelConfig, num_blocks: int,
                           block_size: int, dtype, device,
                           kv_quant: bool = False) -> Dict:
    if any(spec[0] != "gqa" for spec in group.period):
        raise ValueError(f"paged KV cache requires attention (gqa) layers, got "
                         f"{group.period}; see models.api.cache_layout")

    def one():
        return {f"sub{j}": {"attn": attn_mod.init_paged_kv_cache(
            cfg, num_blocks, block_size, dtype, device, kv_quant)}
            for j in range(len(group.period))}
    if group.repeats == 1:
        return one()
    return _stack([one() for _ in range(group.repeats)])


def _index(tree, r: int):
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return tree[r]


def block_apply(params: Mapping, x: torch.Tensor, spec: BlockSpec, cfg: ModelConfig, *,
                positions, mode: str, cache=None, cache_len=None,
                block_tables=None, taps=None, tap_prefix: str = "") -> torch.Tensor:
    """mode "train" (causal, no cache), "prefill" (causal, writing a fresh
    dense cache; rwkv only) or "decode"."""
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
    if mode == "prefill":
        raise ValueError("prefill into a dense slab needs a recurrent mixer; "
                         "attention prefills in chunks through the paged pools")
    h = norm_apply(params["norm1"], x)
    x = x + attn_mod.attention_apply(
        params["attn"], h, cfg, positions,
        mode="decode" if mode == "decode" else "causal",
        cache=None if cache is None else cache["attn"], cache_len=cache_len,
        block_tables=block_tables, taps=taps, tap_prefix=f"{tap_prefix}.attn")
    h = norm_apply(params["norm2"], x)
    return x + mlp_apply(params["mlp"], h, cfg.activation, taps,
                         f"{tap_prefix}.mlp")


def group_apply(params: Mapping, x: torch.Tensor, group: StackGroup,
                cfg: ModelConfig, *, positions, mode: str, cache=None,
                cache_len=None, block_tables=None, taps: Optional[Dict] = None,
                tap_group: str = "") -> torch.Tensor:
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
                            taps=taps, tap_prefix=tp)
    return x
