"""Block assembly + layer stacking for (gqa, mlp) decoder layers.

A layer is pre-norm: x = x + attn(norm1(x)); x = x + mlp(norm2(x)).
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
from .layers import mlp_apply, mlp_init, norm_apply, norm_init

BlockSpec = Tuple[str, str]  # (mixer, ffn)


def resolve_specs(cfg: ModelConfig) -> Tuple[BlockSpec, ...]:
    out = []
    for mixer, ffn in cfg.layer_specs():
        if mixer != "attn" or cfg.attention != "gqa" or ffn != "mlp":
            raise ValueError(f"{cfg.name}: only (gqa, mlp) layers are ported, "
                             f"got ({mixer}/{cfg.attention}, {ffn})")
        out.append(("gqa", "mlp"))
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


def block_init(gen, cfg: ModelConfig, dtype, device) -> Dict:
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
        return {f"sub{j}": block_init(gen, cfg, dtype, device)
                for j in range(len(group.period))}
    if group.repeats == 1:
        return one()
    return _stack([one() for _ in range(group.repeats)])


def group_paged_cache_init(group: StackGroup, cfg: ModelConfig, num_blocks: int,
                           block_size: int, dtype, device,
                           kv_quant: bool = False) -> Dict:
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


def block_apply(params: Mapping, x: torch.Tensor, cfg: ModelConfig, *,
                positions, mode: str, cache=None, cache_len=None,
                block_tables=None, taps=None, tap_prefix: str = "") -> torch.Tensor:
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
        for j in range(len(group.period)):
            tp = f"{tap_group}/rep{r}/sub{j}" if stacked else f"{tap_group}/sub{j}"
            x = block_apply(p_r[f"sub{j}"], x, cfg, positions=positions,
                            mode=mode,
                            cache=None if c_r is None else c_r[f"sub{j}"],
                            cache_len=cache_len, block_tables=block_tables,
                            taps=taps, tap_prefix=tp)
    return x
