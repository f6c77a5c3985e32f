"""Decoder-only LM assembly for the dense (gqa, mlp) families and RWKV-6
(rwkv, cmix)."""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import torch

from repro_torch import Device, resolve_device, torch_dtype
from repro_torch.configs.base import ModelConfig

from .blocks import (
    group_apply,
    group_cache_init,
    group_init,
    group_layers,
    group_paged_cache_init,
    resolve_specs,
)
from .layers import (
    embed,
    embedding_init,
    learned_pos,
    linear_init,
    norm_apply,
    norm_init,
    unembed,
)


class DecoderLM:
    """Functional decoder-only LM over plain dict param trees.

    apply modes: "train" (causal, no cache); "prefill" (causal, writing a
    fresh dense row cache from ``init_cache``: recurrent state and shifts);
    and "decode" (S new tokens per row at each row's cache_len, into a paged
    cache for attention — S == 1 is a decode step, S > 1 a chunk of
    streaming prefill — or one token per row into the dense recurrent cache).
    """

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.specs = resolve_specs(cfg)
        self.groups = group_layers(self.specs)
        self.dtype = torch_dtype(cfg.dtype)

    def init(self, seed: int = 0, device: Device = None) -> Dict:
        """Random weights drawn from a ``torch.Generator`` seeded with
        ``seed`` on ``device`` (default: the card)."""
        cfg, dev = self.cfg, resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        params: Dict[str, Any] = {
            "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model, self.dtype, dev)}
        if cfg.pos_emb == "learned":
            params["pos"] = embedding_init(gen, cfg.max_seq, cfg.d_model,
                                           self.dtype, dev)
        for i, g in enumerate(self.groups):
            params[f"g{i}"] = group_init(gen, g, cfg, self.dtype, dev)
        params["final_norm"] = norm_init(cfg.norm, cfg.d_model, self.dtype, dev)
        if not cfg.tie_embeddings:
            params["unembed"] = linear_init(gen, cfg.d_model, cfg.vocab_size,
                                            self.dtype, dev)
        return params

    def init_cache(self, batch: int, max_len: int, dtype=None,
                   device: Device = None) -> Dict:
        """The dense (batch, ...) cache slab (the reference's layout);
        ``device="meta"`` gives its leaves without allocating."""
        dtype = dtype or self.dtype
        dev = resolve_device(device)
        return {f"g{i}": group_cache_init(g, self.cfg, batch, max_len, dtype, dev)
                for i, g in enumerate(self.groups)}

    def init_paged_cache(self, num_blocks: int, block_size: int, dtype=None,
                         kv_quant: bool = False, device: Device = None) -> Dict:
        dtype = dtype or self.dtype
        dev = resolve_device(device)
        return {f"g{i}": group_paged_cache_init(g, self.cfg, num_blocks,
                                                block_size, dtype, dev, kv_quant)
                for i, g in enumerate(self.groups)}

    def apply(self, params: Mapping[str, Any], tokens: torch.Tensor, *,
              mode: str = "train", cache: Optional[Dict] = None,
              cache_len: Optional[torch.Tensor] = None,
              block_tables: Optional[torch.Tensor] = None,
              taps: Optional[Dict] = None) -> torch.Tensor:
        """Logits (B, S, V).  In "prefill" and "decode" mode the ``cache``
        tensors are written in place."""
        cfg = self.cfg
        b, s = tokens.shape
        x = embed(params["embed"], tokens).to(self.dtype)
        ar = torch.arange(s, device=tokens.device)
        if mode == "decode":
            positions = cache_len.long()[:, None] + ar
        elif mode in ("train", "prefill"):
            positions = ar.expand(b, s)
        else:
            raise ValueError(f"mode {mode!r} is not ported")
        if cfg.pos_emb == "learned":
            x = x + learned_pos(params["pos"], positions).to(x.dtype)
        for i, g in enumerate(self.groups):
            x = group_apply(params[f"g{i}"], x, g, cfg, positions=positions,
                            mode=mode,
                            cache=None if cache is None else cache[f"g{i}"],
                            cache_len=cache_len, block_tables=block_tables,
                            taps=taps, tap_group=f"g{i}")
        x = norm_apply(params["final_norm"], x)
        if taps is not None:
            taps["final.out_in"] = x
        return unembed(params.get("unembed", params["embed"]), x)

    def compressible_targets(self):
        """TargetSpecs for every factorizable matrix (reference names and
        Gram keys)."""
        from repro_torch.core.plan import TargetSpec

        cfg = self.cfg
        d = cfg.d_model
        hq = cfg.num_heads * cfg.head_dim
        hkv = cfg.num_kv_heads * cfg.head_dim
        layers = {
            ("gqa", "mlp"): [
                (("attn", "wq"), d, hq, "attn.in"),
                (("attn", "wk"), d, hkv, "attn.in"),
                (("attn", "wv"), d, hkv, "attn.in"),
                (("attn", "wo"), hq, d, "attn.out_in"),
                (("mlp", "wi"), d, cfg.d_ff, "mlp.in"),
                *([(("mlp", "wg"), d, cfg.d_ff, "mlp.in")]
                  if cfg.activation == "swiglu" else []),
                (("mlp", "wo"), cfg.d_ff, d, "mlp.mid"),
            ],
            ("rwkv", "cmix"): [
                *((("rwkv_t", w), d, d, f"rwkv_t.{t}_in")
                  for w, t in (("wr", "r"), ("wk", "k"), ("wv", "v"), ("wg", "g"))),
                (("rwkv_t", "wo"), d, d, "rwkv_t.out_in"),
                (("rwkv_c", "wk"), d, cfg.d_ff, "rwkv_c.k_in"),
                (("rwkv_c", "wv"), cfg.d_ff, d, "rwkv_c.mid"),
                (("rwkv_c", "wr"), d, d, "rwkv_c.r_in"),
            ],
        }
        targets = []
        for i, g in enumerate(self.groups):
            rep = (g.repeats,) if g.repeats > 1 else ()
            for j, spec in enumerate(g.period):
                base, tap = (f"g{i}", f"sub{j}"), f"g{i}/sub{j}"
                for path, in_dim, out_dim, key in layers[spec]:
                    targets.append(TargetSpec(path=base + path, in_dim=in_dim,
                                              out_dim=out_dim,
                                              gram_key=f"{tap}.{key}",
                                              stacked=rep))
        return targets
