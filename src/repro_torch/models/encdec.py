"""Encoder-decoder LM (the whisper family) with a stubbed audio frontend.

``frames`` are precomputed post-conv frame embeddings (B, encoder_seq,
d_model): the conv / mel frontend is a stub, as in the reference.  The
encoder is one stack of (gqa, mlp) layers run unmasked; the decoder one
stack of (gqa, mlp) layers with cross-attention to the encoder's memory
between the mixer and the MLP.  Prefill encodes the frames once and writes
each decoder layer's self K/V slab and cross K/V slab; decode reads the
cross slab and never sees the frames again.

The param tree keeps the reference's keys and stacked leading dims
(``embed``, ``pos_dec``, ``pos_enc``, ``encoder``, ``enc_norm``,
``decoder``, ``final_norm``, ``unembed``), so ``bridge.to_torch`` of a
reference tree loads unchanged; tap names are the reference's
(``enc/rep{r}/sub0.attn.in``, ``dec/rep{r}/sub0.cross.kv_in``, ...).
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional

import torch

from repro_torch import Device, resolve_device, torch_dtype
from repro_torch.configs.base import ModelConfig

from .blocks import StackGroup, group_apply, group_cache_init, group_init
from .layers import (
    embed,
    embedding_init,
    learned_pos,
    linear_init,
    norm_apply,
    norm_init,
    unembed,
)


class EncDecLM:
    """Functional encoder-decoder LM over plain dict param trees.

    apply modes: "train" (encode ``frames``, then the causal decoder, no
    cache), "prefill" (the same, writing a fresh ``init_cache``: the
    decoder's self K/V from position 0 and the memory's cross K/V) and
    "decode" (S new tokens per row at each row's cache_len, attending the
    self slab and the cross slab).  ``memory`` (B, T, d_model), an
    ``encode`` result, skips the encoder in train and prefill.
    """

    def __init__(self, cfg: ModelConfig):
        if not cfg.is_encdec:
            raise ValueError(f"{cfg.name} has no encoder (encoder_layers == 0)")
        self.cfg = cfg
        self.dtype = torch_dtype(cfg.dtype)
        # Encoder and decoder are each one uniform stack.
        self.enc_group = StackGroup((("gqa", "mlp"),), cfg.encoder_layers, 0)
        self.dec_group = StackGroup((("gqa", "mlp"),), cfg.num_layers, 0)

    def init(self, seed: int = 0, device: Device = None) -> Dict:
        """Random weights drawn from a ``torch.Generator`` seeded with
        ``seed`` on ``device`` (default: the card); ``device="meta"`` gives
        the param tree's leaves without allocating."""
        cfg, dev, dt = self.cfg, resolve_device(device), self.dtype
        gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
        return {
            "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model, dt, dev),
            "pos_dec": embedding_init(gen, cfg.max_seq, cfg.d_model, dt, dev),
            "pos_enc": embedding_init(gen, cfg.encoder_seq, cfg.d_model, dt, dev),
            "encoder": group_init(gen, self.enc_group, cfg, dt, dev, cross=False),
            "enc_norm": norm_init(cfg.norm, cfg.d_model, dt, dev),
            "decoder": group_init(gen, self.dec_group, cfg, dt, dev, cross=True),
            "final_norm": norm_init(cfg.norm, cfg.d_model, dt, dev),
            "unembed": linear_init(gen, cfg.d_model, cfg.vocab_size, dt, dev),
        }

    def init_cache(self, batch: int, max_len: int, dtype=None,
                   device: Device = None, kv_quant: bool = False) -> Dict:
        """The decoder's dense slabs: per layer a (batch, max_len) self K/V
        slab (int8 with ``kv_quant``) and a (batch, encoder_seq) cross K/V
        slab (always ``dtype``, as the reference's)."""
        return {"decoder": group_cache_init(self.dec_group, self.cfg, batch, max_len,
                                            dtype or self.dtype, resolve_device(device),
                                            cross=True, kv_quant=kv_quant)}

    def encode(self, params: Mapping[str, Any], frames: torch.Tensor,
               taps: Optional[Dict] = None) -> torch.Tensor:
        """Frames (B, T, d_model) -> the encoder's memory (B, T, d_model)."""
        b, t, _ = frames.shape
        pos = torch.arange(t, device=frames.device).expand(b, t)
        x = frames.to(self.dtype) + learned_pos(params["pos_enc"], pos).to(self.dtype)
        x = group_apply(params["encoder"], x, self.enc_group, self.cfg, positions=pos,
                        mode="train", taps=taps, tap_group="enc", encoder=True)
        return norm_apply(params["enc_norm"], x)

    def apply(self, params: Mapping[str, Any], tokens: torch.Tensor, *,
              frames: Optional[torch.Tensor] = None,
              memory: Optional[torch.Tensor] = None, mode: str = "train",
              cache: Optional[Dict] = None,
              cache_len: Optional[torch.Tensor] = None,
              taps: Optional[Dict] = None, aux: Optional[List] = None) -> torch.Tensor:
        """Logits (B, S, V).  Train and prefill take ``frames`` (or
        ``memory``); decode takes the prefilled ``cache`` and writes it in
        place.  ``aux`` as ``DecoderLM.apply``'s (no MoE layer here: it
        stays empty)."""
        b, s = tokens.shape
        ar = torch.arange(s, device=tokens.device)
        if mode == "decode":
            if cache is None or cache_len is None:
                raise ValueError("decode needs the prefilled cache and cache_len")
            positions = cache_len.long()[:, None] + ar
        elif mode in ("train", "prefill"):
            if memory is None:
                if frames is None:
                    raise ValueError(f"{self.cfg.name}: {mode} needs the encoder's "
                                     "frames (B, encoder_seq, d_model) or its memory")
                memory = self.encode(params, frames, taps=taps)
            positions = ar.expand(b, s)
        else:
            raise ValueError(f"mode {mode!r} is not ported")
        x = embed(params["embed"], tokens).to(self.dtype)
        x = x + learned_pos(params["pos_dec"], positions).to(x.dtype)
        x = group_apply(params["decoder"], x, self.dec_group, self.cfg,
                        positions=positions, mode=mode,
                        cache=None if cache is None else cache["decoder"],
                        cache_len=cache_len, taps=taps, tap_group="dec", memory=memory,
                        aux=aux)
        return unembed(params["unembed"], norm_apply(params["final_norm"], x))

    def compressible_targets(self):
        """The reference's TargetSpecs: per encoder layer attn wq/wk/wv/wo
        and mlp wi/wo, per decoder layer those and cross wq/wk/wv/wo, each
        stacked over its stack's layers; cross wk/wv read the memory's Gram
        (``.cross.kv_in``)."""
        from repro_torch.core.plan import TargetSpec

        cfg = self.cfg
        d, hq = cfg.d_model, cfg.num_heads * cfg.head_dim
        targets = []
        for side, n in (("encoder", cfg.encoder_layers), ("decoder", cfg.num_layers)):
            tap = f"{'enc' if side == 'encoder' else 'dec'}/sub0"
            rep = (n,) if n > 1 else ()
            mats = [("attn", "wq", d, hq, "attn.in"), ("attn", "wk", d, hq, "attn.in"),
                    ("attn", "wv", d, hq, "attn.in"), ("attn", "wo", hq, d, "attn.out_in")]
            if side == "decoder":
                mats += [("cross", "wq", d, hq, "cross.in"),
                         ("cross", "wk", d, hq, "cross.kv_in"),
                         ("cross", "wv", d, hq, "cross.kv_in"),
                         ("cross", "wo", hq, d, "cross.out_in")]
            mats += [("mlp", "wi", d, cfg.d_ff, "mlp.in"),
                     ("mlp", "wo", cfg.d_ff, d, "mlp.mid")]
            for block, w, in_dim, out_dim, key in mats:
                targets.append(TargetSpec(path=(side, "sub0", block, w), in_dim=in_dim,
                                          out_dim=out_dim, gram_key=f"{tap}.{key}",
                                          stacked=rep))
        return targets
