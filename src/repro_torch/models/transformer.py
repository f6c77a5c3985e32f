"""Decoder-only LM assembly for the dense (gqa, mlp) families, Multi-head
Latent Attention (mla, mlp), the token-choice MoE family (dense first
layers, then (gqa, moe) layers, or deepseek-v3's (mla, moe)), jamba's
Mamba / attention hybrid ((mamba, mlp), (mamba, moe) and (gqa, mlp) in a
period of 8), RWKV-6 (rwkv, cmix) and the vision frontend (llava: a
projector over patch features, its output in front of the tokens)."""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Mapping, Optional

import torch
import torch.nn.functional as F

from repro_torch import Device, resolve_device, torch_dtype
from repro_torch.configs.base import ModelConfig
from repro_torch.parallel import collectives
from repro_torch.parallel.sharding import NONE_PARALLEL, Parallelism

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
    linear,
    linear_init,
    norm_apply,
    norm_init,
    unembed,
)
from .mamba import dt_rank_of

VISION_FEATURE_DIM = 1024  # CLIP-L patch feature width (llava stub input)


class DecoderLM:
    """Functional decoder-only LM over plain dict param trees.

    apply modes: "train" (causal, no cache); "prefill" (causal, writing a
    fresh dense row cache from ``init_cache``: recurrent state and shifts
    (RWKV-6; Mamba's state and conv tail), attention K/V or MLA's latents
    from position 0); and "decode" (S new
    tokens per row at each row's cache_len: into a paged cache for
    attention with ``block_tables`` — S == 1 is a decode step, S > 1 a
    chunk of streaming prefill — or into the dense slab: attention K/V at
    cache_len.., or one token per row into the recurrent cache or MLA's
    latent slab).

    ``par``: the mesh the model runs on.  With more than one rank on its
    model axis, every forward runs inside ``collectives.tensor_parallel``
    on this rank's local params (``parallel.shard_params``): the linears
    split by the sharding rules, the vocab-sharded embedding is summed over
    the model group, the logits are gathered whole before they are
    returned, and the caches hold this rank's heads.  With one rank there
    it is the meshless model, bit for bit.
    """

    def __init__(self, cfg: ModelConfig, par: Parallelism = NONE_PARALLEL):
        self.cfg = cfg
        self.specs = resolve_specs(cfg)
        self.groups = group_layers(self.specs)
        self.dtype = torch_dtype(cfg.dtype)
        self.par = par
        self.tp = par.tp_size if par.active else 1
        if self.tp > 1:
            err = tensor_parallel_refusal(cfg, self.tp)
            if err is not None:
                raise ValueError(err)

    def init(self, seed: int = 0, device: Device = None) -> Dict:
        """Random weights drawn from a ``torch.Generator`` seeded with
        ``seed`` on ``device`` (default: the card); ``device="meta"`` gives
        the param tree's leaves without allocating (sizing a cut)."""
        cfg, dev = self.cfg, resolve_device(device)
        gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
        params: Dict[str, Any] = {
            "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model, self.dtype, dev)}
        if cfg.pos_emb == "learned":
            params["pos"] = embedding_init(gen, cfg.max_seq, cfg.d_model,
                                           self.dtype, dev)
        if cfg.frontend == "vision":
            params["projector"] = {
                "wi": linear_init(gen, VISION_FEATURE_DIM, cfg.d_model, self.dtype, dev),
                "wo": linear_init(gen, cfg.d_model, cfg.d_model, self.dtype, dev)}
        for i, g in enumerate(self.groups):
            params[f"g{i}"] = group_init(gen, g, cfg, self.dtype, dev)
        params["final_norm"] = norm_init(cfg.norm, cfg.d_model, self.dtype, dev)
        if not cfg.tie_embeddings:
            params["unembed"] = linear_init(gen, cfg.d_model, cfg.vocab_size,
                                            self.dtype, dev)
        return params

    def init_cache(self, batch: int, max_len: int, dtype=None,
                   device: Device = None, kv_quant: bool = False) -> Dict:
        """The dense (batch, ...) cache slab (the reference's layout);
        ``kv_quant``: the attention layers' K/V in int8 with fp32 scales
        (recurrent state and MLA's latents keep ``dtype``);
        ``device="meta"`` gives its leaves without allocating."""
        dtype = dtype or self.dtype
        dev = resolve_device(device)
        return {f"g{i}": group_cache_init(g, self.cfg, batch, max_len, dtype, dev,
                                          kv_quant=kv_quant, tp=self.tp)
                for i, g in enumerate(self.groups)}

    def init_paged_cache(self, num_blocks: int, block_size: int, dtype=None,
                         kv_quant: bool = False, device: Device = None) -> Dict:
        dtype = dtype or self.dtype
        dev = resolve_device(device)
        return {f"g{i}": group_paged_cache_init(g, self.cfg, num_blocks,
                                                block_size, dtype, dev, kv_quant, tp=self.tp)
                for i, g in enumerate(self.groups)}

    def apply(self, params: Mapping[str, Any], tokens: torch.Tensor, *,
              patches: Optional[torch.Tensor] = None,
              mode: str = "train", cache: Optional[Dict] = None,
              cache_len: Optional[torch.Tensor] = None,
              block_tables: Optional[torch.Tensor] = None,
              taps: Optional[Dict] = None, output: str = "logits",
              aux: Optional[List] = None) -> torch.Tensor:
        """Logits (B, S, V), or with ``output="hidden"`` the final-norm
        hidden states (B, S, d_model) without the unembed (the draft's
        prefills, which need only the cache writes).  In "prefill" and
        "decode" mode the ``cache`` tensors are written in place.

        ``patches`` (B, P, VISION_FEATURE_DIM), a vision model's image
        features: the projector maps them to P rows in front of the token
        embeddings, and positions (and the cache) run over the P + S rows;
        the taps see the raw patches (``projector.in``), the GELU's output
        (``projector.mid``) and the final norm over every row, and the
        output covers the S token positions only.

        ``aux``: a list that receives each MoE layer's load-balance loss
        (0-d fp32), which the reference's apply returns as its third
        output; the train step sums it, every other caller passes none."""
        scope = (collectives.tensor_parallel(self.par) if self.tp > 1
                 else contextlib.nullcontext())
        with scope:
            return self._apply(params, tokens, patches=patches, mode=mode, cache=cache,
                               cache_len=cache_len, block_tables=block_tables, taps=taps,
                               output=output, aux=aux)

    def _embed(self, table_params, tokens: torch.Tensor) -> torch.Tensor:
        """Token embeddings; a vocab-sharded table (this rank's rows) looks
        up the ids it holds, zeros elsewhere, and sums over the model group
        (exact: one rank holds each id).  Ids wrap as indexing wraps them
        (serving feeds negative ids for finished rows)."""
        table = table_params["table"]
        v = self.cfg.vocab_size
        if self.tp == 1 or table.shape[0] == v:
            return embed(table_params, tokens)
        n = table.shape[0]
        local = tokens.long().remainder(v) - self.par.tp_rank * n
        held = (local >= 0) & (local < n)
        x = table[local.clamp(0, n - 1)] * held[..., None].to(table.dtype)
        return collectives.all_reduce(x, self.par, self.par.tp_axis)

    def _unembed(self, out_params, x: torch.Tensor) -> torch.Tensor:
        """Logits; vocab-sharded ones (this rank's columns) gathered whole
        over the model group before sampling."""
        logits = unembed(out_params, x)
        if self.tp > 1 and logits.shape[-1] != self.cfg.vocab_size:
            logits = collectives.all_gather(logits, self.par, self.par.tp_axis, dim=-1)
        return logits

    def _apply(self, params, tokens, *, patches, mode, cache, cache_len, block_tables,
               taps, output, aux):
        cfg = self.cfg
        b = tokens.shape[0]
        x = self._embed(params["embed"], tokens).to(self.dtype)
        n_prefix = 0
        if patches is not None:
            if taps is not None:
                taps["projector.in"] = patches
            # jax.nn.gelu defaults to the tanh approximation.
            pv = F.gelu(linear(params["projector"]["wi"], patches.to(self.dtype)),
                        approximate="tanh")
            if taps is not None:
                taps["projector.mid"] = pv
            x = torch.cat([linear(params["projector"]["wo"], pv), x], dim=1)
            n_prefix = patches.shape[1]
        s = x.shape[1]
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
                            taps=taps, tap_group=f"g{i}", aux=aux)
        x = norm_apply(params["final_norm"], x)
        if taps is not None:
            taps["final.out_in"] = x
        x = x[:, n_prefix:]
        if output == "hidden":
            return x
        if output != "logits":
            raise ValueError(f"output {output!r}: 'logits' or 'hidden'")
        return self._unembed(params.get("unembed", params["embed"]), x)

    def compressible_targets(self):
        """TargetSpecs for every factorizable matrix (reference names and
        Gram keys), built as the reference builds them: a layer's list is
        its mixer's (gqa, mla, mamba or rwkv time mix) followed by its
        ffn's (mlp, moe or channel mix), so every (mixer, ffn) pair,
        deepseek-v3's (mla, moe) and jamba's (mamba, moe) among them, gets
        its targets in the reference's order.
        A MoE layer's expert targets are stacked over the experts too; a
        vision model's projector (``wi``, ``wo``) comes after the layers."""
        from repro_torch.core.plan import TargetSpec

        cfg = self.cfg
        d = cfg.d_model
        # (path, in, out, Gram key, per expert: stacked over the experts too)
        mixers, ffns = {}, {}
        hq, hkv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
        mixers["gqa"] = [
            (("attn", "wq"), d, hq, "attn.in"),
            (("attn", "wk"), d, hkv, "attn.in"),
            (("attn", "wv"), d, hkv, "attn.in"),
            (("attn", "wo"), hq, d, "attn.out_in"),
        ]
        if cfg.mla is not None:
            m, h = cfg.mla, cfg.num_heads
            qk = m.qk_nope_head_dim + m.qk_rope_head_dim
            mixers["mla"] = [
                (("attn", "wq_a"), d, m.q_lora_rank, "attn.in"),
                (("attn", "wq_b"), m.q_lora_rank, h * qk, "attn.q_lora_in"),
                (("attn", "wkv_a"), d, m.kv_lora_rank + m.qk_rope_head_dim, "attn.in"),
                (("attn", "wkv_b"), m.kv_lora_rank,
                 h * (m.qk_nope_head_dim + m.v_head_dim), "attn.kv_lora_in"),
                (("attn", "wo"), h * m.v_head_dim, d, "attn.out_in"),
            ]
        if cfg.mamba is not None:
            di, dt_rank = cfg.mamba.d_inner, dt_rank_of(cfg)
            mixers["mamba"] = [
                (("mamba", "in_proj"), d, 2 * di, "mamba.in"),
                (("mamba", "x_proj"), di, dt_rank + 2 * cfg.mamba.d_state, "mamba.ssm_in"),
                (("mamba", "dt_proj"), dt_rank, di, "mamba.dt_in"),
                (("mamba", "out_proj"), di, d, "mamba.out_in"),
            ]
        mixers["rwkv"] = [
            *((("rwkv_t", w), d, d, f"rwkv_t.{t}_in")
              for w, t in (("wr", "r"), ("wk", "k"), ("wv", "v"), ("wg", "g"))),
            (("rwkv_t", "wo"), d, d, "rwkv_t.out_in"),
        ]
        ffns["mlp"] = [
            (("mlp", "wi"), d, cfg.d_ff, "mlp.in"),
            *([(("mlp", "wg"), d, cfg.d_ff, "mlp.in")]
              if cfg.activation == "swiglu" else []),
            (("mlp", "wo"), cfg.d_ff, d, "mlp.mid"),
        ]
        if cfg.moe is not None:
            f, fs = cfg.moe.d_ff_expert, cfg.moe.d_ff_expert * cfg.moe.num_shared_experts
            ffns["moe"] = [
                (("moe", "experts", "wi"), d, f, "moe.expert_buf", True),
                (("moe", "experts", "wg"), d, f, "moe.expert_buf", True),
                (("moe", "experts", "wo"), f, d, "moe.expert_mid", True),
                *([(("moe", "shared", "wi"), d, fs, "moe.shared_in"),
                   (("moe", "shared", "wg"), d, fs, "moe.shared_in"),
                   (("moe", "shared", "wo"), fs, d, "moe.shared_mid")] if fs else []),
            ]
        ffns["cmix"] = [
            (("rwkv_c", "wk"), d, cfg.d_ff, "rwkv_c.k_in"),
            (("rwkv_c", "wv"), cfg.d_ff, d, "rwkv_c.mid"),
            (("rwkv_c", "wr"), d, d, "rwkv_c.r_in"),
        ]
        targets = []
        for i, g in enumerate(self.groups):
            rep = (g.repeats,) if g.repeats > 1 else ()
            for j, (mixer, ffn) in enumerate(g.period):
                base, tap = (f"g{i}", f"sub{j}"), f"g{i}/sub{j}"
                for path, in_dim, out_dim, key, *per_expert in mixers[mixer] + ffns[ffn]:
                    stacked = rep + (cfg.moe.num_experts,) if per_expert else rep
                    targets.append(TargetSpec(path=base + path, in_dim=in_dim,
                                              out_dim=out_dim,
                                              gram_key=f"{tap}.{key}",
                                              stacked=stacked))
        if cfg.frontend == "vision":
            targets.append(TargetSpec(("projector", "wi"), VISION_FEATURE_DIM, d,
                                      "projector.in"))
            targets.append(TargetSpec(("projector", "wo"), d, d, "projector.mid"))
        return targets


def tensor_parallel_refusal(cfg: ModelConfig, tp: int):
    """Why ``cfg`` cannot split over ``tp`` model ranks, or None.  The split
    is ported for the dense attention decoders (LLaMA, OPT, Mistral,
    chatglm3, phi3, deepseek-67b) and RWKV-6, whose heads, widths and
    hidden dims the model axis divides; the rest is ROADMAP A3b."""
    kind = mesh_family_refusal(cfg)
    if kind is not None:
        return kind
    heads = ((cfg.d_model // cfg.rwkv.head_dim,) if cfg.rwkv is not None
             else (cfg.num_heads, cfg.num_kv_heads))
    if any(n % tp for n in heads + (cfg.d_model, cfg.d_ff)):
        return (f"{cfg.name}: a model axis of {tp} ranks does not divide its heads "
                f"{heads}, d_model {cfg.d_model} or d_ff {cfg.d_ff}; the reference pads "
                "them, the port refuses (ROADMAP A3b)")
    return None


def mesh_family_refusal(cfg: ModelConfig):
    """Why ``cfg``'s family cannot run on a mesh of more than one rank, or
    None (the dense attention decoders and RWKV-6 can)."""
    kind = ("an encoder-decoder" if cfg.is_encdec
            else "MoE: capacity routing differs once rows split" if cfg.moe is not None
            else "Mamba" if cfg.mamba is not None
            else "MLA" if cfg.attention == "mla"
            else "a vision frontend" if cfg.frontend == "vision" else None)
    if kind is None:
        return None
    return (f"{cfg.name} ({kind}) has no form on a mesh of more than one rank yet "
            "(ROADMAP A3b): serve it on a (1, 1) mesh or meshless")
