"""Shared helpers for the port's parity tests (tests/test_torch_*.py): the
same configs and weights on both sides, moved across as numpy arrays."""

from __future__ import annotations

import jax
import numpy as np
import torch

from repro.configs import paper_models as jax_paper
from repro_torch import bridge
from repro_torch.configs import paper_models as torch_paper

FAMILIES = {"small-llama": "LLAMA_7B", "small-opt": "OPT_6_7B",
            "small-mistral": "MISTRAL_7B"}


def tiny_cfgs(family: str, num_layers: int = 2, d_model: int = 32,
              d_ff: int = 48, vocab: int = 64, num_heads: int = 4):
    """(reference cfg, port cfg) of one paper family at a tiny width."""
    kw = dict(name=family, num_layers=num_layers, d_model=d_model, d_ff=d_ff,
              vocab_size=vocab, num_heads=num_heads)
    return (jax_paper.small_lm(family_of=getattr(jax_paper, FAMILIES[family]), **kw),
            torch_paper.small_lm(family_of=getattr(torch_paper, FAMILIES[family]), **kw))


def to_np(tree):
    """JAX pytree of dicts -> numpy tree."""
    return jax.tree.map(np.asarray, tree)


def to_t(tree):
    """numpy or JAX tree -> torch tree on the CPU (bf16 kept)."""
    return bridge.to_torch(to_np(tree), device="cpu")


def t2np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()

