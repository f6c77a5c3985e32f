"""Shared helpers for the port's parity tests (tests/test_torch_*.py): the
same configs and weights on both sides, moved across as numpy arrays."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.calib.runner import collect_grams as jax_collect_grams
from repro.configs import get_config as jax_get_config
from repro.configs import paper_models as jax_paper
from repro.core import CompressionConfig as JaxCompressionConfig
from repro.core import build_plan as jax_build_plan
from repro.core import compress_params as jax_compress_params
from repro.models import build_model as jax_build_model
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.configs import paper_models as torch_paper
from repro_torch.models import build_model

# The parity tests run tiny shapes, several test workers at a time: torch's
# intra-op pool (a thread a core in every worker) then oversubscribes the
# host, and each test runs 20-50x slower than alone.  One thread a worker is
# as fast at these sizes and keeps the suite inside its time limit.
torch.set_num_threads(1)

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



def _spread_and_compress(jmodel, jparams, kind, vocab):
    """Spread the logits (same weights on both sides) so greedy choices
    are not near-ties; ``kind`` "nsvd1" compresses at ratio 0.3 (fp32)."""
    jparams["unembed"]["kernel"] = jparams["unembed"]["kernel"] * 8.0
    if kind == "nsvd1":
        rng = np.random.default_rng(3)
        grams = jax_collect_grams(jmodel, jparams, [
            {"tokens": jnp.asarray(rng.integers(0, vocab, (4, 32)), jnp.int32)}])
        plan = jax_build_plan(jmodel.compressible_targets(), JaxCompressionConfig(
            method="nsvd1", ratio=0.3, dtype="float32", use_randomized=False))
        jparams = jax_compress_params(jparams, plan, grams)
    return jparams


@functools.lru_cache(maxsize=None)
def tiny_lm(kind):
    """(reference model, params, port model, params): a tiny fp32 LLaMA,
    dense or NSVD-compressed, with spread logits."""
    jcfg, tcfg = tiny_cfgs("small-llama", d_model=32, d_ff=48, vocab=64)
    jmodel = jax_build_model(jcfg)
    jparams = _spread_and_compress(jmodel, jmodel.init(jax.random.key(0)), kind, 64)
    return jmodel, jparams, build_model(tcfg), to_t(jparams)


@functools.lru_cache(maxsize=None)
def tiny_rwkv(kind):
    """The same for the reduced rwkv6-1.6b (the dense recurrent slab)."""
    jmodel = jax_build_model(jax_get_config("rwkv6-1.6b").reduced())
    jparams = _spread_and_compress(jmodel, jmodel.init(jax.random.key(0)), kind, 256)
    tmodel = build_model(get_config("rwkv6-1.6b").reduced())
    return jmodel, jparams, tmodel, to_t(jparams)
