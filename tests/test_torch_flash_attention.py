"""Port parity for causal GQA attention: the port's ``flash_attention``
(its plain version on the CPU) and the model's causal attention against the
reference's Pallas flash-attention kernel in interpret mode and its causal
``attention_apply``, on the same numpy-seeded inputs: G in {1, 2, 4},
ragged S, fp32 and bf16."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import t2np, tiny_cfgs, to_t

from repro.kernels.flash_attention.ops import flash_attention as jax_flash_attention
from repro.models.attention import attention_apply as jax_attention_apply
from repro.models.attention import attention_init as jax_attention_init
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.attention import attention_apply

# fp32: sum order only.  bf16: P and the output round to bf16 at the same
# points; the einsums sum in another order (a few bf16 ulps).
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _rel_err(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [16, 37])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_flash_attention_matches_pallas_interpret(group, s, dtype):
    rng = np.random.default_rng(group * 100 + s)
    b, hkv, hd = 2, 2, 16

    def mk(h):
        t = torch.as_tensor(rng.standard_normal((b, s, h, hd)).astype(np.float32)).to(dtype)
        j = jnp.asarray(t.float().numpy())
        return t, (j.astype(jnp.bfloat16) if dtype == torch.bfloat16 else j)

    (q, jq), (k, jk), (v, jv) = mk(hkv * group), mk(hkv), mk(hkv)
    got = flash_attention(q, k, v)
    assert got.shape == q.shape and got.dtype == dtype
    want = jax_flash_attention(jq, jk, jv, block_q=16, block_k=16, interpret=True)
    assert _rel_err(t2np(got), np.asarray(want, np.float32)) < TOL[dtype]


@pytest.mark.parametrize("family", ["small-mistral", "small-llama"])
def test_causal_attention_matches_reference(family):
    """The model's causal branch (the flash-attention wrapper) against the
    reference's causal attention_apply on the same params and input."""
    jcfg, tcfg = tiny_cfgs(family, d_model=32, num_heads=4)
    jparams = jax_attention_init(jax.random.key(3), jcfg, jnp.float32)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 21, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(21), (2, 21)).copy()
    want, _ = jax_attention_apply(jparams, jnp.asarray(x), jcfg, jnp.asarray(pos),
                                  mode="causal")
    got = attention_apply(to_t(jparams), torch.as_tensor(x), tcfg,
                          torch.as_tensor(pos), mode="causal")
    assert _rel_err(t2np(got), np.asarray(want)) < 1e-5
