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
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
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


# The wrapper's dispatch, decided in Python before a launch: bf16 on the
# tensor-core kernel at a padded head dim of 64, 128 or 256 and 128 rows a
# block; fp32 on the CUDA-core kernel at 32/64/128/256 with 64 rows (32
# above hd 128).
@pytest.mark.parametrize("dtype,hd,g,want", [
    (torch.bfloat16, 8, 1, ("tensor_core", 64, 128)),
    (torch.bfloat16, 32, 3, ("tensor_core", 64, 128)),
    (torch.bfloat16, 40, 3, ("tensor_core", 64, 128)),
    (torch.bfloat16, 64, 8, ("tensor_core", 64, 128)),
    (torch.bfloat16, 72, 4, ("tensor_core", 128, 128)),
    (torch.bfloat16, 128, 4, ("tensor_core", 128, 128)),
    (torch.bfloat16, 128, 128, ("tensor_core", 128, 128)),
    (torch.bfloat16, 136, 2, ("tensor_core", 256, 128)),
    (torch.bfloat16, 256, 128, ("tensor_core", 256, 128)),
    (torch.float32, 8, 1, ("cuda_core", 32, 64)),
    (torch.float32, 40, 64, ("cuda_core", 64, 64)),
    (torch.float32, 128, 4, ("cuda_core", 128, 64)),
    (torch.float32, 136, 32, ("cuda_core", 256, 32)),
    (torch.float32, 256, 1, ("cuda_core", 256, 32))])
def test_flash_plan_picks_kernel_and_padded_head_dim(dtype, hd, g, want):
    assert tuple(fa_ops.plan(dtype, hd, g)) == want


@pytest.mark.parametrize("dtype,hd,g,exc", [
    (torch.bfloat16, 12, 1, ValueError), (torch.float32, 4, 1, ValueError),
    (torch.bfloat16, 264, 1, ValueError), (torch.float32, 0, 1, ValueError),
    (torch.bfloat16, 128, 129, ValueError), (torch.float32, 128, 65, ValueError),
    (torch.float32, 256, 33, ValueError), (torch.float16, 128, 4, TypeError)])
def test_flash_plan_rejects(dtype, hd, g, exc):
    with pytest.raises(exc):
        fa_ops.plan(dtype, hd, g)


# The backward's dispatch: bf16 at hd <= 128 on the tensor-core kernels at a
# padded head dim of 64 or 128, any G; bf16 above hd 128 and fp32 on the
# CUDA-core ones at 32/64/128/256.
@pytest.mark.parametrize("dtype,hd,g,want", [
    (torch.bfloat16, 8, 1, ("tensor_core", 64)),
    (torch.bfloat16, 32, 4, ("tensor_core", 64)),
    (torch.bfloat16, 64, 8, ("tensor_core", 64)),
    (torch.bfloat16, 72, 1, ("tensor_core", 128)),
    (torch.bfloat16, 96, 4, ("tensor_core", 128)),
    (torch.bfloat16, 128, 16, ("tensor_core", 128)),
    (torch.bfloat16, 128, 200, ("tensor_core", 128)),
    (torch.bfloat16, 136, 4, ("cuda_core", 256)),
    (torch.bfloat16, 256, 2, ("cuda_core", 256)),
    (torch.float32, 32, 1, ("cuda_core", 32)),
    (torch.float32, 64, 4, ("cuda_core", 64)),
    (torch.float32, 128, 4, ("cuda_core", 128)),
    (torch.float32, 256, 16, ("cuda_core", 256))])
def test_flash_bwd_plan_picks_kernel_and_padded_head_dim(dtype, hd, g, want):
    assert tuple(fa_ops.bwd_plan(dtype, hd, g)) == want


@pytest.mark.parametrize("dtype,hd,g,exc", [
    (torch.bfloat16, 12, 1, ValueError), (torch.bfloat16, 0, 1, ValueError),
    (torch.bfloat16, 264, 1, ValueError), (torch.float32, 4, 1, ValueError),
    (torch.bfloat16, 128, 0, ValueError), (torch.float16, 128, 4, TypeError),
    (torch.float16, 256, 4, TypeError)])
def test_flash_bwd_plan_rejects(dtype, hd, g, exc):
    with pytest.raises(exc):
        fa_ops.bwd_plan(dtype, hd, g)


def test_flash_check_gates_operands():
    """The gates run on any device: shapes, dtypes, contiguity, and the
    plan they give."""
    q = torch.zeros((2, 9, 8, 40), dtype=torch.bfloat16)
    k = torch.zeros((2, 9, 2, 40), dtype=torch.bfloat16)
    assert fa_ops.check(q, k, k) == ("tensor_core", 64, 128)
    with pytest.raises(ValueError):  # Hq not a multiple of Hkv
        fa_ops.check(q[:, :, :7].contiguous(), k, k)
    with pytest.raises(ValueError):  # k and v shapes differ
        fa_ops.check(q, k, k[:, :8].contiguous())
    with pytest.raises(TypeError):  # mixed dtypes
        fa_ops.check(q, k.float(), k)
    with pytest.raises(ValueError):  # not contiguous
        fa_ops.check(q.transpose(1, 2).contiguous().transpose(1, 2), k, k)
    with pytest.raises(ValueError):  # hd not a multiple of 8
        fa_ops.check(q[..., :12].contiguous(), k[..., :12].contiguous(), k[..., :12].contiguous())
    with pytest.raises(ValueError):  # fp32 grid: B * Hkv above 65535
        big_q = torch.empty((65536, 1, 1, 8))
        fa_ops.check(big_q, big_q, big_q)


def test_flash_plain_path_keeps_every_shape_on_cpu():
    """On a CPU tensor the wrapper is the plain version, whatever the
    kernels take (here hd 12 and G 130)."""
    rng = np.random.default_rng(0)
    q = torch.as_tensor(rng.standard_normal((1, 5, 130, 12)).astype(np.float32))
    k = torch.as_tensor(rng.standard_normal((1, 5, 1, 12)).astype(np.float32))
    assert torch.equal(flash_attention(q, k, k), flash_attention_ref(q, k, k))
