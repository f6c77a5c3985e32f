"""Port parity: the nested low-rank op and ``linear_apply`` against the JAX
reference (the Pallas kernel in interpret mode and its jnp oracle)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import t2np

from repro.core import lowrank as jax_lowrank
from repro.kernels.nested_lowrank.ops import nested_lowrank_matmul as jax_nested
from repro.kernels.nested_lowrank.ref import nested_lowrank_matmul_ref as jax_nested_ref
from repro_torch.core import lowrank
from repro_torch.kernels.nested_lowrank import ops, ref


def _tol(dtype):
    # As tests/test_kernels.py: bf16 sides round intermediates at different
    # points (the kernel accumulates in fp32), fp32 differs by sum order.
    return dict(rtol=6e-2, atol=6e-2) if dtype == "bfloat16" else dict(rtol=2e-5, atol=2e-5)


SHAPES = [(8, 64, 16, 4, 128), (16, 128, 32, 8, 256), (4, 96, 24, 8, 192),
          (32, 256, 128, 16, 512), (8, 64, 16, 4, 100), (8, 64, 16, 4, 320),
          (4, 64, 16, 4, 130)]


@pytest.mark.parametrize("m,kin,k1,k2,n", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nested_op_matches_reference_kernel(m, kin, k1, k2, n, dtype):
    rng = np.random.default_rng(0)
    arrs = [rng.standard_normal(s) * 0.3 for s in
            ((m, kin), (kin, k1), (k1, n), (kin, k2), (k2, n))]
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    tx = [torch.as_tensor(np.asarray(a, np.float32)).to(getattr(torch, dtype))
          for a in jx]
    got = t2np(ops.nested_lowrank_matmul(*tx))
    want_kernel = np.asarray(jax_nested(*jx, block_n=128, interpret=True), np.float32)
    want_ref = np.asarray(jax_nested_ref(*jx), np.float32)
    np.testing.assert_allclose(got, want_kernel, **_tol(dtype))
    np.testing.assert_allclose(got, want_ref, **_tol(dtype))


def test_batched_leading_dims_and_row_gate():
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.standard_normal((2, 3, 64)), dtype=torch.float32)
    f = [torch.as_tensor(rng.standard_normal(s), dtype=torch.float32)
         for s in ((64, 8), (8, 128), (64, 4), (4, 128))]
    y = ops.nested_lowrank_matmul(x, *f)
    assert y.shape == (2, 3, 128)
    np.testing.assert_allclose(t2np(y), t2np(ref.nested_lowrank_matmul_ref(x, *f)),
                               rtol=1e-6, atol=1e-6)
    assert ops.MAX_KERNEL_ROWS == 1024  # the reference's row gate


@pytest.mark.parametrize("kind", ["dense", "single", "nested"])
def test_linear_apply_matches_reference(kind):
    rng = np.random.default_rng(7)
    if kind == "dense":
        p = {"kernel": rng.standard_normal((64, 96))}
    else:
        p = {"u": rng.standard_normal((64, 16)), "v": rng.standard_normal((16, 96))}
        if kind == "nested":
            p.update(u2=rng.standard_normal((64, 4)), v2=rng.standard_normal((4, 96)))
    x = rng.standard_normal((3, 5, 64))
    jp = {k: jnp.asarray(v, jnp.float32) for k, v in p.items()}
    tp = {k: torch.as_tensor(v, dtype=torch.float32) for k, v in p.items()}
    got = lowrank.linear_apply(tp, torch.as_tensor(x, dtype=torch.float32))
    want = jax_lowrank.linear_apply(jp, jnp.asarray(x, jnp.float32))
    np.testing.assert_allclose(t2np(got), np.asarray(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(t2np(lowrank.dense_equivalent(tp)),
                               np.asarray(jax_lowrank.dense_equivalent(jp)),
                               rtol=2e-5, atol=2e-5)
    assert lowrank.flops_per_token(tp) == jax_lowrank.flops_per_token(jp)
    assert lowrank.param_count(tp) == jax_lowrank.param_count(jp)


def test_split_k_covers_depth():
    """The split-K plan the wrapper hands the kernel covers the reduction
    exactly: s chunks of depth c (a multiple of the tile depth) with
    (s - 1) * c < depth <= s * c."""
    for rows, depth, cols in ((1, 14336, 4096), (8, 4096, 2548), (512, 2548, 14336),
                              (8, 655, 1024), (64, 16, 8), (1, 1, 1)):
        s, c = ops.split_k(rows, depth, cols)
        assert c % ops.BK == 0 and (s - 1) * c < depth <= s * c
