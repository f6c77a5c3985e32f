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


# (rows, dtype, n, aligned) -> kernel: bf16 with n % 8 == 0 and 16-byte
# aligned v/v2 streams at 1..16 rows and runs the mma kernel at 17..1024;
# everything else takes the tile kernel; above 1024 rows no kernel runs.
@pytest.mark.parametrize("rows,dtype,n,aligned,kernel", [
    (1, torch.bfloat16, 4096, True, "stream"),
    (8, torch.bfloat16, 14336, True, "stream"),
    (16, torch.bfloat16, 1024, True, "stream"),
    (17, torch.bfloat16, 4096, True, "mma"),
    (200, torch.bfloat16, 4096, True, "mma"),
    (512, torch.bfloat16, 4096, True, "mma"),
    (1024, torch.bfloat16, 14336, True, "mma"),
    (64, torch.float32, 4096, True, "tile"),
    (64, torch.bfloat16, 4096, False, "tile"),
    (64, torch.bfloat16, 4100, True, "tile"),
    (1025, torch.bfloat16, 4096, True, "plain"),
    (8, torch.float32, 4096, True, "tile"),
    (8, torch.bfloat16, 4100, True, "tile"),
    (8, torch.bfloat16, 4096, False, "tile"),
])
def test_plan_picks_kernel(rows, dtype, n, aligned, kernel):
    assert ops.plan(rows, dtype, 4096, n, 2421, 127, aligned).kernel == kernel


def test_plan_mma_needs_k_in_multiple_of_8():
    """x's rows are read 16 bytes at a time: K % 8 != 0 takes the tile kernel."""
    assert ops.plan(64, torch.bfloat16, 4100, 4096, 2421, 127, True).kernel == "tile"
    assert ops.plan(64, torch.bfloat16, 4104, 4096, 2421, 127, True).kernel == "mma"


def _covers(s, c, depth, stage):
    return c % stage == 0 and (s == 0 if depth == 0 else (s - 1) * c < depth <= s * c)


# (rows, K, N, k1, k2): the Mistral-7B gate/down/wq/wk shapes at ratio 0.2,
# the card tests' ranks, and degenerate depths.
PLAN_SHAPES = [(8, 4096, 14336, 2421, 127), (1, 14336, 4096, 2421, 127),
               (16, 4096, 4096, 1556, 82), (8, 4096, 1024, 622, 33),
               (7, 320, 776, 61, 3), (9, 14336, 776, 1, 5), (8, 320, 200, 8, 8),
               (64, 4096, 14336, 2421, 127), (512, 2548, 4096, 2421, 127),
               (8, 16, 8, 1, 0), (17, 4096, 14336, 2421, 127),
               (200, 14336, 4096, 2421, 127), (512, 4096, 1024, 622, 33),
               (1024, 2048, 7168, 1210, 64), (31, 328, 776, 1, 5), (64, 16, 8, 1, 0)]


@pytest.mark.parametrize("rows,k_in,n,k1,k2", PLAN_SHAPES)
def test_plan_splits_cover_each_depth(rows, k_in, n, k1, k2):
    """Each phase's slices cover its depth exactly: the stream kernel's
    chunks are multiples of its ring stage (at most STREAM_MAX_CHUNK) and
    phase 2 covers v's and v2's depths with slices of their own; the tile
    kernel keeps ``split_k``."""
    p = ops.plan(rows, torch.bfloat16, k_in, n, k1, k2, True)
    if p.kernel == "tile":
        assert (p.s1, p.c1) == ops.split_k(rows, k_in, k1 + k2)
        assert (p.s2, p.c2) == ops.split_k(rows, k1 + k2, n)
        return
    if p.kernel == "mma":
        stage = ops.MMA_BK
        assert rows > ops.STREAM_ROWS
    else:
        stage = ops.STREAM_BK
        assert p.c1 <= ops.STREAM_MAX_CHUNK and p.c2 <= ops.STREAM_MAX_CHUNK
    assert _covers(p.s1, p.c1, k_in, stage)
    sv = -(-k1 // p.c2)
    assert _covers(sv, p.c2, k1, stage) and _covers(p.s2 - sv, p.c2, k2, stage)


@pytest.mark.parametrize("rows,waves", [(1, ops.TARGET_BLOCKS), (8, ops.TARGET_BLOCKS),
                                        (9, ops.SM_COUNT), (16, ops.SM_COUNT)])
def test_stream_chunk_uses_the_row_tiles_block_count(rows, waves):
    """The stream kernel runs 2 blocks an SM with its 8-row tile and 1 with
    its 16-row tile: the chunk plan sizes its waves by the tile that runs."""
    assert ops.stream_wave(rows) == waves
    k_in, n, k1, k2 = 4096, 14336, 2421, 127
    p = ops.plan(rows, torch.bfloat16, k_in, n, k1, k2, True)
    assert p.kernel == "stream"
    bn = ops.STREAM_BN
    assert p.c1 == ops.stream_chunk(-(-k1 // bn) + -(-k2 // bn), (k_in,), waves)
    assert p.c2 == ops.stream_chunk(-(-n // bn), (k1, k2), waves)


def test_mma_scratch_columns_are_aligned():
    """The mma kernel's t puts u2's columns at k1 rounded up to 8 and pads
    rows to a multiple of 8; the other kernels keep k1 + k2."""
    assert ops.t_cols("mma", 2421, 127) == 2424 + 128
    assert ops.t_cols("mma", 8, 8) == 16 and ops.t_cols("mma", 1, 5) == 16
    assert ops.t_cols("stream", 2421, 127) == ops.t_cols("tile", 2421, 127) == 2548
