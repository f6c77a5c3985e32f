"""The rwkv6 backward kernels' chunked, division-free algebra on the CPU:
``rwkv6_chunked_bwd_ref`` (the kernels' schedule written plainly) against
the plain reverse recurrence ``rwkv6_scan_bwd_ref`` in fp64 and fp32 and
against ``jax.vjp`` of the reference's scan, at ragged T around the chunk's
edges, every K the kernels take, long memory and extreme decay; and
``bwd_plan``, the kernels' grids and scratch.  Inputs come from numpy
seeds; each tolerance is stated where it is used."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import t2np

from repro.kernels.rwkv6.ref import rwkv6_scan_ref as jax_rwkv6_scan_ref
from repro_torch.kernels.rwkv6 import ops as rwkv_ops
from repro_torch.kernels.rwkv6.ref import rwkv6_chunked_bwd_ref, rwkv6_scan_bwd_ref

NAMES = ("dr", "dk", "dv", "dw", "du")
C = rwkv_ops.BWD_CHUNK


def _inputs(bh, t, k, seed, w=None, dtype=np.float32):
    rng = np.random.default_rng(seed)
    r, kk, v = (rng.standard_normal((bh, t, k)) * 0.5 for _ in range(3))
    if w is None:  # decays in (0, 1), strong ones included
        w = rng.uniform(0.01, 0.999, (bh, t, k))
    u = rng.standard_normal((bh, k)) * 0.5
    dy = rng.standard_normal((bh, t, k))
    w = np.broadcast_to(np.float64(w), (bh, t, k))
    return [torch.as_tensor(np.array(a, dtype=dtype)) for a in (r, kk, v, w, u, dy)]


def _elem_err(got, want) -> float:
    """chip_smoke.py's ``bwd_elem_err`` in the inputs' precision: max over
    elements of |got - want| / (|want| + rms of want's row + rms of want)
    (a gradient row can vanish: dw at T = 1 is exactly 0)."""
    w = want.double()
    rms = w.pow(2).mean(-1, keepdim=True).sqrt()
    floor = w.pow(2).mean().sqrt()
    return float(((got.double() - w).abs() / (w.abs() + rms + floor).clamp_min(1e-300)).max())


def _check(got, want, tol):
    for name, g, x in zip(NAMES, got, want):
        assert g.dtype == x.dtype and g.shape == x.shape, name
        assert bool(torch.isfinite(g).all()), name
        assert _elem_err(g, x) <= tol, name


# fp64: the chunked form is the plain recurrence's algebra, every decay a
# running product (no quotient), so the two agree to fp64 rounding of sums
# in other orders (measured up to ~3e-15): 1e-12 allowed.
@pytest.mark.parametrize("k", [8, 16, 32, 64])
@pytest.mark.parametrize("t", [1, C - 1, C, C + 1, 2 * C + 1])
def test_chunked_fp64_matches_plain(t, k):
    args = _inputs(2, t, k, seed=t * k + 3, dtype=np.float64)
    _check(rwkv6_chunked_bwd_ref(*args, chunk=C), rwkv6_scan_bwd_ref(*args), 1e-12)


# Long memory (w = 1 - 1e-3 over 400 tokens: S and G sum hundreds of terms,
# dw's rows cancel) and extreme decay (w = 1e-6 past one chunk: a running
# product of 16 tokens underflows, where a ratio of two would be 0/0).
@pytest.mark.parametrize("t,k,w", [(400, 8, 1.0 - 1e-3), (70, 64, 1e-6), (45, 16, 1e-6)])
def test_chunked_fp64_long_memory_and_extreme_decay(t, k, w):
    args = _inputs(2, t, k, seed=t + k, w=w, dtype=np.float64)
    _check(rwkv6_chunked_bwd_ref(*args, chunk=C), rwkv6_scan_bwd_ref(*args), 1e-12)


# The algebra does not depend on the chunk: 16 tokens (the design's other
# choice) and a chunk longer than T, in fp64.
@pytest.mark.parametrize("chunk,t", [(16, 37), (16, 16), (64, 40)])
def test_chunked_fp64_other_chunks(chunk, t):
    args = _inputs(2, t, 8, seed=chunk + t, dtype=np.float64)
    _check(rwkv6_chunked_bwd_ref(*args, chunk=chunk), rwkv6_scan_bwd_ref(*args), 1e-12)


# fp32 against the plain fp32 backward, at chip_smoke.py's
# RWKV_BWD_ELEM_TOL (the kernels' own tolerance against the same plain
# version on the card): fp32 rounding of sums in other orders, measured up
# to ~1e-6.
@pytest.mark.parametrize("t,k,w", [(1, 8, None), (C + 1, 16, None), (2 * C + 1, 64, None),
                                   (37, 32, None), (400, 8, 1.0 - 1e-3), (70, 64, 1e-6)])
def test_chunked_fp32_matches_plain_fp32(t, k, w):
    import chip_smoke

    args = _inputs(3, t, k, seed=t * k + 11, w=w)
    got = rwkv6_chunked_bwd_ref(*args, chunk=C)
    assert all(g.dtype == torch.float32 for g in got)
    _check(got, rwkv6_scan_bwd_ref(*args), chip_smoke.RWKV_BWD_ELEM_TOL["float32"])


# fp32 against XLA's autodiff of the reference's scan, as
# test_plain_backward_matches_jax_vjp holds the plain backward: rtol 1e-4
# with atol 1e-5 of the tensor's max |grad|.
@pytest.mark.parametrize("t,k,w", [(C - 1, 8, None), (2 * C + 1, 64, None),
                                   (300, 8, 1.0 - 1e-3), (45, 64, 1e-6)])
def test_chunked_fp32_matches_jax_vjp(t, k, w):
    args = _inputs(2, t, k, seed=t + 5 * k, w=w)
    _, vjp = jax.vjp(jax_rwkv6_scan_ref, *(jnp.asarray(t2np(a)) for a in args[:5]))
    want = vjp(jnp.asarray(t2np(args[5])))
    got = rwkv6_chunked_bwd_ref(*args, chunk=C)
    for name, g, x in zip(NAMES, got, want):
        x = np.asarray(x)
        assert g.shape == x.shape, name
        np.testing.assert_allclose(t2np(g), x, rtol=1e-4, atol=1e-5 * np.abs(x).max(),
                                   err_msg=name)


def test_chunked_keeps_dtypes_bf16():
    """bf16 operands: each gradient comes back in its operand's dtype
    (du in u's), as the plain backward's."""
    args = _inputs(2, 19, 8, seed=5)
    args16 = [a.to(torch.bfloat16) if i != 4 else a for i, a in enumerate(args)]
    got = rwkv6_chunked_bwd_ref(*args16)
    want = rwkv6_scan_bwd_ref(*args16)
    assert [g.dtype for g in got] == [x.dtype for x in want]


def test_bwd_plan_eval_shape():
    """rwkv6-1.6b's eval batch (128 heads, 2048 tokens, K 64): 64 chunks a
    head, one block a (head, chunk) for the summaries and the gradients,
    two directions of 8 blocks a head for the scan, and scratch within the
    per-token design's 512 MiB (2 x 128 MiB of chunk states, then W and
    du's shares)."""
    p = rwkv_ops.bwd_plan(2048, 64, 128)
    assert (p.chunk, p.chunks) == (32, 64)
    assert p.scan_tiles == 8
    assert p.grids == (128 * 64, 8 * 128 * 2, 128 * 64)
    assert p.scratch_bytes == 4 * 128 * 64 * (2 * 64 * 64 + 2 * 64)
    assert 2 * 128 * 2 ** 20 < p.scratch_bytes <= 512 * 2 ** 20


@pytest.mark.parametrize("t,k,heads,chunks,tiles", [(1, 8, 3, 1, 1), (31, 16, 2, 1, 1),
                                                    (32, 32, 2, 1, 2), (33, 64, 1, 2, 8),
                                                    (200, 64, 32, 7, 8)])
def test_bwd_plan_ragged(t, k, heads, chunks, tiles):
    """A ragged last chunk counts as a chunk (the kernels mask it); the
    scan's tiles cover K x K in float4s, 128 threads a block."""
    p = rwkv_ops.bwd_plan(t, k, heads)
    assert (p.chunks, p.scan_tiles) == (chunks, tiles)
    assert p.scratch_floats == heads * chunks * (2 * k * k + 2 * k)


def test_bwd_plan_rejects_other_widths():
    with pytest.raises(ValueError):
        rwkv_ops.bwd_plan(64, 24, 2)
