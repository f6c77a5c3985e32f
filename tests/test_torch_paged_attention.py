"""Port parity: the paged-attention op against the JAX reference (the Pallas
kernel in interpret mode and its jnp oracle) for fp32, bf16 and int8 pools,
G in {1, 2, 4}, page-edge lengths and -1 tail entries; the split kernel's
decomposition (``paged_attention_split_ref``) against both; the split plan
and shared-memory layout of every supported shape; and the paged write path
dropping -1 entries.  The card-only checks are in test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import t2np

from repro.kernels.paged_attention.ops import paged_attention as jax_paged
from repro.kernels.paged_attention.ref import paged_attention_ref as jax_paged_ref
from repro_torch.kernels.paged_attention import ops, ref
from repro_torch.models.attention import _paged_decode_attend


def _case(b, hq, hkv, hd, bs, lens, dtype, seed=0, n=16, m=5):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, hd)) * 0.3
    if dtype == "int8":
        kp = rng.integers(-127, 127, (n, bs, hkv, hd))
        vp = rng.integers(-127, 127, (n, bs, hkv, hd))
        ks = rng.uniform(0.01, 0.1, (n, bs, hkv))
        vs = rng.uniform(0.01, 0.1, (n, bs, hkv))
    else:
        kp = rng.standard_normal((n, bs, hkv, hd)) * 0.3
        vp = rng.standard_normal((n, bs, hkv, hd)) * 0.3
        ks = vs = None
    bt = np.full((b, m), -1, np.int32)  # -1 tails past each row's pages
    blocks = iter(rng.permutation(n))
    for r, ln in enumerate(lens):
        for j in range(-(-ln // bs)):
            bt[r, j] = next(blocks)
    return q, kp, vp, bt, np.asarray(lens, np.int32), ks, vs


def _run_both(q, kp, vp, bt, ln, ks, vs, dtype):
    qd = "float32" if dtype == "int8" else dtype
    pd = "int8" if dtype == "int8" else dtype
    jargs = [jnp.asarray(q, getattr(jnp, qd)), jnp.asarray(kp, getattr(jnp, pd)),
             jnp.asarray(vp, getattr(jnp, pd)), jnp.asarray(bt), jnp.asarray(ln)]
    targs = [torch.as_tensor(np.asarray(a, np.float32)).to(getattr(torch, qd if i == 0 else pd))
             for i, a in enumerate(jargs[:3])] + [torch.as_tensor(bt), torch.as_tensor(ln)]
    jsc = tsc = (None, None)
    if ks is not None:
        jsc = (jnp.asarray(ks, jnp.float32), jnp.asarray(vs, jnp.float32))
        tsc = (torch.as_tensor(ks, dtype=torch.float32),
               torch.as_tensor(vs, dtype=torch.float32))
    got = t2np(ops.paged_attention(*targs, *tsc))
    want_k = np.asarray(jax_paged(*jargs, *jsc, interpret=True), np.float32)
    want_r = np.asarray(jax_paged_ref(*jargs, *jsc), np.float32)
    return got, want_k, want_r


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("b,hq,hkv,hd,bs,lens", [
    (2, 4, 4, 32, 16, (5, 30)),            # G=1
    (3, 8, 4, 32, 8, (1, 8, 33)),          # G=2, page-edge lengths
    (4, 8, 2, 16, 8, (7, 8, 9, 40)),       # G=4, bs-1 / bs / bs+1 / full table
])
def test_paged_op_matches_reference(b, hq, hkv, hd, bs, lens, dtype):
    got, want_k, want_r = _run_both(*_case(b, hq, hkv, hd, bs, lens, dtype), dtype)
    # fp32: sum order only; bf16: bf16 probabilities/values on both sides
    # but different rounding points (the Pallas kernel works in fp32); int8:
    # dequantized values rounded to q's dtype (fp32 here).
    tol = {"float32": 2e-5, "bfloat16": 5e-2, "int8": 2e-4}[dtype]
    np.testing.assert_allclose(got, want_r, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, want_k, rtol=tol, atol=tol)


@pytest.mark.parametrize("b,hkv,cols", [
    (8, 8, 16),      # Mistral serve decode: max_len 256 / block 16
    (8, 8, 44),      # chip_smoke's paged phase (lengths up to 700)
    (8, 8, 512),     # long8 (up to 8192 tokens)
    (1, 8, 2048),    # one32k (Mistral-7B's max_seq)
    (64, 8, 2048),
    (1, 1, 1),
    (3, 1, 3),
    (2, 2, 200000),  # wider than MAX_PPS x TARGET_BLOCKS columns
])
def test_plan_splits_covers_the_table(b, hkv, cols):
    n, pps = ops.plan_splits(b, hkv, cols)
    assert n * pps >= cols > (n - 1) * pps  # every page once, no empty split
    assert 1 <= n <= ops.MAX_SPLITS and 1 <= pps <= ops.MAX_PPS  # combine, staged table
    assert pps >= min(ops.MIN_PPS, cols) or n == -(-cols // ops.MAX_PPS)
    if cols <= ops.MIN_PPS:
        assert n == 1  # a narrow table runs one launch, no combine
    target = ops.TARGET_BLOCKS_ONE_ROW if b == 1 else ops.TARGET_BLOCKS_BATCH
    if n > 1:  # no more splits than the target blocks need
        assert b * hkv * (n - 1) < target or n == -(-cols // ops.MAX_PPS)
    # ... and splits no longer than the target blocks ask for
    assert pps <= max(-(-cols // -(-target // (b * hkv))), ops.MIN_PPS,
                      -(-cols // ops.MAX_SPLITS))
    assert ops.plan_splits(b, hkv, cols) == (n, pps)  # shapes only: deterministic


@pytest.mark.parametrize("group", ops.GROUPS)
def test_every_supported_shape_fits_shared_memory(group):
    """Every head dim up to MAX_HEAD_DIM and pool type, at the widest split
    plan_splits makes, fits a block's shared memory."""
    for hd in range(1, ops.MAX_HEAD_DIM + 1):
        assert hd <= ops.padded_head_dim(hd) <= max(64, 2 * hd)
        for elem, quant in ((4, False), (2, False), (1, True)):
            assert ops.smem_bytes(group, hd, elem, quant, ops.MAX_PPS) \
                <= ops.MAX_SMEM_BYTES


def _torch_case(q, kp, vp, bt, ln, ks, vs, dtype):
    """_case's arrays as the port's operands (q fp32 for int8 pools)."""
    qd = "float32" if dtype == "int8" else dtype
    return [torch.as_tensor(np.asarray(q, np.float32)).to(getattr(torch, qd)),
            torch.as_tensor(np.asarray(kp, np.float32)).to(getattr(torch, dtype)),
            torch.as_tensor(np.asarray(vp, np.float32)).to(getattr(torch, dtype)),
            torch.as_tensor(bt), torch.as_tensor(ln),
            None if ks is None else torch.as_tensor(ks, dtype=torch.float32),
            None if vs is None else torch.as_tensor(vs, dtype=torch.float32)]


@pytest.mark.parametrize("n_splits", [1, 2, 3, "M"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_split_ref_matches_reference(dtype, n_splits):
    """The split-and-combine decomposition equals the one-pass softmax: rows
    ending at split edges and one token either side (pps x bs = 24, 16, 8
    tokens at 2, 3, 6 splits of a 6-column table), splits that reach no
    token (every row shorter than the table), and a length-0 row (zeros)."""
    b, hq, hkv, hd, bs, m = 9, 8, 4, 16, 8, 6
    lens = (1, 8, 16, 17, 23, 24, 25, 47, 0)
    n = m if n_splits == "M" else n_splits
    case = _case(b, hq, hkv, hd, bs, lens, dtype, n=40, m=m)
    got, want_k, want_r = _run_both(*case, dtype)
    split = t2np(ref.paged_attention_split_ref(*_torch_case(*case, dtype), n_splits=n))
    live = np.asarray(lens) > 0
    tol = {"float32": 2e-5, "bfloat16": 5e-2, "int8": 2e-4}[dtype]
    np.testing.assert_allclose(split[live], got[live], rtol=tol, atol=tol)
    np.testing.assert_allclose(split[live], want_r[live], rtol=tol, atol=tol)
    np.testing.assert_allclose(split[live], want_k[live], rtol=tol, atol=tol)
    assert (split[~live] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_combine_reads_only_the_splits_a_row_reaches(dtype):
    """The kernel leaves the partials of splits past a row's length
    unwritten: the combine must give the same result whatever they hold."""
    b, hq, hkv, hd, bs, m, n_splits = 4, 8, 4, 16, 8, 6, 3
    lens = (5, 17, 48, 0)
    args = _torch_case(*_case(b, hq, hkv, hd, bs, lens, dtype, n=30, m=m), dtype)
    acc, ml = ref.split_partials_ref(*args, None, n_splits, 2)
    want = ref.combine_partials_ref(acc, ml, args[4], bs, m, 2, args[0].dtype)
    for r, n in enumerate(lens):
        pages = -(-n // bs)
        reached = -(-pages // 2)  # splits of 2 pages the row reaches
        acc[r * hkv:(r + 1) * hkv, reached:] = float("nan")
        ml[r * hkv:(r + 1) * hkv, reached:] = float("nan")
    got = ref.combine_partials_ref(acc, ml, args[4], bs, m, 2, args[0].dtype)
    assert torch.equal(got, want) and (got[3] == 0).all()


def test_negative_table_entries_drop_writes():
    """A write through a -1 table entry (or past the table) must not touch
    the pool: torch indexing, like jnp's, wraps a negative flat index onto
    the LAST pool slot, which can belong to a live request."""
    h, hd, bs, n = 2, 16, 8, 3
    # n real blocks plus the sink block init_paged_kv_cache adds.
    cache = {"k": torch.zeros((n + 1, bs, h, hd)), "v": torch.zeros((n + 1, bs, h, hd))}
    ones = torch.ones((1, 1, h, hd))
    bt = torch.full((1, 2), -1, dtype=torch.int32)
    for clen in (0, 7, bs * n - 1, bs * n + 5):
        _paged_decode_attend(ones, ones, ones, cache,
                             torch.as_tensor([clen], dtype=torch.int32), bt, 0.25)
        assert (cache["k"][:n] == 0).all() and (cache["v"][:n] == 0).all(), clen
    # A valid write beside a dropped one (past the table) lands exactly.
    bt = torch.as_tensor([[2, -1]], dtype=torch.int32)
    _paged_decode_attend(ones, ones, ones, cache,
                         torch.as_tensor([bs - 1], dtype=torch.int32), bt, 0.25)
    assert (cache["k"][2, bs - 1] == 1).all() and cache["k"][:n].sum() == h * hd


def test_int8_write_path_quantizes_like_reference():
    from repro.models.attention import _quantize_kv as jax_quantize
    from repro_torch.models.attention import dequantize_kv, quantize_kv

    x = np.random.default_rng(4).standard_normal((3, 5, 2, 16)).astype(np.float32)
    jq, js = jax_quantize(jnp.asarray(x))
    tq, ts = quantize_kv(torch.as_tensor(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7)
    np.testing.assert_allclose(t2np(dequantize_kv(tq, ts, torch.float32)),
                               np.asarray(jq, np.float32) * np.asarray(js)[..., None],
                               rtol=1e-6)
