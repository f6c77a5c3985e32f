"""Port parity: the paged-attention op against the JAX reference (the Pallas
kernel in interpret mode and its jnp oracle) for fp32, bf16 and int8 pools,
G in {1, 2, 4}, page-edge lengths and -1 tail entries; and the paged write
path dropping -1 entries.  The card-only checks are in test_torch_cuda.py."""

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
