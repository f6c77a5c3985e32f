"""Card-only checks of the port's CUDA kernels against their plain PyTorch
versions, and of a served stream with the kernels against the same stream
through the plain versions.  CUDA kernels have no CPU mode, so every test
here is marked ``cuda`` and skips without a card.  Imports neither jax nor
repro, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import contextlib
import dataclasses
import subprocess
import time

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import check_launch
from repro_torch.calib.runner import collect_grams
from repro_torch.configs import (MISTRAL_7B, MOONSHOT_V1_16B_A3B, RWKV6_1_6B, get_config,
                                 small_lm)
from repro_torch.core import CompressionConfig, build_plan, compress_params
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.gram import ops as gram_ops
from repro_torch.kernels.gram import ref as gram_ref
from repro_torch.kernels.nested_lowrank import ops as nlr_ops
from repro_torch.kernels.nested_lowrank import ref as nlr_ref
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention import ref as pa_ref
from repro_torch.kernels.rwkv6 import ops as rwkv_ops
from repro_torch.kernels.rwkv6 import ref as rwkv_ref
from repro_torch.models import build_model, moe
from repro_torch.serving.engine import ServingEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _err(got, want):
    """Max |got - want| relative to max |want|."""
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


# bf16: kernel and plain version round the rank-width intermediate and the
# output to bf16 at the same points, summing in different orders; fp32: sum
# order only.
NESTED_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}


# Per-element nested tolerance (chip_smoke.py's NESTED_ELEM_TOL): |kernel -
# plain| <= tol * (|plain| + rms of its row).  bf16: the plain version
# rounds x@u, x@u2, their two products and the sum to bf16 (three
# roundings of the output, one ulp up to 2^-7 of |y|), the kernel rounds t
# and y once each; fp32: sum order only.
NESTED_ELEM_TOL = {torch.bfloat16: 2 ** -5, torch.float32: 1e-4}


def _nested_checks(got, want, dtype):
    assert bool(torch.isfinite(got).all())
    assert _err(got, want) < NESTED_TOL[dtype]
    assert _elem_err(got, want) <= NESTED_ELEM_TOL[dtype]


def _nested_counts():
    return (nlr_ops.launches, nlr_ops.stream_launches, nlr_ops.mma_launches,
            nlr_ops.tile_launches)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 8, 64, 512, 1024])
def test_nested_kernel_matches_plain(dev, m, dtype):
    g = torch.Generator(device=dev).manual_seed(m)
    mk = lambda *s: (torch.randn(s, generator=g, device=dev) * s[0] ** -0.5).to(dtype)  # noqa: E731
    x, u, v, u2, v2 = mk(m, 320), mk(320, 61), mk(61, 200), mk(320, 3), mk(3, 200)
    before = nlr_ops.launches
    got = nlr_ops.nested_lowrank_matmul(x, u, v, u2, v2)
    torch.cuda.synchronize()
    assert nlr_ops.launches == before + 1
    _nested_checks(got, nlr_ref.nested_lowrank_matmul_ref(x, u, v, u2, v2), dtype)


def _at_offset(t, off):
    """A contiguous copy of ``t`` starting ``off`` elements into a larger
    buffer (a stacked layer slice's address)."""
    buf = torch.zeros(off + t.numel() + 8, dtype=t.dtype, device=t.device)
    view = buf[off:off + t.numel()].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("k_in", [320, 14336])
@pytest.mark.parametrize("k1,k2", [(61, 3), (2421, 127), (8, 8), (1, 5)])
@pytest.mark.parametrize("m", [1, 7, 8, 9, 16])
def test_nested_stream_kernel_edges(dev, m, k1, k2, k_in):
    """The stream kernel at both row tiles, odd and tiny ranks, u and u2 at
    odd element offsets (every row shift), a ragged last column tile (N =
    3 * 256 + 8) and split-K over a long depth."""
    n = 776
    g = torch.Generator(device=dev).manual_seed(m * 1000 + k1 + k_in)
    mk = lambda *s: (torch.randn(s, generator=g, device=dev) * s[0] ** -0.5).to(torch.bfloat16)  # noqa: E731
    x, v, v2 = mk(m, k_in), mk(k1, n), mk(k2, n)
    u, u2 = _at_offset(mk(k_in, k1), 3), _at_offset(mk(k_in, k2), 5)
    assert u.data_ptr() % 16 and u2.data_ptr() % 16 and u.is_contiguous()
    assert nlr_ops.plan(m, torch.bfloat16, k_in, n, k1, k2, True).kernel == "stream"
    n0, s0, a0, t0 = _nested_counts()
    got = nlr_ops.nested_lowrank_matmul(x, u, v, u2, v2)
    torch.cuda.synchronize()
    assert _nested_counts() == (n0 + 1, s0 + 1, a0, t0)
    _nested_checks(got, nlr_ref.nested_lowrank_matmul_ref(x, u, v, u2, v2), torch.bfloat16)


@pytest.mark.parametrize("k_in", [320, 200])
@pytest.mark.parametrize("m", [17, 31, 64, 200, 512, 1024])
def test_nested_mma_kernel_matches_plain(dev, m, k_in):
    """The mma kernel at every row tile shape: 17 (the first mma row count),
    31 and 200 (not multiples of 16), 64, 512 and 1024 (the gate); odd k1,
    k2 < 8, N = 200 (not a multiple of the 128-column tile), K = 200 (not a
    multiple of the 32-deep stage)."""
    g = torch.Generator(device=dev).manual_seed(m + k_in)
    mk = lambda *s: (torch.randn(s, generator=g, device=dev) * s[0] ** -0.5).to(torch.bfloat16)  # noqa: E731
    x, u, v, u2, v2 = mk(m, k_in), mk(k_in, 61), mk(61, 200), mk(k_in, 3), mk(3, 200)
    assert nlr_ops.plan(m, torch.bfloat16, k_in, 200, 61, 3, True).kernel == "mma"
    n0, s0, a0, t0 = _nested_counts()
    got = nlr_ops.nested_lowrank_matmul(x, u, v, u2, v2)
    torch.cuda.synchronize()
    assert _nested_counts() == (n0 + 1, s0, a0 + 1, t0)
    _nested_checks(got, nlr_ref.nested_lowrank_matmul_ref(x, u, v, u2, v2), torch.bfloat16)


@pytest.mark.parametrize("k_in", [328, 14336])
@pytest.mark.parametrize("k1,k2", [(61, 3), (2421, 127), (8, 8), (1, 5), (130, 9)])
@pytest.mark.parametrize("m", [17, 31, 200])
def test_nested_mma_kernel_edges(dev, m, k1, k2, k_in):
    """The mma kernel with u and u2 at odd element offsets (every row
    shift, re-packed), odd and tiny ranks (a u2 tile of 3 to 127 columns,
    a v2 K-range shorter than one stage), ragged last column tiles (N =
    6 * 128 + 8), K 328 (ends mid-stage) and split-K over a long depth."""
    n = 776
    g = torch.Generator(device=dev).manual_seed(m * 1000 + k1 + k_in)
    mk = lambda *s: (torch.randn(s, generator=g, device=dev) * s[0] ** -0.5).to(torch.bfloat16)  # noqa: E731
    x, v, v2 = mk(m, k_in), mk(k1, n), mk(k2, n)
    u, u2 = _at_offset(mk(k_in, k1), 3), _at_offset(mk(k_in, k2), 5)
    assert u.data_ptr() % 16 and u2.data_ptr() % 16 and u.is_contiguous()
    assert nlr_ops.plan(m, torch.bfloat16, k_in, n, k1, k2, True).kernel == "mma"
    n0, s0, a0, t0 = _nested_counts()
    got = nlr_ops.nested_lowrank_matmul(x, u, v, u2, v2)
    torch.cuda.synchronize()
    assert _nested_counts() == (n0 + 1, s0, a0 + 1, t0)
    _nested_checks(got, nlr_ref.nested_lowrank_matmul_ref(x, u, v, u2, v2), torch.bfloat16)


def test_nested_mma_kernel_takes_unaligned_x(dev):
    """x at an odd element offset (a view): the wrapper hands the mma kernel
    an aligned copy; the result is the same as from an aligned x."""
    g = torch.Generator(device=dev).manual_seed(5)
    mk = lambda *s: (torch.randn(s, generator=g, device=dev) * s[0] ** -0.5).to(torch.bfloat16)  # noqa: E731
    x, u, v, u2, v2 = mk(40, 320), mk(320, 61), mk(61, 200), mk(320, 3), mk(3, 200)
    xo = _at_offset(x, 1)
    assert xo.data_ptr() % 16
    n0, s0, a0, t0 = _nested_counts()
    got = nlr_ops.nested_lowrank_matmul(xo, u, v, u2, v2)
    want = nlr_ops.nested_lowrank_matmul(x, u, v, u2, v2)
    torch.cuda.synchronize()
    assert _nested_counts() == (n0 + 2, s0, a0 + 2, t0)
    assert torch.equal(got, want)
    _nested_checks(got, nlr_ref.nested_lowrank_matmul_ref(x, u, v, u2, v2), torch.bfloat16)


def test_nested_gate_picks_kernel(dev):
    """bf16 with aligned v/v2 rows runs the stream kernel at <= 16 rows and
    the mma kernel at 17; N % 8 != 0, a misaligned v and fp32 run the tile
    kernel."""
    g = torch.Generator(device=dev).manual_seed(17)

    def mk(*s, dtype=torch.bfloat16):
        return (torch.randn(s, generator=g, device=dev) * s[0] ** -0.5).to(dtype)

    def case(m, n, dtype=torch.bfloat16, v_off=0):
        x, u, u2 = mk(m, 320, dtype=dtype), mk(320, 61, dtype=dtype), mk(320, 3, dtype=dtype)
        v = _at_offset(mk(61, n, dtype=dtype), v_off)
        return x, u, v, u2, mk(3, n, dtype=dtype)

    for args, kernel in ((case(8, 200), "stream"), (case(8, 201), "tile"),
                         (case(8, 200, v_off=1), "tile"),
                         (case(8, 200, dtype=torch.float32), "tile"), (case(17, 200), "mma"),
                         (case(64, 201), "tile"), (case(64, 200, v_off=1), "tile"),
                         (case(64, 200, dtype=torch.float32), "tile")):
        n0, s0, a0, t0 = _nested_counts()
        got = nlr_ops.nested_lowrank_matmul(*args)
        torch.cuda.synchronize()
        want = (n0 + 1, s0 + (kernel == "stream"), a0 + (kernel == "mma"),
                t0 + (kernel == "tile"))
        assert _nested_counts() == want, kernel
        _nested_checks(got, nlr_ref.nested_lowrank_matmul_ref(*args), args[0].dtype)


def test_nested_stream_launch_refuses_what_it_cannot_do(dev):
    """The C launcher returns an error, and launches nothing, for a stream
    launch outside its gate: a misaligned v, fp32, 17 rows, a chunk that is
    not a multiple of the stage depth."""
    x = torch.zeros((8, 64), dtype=torch.bfloat16, device=dev)
    u, u2 = torch.zeros((64, 8), dtype=x.dtype, device=dev), torch.zeros((64, 8), dtype=x.dtype, device=dev)
    v = torch.zeros((8 * 64 + 8,), dtype=x.dtype, device=dev)
    y, t = torch.empty((17, 64), dtype=x.dtype, device=dev), torch.empty((17, 16), dtype=x.dtype, device=dev)
    part = torch.empty((64, 17, 64), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def launch(m=8, v_ptr=v.data_ptr(), dtype=1, c1=32, c2=32):
        return nlr_ops._launcher()(x.data_ptr(), u.data_ptr(), v_ptr, u2.data_ptr(),
                                   v.data_ptr(), y.data_ptr(), part.data_ptr(), t.data_ptr(),
                                   part.data_ptr(), m, 64, 8, 8, 64, -(-64 // c1), c1,
                                   2 * -(-8 // c2), c2, 1, dtype, 1, stream)
    assert launch() == 0
    for bad in (dict(v_ptr=v.data_ptr() + 2), dict(dtype=0), dict(m=17), dict(c1=48),
                dict(c2=1024)):
        assert launch(**bad) != 0, bad
        with pytest.raises(RuntimeError):
            check_launch(launch(**bad), "nested_lowrank")
    torch.cuda.synchronize()


def test_nested_mma_launch_refuses_what_it_cannot_do(dev):
    """The C launcher returns an error, and launches nothing, for an mma
    launch outside its gate: fp32, 16 or 1025 rows, N % 8 != 0, K % 8 != 0,
    a misaligned x, t or v, a chunk that is not a multiple of the stage
    depth, splits that do not cover a depth."""
    x = torch.zeros((1025 * 64 + 8,), dtype=torch.bfloat16, device=dev)
    u, u2 = torch.zeros((64, 8), dtype=x.dtype, device=dev), torch.zeros((64, 8), dtype=x.dtype, device=dev)
    v = torch.zeros((8 * 64 + 8,), dtype=x.dtype, device=dev)
    y, t = torch.empty((1025, 64), dtype=x.dtype, device=dev), torch.empty((1025, 24), dtype=x.dtype, device=dev)
    part = torch.empty((64, 1025, 64), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def launch(m=32, k_in=64, n=64, x_ptr=x.data_ptr(), t_ptr=t.data_ptr(), v_ptr=v.data_ptr(),
               dtype=1, c1=32, c2=32, s1=None):
        s1 = -(-k_in // c1) if s1 is None else s1
        return nlr_ops._launcher()(x_ptr, u.data_ptr(), v_ptr, u2.data_ptr(), v.data_ptr(),
                                   y.data_ptr(), part.data_ptr(), t_ptr, part.data_ptr(), m,
                                   k_in, 8, 8, n, s1, c1, 2 * -(-8 // c2), c2, 1, dtype, 2,
                                   stream)
    assert launch() == 0
    torch.cuda.synchronize()
    for bad in (dict(dtype=0), dict(m=16), dict(m=1025), dict(n=60), dict(k_in=60),
                dict(x_ptr=x.data_ptr() + 2), dict(t_ptr=t.data_ptr() + 2),
                dict(v_ptr=v.data_ptr() + 2), dict(c1=48), dict(c2=16), dict(s1=3)):
        assert launch(**bad) != 0, bad
        with pytest.raises(RuntimeError):
            check_launch(launch(**bad), "nested_lowrank")
    torch.cuda.synchronize()


def test_nested_rows_above_gate_use_plain_matmuls(dev):
    x = torch.randn((1025, 64), device=dev)
    f = [torch.randn(s, device=dev) for s in ((64, 8), (8, 32), (64, 2), (2, 32))]
    before = nlr_ops.launches
    nlr_ops.nested_lowrank_matmul(x, *f)
    assert nlr_ops.launches == before


def _batched_factors(g, dev, e, k_in, n, k1, k2, dtype, u_offset=0):
    """Per-expert factors (E, ...), u and u2 at ``u_offset`` elements into
    their buffers (odd offsets: every row shift)."""
    mk = lambda *s: (torch.randn(s, generator=g, device=dev) * s[-2] ** -0.5).to(dtype)  # noqa: E731
    u, u2 = mk(e, k_in, k1), mk(e, k_in, k2)
    if u_offset:
        u, u2 = _at_offset(u, u_offset), _at_offset(u2, u_offset + 2)
    return u, mk(e, k1, n), u2, mk(e, k2, n)


@pytest.mark.parametrize("dtype,rows,kernel", [
    (torch.bfloat16, 1, "stream"), (torch.bfloat16, 8, "stream"),
    (torch.bfloat16, 16, "stream"), (torch.bfloat16, 17, "mma"),
    (torch.bfloat16, 200, "mma"), (torch.bfloat16, 1024, "mma"),
    (torch.float32, 8, "tile"), (torch.float32, 200, "tile")])
@pytest.mark.parametrize("experts", [1, 5, 64])
def test_nested_batched_matches_plain_by_route(dev, experts, rows, kernel, dtype):
    """The batched form on each route, every expert's rows through its own
    factors (odd ranks, u/u2 at odd offsets, N not a multiple of a tile),
    per element against the batched plain version; one launch, counted as
    batched and by kernel."""
    g = torch.Generator(device=dev).manual_seed(experts * 100 + rows)
    k_in, n, k1, k2 = 328, 200, 61, 3
    u, v, u2, v2 = _batched_factors(g, dev, experts, k_in, n, k1, k2, dtype, u_offset=3)
    x = torch.randn((experts, rows, k_in), generator=g, device=dev).to(dtype)
    assert nlr_ops.plan(rows, dtype, k_in, n, k1, k2, True, experts).kernel == kernel
    before = (*_nested_counts(), dict(nlr_ops.batched_by_kernel))
    got = nlr_ops.nested_lowrank_matmul_batched(x, u, v, u2, v2)
    torch.cuda.synchronize()
    by = {"stream": 1, "mma": 2, "tile": 3}[kernel]
    after = _nested_counts()
    assert [a - b for a, b in zip(after, before)] == [1] + [int(i == by) for i in (1, 2, 3)]
    assert {k: v - before[4][k] for k, v in nlr_ops.batched_by_kernel.items()} == {
        k: int(k == kernel) for k in before[4]}
    assert got.shape == (experts, rows, n)
    _nested_checks(got, nlr_ref.nested_lowrank_matmul_batched_ref(x, u, v, u2, v2), dtype)


@pytest.mark.parametrize("rows,k_in,n", [(8, 2048, 1408), (8, 1408, 2048), (24, 2048, 1408),
                                         (960, 1408, 2048)])
def test_nested_batched_expert_shapes(dev, rows, k_in, n):
    """moonshot-v1-16b-a3b's expert projections at ratio 0.2 (rank 667, k1
    634 + k2 33) for 64 experts: decode rows, an admission's and an eval
    batch's capacity; each expert equals the single form on its slice to
    the per-element tolerance."""
    g = torch.Generator(device=dev).manual_seed(rows + k_in)
    u, v, u2, v2 = _batched_factors(g, dev, 64, k_in, n, 634, 33, torch.bfloat16)
    x = torch.randn((64, rows, k_in), generator=g, device=dev).to(torch.bfloat16)
    x[5:9] = 0.0  # experts with empty capacity rows
    got = nlr_ops.nested_lowrank_matmul_batched(x, u, v, u2, v2)
    want = nlr_ref.nested_lowrank_matmul_batched_ref(x, u, v, u2, v2)
    torch.cuda.synchronize()
    assert not got[5:9].any()
    for e in (0, 17, 63):
        _nested_checks(got[e], want[e], torch.bfloat16)
        single = nlr_ops.nested_lowrank_matmul(x[e], u[e], v[e], u2[e], v2[e])
        assert _elem_err(got[e], single) <= NESTED_ELEM_TOL[torch.bfloat16]


def test_nested_batched_rows_above_gate_use_plain_matmuls(dev):
    x = torch.randn((3, 1025, 64), device=dev)
    f = [torch.randn(s, device=dev) for s in ((3, 64, 8), (3, 8, 32), (3, 64, 2), (3, 2, 32))]
    before = nlr_ops.launches
    nlr_ops.nested_lowrank_matmul_batched(x, *f)
    assert nlr_ops.launches == before


@pytest.mark.parametrize("pool", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
def test_paged_kernel_matches_plain(dev, group, pool):
    rng = np.random.default_rng(group)
    b, hkv, hd, bs, n, m = 5, 2, 64, 16, 16, 4
    lens = np.asarray([1, 16, 17, 47, 0], np.int32)
    bt = np.full((b, m), -1, np.int32)
    blocks = iter(rng.permutation(n))
    for r, ln in enumerate(lens):
        for j in range(-(-int(ln) // bs)):
            bt[r, j] = next(blocks)
    qd = torch.float32 if pool == torch.float32 else torch.bfloat16
    q = torch.as_tensor(rng.standard_normal((b, hkv * group, hd)) * 0.5, device=dev).to(qd)
    ks = vs = None
    if pool == torch.int8:
        kp = torch.as_tensor(rng.integers(-127, 128, (n, bs, hkv, hd)), device=dev).to(pool)
        vp = torch.as_tensor(rng.integers(-127, 128, (n, bs, hkv, hd)), device=dev).to(pool)
        ks = torch.as_tensor(rng.uniform(0.001, 0.01, (n, bs, hkv)), device=dev).float()
        vs = torch.as_tensor(rng.uniform(0.001, 0.01, (n, bs, hkv)), device=dev).float()
    else:
        kp = torch.as_tensor(rng.standard_normal((n, bs, hkv, hd)), device=dev).to(pool)
        vp = torch.as_tensor(rng.standard_normal((n, bs, hkv, hd)), device=dev).to(pool)
    btt, ln = torch.as_tensor(bt, device=dev), torch.as_tensor(lens, device=dev)
    before = pa_ops.launches
    got = pa_ops.paged_attention(q, kp, vp, btt, ln, ks, vs)
    torch.cuda.synchronize()
    assert pa_ops.launches == before + 1
    want = pa_ref.paged_attention_ref(q, kp, vp, btt, ln, ks, vs)
    live = ln > 0
    tol = 1e-5 if pool == torch.float32 else 2e-2
    assert _err(got[live], want[live]) < tol
    assert (got[~live] == 0).all()  # a length-0 row reads nothing, writes 0


# Per-element paged tolerance (chip_smoke.py's PAGED_ELEM_TOL): |kernel -
# plain| <= tol * (|plain| + rms of that (row, head)'s output over hd), on
# live rows.  bf16: the plain version rounds probabilities (and int8's
# dequantized K/V) to bf16, the kernel keeps them in fp32, and the output
# rounds once; fp32: sum order only.
PAGED_ELEM_TOL = {torch.bfloat16: 2 ** -5, torch.float32: 1e-4}


def _paged_split_case(case):
    """(b, hkv, hd, lens, cols) of a split-edge case: rows ending at k*pps*bs
    and one token either side (pps from plan_splits for the table), a table
    4x wider than any row, one row of 8192 tokens, hd 64 and 256; every case
    has a length-0 row."""
    bs = 16
    hd = {"hd64": 64, "hd256": 256}.get(case, 128)
    if case == "long":
        return 2, 2, hd, [8192, 0], 512
    if case == "wide":
        return 4, 2, hd, [5, 40, 100, 0], 4 * -(-100 // bs)
    b, hkv, cols = 9, 2, 48
    _, pps = pa_ops.plan_splits(b, hkv, cols)
    k = pps * bs
    return b, hkv, hd, [k - 1, k, k + 1, 2 * k - 1, 2 * k, 2 * k + 1, cols * bs, 1, 0], cols


@pytest.mark.parametrize("case", ["edges", "wide", "long", "hd64", "hd256"])
@pytest.mark.parametrize("group", [1, 4, 16])
@pytest.mark.parametrize("pool", [torch.float32, torch.bfloat16, torch.int8])
def test_paged_split_edges(dev, pool, group, case):
    """The split kernel and its combine at ragged split edges, -1 table
    tails, a long row and hd 64/128/256, against PAGED_TOL-style global and
    PAGED_ELEM_TOL per-element checks; a length-0 row writes zeros."""
    b, hkv, hd, lens, cols = _paged_split_case(case)
    bs = 16
    rng = np.random.default_rng(len(lens) * 100 + group + hd)
    lens = np.asarray(lens, np.int32)
    pages = [-(-int(n) // bs) for n in lens]
    n = sum(pages) + 4
    bt = np.full((b, cols), -1, np.int32)
    blocks = iter(rng.permutation(n))
    for r, p in enumerate(pages):
        for j in range(p):
            bt[r, j] = next(blocks)
    qd = torch.float32 if pool == torch.float32 else torch.bfloat16
    q = torch.as_tensor(rng.standard_normal((b, hkv * group, hd)) * 0.5, device=dev).to(qd)
    ks = vs = None
    if pool == torch.int8:
        kp = torch.as_tensor(rng.integers(-127, 128, (n, bs, hkv, hd)), device=dev).to(pool)
        vp = torch.as_tensor(rng.integers(-127, 128, (n, bs, hkv, hd)), device=dev).to(pool)
        ks = torch.as_tensor(rng.uniform(0.001, 0.01, (n, bs, hkv)), device=dev).float()
        vs = torch.as_tensor(rng.uniform(0.001, 0.01, (n, bs, hkv)), device=dev).float()
    else:
        kp = torch.as_tensor(rng.standard_normal((n, bs, hkv, hd)), device=dev).to(pool)
        vp = torch.as_tensor(rng.standard_normal((n, bs, hkv, hd)), device=dev).to(pool)
    btt, ln = torch.as_tensor(bt, device=dev), torch.as_tensor(lens, device=dev)
    n_splits, _ = pa_ops.plan_splits(b, hkv, cols)
    before = (pa_ops.launches, pa_ops.combine_launches)
    got = pa_ops.paged_attention(q, kp, vp, btt, ln, ks, vs)
    torch.cuda.synchronize()
    assert (pa_ops.launches, pa_ops.combine_launches) == (before[0] + 1,
                                                          before[1] + (n_splits > 1))
    want = pa_ref.paged_attention_ref(q, kp, vp, btt, ln, ks, vs)
    live = ln > 0
    assert bool(torch.isfinite(got).all())
    assert _err(got[live], want[live]) < (1e-5 if pool == torch.float32 else 2e-2)
    assert _elem_err(got[live], want[live]) <= PAGED_ELEM_TOL[qd]
    assert (got[~live] == 0).all()  # a length-0 row reads nothing, writes 0


@pytest.mark.parametrize("qd", [torch.float32, torch.bfloat16])
def test_paged_combine_alone_matches_plain(dev, qd):
    """The combine kernel on the split kernel's partials against its plain
    version on the same partials (the splits past a row's length are never
    written, and neither version reads them)."""
    b, hkv, hd, lens, cols = _paged_split_case("edges")
    n_splits, pps = pa_ops.plan_splits(b, hkv, cols)
    assert n_splits > 1
    rng = np.random.default_rng(7)
    n = sum(-(-x // 16) for x in lens) + 4
    bt = np.full((b, cols), -1, np.int32)
    blocks = iter(rng.permutation(n))
    for r, x in enumerate(lens):
        for j in range(-(-x // 16)):
            bt[r, j] = next(blocks)
    q = torch.as_tensor(rng.standard_normal((b, hkv * 4, hd)), device=dev).to(qd)
    kp, vp = (torch.as_tensor(rng.standard_normal((n, 16, hkv, hd)), device=dev).to(qd)
              for _ in range(2))
    btt = torch.as_tensor(bt, device=dev)
    ln = torch.as_tensor(np.asarray(lens, np.int32), device=dev)
    acc, ml = pa_ops.split_partials(q, kp, vp, btt, ln, None, None, None, n_splits, pps)
    before = pa_ops.combine_launches
    got = pa_ops.combine(acc, ml, ln, 16, cols, pps, qd)
    torch.cuda.synchronize()
    assert pa_ops.combine_launches == before + 1
    want = pa_ref.combine_partials_ref(acc, ml, ln, 16, cols, pps, qd)
    live = ln > 0
    assert _err(got[live], want[live]) < (1e-6 if qd == torch.float32 else 1e-2)
    assert (got[~live] == 0).all()
    full = pa_ops.paged_attention(q, kp, vp, btt, ln)
    assert torch.equal(full, got)  # the same kernels, in one call


# Gram tolerances (chip_smoke.py's GRAM_TOL and GRAM_ELEM_TOL): fp32 sums
# of the same exact products (bf16 x bf16 is exact in fp32) in another
# order, 1e-5 of the largest entry; and per entry 1e-4 (gamma_2048 in fp32)
# of sqrt(G_ii G_jj), which bounds the entry's sum of |products|.
GRAM_TOL = 1e-5
GRAM_ELEM_TOL = 1e-4
# fp32 rows (chip_smoke.py's GRAM_GATE): per element against an fp64 Gram,
# at most 4x the plain fp32 matmul's error (tf32x3 measured at 0.19-1.8x,
# a single-pass TF32 Gram at 10-180x).
GRAM_GATE = 4.0


def _gram_checks(x, got_g, got_a):
    want_g, want_a = gram_ref.gram_accumulate_ref(x)
    assert bool(torch.isfinite(got_g).all())
    assert _err(got_g, want_g) < GRAM_TOL
    assert _err(got_a, want_a) < GRAM_TOL
    assert gram_ref.gram_elem_err(got_g, want_g) <= GRAM_ELEM_TOL
    assert torch.equal(got_g, got_g.T)


def _gram_counts():
    return (gram_ops.launches, gram_ops.mma_launches, gram_ops.fma_launches,
            gram_ops.tf32x3_launches)


def _gram_ran(before, kernel):
    """The counts after one launch of ``kernel`` since ``before``."""
    return (before[0] + 1, before[1] + (kernel == "mma"), before[2] + (kernel == "fma"),
            before[3] + (kernel == "tf32x3"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,n", [(64, 128), (77, 200), (2048, 4096), (5, 1)])
def test_gram_kernel_matches_plain(dev, rows, n, dtype):
    """Ragged rows and n included, against GRAM_TOL and GRAM_ELEM_TOL, on
    the kernel ``route`` picks: fp32 at n % 4 == 0 on the tf32x3 kernel,
    bf16 at n % 8 == 0 on the mma kernel, n 1 on the FMA kernel."""
    g = torch.Generator(device=dev).manual_seed(rows + n)
    x = torch.randn((rows, n), generator=g, device=dev).to(dtype)
    x[:, n // 2] *= 30.0  # an outlier channel
    want = "fma" if n % 4 else "tf32x3" if dtype == torch.float32 else "mma"
    before = _gram_counts()
    got_g, got_a = gram_ops.gram_accumulate(x.reshape(1, rows, n))
    torch.cuda.synchronize()
    assert _gram_counts() == _gram_ran(before, want)
    _gram_checks(x, got_g, got_a)


@pytest.mark.parametrize("rows,n,offset", [
    *[(r, n, 0) for r in (1, 31, 33, 2048, 4100) for n in (8, 128, 136, 2048, 4104)],
    (2048, 7168, 0), (64, 136, 3)])
def test_gram_mma_kernel_edges(dev, rows, n, offset):
    """bf16 rows on the mma kernel: a single row, rows either side of a
    32-row stage, ragged column tiles (136, 4104), RWKV's d_ff width; and a
    tap viewed at an odd element offset, which goes to the FMA kernel."""
    g = torch.Generator(device=dev).manual_seed(rows * 7 + n)
    x = torch.randn((rows, n), generator=g, device=dev)
    x[:, ::97] *= 20.0  # outlier channels
    x = _at_offset(x.to(torch.bfloat16), offset) if offset else x.to(torch.bfloat16)
    want = "fma" if offset else "mma"
    assert gram_ops.route(x.dtype, n, x.data_ptr()) == want
    before = _gram_counts()
    got_g, got_a = gram_ops.gram_accumulate(x)
    torch.cuda.synchronize()
    assert _gram_counts() == _gram_ran(before, want)
    _gram_checks(x, got_g, got_a)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("experts,rows,n", [(1, 33, 136), (8, 12, 32), (64, 240, 2048),
                                            (64, 240, 1408), (5, 1, 8)])
def test_gram_batched_matches_plain(dev, experts, rows, n, dtype):
    """Per-expert Grams of a zero-padded capacity buffer in one launch (mma
    for bf16, tf32x3 for fp32), each expert per element and exactly
    symmetric; empty rows and an empty expert included."""
    g = torch.Generator(device=dev).manual_seed(experts * rows + n)
    buf = torch.randn((experts, rows, n), generator=g, device=dev)
    buf[:, :, ::97] *= 20.0  # outlier channels
    buf[:, rows - rows // 3:] = 0.0
    buf[experts // 2] = 0.0
    buf = buf.to(dtype)
    before = (*_gram_counts(), gram_ops.batched_launches)
    got_g, got_a = gram_ops.gram_accumulate_batched(buf)
    torch.cuda.synchronize()
    want = "mma" if dtype == torch.bfloat16 else "tf32x3"
    assert (*_gram_counts(), gram_ops.batched_launches) == (
        *_gram_ran(before[:4], want), before[4] + 1)
    assert got_g.shape == (experts, n, n) and got_a.shape == (experts, n)
    for e in range(experts):
        if e == experts // 2:
            assert not got_g[e].any() and not got_a[e].any()
        else:
            _gram_checks(buf[e], got_g[e], got_a[e])


# (rows, n) or (E, rows, n) fp32: llava's projector.in, whisper's encoder
# width, a ragged tap, a batched one (both at one split), and a batched one
# over several splits.
GATE_CASES = [(9216, 1024), (24000, 768), (33, 136), (8, 12, 32), (4, 2048, 256)]


@pytest.mark.parametrize("shape", GATE_CASES)
def test_gram_tf32x3_fp64_gate(dev, shape):
    """fp32 rows on the tf32x3 kernel: per element within GRAM_GATE of the
    plain fp32 matmul's error against an fp64 Gram (a single-pass TF32 Gram
    would pass GRAM_ELEM_TOL, not this), the usual checks against plain,
    exactly symmetric, and two runs bit-identical."""
    g = torch.Generator(device=dev).manual_seed(sum(shape))
    x = torch.randn(shape, generator=g, device=dev)
    x[..., ::97] *= 20.0  # outlier channels, as in the gram phase
    fn, ref_fn = ((gram_ops.gram_accumulate_batched, gram_ref.gram_accumulate_batched_ref)
                  if x.ndim == 3 else (gram_ops.gram_accumulate, gram_ref.gram_accumulate_ref))
    before = _gram_counts()
    got_g, got_a = fn(x)
    torch.cuda.synchronize()
    assert _gram_counts() == _gram_ran(before, "tf32x3")
    want_g, _ = ref_fn(x)
    x64 = x.double()
    g64 = x64.transpose(-1, -2) @ x64
    assert gram_ref.gram_elem_err(got_g, g64) <= GRAM_GATE * gram_ref.gram_elem_err(want_g, g64)
    again_g, again_a = fn(x)
    assert torch.equal(again_g, got_g) and torch.equal(again_a, got_a)
    if x.ndim == 2:
        _gram_checks(x, got_g, got_a)
    else:
        for e in range(x.shape[0]):
            _gram_checks(x[e], got_g[e], got_a[e])


def test_gram_tf32x3_refusals_and_fma_taps(dev):
    """The tf32x3 launcher refuses bf16 rows, a width not a multiple of 4
    and a start not 16-byte aligned; fp32 rows at such a width or start go
    to the FMA kernel (ragged rows too), never quietly to another kernel."""
    x = torch.zeros((4, 24), device=dev)
    for bad in (x.to(torch.bfloat16), x[:, :10].contiguous(), x[:, :14].contiguous(),
                x.reshape(-1)[3:3 + 64].view(4, 16)):
        with pytest.raises(RuntimeError):
            gram_ops.launch(bad, "tf32x3")
    g = torch.Generator(device=dev).manual_seed(77)
    for t in (torch.randn((77, 202), generator=g, device=dev),
              _at_offset(torch.randn((77, 200), generator=g, device=dev), 3)):
        assert gram_ops.route(t.dtype, t.shape[-1], t.data_ptr()) == "fma"
        before = _gram_counts()
        got_g, got_a = gram_ops.gram_accumulate(t)
        torch.cuda.synchronize()
        assert _gram_counts() == _gram_ran(before, "fma")
        _gram_checks(t, got_g, got_a)


def test_gram_launch_refuses_what_mma_cannot_do(dev):
    """The mma kernel takes bf16 only, n % 8 == 0, 16-byte-aligned rows."""
    x = torch.zeros((4, 24), dtype=torch.bfloat16, device=dev)
    with pytest.raises(RuntimeError):
        gram_ops.launch(x.float(), "mma")
    with pytest.raises(RuntimeError):
        gram_ops.launch(x[:, :12].contiguous(), "mma")
    with pytest.raises(RuntimeError):
        gram_ops.launch(x.reshape(-1)[3:3 + 64].view(4, 16), "mma")


def _elem_err(got, want):
    """Max over elements of |got - want| / (|want| + rms of want's row): a
    fault in a late tile or a few keys of a long row cannot hide under the
    large outputs of the first rows, as it can under max |want|."""
    w = want.float()
    rms = w.pow(2).mean(-1, keepdim=True).sqrt()
    return float(((got.float() - w).abs() / (w.abs() + rms).clamp_min(1e-30)).max())


# Per-element flash tolerance (chip_smoke.py's FLASH_ELEM_TOL).  bf16: the
# output rounds to bf16 (one ulp, 2^-7 of |out|) after P's rounding at
# another point has moved the fp32 value by a few 2^-9 of the row's rms;
# four ulps allowed (measured up to 1.33e-2 on the H100).  fp32: sum order.
FLASH_ELEM_TOL = {torch.bfloat16: 2 ** -5, torch.float32: 1e-4}
BF16_ROWS = fa_ops.plan(torch.bfloat16, 128, 1).rows  # the largest bf16 G


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,hkv,group,hd", [
    (2, 128, 2, 4, 128), (1, 1000, 1, 4, 64), (3, 37, 2, 1, 32),
    (2, 70, 2, 2, 256), (1, 5, 3, 3, 40)])
def test_flash_kernel_matches_plain(dev, b, s, hkv, group, hd, dtype):
    """Ragged S, G in {1, 2, 3, 4}, hd up to 256.  Tolerance: fp32 sum order
    (1e-5); bf16 P rounded before P V at other points than the plain
    version's normalized probabilities (2e-2)."""
    g = torch.Generator(device=dev).manual_seed(s)
    mk = lambda h: torch.randn((b, s, h, hd), generator=g, device=dev).to(dtype)  # noqa: E731
    q, k, v = mk(hkv * group), mk(hkv), mk(hkv)
    before = fa_ops.launches
    got = fa_ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa_ops.launches == before + 1
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    want = fa_ref.flash_attention_ref(q, k, v)
    assert _err(got, want) < tol
    assert _elem_err(got, want) <= FLASH_ELEM_TOL[dtype]


# bf16 S at the kernel's tile edges (64 keys a KV tile, 128 rows a block),
# G = 8 and the largest G the bf16 kernel takes (its 128 rows: one position
# a block), hd 256 (its own instantiation: 32-key tiles) at a ragged S.
# Tolerances as above: P rounded to bf16 unnormalized (kernel) vs normalized
# (plain), and the output rounded to bf16 (2e-2 of max |out|, and
# FLASH_ELEM_TOL for every element).
@pytest.mark.parametrize("b,s,hkv,group,hd", [
    (2, 63, 2, 4, 128), (2, 64, 2, 4, 128), (2, 65, 2, 4, 128), (1, 129, 2, 8, 128),
    (1, 2048, 2, 8, 128), (2, 130, 1, 8, 64), (1, 65, 1, BF16_ROWS, 128),
    (1, 33, 1, BF16_ROWS, 64), (2, 97, 2, 4, 256), (1, 200, 1, 8, 256)])
def test_flash_tensor_core_kernel_edges(dev, b, s, hkv, group, hd):
    g = torch.Generator(device=dev).manual_seed(s + group)
    mk = lambda h: torch.randn((b, s, h, hd), generator=g, device=dev).to(torch.bfloat16)  # noqa: E731
    q, k, v = mk(hkv * group), mk(hkv), mk(hkv)
    before = fa_ops.tensor_core_launches
    got = fa_ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa_ops.tensor_core_launches == before + 1
    assert torch.isfinite(got).all()
    want = fa_ref.flash_attention_ref(q, k, v)
    assert _err(got, want) < 2e-2
    assert _elem_err(got, want) <= FLASH_ELEM_TOL[torch.bfloat16]


@pytest.mark.parametrize("s", [64, 300])
def test_flash_tensor_core_kernel_large_scores(dev, s):
    """q and k scaled by 4: scores q.k / sqrt(hd) of std 16, |s| up to ~60,
    so the running max jumps between tiles and the rescale exp(m - m_new)
    is far from 1.  Tolerances as above."""
    b, hkv, group, hd = 2, 2, 4, 128
    g = torch.Generator(device=dev).manual_seed(s)
    mk = lambda h, a: (a * torch.randn((b, s, h, hd), generator=g, device=dev)).to(torch.bfloat16)  # noqa: E731
    q, k, v = mk(hkv * group, 4.0), mk(hkv, 4.0), mk(hkv, 1.0)
    want = fa_ref.flash_attention_ref(q, k, v)
    scores = torch.einsum("bsgd,btgd->bgst", q[:, :, ::group].float(), k.float()) / hd ** 0.5
    assert scores.abs().max() > 40  # the case this test is for
    got = fa_ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert _err(got, want) < 2e-2
    assert _elem_err(got, want) <= FLASH_ELEM_TOL[torch.bfloat16]


def test_flash_dtype_picks_kernel(dev):
    """bf16 runs the tensor-core kernel and fp32 the CUDA-core one; the
    total count is their sum."""
    q = torch.randn((1, 40, 4, 64), device=dev)
    k = torch.randn((1, 40, 2, 64), device=dev)
    counts = lambda: (fa_ops.launches, fa_ops.tensor_core_launches, fa_ops.cuda_core_launches)  # noqa: E731
    n0, t0, c0 = counts()
    fa_ops.flash_attention(q, k, k)
    assert counts() == (n0 + 1, t0, c0 + 1)
    qb, kb = q.to(torch.bfloat16), k.to(torch.bfloat16)
    fa_ops.flash_attention(qb, kb, kb)
    assert counts() == (n0 + 2, t0 + 1, c0 + 1)
    torch.cuda.synchronize()


def test_flash_kernel_rejects_bad_head_dim(dev):
    q = torch.zeros((1, 4, 2, 12), device=dev)
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, q[:, :, :1].contiguous(), q[:, :, :1].contiguous())


# Per-element tolerance of the backward kernels against the plain backward
# (chip_smoke.py's FLASH_BWD_ELEM_TOL), on ``_bwd_elem_err``.  Both compute
# the same fp32 FA2 formulas from the same inputs in another order.  bf16:
# dq, dk, dv round to bf16 at the end (a rounding flip is one ulp, under
# 2^-7 of |want|), four ulps allowed; fp32: sum order over up to S keys or
# S x G query rows.
FLASH_BWD_ELEM_TOL = {torch.bfloat16: 2 ** -5, torch.float32: 1e-4}


def _bwd_elem_err(got, want) -> float:
    """Max over elements of |got - want| / (|want| + rms of want's row +
    rms of want).  The whole tensor's rms is the floor because a gradient
    row can vanish by cancellation: position 0's dq is dS K with dS = P (dP
    - D) = dO.v0 - dO.o0 = 0 exactly, so both versions hold rounding noise
    there, unrelated to each other, however right the kernel."""
    w = want.float()
    rms = w.pow(2).mean(-1, keepdim=True).sqrt()
    floor = w.pow(2).mean().sqrt()
    return float(((got.float() - w).abs() / (w.abs() + rms + floor).clamp_min(1e-30)).max())


def _bwd_inputs(dev, b, s, hkv, group, hd, dtype, seed):
    """q, k, v, the plain forward's (out, lse) and dout, all on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda h: torch.randn((b, s, h, hd), generator=g, device=dev).to(dtype)  # noqa: E731
    q, k, v = mk(hkv * group), mk(hkv), mk(hkv)
    out, lse = fa_ref.flash_attention_fwd_ref(q, k, v)
    return q, k, v, out, lse, mk(hkv * group)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,hkv,group,hd", [
    (2, 128, 2, 1, 32), (2, 128, 4, 4, 32), (1, 100, 2, 4, 64), (2, 64, 1, 16, 64),
    (1, 257, 2, 4, 128), (1, 130, 1, 16, 128), (3, 37, 2, 1, 256), (1, 70, 1, 4, 256),
    (1, 5, 3, 3, 40),
    # The tensor-core kernels' edges (64-row tiles, 32-row chunks, hd
    # padded to 64 or 128, rows packed position x G): S below one tile and
    # at 64k - 1, 64k, 64k + 1; hd 40, 72, 96; G 1, 8, 16 at hd 128; a grid
    # of 128 (batch, KV head) pairs.
    (2, 37, 2, 4, 128), (1, 63, 2, 4, 128), (1, 64, 2, 4, 128), (1, 65, 1, 8, 128),
    (1, 127, 2, 2, 96), (1, 129, 1, 1, 128), (1, 191, 2, 4, 72), (1, 193, 2, 3, 40),
    (2, 300, 4, 1, 128), (1, 300, 2, 8, 128), (1, 300, 1, 16, 128), (8, 70, 16, 2, 64)])
def test_flash_bwd_kernel_matches_plain(dev, b, s, hkv, group, hd, dtype):
    """dq, dk, dv of the three backward kernels against the plain FA2
    backward on the same inputs: hd 32-256, G 1-16, ragged S."""
    args = _bwd_inputs(dev, b, s, hkv, group, hd, dtype, s + group)
    before = fa_ops.backward_launches
    got = fa_ops.backward(*args)
    torch.cuda.synchronize()
    assert fa_ops.backward_launches == before + 1
    want = fa_ref.flash_attention_bwd_ref(*args)
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        assert x.dtype == dtype and x.shape == w.shape, name
        assert torch.isfinite(x).all(), name
        assert _bwd_elem_err(x, w) <= FLASH_BWD_ELEM_TOL[dtype], name


@pytest.mark.parametrize("dtype,hd", [(torch.float32, 128), (torch.bfloat16, 128),
                                      (torch.bfloat16, 64), (torch.bfloat16, 256)])
def test_flash_bwd_single_position(dev, dtype, hd):
    """S = 1: dv against the plain backward; dq and dk are zero in exact
    arithmetic (dS = dO.v0 - dO.o0 with o0 = v0), so both versions hold
    only the fp32 rounding of two dot products of hd unit-scale terms (about
    1e-6): held to 1e-4 absolute, not to a relative error of noise."""
    args = _bwd_inputs(dev, 2, 1, 2, 4, hd, dtype, 1)
    dq, dk, dv = fa_ops.backward(*args)
    torch.cuda.synchronize()
    want = fa_ref.flash_attention_bwd_ref(*args)
    assert _bwd_elem_err(dv, want[2]) <= FLASH_BWD_ELEM_TOL[dtype]
    for x in (dq, dk):
        assert torch.isfinite(x).all() and float(x.float().abs().max()) <= 1e-4


@pytest.mark.parametrize("dtype,hd,kind", [
    (torch.bfloat16, 40, "tensor_core"), (torch.bfloat16, 64, "tensor_core"),
    (torch.bfloat16, 128, "tensor_core"), (torch.bfloat16, 256, "cuda_core"),
    (torch.float32, 64, "cuda_core"), (torch.float32, 128, "cuda_core")])
def test_flash_bwd_dtype_picks_kernel(dev, dtype, hd, kind):
    """bf16 at hd <= 128 runs only the tensor-core backward kernels, fp32
    and bf16 above hd 128 only the CUDA-core ones (``bwd_plan``), by the
    wrapper's counters; the total is their sum."""
    args = _bwd_inputs(dev, 1, 80, 2, 4, hd, dtype, 3)
    counts = lambda: {n: getattr(fa_ops, f"backward_{n}launches")  # noqa: E731
                      for n in ("", "tensor_core_", "cuda_core_")}
    before = counts()
    fa_ops.backward(*args)
    torch.cuda.synchronize()
    after = counts()
    assert {n: after[n] - before[n] for n in after} == {
        "": 1, "tensor_core_": int(kind == "tensor_core"), "cuda_core_": int(kind == "cuda_core")}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_forward_lse_leaves_out_bit_identical(dev, dtype):
    """The forward with the log-sum-exp written out gives the same bits in
    ``out`` as without it; its lse against the plain forward's (fp32 sum
    order over S keys: 1e-5 of |lse| plus 1e-5)."""
    b, s, hkv, group, hd = 2, 300, 2, 4, 128
    q, k, v, _, want_lse, _ = _bwd_inputs(dev, b, s, hkv, group, hd, dtype, 7)
    plain_out = fa_ops.flash_attention(q, k, v)
    lse = torch.empty((b, hkv * group, s), dtype=torch.float32, device=dev)
    out = fa_ops._forward(q, k, v, lse)
    torch.cuda.synchronize()
    assert torch.equal(out, plain_out)
    assert torch.allclose(lse, want_lse, rtol=1e-5, atol=1e-5)


def test_flash_bwd_runs_are_bit_identical(dev):
    """No atomics: two backward runs give the same bits."""
    args = _bwd_inputs(dev, 2, 500, 2, 4, 128, torch.bfloat16, 11)
    one, two = fa_ops.backward(*args), fa_ops.backward(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(one, two))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_autograd_on_card_matches_plain(dev, dtype):
    """``flash_attention`` on tensors that require grad: one forward launch
    with lse and one backward call; its output and grads against the same
    autograd Function under ``kernels.plain()``."""
    b, s, hkv, group, hd = 2, 90, 2, 4, 64
    g = torch.Generator(device=dev).manual_seed(5)
    base = [torch.randn((b, s, h, hd), generator=g, device=dev).to(dtype)
            for h in (hkv * group, hkv, hkv)]
    dout = torch.randn((b, s, hkv * group, hd), generator=g, device=dev).to(dtype)

    def run():
        ins = [t.clone().requires_grad_() for t in base]
        out = fa_ops.flash_attention(*ins)
        return (out, *torch.autograd.grad(out, ins, dout))
    n0, b0 = fa_ops.launches, fa_ops.backward_launches
    got = run()
    torch.cuda.synchronize()
    assert (fa_ops.launches, fa_ops.backward_launches) == (n0 + 1, b0 + 1)
    with kernels.plain():
        want = run()
    assert (fa_ops.launches, fa_ops.backward_launches) == (n0 + 1, b0 + 1)
    assert _elem_err(got[0].detach(), want[0].detach()) <= FLASH_ELEM_TOL[dtype]
    # Twice the backward's tolerance: here the two backward passes also
    # start from two forwards' out and lse, which differ within the
    # forward's own tolerance (bf16: P rounded at other points).
    for x, w in zip(got[1:], want[1:]):
        assert _bwd_elem_err(x, w) <= 2 * FLASH_BWD_ELEM_TOL[dtype]


def test_forward_only_kernels_refuse_grad(dev):
    """nested_lowrank (single and batched), paged_attention and gram (single
    and batched) raise, naming the kernel, when asked for a gradient on the
    card; under no_grad the same call runs.  (rwkv6 has a backward kernel:
    ``test_rwkv6_autograd_on_card_matches_plain``.)"""
    x = torch.randn((8, 64), device=dev, dtype=torch.bfloat16, requires_grad=True)
    u, v = torch.randn((64, 8), device=dev), torch.randn((8, 32), device=dev)
    fac = [t.to(torch.bfloat16) for t in (u, v, u, v)]
    q = torch.randn((2, 4, 32), device=dev, requires_grad=True)
    pages = torch.randn((4, 16, 2, 32), device=dev)
    tables = torch.zeros((2, 2), dtype=torch.int32, device=dev)
    lens = torch.full((2,), 5, dtype=torch.int32, device=dev)
    calls = {
        "nested_lowrank": lambda: nlr_ops.nested_lowrank_matmul(x, *fac),
        "nested_lowrank (batched)": lambda: nlr_ops.nested_lowrank_matmul_batched(
            x[None], *(f[None] for f in fac)),
        "paged_attention": lambda: pa_ops.paged_attention(q, pages, pages, tables, lens),
        "gram": lambda: gram_ops.gram_accumulate(x),
        "gram (batched)": lambda: gram_ops.gram_accumulate_batched(x[None]),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=rf"^{name.replace('(', '.').replace(')', '.')}:"):
            call()
        with torch.no_grad():
            call()
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_calibration_runs_through_gram_and_flash(dev, dtype):
    """collect_grams on a CUDA model launches gram once per tap and batch
    (every launch on the mma kernel for bf16 taps, on the tf32x3 kernel for
    fp32) and flash_attention once per layer and batch.  fp32: its Grams
    match the same calibration through the plain versions.  bf16 (where the
    plain attention rounds the taps differently): each tap's Gram of one
    more batch matches the plain Gram of the same tap."""
    cfg = dataclasses.replace(small_lm("card-calib", MISTRAL_7B, num_layers=2, d_model=64,
                                       d_ff=96, vocab_size=128, num_heads=8), dtype=dtype)
    model = build_model(cfg)
    params = model.init(0, dev)
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 128, (4, 40)).astype(np.int32) for _ in range(3)]
    g0, f0 = _gram_counts(), fa_ops.launches
    store = collect_grams(model, params, batches)
    taps_per_batch = 4 * cfg.num_layers + 1
    g1 = _gram_counts()
    assert g1[0] - g0[0] == 3 * taps_per_batch
    mma = dtype == "bfloat16"
    calls = g1[0] - g0[0]
    assert (g1[1] - g0[1], g1[2] - g0[2], g1[3] - g0[3]) == (
        (calls, 0, 0) if mma else (0, 0, calls))
    assert fa_ops.launches - f0 == 3 * cfg.num_layers
    if not mma:
        with kernels.plain():
            plain = collect_grams(model, params, batches)
        assert set(store.keys()) == set(plain.keys())
        for key in store.keys():
            assert _err(store.gram(key), plain.gram(key)) < 1e-5
        return
    taps = {}
    with torch.no_grad():
        model.apply(params, torch.as_tensor(batches[0], device=dev), mode="train", taps=taps)
    assert len(taps) == taps_per_batch
    for x in taps.values():
        assert x.dtype == torch.bfloat16
        _gram_checks(x.reshape(-1, x.shape[-1]), *gram_ops.gram_accumulate(x))


def test_served_greedy_stream_kernels_vs_plain(dev):
    """A compressed-layout model served with the kernels emits the same
    greedy streams as with the plain versions (fp32, logits spread so the
    choices are not near-ties)."""
    cfg = small_lm("card-tiny", MISTRAL_7B, num_layers=2, d_model=64, d_ff=96,
                   vocab_size=128, num_heads=8)
    model = build_model(cfg)
    params = model.init(0, dev)
    params["unembed"]["kernel"] *= 8.0
    g = torch.Generator(device=dev).manual_seed(1)
    for layer in ("wq", "wk", "wv", "wo"):  # factor the attention in place
        leaf = params["g0"]["sub0"]["attn"][layer]
        k_in, k_out = leaf["kernel"].shape[-2:]
        params["g0"]["sub0"]["attn"][layer] = {
            "u": torch.randn((2, k_in, 12), generator=g, device=dev) * k_in ** -0.5,
            "v": torch.randn((2, 12, k_out), generator=g, device=dev) * 12 ** -0.5,
            "u2": torch.randn((2, k_in, 4), generator=g, device=dev) * k_in ** -0.5,
            "v2": torch.randn((2, 4, k_out), generator=g, device=dev) * 4 ** -0.5}
    prompts = [np.arange(3, 3 + n) % 128 for n in (5, 19, 40)]

    def run():
        eng = ServingEngine(model, params, max_batch=2, max_len=64, prefill_chunk=16)
        ids = [eng.submit(p, max_new_tokens=12) for p in prompts]
        out = eng.run()
        return [out[i] for i in ids]

    launches = pa_ops.launches
    with_kernels = run()
    assert pa_ops.launches > launches
    with kernels.plain():
        plain = run()
    assert with_kernels == plain


def test_decode_step_dispatch_is_sync_free(dev):
    """Dispatching a decode step (model, kernels, sampling, device-side
    exits) makes no host sync: the engine's one sync per step is its copy
    of the token vector."""
    cfg = small_lm("card-sync", MISTRAL_7B, num_layers=2, d_model=64, d_ff=96,
                   vocab_size=128, num_heads=8)
    model = build_model(cfg)
    eng = ServingEngine(model, model.init(0, dev), max_batch=4, max_len=64,
                        prefill_chunk=16)
    for n in (5, 9, 30):
        eng.submit(np.arange(2, 2 + n), max_new_tokens=8)
    while eng._prefilling or eng.queue:
        eng._admit()
    args = (eng.params, eng.kv.pools, eng.kv.table_device(), eng.last_token,
            eng.cache_len, eng.budget_dev, eng.key_data, eng.active_dev,
            *eng._host_inputs())
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng._decode(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def _rwkv_inputs(dev, bh, t, k, dtype, seed, w_value=None):
    g = torch.Generator(device=dev).manual_seed(seed)
    r, kk, v = (torch.randn((bh, t, k), generator=g, device=dev) * 0.5 for _ in range(3))
    w = (torch.full((bh, t, k), w_value, device=dev) if w_value is not None
         else torch.rand((bh, t, k), generator=g, device=dev) * 0.989 + 0.01)
    u = torch.randn((bh, k), generator=g, device=dev) * 0.5
    return [x.to(dtype) for x in (r, kk, v, w)] + [u]


# fp32: the same recurrence as the sequential scan, y summed over K in
# another order: 1e-4 of the largest value.  bf16: inputs widen exactly and
# both sides compute in fp32, then round y to bf16 on their own (one bf16
# ulp, 2^-8 relative); the fp32 state keeps the fp32 tolerance.
RWKV_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# Per element (chip_smoke.py's RWKV_ELEM_TOL, RWKV_STATE_ELEM_TOL): |kernel
# - plain| <= tol * (|plain| + rms of the row), for y over its K columns and
# for the fp32 state over its V columns.  y, fp32: rows whose sums cancel
# (y_0 scales with one dot product r.(u*k)) carry both sides' fp32 rounding
# (measured up to 4.0e-4); bf16: each side rounds y to bf16 on its own (at
# most one ulp, 2^-7 of |plain|, apart), two allowed.  State: each step
# rounded as the plain scan rounds it.
RWKV_ELEM_TOL = {torch.float32: 2e-3, torch.bfloat16: 2 ** -6}
RWKV_STATE_ELEM_TOL = 1e-4


def _rwkv_checks(y, s, wy, ws, dtype):
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    assert _err(y, wy) < RWKV_TOL[dtype]
    assert _err(s, ws) < 1e-4
    assert _elem_err(y, wy) <= RWKV_ELEM_TOL[dtype]
    assert _elem_err(s, ws) <= RWKV_STATE_ELEM_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,t,k", [(2, 40, 16), (1, 5, 8), (3, 37, 32), (32, 200, 64),
                                    (4, 16, 64), (2, 1, 64), (3, 15, 8), (3, 17, 8),
                                    (3, 31, 16), (3, 33, 16), (3, 15, 64), (3, 17, 64),
                                    (3, 33, 64), (3, 100, 64)])
def test_rwkv6_kernel_matches_plain(dev, bh, t, k, dtype):
    """Ragged T (below one 16-token chunk and just past chunk boundaries),
    every instantiated K (clusters of one block at K 8 and 16, of two and
    four at 32 and 64), y and the final state, globally and per element."""
    args = _rwkv_inputs(dev, bh, t, k, dtype, seed=t * k)
    before = rwkv_ops.launches
    y, s = rwkv_ops.rwkv6_attention(*args, return_state=True)
    torch.cuda.synchronize()
    assert rwkv_ops.launches == before + 1
    assert y.dtype == dtype and s.dtype == torch.float32
    wy, ws = rwkv_ref.rwkv6_scan_ref(*args, return_state=True)
    _rwkv_checks(y, s, wy, ws, dtype)


def test_rwkv6_kernel_extreme_decay(dev):
    """w = 1e-6: the per-chunk rebase keeps every exponent <= 0."""
    args = _rwkv_inputs(dev, 4, 64, 64, torch.float32, seed=9, w_value=1e-6)
    y, s = rwkv_ops.rwkv6_attention(*args, return_state=True)
    torch.cuda.synchronize()
    wy, ws = rwkv_ref.rwkv6_scan_ref(*args, return_state=True)
    _rwkv_checks(y, s, wy, ws, torch.float32)


def _offset_views(args, offset):
    """Copies of r, k, v, w that start ``offset`` elements into a buffer."""
    views = []
    for x in args[:4]:
        buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
        view = buf[offset:].view(x.shape)
        view.copy_(x)
        views.append(view)
    return views


@pytest.mark.parametrize("k", [16, 32, 64])
@pytest.mark.parametrize("dtype,offset", [(torch.float32, 1), (torch.float32, 2),
                                          (torch.bfloat16, 2), (torch.bfloat16, 6)])
def test_rwkv6_kernel_four_byte_copies(dev, dtype, offset, k):
    """Bases 4-12 bytes off 16-byte alignment take the 4-byte copy path of
    the same kernel (one launch, counted as such), with the same results."""
    args = _rwkv_inputs(dev, 3, 45, k, dtype, seed=offset + k)
    views = _offset_views(args, offset)
    v4, n = rwkv_ops.vec4_launches, rwkv_ops.launches
    y, s = rwkv_ops.rwkv6_attention(*views, args[4], return_state=True)
    torch.cuda.synchronize()
    assert (rwkv_ops.vec4_launches - v4, rwkv_ops.launches - n) == (1, 1)
    wy, ws = rwkv_ref.rwkv6_scan_ref(*args, return_state=True)
    _rwkv_checks(y, s, wy, ws, dtype)


def test_rwkv6_kernel_four_byte_copies_odd_t_stride(dev):
    """(B, T, H, K+1) storage sliced to K: the T stride is H (K + 1) floats,
    not a multiple of 16 bytes, so the views are read by 4-byte copies."""
    b, t, h, k = 2, 37, 3, 64
    g = torch.Generator(device=dev).manual_seed(5)
    x = [torch.randn((b, t, h, k + 1), generator=g, device=dev)[..., :k] for _ in range(3)]
    x.append((torch.rand((b, t, h, k + 1), generator=g, device=dev) * 0.9 + 0.05)[..., :k])
    heads = [a.permute(0, 2, 1, 3) for a in x]
    u = torch.randn((b, h, k), generator=g, device=dev)
    v4 = rwkv_ops.vec4_launches
    y, s = rwkv_ops.rwkv6_heads(*heads, u, return_state=True)
    with kernels.plain():
        wy, ws = rwkv_ops.rwkv6_heads(*heads, u, return_state=True)
    torch.cuda.synchronize()
    assert rwkv_ops.vec4_launches == v4 + 1
    _rwkv_checks(y, s, wy, ws, torch.float32)


def test_rwkv6_kernel_copies_odd_bf16_offset(dev):
    """bf16 views at an odd element offset fit neither copy width: the
    wrapper copies them into fresh tensors, then takes 16-byte copies."""
    args = _rwkv_inputs(dev, 2, 40, 64, torch.bfloat16, seed=11)
    views = _offset_views(args, 1)
    v16 = rwkv_ops.vec16_launches
    y, s = rwkv_ops.rwkv6_attention(*views, args[4], return_state=True)
    torch.cuda.synchronize()
    assert rwkv_ops.vec16_launches == v16 + 1
    wy, ws = rwkv_ref.rwkv6_scan_ref(*args, return_state=True)
    _rwkv_checks(y, s, wy, ws, torch.bfloat16)


# The backward against the plain backward (chip_smoke.py's RWKV_BWD_TOL and
# RWKV_BWD_ELEM_TOL, on ``_bwd_elem_err``): the kernels associate S's and
# G's sums by 32-token chunks and run their products in 3xTF32 (fp32's
# level), so each gradient is the plain one up to fp32 rounding of sums in
# other orders, 1e-4 allowed in fp32; bf16 operands widen exactly and each
# side rounds every gradient to bf16 once.
RWKV_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
RWKV_BWD_ELEM_TOL = {torch.float32: 1e-4, torch.bfloat16: 2 ** -6}


def _rwkv_bwd_checks(got, want, dtype):
    for name, g, w in zip(("dr", "dk", "dv", "dw", "du"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert bool(torch.isfinite(g).all()), name
        # Max |got - want| within tol x max |want| (dw is exactly 0 at T 1).
        assert float((g.float() - w.float()).abs().max()) <= RWKV_BWD_TOL[dtype] * float(
            w.float().abs().max()), name
        assert _bwd_elem_err(g, w) <= RWKV_BWD_ELEM_TOL[dtype], name


_RWKV_BWD_CASES = [(2, 40, 16, None), (1, 5, 8, None), (3, 37, 32, None), (4, 16, 64, None),
                   (2, 1, 64, None), (3, 7, 8, None), (3, 9, 8, None), (3, 17, 64, None),
                   (5, 100, 64, None), (2, 31, 64, None), (2, 32, 16, None), (2, 33, 8, None),
                   (2, 65, 32, None)]


@pytest.mark.parametrize("bh,t,k,w_value,dtype", [
    *((*c, d) for c in _RWKV_BWD_CASES for d in (torch.float32, torch.bfloat16)),
    (3, 64, 64, 1e-6, torch.float32), (2, 45, 64, 1e-6, torch.float32),
    (2, 400, 64, 1.0 - 1e-3, torch.float32)])
def test_rwkv6_backward_kernel_matches_plain(dev, bh, t, k, w_value, dtype):
    """Ragged T (a single token, below one 32-token chunk, at and just past
    its edges: C - 1, C, C + 1, 2C + 1), every instantiated K (8 and 16
    padded to the mma tiles), in fp32 and bf16, then extreme decay (one
    chunk and a ragged one past it) and long memory in fp32 (the model's
    dtype for the recurrence): every gradient globally and per element, and
    two runs bit-identical (no atomics)."""
    args = _rwkv_inputs(dev, bh, t, k, dtype, seed=t * k + 1, w_value=w_value)
    g = torch.Generator(device=dev).manual_seed(t)
    dy = torch.randn((bh, t, k), generator=g, device=dev).to(dtype)
    heads = [x[:, None] for x in (*args, dy)]
    n = rwkv_ops.backward_launches
    got = [x[:, 0] for x in rwkv_ops.backward(*heads)]
    again = [x[:, 0] for x in rwkv_ops.backward(*heads)]
    torch.cuda.synchronize()
    assert rwkv_ops.backward_launches == n + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _rwkv_bwd_checks(got, rwkv_ref.rwkv6_scan_bwd_ref(*args, dy), dtype)


@pytest.mark.parametrize("k", [8, 64])
def test_rwkv6_backward_four_byte_copies(dev, k):
    """Inputs whose token stride (K + 1 floats) is not a multiple of 16
    bytes take the kernels' 4-byte copies: the same checks, read in place."""
    bh, t = 3, 70
    args = _rwkv_inputs(dev, bh, t, k, torch.float32, seed=k + 5)
    g = torch.Generator(device=dev).manual_seed(k)
    dy = torch.randn((bh, t, k), generator=g, device=dev)

    def odd(x):
        wide = torch.zeros((bh, t, k + 1), device=dev)
        wide[..., :k] = x
        return wide[..., :k]
    heads = [odd(x)[:, None] for x in (*args[:4], dy)]
    got = [x[:, 0] for x in rwkv_ops.backward(*heads[:4], args[4][:, None], heads[4])]
    torch.cuda.synchronize()
    _rwkv_bwd_checks(got, rwkv_ref.rwkv6_scan_bwd_ref(*args, dy), torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [8, 64])
def test_rwkv6_autograd_on_card_matches_plain(dev, k, dtype):
    """``rwkv6_heads`` on the model's layout ((B, T, H, K) tensors permuted,
    a broadcast bonus) that requires grad: one forward and one backward
    launch; y and the grads of r, k, v, w and the bonus against the same
    autograd Function under ``kernels.plain()``, which launches nothing."""
    b, t, h = 2, 70, 3
    g = torch.Generator(device=dev).manual_seed(k)
    base = [torch.randn((b, t, h, k), generator=g, device=dev) * 0.5 for _ in range(3)]
    base.append(torch.rand((b, t, h, k), generator=g, device=dev) * 0.9 + 0.05)
    base = [x.to(dtype) for x in base]
    bonus = torch.randn((h, k), generator=g, device=dev) * 0.5
    dy = torch.randn((b, h, t, k), generator=g, device=dev).to(dtype)

    def run():
        ins = [x.clone().requires_grad_() for x in (*base, bonus)]
        heads = [x.permute(0, 2, 1, 3) for x in ins[:4]]
        y = rwkv_ops.rwkv6_heads(*heads, ins[4].expand(b, h, k))
        return (y, *torch.autograd.grad(y, ins, dy))
    counts = (rwkv_ops.launches, rwkv_ops.backward_launches)
    got = run()
    torch.cuda.synchronize()
    assert (rwkv_ops.launches, rwkv_ops.backward_launches) == (counts[0] + 1, counts[1] + 1)
    with kernels.plain():
        want = run()
    assert (rwkv_ops.launches, rwkv_ops.backward_launches) == (counts[0] + 1, counts[1] + 1)
    assert _elem_err(got[0].detach(), want[0].detach()) <= RWKV_ELEM_TOL[dtype]
    # Each gradient's row runs over K, as in the backward's check: the (B,
    # T, H, K) leaves and the (H, K) bonus.  dy is given, so both backward
    # passes start from the same inputs: the backward's own tolerance.
    for x, w in zip(got[1:], want[1:]):
        assert _bwd_elem_err(x, w) <= RWKV_BWD_ELEM_TOL[dtype]


def test_rwkv6_backward_raises_on_what_it_does_not_take(dev):
    """K outside the instantiated set, fp16, or a dy of another shape
    raise: no plain fallback, no launch counted."""
    n = rwkv_ops.backward_launches
    args = _rwkv_inputs(dev, 2, 20, 24, torch.float32, seed=1)
    with pytest.raises(ValueError):
        rwkv_ops.backward(*(x[:, None] for x in args), args[0][:, None])
    args = _rwkv_inputs(dev, 2, 20, 64, torch.float16, seed=1)
    with pytest.raises(TypeError):
        rwkv_ops.backward(*(x[:, None] for x in args), args[0][:, None])
    args = _rwkv_inputs(dev, 2, 20, 64, torch.float32, seed=1)
    with pytest.raises(ValueError):
        rwkv_ops.backward(*(x[:, None] for x in args), args[0][:, None, :10])
    assert rwkv_ops.backward_launches == n


@pytest.mark.parametrize("field,value", [("chunk", 16), ("chunks", 1), ("kd", 32)])
def test_rwkv6_backward_refuses_a_plan_unlike_its_kernels(dev, monkeypatch, field, value):
    """The launcher checks the wrapper's plan (chunk size, chunks a head,
    scan tiles, scratch size) against its kernels' and launches nothing
    when they differ: a chunk of 16, too few chunks for T, or the tiles and
    scratch of another K."""
    real = rwkv_ops.bwd_plan
    monkeypatch.setattr(rwkv_ops, "bwd_plan", lambda t, kd, heads: dataclasses.replace(
        real(t, kd, heads), **{field: value}))
    args = _rwkv_inputs(dev, 2, 40, 64, torch.float32, seed=3)
    n = rwkv_ops.backward_launches
    with pytest.raises(RuntimeError):
        rwkv_ops.backward(*(x[:, None] for x in args), args[0][:, None])
    assert rwkv_ops.backward_launches == n


def test_rwkv6_kernel_raises_on_what_it_does_not_take(dev):
    """K outside the instantiated set, or fp16, raise: no plain fallback."""
    args = _rwkv_inputs(dev, 2, 20, 24, torch.float32, seed=1)
    n = rwkv_ops.launches
    with pytest.raises(ValueError):
        rwkv_ops.rwkv6_attention(*args)
    args = _rwkv_inputs(dev, 2, 20, 64, torch.float16, seed=1)
    with pytest.raises(TypeError):
        rwkv_ops.rwkv6_attention(*args)
    assert rwkv_ops.launches == n


def test_rwkv6_kernel_reads_model_layout_in_place(dev):
    """(B, T, H, K) tensors permuted to (B, H, T, K) and a broadcast bonus:
    no copies, y keeps the model's layout, same values as the plain path."""
    b, t, h, k = 2, 50, 4, 64
    g = torch.Generator(device=dev).manual_seed(3)
    x = [torch.randn((b, t, h, k), generator=g, device=dev) for _ in range(3)]
    x.append(torch.rand((b, t, h, k), generator=g, device=dev) * 0.9 + 0.05)
    heads = [a.permute(0, 2, 1, 3) for a in x]
    u = torch.randn((h, k), generator=g, device=dev).expand(b, h, k)
    v16 = rwkv_ops.vec16_launches
    y, s = rwkv_ops.rwkv6_heads(*heads, u, return_state=True)
    with kernels.plain():
        wy, ws = rwkv_ops.rwkv6_heads(*heads, u, return_state=True)
    torch.cuda.synchronize()
    assert y.stride() == heads[0].stride()
    assert rwkv_ops.vec16_launches == v16 + 1  # the model's views take 16-byte copies
    _rwkv_checks(y, s, wy, ws, torch.float32)


def _rwkv_card_model(dev):
    cfg = small_lm("card-rwkv", RWKV6_1_6B, num_layers=2, d_model=128, d_ff=256,
                   vocab_size=128, num_heads=2)
    model = build_model(cfg)
    params = model.init(0, dev)
    params["unembed"]["kernel"] *= 8.0
    g = torch.Generator(device=dev).manual_seed(1)
    for layer in ("wr", "wk", "wv", "wg", "wo"):  # factor the time mix in place
        k_in, k_out = params["g0"]["sub0"]["rwkv_t"][layer]["kernel"].shape[-2:]
        params["g0"]["sub0"]["rwkv_t"][layer] = {
            "u": torch.randn((2, k_in, 24), generator=g, device=dev) * k_in ** -0.5,
            "v": torch.randn((2, 24, k_out), generator=g, device=dev) * 24 ** -0.5,
            "u2": torch.randn((2, k_in, 8), generator=g, device=dev) * k_in ** -0.5,
            "v2": torch.randn((2, 8, k_out), generator=g, device=dev) * 8 ** -0.5}
    return model, params


def test_rwkv_dense_decode_step_kernels_vs_plain(dev):
    """One dense-slab decode step after a prefill, through the kernels
    (rwkv6 at prefill, nested_lowrank on the factored linears) and through
    the plain versions: the same logits and cache to fp32 rounding."""
    model, params = _rwkv_card_model(dev)
    toks = torch.as_tensor(np.arange(3, 3 + 2 * 37).reshape(2, 37) % 128, device=dev)
    nxt = toks[:, -1:]
    clen = torch.full((2,), 37, dtype=torch.int32, device=dev)
    out = []
    for plain in (False, True):
        cache = model.init_cache(2, 64, device=dev)
        r0, n0 = rwkv_ops.launches, nlr_ops.launches
        with (kernels.plain() if plain else torch.no_grad()), torch.no_grad():
            model.apply(params, toks, mode="prefill", cache=cache)
            logits = model.apply(params, nxt, mode="decode", cache=cache, cache_len=clen)
        torch.cuda.synchronize()
        launched = (rwkv_ops.launches - r0, nlr_ops.launches - n0)
        assert launched == ((0, 0) if plain else (model.cfg.num_layers, 2 * 5 * 2))
        out.append((logits, cache))
    (lk, ck), (lp, cp) = out
    assert _err(lk, lp) < 1e-4
    for k in ("state", "shift_t", "shift_c"):
        assert _err(ck["g0"]["sub0"]["rwkv"][k], cp["g0"]["sub0"]["rwkv"][k]) < 1e-4


def test_rwkv_served_greedy_stream_kernels_vs_plain(dev):
    model, params = _rwkv_card_model(dev)
    prompts = [np.arange(3, 3 + n) % 128 for n in (5, 19, 40)]

    def run():
        eng = ServingEngine(model, params, max_batch=2, max_len=64)
        ids = [eng.submit(p, max_new_tokens=12) for p in prompts]
        out = eng.run()
        st = eng.stats()
        assert eng.layout == "dense"
        assert st["host_syncs"] == st["steps"] + st["prefill_ticks"] == st["steps"] + 3
        return [out[i] for i in ids]

    launches = rwkv_ops.launches
    with_kernels = run()
    assert rwkv_ops.launches - launches == 3 * model.cfg.num_layers  # prefills only
    with kernels.plain():
        plain = run()
    assert with_kernels == plain


def test_rwkv_dense_decode_dispatch_is_sync_free(dev):
    model, params = _rwkv_card_model(dev)
    eng = ServingEngine(model, params, max_batch=4, max_len=64)
    for n in (5, 9, 30):
        eng.submit(np.arange(2, 2 + n), max_new_tokens=8)
    eng._admit()
    args = (eng.params, eng.cache, eng.last_token, eng.cache_len, eng.budget_dev,
            eng.key_data, eng.active_dev, *eng._host_inputs())
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng._decode(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def _moe_card_model(dev):
    """The reduced moonshot topology (a dense layer, two MoE layers of 8
    experts, top-2, a shared expert) widened to d_model 128 in bf16, its
    MoE layers' experts nested-factored (the batched kernel's routes)."""
    base = MOONSHOT_V1_16B_A3B.reduced()
    cfg = dataclasses.replace(base, d_model=128, d_ff=256, vocab_size=128, head_dim=32,
                              dtype="bfloat16",
                              moe=dataclasses.replace(base.moe, d_ff_expert=64))
    model = build_model(cfg)
    params = model.init(0, dev)
    params["unembed"]["kernel"] *= 8.0
    g = torch.Generator(device=dev).manual_seed(1)
    experts = params["g1"]["sub0"]["moe"]["experts"]
    for w in ("wi", "wg", "wo"):
        k_in, k_out = experts[w]["kernel"].shape[-2:]
        lead = experts[w]["kernel"].shape[:2]  # (layers, experts)
        experts[w] = {k: (torch.randn((*lead, *shape), generator=g, device=dev)
                          * shape[0] ** -0.5).to(torch.bfloat16)
                      for k, shape in (("u", (k_in, 24)), ("v", (24, k_out)),
                                       ("u2", (k_in, 8)), ("v2", (8, k_out)))}
    return model, params


def test_moe_dense_decode_step_kernels_vs_plain(dev):
    """One dense-slab decode step after an exact-length prefill, through the
    kernels (flash_attention at prefill, the batched nested kernel on every
    MoE layer's experts) and through the plain versions routed as the
    kernel run (``RoutingTrace``): logits within the decode-step gate (5% of
    max |logit|, chip_smoke.py's STEP_LOGIT_TOL), and the experts' launches:
    3 a layer a call, all batched."""
    model, params = _moe_card_model(dev)
    toks = torch.as_tensor(np.arange(3, 3 + 2 * 37).reshape(2, 37) % 128, device=dev)
    nxt = toks[:, -1:]
    clen = torch.full((2,), 37, dtype=torch.int32, device=dev)
    out = []
    trace = moe.RoutingTrace()  # the plain run takes the kernel run's experts
    for plain in (False, True):
        cache = model.init_cache(2, 64, device=dev)
        b0, f0 = sum(nlr_ops.batched_by_kernel.values()), fa_ops.launches
        with (kernels.plain() if plain else torch.no_grad()), torch.no_grad(), \
                (trace.replay() if plain else trace.record()):
            model.apply(params, toks, mode="prefill", cache=cache)
            logits = model.apply(params, nxt, mode="decode", cache=cache, cache_len=clen)
        torch.cuda.synchronize()
        launched = (sum(nlr_ops.batched_by_kernel.values()) - b0, fa_ops.launches - f0)
        assert launched == ((0, 0) if plain else (2 * 3 * 2, model.cfg.num_layers))
        out.append(logits.float())
    lk, lp = out
    assert bool(torch.isfinite(lk).all())
    assert float((lk - lp).abs().max()) <= 5e-2 * float(lp.abs().max())


def test_moe_dense_decode_dispatch_is_sync_free(dev):
    """Routing, dispatch, the batched experts, the combine and the slab
    write make no host sync in a decode step."""
    model, params = _moe_card_model(dev)
    eng = ServingEngine(model, params, max_batch=4, max_len=64)
    assert eng.layout == "dense"
    for n in (5, 9, 30):
        eng.submit(np.arange(2, 2 + n), max_new_tokens=8)
    eng._admit()
    args = (eng.params, eng.cache, eng.last_token, eng.cache_len, eng.budget_dev,
            eng.key_data, eng.active_dev, *eng._host_inputs())
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng._decode(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_column_id_on_card_matches_cpu_without_host_sync(dev):
    """The truncated pivoted QR on the card picks the CPU's columns and
    gives its T within 1e-10 (relative to max |T|), and queues all of its
    steps without one host sync."""
    from repro_torch.core.nid import column_id, id_compress

    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.standard_normal((2048, 1024)) * np.exp(-np.arange(1024) / 300.0))
    want_cols, want_t = column_id(a, 64)
    a_dev = a.to(dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        cols, t = column_id(a_dev, 64)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(cols.cpu(), want_cols)
    assert float((t.cpu() - want_t).abs().max()) <= 1e-10 * float(want_t.abs().max())
    f = id_compress(a_dev, 64)
    assert torch.equal(f.w, a_dev[:, cols])
    assert torch.equal(f.z[:, cols], torch.eye(64, dtype=torch.float64, device=dev))


def test_best_svd_randomized_on_card_matches_cpu(dev):
    """Above the 6144 minor-dimension threshold best_svd takes the
    randomized range finder (its test matrix drawn by numpy on both
    devices): the card's rank-k truncation within 1e-9 of the CPU's."""
    from repro_torch.core.svd import best_svd

    rng = np.random.default_rng(1)
    a = torch.as_tensor(rng.standard_normal((8192, 7168)) * np.exp(-np.arange(7168) / 400.0))
    k = 1024
    assert k < min(a.shape) // 4 and min(a.shape) > 6144  # the randomized branch
    want = best_svd(a, k)
    got = best_svd(a.to(dev), k)
    assert got.rank == want.rank == k
    wm = want.matrix()
    rel = float(torch.linalg.norm(got.matrix().cpu() - wm) / torch.linalg.norm(wm))
    assert rel <= 1e-9, rel
    assert float((got.s.cpu() - want.s).abs().max()) <= 1e-9 * float(want.s[0])


# ------------------------------------------ the serving policy on the card


def _paged_card_model(dev, dtype="bfloat16"):
    """A 2-layer Mistral-shaped model (8/2 heads x 8, G 4) with spread logits
    and its attention nested-factored in place (the stream kernel's rows)."""
    cfg = dataclasses.replace(
        small_lm("card-sched", MISTRAL_7B, num_layers=2, d_model=64, d_ff=96,
                 vocab_size=128, num_heads=8), dtype=dtype)
    model = build_model(cfg)
    params = model.init(0, dev)
    params["unembed"]["kernel"] *= 8.0
    g = torch.Generator(device=dev).manual_seed(1)
    wdt = params["unembed"]["kernel"].dtype
    for layer in ("wq", "wk", "wv", "wo"):
        k_in, k_out = params["g0"]["sub0"]["attn"][layer]["kernel"].shape[-2:]
        params["g0"]["sub0"]["attn"][layer] = {
            "u": (torch.randn((2, k_in, 16), generator=g, device=dev) * k_in ** -0.5).to(wdt),
            "v": (torch.randn((2, 16, k_out), generator=g, device=dev) * 16 ** -0.5).to(wdt),
            "u2": (torch.randn((2, k_in, 8), generator=g, device=dev) * k_in ** -0.5).to(wdt),
            "v2": (torch.randn((2, 8, k_out), generator=g, device=dev) * 8 ** -0.5).to(wdt)}
    return model, params


def _sched_prompts(n=6):
    rng = np.random.default_rng(21)
    return [rng.integers(2, 120, size=int(rng.integers(4, 30))) for _ in range(n)]


def _serve_card(model, params, prompts, max_new=20, **kw):
    eng = ServingEngine(model, params, max_batch=3, max_len=64, block_size=8,
                        prefill_chunk=16, **kw)
    ids = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    eng.run()
    return [eng.finished_requests[u].generated for u in ids], eng


def test_ring_dispatch_is_sync_free(dev):
    """Every decode dispatch of an on-demand, depth-2 engine under pool
    pressure (growth, table re-uploads, row order, preemption in between)
    makes no host sync: the only syncs are the consumed token copies."""
    from repro_torch.serving.scheduler import SchedulerConfig

    model, params = _paged_card_model(dev)
    for resume in ("reprefill", "swap"):
        eng = ServingEngine(model, params, max_batch=3, max_len=64, block_size=8,
                            num_blocks=10, prefill_chunk=16, pipeline_depth=2,
                            sched_config=SchedulerConfig(resume=resume))
        dispatch, n = eng._dispatch_decode, [0]

        def checked(dispatch=dispatch, n=n):
            torch.cuda.set_sync_debug_mode("error")
            try:
                dispatch()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            n[0] += 1

        eng._dispatch_decode = checked
        for p in _sched_prompts():
            eng.submit(p, max_new_tokens=20)
        eng.run()
        st = eng.stats()
        assert len(eng.finished_requests) == 6 and n[0] == st["steps"] == st["decode_syncs"]
        assert eng.scheduler_stats()["preempt_count"] > 0


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_depth2_streams_equal_depth1(dev, layout):
    """The ring changes no token: depth 2 (and 3) against depth 1, on the
    paged pools (bf16) and on RWKV-6's dense slab."""
    model, params = (_paged_card_model(dev) if layout == "paged"
                     else _rwkv_card_model(dev))
    streams = [_serve_card(model, params, _sched_prompts(), pipeline_depth=d)[0]
               for d in (1, 2, 3)]
    assert streams[1] == streams[0] and streams[2] == streams[0]


@pytest.mark.parametrize("kv_quant", [False, True])
def test_swap_out_and_back_is_bit_exact(dev, kv_quant):
    """Swapped blocks come back bit for bit (bf16 pools, and int8 pools
    with their scales), and a swap-preempted run's streams equal a run
    without pressure."""
    from repro_torch.serving.kvcache import pool_leaves
    from repro_torch.serving.scheduler import SchedulerConfig

    model, params = _paged_card_model(dev)
    base, _ = _serve_card(model, params, _sched_prompts(), kv_quant=kv_quant)
    swapped, eng = _serve_card(model, params, _sched_prompts(), kv_quant=kv_quant,
                               num_blocks=10, sched_config=SchedulerConfig(resume="swap"))
    st = eng.scheduler_stats()
    assert st["swap_bytes"] > 0 and st["swap_fallbacks"] == 0 and swapped == base
    # One swap by hand: the payload equals the pages, and the resumed
    # row's new pages equal the payload.
    eng = ServingEngine(model, params, max_batch=2, max_len=64, block_size=8,
                        num_blocks=24, prefill_chunk=16, kv_quant=kv_quant,
                        sched_config=SchedulerConfig(resume="swap"))
    uid = eng.submit(_sched_prompts()[1], max_new_tokens=30)
    for _ in range(12):
        eng.run(max_steps=1)
    eng.drain()
    req = next(r for r in eng.slots if r is not None and r.uid == uid)
    slot, n_ctx = req.slot, int(eng._len_host[req.slot])

    def pages(s, n_blocks):
        ids = torch.as_tensor(eng.kv.alloc.owned_by(s)[:n_blocks], device=dev)
        return [leaf.index_select(ax, ids) for _, ax, leaf in pool_leaves(eng.kv.pools)]

    n_blocks = eng.kv.blocks_for(n_ctx)
    old_ids = set(eng.kv.alloc.owned_by(slot)[:n_blocks])
    before = pages(slot, n_blocks)
    eng._preempt(slot, "pool_dry")
    assert all(torch.equal(b.cpu(), p) for b, p in zip(before, req.swap.blocks))
    eng.kv.alloc.alloc("decoy", n_blocks)  # the freed ids: the row must move
    eng._admit()
    assert req.swap is None and req.slot is not None
    assert not old_ids & set(eng.kv.alloc.owned_by(req.slot)[:n_blocks])
    assert all(torch.equal(a, b) for a, b in zip(pages(req.slot, n_blocks), before))


def test_defrag_keeps_pages_bit_exact_on_card(dev):
    """defrag's one gather per pool leaf on the card moves every live
    row's pages bit for bit, bf16 and int8 pools."""
    from repro_torch.serving.kvcache import PagedKVCache, pool_leaves

    model, _ = _paged_card_model(dev)
    for kv_quant in (False, True):
        kv = PagedKVCache(model, 4, 64, block_size=8, num_blocks=20, kv_quant=kv_quant,
                          device=dev)
        g = torch.Generator(device=dev).manual_seed(2)
        for _, _, leaf in pool_leaves(kv.pools):
            leaf.copy_(torch.randint(-100, 100, leaf.shape, generator=g, device=dev)
                       .to(leaf.dtype))
        for op, *args in (("reserve", 0, 20), ("reserve", 1, 9), ("reserve", 2, 30),
                          ("extend", 1, 30), ("free", 0), ("reserve", 3, 12),
                          ("rollback", 2, 17), ("free", 3)):
            getattr(kv, op)(*args)

        def pages():
            return [leaf.index_select(ax, torch.as_tensor(row[row >= 0], device=dev))
                    for row in kv.table_np for _, ax, leaf in pool_leaves(kv.pools)]

        before = pages()
        assert kv.defrag()
        assert all(torch.equal(a, b) for a, b in zip(before, pages()))


# ------------------------------------------------------ faults on the card


def test_poison_input_on_bf16_logits_is_sync_free(dev):
    """The bf16 paged decode step with the poison input: a zero vector
    leaves every token and flag as without it; a NaN row reports
    POISON_TOKEN and clears its own active flag, the other rows unchanged,
    and neither call synchronises (sync-debug "error")."""
    from repro_torch.launch.steps import POISON_TOKEN
    from repro_torch.serving.kvcache import upload

    model, params = _paged_card_model(dev)
    eng = ServingEngine(model, params, max_batch=3, max_len=64, block_size=8,
                        prefill_chunk=16, pipeline_depth=1)
    for p in _sched_prompts(3):
        eng.submit(p, max_new_tokens=20)
    while eng.sched or eng._prefilling:
        eng.run(max_steps=1)
    state = (eng.cache_len, eng.budget_dev, eng.key_data, eng.active_dev, *eng._host_inputs())

    def clone(tree):
        return ({k: clone(v) for k, v in tree.items()} if isinstance(tree, dict)
                else tree.clone())

    def step(*poison):
        pools = clone(eng.kv.pools)
        torch.cuda.set_sync_debug_mode("error")
        try:
            return eng._decode(params, pools, eng.kv.table_device(), eng.last_token, *state,
                               *poison)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    nan = np.zeros(3, np.float32)
    nan[1] = np.nan
    plain, zero = step(), step(torch.zeros(3, device=dev))
    hit = step(upload(nan, dev))
    assert all(torch.equal(a, z) for a, z in zip(plain, zero))
    assert int(hit[0][1]) == POISON_TOKEN and not bool(hit[4][1])
    keep = torch.tensor([True, False, True], device=dev)
    assert torch.equal(hit[0][keep], plain[0][keep]) and torch.equal(hit[4][keep], plain[4][keep])


def test_finite_check_on_an_inf_row(dev):
    """An Inf logit in one live row retires that row with POISON_TOKEN; a
    host-masked Inf row stays frozen and active."""
    from repro_torch.launch.steps import POISON_TOKEN, _sample_advance_exit

    b, v = 4, 256
    g = torch.Generator(device=dev).manual_seed(0)
    logits = torch.randn((b, 1, v), generator=g, device=dev).to(torch.bfloat16)
    logits[1, 0, 17] = float("inf")
    logits[2, 0, 3] = float("-inf")
    logits[3, 0, 5] = float("inf")
    keep = torch.tensor([True, True, True, False], device=dev)
    last = torch.arange(b, dtype=torch.int32, device=dev)
    out = _sample_advance_exit(
        logits, last, torch.full((b,), 5, dtype=torch.int32, device=dev),
        torch.full((b,), 9, dtype=torch.int32, device=dev),
        torch.zeros((b, 2), dtype=torch.int64, device=dev),
        torch.ones(b, dtype=torch.bool, device=dev), keep, torch.zeros(b, device=dev),
        torch.full((b,), -1, dtype=torch.int32, device=dev), 64)
    tok, act = out[0].cpu().tolist(), out[4].cpu().tolist()
    assert tok[1] == tok[2] == POISON_TOKEN and act == [True, False, False, True]
    assert tok[0] == int(logits[0, 0].float().argmax()) and tok[3] == 3


def test_cancel_live_row_at_depth2_on_card(dev):
    """A live row cancelled with a step in flight: the ring drains first,
    the row ends "cancelled" with a prefix of its uninterrupted stream, its
    blocks free, and the other streams are unchanged."""
    model, params = _paged_card_model(dev)
    base, _ = _serve_card(model, params, _sched_prompts(3), pipeline_depth=2)
    eng = ServingEngine(model, params, max_batch=3, max_len=64, block_size=8,
                        prefill_chunk=16, pipeline_depth=2)
    ids = [eng.submit(p, max_new_tokens=20) for p in _sched_prompts(3)]
    while len(eng.step_times) < 6:
        eng.run(max_steps=1)
    assert len(eng._ring) == 1 and any(r is not None and r.uid == ids[1] for r in eng.slots)
    assert eng.cancel(ids[1])
    eng.run()
    got = [eng.finished_requests[u] for u in ids]
    assert [r.finish_reason for r in got] == ["stop", "cancelled", "stop"]
    assert got[0].generated == base[0] and got[2].generated == base[2]
    assert 0 < len(got[1].generated) < 20 and got[1].generated == base[1][:len(got[1].generated)]
    assert eng.kv.alloc.in_use() == 0 and eng.fault_stats()["cancelled"] == 1


# ------------------------------------------------ speculative decoding


class _FixedLogits:
    """A model stand-in whose every forward returns the same logits, so a
    verify root's tail (accept, finish scan, pack) runs on identical logits
    on both devices."""

    def __init__(self, logits):
        self.logits = logits

    def apply(self, params, tokens, **kw):
        return self.logits.to(tokens.device)


def test_spec_verify_root_on_card_equals_cpu(dev):
    """The verify root's tail on the card equals the same root on the CPU
    for greedy rows on identical logits (accepted counts, commit counts
    cut at an eos, the poisoned row's -1, lengths, budgets, active flags,
    last tokens), and its call makes no host sync."""
    from repro_torch.launch.steps import make_spec_verify_step

    b, k, v = 8, 4, 512
    g = torch.Generator().manual_seed(0)
    logits = torch.randn((b, k + 1, v), generator=g) * 4
    greedy = logits.argmax(-1).to(torch.int32)
    proposals = torch.randint(0, v, (b, k), generator=g, dtype=torch.int32)
    for r in range(b):
        proposals[r, :r % (k + 1)] = greedy[r, :r % (k + 1)]
    logits[5, 1, 7] = float("nan")  # row 5 poisoned
    q = torch.softmax(torch.randn((b, k, v), generator=g), -1)
    eos = torch.full((b,), -1, dtype=torch.int32)
    eos[4] = int(greedy[4, 1])
    args = dict(last_token=torch.arange(b, dtype=torch.int32), proposals=proposals, q_probs=q,
                cache_len=torch.full((b,), 20, dtype=torch.int32),
                budget=torch.tensor([9, 9, 2, 9, 9, 9, 9, 1], dtype=torch.int32),
                key_data=torch.zeros((b, 2), dtype=torch.int64),
                active=torch.ones(b, dtype=torch.bool),
                host_keep=torch.tensor([True] * 6 + [False, True]),
                temps=torch.zeros(b), eos=eos,
                k_row=torch.tensor([k, k, 2, k, k, k, k, 1], dtype=torch.int32))

    def run(device):
        root = make_spec_verify_step(_FixedLogits(logits.to(device)), k, 64)
        kw = {n: t.to(device) for n, t in args.items()}
        if device.type == "cuda":
            torch.cuda.set_sync_debug_mode("error")
        try:
            out = root(None, None, None, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        return [t.cpu() for t in out]

    cpu, card = run(torch.device("cpu")), run(dev)
    for got, want in zip(card, cpu):
        assert torch.equal(got, want)
    pack = cpu[0]
    assert pack[5, k + 1] == -1 and pack[4, k + 1] <= 2 and pack[6, k + 1] == 0


@pytest.mark.parametrize("paged", [True, False])
def test_spec_step_dispatch_is_sync_free(dev, paged):
    """A speculative engine step's dispatch (the draft root's k+1 decodes on
    the nested stream kernel and, paged, the paged kernel; the verify
    root's 40-row chunk on the mma kernel) makes no host sync, on the paged
    pools and on the dense slab, and the engine then serves every request
    to its end.  (Greedy streams are held to plain decoding's on the CPU,
    tests/test_torch_spec.py, and on the card by chip_smoke's margin rule:
    the bf16 verify chunk and the plain decode step round differently, so
    they may part at a near-tie.)"""
    from repro_torch.serving.spec import SpecConfig

    model, params = _paged_card_model(dev)
    prompts = _sched_prompts(3)
    eng = ServingEngine(model, params, max_batch=8, max_len=64, block_size=8,
                        prefill_chunk=16, pipeline_depth=1, paged=paged,
                        spec_config=SpecConfig(params, k=4))
    ids = [eng.submit(p, max_new_tokens=20) for p in prompts]
    while eng.sched or eng._prefilling:
        eng.run(max_steps=1)
    before = (nlr_ops.stream_launches, nlr_ops.mma_launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng._dispatch_spec()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    calls = 4 * model.cfg.num_layers  # the nested attention projections of a forward
    assert (nlr_ops.stream_launches - before[0],
            nlr_ops.mma_launches - before[1]) == (5 * calls, calls)
    eng.drain()
    eng.run()
    got = [eng.finished_requests[u] for u in ids]
    assert all(r.finish_reason == "stop" and len(r.generated) == 20 for r in got)
    assert eng.spec_stats()["steps"] >= 1 and eng.spec_stats()["acceptance_rate"] > 0.5


def test_spec_draft_failure_raises_on_card(dev):
    """A draft root that fails on the card (not an injected ``draft_kill``)
    raises out of the step: no fallback to plain decode hides a kernel's
    launch failure there (on the CPU the engine degrades as the
    reference's does)."""
    from repro_torch.serving.spec import SpecConfig

    model, params = _paged_card_model(dev)
    eng = ServingEngine(model, params, max_batch=8, max_len=64, block_size=8,
                        prefill_chunk=16, pipeline_depth=1, spec_config=SpecConfig(params, k=4))
    for p in _sched_prompts(2):
        eng.submit(p, max_new_tokens=8)
    while eng.sched or eng._prefilling:
        eng.run(max_steps=1)

    def failing(*args):
        raise RuntimeError("draft launch failed")

    eng._spec_draft = failing
    with pytest.raises(RuntimeError, match="draft launch failed"):
        eng._dispatch_spec()
    assert eng.fault_stats()["draft_kills"] == 0


@pytest.mark.parametrize("depth", [1, 2])
def test_telemetry_on_off_streams_bit_identical_on_card(dev, depth):
    """Telemetry observes without perturbing: the same greedy streams and
    kernel launches with it on and off, every dispatch of the telemetry run
    under the engine's transfer guard (sync-debug "error"), and its token
    counter equal to the tokens served."""
    from repro_torch.obs import Telemetry

    model, params = _paged_card_model(dev)
    runs = []
    for tel in (None, Telemetry()):
        before = (nlr_ops.stream_launches, nlr_ops.mma_launches, pa_ops.launches)
        out, eng = _serve_card(model, params, _sched_prompts(), pipeline_depth=depth,
                               telemetry=tel, transfer_guard=tel is not None)
        launched = (nlr_ops.stream_launches - before[0], nlr_ops.mma_launches - before[1],
                    pa_ops.launches - before[2])
        runs.append((out, launched))
    assert runs[1] == runs[0]
    assert tel.tokens_emitted.value == sum(len(s) for s in runs[1][0])
    assert tel.steps_dispatched.value == eng.stats()["steps"]


def test_profile_capture_holds_cuda_kernels(dev, tmp_path):
    """A ProfileCapture of 4 steps on the card writes a Chrome trace with
    the decode root's ranges and its kernels (nested stream, paged split)."""
    import json

    from repro_torch.obs import Telemetry

    model, params = _paged_card_model(dev)
    tel = Telemetry(profile_dir=str(tmp_path), profile_steps=4)
    _serve_card(model, params, _sched_prompts(), pipeline_depth=1, telemetry=tel)
    prof = tel.profile
    assert prof.error is None and prof.trace_path is not None
    with open(prof.trace_path) as f:
        evs = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in evs if e.get("cat") == "kernel"]
    assert any(e.get("name") == "serving_root.paged_decode" for e in evs)
    assert any("stream_partial" in k for k in kernels)
    assert any("paged_split_kernel" in k for k in kernels)


# ------------------------------------------------ the widest dense GQA archs

@pytest.mark.parametrize("arch", ["phi3-medium-14b", "deepseek-67b"])
def test_full_width_gqa_arch_compressed_kernels_vs_plain(dev, arch):
    """phi3-medium-14b (d_model 5120, 40/10 heads, vocab 100352) and
    deepseek-67b (d_model 8192, 64/8 heads, d_ff 22016: gram at n 22016 and
    nested at K 22016, the widest shapes of any path) at full width, cut to
    one layer, random bf16 weights: one calibration batch (16 x 128; gram on
    its mma kernel for every tap, flash once), nsvd1 at 0.2, then a 64-token
    prefill chunk of 8 rows through the paged pools (512 nested rows, the
    mma kernel) and one paged decode step (8 rows: the stream kernel and
    paged_attention) through the kernels and through the plain versions:
    logits within 5% of max |logit| (chip_smoke.py's STEP_LOGIT_TOL).
    Prints the seconds and the peak device memory beside nvidia-smi's name
    and power limit."""
    from repro_torch.serving.kvcache import PagedKVCache

    cfg = dataclasses.replace(get_config(arch), num_layers=1)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg)
    params = model.init(0, dev)
    rng = np.random.default_rng(0)
    batch = rng.integers(2, cfg.vocab_size // 2, (16, 128)).astype(np.int32)
    g0, f0 = (gram_ops.launches, gram_ops.mma_launches), fa_ops.launches
    store = collect_grams(model, params, [batch])
    assert (gram_ops.launches - g0[0], gram_ops.mma_launches - g0[1]) == (5, 5)
    assert fa_ops.launches - f0 == 1
    plan = build_plan(model.compressible_targets(), CompressionConfig(
        method="nsvd1", ratio=0.2, dtype=cfg.dtype, use_randomized=False))
    params = compress_params(params, plan, store)
    del store
    calib_s = time.perf_counter() - t0
    toks = torch.as_tensor(rng.integers(2, cfg.vocab_size // 2, (8, 64)), device=dev)
    nxt = torch.as_tensor(rng.integers(2, cfg.vocab_size // 2, (8, 1)), device=dev)
    clen = torch.full((8,), 64, dtype=torch.int32, device=dev)
    out = []
    for plain in (False, True):
        kv = PagedKVCache(model, 8, 128, block_size=16, device=dev)
        for slot in range(8):
            kv.reserve(slot, 65)
        bt = kv.table_device()
        n0, p0 = _nested_counts(), pa_ops.launches
        with (kernels.plain() if plain else torch.no_grad()), torch.no_grad():
            pre = model.apply(params, toks, mode="decode", cache=kv.pools,
                              cache_len=torch.zeros_like(clen), block_tables=bt).float()
            step = model.apply(params, nxt, mode="decode", cache=kv.pools, cache_len=clen,
                               block_tables=bt).float()
        torch.cuda.synchronize()
        n1 = _nested_counts()
        launched = (n1[1] - n0[1], n1[2] - n0[2], n1[3] - n0[3], pa_ops.launches - p0)
        assert launched == ((0, 0, 0, 0) if plain else (7, 7, 0, 1))
        out.append((pre, step))
        del kv
    (pk, sk), (pp, sp) = out
    for got, want in ((pk, pp), (sk, sp)):
        assert got.shape[-1] == cfg.vocab_size and bool(torch.isfinite(got).all())
        assert float((got - want).abs().max()) <= 5e-2 * float(want.abs().max())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(f"\n{arch} (1 layer, full width): calibrate + compress {calib_s:.1f} s, total "
          f"{time.perf_counter() - t0:.1f} s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; prefill err "
          f"{float((pk - pp).abs().max()):.4e} of {float(pp.abs().max()):.3f}, decode err "
          f"{float((sk - sp).abs().max()):.4e} of {float(sp.abs().max()):.3f}; {smi}")


# ------------------------------------------ deepseek-v3's MoE layer, 256 experts

def test_full_width_dsv3_moe_layer_256_experts_kernels_vs_plain(dev):
    """One deepseek-v3-671b (mla, moe) layer at full width with all 256
    experts (d_model 7168, 128 heads, kv_lora 512, top-8, 1 shared expert,
    vocab 129280), every target factored with random factors at the served
    plan's ranks (nsvd1 at 0.2: the experts at 1210 + 64) and no
    calibration (256 experts' fp64 Grams would be 105 GB): a 512-row
    prefill (8 x 64 on the latent slab: the single form on mma, the
    experts at capacity 20 on the batched mma kernel) and a decode step of
    8 rows (stream; the experts at capacity 8) through the kernels and
    through the plain versions, the plain runs pinned to the kernel runs'
    expert choices; logits within 5% of max |logit| (chip_smoke.py's
    STEP_LOGIT_TOL).  Prints how many of the 256 experts hold a row at the
    decode step (at most 8 x 8 = 64), the peak device memory and
    nvidia-smi's name and power limit."""
    from repro_torch.launch.compress_shapes import compressed_param_shapes

    base = get_config("deepseek-v3-671b")
    cfg = dataclasses.replace(base, num_layers=1, moe=dataclasses.replace(
        base.moe, first_k_dense=0))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg)
    shapes = compressed_param_shapes(model, model.init(device="meta"), 0.2, k1_frac=0.95,
                                     multiple_of=1)
    # The non-expert leaves from a one-expert twin's init; every factor and
    # the 256-expert router random.
    real = build_model(dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=1))).init(0, dev)
    gen = torch.Generator(device=dev).manual_seed(1)

    def fill(meta, have, path=()):
        if isinstance(meta, dict):
            return {k: fill(v, have.get(k, {}) if isinstance(have, dict) else {}, path + (k,))
                    for k, v in meta.items()}
        if isinstance(have, torch.Tensor) and have.shape == meta.shape:
            return have
        fan_in = meta.shape[-2]
        return (torch.randn(meta.shape, generator=gen, device=dev) * fan_in ** -0.5).to(
            meta.dtype)
    params = fill(shapes, real)
    del real
    wi = params["g0"]["sub0"]["moe"]["experts"]["wi"]
    assert tuple(wi["u"].shape) == (256, 7168, 1210) and tuple(wi["u2"].shape) == (
        256, 7168, 64)
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(2, cfg.vocab_size // 2, (8, 64)), device=dev)
    nxt = torch.as_tensor(rng.integers(2, cfg.vocab_size // 2, (8, 1)), device=dev)
    clen = torch.full((8,), 64, dtype=torch.int32, device=dev)
    out, traces = [], [moe.RoutingTrace(), moe.RoutingTrace()]
    for plain in (False, True):
        cache = model.init_cache(8, 128, device=dev)
        n0, b0 = _nested_counts(), dict(nlr_ops.batched_by_kernel)
        with torch.no_grad():
            with (kernels.plain() if plain else contextlib.nullcontext()), \
                    (traces[0].replay() if plain else traces[0].record()):
                pre = model.apply(params, toks, mode="prefill", cache=cache).float()
            with (kernels.plain() if plain else contextlib.nullcontext()), \
                    (traces[1].replay() if plain else traces[1].record()):
                step = model.apply(params, nxt, mode="decode", cache=cache,
                                   cache_len=clen).float()
        torch.cuda.synchronize()
        n1, b1 = _nested_counts(), nlr_ops.batched_by_kernel
        launched = (n1[1] - n0[1], n1[2] - n0[2], n1[3] - n0[3],
                    b1["stream"] - b0["stream"], b1["mma"] - b0["mma"])
        # Prefill: 5 MLA + 3 shared on mma, 3 batched on mma (capacity 20);
        # decode: 4 MLA (wkv_b through dense_kernel) + 3 shared and 3 batched
        # on stream.
        assert launched == ((0, 0, 0, 0, 0) if plain else (10, 11, 0, 3, 3))
        out.append((pre, step))
        del cache
    (pk, sk), (pp, sp) = out
    assert moe.capacity_of(512, cfg) == 20 and moe.capacity_of(8, cfg) == 8
    for got, want in ((pk, pp), (sk, sp)):
        assert got.shape[-1] == cfg.vocab_size and bool(torch.isfinite(got).all())
        assert float((got - want).abs().max()) <= 5e-2 * float(want.abs().max())
    held = int(torch.unique(traces[1].choices[0]).numel())
    assert 8 <= held <= 64
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(f"\ndeepseek-v3-671b (mla, moe) layer, 256 experts (full width, random factors): "
          f"{time.perf_counter() - t0:.1f} s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; experts holding a decode "
          f"row {held} of 256; routings pinned {traces[0].flips} (prefill) "
          f"{traces[1].flips} (decode); prefill err {float((pk - pp).abs().max()):.4e} of "
          f"{float(pp.abs().max()):.3f}, decode err {float((sk - sp).abs().max()):.4e} of "
          f"{float(sp.abs().max()):.3f}; {smi}")


def test_full_width_jamba_mamba_moe_layer_16_experts_kernels_vs_plain(dev):
    """One jamba-v0.1-52b (mamba, moe) layer at full width with all 16
    experts (d_model 4096, d_inner 8192, d_state 16, dt_rank 256, experts
    4096 <-> 14336 top-2, vocab 65536), every target factored with random
    factors at the served plan's ranks (nsvd1 at 0.2: in_proj 2490 + 131,
    x_proj 211 + 11, dt_proj 188 + 10, out_proj 2075 + 109, the experts
    2421 + 127) and no calibration (16 experts' fp64 Grams would be 71 GB
    with the other layers'): a 512-row prefill (8 x 64 on the dense slab:
    the Mamba linears on mma, the experts at capacity 80 on the batched mma
    kernel) and a decode step of 8 rows (stream; the experts at capacity
    8) through the kernels and through the plain versions, the plain runs
    pinned to the kernel runs' expert choices; logits within 5% of max
    |logit| (chip_smoke.py's STEP_LOGIT_TOL).  Then the selective scan at
    full width (S 2048, d_inner 8192, d_state 16) against an fp64
    sequential recurrence, output and final state within 1e-4 of their max.
    Prints the seconds, the peak device memory and nvidia-smi's name and
    power limit."""
    from repro_torch.launch.compress_shapes import compressed_param_shapes
    from repro_torch.models import mamba

    base = get_config("jamba-v0.1-52b")
    cfg = dataclasses.replace(base, num_layers=1, mixer_pattern=("mamba",),
                              moe=dataclasses.replace(base.moe, first_k_dense=0,
                                                      moe_every=1))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg)
    assert model.specs == (("mamba", "moe"),)
    shapes = compressed_param_shapes(model, model.init(device="meta"), 0.2, k1_frac=0.95,
                                     multiple_of=1)
    # The non-factored leaves (dt_proj's bias, a_log, the conv, ...) from a
    # one-expert twin's init; every factor and the 16-expert router random.
    real = build_model(dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=1))).init(0, dev)
    gen = torch.Generator(device=dev).manual_seed(1)

    def fill(meta, have):
        if isinstance(meta, dict):
            return {k: fill(v, have.get(k, {}) if isinstance(have, dict) else {})
                    for k, v in meta.items()}
        if isinstance(have, torch.Tensor) and have.shape == meta.shape:
            return have
        fan_in = meta.shape[-2]
        return (torch.randn(meta.shape, generator=gen, device=dev) * fan_in ** -0.5).to(
            meta.dtype)
    params = fill(shapes, real)
    del real
    mp = params["g0"]["sub0"]["mamba"]
    assert [(tuple(mp[t]["u"].shape), tuple(mp[t]["u2"].shape)) for t in (
        "in_proj", "x_proj", "dt_proj", "out_proj")] == [
        ((4096, 2490), (4096, 131)), ((8192, 211), (8192, 11)), ((256, 188), (256, 10)),
        ((8192, 2075), (8192, 109))]
    assert tuple(mp["dt_proj"]["bias"].shape) == (8192,)
    wi = params["g0"]["sub0"]["moe"]["experts"]["wi"]
    assert tuple(wi["u"].shape) == (16, 4096, 2421) and tuple(wi["u2"].shape) == (
        16, 4096, 127)
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(2, cfg.vocab_size // 2, (8, 64)), device=dev)
    nxt = torch.as_tensor(rng.integers(2, cfg.vocab_size // 2, (8, 1)), device=dev)
    clen = torch.full((8,), 64, dtype=torch.int32, device=dev)
    out, traces = [], [moe.RoutingTrace(), moe.RoutingTrace()]
    for plain in (False, True):
        cache = model.init_cache(8, 128, device=dev)
        n0, b0 = _nested_counts(), dict(nlr_ops.batched_by_kernel)
        with torch.no_grad():
            with (kernels.plain() if plain else contextlib.nullcontext()), \
                    (traces[0].replay() if plain else traces[0].record()):
                pre = model.apply(params, toks, mode="prefill", cache=cache).float()
            with (kernels.plain() if plain else contextlib.nullcontext()), \
                    (traces[1].replay() if plain else traces[1].record()):
                step = model.apply(params, nxt, mode="decode", cache=cache,
                                   cache_len=clen).float()
        torch.cuda.synchronize()
        n1, b1 = _nested_counts(), nlr_ops.batched_by_kernel
        launched = (n1[1] - n0[1], n1[2] - n0[2], n1[3] - n0[3],
                    b1["stream"] - b0["stream"], b1["mma"] - b0["mma"])
        # Prefill: 4 Mamba linears and 3 batched on mma (capacity 80);
        # decode: 4 and 3 on stream.
        assert launched == ((0, 0, 0, 0, 0) if plain else (7, 7, 0, 3, 3))
        out.append((pre, step))
        del cache
    (pk, sk), (pp, sp) = out
    assert moe.capacity_of(512, cfg) == 80 and moe.capacity_of(8, cfg) == 8
    for got, want in ((pk, pp), (sk, sp)):
        assert got.shape[-1] == cfg.vocab_size and bool(torch.isfinite(got).all())
        assert float((got - want).abs().max()) <= 5e-2 * float(want.abs().max())
    held = int(torch.unique(traces[1].choices[0]).numel())
    assert 2 <= held <= 16
    layer_s = time.perf_counter() - t0
    del params, out, pk, sk, pp, sp

    # The scan at full width against an fp64 sequential recurrence.
    s, di, ns = 2048, 8192, 16
    g = torch.Generator(device=dev).manual_seed(2)
    dt = torch.nn.functional.softplus(torch.randn((1, s, di), generator=g, device=dev)
                                      * 0.5 - 4.6)
    a = -torch.arange(1, ns + 1, dtype=torch.float32, device=dev).repeat(di, 1)
    b_mat = torch.randn((1, s, ns), generator=g, device=dev)
    c_mat = torch.randn((1, s, ns), generator=g, device=dev)
    xc = torch.nn.functional.silu(torch.randn((1, s, di), generator=g, device=dev))
    h0 = torch.zeros((1, di, ns), device=dev)
    t1 = time.perf_counter()
    y, h = mamba.chunk_scan(dt, a, b_mat, c_mat, xc, h0)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t1
    d64, a64, b64, c64, x64 = (t.double() for t in (dt, a, b_mat, c_mat, xc))
    h64 = h0.double()
    ys = []
    for t in range(s):
        h64 = torch.exp(d64[:, t, :, None] * a64) * h64 + (
            d64[:, t] * x64[:, t])[..., None] * b64[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h64, c64[:, t]))
    y64 = torch.stack(ys, 1)
    y_err = float((y.double() - y64).abs().max() / y64.abs().max())
    h_err = float((h.double() - h64).abs().max() / h64.abs().max())
    assert y.shape == (1, s, di) and y_err <= 1e-4 and h_err <= 1e-4
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(f"\njamba-v0.1-52b (mamba, moe) layer, 16 experts (full width, random factors): "
          f"{layer_s:.1f} s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; experts holding a decode "
          f"row {held} of 16; routings pinned {traces[0].flips} (prefill) "
          f"{traces[1].flips} (decode); scan at S {s}: {scan_s * 1e3:.1f} ms (first call), "
          f"y err {y_err:.3e}, h err {h_err:.3e} of the fp64 recurrence; {smi}")


@pytest.mark.parametrize("method,in_dim,out_dim,gram_kind,tight", [
    ("nsvd1", 14336, 4096, "indefinite", True), ("nsvd1", 14336, 4096, "spd", False),
    ("nsvd1", 4096, 14336, "spd", True), ("nsvd1", 8192, 288, "indefinite", True),
    ("nsvd1", 2048, 7168, "spd", True), ("nsvd1", 5120, 13824, "spd", True),
    ("nsvd1", 13824, 5120, "indefinite", True), ("nsvd2", 14336, 4096, "spd", True)])
def test_decomposition_bytes_bound_the_measured_peak(dev, method, in_dim, out_dim, gram_kind,
                                                     tight):
    """One kernel's fp64 decomposition (``compress_matrix`` with the serve
    CLI's config: no randomized SVD, ratio 0.2) on the card peaks at or
    below ``compress_shapes.decomposition_bytes``, which the serve CLI's
    memory check adds, and where the model's leading term is the one that
    runs (``tight``) the estimate is within 20% of the peak.  An indefinite
    Gram makes the Cholesky whitener fall back to the eigen one, as a
    rank-deficient expert Gram does; a Cholesky whitener that succeeds
    peaks lower than the model's eigen build.  (5120, 13824) and (13824,
    5120) are shapes the coefficients were not fitted on."""
    from repro_torch.core.compress import compress_matrix
    from repro_torch.core.ratio import rank_for_ratio
    from repro_torch.launch.compress_shapes import decomposition_bytes

    g = torch.Generator(device=dev).manual_seed(in_dim + out_dim)
    kern = (torch.randn((in_dim, out_dim), generator=g, device=dev) * in_dim ** -0.5).to(
        torch.bfloat16).float()
    r = torch.randn((in_dim, in_dim), generator=g, device=dev, dtype=torch.float64)
    shift = in_dim if gram_kind == "spd" else -in_dim / 100
    gram = r @ r.T + shift * torch.eye(in_dim, device=dev, dtype=torch.float64)
    del r
    absmean = torch.rand(in_dim, generator=g, device=dev, dtype=torch.float64)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    compress_matrix(kern, rank_for_ratio(out_dim, in_dim, 0.2), CompressionConfig(
        method=method, ratio=0.2, use_randomized=False), gram, absmean)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    est = decomposition_bytes(in_dim, out_dim, method)
    print(f"{method} {in_dim} -> {out_dim} ({gram_kind} Gram): peak {peak / 2 ** 30:.3f} GiB, "
          f"estimate {est / 2 ** 30:.3f} ({est / peak:.3f}x)")
    assert peak <= est
    assert est <= 1.2 * peak or not tight


def test_gram_homes_agree_at_mistral_7b_depth_2(dev, monkeypatch):
    """mistral-7b at full width cut to 2 layers (random weights from seed
    0), where both GramStore homes fit the card: the host store, filled one
    layer a group, against the one-pass device store -- every layer's
    Grams, absmeans and counts bit-identical, the shared keys (summed over
    the two groups in turn) within 1e-12 of their largest entry -- and
    nsvd1 0.2 from either store bit-identical, every factor on the card;
    the host store's Grams read onto the card one key at a time."""
    from repro_torch.calib.runner import calibration_batches
    from repro_torch.checkpoint.checkpointer import flatten
    from repro_torch.core import GramStore
    from repro_torch.launch.compress_shapes import gram_layers

    cfg = dataclasses.replace(MISTRAL_7B, num_layers=2)
    model = build_model(cfg)
    params = model.init(0, dev)
    batches = list(calibration_batches(cfg.vocab_size, "en_a", n_samples=256, batch=16,
                                       seq=128))
    one = collect_grams(model, params, batches)
    host = collect_grams(model, params, batches, grams_on="host",
                         group_bytes=max(gram_layers(model)["layers"].values()))
    assert one.device.type == "cuda" and host.device == torch.device("cpu") and host.groups == 2
    assert set(host.keys()) == set(one.keys())
    own = [k for k in one.keys() if k.rsplit("/", 1)[-1].isdigit()]
    assert len(own) == 2 * 4
    for k in one.keys():
        assert host.count(k) == one.count(k), k
        for got, want in ((host.gram(k), one.gram(k).cpu()),
                          (host.absmean(k), one.absmean(k).cpu())):
            if k in own:
                assert torch.equal(got, want), k
            else:
                assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max()), k
    plan = build_plan(model.compressible_targets(), CompressionConfig(
        method="nsvd1", ratio=0.2, dtype=cfg.dtype, use_randomized=False))
    reads = []
    real = GramStore.gram

    def spy(self, key, *a, **kw):
        reads.append(kw.get("device"))
        return real(self, key, *a, **kw)
    monkeypatch.setattr(GramStore, "gram", spy)
    from_host = compress_params(params, plan, host)
    monkeypatch.undo()
    from_dev = compress_params(params, plan, one)
    assert len(reads) == cfg.num_layers * len(plan.targets)
    assert all(d.type == "cuda" for d in reads)
    a, b = flatten(from_host), flatten(from_dev)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].device.type == "cuda" and torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("paged", [True, False])
def test_mesh_11_nccl_engine_bit_identical_on_card(dev, tmp_path, paged):
    """A (1, 1) serving mesh on one NCCL rank (a FileStore process group) on
    the card: the streams, every kernel's launches and the host syncs of the
    meshless engine, bit for bit, with one all-gather of the token word
    over the data group a host sync, no TP collective, and every dispatch
    under the transfer guard (sync-debug "error")."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.parallel import collectives, make_parallelism

    model, params = _paged_card_model(dev)
    prompts = _sched_prompts()
    runs = []
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        par = make_parallelism(make_serving_mesh(1, 1))
        for p in (None, par):
            before = (nlr_ops.launches, pa_ops.launches, fa_ops.launches)
            collectives.reset_counts()
            out, eng = _serve_card(model, params, prompts, paged=paged, parallelism=p,
                                   transfer_guard=True)
            launched = (nlr_ops.launches - before[0], pa_ops.launches - before[1],
                        fa_ops.launches - before[2])
            runs.append((out, launched, eng.stats()["host_syncs"], dict(collectives.counts)))
    finally:
        dist.destroy_process_group()
    (base, base_l, base_syncs, none), (mesh, mesh_l, syncs, coll) = runs
    assert mesh == base and mesh_l == base_l and syncs == base_syncs
    assert none == {} and coll == {("all_gather", "data"): syncs}
