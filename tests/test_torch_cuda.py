"""Card-only checks of the port's CUDA kernels against their plain PyTorch
versions, and of a served stream with the kernels against the same stream
through the plain versions.  CUDA kernels have no CPU mode, so every test
here is marked ``cuda`` and skips without a card.  Imports neither jax nor
repro, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import check_launch
from repro_torch.calib.runner import collect_grams
from repro_torch.configs import MISTRAL_7B, MOONSHOT_V1_16B_A3B, RWKV6_1_6B, small_lm
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


def _gram_checks(x, got_g, got_a):
    want_g, want_a = gram_ref.gram_accumulate_ref(x)
    assert bool(torch.isfinite(got_g).all())
    assert _err(got_g, want_g) < GRAM_TOL
    assert _err(got_a, want_a) < GRAM_TOL
    assert gram_ref.gram_elem_err(got_g, want_g) <= GRAM_ELEM_TOL
    assert torch.equal(got_g, got_g.T)


def _gram_counts():
    return gram_ops.launches, gram_ops.mma_launches, gram_ops.fma_launches


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,n", [(64, 128), (77, 200), (2048, 4096), (5, 1)])
def test_gram_kernel_matches_plain(dev, rows, n, dtype):
    """Ragged rows and n included, against GRAM_TOL and GRAM_ELEM_TOL."""
    g = torch.Generator(device=dev).manual_seed(rows + n)
    x = torch.randn((rows, n), generator=g, device=dev).to(dtype)
    x[:, n // 2] *= 30.0  # an outlier channel
    before = gram_ops.launches
    got_g, got_a = gram_ops.gram_accumulate(x.reshape(1, rows, n))
    torch.cuda.synchronize()
    assert gram_ops.launches == before + 1
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
    assert _gram_counts() == (before[0] + 1, before[1] + (want == "mma"),
                              before[2] + (want == "fma"))
    _gram_checks(x, got_g, got_a)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("experts,rows,n", [(1, 33, 136), (8, 12, 32), (64, 240, 2048),
                                            (64, 240, 1408), (5, 1, 8)])
def test_gram_batched_matches_plain(dev, experts, rows, n, dtype):
    """Per-expert Grams of a zero-padded capacity buffer in one launch (mma
    for bf16, FMA for fp32), each expert per element and exactly symmetric;
    empty rows and an empty expert included."""
    g = torch.Generator(device=dev).manual_seed(experts * rows + n)
    buf = torch.randn((experts, rows, n), generator=g, device=dev)
    buf[:, :, ::97] *= 20.0  # outlier channels
    buf[:, rows - rows // 3:] = 0.0
    buf[experts // 2] = 0.0
    buf = buf.to(dtype)
    before = (*_gram_counts(), gram_ops.batched_launches)
    got_g, got_a = gram_ops.gram_accumulate_batched(buf)
    torch.cuda.synchronize()
    mma = dtype == torch.bfloat16
    assert (*_gram_counts(), gram_ops.batched_launches) == (
        before[0] + 1, before[1] + mma, before[2] + (not mma), before[3] + 1)
    assert got_g.shape == (experts, n, n) and got_a.shape == (experts, n)
    for e in range(experts):
        if e == experts // 2:
            assert not got_g[e].any() and not got_a[e].any()
        else:
            _gram_checks(buf[e], got_g[e], got_a[e])


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_calibration_runs_through_gram_and_flash(dev, dtype):
    """collect_grams on a CUDA model launches gram once per tap and batch
    (every launch on the mma kernel for bf16 taps, on the FMA kernel for
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
    assert (g1[1] - g0[1], g1[2] - g0[2]) == ((g1[0] - g0[0], 0) if mma else (0, g1[0] - g0[0]))
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
