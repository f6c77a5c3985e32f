"""Port parity for the calibration Gram: the port's ``gram_accumulate``
(its plain version on the CPU) and ``gram_update`` against the reference's
Pallas kernel in interpret mode and its ``calib.gram.gram_update``, on the
same numpy-seeded inputs, ragged rows and widths included; the
calibration telemetry's per-batch rows against the reference's; the
kernels' routes and the tf32x3 kernel's row splits; and its 3xTF32
arithmetic, emulated here, against the reference within the card's fp64
gate, which a single-pass TF32 Gram fails."""

import chip_smoke
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import t2np, tiny_cfgs, to_t

from repro.calib.gram import accumulate_taps as jax_accumulate_taps
from repro.calib.gram import gram_update as jax_gram_update
from repro.calib.runner import collect_grams as jax_collect_grams
from repro.core import GramStore as JaxGramStore
from repro.kernels.gram.ops import gram_accumulate as jax_gram_accumulate
from repro.models import build_model as jax_build_model
from repro.obs.compression import CompressionTelemetry as JaxTelemetry
from repro_torch.calib.gram import accumulate_taps, gram_update
from repro_torch.calib.runner import collect_grams
from repro_torch.models import build_model
from repro_torch.core import GramStore
from repro_torch.kernels.gram import ops as gram_ops
from repro_torch.kernels.gram import ref as gram_ref
from repro_torch.kernels.gram.ops import gram_accumulate
from repro_torch.obs.compression import CompressionTelemetry

SHAPES = [(3, 7, 40), (50, 33), (129, 24), (1, 1, 8), (600, 16)]


def _inputs(shape, dtype, seed=0):
    """The same values on both sides: bf16 rounding happens once, in torch,
    and crosses to JAX exactly through fp32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    x[..., 0] *= 25.0  # an outlier channel
    t = torch.as_tensor(x).to(dtype)
    j = jnp.asarray(t.float().numpy())
    return t, (j.astype(jnp.bfloat16) if dtype == torch.bfloat16 else j)


def _close(got, want, rel=1e-5):
    """fp32 sums of exact products (bf16 x bf16 is exact in fp32) in another
    order: within 1e-5 of the largest entry."""
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_gram_accumulate_matches_pallas_interpret(shape, dtype):
    t, j = _inputs(shape, dtype)
    g, a = gram_accumulate(t)
    assert g.dtype == a.dtype == torch.float32
    assert g.shape == (shape[-1], shape[-1]) and a.shape == (shape[-1],)
    want = jax_gram_accumulate(j, block_n=16, block_t=32, interpret=True)
    _close(t2np(g), want)
    _close(t2np(a), np.abs(np.asarray(j, np.float64)).reshape(-1, shape[-1]).sum(0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES[:3])
def test_gram_update_matches_reference(shape, dtype):
    t, j = _inputs(shape, dtype, seed=1)
    g, a, c = gram_update(t)
    wg, wa, wc = jax_gram_update(j)
    _close(t2np(g), wg)
    _close(t2np(a), wa)
    assert c == float(wc) == float(np.prod(shape[:-1]))


def test_accumulate_taps_matches_reference_with_telemetry():
    """Stacked and unstacked taps fold into the same GramStore keys, sums
    and counts, and both telemetries count the same rows per tap."""
    rng = np.random.default_rng(2)
    shapes = {"g0/rep0/sub0.attn.in": (2, 5, 12), "g0/rep1/sub0.attn.in": (2, 5, 12),
              "final.out_in": (2, 5, 12), "g0/rep1/sub0.mlp.mid": (2, 5, 20)}
    arrays = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    jstore, jtel = JaxGramStore(), JaxTelemetry()
    tstore, ttel = GramStore(), CompressionTelemetry()
    for _ in range(2):
        jax_accumulate_taps(jstore, {k: jnp.asarray(v) for k, v in arrays.items()},
                            telemetry=jtel)
        accumulate_taps(tstore, {k: torch.as_tensor(v) for k, v in arrays.items()},
                        telemetry=ttel)
    assert set(tstore.keys()) == set(jstore.keys())
    for k in jstore.keys():
        _close(tstore.gram(k).numpy(), jstore.gram(k))
        _close(tstore.absmean(k).numpy(), jstore.absmean(k))
        assert tstore.count(k) == jstore.count(k)
    assert ttel.calib_batches.value == jtel.calib_batches.value == 2
    assert (ttel.metrics.snapshot()["compress_calib_rows_total"]
            == jtel.metrics.snapshot()["compress_calib_rows_total"])


@pytest.mark.parametrize("family", ["small-opt", "small-llama"])
def test_collect_grams_key_sets_match_reference(family):
    """A tiny model calibrated on both sides: the same Gram keys (per layer
    and shared), counts, and Grams within fp32 tolerance."""
    jcfg, tcfg = tiny_cfgs(family, num_layers=3, d_model=24, d_ff=40)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(7))
    rng = np.random.default_rng(8)
    batches = [rng.integers(0, jcfg.vocab_size, (3, 17)).astype(np.int32) for _ in range(2)]
    want = jax_collect_grams(jmodel, jparams, [{"tokens": jnp.asarray(b)} for b in batches])
    got = collect_grams(build_model(tcfg), to_t(jparams), batches)
    assert set(got.keys()) == set(want.keys())
    assert any(k.endswith("/2") for k in got.keys())  # per-layer keys of the stack
    for k in want.keys():
        assert got.count(k) == want.count(k)
        _close(got.gram(k).numpy(), want.gram(k))


@pytest.mark.parametrize("offset", [0, 2, 8, 16, 48])
@pytest.mark.parametrize("n", [8, 12, 2048, 4100, 14336, 10, 4102])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gram_route(dtype, n, offset):
    """Rows starting 16-byte aligned take a tensor-core kernel: bf16 the
    mma kernel at a width that is a multiple of 8, fp32 the tf32x3 kernel
    at a multiple of 4; other widths and misaligned starts take the FMA
    kernel."""
    want = "fma"
    if offset % 16 == 0 and dtype == torch.bfloat16 and n % 8 == 0:
        want = "mma"
    elif offset % 16 == 0 and dtype == torch.float32 and n % 4 == 0:
        want = "tf32x3"
    assert gram_ops.route(dtype, n, 0x7f0000000000 + offset) == want


# (rows, n, batch): calibration taps of the paths (llava's fp32
# ``projector.in``, whisper's encoder width, small-llama's widths, Mistral's
# d_ff), a MoE layer's per-expert buffers, ragged and tiny taps.
SPLIT_CASES = [(9216, 1024, 1), (24000, 768, 1), (2048, 128, 1), (2048, 352, 1),
               (2048, 14336, 1), (240, 2048, 64), (2048, 256, 4), (520, 128, 1),
               (777, 136, 1), (5, 256, 1), (0, 128, 1), (12, 32, 8)]


H100_SMS = 132  # the SMs plan_splits plans for on the H100


def _split_rows(rows, splits):
    """[(start, stop)] of each split, as csrc/gram.cu's gram_tf32x3 takes
    them: split s has rows [s R / S, (s + 1) R / S)."""
    return [(s * rows // splits, (s + 1) * rows // splits) for s in range(splits)]


@pytest.mark.parametrize("rows,n,batch", SPLIT_CASES)
def test_gram_split_plan_covers_rows(rows, n, batch):
    """The splits cover every row once, in order; a plan of more than one
    split keeps each at MIN_SPLIT_ROWS rows or more; and the grid stays
    within MAX_BLOCKS_PER_SM (4) blocks an SM of the H100."""
    s = gram_ops.plan_splits(rows, n, batch, H100_SMS)
    assert s >= 1
    spans = _split_rows(rows, s)
    assert [r for a, b in spans for r in range(a, b)] == list(range(rows))
    if s > 1:
        assert min(b - a for a, b in spans) >= gram_ops.MIN_SPLIT_ROWS
        assert gram_ops.upper_tiles(n) * batch * s <= gram_ops.MAX_BLOCKS_PER_SM * H100_SMS


@pytest.mark.parametrize("rows,n", [(9216, 1024), (24000, 768)])
def test_gram_split_plan_fills_the_card(rows, n):
    """llava's ``projector.in`` and whisper's encoder taps: at least two
    blocks on each of the H100's 132 SMs."""
    assert gram_ops.upper_tiles(n) * gram_ops.plan_splits(rows, n, 1, H100_SMS) >= 2 * H100_SMS


@pytest.mark.parametrize("rows,n", [(5, 256), (127, 1024), (1, 8)])
def test_gram_split_plan_keeps_a_small_tap_whole(rows, n):
    assert gram_ops.plan_splits(rows, n, 1, H100_SMS) == 1


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 (10 mantissa bits), rounded to nearest with ties away
    from zero, as the card's cvt.rna.tf32.f32."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _gram_tf32(x: torch.Tensor, passes: int) -> torch.Tensor:
    """The tf32x3 kernel's arithmetic on the CPU: hi = tf32(x), lo =
    tf32(x - hi); each 8 rows' lo_i hi_j + hi_i lo_j + hi_i hi_j (passes 3)
    or hi_i hi_j alone (passes 1, a single-pass TF32 Gram) summed exactly
    and truncated once to fp32 (rounded toward zero: the tensor cores' adds
    truncate, perhaps at more steps than this one), then added into a
    running fp32 sum in row order with round-to-nearest adds."""
    n = x.shape[-1]
    x = x.reshape(-1, n).float()
    x = torch.cat([x, x.new_zeros((-x.shape[0] % 8, n))])
    hi = _tf32(x)
    lo = _tf32(x - hi)
    h, lw = (t.double().reshape(-1, 8, n) for t in (hi, lo))
    part = h.transpose(1, 2) @ h
    if passes == 3:
        part += lw.transpose(1, 2) @ h + h.transpose(1, 2) @ lw
    near = part.float()
    part = torch.where(near.double().abs() > part.abs(), torch.nextafter(near, torch.zeros(())),
                       near)
    total = torch.zeros((n, n))
    for p in part:
        total += p
    return total


def _gate_inputs(shape, seed):
    """randn rows with every 97th channel scaled by 20, as the card's gram
    phase makes them."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x[:, ::97] *= 20.0
    return x


@pytest.mark.parametrize("shape", [(2048, 256), (600, 136)])
def test_gram_tf32x3_within_fp64_gate(shape):
    """3xTF32, emulated, holds to the card's gate: its per-element error
    against an fp64 Gram at most GRAM_GATE times that of the reference's
    fp32 Gram (the Pallas kernel in interpret mode); and it matches that
    Gram within GRAM_ELEM_TOL."""
    x = _gate_inputs(shape, 11)
    g64 = torch.as_tensor(x.astype(np.float64).T @ x.astype(np.float64))
    want = torch.as_tensor(np.array(jax_gram_accumulate(
        jnp.asarray(x), block_n=128, block_t=256, interpret=True)))
    got = _gram_tf32(torch.as_tensor(x), passes=3)
    ref_err = gram_ref.gram_elem_err(want, g64)
    assert 0 < ref_err < 1e-6
    assert gram_ref.gram_elem_err(got, g64) <= chip_smoke.GRAM_GATE * ref_err
    assert gram_ref.gram_elem_err(got, want) <= chip_smoke.GRAM_ELEM_TOL
    assert torch.equal(got, got.T)


@pytest.mark.parametrize("shape", [(2048, 256), (600, 136)])
def test_gram_single_tf32_fails_the_gate_only(shape):
    """Why the gate exists: a single-pass TF32 Gram passes the per-element
    check against the plain version (GRAM_ELEM_TOL) but not the fp64 gate."""
    x = _gate_inputs(shape, 11)
    g64 = torch.as_tensor(x.astype(np.float64).T @ x.astype(np.float64))
    want = torch.as_tensor(np.array(jax_gram_accumulate(
        jnp.asarray(x), block_n=128, block_t=256, interpret=True)))
    got = _gram_tf32(torch.as_tensor(x), passes=1)
    assert gram_ref.gram_elem_err(got, want) <= chip_smoke.GRAM_ELEM_TOL
    assert gram_ref.gram_elem_err(got, g64) > chip_smoke.GRAM_GATE * gram_ref.gram_elem_err(
        want, g64)


def test_gram_elem_scale_and_err_match_numpy():
    """The per-element check's scale is sqrt(G_ii G_jj); its error is the
    largest |got - want| over that scale, 0 where both are 0."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((40, 12)).astype(np.float32)
    x[:, 3] *= 25.0
    x[:, 7] = 0.0  # a channel that is all zeros
    want = x.T.astype(np.float64) @ x
    d = np.sqrt(np.diag(want))
    np.testing.assert_allclose(gram_ref.gram_elem_scale(torch.as_tensor(want)).numpy(),
                               np.outer(d, d), rtol=1e-6)
    got = want.copy()
    got[2, 5] += 1e-3
    got[7, 7] = 0.0
    err = gram_ref.gram_elem_err(torch.as_tensor(got), torch.as_tensor(want))
    np.testing.assert_allclose(err, 1e-3 / (d[2] * d[5]), rtol=1e-4)
    assert gram_ref.gram_elem_err(torch.as_tensor(want), torch.as_tensor(want)) == 0.0
