"""Port parity for the calibration Gram: the port's ``gram_accumulate``
(its plain version on the CPU) and ``gram_update`` against the reference's
Pallas kernel in interpret mode and its ``calib.gram.gram_update``, on the
same numpy-seeded inputs, ragged rows and widths included; and the
calibration telemetry's per-batch rows against the reference's."""

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
@pytest.mark.parametrize("n", [8, 12, 2048, 4100, 14336])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gram_route(dtype, n, offset):
    """bf16 rows of a width that is a multiple of 8, starting 16-byte
    aligned, take the mma kernel; fp32 rows, other widths and misaligned
    starts take the FMA kernel."""
    want = "mma" if dtype == torch.bfloat16 and n % 8 == 0 and offset % 16 == 0 else "fma"
    assert gram_ops.route(dtype, n, 0x7f0000000000 + offset) == want


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
