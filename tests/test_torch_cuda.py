"""Card-only checks of the port's CUDA kernels against their plain PyTorch
versions, and of a served stream with the kernels against the same stream
through the plain versions.  CUDA kernels have no CPU mode, so every test
here is marked ``cuda`` and skips without a card.  Imports neither jax nor
repro, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.calib.runner import collect_grams
from repro_torch.configs import MISTRAL_7B, small_lm
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.gram import ops as gram_ops
from repro_torch.kernels.gram import ref as gram_ref
from repro_torch.kernels.nested_lowrank import ops as nlr_ops
from repro_torch.kernels.nested_lowrank import ref as nlr_ref
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention import ref as pa_ref
from repro_torch.models import build_model
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
    assert _err(got, nlr_ref.nested_lowrank_matmul_ref(x, u, v, u2, v2)) < NESTED_TOL[dtype]


def test_nested_rows_above_gate_use_plain_matmuls(dev):
    x = torch.randn((1025, 64), device=dev)
    f = [torch.randn(s, device=dev) for s in ((64, 8), (8, 32), (64, 2), (2, 32))]
    before = nlr_ops.launches
    nlr_ops.nested_lowrank_matmul(x, *f)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,n", [(64, 128), (77, 200), (2048, 4096), (5, 1)])
def test_gram_kernel_matches_plain(dev, rows, n, dtype):
    """Ragged rows and n included.  Tolerance: fp32 sums in another order
    (bf16 products are exact in fp32), 1e-5 of the largest entry."""
    g = torch.Generator(device=dev).manual_seed(rows + n)
    x = torch.randn((rows, n), generator=g, device=dev).to(dtype)
    x[:, n // 2] *= 30.0  # an outlier channel
    before = gram_ops.launches
    got_g, got_a = gram_ops.gram_accumulate(x.reshape(1, rows, n))
    torch.cuda.synchronize()
    assert gram_ops.launches == before + 1
    want_g, want_a = gram_ref.gram_accumulate_ref(x)
    assert _err(got_g, want_g) < 1e-5
    assert _err(got_a, want_a) < 1e-5
    assert torch.equal(got_g, got_g.T)


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
    assert _err(got, fa_ref.flash_attention_ref(q, k, v)) < tol


def test_flash_kernel_rejects_bad_head_dim(dev):
    q = torch.zeros((1, 4, 2, 12), device=dev)
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, q[:, :, :1].contiguous(), q[:, :, :1].contiguous())


def test_calibration_runs_through_gram_and_flash(dev):
    """collect_grams on a CUDA model launches gram once per tap and batch
    and flash_attention once per layer and batch, and its Grams match the
    same calibration through the plain versions."""
    cfg = small_lm("card-calib", MISTRAL_7B, num_layers=2, d_model=64, d_ff=96,
                   vocab_size=128, num_heads=8)
    model = build_model(cfg)
    params = model.init(0, dev)
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 128, (4, 40)).astype(np.int32) for _ in range(3)]
    g0, f0 = gram_ops.launches, fa_ops.launches
    store = collect_grams(model, params, batches)
    assert gram_ops.launches - g0 == 3 * (4 * cfg.num_layers + 1)
    assert fa_ops.launches - f0 == 3 * cfg.num_layers
    with kernels.plain():
        plain = collect_grams(model, params, batches)
    assert set(store.keys()) == set(plain.keys())
    for key in store.keys():
        assert _err(store.gram(key), plain.gram(key)) < 1e-5


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
