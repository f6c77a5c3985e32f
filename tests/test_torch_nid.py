"""Port parity for the rest of the paper's compressors: the column ID and
NID-I/II, ASVD-III, ``compress_model``, the svd/asvd helpers, the
shape-level compression and the public API, against the JAX reference on
the same numpy-seeded inputs (all on the CPU, in float64 where the
reference is)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import t2np, tiny_cfgs, to_np, to_t

import repro.core as jax_core
import repro_torch.core as core
from repro.calib.runner import collect_grams as jax_collect_grams
from repro.checkpoint.checkpointer import save_checkpoint as jax_save_checkpoint
from repro.core.asvd import activation_loss as jax_activation_loss
from repro.core.asvd import gram_loss as jax_gram_loss
from repro.core.lowrank import dense_equivalent as jax_dense_equivalent
from repro.core.nid import column_id as jax_column_id
from repro.core.nsvd import nsvd_compress as jax_nsvd_compress
from repro.core.whitening import make_gamma_whitener as jax_make_gamma_whitener
from repro.launch.compress_shapes import compressed_param_shapes as jax_compressed_param_shapes
from repro.models import build_model as jax_build_model
from repro_torch import bridge
from repro_torch.core.asvd import asvd_compress, gram_loss
from repro_torch.core.lowrank import dense_equivalent
from repro_torch.core.nid import column_id, id_compress
from repro_torch.core.nsvd import nsvd_compress
from repro_torch.core.svd import frobenius, low_rank_storage, max_rank_for_budget
from repro_torch.core.whitening import make_gamma_whitener, make_whitener
from repro_torch.launch.compress_shapes import compressed_param_shapes
from repro_torch.models import build_model
from repro_torch.obs.compression import NULL_COMPRESSION_TELEMETRY


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def _id_case(case):
    """(matrix, k) of a column-ID case."""
    rng = np.random.default_rng(len(case))
    shapes = {"tall": (96, 64, 8), "wide": (64, 160, 12), "square": (48, 48, 20),
              "k_full": (48, 48, 48), "k_above_min": (30, 40, 50), "k_zero": (20, 10, 0),
              "deep": (200, 120, 30), "zero_first_row": (40, 30, 10),
              "zero_columns": (12, 8, 8)}
    m, n, k = shapes[case]
    a = rng.standard_normal((m, n)) * np.exp(-np.arange(n) / 20.0)
    if case == "zero_first_row":
        a[0] = 0.0  # the first reflector sees x[0] == 0 (sign(0) is 0)
    if case == "zero_columns":
        a[:, [1, 4, 5, 7]] = 0.0  # norms reach 0: the 1e-300 branch
    return a, k


ID_CASES = ("tall", "wide", "square", "k_full", "k_above_min", "k_zero", "deep",
            "zero_first_row", "zero_columns")


@pytest.mark.parametrize("case", ID_CASES)
def test_column_id_matches_reference(case):
    """Same pivots; t within 1e-12 of the reference's (relative to max |t|)."""
    a, k = _id_case(case)
    want_cols, want_t = jax_column_id(a, k)
    cols, t = column_id(_t(a), k)
    assert cols.dtype == torch.int64 and t.dtype == torch.float64
    np.testing.assert_array_equal(cols.numpy(), want_cols)
    assert t.shape == want_t.shape
    if want_t.size:
        assert np.abs(t.numpy() - want_t).max() <= 1e-12 * np.abs(want_t).max()


@pytest.mark.parametrize("case", ("tall", "wide", "square", "zero_columns"))
def test_id_compress_keeps_actual_columns(case):
    """C is A's columns bit for bit, and T[:, cols] is exactly I_k."""
    a, k = _id_case(case)
    at = _t(a)
    f = id_compress(at, k)
    cols, _ = column_id(at, k)
    assert f.method == "id" and not f.nested
    assert torch.equal(f.w, at[:, cols])
    assert torch.equal(f.z[:, cols], torch.eye(len(cols), dtype=torch.float64))


def test_column_id_truncation_matches_full_qr():
    """k steps give the same pivots and T as the full factorization, by
    the reference's own full QR."""
    a, _ = _id_case("deep")
    for k in (1, 7, 30):
        want_cols, want_t = jax_column_id(a, k)
        cols, t = column_id(_t(a), k)
        np.testing.assert_array_equal(cols.numpy(), want_cols)
        np.testing.assert_allclose(t.numpy(), want_t, rtol=0, atol=1e-12 * np.abs(want_t).max())


def _problem(seed=0, m=40, n=32, rows=120):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, n))
    x = rng.standard_normal((n, rows)) * np.exp(rng.standard_normal(n))[:, None]
    return a, x, x @ x.T


@pytest.mark.parametrize("k1_frac", (0.8, 1.0))
@pytest.mark.parametrize("variant", ("nid1", "nid2"))
def test_nid_compress_matches_reference(variant, k1_frac):
    """Dense equivalent within 1e-10 relative, the same gram loss and the
    same k1/k2 split (k1_frac 1.0: no residual step, one pair)."""
    a, _, g = _problem()
    want = jax_nsvd_compress(a, 12, g, k1_frac=k1_frac, variant=variant,
                             use_randomized=False)
    got = nsvd_compress(_t(a), 12, _t(g), k1_frac=k1_frac, variant=variant,
                        use_randomized=False)
    assert got.method == want.method == variant
    assert got.nested == want.nested == (k1_frac < 1.0)
    assert got.w.shape == want.w.shape
    if want.nested:
        assert got.w2.shape == want.w2.shape
    wm = want.matrix()
    rel = np.linalg.norm(got.matrix().numpy() - wm) / np.linalg.norm(wm)
    assert rel < 1e-10, rel
    np.testing.assert_allclose(gram_loss(_t(a), got.matrix(), _t(g)),
                               jax_gram_loss(a, wm, g), rtol=1e-10)


def test_nid_residual_is_an_exact_column_id():
    """NID's second pair is C = residual[:, cols] and T with T[:, cols] = I."""
    a, _, g = _problem(seed=3)
    at, gt = _t(a), _t(g)
    f = nsvd_compress(at, 12, gt, k1_frac=0.75, variant="nid1", use_randomized=False)
    first, _ = asvd_compress(at, 9, make_whitener("asvd1", gram=gt), use_randomized=False)
    residual = at - first.matrix()
    cols, t = column_id(residual, 3)
    assert torch.equal(f.w2, residual[:, cols]) and torch.equal(f.z2, t)


def test_gamma_whitener_matches_reference():
    """ASVD-III: the same scalar gamma and rank; factors compared through
    their dense equivalent and gram loss (sign-invariant)."""
    a, _, g = _problem(seed=4)
    want_w = jax_make_gamma_whitener(g, damp=1e-6)
    got_w = make_whitener("asvd3", gram=_t(g))
    assert got_w.method == "asvd3" and got_w.rank == want_w.rank
    np.testing.assert_allclose(
        np.linalg.norm(got_w.s.numpy(), 2), np.linalg.norm(want_w.s, 2), rtol=1e-12)
    want = jax_core.compress(a, 10, "asvd3", gram=g, use_randomized=False)
    got = core.compress(_t(a), 10, "asvd3", gram=_t(g), use_randomized=False)
    wm = want.matrix()
    rel = np.linalg.norm(got.matrix().numpy() - wm) / np.linalg.norm(wm)
    assert rel < 1e-10, rel
    np.testing.assert_allclose(gram_loss(_t(a), got.matrix(), _t(g)),
                               jax_gram_loss(a, wm, g), rtol=1e-10)


def test_gamma_whitener_zero_gram_and_theorem4_bound():
    """An all-zero Gram gives gamma 1 and rank 0; on a real problem the loss
    of dropping direction j is sigma_j * sqrt(v_j (Lam / gamma^2) v_j) <=
    sigma_j (Thm 4(a), as tests/test_core_theorems.py states it)."""
    w0 = make_gamma_whitener(torch.zeros((6, 6), dtype=torch.float64))
    assert w0.rank == 0 and torch.allclose(w0.s @ w0.s_inv, torch.eye(6, dtype=torch.float64))
    a, x, g = _problem(seed=9, m=48, n=32, rows=96)
    at, xt, gt = _t(a), _t(x), _t(g)
    whit = make_gamma_whitener(gt)
    u, s, vt = torch.linalg.svd(whit.apply_right(at), full_matrices=False)
    lam = torch.linalg.eigvalsh(gt).flip(0)
    for j in (0, 5):
        keep = torch.ones(len(s), dtype=torch.bool)
        keep[j] = False
        approx = whit.unapply_right((u[:, keep] * s[keep]) @ vt[keep])
        loss = core.activation_loss(at, approx, xt)
        expected = float(s[j] * torch.sqrt(vt[j] @ (torch.diag(lam) / lam[0]) @ vt[j]))
        np.testing.assert_allclose(loss, expected, rtol=1e-6)
        assert loss <= float(s[j]) + 1e-9


def test_svd_and_asvd_helpers_match_reference():
    a, x, _ = _problem(seed=5)
    b = a + 0.1 * np.random.default_rng(6).standard_normal(a.shape)
    np.testing.assert_allclose(frobenius(_t(a)), jax_core.svd.frobenius(a), rtol=1e-14)
    for m, n, k in ((4096, 14336, 2230), (7, 3, 2)):
        assert low_rank_storage(m, n, k) == jax_core.svd.low_rank_storage(m, n, k)
        for budget in (0, 9, (m + n) * k + 5):
            assert max_rank_for_budget(m, n, budget) == \
                jax_core.svd.max_rank_for_budget(m, n, budget)
    np.testing.assert_allclose(core.activation_loss(_t(a), _t(b), _t(x)),
                               jax_activation_loss(a, b, x), rtol=1e-12)
    f = core.nested_compress(_t(a), 10, "nid1", gram=_t(x @ x.T), k1_frac=0.8,
                             use_randomized=False)
    for dt in (torch.bfloat16, "float32"):
        h = f.astype(dt)
        want = torch.bfloat16 if dt == torch.bfloat16 else torch.float32
        assert {h.w.dtype, h.z.dtype, h.w2.dtype, h.z2.dtype} == {want}
        assert h.method == "nid1" and h.rank == f.rank


def test_public_api_covers_reference():
    def names(mod):
        return {n for n in dir(mod) if not n.startswith("_")}
    assert names(jax_core) <= names(core)
    assert core.ALL_METHODS == jax_core.ALL_METHODS
    assert core.NESTED_METHODS == jax_core.NESTED_METHODS


@pytest.fixture(scope="module")
def calibrated(tmp_path_factory):
    jcfg, tcfg = tiny_cfgs("small-llama", d_model=32, d_ff=48)
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    jparams = jmodel.init(jax.random.key(4))
    rng = np.random.default_rng(8)
    batches = [rng.integers(0, jcfg.vocab_size, (4, 24)).astype(np.int32) for _ in range(3)]
    jgrams = jax_collect_grams(jmodel, jparams, [{"tokens": jnp.asarray(b)} for b in batches])
    path = str(tmp_path_factory.mktemp("grams") / "grams.npz")
    jgrams.save(path)
    return jcfg, jmodel, tmodel, jparams, to_t(jparams), jgrams, path


def _factored(tree, prefix=()):
    if isinstance(tree, dict) and "u" in tree:
        yield prefix, tree
    elif isinstance(tree, dict):
        for key in sorted(tree):
            yield from _factored(tree[key], prefix + (key,))


@pytest.mark.parametrize("method", core.ALL_METHODS)
def test_compress_model_matches_reference(calibrated, method):
    """Plan and execute in one call: equal plans and dense equivalents
    within 1e-5 relative (fp32 factors)."""
    _, jmodel, tmodel, jparams, tparams, jgrams, path = calibrated
    kw = dict(method=method, ratio=0.3, k1_frac=0.8, dtype="float32", use_randomized=False)
    want, jplan = jax_core.compress_model(jparams, jmodel.compressible_targets(), jgrams,
                                          jax_core.CompressionConfig(**kw))
    got, tplan = core.compress_model(tparams, tmodel.compressible_targets(),
                                      core.GramStore.load(path, device="cpu"),
                                      core.CompressionConfig(**kw),
                                      telemetry=NULL_COMPRESSION_TELEMETRY)
    assert tplan.summary() == jplan.summary() and dict(tplan.ranks) == dict(jplan.ranks)
    wl, gl = dict(_factored(to_np(want))), dict(_factored(got))
    assert wl.keys() == gl.keys() and wl
    for name, w in wl.items():
        g = gl[name]
        assert {k: tuple(v.shape) for k, v in g.items()} == {k: v.shape for k, v in w.items()}
        jd = np.asarray(jax_dense_equivalent({k: jnp.asarray(v) for k, v in w.items()}))
        rel = np.linalg.norm(t2np(dense_equivalent(g)) - jd) / np.linalg.norm(jd)
        assert rel < 1e-5, (name, rel)


def _shape_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _shape_leaves(tree[key], prefix + (key,))
    else:
        yield prefix, (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))


@pytest.mark.parametrize("method", core.ALL_METHODS)
def test_compressed_param_shapes_match_reference_and_real(calibrated, method):
    """Meta-tensor shapes equal the reference's ShapeDtypeStructs and the
    shapes compress_params really produces, for every method."""
    _, jmodel, tmodel, jparams, tparams, _, path = calibrated
    jshapes = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), jparams)
    want = jax_compressed_param_shapes(jmodel, jshapes, 0.3, method=method, k1_frac=0.8,
                                       multiple_of=8)
    meta_in = jax.tree.map(lambda x: torch.empty(x.shape, device="meta",
                                                 dtype=getattr(torch, str(x.dtype))), jshapes)
    for src in (tparams, meta_in):
        got = compressed_param_shapes(tmodel, src, 0.3, method=method, k1_frac=0.8,
                                      multiple_of=8)
        assert all(leaf.is_meta for _, leaf in _factored(got) for leaf in leaf.values())
        assert dict(_shape_leaves(got)) == dict(_shape_leaves(want))
    plan = core.build_plan(tmodel.compressible_targets(), core.CompressionConfig(
        method=method, ratio=0.3, k1_frac=0.8, multiple_of=8, dtype="float32",
        use_randomized=False))
    real = core.compress_params(tparams, plan, core.GramStore.load(path, device="cpu"))
    assert dict(_shape_leaves(real)) == dict(_shape_leaves(got))


def test_nid1_checkpoint_from_reference_gives_its_logits(calibrated, tmp_path):
    """A reference nid1-compressed checkpoint, carried across by the
    bridge, gives the reference's logits in the port (fp32 both sides)."""
    jcfg, jmodel, tmodel, jparams, _, jgrams, _ = calibrated
    plan = jax_core.build_plan(jmodel.compressible_targets(), jax_core.CompressionConfig(
        method="nid1", ratio=0.3, k1_frac=0.8, dtype="float32", use_randomized=False))
    cparams = jax_core.compress_params(jparams, plan, jgrams)
    path = str(tmp_path / "nid1")
    jax_save_checkpoint(path, cparams)
    loaded, _ = bridge.load_checkpoint(path, device="cpu")
    assert any("u2" in leaf for _, leaf in _factored(loaded))
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 11))
    want, _, _ = jmodel.apply(cparams, jnp.asarray(tokens, jnp.int32), mode="train")
    got = tmodel.apply(loaded, torch.as_tensor(tokens), mode="train")
    np.testing.assert_allclose(t2np(got), np.asarray(want), rtol=1e-4, atol=1e-4)
