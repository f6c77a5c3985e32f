"""The calibration GramStore in host memory (``grams_on="host"``) against
the one-pass store on the params' device and the reference's GramStore:
the layer groups it is filled in, the keys (per layer, per expert and
shared), ``fallback`` / ``min_count``, the npz files both ways,
``compress_params`` reading one Gram at a time onto the params' device,
the telemetry's rows, and the serve CLI's memory reckoning for each home.

Tolerances: a layer's or an expert's keys are bit-identical between the
homes (the same fp64 adds in the same batch order on the same device); a
shared key summed over layers adds its groups' partial sums in another
order, so it agrees within 1e-12 of its largest entry; against the
reference, the existing gram parity tests' 1e-5 (fp32 Grams of fp32 sums
in another order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import tiny_cfgs, to_t

from repro.calib.runner import collect_grams as jax_collect_grams
from repro.configs import get_config as jax_get_config
from repro.core import GramStore as JaxGramStore
from repro.models import build_model as jax_build_model
from repro_torch.calib.gram import tap_layer
from repro_torch.calib.runner import collect_grams
from repro_torch.checkpoint.checkpointer import flatten
from repro_torch.configs import MISTRAL_7B, get_config
from repro_torch.core import CompressionConfig, GramStore, build_plan, compress_params
from repro_torch.launch.compress_shapes import calibration_bytes, gram_groups, gram_layers
from repro_torch.launch.serve import fit_error, run_bytes
from repro_torch.models import build_model
from repro_torch.obs.compression import CompressionTelemetry

SHARED_REL = 1e-12
REF_REL = 1e-5


def _moe_cfgs():
    return (jax_get_config("moonshot-v1-16b-a3b").reduced(),
            get_config("moonshot-v1-16b-a3b").reduced())


MODELS = {"small-llama": lambda: tiny_cfgs("small-llama", num_layers=3, d_model=24, d_ff=40),
          "moe": _moe_cfgs}


def _setup(name, n_batches=3):
    jcfg, tcfg = MODELS[name]()
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(3))
    rng = np.random.default_rng(11)
    batches = [rng.integers(0, jcfg.vocab_size, (4, 16)).astype(np.int32)
               for _ in range(n_batches)]
    return jmodel, jparams, build_model(tcfg), to_t(jparams), batches


def _own_keys(store):
    """A layer's and an expert's keys (those with a layer index)."""
    return [k for k in store.keys() if k.rsplit("/", 1)[-1].isdigit()]


def _one_layer(model) -> int:
    return max(gram_layers(model)["layers"].values())


@pytest.mark.parametrize("name", list(MODELS))
def test_host_store_in_layer_groups_equals_the_one_pass_store(name):
    """One layer a group: every layer's (and expert's) keys bit-identical to
    the one-pass device store's, the shared keys within SHARED_REL, the
    counts equal; the host store's home is the CPU."""
    _, _, model, params, batches = _setup(name)
    one = collect_grams(model, params, batches)
    host = collect_grams(model, params, batches, grams_on="host",
                         group_bytes=_one_layer(model))
    layers = list(gram_layers(model)["layers"])
    assert host.device == torch.device("cpu") and one.groups == 1
    assert host.groups == len(layers) > 1
    assert set(host.keys()) == set(one.keys())
    own = _own_keys(one)
    assert own and (name != "moe" or any("expert_buf/" in k for k in own))
    for k in one.keys():
        assert host.count(k) == one.count(k), k
        if k in own:
            assert torch.equal(host.gram(k), one.gram(k)), k
            assert torch.equal(host.absmean(k), one.absmean(k)), k
        else:
            for got, want in ((host.gram(k), one.gram(k)), (host.absmean(k), one.absmean(k))):
                assert float((got - want).abs().max()) <= SHARED_REL * float(want.abs().max()), k
    assert host.nbytes() == one.nbytes() == calibration_bytes(model)["grams"]


def test_one_group_is_bit_identical_shared_keys_included():
    """Without a budget on the CPU the host store is one group: every key,
    the shared ones too, equals the one-pass store's bit for bit."""
    _, _, model, params, batches = _setup("moe", n_batches=2)
    one = collect_grams(model, params, batches)
    host = collect_grams(model, params, batches, grams_on="host")
    assert host.groups == 1
    for k in one.keys():
        assert torch.equal(host.gram(k), one.gram(k)), k
        assert torch.equal(host.absmean(k), one.absmean(k)), k


@pytest.mark.parametrize("name", list(MODELS))
def test_both_homes_equal_the_reference_store(name):
    """The host store (in groups) and the device store against the
    reference's GramStore on the same batches: keys, counts, Grams and
    absmeans within REF_REL of the largest entry."""
    jmodel, jparams, model, params, batches = _setup(name)
    want = jax_collect_grams(jmodel, jparams, [{"tokens": jnp.asarray(b)} for b in batches])
    for got in (collect_grams(model, params, batches),
                collect_grams(model, params, batches, grams_on="host",
                              group_bytes=_one_layer(model))):
        assert set(got.keys()) == set(want.keys())
        for k in want.keys():
            assert got.count(k) == want.count(k), k
            for g, w in ((got.gram(k), want.gram(k)), (got.absmean(k), want.absmean(k))):
                w = np.asarray(w, np.float64)
                np.testing.assert_allclose(g.numpy(), w, rtol=REF_REL,
                                           atol=REF_REL * max(np.abs(w).max(), 1e-30),
                                           err_msg=k)


def test_fallback_and_min_count_resolve_the_same_keys():
    """Every expert key at min_count thresholds from 0 past the largest
    count: the host store, the device store and the reference's resolve
    it to the same key for the same reason, and ``gram`` / ``absmean``
    read the same statistics on both homes."""
    jmodel, jparams, model, params, batches = _setup("moe")
    ref = jax_collect_grams(jmodel, jparams, [{"tokens": jnp.asarray(b)} for b in batches])
    one = collect_grams(model, params, batches)
    host = collect_grams(model, params, batches, grams_on="host",
                         group_bytes=_one_layer(model))
    experts = [k for k in one.keys() if "expert_" in k and k.rsplit("/", 1)[-1].isdigit()]
    counts = sorted({one.count(k) for k in experts})
    assert len(counts) > 1  # some experts see fewer rows than others
    fallbacks = 0
    for mc in [0, *counts, counts[-1] + 1]:
        for k in experts:
            base = k.rsplit("/", 2)[0]
            got = host.resolve(k, base, mc)
            assert got == one.resolve(k, base, mc) == ref.resolve(k, base, mc), (k, mc)
            fallbacks += got[1] is not None
            for name in ("gram", "absmean"):
                h, o = (getattr(s, name)(k, base, mc) for s in (host, one))
                if got[1] is None:  # the expert's own key
                    assert torch.equal(h, o), (k, mc)
                else:  # the shared key, summed over the layers' groups
                    assert float((h - o).abs().max()) <= SHARED_REL * float(o.abs().max())
    assert fallbacks > 0
    with pytest.raises(KeyError):
        host.gram("g1/sub0.moe.expert_buf/1/99", fallback="absent")


def test_npz_round_trips_between_the_homes_and_the_reference(tmp_path):
    """The host store saved reads back bit for bit into either home and
    into the reference's GramStore; the reference's file reads into a host
    store as the reference reads it; ``load`` keeps the home asked for."""
    jmodel, jparams, model, params, batches = _setup("moe", n_batches=2)
    host = collect_grams(model, params, batches, grams_on="host",
                         group_bytes=_one_layer(model))
    path = str(tmp_path / "host.npz")
    host.save(path)
    back = GramStore.load(path, device="cpu")
    assert back.device == torch.device("cpu") and set(back.keys()) == set(host.keys())
    ref_back = JaxGramStore.load(path)
    for k in host.keys():
        assert torch.equal(back.gram(k), host.gram(k)) and back.count(k) == host.count(k)
        assert torch.equal(back.absmean(k), host.absmean(k))
        np.testing.assert_array_equal(np.asarray(ref_back.gram(k)), host.gram(k).numpy())
        np.testing.assert_array_equal(np.asarray(ref_back.absmean(k)),
                                      host.absmean(k).numpy())
    ref = jax_collect_grams(jmodel, jparams, [{"tokens": jnp.asarray(b)} for b in batches])
    ref_path = str(tmp_path / "ref.npz")
    ref.save(ref_path)
    from_ref = GramStore.load(ref_path, device="cpu")
    for k in ref.keys():
        np.testing.assert_array_equal(from_ref.gram(k).numpy(), np.asarray(ref.gram(k)))
        np.testing.assert_array_equal(from_ref.absmean(k).numpy(), np.asarray(ref.absmean(k)))
        assert from_ref.count(k) == ref.count(k)


def test_compress_params_reads_one_gram_at_a_time_onto_the_params_device(monkeypatch):
    """``compress_params`` from a host store asks for every Gram and
    absmean one key at a time on the kernel's device, puts every factor
    on the params' device, and gives the factors the one-pass store
    gives (the per-layer keys it reads are equal)."""
    _, _, model, params, batches = _setup("moe")
    one = collect_grams(model, params, batches)
    host = collect_grams(model, params, batches, grams_on="host",
                         group_bytes=_one_layer(model))
    plan = build_plan(model.compressible_targets(), CompressionConfig(
        method="nsvd1", ratio=0.2, dtype="float32", use_randomized=False, min_dim=8))
    reads = []
    for name in ("gram", "absmean"):
        real = getattr(GramStore, name)

        def spy(self, key, *a, _real=real, _name=name, **kw):
            reads.append((_name, key, kw.get("device")))
            return _real(self, key, *a, **kw)
        monkeypatch.setattr(GramStore, name, spy)
    got = compress_params(params, plan, host)
    monkeypatch.undo()
    want = compress_params(params, plan, one)
    assert reads and all(dev == torch.device("cpu") for _, _, dev in reads)
    assert len(reads) == 2 * sum(int(np.prod(t.stacked or (1,))) for t in plan.targets)
    a, b = flatten(got), flatten(want)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].device == params["embed"]["table"].device, k
        assert torch.equal(a[k], b[k]), k


def test_host_calibration_telemetry_counts_the_one_pass_rows():
    """The calibration telemetry of a host store in groups: the same batch
    count, rows per tap and per-key statistics as the one-pass store's."""
    _, _, model, params, batches = _setup("small-llama")
    one_tel, host_tel = CompressionTelemetry(), CompressionTelemetry()
    collect_grams(model, params, batches, telemetry=one_tel)
    collect_grams(model, params, batches, telemetry=host_tel, grams_on="host",
                  group_bytes=_one_layer(model))
    assert host_tel.calib_batches.value == one_tel.calib_batches.value == len(batches)
    snap = "compress_calib_rows_total"
    assert host_tel.metrics.snapshot()[snap] == one_tel.metrics.snapshot()[snap]
    assert host_tel.calib.keys() == one_tel.calib.keys()
    for k, stats in one_tel.calib.items():
        assert host_tel.calib[k]["samples"] == stats["samples"]
        assert host_tel.calib[k]["absmean_max"] == pytest.approx(stats["absmean_max"], rel=1e-12)


def test_collect_grams_refuses_an_unknown_home():
    _, _, model, params, batches = _setup("small-llama", n_batches=1)
    with pytest.raises(ValueError, match="grams_on"):
        collect_grams(model, params, batches, grams_on="disk")


def test_gram_groups_split_mistral_7b_in_forward_order():
    """mistral-7b at 32 layers on meta tensors: 2.05 GB of Grams a layer
    (three 4096-wide taps and the 14336-wide down input), 2.18 GB of shared
    keys; groups in forward order within the budget, and a budget under
    one layer refused."""
    model = build_model(MISTRAL_7B)
    layers = gram_layers(model)
    per = 8 * (3 * (4096 ** 2 + 4096) + 14336 ** 2 + 14336)
    assert layers["layers"] == {f"g0/rep{i}": per for i in range(32)}
    assert layers["shared"] == per + 8 * (4096 ** 2 + 4096)  # final.out_in
    assert calibration_bytes(model)["grams"] == 32 * per + layers["shared"]
    groups = gram_groups(model, 58e9)
    assert [g for grp in groups for g in grp] == list(layers["layers"])
    assert [len(g) for g in groups] == [28, 4]
    assert len(gram_groups(model, float("inf"))) == 1
    with pytest.raises(ValueError, match="over the"):
        gram_groups(model, per - 1)
    assert tap_layer("g0/rep17/sub0.mlp.in") == "g0/rep17" and tap_layer("final.out_in") is None


def test_run_bytes_and_fit_error_name_the_host_home_for_full_mistral_7b():
    """mistral-7b at 32 layers, nsvd1 0.2, 80 GB free (on meta tensors): with
    the Grams on the device the run needs 114.40 GB and does not fit; in
    host memory it needs the weights and the larger of one calibration
    group (the shared keys, one layer's and a tap's fp32 Gram) and the
    compression (with one Gram on the card), 48.35 GB, and fits.  The
    refusal names the host home before a cut; a run that fits neither way
    is told to cut."""
    free = 80 * 10 ** 9
    dev, what = run_bytes(MISTRAL_7B, [0.2])
    host, host_what = run_bytes(MISTRAL_7B, [0.2], "host")
    assert dev == 114_396_094_464 and "calibration Grams 67.69" in what
    assert host == 48_354_025_472 and "67.69 of Grams in host memory" in host_what
    assert fit_error(MISTRAL_7B, [0.2], free, "host") is None
    err = fit_error(MISTRAL_7B, [0.2], free)
    assert "114.40 GB" in err and "--grams-on host" in err and "48.35 GB" in err
    assert err.index("--grams-on host") < err.index("--layers")
    tight = fit_error(MISTRAL_7B, [0.2], 40 * 10 ** 9)
    assert "--grams-on" not in tight and "--layers" in tight
    assert "--layers" in fit_error(MISTRAL_7B, [0.2], 40 * 10 ** 9, "host")
    # Uncompressed runs hold no Grams: the home changes nothing.
    assert run_bytes(MISTRAL_7B, [], "host") == run_bytes(MISTRAL_7B, [])
    # Two layers fit either way.
    two = dataclasses.replace(MISTRAL_7B, num_layers=2)
    assert fit_error(two, [0.2], free) is None and fit_error(two, [0.2], free, "host") is None


def test_chip_homes_check_passes_on_a_tiny_model():
    """chip_smoke's full_depth step that holds the two homes to each other
    (at mistral-7b depth 2 on the card), here on a tiny Mistral on the
    CPU: two groups, layer keys and params bit-identical."""
    import chip_smoke as cs

    cfg = dataclasses.replace(tiny_cfgs("small-mistral", num_layers=cs.HOMES_LAYERS)[1],
                              dtype="float32")
    got = cs.gram_homes_check(torch, np, cfg, device="cpu")
    assert got["ok"] and got["groups"] == cs.HOMES_LAYERS == 2
    assert got["own_equal"] and got["params_equal"] and got["own_keys"] > 0
    assert got["shared_max_rel"] <= cs.HOMES_SHARED_REL


def test_serve_cli_names_the_host_home_when_only_it_fits(monkeypatch, capsys):
    """``--arch mistral-7b --no-reduced --compress 0.2`` on a card with 80 GB
    free: the CLI refuses the device home before it allocates anything and
    names ``--grams-on host`` (48.35 GB) before a cut; with 40 GB free it
    asks for a cut whatever the home."""
    from repro_torch.launch.serve import main as serve_main

    for free, argv, want, unwanted in (
            (80 * 10 ** 9, [], "--grams-on host keeps the Grams in host memory", None),
            (40 * 10 ** 9, ["--grams-on", "host"], "cut it with --layers", "--grams-on")):
        monkeypatch.setattr(torch.cuda, "mem_get_info", lambda *a, f=free: (f, 85 * 10 ** 9))
        with pytest.raises(SystemExit):
            serve_main(["--arch", "mistral-7b", "--no-reduced", "--compress", "0.2", *argv])
        err = capsys.readouterr().err
        assert want in err and "mistral-7b at 32 layers needs" in err, err
        assert unwanted is None or unwanted not in err.split("free;")[-1]
