"""Mesh serving on the port's parallelism layer, against the meshless port
engine and the reference's meshless engine: the ports of
``tests/test_sharded_serving.py``'s cases on four gloo ranks spawned once
for the module (``tests/torch_mesh_ranks.py`` runs every scenario in them;
this file checks their results).

The reference's (2, 2) cases need ``XLA_FLAGS=--xla_force_host_platform_
device_count=4`` and skip without it; these need no flag.  The same
weights (the reference's tiny LLaMA, dense and NSVD-compressed, with
spread logits, and the reduced RWKV-6) go to both packages as numpy
arrays; the reference's streams are computed here, in the parent, while
the ranks run (no rank imports JAX).  Greedy streams equal the reference's
meshless engine's; temperature streams are the port's own sampler's
(ROADMAP: JAX random streams cannot be reproduced in torch), equal to the
meshless port engine's.  Speculative decoding on more than one rank is
refused (ROADMAP A3b) and tested as refused.

Rendezvous through a ``FileStore`` under the test's tmp dir (concurrent
test workers never race for a port); each rank runs one torch thread with
a 60 s process-group timeout; the parent joins with a timeout, kills the
ranks on expiry and fails.
"""

import os
import pickle
import time

import numpy as np
import pytest
import torch

import torch_mesh_ranks
from repro.checkpoint.checkpointer import save_checkpoint as jax_save_checkpoint
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs import paper_models as torch_paper
from repro_torch.models import build_model
from repro_torch.serving.engine import ServingEngine
from torch_parity import tiny_cfgs, tiny_lm, tiny_rwkv, to_np

JOIN_TIMEOUT_S = 240
MESHES = torch_mesh_ranks.MESHES
SHARDED = ("2x2", "1x2", "2x1")


def _ref_serve(model, params, prompts, max_new=6, max_batch=4, **kw):
    eng = JaxEngine(model, params, max_batch=max_batch, max_len=64, **kw)
    uids = [eng.submit(np.asarray(p), max_new_tokens=max_new) for p in prompts]
    out = eng.run()
    return [list(map(int, out[u])) for u in uids]


def _port_serve(model, params, prompts, max_new=6, temperature=0.0, **kw):
    eng = ServingEngine(model, params, max_batch=4, max_len=64, **kw)
    uids = [eng.submit(p, max_new_tokens=max_new, temperature=temperature) for p in prompts]
    out = eng.run()
    return [out[u] for u in uids]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Spawn the four ranks, compute the meshless streams (the port's and
    the reference's) meanwhile, and collect the ranks' results."""
    workdir = tmp_path_factory.mktemp("mesh_ranks")
    jcfg, tcfg = tiny_cfgs("small-llama", d_model=32, d_ff=48, vocab=64)
    jm, jdense, tm, tdense = tiny_lm("dense")
    _, jnsvd, _, tnsvd = tiny_lm("nsvd1")
    jr, jrwkv, rm, trwkv = tiny_rwkv("dense")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(2, 60, size=n) for n in (6, 9, 5, 7)]
    rwkv_prompts = [rng.integers(2, 200, size=n) for n in (5, 6)]
    # The checkpoints the ranks restore: saved meshless by each package.
    CheckpointManager(str(workdir / "ckpt_port"), async_save=False).save(0, tdense)
    jax_save_checkpoint(str(workdir / "ckpt_reference" / "step_00000000"), jdense)
    mistral = torch_paper.small_lm(family_of=torch_paper.MISTRAL_7B, name="small-mistral",
                                   num_layers=2, d_model=32, d_ff=48, vocab_size=64,
                                   num_heads=4)  # 4 / 1 heads: a model axis of 2 splits no KV head
    inputs = {"models": {"dense": (tcfg, to_np(jdense)), "nsvd1": (tcfg, to_np(jnsvd)),
                         "rwkv": (get_config("rwkv6-1.6b").reduced(), to_np(jrwkv))},
              "prompts": prompts, "rwkv_prompts": rwkv_prompts,
              "indivisible_heads": mistral}
    with open(workdir / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=torch_mesh_ranks.rank_main, args=(r, str(workdir)))
             for r in range(torch_mesh_ranks.WORLD)]
    for p in procs:
        p.start()
    try:
        ref, port = {}, {}
        for kind, jp, tp in (("dense", jdense, tdense), ("nsvd1", jnsvd, tnsvd)):
            for paged in (True, False):
                ref[(kind, paged)] = _ref_serve(jm, jp, prompts, paged=paged)
                for t in (0.0, 0.7):
                    port[(kind, paged, t)] = _port_serve(tm, tp, prompts, temperature=t,
                                                         paged=paged)
        ref["int8"] = _ref_serve(jm, jdense, prompts, paged=True, kv_quant=True)
        ref["rwkv"] = _ref_serve(jr, jrwkv, rwkv_prompts, max_new=3, max_batch=2)
        port["rwkv"] = _port_serve(rm, trwkv, rwkv_prompts, max_new=3)
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
        alive = [p for p in procs if p.is_alive()]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    if alive:
        pytest.fail(f"{len(alive)} rank(s) still running after {JOIN_TIMEOUT_S} s: killed")
    outs = []
    for r in range(torch_mesh_ranks.WORLD):
        path = workdir / f"out_{r}.pkl"
        if not path.exists():
            pytest.fail(f"rank {r} wrote no results (exit code {procs[r].exitcode})")
        with open(path, "rb") as f:
            out = pickle.load(f)
        if out["error"] is not None:
            pytest.fail(f"rank {r} failed:\n{out['error']}")
        outs.append(out["results"])
    return {"ranks": outs, "ref": ref, "port": port, "params": tdense,
            "prompts": prompts}


def _all(world, key):
    """The value every rank reported for ``key`` (asserted equal)."""
    vals = [r[key] for r in world["ranks"]]
    for v in vals[1:]:
        assert v == vals[0], key
    return vals[0]


@pytest.mark.parametrize("kind,t", [("dense", 0.0), ("dense", 0.7), ("nsvd1", 0.0)])
@pytest.mark.parametrize("paged", [True, False])
def test_11_mesh_is_the_meshless_engine(world, kind, paged, t):
    got = _all(world, ("streams", kind, "1x1", paged, t))
    assert got == world["port"][(kind, paged, t)]
    dp_shards, cs, st = _all(world, ("stats", kind, "1x1", paged, t))
    assert dp_shards == 1 and cs["mesh"] == {"dp": 1, "tp": 1, "devices": 1}
    assert cs["per_device_cache_hbm_bytes"] == cs["cache_hbm_bytes"]
    assert _all(world, ("collectives", kind, "1x1", paged, t)) == {
        ("all_gather", "data"): st["host_syncs"]}


@pytest.mark.parametrize("mesh", SHARDED)
@pytest.mark.parametrize("kind", ["dense", "nsvd1"])
@pytest.mark.parametrize("paged", [True, False])
def test_greedy_streams_equal_both_meshless_engines(world, mesh, kind, paged):
    got = _all(world, ("streams", kind, mesh, paged, 0.0))
    assert got == world["port"][(kind, paged, 0.0)] == world["ref"][(kind, paged)]


@pytest.mark.parametrize("mesh", SHARDED)
@pytest.mark.parametrize("paged", [True, False])
def test_temperature_streams_equal_meshless_port_engine(world, mesh, paged):
    assert _all(world, ("streams", "dense", mesh, paged, 0.7)) == \
        world["port"][("dense", paged, 0.7)]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("kind", ["dense", "nsvd1"])
def test_collectives_as_the_mesh_needs(world, mesh, kind):
    """One data-group gather a host sync at every group size; TP
    collectives only with a model axis of 2, where the factored nested
    layers take the split route (rank-k all-reduces)."""
    for paged in (True, False):
        coll = _all(world, ("collectives", kind, mesh, paged, 0.0))
        dp_shards, cs, st = _all(world, ("stats", kind, mesh, paged, 0.0))
        assert coll[("all_gather", "data")] == st["host_syncs"]
        tp = int(mesh[-1])
        model = {k: n for k, n in coll.items() if k[1] == "model"}
        split = _all(world, ("split_calls", kind, mesh, paged, 0.0))
        if tp == 1:
            assert model == {} and split == 0
        else:
            assert model[("all_reduce", "model")] > 0 and model[("all_gather", "model")] > 0
            assert (split > 0) == (kind == "nsvd1")
        assert cs["mesh"] == {"dp": int(mesh[0]), "tp": tp, "devices": int(mesh[0]) * tp}
        assert dp_shards == int(mesh[0])
        # A rank holds its shard's pool (or slab rows) and its KV heads.
        assert cs["per_device_cache_hbm_bytes"] * cs["mesh"]["devices"] == \
            cs["cache_hbm_bytes"]


def test_int8_kv_quant_identical(world):
    assert _all(world, "int8") == world["ref"]["int8"]


@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("t", [0.0, 0.7])
def test_pipelined_depth2_identical_under_mesh(world, paged, t):
    """Depth 2 (slot reuse) under (2, 2) equals depth 1 under (2, 2) and the
    meshless engine at depth 2, with one copy a consumed step."""
    (d2, ok2), (d1, ok1), (meshless, _) = _all(world, ("depth", paged, t))
    assert d2 == d1 == meshless and ok2 and ok1


def test_per_shard_admission_and_peaks(world):
    out, dp_shards, per_shard, st, k_shape = _all(world, "per_shard")
    assert out == _all(world, "per_shard_meshless")
    assert dp_shards == 2 and per_shard == 4
    assert len(st["blocks_peak_by_shard"]) == 2
    assert all(0 < p <= 4 for p in st["blocks_peak_by_shard"])
    # Each rank allocates its 4-block sub-pool and a sink, of 2 of 4 KV heads.
    assert k_shape[-4:] == (5, 16, 2, 8)
    assert st["per_device_cache_hbm_bytes"] * 4 == st["cache_hbm_bytes"]


def test_submit_rejects_worst_case_exceeding_shard_subpool(world):
    msg = _all(world, "submit_refused")
    assert "shard" in msg and "2" in msg


def test_indivisible_max_batch_keeps_tp_drops_dp(world):
    out, dp_shards, kv_shards, wq_shape = _all(world, "indivisible")
    assert out == _all(world, "indivisible_meshless")
    assert dp_shards == kv_shards == 1
    assert wq_shape[-1] == 16  # (2 layers, 32, 32 / 2): TP kept


@pytest.mark.parametrize("paged", [True, False])
def test_pools_written_in_place_one_host_copy_a_step(world, paged):
    in_place, copies = _all(world, ("in_place", paged))
    assert in_place
    assert copies == [(4,)] * 4  # one gathered (max_batch,) word a step


def test_swap_and_defrag_across_shards(world):
    """Swap resume (the blocks broadcast from their shard over the data
    group) and defrag every 5 steps under (2, 2): the meshless streams."""
    mesh, sch = _all(world, ("swap", "mesh"))
    meshless, sch0 = _all(world, ("swap", "meshless"))
    assert mesh == meshless
    assert sch["preempt_count"] > 0 and sch["swap_bytes"] > 0 and sch["resumes"] > 0
    assert sch0["preempt_count"] > 0


@pytest.mark.parametrize("mesh", MESHES)
def test_rwkv6_exact_length_admission_under_mesh(world, mesh):
    out, bucketed, widths = _all(world, ("rwkv", mesh))
    assert not bucketed and widths == {5: 1, 6: 1}
    assert out == world["port"]["rwkv"] == world["ref"]["rwkv"]


def test_11_mesh_takes_every_family(world):
    on_mesh, meshless = _all(world, "moe_11")
    assert on_mesh == meshless


def test_11_mesh_takes_spec_decoding(world):
    on_mesh, meshless = _all(world, "spec_11")
    assert on_mesh == meshless


def test_each_rank_holds_its_slice_and_the_tree_gathers_back(world):
    params = {k: v.numpy() for k, v in torch_mesh_ranks._flat(world["params"]).items()}
    coords = set()
    for r in world["ranks"]:
        sh = r["shard"]
        assert sh["gathered_equal"]
        d, m = sh["coord"]
        coords.add((d, m))
        wq = sh["local"][("g0", "sub0", "attn", "wq", "kernel")]
        full = params[("g0", "sub0", "attn", "wq", "kernel")]
        np.testing.assert_array_equal(wq, full[..., m * 16:(m + 1) * 16])
        wo = sh["local"][("g0", "sub0", "attn", "wo", "kernel")]
        np.testing.assert_array_equal(
            wo, params[("g0", "sub0", "attn", "wo", "kernel")][:, m * 16:(m + 1) * 16])
        table = sh["local"][("embed", "table")]
        np.testing.assert_array_equal(table, params[("embed", "table")][m * 32:(m + 1) * 32])
        norm = ("g0", "sub0", "norm1", "scale")
        np.testing.assert_array_equal(sh["local"][norm], params[norm])
    assert coords == {(0, 0), (0, 1), (1, 0), (1, 1)}


@pytest.mark.parametrize("who", ["port", "reference"])
def test_elastic_restore_onto_22(world, who):
    """A checkpoint saved meshless (by the port, or by the reference)
    restored onto (2, 2): each rank's leaf is its slice of the saved
    leaf, the tree gathers back whole, and it serves the meshless
    streams."""
    params = {k: v.numpy() for k, v in torch_mesh_ranks._flat(world["params"]).items()}
    from repro_torch.parallel.sharding import _entry_axes

    for r in world["ranks"]:
        got = r[("restore", who)]
        d, m = r["shard"]["coord"]
        assert got["step"] == 0 and got["gathered_equal"]
        assert got["local"].keys() == params.keys()
        for path, leaf in got["local"].items():
            full = params[path]
            idx = []
            for dim, e in enumerate(got["specs"][path] + (None,) * full.ndim):
                if dim >= full.ndim:
                    break
                axes = _entry_axes(e)
                assert axes in ((), ("model",)), (path, e)
                n = full.shape[dim] // (2 if axes else 1)
                lo = m * n if axes else 0
                idx.append(slice(lo, lo + n))
            np.testing.assert_array_equal(leaf, full[tuple(idx)], err_msg=str(path))
        assert got["serve"] == world["port"][("dense", True, 0.0)]


@pytest.mark.parametrize("kind", ["moe", "mla", "mamba", "llava", "indivisible_heads",
                                  "spec"])
@pytest.mark.parametrize("mesh", SHARDED)
def test_a3b_refusals_on_meshes_of_more_than_one_rank(world, kind, mesh):
    msg = _all(world, "refusals")[(kind, mesh)]
    if kind == "indivisible_heads" and mesh == "2x1":
        assert msg == ""  # no model axis to divide: DP alone serves it
        return
    assert "ROADMAP A3b" in msg, msg


def test_mesh_factories_refuse_a_world_they_do_not_fill(world):
    """On a world of four ranks a (1, 2) serving mesh and the 256-rank
    production mesh are refused."""
    serving, production = _all(world, "mesh_refusals")
    assert "start dp*tp = 2 ranks" in serving and "256" in production


def test_chip_mesh_serve_path_on_cpu():
    """chip_smoke's mesh_serve path (phase 4f) on a tiny Mistral-family
    model, one gloo rank: every gate of the card's run but the profile."""
    import chip_smoke as cs
    from repro_torch.serving.scheduler import SchedulerConfig

    cfg = torch_paper.small_lm(family_of=torch_paper.MISTRAL_7B, name="small-mistral",
                               num_layers=2, d_model=32, d_ff=48, vocab_size=64, num_heads=4)
    model = build_model(cfg)
    params = model.init(0, "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, 32, size=int(n)) for n in rng.integers(16, 201, 8)]
    eng = ServingEngine(model, params, max_batch=8, max_len=256, seed=0, block_size=16,
                        prefill_chunk=64, pipeline_depth=1,
                        sched_config=SchedulerConfig(admission="worst_case"))
    cs.reset_counts()
    uids = [eng.submit(p, max_new_tokens=32) for p in prompts]
    out = eng.run()
    served = dict(model=model, params=params, prompts=prompts,
                  outputs=[out[u] for u in uids],
                  plan_launches=dict(cs.read_counts(), nested=cs.nested_split(),
                                     paged_combine=cs._ops("paged_attention").combine_launches),
                  plan_stats=eng.stats())
    summary, counts = cs.mesh_serve_path(torch, np, served, device="cpu")
    assert summary["ok"], summary["gates"]
    assert summary["collectives"] == {"all_gather data": eng.stats()["host_syncs"]}
    assert served == {} and set(counts) == set(cs.KERNELS)
    assert not torch.distributed.is_initialized()
    assert os.path.isdir(os.path.dirname(cs.OUT_DIR))
