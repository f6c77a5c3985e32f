"""The ranks of ``tests/test_torch_sharded_serving.py``: each spawned process
joins a gloo process group of four through a ``FileStore``, builds every
mesh the scenarios need, runs every scenario on the port's engine and
writes its results for the parent test process to read.  Imports neither
jax nor repro: the reference's outputs are computed in the parent.

Meshes over the four ranks: (2, 2) over all of them; (1, 2) and (2, 1) as
two replicas of two ranks; (1, 1) as four replicas of one.  Every rank
builds every mesh (a process group is made by all ranks), and keeps the
one it is in.
"""

from __future__ import annotations

import datetime
import os
import pickle
import traceback
from unittest import mock

import numpy as np
import torch

WORLD = 4
TIMEOUT_S = 60
MESHES = ("1x1", "2x2", "1x2", "2x1")


def _mesh(rank: int, name: str):
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch.mesh import make_serving_mesh

    if name == "2x2":
        return make_serving_mesh(2, 2, device="cpu")
    layouts = {"1x2": [[[0, 1]], [[2, 3]]], "2x1": [[[0], [2]], [[1], [3]]],
               "1x1": [[[r]] for r in range(WORLD)]}[name]
    meshes = [DeviceMesh("cpu", torch.tensor(m), mesh_dim_names=("data", "model"))
              for m in layouts]
    return next(m for m in meshes if m.get_coordinate() is not None)


def _serve(model, params, prompts, par=None, max_new=6, temperature=0.0, max_batch=4,
           **kw):
    from repro_torch.serving.engine import ServingEngine

    eng = ServingEngine(model, params, max_batch=max_batch, max_len=64, parallelism=par,
                        **kw)
    uids = [eng.submit(p, max_new_tokens=max_new, temperature=temperature)
            for p in prompts]
    out = eng.run()
    return [out[u] for u in uids], eng


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _refusal(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def scenarios(rank: int, inp: dict, workdir: str) -> dict:
    from repro_torch import bridge
    from repro_torch.checkpoint import CheckpointManager, load_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.kernels.nested_lowrank import ops as nlr_ops
    from repro_torch.models import build_model
    from repro_torch.parallel import (collectives, gather_params, make_parallelism,
                                      param_shardings, shard_params)
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.scheduler import SchedulerConfig
    from repro_torch.serving.spec import SpecConfig

    pars = {name: make_parallelism(_mesh(rank, name)) for name in MESHES}
    par22 = pars["2x2"]
    # The parent's models (numpy trees, the reference's weights), and the
    # families the refusals build (random weights from a seed).
    models = {kind: (build_model(cfg), bridge.to_torch(tree, device="cpu"))
              for kind, (cfg, tree) in inp["models"].items()}
    for kind, cfg in (("moe", get_config("moonshot-v1-16b-a3b").reduced()),
                      ("mla", get_config("minicpm3-4b").reduced()),
                      ("mamba", get_config("jamba-v0.1-52b").reduced()),
                      ("llava", get_config("llava-next-mistral-7b").reduced()),
                      ("indivisible_heads", inp["indivisible_heads"])):
        m = build_model(cfg)
        models[kind] = (m, m.init(0, "cpu"))
    prompts = inp["prompts"]
    res: dict = {}

    # Streams: every mesh, both layouts, dense and NSVD-compressed; the
    # dense model's temperature streams too.
    for kind in ("dense", "nsvd1"):
        model, params = models[kind]
        for name in MESHES:
            for paged in (True, False):
                temps = (0.0, 0.7) if kind == "dense" else (0.0,)
                for t in temps:
                    collectives.reset_counts()
                    nlr_ops.split_calls = 0
                    out, eng = _serve(model, params, prompts, pars[name], temperature=t,
                                      paged=paged)
                    res[("streams", kind, name, paged, t)] = out
                    res[("collectives", kind, name, paged, t)] = dict(collectives.counts)
                    res[("split_calls", kind, name, paged, t)] = nlr_ops.split_calls
                    st = eng.stats()  # the counts (times differ by rank)
                    res[("stats", kind, name, paged, t)] = (
                        eng.dp_shards, eng.cache_stats(),
                        {k: st[k] for k in ("steps", "host_syncs", "decode_syncs",
                                            "prefill_ticks")})

    model, params = models["dense"]
    # int8 K/V on the pages.
    res["int8"] = _serve(model, params, prompts, par22, paged=True, kv_quant=True)[0]
    # Depth 2 with slot reuse, both layouts, greedy and temperature.
    work = list(prompts) + [np.asarray(p[::-1]) for p in prompts]
    lens = [6, 4, 7, 3, 5, 6, 4, 5]

    def reuse(par, depth, paged, t):
        eng = ServingEngine(model, params, max_batch=4, max_len=64, parallelism=par,
                            paged=paged, pipeline_depth=depth)
        uids = [eng.submit(p, max_new_tokens=m, temperature=t) for p, m in zip(work, lens)]
        out = eng.run()
        return [out[u] for u in uids], eng.stats()["decode_syncs"] == eng.stats()["steps"]
    for paged in (True, False):
        for t in (0.0, 0.7):
            res[("depth", paged, t)] = [reuse(p, d, paged, t) for p, d in
                                        ((par22, 2), (par22, 1), (None, 2))]
    # Per-shard admission and peaks on an 8-block pool.
    rng = np.random.default_rng(5)
    ps = [rng.integers(2, 60, size=9) for _ in range(4)]
    out, eng = _serve(model, params, ps, par22, max_new=4, paged=True, num_blocks=8)
    res["per_shard"] = (out, eng.kv.dp_shards, eng.kv.blocks_per_shard, eng.kv.stats(),
                        eng.kv.pools["g0"]["sub0"]["attn"]["k"].shape)
    res["per_shard_meshless"] = _serve(model, params, ps, None, max_new=4, paged=True,
                                       num_blocks=8)[0]
    # A worst case larger than a shard's sub-pool.
    eng = ServingEngine(model, params, max_batch=4, max_len=64, paged=True, num_blocks=4,
                        parallelism=par22)
    res["submit_refused"] = _refusal(lambda: eng.submit(np.arange(2, 22), max_new_tokens=13))
    # max_batch 3 does not divide dp 2: one pool shard, weights still TP.
    out, eng = _serve(model, params, prompts, par22, max_batch=3)
    res["indivisible"] = (out, eng.dp_shards, eng.kv.dp_shards,
                          tuple(eng.params["g0"]["sub0"]["attn"]["wq"]["kernel"].shape))
    res["indivisible_meshless"] = _serve(model, params, prompts, None, max_batch=3)[0]
    # Pools and the slab written in place; one host copy a step.
    for paged in (True, False):
        eng = ServingEngine(model, params, max_batch=4, max_len=64, paged=paged,
                            parallelism=par22, pipeline_depth=1)
        for p in prompts:
            eng.submit(p, max_new_tokens=8)
        eng._admit()
        leaves = list(_flat(eng.kv.pools if paged else eng.cache).values())
        ptrs = [t.data_ptr() for t in leaves]
        import repro_torch.serving.engine as engine_mod
        real, copies = engine_mod._to_host, []

        def counting(t, real=real, copies=copies):
            copies.append(tuple(t.shape))
            return real(t)
        with mock.patch.object(engine_mod, "_to_host", side_effect=counting):
            for _ in range(4):
                eng.step()
        after = [t.data_ptr() for t in _flat(eng.kv.pools if paged else eng.cache).values()]
        res[("in_place", paged)] = (ptrs == after, copies)
    # Swap resume and defrag across the DP shards, against the meshless run.
    long_prompts = [np.concatenate([p, p[::-1], p]) for p in prompts]
    for name, par in (("mesh", par22), ("meshless", None)):
        eng = ServingEngine(model, params, max_batch=4, max_len=64, parallelism=par,
                            paged=True, num_blocks=12, block_size=8,
                            sched_config=SchedulerConfig(resume="swap"))
        uids = [eng.submit(p, max_new_tokens=20) for p in long_prompts]
        steps = 0
        while eng.sched or eng._prefilling or eng.active.any():
            eng.run(max_steps=1)
            steps += 1
            if steps % 5 == 0:
                eng.defrag()
        eng.drain()
        res[("swap", name)] = ([eng.finished_requests[u].generated for u in uids],
                               eng.scheduler_stats())
    # RWKV-6: exact-length admission, one request a call.
    rmodel, rparams = models["rwkv"]
    for name in ("2x2", "1x2", "2x1", "1x1"):
        out, eng = _serve(rmodel, rparams, inp["rwkv_prompts"], pars[name], max_new=3,
                          max_batch=2)
        res[("rwkv", name)] = (out, eng._bucketed, eng.admissions_by_width)
    # (1, 1) takes every family: the reduced MoE.
    mmodel, mparams = models["moe"]
    res["moe_11"] = [_serve(mmodel, mparams, inp["rwkv_prompts"], par, max_new=3,
                            max_batch=2)[0] for par in (pars["1x1"], None)]
    # This rank's wq shard, and the whole tree gathered back.
    local = shard_params(params, par22)
    res["shard"] = {"coord": tuple(par22.mesh.get_coordinate()),
                    "local": {k: v.numpy() for k, v in _flat(local).items()},
                    "gathered_equal": all(torch.equal(a, b) for a, b in zip(
                        _flat(gather_params(local, par22)).values(), _flat(params).values()))}
    # The elastic restore: checkpoints saved meshless by the port and by
    # the reference, restored onto (2, 2), each rank reading its slices.
    for who in ("port", "reference"):
        path = os.path.join(workdir, f"ckpt_{who}")
        sh = param_shardings(params, par22.mesh)
        if who == "port":
            tree, _, step = CheckpointManager(path).restore(shardings=sh)
        else:
            tree, _ = load_checkpoint(os.path.join(path, "step_00000000"), "cpu", sh)
            step = 0
        res[("restore", who)] = {
            "step": step, "local": {k: v.numpy() for k, v in _flat(tree).items()},
            "specs": {k: tuple(v) for k, v in _flat(tree.specs).items()},
            "gathered_equal": all(torch.equal(a, b) for a, b in zip(
                _flat(gather_params(tree, par22)).values(), _flat(params).values())),
            "serve": _serve(model, tree, prompts, par22)[0]}
    # ROADMAP A3b's refusals on meshes of more than one rank.
    refusals = {}
    for kind in ("moe", "mla", "mamba", "llava", "indivisible_heads"):
        m = models[kind][0]
        for name in ("2x2", "2x1", "1x2"):
            refusals[(kind, name)] = _refusal(lambda: ServingEngine(
                m, models[kind][1], max_batch=4, max_len=64, parallelism=pars[name]))
    for name in ("2x2", "2x1", "1x2"):
        refusals[("spec", name)] = _refusal(lambda: ServingEngine(
            model, params, max_batch=4, max_len=64, parallelism=pars[name],
            spec_config=SpecConfig(draft_params=params, k=3)))
    res["refusals"] = refusals
    from repro_torch.launch.mesh import make_production_mesh, make_serving_mesh

    res["mesh_refusals"] = (_refusal(lambda: make_serving_mesh(1, 2, device="cpu")),
                            _refusal(lambda: make_production_mesh(device="cpu")))
    res["spec_11"] = [_serve(model, params, prompts, par, spec_config=SpecConfig(
        draft_params=params, k=3))[0] for par in (pars["1x1"], None)]
    return res


def rank_main(rank: int, workdir: str) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist

    out, err = None, None
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(workdir, "store"), WORLD), rank=rank,
            world_size=WORLD, timeout=datetime.timedelta(seconds=TIMEOUT_S))
        with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
            inp = pickle.load(f)
        out = scenarios(rank, inp, workdir)
    except BaseException:
        err = traceback.format_exc()
    finally:
        with open(os.path.join(workdir, f"out_{rank}.pkl"), "wb") as f:
            pickle.dump({"results": out, "error": err}, f)
        if dist.is_initialized():
            dist.destroy_process_group()
