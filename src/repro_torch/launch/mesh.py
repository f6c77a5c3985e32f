"""Mesh factories on ``torch.distributed`` (the reference's
``launch/mesh.py``): one process a rank, each a ``DeviceMesh`` coordinate.

Functions, not module-level meshes, so importing this module touches no
process group.  ``init_distributed`` joins the job ``torchrun`` started
(its ``WORLD_SIZE``, ``RANK`` and ``MASTER_*`` variables), or makes a
one-process group through a ``FileStore`` in a temporary directory when
there is no such job, so a (1, 1) mesh needs no launcher.  NCCL on the
card, gloo on the CPU.
"""

from __future__ import annotations

import datetime
import os
import tempfile
import warnings

import torch
import torch.distributed as dist

from repro_torch import Device, resolve_device

# The card's figures (roofline targets): NVIDIA H100 80GB HBM3 at its 700 W
# power limit, as ``nvidia-smi --query-gpu=name,power.limit`` names it.
DEVICE = "H100 80GB HBM3, 700 W"
PEAK_FLOPS_BF16 = 989e12  # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12  # bytes/s
NVLINK_BW = 900e9  # bytes/s a card, all links
CHIP_HBM_BYTES = 80 * 1024**3

PROCESS_GROUP_TIMEOUT_S = 60


def init_distributed(device: Device = None) -> int:
    """Join (or make) the default process group; returns the world size.
    On the card each rank takes the CUDA device of its ``LOCAL_RANK``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if not dist.is_initialized():
        timeout = datetime.timedelta(seconds=PROCESS_GROUP_TIMEOUT_S)
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, timeout=timeout)
        else:
            store = dist.FileStore(os.path.join(tempfile.mkdtemp(prefix="repro_pg_"),
                                                "store"), 1)
            dist.init_process_group(backend, store=store, rank=0, world_size=1,
                                    timeout=timeout)
    return dist.get_world_size()


def make_mesh(shape, axes, device: Device = None):
    """A ``DeviceMesh`` of ``shape`` over the whole world (``cuda`` unless
    the caller asks for the CPU); a (1, 1) mesh runs the same code as
    (2, 2)."""
    dev = resolve_device(device)
    init_distributed(dev)
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device: Device = None):
    """The reference's production mesh: 16 x 16 ("data", "model"), or 2 x
    16 x 16 with "pod"; raises unless the world has 256 (512) ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for s in shape:
        need *= s
    world = init_distributed(device)
    if world != need:
        raise ValueError(f"the production mesh {shape} needs {need} ranks, the world "
                         f"has {world}")
    return make_mesh(shape, axes, device)


def make_serving_mesh(dp: int = 1, tp: int = 1, device: Device = None):
    """Serving mesh: ("data", "model") of shape (dp, tp), checked against the
    world's ranks.  When dp*tp exceeds them it WARNS and returns a (1, 1)
    mesh, which the serving engine guarantees is bit for bit the meshless
    path (run under ``torchrun --nproc-per-node dp*tp`` for a real one)."""
    if dp < 1 or tp < 1:
        raise ValueError(f"mesh axes must be positive, got dp={dp} tp={tp}")
    n = dp * tp
    avail = init_distributed(device)
    if n > avail:
        warnings.warn(
            f"serving mesh dp x tp = {dp}x{tp} needs {n} ranks but only {avail} "
            f"{'is' if avail == 1 else 'are'} running; falling back to a (1, 1) mesh "
            f"(single-device-equivalent). Run under torchrun --nproc-per-node {n} "
            "for the real mesh.", stacklevel=2)
        dp = tp = 1
    if dp * tp != avail:
        raise ValueError(f"a ({dp}, {tp}) serving mesh over a world of {avail} ranks: "
                         f"start dp*tp = {dp * tp} ranks")
    return make_mesh((dp, tp), ("data", "model"), device)
