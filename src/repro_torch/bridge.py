"""Weights and Grams cross between the JAX reference and the port by file.

* Param trees: nested dicts of numpy arrays <-> nested dicts of torch
  tensors with the same keys (``g{i}/sub{j}/attn/wq/{kernel | u,v,u2,v2}``,
  stacked leading layer dims kept).
* Reference checkpoints: one directory holding ``manifest.json`` plus one
  ``.npy`` per leaf (the reference's ``checkpoint/checkpointer.py`` layout),
  read and written by ``repro_torch.checkpoint.checkpointer`` (which
  ``load_checkpoint`` and ``save_checkpoint`` here call).
* GramStore npz files (schema 1 or 2): ``read_gram_npz``.

bf16 leaves: without ``ml_dtypes`` (absent on the card's machine) numpy
reads a bf16 ``.npy`` as raw 2-byte voids.  Those bytes are reinterpreted
as uint16 and viewed as ``torch.bfloat16`` — bit-exact, no float detour.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Tuple

import numpy as np
import torch

from . import Device, resolve_device

GRAM_STORE_SCHEMA = 2
_STEP_RE = re.compile(r"^step_(\d+)$")


def _is_bf16(arr: np.ndarray) -> bool:
    return arr.dtype.name == "bfloat16" or (
        arr.dtype.kind == "V" and arr.dtype.itemsize == 2)


def array_to_tensor(arr: np.ndarray, device: Device = None, copy: bool = True) -> torch.Tensor:
    """numpy -> torch on ``device``; bf16 (ml_dtypes or raw void) is kept.
    ``copy=False``: a CPU tensor may share the array's memory (for an array
    the caller owns and drops, as a checkpoint reader does)."""
    arr = np.asarray(arr)
    # ascontiguousarray makes a 0-d array 1-d: the reshape keeps its shape.
    flat = np.ascontiguousarray(arr).reshape(arr.shape)
    if _is_bf16(arr):
        flat = flat.view(np.uint16).view(np.int16)
    if copy or not flat.flags.writeable:
        flat = flat.copy()
    t = torch.from_numpy(flat)
    if _is_bf16(arr):
        t = t.view(torch.bfloat16)
    return t.to(resolve_device(device))


def tensor_to_array(t: torch.Tensor) -> np.ndarray:
    """torch -> numpy.  bf16 comes back as ``ml_dtypes.bfloat16`` when that
    package is importable (what the JAX side expects), else as the raw
    uint16 bit pattern."""
    t = t.detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy()
    raw = t.contiguous().view(torch.int16).numpy().view(np.uint16)
    try:
        import ml_dtypes
    except ImportError:
        return raw
    return raw.view(ml_dtypes.bfloat16)


def to_torch(tree, device: Device = None):
    """Nested dict of numpy arrays -> same dict of torch tensors."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    return array_to_tensor(tree, device)


def to_numpy(tree):
    """Nested dict of torch tensors -> same dict of numpy arrays."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return tensor_to_array(tree)


def load_checkpoint(path: str, device: Device = None) -> Tuple[Dict, Dict]:
    """Read one checkpoint directory in the reference's layout -> (tree,
    extra); ``checkpoint.checkpointer.load_checkpoint``, the one reader."""
    from repro_torch.checkpoint.checkpointer import load_checkpoint as load
    return load(path, device)


def latest_checkpoint(directory: str) -> str:
    """The newest ``step_*`` directory a reference CheckpointManager wrote."""
    steps = sorted(int(m.group(1)) for m in
                   (_STEP_RE.match(n) for n in os.listdir(directory)) if m)
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    return os.path.join(directory, f"step_{steps[-1]:08d}")


def save_checkpoint(path: str, tree, extra: Dict | None = None) -> None:
    """Write a tree in the reference's layout (atomic rename);
    ``checkpoint.checkpointer.save_checkpoint``, the one writer."""
    from repro_torch.checkpoint.checkpointer import save_checkpoint as save
    save(path, tree, extra)


def read_gram_npz(path: str) -> Dict[str, Tuple[np.ndarray, np.ndarray, float]]:
    """GramStore npz (schema 1 unstamped, or 2) -> {key: (gram, absmean
    sum, row count)}; rejects newer schemas and torn entries."""
    data = np.load(path)
    schema = int(data["__schema__"]) if "__schema__" in data.files else 1
    if not 1 <= schema <= GRAM_STORE_SCHEMA:
        raise ValueError(f"GramStore file {path!r} has schema {schema}; this "
                         f"build reads schemas 1..{GRAM_STORE_SCHEMA}")
    out = {}
    for name in sorted(k[3:] for k in data.files if k.startswith("g::")):
        if f"a::{name}" not in data.files or f"c::{name}" not in data.files:
            raise ValueError(f"GramStore file {path!r} is corrupt: key "
                             f"{name!r} is missing its absmean/count arrays")
        gram = np.asarray(data[f"g::{name}"])
        absmean = np.asarray(data[f"a::{name}"])
        if gram.ndim != 2 or gram.shape[0] != gram.shape[1] \
                or absmean.shape != gram.shape[:1]:
            raise ValueError(f"GramStore file {path!r} is corrupt: key "
                             f"{name!r} has gram {gram.shape} / absmean "
                             f"{absmean.shape}")
        out[name] = (gram, absmean, float(data[f"c::{name}"]))
    return out


def write_gram_npz(path: str, entries: Dict[str, Tuple[np.ndarray, np.ndarray, float]]) -> None:
    """Inverse of ``read_gram_npz`` (schema 2, the reference's layout)."""
    np.savez_compressed(
        path,
        __schema__=np.asarray(GRAM_STORE_SCHEMA),
        **{f"g::{k}": g for k, (g, _, _) in entries.items()},
        **{f"a::{k}": a for k, (_, a, _) in entries.items()},
        **{f"c::{k}": np.asarray(c) for k, (_, _, c) in entries.items()},
    )
