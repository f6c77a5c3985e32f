"""Weights and Grams cross between the JAX reference and the port by file.

* Param trees: nested dicts of numpy arrays <-> nested dicts of torch
  tensors with the same keys (``g{i}/sub{j}/attn/wq/{kernel | u,v,u2,v2}``,
  stacked leading layer dims kept).
* Reference checkpoints: one directory holding ``manifest.json`` plus one
  ``.npy`` per leaf (the reference's ``checkpoint/checkpointer.py`` layout);
  ``save_checkpoint`` writes the same layout back.
* GramStore npz files (schema 1 or 2): ``read_gram_npz``.

bf16 leaves: without ``ml_dtypes`` (absent on the card's machine) numpy
reads a bf16 ``.npy`` as raw 2-byte voids.  Those bytes are reinterpreted
as uint16 and viewed as ``torch.bfloat16`` — bit-exact, no float detour.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, Tuple

import numpy as np
import torch

from . import Device, resolve_device

GRAM_STORE_SCHEMA = 2
_STEP_RE = re.compile(r"^step_(\d+)$")


def _is_bf16(arr: np.ndarray) -> bool:
    return arr.dtype.name == "bfloat16" or (
        arr.dtype.kind == "V" and arr.dtype.itemsize == 2)


def array_to_tensor(arr: np.ndarray, device: Device = None) -> torch.Tensor:
    """numpy -> torch on ``device``; bf16 (ml_dtypes or raw void) is kept."""
    arr = np.asarray(arr)
    if _is_bf16(arr):
        raw = np.ascontiguousarray(arr).view(np.uint16).view(np.int16)
        t = torch.from_numpy(raw.copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr).copy())
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


def _flatten(tree, prefix=()) -> Dict[Tuple[str, ...], Any]:
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], prefix + (str(k),)))
    else:
        out[prefix] = tree
    return out


def load_checkpoint(path: str, device: Device = None) -> Tuple[Dict, Dict]:
    """Read one reference checkpoint directory -> (param tree, extra)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    root: Dict[str, Any] = {}
    for leaf in manifest["leaves"]:
        keys = leaf["path"]
        if any(k.startswith("#") for k in keys):
            raise ValueError(f"tuple leaves are not part of a param tree: {keys}")
        arr = np.load(os.path.join(path, leaf["file"]))
        if leaf["dtype"] == "bfloat16":
            if arr.dtype.itemsize != 2:
                raise ValueError(f"leaf {keys} is declared bfloat16 but reads "
                                 f"as {arr.dtype}")
            arr = arr.view("V2")  # the bits, whatever numpy named them
        if list(arr.shape) != list(leaf["shape"]):
            raise ValueError(f"leaf {keys} has shape {arr.shape}, manifest "
                             f"says {leaf['shape']}")
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = array_to_tensor(arr, device)
    return root, manifest.get("extra", {})


def latest_checkpoint(directory: str) -> str:
    """The newest ``step_*`` directory a reference CheckpointManager wrote."""
    steps = sorted(int(m.group(1)) for m in
                   (_STEP_RE.match(n) for n in os.listdir(directory)) if m)
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    return os.path.join(directory, f"step_{steps[-1]:08d}")


def save_checkpoint(path: str, tree, extra: Dict | None = None) -> None:
    """Write a param tree in the reference layout (atomic rename)."""
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"leaves": [], "extra": extra or {}}
    for i, (p, leaf) in enumerate(_flatten(tree).items()):
        bf16 = isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16
        arr = tensor_to_array(leaf) if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
        if bf16:
            arr = arr.view(np.uint16)  # bits; the manifest names the dtype
        fname = f"leaf{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append({
            "path": list(p), "file": fname,
            "dtype": "bfloat16" if bf16 else str(arr.dtype),
            "shape": list(arr.shape)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)


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
