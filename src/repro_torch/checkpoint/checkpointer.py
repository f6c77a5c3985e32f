"""Checkpoints in the reference's layout (its ``checkpoint/checkpointer.py``).

One directory a checkpoint:
  manifest.json  -- {"leaves": [{"path", "file", "dtype", "shape"}], "extra"}
  leafNNNNN.npy  -- each leaf as a host numpy array

A leaf's path is its keys from the root: a dict's keys (sorted), a tuple's
or list's index as ``#i``, so a training checkpoint ``(params,
AdamWState)`` reads back as a tuple whose second item the caller rebuilds
as an ``AdamWState``.  bf16 leaves are written as their uint16 bits with
the manifest naming ``bfloat16`` (the reference views them back as
``ml_dtypes.bfloat16``) and read back bit for bit, with or without
``ml_dtypes`` (``bridge.array_to_tensor``).

Saves are atomic (write a ``.tmp`` directory, fsync the manifest, rename),
so a failure in the middle of a save never corrupts the last checkpoint.
``AsyncCheckpointer`` copies the tree to host memory on the caller's thread
(a consistent snapshot) and writes it on a background thread.

This module is the port's one writer and reader of the layout:
``bridge.save_checkpoint`` and ``bridge.load_checkpoint`` call it.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import Device
from repro_torch.bridge import array_to_tensor, tensor_to_array


def flatten(tree, prefix=()) -> Dict[Tuple[str, ...], Any]:
    """{path: leaf} of nested dicts (sorted keys) and lists/tuples (``#i``
    path keys), the reference's layout."""
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(flatten(tree[k], prefix + (str(k),)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten(v, prefix + (f"#{i}",)))
    else:
        out[prefix] = tree
    return out


def _unflatten(flat: Dict[Tuple[str, ...], Any]):
    root: Dict = {}
    for path, v in flat.items():
        node = root
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = v

    def rebuild(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.startswith("#") for k in keys):
            return tuple(rebuild(node[f"#{i}"]) for i in range(len(keys)))
        return {k: rebuild(v) for k, v in node.items()}

    return rebuild(root)


def _host(leaf) -> Tuple[np.ndarray, str]:
    """(host array, manifest dtype) of a leaf: bf16 as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        arr = tensor_to_array(leaf)
        if leaf.device.type == "cpu":  # a view of the tensor's memory: snapshot it
            arr = arr.copy()
    else:
        arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16" or (arr.dtype.kind == "V" and arr.dtype.itemsize == 2):
        return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def _write(path: str, flat: Dict[Tuple[str, ...], Tuple[np.ndarray, str]],
           extra: Optional[Dict]) -> None:
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"leaves": [], "extra": extra or {}}
    for i, (p, (arr, dtype)) in enumerate(flat.items()):
        fname = f"leaf{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append({"path": list(p), "file": fname, "dtype": dtype,
                                   "shape": list(arr.shape)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)


def save_checkpoint(path: str, tree, extra: Optional[Dict] = None) -> None:
    """Atomic save of a tree of nested dicts, tuples and tensors (or numpy
    arrays) in the reference's layout."""
    _write(path, {p: _host(leaf) for p, leaf in flatten(tree).items()}, extra)


def load_checkpoint(path: str, device: Device = None, shardings=None):
    """Read one checkpoint directory -> (tree, extra), the leaves as torch
    tensors on ``device`` (default: the card), tuples rebuilt from ``#i``
    keys.

    ``shardings`` (a tree of ``parallel.NamedSharding`` matching the saved
    tree, or a callable from a leaf's path to one) restores onto a mesh,
    which may differ from the one that saved (elastic reshard): each rank
    memory-maps a leaf's ``.npy`` and copies only its ``local_slice`` to
    the sharding's device.  A leaf the tree does not cover loads whole on
    ``device``.  A dict tree comes back as ``parallel.LocalParams``, its
    ``specs`` the specs it was cut by."""
    from repro_torch.parallel.sharding import LocalParams, P

    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    shard_flat = None
    if shardings is not None and not callable(shardings):
        shard_flat = flatten(shardings)
    flat, specs = {}, {}
    for leaf in manifest["leaves"]:
        keys = tuple(leaf["path"])
        sh = (shardings(keys) if callable(shardings)
              else shard_flat.get(keys) if shard_flat is not None else None)
        arr = np.load(os.path.join(path, leaf["file"]),
                      mmap_mode="r" if sh is not None else None)
        if leaf["dtype"] == "bfloat16":
            if arr.dtype.itemsize != 2:
                raise ValueError(f"leaf {list(keys)} is declared bfloat16 but reads "
                                 f"as {arr.dtype}")
            arr = arr.view("V2")  # the bits, whatever numpy named them
        if list(arr.shape) != list(leaf["shape"]):
            raise ValueError(f"leaf {list(keys)} has shape {arr.shape}, manifest "
                             f"says {leaf['shape']}")
        if sh is None:
            flat[keys] = array_to_tensor(arr, device, copy=False)
            specs[keys] = P()
        else:
            flat[keys] = array_to_tensor(arr[sh.local_slice(arr.shape)], sh.device)
            specs[keys] = sh.spec
    tree = _unflatten(flat)
    if shardings is not None and isinstance(tree, dict):
        tree = LocalParams(tree)
        tree.specs = _unflatten(specs)
    return tree, manifest.get("extra", {})


class AsyncCheckpointer:
    """Saves on a background thread.  The tree is copied to host memory on
    the caller's thread, so the snapshot is the values at the call; file
    IO then overlaps the next training steps."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None

    def save(self, path: str, tree, extra=None):
        flat = {p: _host(leaf) for p, leaf in flatten(tree).items()}
        self.wait()

        def run():
            try:
                _write(path, flat, extra)
            except BaseException as e:  # surfaced by wait()
                self.error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self):
        """Block until the save in flight is on disk; re-raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.error is not None:
            err, self.error = self.error, None
            raise err
