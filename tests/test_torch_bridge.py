"""The bridge between the packages (checkpoints with bf16 leaves, param
trees), the reference checkpoint read through it, and the port's import
boundary: nothing under src/repro_torch/, chip_smoke.py nor tools/ imports
jax or repro."""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import load_checkpoint as jax_load_checkpoint
from repro.checkpoint.checkpointer import save_checkpoint as jax_save_checkpoint
from repro_torch import bridge

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree():
    rng = np.random.default_rng(0)
    return {
        "embed": {"table": jnp.asarray(rng.standard_normal((8, 4)), jnp.bfloat16)},
        "g0": {"sub0": {"attn": {"wq": {
            "u": jnp.asarray(rng.standard_normal((2, 4, 3)), jnp.float32),
            "v": jnp.asarray(rng.standard_normal((2, 3, 4)), jnp.bfloat16)}}}},
        "steps": jnp.asarray(np.arange(3), jnp.int32),
    }


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def test_reference_checkpoint_loads_bit_exact(tmp_path):
    tree = _tree()
    path = str(tmp_path / "ckpt")
    jax_save_checkpoint(path, tree)
    got, _ = bridge.load_checkpoint(path, device="cpu")
    assert got["embed"]["table"].dtype == torch.bfloat16
    for want, have in ((tree["embed"]["table"], got["embed"]["table"]),
                       (tree["g0"]["sub0"]["attn"]["wq"]["v"],
                        got["g0"]["sub0"]["attn"]["wq"]["v"])):
        np.testing.assert_array_equal(_bits(have), np.asarray(want).view(np.int16))
    np.testing.assert_array_equal(got["g0"]["sub0"]["attn"]["wq"]["u"].numpy(),
                                  np.asarray(tree["g0"]["sub0"]["attn"]["wq"]["u"]))


def test_bf16_npy_without_ml_dtypes_reads_as_void(tmp_path):
    """Where ml_dtypes is absent numpy reads a bf16 .npy as 2-byte voids;
    the bridge reinterprets the bits."""
    raw = np.asarray([0x3F80, 0xC000, 0x0001], np.uint16)  # 1.0, -2.0, tiny
    voids = raw.view("V2")
    t = bridge.array_to_tensor(voids, device="cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16), raw)
    assert t[:2].float().tolist() == [1.0, -2.0]


def test_port_checkpoint_round_trips_to_reference(tmp_path):
    tree = bridge.to_torch(jax.tree.map(np.asarray, _tree()), device="cpu")
    path = str(tmp_path / "port")
    bridge.save_checkpoint(path, tree, extra={"steps": 1})
    back, extra = jax_load_checkpoint(path)
    assert extra == {"steps": 1}
    assert back["embed"]["table"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(back["embed"]["table"]).view(np.int16),
                                  _bits(tree["embed"]["table"]))
    again, _ = bridge.load_checkpoint(path, device="cpu")
    for a, b in ((again["g0"]["sub0"]["attn"]["wq"]["v"], tree["g0"]["sub0"]["attn"]["wq"]["v"]),
                 (again["steps"], tree["steps"])):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    np_tree = bridge.to_numpy(tree)
    assert np_tree["embed"]["table"].dtype.itemsize == 2


def test_latest_checkpoint_picks_newest(tmp_path):
    for step in (3, 12):
        os.makedirs(tmp_path / f"step_{step:08d}")
    os.makedirs(tmp_path / "step_00000020.tmp")
    assert bridge.latest_checkpoint(str(tmp_path)).endswith("step_00000012")
    with pytest.raises(FileNotFoundError):
        bridge.latest_checkpoint(str(tmp_path / "step_00000003"))


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_repro():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    tools = os.path.join(ROOT, "tools")  # the card-side fault checks and profiles
    files += [os.path.join(tools, n) for n in os.listdir(tools) if n.endswith(".py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    bad = [(f, m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []
