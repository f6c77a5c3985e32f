"""Sharding rules on ``torch.distributed``: DP x TP partition specs for every
param (the reference's ``parallel/sharding.py``), and each rank's local
shard of a param tree.

Mesh axes, as the reference's:
  single pod: ("data", "model")
  multi-pod:  ("pod", "data", "model")  -- "pod" composes with "data" for DP.

Param rules (Megatron-style TP over "model"), copied rule for rule:
  embeddings (V, D)           -> (tp, None)        vocab-sharded
  unembed    (D, V)           -> (None, tp)
  attn  wq/wk/wv (D, H*hd)    -> (None, tp)        head-sharded
  attn  wo (H*hd, D)          -> (tp, None)        row-parallel (all-reduce)
  mlp   wi/wg (D, F)          -> (None, tp)
  mlp   wo (F, D)             -> (tp, None)
  moe   experts (E, D, F)     -> (tp, None, None)  expert-parallel
  mamba column/row splits over d_inner; rwkv over heads.

Factored (compressed) params shard u on its input dim and v on its output
dim, so a factored layer all-reduces a rank-k partial instead of d_model.

The port runs explicit SPMD, one process a rank, where the reference runs
GSPMD under one controller: each rank holds its shard of every param as a
plain tensor (``shard_params``, or a checkpoint restored with
``param_shardings``), the kernels take those local tensors, and the
collectives are written out where GSPMD inserts them
(``parallel.collectives``).  ``Parallelism.constrain`` is therefore a
no-op: placement lives in the local shards, not in annotations.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch


class P(tuple):
    """A partition spec: one entry a dim, each None (replicated), an axis
    name, or a tuple of axis names; equal by value, as jax's."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}" if len(self) != 1 else f"P({self[0]!r})"


class AbstractMesh:
    """A mesh's axis names and sizes without processes, for specs on a mesh
    this host cannot build (a 2 x 16 pod on one CPU)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError(f"{len(shape)} sizes for {len(axis_names)} axes")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape.values():
            n *= s
        return n


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or an ``AbstractMesh``."""
    if isinstance(mesh, AbstractMesh):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclasses.dataclass(frozen=True)
class Parallelism:
    """Carries the mesh and its axis names through model construction and
    the engine.  ``mesh`` is a ``torch.distributed.device_mesh.DeviceMesh``
    (an ``AbstractMesh`` serves the spec functions alone) or None."""

    mesh: Optional[Any] = None
    dp_axes: Tuple[str, ...] = ("data",)
    tp_axis: Optional[str] = "model"

    @property
    def active(self) -> bool:
        return self.mesh is not None

    @property
    def dp(self):  # spec entry for batch dims
        return self.dp_axes if len(self.dp_axes) > 1 else self.dp_axes[0]

    def _size(self, axes) -> int:
        if self.mesh is None:
            return 1
        sizes = mesh_axis_sizes(self.mesh)
        n = 1
        for a in axes:
            n *= sizes[a]
        return n

    @property
    def dp_size(self) -> int:
        return self._size(self.dp_axes)

    @property
    def tp_size(self) -> int:
        return self._size((self.tp_axis,)) if self.tp_axis else 1

    @property
    def size(self) -> int:
        return self.dp_size * self.tp_size

    def _one_axis(self, axes: Tuple[str, ...]) -> str:
        if len(axes) != 1:
            raise NotImplementedError(
                f"a process group over the axes {axes}: the serving and test meshes "
                "have one data axis (a multi-pod mesh needs 512 ranks)")
        return axes[0]

    def data_group(self):
        return self.mesh.get_group(self._one_axis(self.dp_axes))

    def model_group(self):
        return self.mesh.get_group(self.tp_axis)

    @property
    def dp_rank(self) -> int:
        if self.mesh is None:
            return 0
        return self.mesh.get_local_rank(self._one_axis(self.dp_axes))

    @property
    def tp_rank(self) -> int:
        if self.mesh is None or not self.tp_axis:
            return 0
        return self.mesh.get_local_rank(self.tp_axis)

    def constrain(self, x: torch.Tensor, *spec) -> torch.Tensor:
        """The reference's sharding constraint.  A no-op here: every rank
        already holds its local shard (explicit SPMD)."""
        return x


NONE_PARALLEL = Parallelism()


def make_parallelism(mesh) -> Parallelism:
    if mesh is None:
        return NONE_PARALLEL
    names = tuple(mesh_axis_sizes(mesh))
    if "pod" in names:
        return Parallelism(mesh, ("pod", "data"), "model")
    return Parallelism(mesh, ("data",), "model")


# --------------------------------------------------------------- param rules

# (path regex) -> (in_axis, out_axis) for linear-like leaves.  Specific
# rules MUST precede generic ones (first match wins).
_LINEAR_RULES: Sequence[Tuple[str, Tuple[Optional[str], Optional[str]]]] = (
    # rwkv / mamba / moe / mla specifics first
    (r"rwkv_c/wk$", (None, "model")),
    (r"rwkv_c/wv$", ("model", None)),
    (r"rwkv_c/wr$", (None, None)),
    (r"rwkv_t/(wr|wk|wv|wg)$", (None, "model")),
    (r"rwkv_t/wo$", ("model", None)),
    (r"mamba/in_proj$", (None, "model")),
    (r"mamba/x_proj$", ("model", None)),
    (r"mamba/out_proj$", ("model", None)),
    (r"(^|/)router$", (None, None)),
    (r"(^|/)wq_a$", (None, None)),
    (r"(^|/)wq_b$", (None, "model")),
    (r"(^|/)wkv_a$", (None, None)),
    (r"(^|/)wkv_b$", (None, "model")),
    # generic transformer projections
    (r"(^|/)unembed$", (None, "model")),
    (r"(^|/)(wq|wk|wv)$", (None, "model")),
    (r"(^|/)wo$", ("model", None)),
    (r"(^|/)(wi|wg)$", (None, "model")),
)

# Non-linear leaves: path regex -> spec (without stacked prefix).
_LEAF_RULES: Sequence[Tuple[str, Tuple]] = (
    (r"(^|/)embed/table$", ("model", None)),
    (r"(^|/)pos/table$", (None, None)),
    (r"experts/(wi|wg|wo)/kernel$", ("model", None, None)),
    (r"experts/(wi|wg|wo)/(u|v|u2|v2)$", ("model", None, None)),
    (r"mamba/conv/w$", (None, "model")),
    (r"mamba/conv/b$", ("model",)),
    (r"mamba/dt_proj/kernel$", (None, "model")),
    (r"mamba/dt_proj/bias$", ("model",)),
    (r"mamba/a_log$", ("model", None)),
    (r"mamba/d_skip$", ("model",)),
    (r"rwkv_t/bonus$", ("model", None)),
    (r"rwkv_t/(ln_scale|ln_bias)$", ("model",)),
)


def _match_linear(path: str):
    for pat, axes in _LINEAR_RULES:
        if re.search(pat, path):
            return axes
    return None


def _match_leaf(path: str, ndim: int):
    for pat, spec in _LEAF_RULES:
        if re.search(pat, path):
            return spec
    return None


def param_pspec(path: Tuple[str, ...], leaf, fsdp_axes=None) -> P:
    """PartitionSpec for one param leaf (anything with ``.shape``) given its
    tree path.

    ``fsdp_axes``: additionally shard each 2D+ weight over the DP axes on
    its largest TP-free dim of at least 128 (ZeRO-3/FSDP storage)."""
    ndim = len(leaf.shape)
    joined = "/".join(path)
    parent = "/".join(path[:-1])
    key = path[-1]

    def with_fsdp(entries):
        if not fsdp_axes or ndim < 2:
            return P(*entries)
        entries = list(entries)
        dp = tuple(fsdp_axes) if len(fsdp_axes) > 1 else fsdp_axes[0]
        free = [i for i, e in enumerate(entries) if e is None and leaf.shape[i] >= 128]
        if free:
            target = max(free, key=lambda i: leaf.shape[i])
            entries[target] = dp
        return P(*entries)

    spec = _match_leaf(joined, ndim)
    if spec is not None:
        pad = ndim - len(spec)
        return with_fsdp([None] * pad + list(spec))

    if key in ("kernel", "u", "v", "u2", "v2", "table"):
        axes = _match_linear(parent)
        if axes is None:
            return P()  # replicate unknown linears
        in_ax, out_ax = axes
        if key == "kernel":
            mat = (in_ax, out_ax)
        elif key in ("u", "u2"):
            # u shards its INPUT dim, v its OUTPUT dim, whatever the dense
            # kernel's orientation (else u stays whole on every rank of a
            # column-parallel layer): one rank-k all-reduce a factored
            # column-parallel matmul.
            mat = (None, None) if (in_ax is None and out_ax is None) else ("model", None)
        else:  # v / v2
            mat = (None, None) if (in_ax is None and out_ax is None) else (None, "model")
        pad = ndim - 2
        return with_fsdp([None] * pad + list(mat))

    return P()  # norms, biases, scalars: replicated


def tree_paths(tree, prefix=()) -> Dict[Tuple[str, ...], Any]:
    out = {}
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            out.update(tree_paths(v, prefix + (str(k),)))
    else:
        out[prefix] = tree
    return out


def _walk(tree, fn, prefix=()):
    if isinstance(tree, Mapping):
        return {k: _walk(v, fn, prefix + (str(k),)) for k, v in tree.items()}
    return fn(prefix, tree)


def param_pspecs(params_shape, fsdp_axes=None):
    """Tree of raw PartitionSpecs (mesh-independent)."""
    return _walk(params_shape, lambda p, leaf: param_pspec(p, leaf, fsdp_axes))


def moe_shard_specs(moe_params_shape) -> Any:
    """The MoE layer's specs: experts sharded on "model", shared experts
    TP-sliced, router replicated."""
    return _walk(moe_params_shape, lambda p, leaf: param_pspec(p, leaf))


# ------------------------------------------------------------ local shards

def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


class NamedSharding:
    """A spec on a mesh: ``local_slice(shape)`` is the index this rank holds
    of a leaf of ``shape`` (each split dim cut into equal contiguous parts,
    the rank's part by its mesh coordinate, row-major over an entry's
    axes); ``device`` is where the local shard lives."""

    def __init__(self, mesh, spec: P):
        self.mesh = mesh
        self.spec = P(*spec)

    def __repr__(self) -> str:
        return f"NamedSharding({mesh_axis_sizes(self.mesh)}, {self.spec!r})"

    def __eq__(self, other) -> bool:
        return (isinstance(other, NamedSharding) and other.mesh is self.mesh
                and other.spec == self.spec)

    def __hash__(self) -> int:
        return hash((id(self.mesh), self.spec))

    @property
    def device(self) -> torch.device:
        kind = self.mesh.device_type
        if kind == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device(kind)

    def local_slice(self, shape: Sequence[int]) -> Tuple[slice, ...]:
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more entries than shape {tuple(shape)}")
        if isinstance(self.mesh, AbstractMesh):
            raise ValueError("an AbstractMesh has no ranks: it holds no local slice")
        sizes = mesh_axis_sizes(self.mesh)
        names = list(self.mesh.mesh_dim_names)
        coord = self.mesh.get_coordinate()
        if coord is None:
            raise ValueError("this process is not a rank of the sharding's mesh")
        out = []
        for dim, size in enumerate(shape):
            axes = _entry_axes(self.spec[dim]) if dim < len(self.spec) else ()
            parts, idx = 1, 0
            for a in axes:
                parts *= sizes[a]
                idx = idx * sizes[a] + coord[names.index(a)]
            if size % parts:
                raise ValueError(f"dim {dim} of {tuple(shape)} does not split into "
                                 f"{parts} parts ({self.spec}); sanitize the spec first")
            step = size // parts
            out.append(slice(idx * step, (idx + 1) * step))
        return tuple(out)


def sanitized(spec: P, shape, sizes: Dict[str, int]) -> P:
    """Drop the entries of ``spec`` whose axes do not divide their dim."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, e in zip(shape, entries):
        n = 1
        for a in _entry_axes(e):
            n *= sizes[a]
        out.append(e if dim % n == 0 else None)
    return P(*out)


def param_shardings(params_shape, mesh, fsdp_axes=None):
    """Tree of ``NamedSharding`` matching a params (shape) tree: the rules,
    with the entries that do not divide a leaf's dims dropped (that leaf
    is then held whole, as the reference's jit boundaries require)."""
    sizes = mesh_axis_sizes(mesh)
    return _walk(params_shape, lambda p, leaf: NamedSharding(
        mesh, sanitized(param_pspec(p, leaf, fsdp_axes), leaf.shape, sizes)))


class LocalParams(dict):
    """A rank's local shards of a param tree, as ``shard_params`` or a
    restore with ``param_shardings`` gives them; ``specs`` is the tree of
    PartitionSpecs they were cut by (``gather_params`` reads it)."""

    specs: Any = None


def shard_params(params, par: Parallelism) -> LocalParams:
    """This rank's local tree of ``params`` (the whole tree on every rank)
    under the rules of ``param_shardings``; a ``LocalParams`` is returned
    as it is.  Without an active mesh, the whole tree."""
    if isinstance(params, LocalParams):
        return params
    if par is None or not par.active:
        out = LocalParams(params)
        out.specs = _walk(params, lambda p, leaf: P())
        return out
    shardings = param_shardings(params, par.mesh)

    def cut(leaf, sh):
        sl = sh.local_slice(leaf.shape)
        if all(s.start == 0 and s.stop == n for s, n in zip(sl, leaf.shape)):
            return leaf
        return leaf[sl].contiguous().clone()

    out = LocalParams(_zip(cut, params, shardings))
    out.specs = _zip(lambda leaf, sh: sh.spec, params, shardings)
    return out


def _zip(fn, a, b):
    if isinstance(a, Mapping):
        return {k: _zip(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def gather_params(local, par: Parallelism, specs=None):
    """The whole tree from every rank's ``local`` shards (the tests' check
    of ``shard_params`` and of a sharded restore): each split dim
    all-gathered over its axes' groups.  ``specs`` defaults to
    ``local.specs``."""
    from .collectives import all_gather

    specs = local.specs if specs is None else specs

    def join(leaf, spec):
        for dim, e in enumerate(spec):
            for a in reversed(_entry_axes(e)):
                leaf = all_gather(leaf, par, a, dim=dim)
        return leaf

    return _zip(join, dict(local), specs)
