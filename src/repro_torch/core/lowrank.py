"""Runtime low-rank linear application.

A dense linear stores {"kernel": (in, out)} and computes y = x @ kernel.
After compression the same call site consumes either

    {"u": (in, k), "v": (k, out)}                        (single factorization)
    {"u": (in, k1), "v": (k1, out),
     "u2": (in, k2), "v2": (k2, out)}                    (nested, paper Eq. 6)

and computes y = (x @ u) @ v [+ (x @ u2) @ v2] without ever materializing
the dense kernel.  Nested params route through the nested-lowrank kernel
wrapper (``kernels/nested_lowrank/ops.py``).

``tp_linear_apply`` is the same product on a rank's local shards when a
mesh splits the linear over its model axis (``parallel.sharding``'s
rules): a column-parallel dense layer computes ``x @ W_local``, a
row-parallel one ``all_reduce(x_local @ W_local)``; a factored layer
all-reduces its rank-k partial ``x_part @ [u|u2]_local`` and multiplies it
by ``[v;v2]_local``, gathering the output where the rule leaves it split
and the residual stream needs it whole.  Those factored products are plain
matmuls, counted in the nested wrapper's ``split_calls``.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from repro_torch import torch_dtype
from repro_torch.kernels.nested_lowrank import ops as nlr_ops
from repro_torch.parallel import collectives

from .asvd import LowRankFactors


def is_lowrank(params: Mapping[str, Any]) -> bool:
    return "u" in params


def is_nested(params: Mapping[str, Any]) -> bool:
    return "u2" in params


def linear_apply(params: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
    """y = x @ W for dense, factored or nested-factored params (x (..., in))."""
    if "kernel" in params:
        return torch.matmul(x, params["kernel"])
    if "u" not in params:
        raise KeyError(f"linear params must have 'kernel' or 'u', got {list(params)}")
    if "u2" in params:
        return nlr_ops.nested_lowrank_matmul(
            x, params["u"], params["v"], params["u2"], params["v2"])
    return torch.matmul(torch.matmul(x, params["u"]), params["v"])


def tp_linear_apply(params: Mapping[str, Any], x: torch.Tensor, in_ax, out_ax,
                    par) -> torch.Tensor:
    """``linear_apply`` over ``par``'s model axis for a linear whose rule is
    (in_ax, out_ax), each "model" or None: ``x`` is whole on a column-
    parallel layer (in_ax None) and this rank's slice on a row-parallel one;
    the output is this rank's slice on a column-parallel layer and whole
    otherwise."""
    axis = par.tp_axis
    if "kernel" in params:
        y = torch.matmul(x, params["kernel"])
        return collectives.all_reduce(y, par, axis) if in_ax is not None else y
    us = [params["u"]] + ([params["u2"]] if "u2" in params else [])
    vs = [params["v"]] + ([params["v2"]] if "v2" in params else [])
    if in_ax is None:
        # u holds a slice of the input dim: this rank's part of x.
        lo, hi = collectives.tp_slice(x.shape[-1], par)
        x = x[..., lo:hi]
    parts = [torch.matmul(x, u) for u in us]
    t = collectives.all_reduce(torch.cat(parts, dim=-1), par, axis)
    ranks = [u.shape[-1] for u in us]
    y = None
    for ti, v in zip(torch.split(t, ranks, dim=-1), vs):
        yi = torch.matmul(ti, v)
        y = yi if y is None else y + yi
    if "u2" in params:
        nlr_ops.split_calls += 1
    return collectives.all_gather(y, par, axis, dim=-1) if out_ax is None else y


def dense_equivalent(params: Mapping[str, Any]) -> torch.Tensor:
    """Materialize the (in, out) kernel a factored param represents."""
    if "kernel" in params:
        return params["kernel"]
    k = torch.matmul(params["u"], params["v"])
    if "u2" in params:
        k = k + torch.matmul(params["u2"], params["v2"])
    return k


def factors_to_params(factors: LowRankFactors, dtype="bfloat16") -> dict:
    """Paper-orientation factors (A ~= W Z, A = kernel^T) -> runtime
    {"u","v"[,"u2","v2"]}: u = Z^T (in, k), v = W^T (k, out)."""
    dt = torch_dtype(dtype)
    out = {"u": factors.z.T.contiguous().to(dt), "v": factors.w.T.contiguous().to(dt)}
    if factors.nested:
        out["u2"] = factors.z2.T.contiguous().to(dt)
        out["v2"] = factors.w2.T.contiguous().to(dt)
    return out


def param_count(params: Mapping[str, Any]) -> int:
    return int(sum(v.numel() for v in params.values()))


def flops_per_token(params: Mapping[str, Any]) -> int:
    """Forward multiply-accumulate FLOPs (x2) per input row."""
    if "kernel" in params:
        i, o = params["kernel"].shape[-2:]
        return 2 * i * o
    total = 0
    for a, b in (("u", "v"), ("u2", "v2")):
        if a in params:
            i, k = params[a].shape[-2:]
            _, o = params[b].shape[-2:]
            total += 2 * (i * k + k * o)
    return total
