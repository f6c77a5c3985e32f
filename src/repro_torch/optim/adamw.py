"""AdamW (the reference's ``optim/adamw.py``): params in the model's dtype,
fp32 master copies and moments in the optimizer state, clipping by global
norm, bias correction and weight decay decoupled onto the master.

Trees are nested dicts of tensors with the param tree's keys.  The update
runs on the params' device and reads nothing from the host: the step, the
norm and the learning rate stay 0-d tensors.

``zero_pspec`` and ``state_pspecs`` (ZeRO-1): the optimizer state's
partition specs, each moment sharded over the data-parallel axes on its
largest dim that TP leaves free (``parallel.sharding``'s specs).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, NamedTuple, Optional, Tuple

import torch

from repro_torch.parallel.sharding import P


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # Schedule hook: step -> multiplier (see schedule.py).
    schedule: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


class AdamWState(NamedTuple):
    step: torch.Tensor  # 0-d int32
    mu: Any  # first moment (fp32)
    nu: Any  # second moment (fp32)
    master: Any  # fp32 master params


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts with the first tree's keys."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves):
    """Nested dicts shaped as ``like`` holding ``leaves`` (an iterator, in
    ``tree_leaves`` order)."""
    if isinstance(like, dict):
        return {k: tree_unflatten(like[k], leaves) for k in like}
    return next(leaves)


def init_state(params) -> AdamWState:
    leaf = tree_leaves(params)[0]
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=leaf.device),
        mu=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params),
        nu=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params),
        master=tree_map(lambda p: p.detach().to(torch.float32).clone(), params),
    )


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in tree_leaves(tree)))


def apply_updates(params, grads, state: AdamWState,
                  cfg: AdamWConfig) -> Tuple[Any, AdamWState, Mapping[str, torch.Tensor]]:
    """One AdamW step.  Returns (new_params, new_state, metrics)."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = cfg.lr * (cfg.schedule(step) if cfg.schedule is not None
                   else torch.ones((), dtype=torch.float32, device=gnorm.device))
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.to(torch.float32)
    bc2 = 1.0 - b2 ** step.to(torch.float32)

    def upd(g, mu, nu, master, p):
        g = g.to(torch.float32) * scale
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * torch.square(g)
        mhat = mu / bc1
        vhat = nu / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * master
        master = master - lr * delta
        return mu, nu, master, master.to(p.dtype)

    out = tree_map(upd, grads, state.mu, state.nu, state.master, params)
    pick = lambda i: tree_map(lambda t: t[i], out)  # noqa: E731
    new_state = AdamWState(step=step, mu=pick(0), nu=pick(1), master=pick(2))
    return pick(3), new_state, {"grad_norm": gnorm, "lr": lr}


# ------------------------------------------------------------------ ZeRO-1

def zero_pspec(param_spec: P, shape: Tuple[int, ...], dp_axes: Tuple[str, ...]) -> P:
    """Shard an optimizer-state leaf over the DP axes on its largest dim not
    already claimed by TP.  Falls back to the param spec when no dim is free
    or divisible."""
    entries = list(param_spec) + [None] * (len(shape) - len(param_spec))

    def uses_dp(e):
        if e is None:
            return False
        axes = e if isinstance(e, tuple) else (e,)
        return any(a in dp_axes for a in axes)

    if any(uses_dp(e) for e in entries):
        return param_spec  # FSDP already shards this param over DP
    free = [i for i, e in enumerate(entries) if e is None and shape[i] > 1]
    if not free:
        return param_spec
    target = max(free, key=lambda i: shape[i])
    entries[target] = dp_axes if len(dp_axes) > 1 else dp_axes[0]
    return P(*entries)


def state_pspecs(params_shape, param_pspec_tree, dp_axes: Tuple[str, ...]) -> AdamWState:
    """PartitionSpec tree for AdamWState given the params' spec tree."""
    moments = tree_map(lambda leaf, spec: zero_pspec(spec, tuple(leaf.shape), dp_axes),
                       params_shape, param_pspec_tree)
    return AdamWState(step=P(), mu=moments, nu=moments, master=moments)
