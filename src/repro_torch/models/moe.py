"""Token-choice top-k MoE with capacity and shared experts (one device).

The reference's ``models/moe.py``: token slots are sorted by expert id
(stable), ranked within their expert and dropped beyond the capacity
C = max(8, ceil(N * top_k * cf / E)) (drop by position, Switch-style); the
kept tokens are gathered into an (E, C, D) buffer, every expert runs its
SwiGLU FFN over its C rows, and each token's k weighted outputs are summed
back.  Shared experts are an always-on dense SwiGLU beside them.

Expert FFNs: dense (E, D, F) kernels and {u, v} factors run batched
matmuls (the reference's einsums); nested factors run the batched
``nested_lowrank`` kernel, every expert in one launch (the reference vmaps
its kernel over the expert dim).

Two steps avoid what is nondeterministic on the card, with the
reference's results:
  * the dispatch writes only the valid slots (the reference adds zeros for
    the others at buf[0, 0]; a write without accumulation over duplicate
    indices would let any of them win): invalid slots go to a sink row
    past the buffer;
  * the combine sums each token's k slot outputs by a gather, in the
    reference's scatter-add order (sorted slots: ascending expert id),
    rounding in h's dtype at every add, without atomics.

The router is a full-fp32 matmul, as the reference keeps it for routing
stability: TF32 would flip top-k choices, so on the card it must be off
(``calib.gram.calibration_precision``).  Expert parallelism (``ep_axis``,
the reference's ``shard_map`` over the model axis) is ROADMAP A3b: the
parallelism layer serves MoE on a (1, 1) mesh only.

Top-k routing is discrete: where two experts' probabilities nearly tie (a
random router has many such tokens), a rounding-level change in the
router's input flips a choice and moves that token's output by O(1).  To
hold one run of a model against another that differs only in rounding (the
kernels against their plain versions), ``RoutingTrace`` records the first
run's choices and makes the second take them.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.nested_lowrank import ops as nlr_ops

from .layers import linear, linear_init


def moe_init(gen, cfg: ModelConfig, dtype, device) -> Dict:
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.num_experts
    std = 1.0 / d ** 0.5

    def normal(*shape, scale):
        return torch.randn(shape, generator=gen, device=device) * scale
    params: Dict[str, Any] = {
        "router": {"kernel": normal(d, e, scale=std)},  # fp32, as the reference
        "experts": {
            "wi": {"kernel": normal(e, d, f, scale=std).to(dtype)},
            "wg": {"kernel": normal(e, d, f, scale=std).to(dtype)},
            "wo": {"kernel": normal(e, f, d, scale=f ** -0.5).to(dtype)},
        },
    }
    if m.num_shared_experts > 0:
        fs = f * m.num_shared_experts
        params["shared"] = {
            "wi": linear_init(gen, d, fs, dtype, device),
            "wg": linear_init(gen, d, fs, dtype, device),
            "wo": linear_init(gen, fs, d, dtype, device),
        }
    return params


class Dispatch(NamedTuple):
    buf: torch.Tensor  # (E, C, D) gathered token embeddings
    valid: torch.Tensor  # (N*k,) slot validity (under capacity)
    sorted_e: torch.Tensor  # (N*k,) expert id per sorted slot
    pos: torch.Tensor  # (N*k,) rank within expert
    sorted_t: torch.Tensor  # (N*k,) source token index
    sorted_w: torch.Tensor  # (N*k,) combine weight


def capacity_of(n: int, cfg: ModelConfig) -> int:
    """Slots per expert for n tokens: max(8, ceil(n k int(4 cf) / (4 E)))."""
    m = cfg.moe
    return max(8, -(-n * m.top_k * int(4 * m.capacity_factor) // (4 * m.num_experts)))


def _dispatch(x_flat: torch.Tensor, top_w: torch.Tensor, top_i: torch.Tensor,
              num_experts: int, capacity: int) -> Dispatch:
    """Sort-based capacity dispatch over all experts."""
    n, k = top_i.shape
    dev = x_flat.device
    flat_e = top_i.reshape(-1)
    flat_t = torch.arange(n * k, device=dev) // k  # no host sync
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    sorted_t = flat_t[order]
    sorted_w = top_w.reshape(-1)[order]
    first = torch.searchsorted(sorted_e, sorted_e)  # side="left"
    pos = torch.arange(sorted_e.shape[0], device=dev) - first
    valid = pos < capacity
    sink = num_experts * capacity
    slots = torch.where(valid, sorted_e * capacity + pos, sink)
    flat = torch.zeros((sink + 1, x_flat.shape[-1]), dtype=x_flat.dtype, device=dev)
    flat.index_copy_(0, slots, x_flat[sorted_t])
    buf = flat[:sink].view(num_experts, capacity, x_flat.shape[-1])
    return Dispatch(buf, valid, sorted_e, pos, sorted_t, sorted_w)


def _combine(h: torch.Tensor, disp: Dispatch, n: int) -> torch.Tensor:
    """Gather each slot's expert output and weight it; each token's sum of
    its k slots, added in sorted-slot order in h's dtype."""
    safe_e = torch.where(disp.valid, disp.sorted_e, 0)
    safe_p = torch.where(disp.valid, disp.pos, 0)
    slot_out = h[safe_e, safe_p]  # (N*k, D)
    slot_out = slot_out * torch.where(disp.valid, disp.sorted_w, 0.0)[:, None].to(h.dtype)
    # Token t's slots in ascending sorted position (a stable sort by token).
    by_token = torch.argsort(disp.sorted_t, stable=True).view(n, -1)
    out = torch.zeros((n, h.shape[-1]), dtype=h.dtype, device=h.device)
    for j in range(by_token.shape[1]):
        out = out + slot_out[by_token[:, j]]
    return out


def _expert_matmul(p: Mapping[str, Any], hh: torch.Tensor) -> torch.Tensor:
    """hh (E, C, in) through each expert's dense, factored or nested
    factored (E, in, out) linear."""
    if "kernel" in p:
        return torch.bmm(hh, p["kernel"])
    if "u2" in p:
        return nlr_ops.nested_lowrank_matmul_batched(hh, p["u"], p["v"], p["u2"], p["v2"])
    return torch.bmm(torch.bmm(hh, p["u"]), p["v"])


def _expert_ffn(experts: Mapping[str, Any], buf: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """buf (E, C, D) -> (out (E, C, D), the SwiGLU hidden (E, C, F))."""
    h = F.silu(_expert_matmul(experts["wg"], buf)) * _expert_matmul(experts["wi"], buf)
    return _expert_matmul(experts["wo"], h), h


def router_probs(params: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
    """Softmax of the full-fp32 router logits (N, E)."""
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the MoE router is a full-fp32 matmul and TF32 would change "
                           "its top-k choices: turn TF32 off first "
                           "(repro_torch.calib.gram.calibration_precision)")
    logits = torch.matmul(x.float(), params["router"]["kernel"].float())
    return torch.softmax(logits, dim=-1)


class RoutingTrace:
    """The top-k expert choices of every ``moe_apply`` call in a run, in
    call order.  Inside ``record()`` each call appends its choices; inside
    ``replay()`` each call takes the next recorded choices instead of its
    own (its weights are its own router's probabilities at those experts)
    and counts, in ``flips``, its tokens whose own choice differed."""

    def __init__(self):
        self.choices: List[torch.Tensor] = []
        self.flips = 0
        self._mode: Optional[str] = None
        self._next = 0

    @contextlib.contextmanager
    def _use(self, mode: str):
        global _active
        if _active is not None:
            raise RuntimeError("a RoutingTrace is already active")
        self._mode, self._next, _active = mode, 0, self
        try:
            yield self
        finally:
            self._mode, _active = None, None

    def record(self):
        self.choices, self.flips = [], 0
        return self._use("record")

    def replay(self):
        self.flips = 0
        return self._use("replay")

    def route(self, top_i: torch.Tensor) -> torch.Tensor:
        if self._mode == "record":
            self.choices.append(top_i)
            return top_i
        pinned = self.choices[self._next]
        self._next += 1
        own, want = top_i.sort(-1).values, pinned.sort(-1).values
        self.flips += int((own != want).any(-1).sum())
        return pinned


_active: Optional[RoutingTrace] = None


def moe_apply(params: Mapping[str, Any], x: torch.Tensor, cfg: ModelConfig,
              ep_axis: Optional[str] = None, taps: Optional[Dict] = None,
              tap_prefix: str = "") -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D), the load-balance aux loss, a scalar)."""
    if ep_axis is not None:
        raise NotImplementedError("expert parallelism is not ported (ROADMAP A3b): "
                                  "MoE runs on a (1, 1) mesh or meshless")
    m = cfg.moe
    b, s, d = x.shape
    n = b * s
    e = m.num_experts
    x_flat = x.reshape(n, d)
    probs = router_probs(params, x_flat)  # (N, E) fp32
    top_w, top_i = torch.topk(probs, m.top_k, dim=-1)
    if _active is not None:
        top_i = _active.route(top_i)
        top_w = probs.gather(-1, top_i)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp(min=1e-9)

    # Load-balance aux loss (Switch-style): E * sum_e f_e * p_e.
    ones = torch.ones(n * m.top_k, dtype=torch.float32, device=x.device)
    counts = torch.zeros(e, dtype=torch.float32, device=x.device).index_add_(
        0, top_i.reshape(-1), ones)
    aux = e * torch.sum(counts / (n * m.top_k) * probs.mean(0))

    disp = _dispatch(x_flat, top_w, top_i, e, capacity_of(n, cfg))
    h, h_mid = _expert_ffn(params["experts"], disp.buf)
    if taps is not None:
        taps[f"{tap_prefix}.router_in"] = x_flat
        taps[f"{tap_prefix}.expert_buf"] = disp.buf
        taps[f"{tap_prefix}.expert_mid"] = h_mid
    out = _combine(h, disp, n)

    if "shared" in params:
        sh = params["shared"]
        hs = F.silu(linear(sh["wg"], x_flat)) * linear(sh["wi"], x_flat)
        if taps is not None:
            taps[f"{tap_prefix}.shared_in"] = x_flat
            taps[f"{tap_prefix}.shared_mid"] = hs
        out = out + linear(sh["wo"], hs).to(out.dtype)
    return out.reshape(b, s, d), aux
