"""Plain PyTorch versions of the RWKV-6 recurrence: the reference's
sequential fp32 scan (``kernels/rwkv6/ref.py::rwkv6_scan_ref``), which can
also return the final state (the reference model's scan carry), and its
backward, the reverse recurrence that the reference gets from XLA's
autodiff of its ``lax.scan``.  Both compute in fp32 (fp64 for fp64 inputs,
which ``torch.autograd.gradcheck`` needs)."""

import torch


def _acc(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def rwkv6_scan_ref(r, k, v, w, u, return_state: bool = False):
    """r/k/v/w (BH, T, K), u (BH, K) -> y (BH, T, K) in r's dtype, fp32
    math from a zero state; with ``return_state`` also S_T (BH, K, K) fp32."""
    acc = _acc(r)
    rf, kf, vf, wf, uf = (x.to(acc) for x in (r, k, v, w, u))
    bh, t_len, kd = r.shape
    s = torch.zeros((bh, kd, v.shape[-1]), dtype=acc, device=r.device)
    y = torch.empty((bh, t_len, v.shape[-1]), dtype=acc, device=r.device)
    for t in range(t_len):
        kv = kf[:, t, :, None] * vf[:, t, None, :]  # (BH, K, V)
        y[:, t] = torch.einsum("bk,bkv->bv", rf[:, t], s + uf[:, :, None] * kv)
        s = wf[:, t, :, None] * s + kv
    y = y.to(r.dtype)
    return (y, s) if return_state else y


def rwkv6_scan_bwd_ref(r, k, v, w, u, dy):
    """The gradients (dr, dk, dv, dw, du) of sum(y * dy) for y =
    ``rwkv6_scan_ref(r, k, v, w, u)``, each in its input's dtype.  With
    S_t the state after token t (S_{-1} = 0) and G_t = dL/dS_t (G_{T-1} =
    0), walking t from T - 1 down:

        dr_t[k] = sum_v dy_t[v] (S_{t-1}[k, v] + u[k] k_t[k] v_t[v])
        dk_t[k] = sum_v (u[k] r_t[k] dy_t[v] + G_t[k, v]) v_t[v]
        dv_t[v] = sum_k k_t[k] (u[k] r_t[k] dy_t[v] + G_t[k, v])
        dw_t[k] = sum_v S_{t-1}[k, v] G_t[k, v]
        du[k]  += r_t[k] k_t[k] (dy_t . v_t)
        G_{t-1} = diag(w_t) G_t + r_t^T dy_t

    S is recomputed from the inputs and kept for every token (T states of
    (BH, K, K)); S and G are rounded as the forward scan rounds S: a
    product, a product, then a sum."""
    acc = _acc(r)
    rf, kf, vf, wf, uf, dyf = (x.to(acc) for x in (r, k, v, w, u, dy))
    bh, t_len, kd = r.shape
    states = torch.empty((t_len, bh, kd, kd), dtype=acc, device=r.device)
    s = torch.zeros((bh, kd, kd), dtype=acc, device=r.device)
    for t in range(t_len):
        states[t] = s
        s = wf[:, t, :, None] * s + kf[:, t, :, None] * vf[:, t, None, :]
    dr, dk, dv, dw = (torch.empty((bh, t_len, kd), dtype=acc, device=r.device)
                      for _ in range(4))
    du = torch.zeros((bh, kd), dtype=acc, device=r.device)
    dyv = (dyf * vf).sum(-1)  # (BH, T): dy_t . v_t
    g = torch.zeros((bh, kd, kd), dtype=acc, device=r.device)
    for t in reversed(range(t_len)):
        sp, rt, kt, vt, dyt = states[t], rf[:, t], kf[:, t], vf[:, t], dyf[:, t]
        dyv_t = dyv[:, t, None]
        dr[:, t] = torch.einsum("bkv,bv->bk", sp, dyt) + uf * kt * dyv_t
        dk[:, t] = torch.einsum("bkv,bv->bk", g, vt) + uf * rt * dyv_t
        dv[:, t] = torch.einsum("bk,bkv->bv", kt, g) + dyt * (uf * kt * rt).sum(-1, keepdim=True)
        dw[:, t] = (sp * g).sum(-1)
        du += rt * kt * dyv_t
        g = wf[:, t, :, None] * g + rt[:, :, None] * dyt[:, None, :]
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw.to(w.dtype), du.to(u.dtype))
