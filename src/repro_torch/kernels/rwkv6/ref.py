"""Plain PyTorch version of the RWKV-6 recurrence: the reference's
sequential fp32 scan (``kernels/rwkv6/ref.py::rwkv6_scan_ref``), which can
also return the final state (the reference model's scan carry)."""

import torch


def rwkv6_scan_ref(r, k, v, w, u, return_state: bool = False):
    """r/k/v/w (BH, T, K), u (BH, K) -> y (BH, T, K) in r's dtype, fp32
    math from a zero state; with ``return_state`` also S_T (BH, K, K) fp32."""
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()
    bh, t_len, kd = r.shape
    s = torch.zeros((bh, kd, v.shape[-1]), dtype=torch.float32, device=r.device)
    y = torch.empty((bh, t_len, v.shape[-1]), dtype=torch.float32, device=r.device)
    for t in range(t_len):
        kv = kf[:, t, :, None] * vf[:, t, None, :]  # (BH, K, V)
        y[:, t] = torch.einsum("bk,bkv->bv", rf[:, t], s + uf[:, :, None] * kv)
        s = wf[:, t, :, None] * s + kv
    y = y.to(r.dtype)
    return (y, s) if return_state else y
