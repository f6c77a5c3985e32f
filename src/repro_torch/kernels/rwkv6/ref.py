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


def rwkv6_chunked_bwd_ref(r, k, v, w, u, dy, chunk: int = 32):
    """``rwkv6_scan_bwd_ref``'s gradients by the backward kernel's chunked,
    division-free algebra (``csrc/rwkv6_bwd.cu``), written plainly: fp32
    math (fp64 for fp64 inputs), each gradient in its input's dtype.  The
    tests hold it to the plain backward; the card runs the kernel.

    T is cut into chunks of ``chunk`` tokens (a ragged last one padded with
    w = 1 and zeros).  In a chunk t0..t1, with S0 = S_{t0-1} and G1 = G_t1:
    a_t and b_t are the running products of w from the chunk's start to
    t (exclusive) and from t (exclusive) to its end, d(s, t) the product
    over s < i < t, M = v dy^T (C x C), P_t = S0 dy_t and Q_t = G1 v_t.
    The summaries (b k)^T v and (a r)^T dy and the scan over chunks give
    every chunk's S0 and G1; then, per column of K,

        dr_t = a_t P_t + R_t + u k_t M[t, t]
        dk_t = b_t Q_t + K_t + u r_t M[t, t]
        dw_t = a_t (b_t rowsum(S0 G1) + T2_t) + b_t T3_t + T4_t

    where R_t = Z_t[t] and T3_t run forward (Z_{t+1} = w_t Z_t + k_t M[t, .],
    T3_{t+1} = w_t T3_t + k_t Q_t), K_t = Y_t[t] and T2_t backward
    (Y_{t-1} = w_t Y_t + r_t M[., t], T2_{t-1} = w_t T2_t + r_t P_t), and
    T4_t, the sum over s < t < tau of d(s, t) d(t, tau) k_s r_tau M[s, tau],
    is sum_tau>t d(t, tau) r_tau Z_t[tau] in the chunk's first half and
    sum_s<t d(s, t) k_s Y_t[s] in its second (each by Horner's rule, the
    decays folded in as it goes); and dv = (k b) G1 + A dy with
    A[t, tau] = sum_k k_t d(t, tau) r_tau (tau > t), sum_k u k_t r_t on the
    diagonal.  du sums r_t k_t M[t, t] by chunk, in chunk order."""
    acc = _acc(r)
    rf, kf, vf, wf, uf, dyf = (x.to(acc) for x in (r, k, v, w, u, dy))
    bh, t_len, kd = r.shape
    cl = chunk
    n = -(-t_len // cl)
    pad = n * cl - t_len

    def chunks(x, fill):
        x = torch.nn.functional.pad(x, (0, 0, 0, pad), value=fill)
        return x.view(bh, n, cl, kd)
    rc, kc, vc, dyc = (chunks(x, 0.0) for x in (rf, kf, vf, dyf))
    wc = chunks(wf, 1.0)
    a, b = torch.empty_like(wc), torch.empty_like(wc)
    run = torch.ones((bh, n, kd), dtype=acc, device=r.device)
    for t in range(cl):
        a[:, :, t] = run
        run = run * wc[:, :, t]
    w_chunk = run
    run = torch.ones_like(run)
    for t in reversed(range(cl)):
        b[:, :, t] = run
        run = run * wc[:, :, t]
    # Chunk summaries, then the scan over chunks (S forward, G backward).
    ds = torch.einsum("bnti,bntj->bnij", b * kc, vc)
    dg = torch.einsum("bnti,bntj->bnij", a * rc, dyc)
    s0, g1 = torch.empty_like(ds), torch.empty_like(dg)
    carry = torch.zeros_like(ds[:, 0])
    for c in range(n):
        s0[:, c] = carry
        carry = w_chunk[:, c, :, None] * carry + ds[:, c]
    carry = torch.zeros_like(carry)
    for c in reversed(range(n)):
        g1[:, c] = carry
        carry = w_chunk[:, c, :, None] * carry + dg[:, c]
    p = torch.einsum("bntj,bnij->bnti", dyc, s0)
    q = torch.einsum("bntj,bnij->bnti", vc, g1)
    m = torch.einsum("bnsj,bntj->bnst", vc, dyc)
    rs = (s0 * g1).sum(-1)
    md = torch.diagonal(m, dim1=-2, dim2=-1)[..., None]  # (bh, n, C, 1): M[t, t]
    half = cl // 2
    dr, dk, dw = (torch.zeros_like(rc) for _ in range(3))
    # Forward in t: Z, T3, and T4 of the chunk's first half.
    z = torch.zeros_like(rc)  # Z_t[tau] along dim 2
    t3 = torch.zeros_like(rc[:, :, 0])
    for t in range(cl):
        dr[:, :, t] = a[:, :, t] * p[:, :, t] + z[:, :, t] + uf[:, None] * kc[:, :, t] * md[:, :, t]
        dw[:, :, t] += b[:, :, t] * t3
        if t < half:  # Horner's rule from tau = C - 1
            h = torch.zeros_like(t3)
            for tau in reversed(range(t + 1, cl)):
                h = wc[:, :, tau] * h + rc[:, :, tau] * z[:, :, tau]
            dw[:, :, t] += h
        z[:, :, t + 1:] = (wc[:, :, t, None] * z[:, :, t + 1:]
                           + kc[:, :, t, None] * m[:, :, t, t + 1:, None])
        t3 = wc[:, :, t] * t3 + kc[:, :, t] * q[:, :, t]
    # Backward in t: Y, T2, and T4 of the chunk's second half.
    y = torch.zeros_like(rc)  # Y_t[s] along dim 2
    t2 = torch.zeros_like(t3)
    for t in reversed(range(cl)):
        dk[:, :, t] = b[:, :, t] * q[:, :, t] + y[:, :, t] + uf[:, None] * rc[:, :, t] * md[:, :, t]
        dw[:, :, t] += a[:, :, t] * (b[:, :, t] * rs + t2)
        if t >= half:  # Horner's rule from s = 0
            h = torch.zeros_like(t2)
            for s in range(t):
                h = wc[:, :, s] * h + kc[:, :, s] * y[:, :, s]
            dw[:, :, t] += h
        y[:, :, :t] = wc[:, :, t, None] * y[:, :, :t] + rc[:, :, t, None] * m[:, :, :t, t, None]
        t2 = wc[:, :, t] * t2 + rc[:, :, t] * p[:, :, t]
    # dv: (k b) G1 plus the chunk's own pairs through A.
    amat = torch.zeros((bh, n, cl, cl), dtype=acc, device=r.device)
    for t in range(cl):
        amat[:, :, t, t] = (uf[:, None] * kc[:, :, t] * rc[:, :, t]).sum(-1)
        d = torch.ones_like(t3)
        for tau in range(t + 1, cl):
            amat[:, :, t, tau] = (kc[:, :, t] * d * rc[:, :, tau]).sum(-1)
            d = d * wc[:, :, tau]
    dv = torch.einsum("bnti,bnij->bntj", b * kc, g1) + torch.einsum("bnts,bnsj->bntj", amat, dyc)
    du = torch.zeros((bh, kd), dtype=acc, device=r.device)
    part = (rc * kc * md).sum(2)  # (bh, n, K)
    for c in range(n):
        du = du + part[:, c]

    def unchunk(x):
        return x.reshape(bh, n * cl, kd)[:, :t_len]
    return (unchunk(dr).to(r.dtype), unchunk(dk).to(k.dtype), unchunk(dv).to(v.dtype),
            unchunk(dw).to(w.dtype), du.to(u.dtype))
