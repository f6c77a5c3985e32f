"""Low-rank (column) interpolative decomposition, in torch float64 on the
matrix's own device: the residual step (5b) of NID-I/II.

A ~= C @ T with C = A[:, J] (k actual columns of A) and T[:, J] = I_k, from
column-pivoted Householder QR (Martinsson, Rokhlin & Tygert 2011):

    A P = Q R,  R = [R11 R12],  C = A[:, J (first k pivots)],
    T = [I_k, R11^{-1} R12] P^T

The reference factors the whole matrix (min(m, n) steps) and accumulates an
m x m Q.  This port runs only the first k steps and forms no Q, and returns
the reference's result all the same:

  * step j touches only rows >= j and columns >= j, so rows < k of R (R11
    and R12) are final once step k - 1 is done;
  * a later step only swaps two columns >= k, and swaps ``piv`` the same
    way, so it permutes R12's columns and their pivot labels together;
    T = [I, R11^{-1} R12] P^T, scattered through ``piv``, is the same for
    every such permutation (and for every sign choice of the reflectors);
  * Q never enters T.

The arithmetic is the reference's, so the pivots agree: each pivot is the
first argmax of the squared column norms, downdated after every step and
never recomputed; the same reflector (v[0] += sign(x[0]) ||x||, or + ||x||
where x[0] == 0); and where ||x|| <= 1e-300 no reflection and every
remaining norm set to 0.  That branch is taken on the device (the
reflector becomes 0), and the pivot is read there too, so a call makes no
host sync at all: its ~20 launches a step are queued ahead of the device.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .asvd import LowRankFactors


def _pivoted_qr_steps(a: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first ``k`` steps of Householder QR with column pivoting on a
    float64 copy of ``a``.  Returns (r_top, piv): rows < k of the pivoted,
    reduced matrix (whose upper triangle is [R11 R12]) and the column
    permutation, a[:, piv] == Q R."""
    a = a.to(torch.float64).clone()
    m, n = a.shape
    dev = a.device
    piv = torch.arange(n, device=dev)
    steps = torch.arange(k, device=dev)
    norms = (a * a).sum(0)
    for j in range(k):
        jt = steps[j:j + 1]
        p = j + torch.argmax(norms[j:]).reshape(1)
        src, dst = torch.cat((p, jt)), torch.cat((jt, p))
        a.index_copy_(1, dst, a.index_select(1, src))
        piv.index_copy_(0, dst, piv.index_select(0, src))
        norms.index_copy_(0, dst, norms.index_select(0, src))
        x = a[j:, j]
        normx = torch.linalg.vector_norm(x)
        small = normx <= 1e-300
        v = x.clone()
        x0 = x[0]
        v[0] += torch.where(x0 != 0, torch.sign(x0) * normx, normx)
        v = torch.where(small, torch.zeros_like(v), v / torch.linalg.vector_norm(v))
        sub = a[j:, j:]
        sub.addr_(v, v @ sub, alpha=-2.0)
        if j + 1 < n:
            down = (norms[j + 1:] - a[j, j + 1:] ** 2).clamp(min=0.0)
            norms[j + 1:] = torch.where(small, torch.zeros_like(down), down)
    return torch.triu(a[:k, :]), piv


def column_id(a: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rank-k column ID: (cols, t) with a ~= a[:, cols] @ t, t (k, n) and
    t[:, cols] == I_k (the reference's ``column_id``)."""
    m, n = a.shape
    dev = a.device
    k = int(min(k, m, n))
    if k == 0:
        return (torch.zeros(0, dtype=torch.int64, device=dev),
                torch.zeros((0, n), dtype=torch.float64, device=dev))
    r, piv = _pivoted_qr_steps(a, k)
    r11, r12 = r[:, :k], r[:, k:]
    t12 = torch.linalg.solve_triangular(r11, r12, upper=True)
    eye = torch.eye(k, dtype=torch.float64, device=dev)
    t = torch.empty((k, n), dtype=torch.float64, device=dev)
    t[:, piv] = torch.cat((eye, t12), 1)
    return piv[:k].clone(), t


def id_compress(a: torch.Tensor, k: int) -> LowRankFactors:
    """A ~= C @ T as LowRankFactors, C the actual columns of A."""
    a = a.to(torch.float64)
    cols, t = column_id(a, k)
    return LowRankFactors(a[:, cols], t, method="id")
