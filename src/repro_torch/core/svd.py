"""Truncated / randomized SVD primitives, in torch float64.

The reference does this math in numpy fp64 on the host; the port runs it in
float64 on whatever device the matrix lives on — the card, at full width,
where host numpy would take minutes per layer.  ``torch.linalg.svd`` on CUDA
takes a cuSOLVER ``driver``; SVD_DRIVER names the one the port uses there:
gesvda, the fastest of gesvd/gesvdj/gesvda on the H100 at the Mistral-7B
compression shapes, whose rank-k truncations differ from gesvd's by ~2e-14
relative (``python -m repro_torch.launch.svd_drivers``; PERF.md).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

SVD_DRIVER = "gesvda"


def _linalg_svd(a: torch.Tensor):
    """Thin SVD; on CUDA through SVD_DRIVER.  gesvda takes tall matrices
    only, so a wide matrix goes through its transpose."""
    if not a.is_cuda:
        return torch.linalg.svd(a, full_matrices=False)
    if a.shape[0] < a.shape[1]:
        u, s, vt = torch.linalg.svd(a.T, full_matrices=False, driver=SVD_DRIVER)
        return vt.T, s, u.T
    return torch.linalg.svd(a, full_matrices=False, driver=SVD_DRIVER)


@dataclasses.dataclass(frozen=True)
class SVDResult:
    """A ~= u @ diag(s) @ vt."""

    u: torch.Tensor  # (m, k)
    s: torch.Tensor  # (k,)
    vt: torch.Tensor  # (k, n)

    @property
    def rank(self) -> int:
        return int(self.s.shape[0])

    def truncate(self, k: int) -> "SVDResult":
        k = min(k, self.rank)
        return SVDResult(self.u[:, :k], self.s[:k], self.vt[:k, :])

    def matrix(self) -> torch.Tensor:
        return (self.u * self.s[None, :]) @ self.vt

    def factors(self, split: str = "sqrt") -> Tuple[torch.Tensor, torch.Tensor]:
        """(W, Z) with W @ Z == U diag(s) Vt ('sqrt' balances the norms)."""
        if split == "sqrt":
            rs = torch.sqrt(self.s)
            return self.u * rs[None, :], rs[:, None] * self.vt
        if split == "left":
            return self.u * self.s[None, :], self.vt
        if split == "right":
            return self.u, self.s[:, None] * self.vt
        raise ValueError(f"unknown split {split!r}")


def svd(a: torch.Tensor) -> SVDResult:
    """Thin SVD in float64.  Falls back, like the reference, to the
    eigendecomposition of the smaller Gram when the SVD does not converge."""
    a = a.to(torch.float64)
    try:
        return SVDResult(*_linalg_svd(a))
    except torch.linalg.LinAlgError:
        m, n = a.shape
        if n <= m:
            lam, v = torch.linalg.eigh(a.T @ a)
            lam = lam.flip(0).clamp(min=0.0)
            v = v.flip(1)
            s = torch.sqrt(lam)
            u = (a @ v) / s.clamp(min=1e-300)[None, :]
            return SVDResult(u, s, v.T)
        lam, u = torch.linalg.eigh(a @ a.T)
        lam = lam.flip(0).clamp(min=0.0)
        u = u.flip(1)
        s = torch.sqrt(lam)
        vt = (u.T @ a) / s.clamp(min=1e-300)[:, None]
        return SVDResult(u, s, vt)


def truncated_svd(a: torch.Tensor, k: int) -> SVDResult:
    """Best rank-k approximation (Eckart-Young-Mirsky)."""
    return svd(a).truncate(k)


def randomized_svd(a: torch.Tensor, k: int, oversample: int = 16,
                   n_iter: int = 4, seed: int = 0) -> SVDResult:
    """Halko-Martinsson-Tropp range finder; the test matrix comes from
    numpy's ``default_rng(seed)`` exactly as in the reference."""
    a = a.to(torch.float64)
    m, n = a.shape
    ell = min(k + oversample, min(m, n))
    omega = np.random.default_rng(seed).standard_normal((n, ell))
    y = a @ torch.from_numpy(omega).to(a.device)
    for _ in range(n_iter):
        y, _ = torch.linalg.qr(y)
        y = a @ (a.T @ y)
    q, _ = torch.linalg.qr(y)
    ub, s, vt = torch.linalg.svd(q.T @ a, full_matrices=False)
    return SVDResult((q @ ub)[:, :k], s[:k], vt[:k, :])


def best_svd(a: torch.Tensor, k: int, randomized_threshold: int = 6144,
             seed: int = 0) -> SVDResult:
    """Dense SVD, or randomized above a ``randomized_threshold`` minor dim
    when k is a small fraction of it (the reference's dispatch)."""
    small = min(a.shape)
    if small > randomized_threshold and k < small // 4:
        return randomized_svd(a, k, seed=seed)
    return truncated_svd(a, k)
