"""Activation whitening transforms S extracted from calibration Grams
(torch float64 twin of the reference's ``core/whitening.py``).

  ASVD-0   S = diag(mean_i |x_i|)
  ASVD-I   S = Cholesky factor of X X^T        (falls back to ASVD-II)
  ASVD-II  S = P Lambda^{1/2} from X X^T = P Lambda P^T
  ASVD-III S = P * gamma, gamma = max sqrt(eig)  (Thm 4, the failure trial)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class Whitener:
    """S (matrix, or vector when diagonal) and its (pseudo-)inverse."""

    s: torch.Tensor
    s_inv: torch.Tensor
    diagonal: bool
    rank: int
    method: str

    def apply_right(self, a: torch.Tensor) -> torch.Tensor:
        """A @ S."""
        a = a.to(self.s.dtype)
        return a * self.s[None, :] if self.diagonal else a @ self.s

    def unapply_right(self, b: torch.Tensor) -> torch.Tensor:
        """B @ S^{-1}."""
        b = b.to(self.s_inv.dtype)
        return b * self.s_inv[None, :] if self.diagonal else b @ self.s_inv


def _regularize(gram: torch.Tensor, damp: float) -> torch.Tensor:
    """Symmetrize + dampen by ``damp`` x mean diagonal (GPTQ's percdamp)."""
    g = gram.to(torch.float64)
    g = 0.5 * (g + g.T)
    if damp > 0.0:
        mean_diag = float(torch.diagonal(g).mean())
        g = g + damp * max(mean_diag, 1e-12) * torch.eye(
            g.shape[0], dtype=g.dtype, device=g.device)
    return g


def diag_absmean_whitener(absmean: torch.Tensor, eps: float = 1e-6) -> Whitener:
    d = absmean.to(torch.float64).clamp(min=eps)
    return Whitener(s=d, s_inv=1.0 / d, diagonal=True, rank=d.shape[0],
                    method="asvd0")


def make_cholesky_whitener(gram: torch.Tensor, damp: float = 1e-6) -> Whitener:
    """ASVD-I (SVD-LLM): S = lower Cholesky factor of X X^T."""
    g = _regularize(gram, damp)
    l, info = torch.linalg.cholesky_ex(g)
    if int(info) != 0:
        del g, l  # two (n, n) fp64 the fallback does not need beside its own
        return make_eigen_whitener(gram, damp=damp, method="asvd1_fallback")
    eye = torch.eye(g.shape[0], dtype=g.dtype, device=g.device)
    s_inv = torch.linalg.solve_triangular(l, eye, upper=False)
    return Whitener(s=l, s_inv=s_inv, diagonal=False, rank=g.shape[0],
                    method="asvd1")


def make_eigen_whitener(gram: torch.Tensor, damp: float = 0.0,
                        rank_rtol: float = 1e-10,
                        method: str = "asvd2") -> Whitener:
    """ASVD-II: S = P Lambda^{1/2}; zero eigenvalues via the pseudo-inverse."""
    g = _regularize(gram, damp)
    lam, p = torch.linalg.eigh(g)  # ascending
    lam = lam.flip(0).clamp(min=0.0)
    p = p.flip(1)
    if float(lam[0]) <= 0.0:
        ones = torch.ones(g.shape[0], dtype=g.dtype, device=g.device)
        return Whitener(ones, ones, True, 0, method)
    cutoff = float(lam[0]) * rank_rtol
    keep = lam > cutoff
    sqrt_lam = torch.sqrt(lam)
    inv_sqrt = torch.where(keep, 1.0 / sqrt_lam.clamp(min=1e-300),
                           torch.zeros_like(lam))
    return Whitener(s=p * sqrt_lam[None, :], s_inv=inv_sqrt[:, None] * p.T,
                    diagonal=False, rank=int(keep.sum()), method=method)


def make_gamma_whitener(gram: torch.Tensor, damp: float = 0.0) -> Whitener:
    """ASVD-III (Thm 4): S = P * gamma with gamma = max(Lambda^{1/2}), a
    rotation and a scalar scale; gamma = 1 for an all-zero Gram."""
    g = _regularize(gram, damp)
    lam, p = torch.linalg.eigh(g)  # ascending
    lam = lam.flip(0).clamp(min=0.0)
    p = p.flip(1)
    top = float(lam[0])
    gamma = math.sqrt(top) if top > 0.0 else 1.0
    rank = int((lam > top * 1e-10).sum()) if top > 0.0 else 0
    return Whitener(s=p * gamma, s_inv=p.T / gamma, diagonal=False, rank=rank,
                    method="asvd3")


def make_whitener(method: str, gram: Optional[torch.Tensor] = None,
                  absmean: Optional[torch.Tensor] = None,
                  damp: float = 1e-6) -> Whitener:
    m = method.lower()
    if m in ("asvd0", "diag"):
        if absmean is None:
            if gram is None:
                raise ValueError("asvd0 needs absmean or gram")
            absmean = torch.sqrt(torch.diagonal(gram.to(torch.float64)).clamp(min=0.0))
        return diag_absmean_whitener(absmean)
    if gram is None:
        raise ValueError(f"{method} needs a Gram matrix")
    if m in ("asvd1", "cholesky", "svd-llm"):
        return make_cholesky_whitener(gram, damp=damp)
    if m in ("asvd2", "eigen", "svd"):
        return make_eigen_whitener(gram, damp=damp)
    if m in ("asvd3", "gamma"):
        return make_gamma_whitener(gram, damp=damp)
    raise ValueError(f"unknown whitening method {method!r}")
