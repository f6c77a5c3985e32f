"""Activation-aware SVD compressors (torch float64): SVD, ASVD-0/I/II.

Each maps (A, calibration stats, rank k) -> (W, Z) with A ~= W @ Z.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .svd import SVDResult, best_svd, truncated_svd
from .whitening import Whitener, make_whitener


@dataclasses.dataclass(frozen=True)
class LowRankFactors:
    """A ~= w @ z  (w: (m, k), z: (k, n)); optionally a nested second pair."""

    w: torch.Tensor
    z: torch.Tensor
    w2: Optional[torch.Tensor] = None
    z2: Optional[torch.Tensor] = None
    method: str = "svd"

    @property
    def rank(self) -> int:
        return int(self.w.shape[1]) + (int(self.w2.shape[1]) if self.nested else 0)

    @property
    def nested(self) -> bool:
        return self.w2 is not None

    def matrix(self) -> torch.Tensor:
        a = self.w @ self.z
        if self.nested:
            a = a + self.w2 @ self.z2
        return a


def plain_svd_compress(a: torch.Tensor, k: int,
                       use_randomized: bool = True) -> LowRankFactors:
    """Standard SVD baseline (activation-unaware)."""
    res = best_svd(a, k) if use_randomized else truncated_svd(a, k)
    w, z = res.factors("sqrt")
    return LowRankFactors(w, z, method="svd")


def asvd_compress(a: torch.Tensor, k: int, whitener: Whitener,
                  use_randomized: bool = True) -> Tuple[LowRankFactors, SVDResult]:
    """SVD(A S), truncate to k, unwhiten the right factor."""
    aw = whitener.apply_right(a.to(torch.float64))
    res = best_svd(aw, k) if use_randomized else truncated_svd(aw, k)
    w, z_whit = res.factors("sqrt")
    return LowRankFactors(w, whitener.unapply_right(z_whit),
                          method=whitener.method), res


def gram_loss(a: torch.Tensor, approx: torch.Tensor, gram: torch.Tensor) -> float:
    """sqrt(tr((A-B) G (A-B)^T)) == ||(A-B) X||_F from the Gram only."""
    d = a.to(torch.float64) - approx.to(torch.float64)
    val = float(torch.einsum("ij,jk,ik->", d, gram.to(torch.float64), d))
    return max(val, 0.0) ** 0.5


def compress(a: torch.Tensor, k: int, method: str = "asvd2",
             gram: Optional[torch.Tensor] = None,
             absmean: Optional[torch.Tensor] = None, damp: float = 1e-6,
             use_randomized: bool = True) -> LowRankFactors:
    """One-call façade for the non-nested methods."""
    m = method.lower()
    if m in ("svd", "plain"):
        return plain_svd_compress(a, k, use_randomized)
    whit = make_whitener(m, gram=gram, absmean=absmean, damp=damp)
    return asvd_compress(a, k, whit, use_randomized)[0]
