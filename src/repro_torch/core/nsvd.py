"""NSVD / NID — the paper's nested activation-aware decomposition (Eq. 5),
torch.

Step (5a): rank-k1 activation-aware truncation (ASVD-I or ASVD-II);
step (5b): rank-k2 approximation of the residual, by plain SVD (NSVD) or
by column interpolative decomposition (NID).  O = W1 (Z1 x) + W2 (Z2 x).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .asvd import LowRankFactors, asvd_compress, compress, gram_loss, plain_svd_compress
from .nid import id_compress
from .whitening import make_whitener

ALL_METHODS = (
    "svd", "asvd0", "asvd1", "asvd2", "asvd3", "nsvd1", "nsvd2", "nid1", "nid2",
)
NESTED_METHODS = ("nsvd1", "nsvd2", "nid1", "nid2")


def split_rank(k: int, k1_frac: float) -> tuple[int, int]:
    """k -> (k1, k2) with k1 = round(k1_frac * k) clamped to [1, k]."""
    k = int(k)
    if k <= 0:
        return 0, 0
    k1 = max(1, min(k, int(round(k1_frac * k))))
    return k1, k - k1


def nsvd_compress(a: torch.Tensor, k: int, gram: torch.Tensor,
                  k1_frac: float = 0.95, variant: str = "nsvd2",
                  damp: float = 1e-6, use_randomized: bool = True) -> LowRankFactors:
    """variant: nsvd1 / nid1 whiten step (5a) by Cholesky (Thm 2), nsvd2 /
    nid2 by eigen-SVD (Thm 3); nsvd* take step (5b) by SVD, nid* by
    column ID."""
    v = variant.lower()
    if v not in NESTED_METHODS:
        raise ValueError(f"unknown nested variant {variant!r}")
    a = a.to(torch.float64)
    k1, k2 = split_rank(k, k1_frac)
    if k1 == 0:
        raise ValueError("rank budget must be >= 1")
    whit = make_whitener("asvd1" if v.endswith("1") else "asvd2", gram=gram, damp=damp)
    first, _ = asvd_compress(a, k1, whit, use_randomized=use_randomized)
    if k2 == 0:
        return LowRankFactors(first.w, first.z, method=v)
    residual = a - first.matrix()
    if v.startswith("nid"):
        second = id_compress(residual, k2)
    else:
        second = plain_svd_compress(residual, k2, use_randomized=use_randomized)
    return LowRankFactors(w=first.w, z=first.z, w2=second.w, z2=second.z,
                          method=v)


def nested_compress(a: torch.Tensor, k: int, method: str,
                    gram: Optional[torch.Tensor] = None,
                    absmean: Optional[torch.Tensor] = None,
                    k1_frac: float = 0.95, damp: float = 1e-6,
                    use_randomized: bool = True) -> LowRankFactors:
    """Façade over every compressor of the paper (ALL_METHODS)."""
    m = method.lower()
    if m in NESTED_METHODS:
        if gram is None:
            raise ValueError(f"{method} requires a calibration Gram")
        return nsvd_compress(a, k, gram, k1_frac=k1_frac, variant=m, damp=damp,
                             use_randomized=use_randomized)
    return compress(a, k, m, gram=gram, absmean=absmean, damp=damp,
                    use_randomized=use_randomized)


def decomposition_diagnostics(a: torch.Tensor, factors: LowRankFactors,
                              gram: Optional[torch.Tensor] = None,
                              compare_plain: bool = True,
                              use_randomized: bool = False) -> Dict[str, float]:
    """Pure observation of a finished decomposition, in fp64 on the device
    of ``a`` (never mutates its inputs):

      plain_rel_err      ||A - Ã||_F / ||A||_F
      whitened_rel_err   ||(A - Ã) X||_F / ||A X||_F, from the Gram only
      sv_tail_mass       whitened_rel_err² (the whitened singular-value tail
                         at the chosen rank, by Eckart–Young)
      outlier_absorption 1 - whitened loss / rank-matched plain-SVD
                         whitened loss (one extra truncated SVD; nan when
                         ``compare_plain`` is False)
      k1 / k2            the nested split used.
    """
    a = a.to(torch.float64)
    approx = factors.matrix().to(torch.float64)
    fro_a = float(torch.linalg.norm(a))
    k1 = int(factors.w.shape[1])
    k2 = int(factors.w2.shape[1]) if factors.nested else 0
    out: Dict[str, float] = {
        "rank": float(factors.rank),
        "k1": float(k1),
        "k2": float(k2),
        "param_count": float(factors.param_count()),
        "plain_rel_err": float(torch.linalg.norm(a - approx)) / max(fro_a, 1e-300),
        "whitened_rel_err": float("nan"),
        "sv_tail_mass": float("nan"),
        "outlier_absorption": float("nan"),
    }
    if gram is None:
        return out
    g = gram.to(torch.float64)
    g = 0.5 * (g + g.T)
    total = gram_loss(a, torch.zeros_like(a), g)  # ||A X||_F
    whit = gram_loss(a, approx, g)
    out["whitened_rel_err"] = whit / max(total, 1e-300)
    out["sv_tail_mass"] = (whit / max(total, 1e-300)) ** 2
    if compare_plain:
        base = plain_svd_compress(a, factors.rank, use_randomized=use_randomized)
        out["outlier_absorption"] = 1.0 - whit / max(
            gram_loss(a, base.matrix(), g), 1e-300)
    return out
