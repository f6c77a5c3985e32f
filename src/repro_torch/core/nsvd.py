"""NSVD — the paper's nested activation-aware decomposition (Eq. 5), torch.

Step (5a): rank-k1 activation-aware truncation (ASVD-I or ASVD-II);
step (5b): rank-k2 plain SVD of the residual.  O = W1 (Z1 x) + W2 (Z2 x).
The column-ID residual (NID) is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from .asvd import LowRankFactors, asvd_compress, compress, plain_svd_compress
from .whitening import make_whitener

NESTED_METHODS = ("nsvd1", "nsvd2")


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
    v = variant.lower()
    if v not in NESTED_METHODS:
        raise ValueError(f"nested variant {variant!r} is not ported")
    a = a.to(torch.float64)
    k1, k2 = split_rank(k, k1_frac)
    if k1 == 0:
        raise ValueError("rank budget must be >= 1")
    whit = make_whitener("asvd1" if v == "nsvd1" else "asvd2", gram=gram, damp=damp)
    first, _ = asvd_compress(a, k1, whit, use_randomized=use_randomized)
    if k2 == 0:
        return LowRankFactors(first.w, first.z, method=v)
    second = plain_svd_compress(a - first.matrix(), k2,
                                use_randomized=use_randomized)
    return LowRankFactors(w=first.w, z=first.z, w2=second.w, z2=second.z,
                          method=v)


def nested_compress(a: torch.Tensor, k: int, method: str,
                    gram: Optional[torch.Tensor] = None,
                    absmean: Optional[torch.Tensor] = None,
                    k1_frac: float = 0.95, damp: float = 1e-6,
                    use_randomized: bool = True) -> LowRankFactors:
    """Façade over the ported compressors: svd, asvd0/1/2, nsvd1/2."""
    m = method.lower()
    if m in NESTED_METHODS:
        if gram is None:
            raise ValueError(f"{method} requires a calibration Gram")
        return nsvd_compress(a, k, gram, k1_frac=k1_frac, variant=m, damp=damp,
                             use_randomized=use_randomized)
    return compress(a, k, m, gram=gram, absmean=absmean, damp=damp,
                    use_randomized=use_randomized)
