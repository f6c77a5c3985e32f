"""Compression-ratio -> rank budgeting.

Paper convention (following ASVD / SVD-LLM): "compression ratio r" means r of
the original parameters are REMOVED; a rank-k factorization of an (m, n)
matrix stores (m + n) * k parameters, so the per-matrix rank for uniform
ratio r is

    k(m, n, r) = floor((1 - r) * m * n / (m + n)).

Beyond the paper we add:
  * TPU-friendly rounding — ranks rounded to a multiple of `multiple_of`
    (128 aligns the contracted dim of both skinny GEMMs with the MXU;
    rounding direction chosen to respect the global budget).
  * Importance-weighted global allocation — spends a global rank budget
    across matrices proportionally to their truncation-loss tails (the
    sigma_i of A S are exact losses per Thm 2/3), instead of uniformly.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Sequence

import numpy as np


def rank_for_ratio(m: int, n: int, ratio: float, multiple_of: int = 1) -> int:
    """Largest rank whose storage is <= (1 - ratio) of the dense matrix."""
    if not 0.0 <= ratio < 1.0:
        raise ValueError(f"ratio must be in [0, 1), got {ratio}")
    budget = (1.0 - ratio) * m * n
    k = int(budget // (m + n))
    k = max(1, k)
    if multiple_of > 1:
        k = _align_rank(k, multiple_of, m, n)
    return k


def _align_rank(k: int, multiple_of: int, m: int, n: int) -> int:
    """Round a budget-respecting rank onto the alignment grid.

    Rounds DOWN so the aligned rank never stores more than the unaligned
    one (the caller's budget).  The single exception is k < multiple_of,
    where the floor would be rank zero: we return one ``multiple_of``
    (the documented minimum) even though it may exceed the budget.
    Always capped at the rank where factorization stops compressing.
    """
    down = (k // multiple_of) * multiple_of
    k = down if down >= multiple_of else multiple_of
    return min(k, max(1, (m * n) // (m + n)))


def ratio_for_rank(m: int, n: int, k: int) -> float:
    """Fraction of parameters removed by a rank-k factorization."""
    return 1.0 - (m + n) * k / (m * n)


@dataclasses.dataclass(frozen=True)
class MatrixSpec:
    """A compressible matrix: its shape and the Gram it whitens against."""

    name: str
    m: int  # output dim (rows of A in paper orientation)
    n: int  # input dim (cols of A; Gram is (n, n))
    gram_key: str
    count: int = 1  # replication (e.g. stacked scan layers share a spec)

    @property
    def dense_params(self) -> int:
        return self.m * self.n * self.count


def uniform_ranks(
    specs: Sequence[MatrixSpec], ratio: float, multiple_of: int = 1
) -> Dict[str, int]:
    """Paper's allocation: every matrix compressed at the same ratio."""
    return {s.name: rank_for_ratio(s.m, s.n, ratio, multiple_of) for s in specs}


def importance_ranks(
    specs: Sequence[MatrixSpec],
    ratio: float,
    tail_losses: Mapping[str, np.ndarray],
    multiple_of: int = 1,
    floor_frac: float = 0.25,
) -> Dict[str, int]:
    """Beyond-paper global allocation using exact per-direction losses.

    ``tail_losses[name]`` are the singular values of A S (descending) — by
    Thm 2/3 sigma_i is exactly the loss of dropping direction i.  We start
    every matrix at ``floor_frac`` of its uniform rank and greedily spend the
    remaining global parameter budget on the directions with the largest
    loss-per-parameter sigma_i^2 / (m + n).
    """
    budget = int(sum((1.0 - ratio) * s.dense_params for s in specs))
    ranks: Dict[str, int] = {}
    spent = 0
    heap: list[tuple[float, int, str, int]] = []  # (-gain, next_i, name, m+n)
    import heapq

    by_name = {s.name: s for s in specs}
    for s in specs:
        k0 = max(1, int(rank_for_ratio(s.m, s.n, ratio) * floor_frac))
        ranks[s.name] = k0
        spent += (s.m + s.n) * k0 * s.count
        sig = np.asarray(tail_losses[s.name], dtype=np.float64)
        if k0 < sig.shape[0]:
            gain = float(sig[k0] ** 2) / (s.m + s.n)
            heapq.heappush(heap, (-gain, k0, s.name, (s.m + s.n) * s.count))
    while heap:
        neg_gain, i, name, cost = heapq.heappop(heap)
        if spent + cost > budget:
            continue
        spent += cost
        ranks[name] = i + 1
        sig = np.asarray(tail_losses[name], dtype=np.float64)
        s = by_name[name]
        if i + 1 < sig.shape[0] and i + 1 < (s.m * s.n) // (s.m + s.n):
            gain = float(sig[i + 1] ** 2) / (s.m + s.n)
            heapq.heappush(heap, (-gain, i + 1, name, cost))
    if multiple_of > 1:
        for name in ranks:
            s = by_name[name]
            ranks[name] = _align_rank(ranks[name], multiple_of, s.m, s.n)
    return ranks


def achieved_ratio(specs: Sequence[MatrixSpec], ranks: Mapping[str, int]) -> float:
    """Realized parameter-removal fraction for a rank assignment."""
    dense = sum(s.dense_params for s in specs)
    comp = sum((s.m + s.n) * ranks[s.name] * s.count for s in specs)
    return 1.0 - comp / dense
