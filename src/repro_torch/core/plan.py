"""Compression plans: which matrices get factored, at what rank, how.

A model definition exposes ``compressible_matrices(cfg) -> list[TargetSpec]``
describing every weight it is willing to factorize: the pytree path of the
{"kernel": ...} leaf, its logical (in, out) shape, how many stacked copies the
leaf holds (scan-over-layers models stack an (L, in, out) kernel), and the
Gram key whose activations whiten it.  ``build_plan`` turns those specs plus a
CompressionConfig into concrete per-matrix ranks.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence, Tuple

import numpy as np

from .ratio import (
    MatrixSpec,
    achieved_ratio,
    importance_ranks,
    rank_for_ratio,
    ratio_for_rank,
    uniform_ranks,
)


@dataclasses.dataclass(frozen=True)
class TargetSpec:
    """One compressible kernel leaf in the param pytree.

    ``stacked`` holds the leading batch dims of the kernel leaf:
      ()        plain (in, out) kernel
      (L,)      scan-over-layers stack
      (L, E)    scanned MoE expert stack (layers x experts)
    Per-slice Grams are looked up as f"{gram_key}/{i0}/{i1}/..." with the
    shared ``gram_key`` as fallback.
    """

    path: Tuple[str, ...]  # pytree path to the dict holding "kernel"
    in_dim: int
    out_dim: int
    gram_key: str
    stacked: Tuple[int, ...] = ()
    per_layer_gram: bool = True  # look up per-slice gram keys first

    @property
    def name(self) -> str:
        return "/".join(self.path)

    @property
    def count(self) -> int:
        c = 1
        for s in self.stacked:
            c *= s
        return c

    def matrix_spec(self) -> MatrixSpec:
        # Paper orientation: A is (out, in) => m = out_dim, n = in_dim.
        return MatrixSpec(
            name=self.name,
            m=self.out_dim,
            n=self.in_dim,
            gram_key=self.gram_key,
            count=self.count,
        )


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """User-facing knobs (paper defaults)."""

    method: str = "nsvd1"  # svd|asvd0|asvd1|asvd2|asvd3|nsvd1|nsvd2|nid1|nid2
    ratio: float = 0.3  # fraction of params removed
    k1_frac: float = 0.95  # nested split (Table 3 sweeps this)
    allocation: str = "uniform"  # uniform | importance (beyond-paper)
    multiple_of: int = 1  # 128 for MXU-aligned deployment ranks
    damp: float = 1e-6
    use_randomized: bool = True
    min_dim: int = 8  # skip tiny matrices (norm scales, routers)
    dtype: str = "bfloat16"


@dataclasses.dataclass(frozen=True)
class CompressionPlan:
    config: CompressionConfig
    targets: Tuple[TargetSpec, ...]
    ranks: Mapping[str, int]  # per TargetSpec.name

    @property
    def achieved_ratio(self) -> float:
        return achieved_ratio([t.matrix_spec() for t in self.targets], self.ranks)

    def rank_of(self, spec: TargetSpec) -> int:
        return self.ranks[spec.name]

    def target_rows(self) -> list:
        """Structured per-target summary: the assigned rank next to the
        unaligned budget rank for the requested ratio, and the per-target
        achieved ratio with its delta against the request — so a plan
        artifact is self-describing about where alignment/min-rank
        rounding spent or saved budget."""
        rows = []
        for t in self.targets:
            k = self.ranks[t.name]
            m, n = t.out_dim, t.in_dim
            requested = rank_for_ratio(m, n, self.config.ratio)
            ach = ratio_for_rank(m, n, k)
            rows.append({
                "target": t.name,
                "shape": [m, n],
                "stacked": list(t.stacked),
                "rank": int(k),
                "requested_rank": int(requested),
                "achieved_ratio": ach,
                "ratio_delta": ach - self.config.ratio,
            })
        return rows

    def summary(self) -> str:
        lines = [
            f"method={self.config.method} ratio={self.config.ratio} "
            f"k1_frac={self.config.k1_frac} "
            f"achieved_ratio={self.achieved_ratio:.4f} "
            f"(delta {self.achieved_ratio - self.config.ratio:+.4f})"
        ]
        for r in self.target_rows():
            stack = "x".join(str(s) for s in r["stacked"])
            m, n = r["shape"]
            req = ""
            if r["rank"] != r["requested_rank"]:
                req = f" (requested {r['requested_rank']})"
            lines.append(
                f"  {r['target']}: ({m}x{n})"
                f"{'x' + stack if stack else ''} -> rank {r['rank']}{req}"
                f" ratio={r['achieved_ratio']:.4f}"
                f" (delta {r['ratio_delta']:+.4f})"
            )
        return "\n".join(lines)


def build_plan(
    targets: Sequence[TargetSpec],
    config: CompressionConfig,
    tail_losses: Optional[Mapping[str, np.ndarray]] = None,
) -> CompressionPlan:
    """Assign ranks.  ``tail_losses`` enables the importance allocator."""
    targets = tuple(
        t for t in targets if min(t.in_dim, t.out_dim) >= config.min_dim
    )
    specs = [t.matrix_spec() for t in targets]
    if config.allocation == "uniform" or tail_losses is None:
        ranks = uniform_ranks(specs, config.ratio, config.multiple_of)
    elif config.allocation == "importance":
        ranks = importance_ranks(
            specs, config.ratio, tail_losses, multiple_of=config.multiple_of
        )
    else:
        raise ValueError(f"unknown allocation {config.allocation!r}")
    return CompressionPlan(config=config, targets=targets, ranks=ranks)
