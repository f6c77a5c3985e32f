"""NSVD core in torch: SVD/whitening/ASVD/NSVD/NID math in float64, rank
budgets and plans, the compression orchestrator and the runtime linear.

Public API (the reference's ``repro.core``):
  - svd: truncated_svd, randomized_svd, best_svd
  - whitening: make_whitener (ASVD-0/I/II/III transforms)
  - asvd: compress (single factorization), activation_loss, gram_loss
  - nid: column_id, id_compress
  - nsvd: nested_compress (NSVD-I/II, NID-I/II), split_rank, ALL_METHODS
  - ratio: rank_for_ratio, uniform_ranks, importance_ranks
  - lowrank: linear_apply (runtime), factors_to_params
  - plan/compress: build_plan, compress_model, GramStore
"""

from .asvd import LowRankFactors, activation_loss, asvd_compress, compress, gram_loss
from .compress import GramStore, compress_matrix, compress_model, compress_params
from .lowrank import (
    dense_equivalent,
    factors_to_params,
    flops_per_token,
    is_lowrank,
    is_nested,
    linear_apply,
    param_count,
)
from .nid import column_id, id_compress
from .nsvd import (
    ALL_METHODS,
    NESTED_METHODS,
    decomposition_diagnostics,
    nested_compress,
    nsvd_compress,
    split_rank,
)
from .plan import CompressionConfig, CompressionPlan, TargetSpec, build_plan
from .ratio import (
    MatrixSpec,
    achieved_ratio,
    importance_ranks,
    rank_for_ratio,
    ratio_for_rank,
    uniform_ranks,
)
from .svd import SVDResult, best_svd, randomized_svd, truncated_svd
from .whitening import Whitener, make_whitener

# ``from .compress import ...`` binds the submodule ``compress`` on this
# package, shadowing asvd.compress — rebind explicitly.
from .asvd import compress as compress  # noqa: F811,E402
