"""NSVD core in torch: SVD/whitening/ASVD/NSVD math in float64, rank
budgets and plans, the compression orchestrator and the runtime linear."""

from .asvd import LowRankFactors, asvd_compress, compress, gram_loss
from .compress import GramStore, compress_matrix, compress_params
from .lowrank import (
    dense_equivalent,
    factors_to_params,
    flops_per_token,
    is_lowrank,
    is_nested,
    linear_apply,
    param_count,
)
from .nsvd import NESTED_METHODS, nested_compress, nsvd_compress, split_rank
from .plan import CompressionConfig, CompressionPlan, TargetSpec, build_plan
from .ratio import achieved_ratio, rank_for_ratio, ratio_for_rank, uniform_ranks
from .svd import SVDResult, best_svd, randomized_svd, truncated_svd
from .whitening import Whitener, make_whitener

# ``from .compress import ...`` binds the submodule ``compress`` on this
# package, shadowing asvd.compress — rebind explicitly.
from .asvd import compress as compress  # noqa: F811,E402
