"""The parallelism layer on ``torch.distributed`` (the reference's
``parallel``): sharding rules, each rank's local shards, and the counted
collectives of the explicit SPMD path."""

from .sharding import (
    NONE_PARALLEL,
    AbstractMesh,
    LocalParams,
    NamedSharding,
    P,
    Parallelism,
    gather_params,
    make_parallelism,
    param_pspec,
    param_pspecs,
    param_shardings,
    shard_params,
)
