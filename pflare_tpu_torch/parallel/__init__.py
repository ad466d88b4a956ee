from .halo import HaloELL, HaloSpMV
from .mesh import (
    ROW_AXIS,
    make_mesh,
    replicate,
    replicated,
    row_sharding,
    shard_ell,
    shard_hierarchy,
    shard_vec,
)
from .repartition import (
    active_shards_schedule,
    coarse_repartition_perm,
    interleaved_partition,
    local_nonlocal_nnz_ratio,
    should_agglomerate,
)
from .tsqr import make_qr_reduce, tsqr_r

__all__ = [
    "tsqr_r",
    "HaloSpMV",
    "HaloELL",
    "make_qr_reduce",
    "local_nonlocal_nnz_ratio",
    "should_agglomerate",
    "active_shards_schedule",
    "interleaved_partition",
    "coarse_repartition_perm",
    "make_mesh",
    "row_sharding",
    "replicated",
    "shard_ell",
    "shard_vec",
    "replicate",
    "shard_hierarchy",
    "ROW_AXIS",
]
