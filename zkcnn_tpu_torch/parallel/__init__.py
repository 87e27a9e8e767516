from .context import Mesh, make_mesh, active_mesh, use_mesh, shard_rows, \
    replicate, gather_rows, COUNTS, reset_counts
from .sharding import (sharded_fold_coeffs, sharded_ntt, stage_sharded_ntt,
                       sharded_segment_sum, sharded_dot, sharded_msm,
                       ShardedMSM)

__all__ = ["Mesh", "make_mesh", "active_mesh", "use_mesh", "shard_rows",
           "replicate", "gather_rows", "COUNTS", "reset_counts",
           "sharded_fold_coeffs", "sharded_ntt", "stage_sharded_ntt",
           "sharded_segment_sum", "sharded_dot", "sharded_msm", "ShardedMSM"]
