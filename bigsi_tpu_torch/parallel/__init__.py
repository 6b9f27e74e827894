from bigsi_tpu_torch.parallel.sharding import (
    AXIS_BATCH,
    AXIS_KMERS,
    AXIS_ROWS,
    AXIS_SAMPLES,
    Mesh,
    MeshEngine,
    factor_devices,
    make_mesh,
    make_row_mesh,
    make_sharded_query_step,
    shard_matrix,
)

__all__ = [
    "AXIS_BATCH",
    "AXIS_KMERS",
    "AXIS_ROWS",
    "AXIS_SAMPLES",
    "Mesh",
    "MeshEngine",
    "factor_devices",
    "make_mesh",
    "make_row_mesh",
    "make_sharded_query_step",
    "shard_matrix",
]
