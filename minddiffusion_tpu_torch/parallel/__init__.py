from minddiffusion_tpu_torch.parallel.mesh import (
    MeshConfig,
    assert_tp_effective,
    batch_sharding,
    make_mesh,
    replicate,
    shard_batch,
    shard_params,
    tp_report,
)

__all__ = [
    "MeshConfig", "assert_tp_effective", "batch_sharding", "make_mesh", "replicate",
    "shard_batch", "shard_params", "tp_report",
]
