"""Multi-device helpers of the port (``paddle_tpu/distributed``): the
serving mesh of ``dp`` replicas x ``mp`` head shards, driven by one
process."""
from . import serving_mesh
from .serving_mesh import (
    clone_model, mp_size, replica_meshes, shard_model_for_serving,
    shard_paged_cache, unshard_model, validate_head_sharding,
    shard_weight_bytes, weight_bytes_by_device,
)

__all__ = ["serving_mesh", "replica_meshes", "mp_size",
           "validate_head_sharding", "shard_model_for_serving",
           "shard_paged_cache", "clone_model", "unshard_model",
           "weight_bytes_by_device", "shard_weight_bytes"]
