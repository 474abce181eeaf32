"""Multi-device helpers of the port (``paddle_tpu/distributed``), driven by
one process: the global mesh (``mesh``), the training placement's shards
(``shards``), the microbatch pipeline (``pp_spmd``), the serving mesh
of ``dp`` replicas x ``mp`` head shards (``serving_mesh``), and the fleet
API (``fleet``: ``init``, the mpu layers, ``PipelineLayer`` and the
1F1B ``PipelineParallel``), imported as ``distributed.fleet``, and
``DataParallel`` (``parallel``); ZeRO's ``group_sharded_parallel``
(``sharding``)."""
from . import mesh, pp_spmd, serving_mesh, sharding, shards
from .parallel import DataParallel
from .mesh import build_mesh, get_mesh, has_mesh, set_mesh
from .serving_mesh import (
    clone_model, mp_size, replica_meshes, shard_model_for_serving,
    shard_paged_cache, unshard_model, validate_head_sharding,
    shard_weight_bytes, weight_bytes_by_device,
)
from .shards import state_bytes_by_position, weight_bytes_by_position

__all__ = ["DataParallel", "mesh", "pp_spmd", "serving_mesh", "sharding",
           "shards", "state_bytes_by_position",
           "build_mesh", "set_mesh", "get_mesh", "has_mesh",
           "replica_meshes", "mp_size",
           "validate_head_sharding", "shard_model_for_serving",
           "shard_paged_cache", "clone_model", "unshard_model",
           "weight_bytes_by_device", "shard_weight_bytes",
           "weight_bytes_by_position"]
