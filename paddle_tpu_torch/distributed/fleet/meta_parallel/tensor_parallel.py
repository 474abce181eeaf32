"""``TensorParallel`` (port of
``paddle_tpu/distributed/fleet/meta_parallel/tensor_parallel.py``): the
wrapper ``fleet.distributed_model`` returns at mp > 1 without pipeline
stages.  The mpu layers already cut the weights and run Megatron's
forward, so it delegates: ``forward``, ``state_dict`` (the wrapped
model's keys) and ``set_state_dict`` / ``load_state_dict``.  At dp > 1 it
holds a replica of the placed model on each dp position, as
``DataParallel`` does (``distributed/parallel.py``)."""
from __future__ import annotations

from ...parallel import ReplicatedModule

__all__ = ["TensorParallel"]


class TensorParallel(ReplicatedModule):
    def __init__(self, layers, hcg=None, **kwargs):
        super().__init__(layers)
        self._hcg = hcg
