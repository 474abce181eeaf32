"""``TensorParallel`` (port of
``paddle_tpu/distributed/fleet/meta_parallel/tensor_parallel.py``): the
wrapper ``fleet.distributed_model`` returns at mp > 1 without pipeline
stages.  The mpu layers already cut the weights and run Megatron's
forward, so it delegates: ``forward``, ``state_dict`` (the wrapped
model's keys) and ``set_state_dict`` / ``load_state_dict``."""
from __future__ import annotations

from torch import nn

from ...shards import load_state

__all__ = ["TensorParallel"]


class TensorParallel(nn.Module):
    def __init__(self, layers, hcg=None, **kwargs):
        super().__init__()
        self._layers = layers
        self._hcg = hcg

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def load_state_dict(self, state_dict, strict: bool = True,
                        assign: bool = False):
        """The wrapped model's keys, each whole tensor cut into its parts
        (``shards.load_state``)."""
        return nn.modules.module._IncompatibleKeys(
            *load_state(self._layers, state_dict, strict))

    set_state_dict = load_state_dict
