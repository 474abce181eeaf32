"""``DataParallel`` (port of ``paddle_tpu/distributed/parallel.py``): the
wrapper ``fleet.distributed_model`` returns at dp > 1 without pipeline
stages or tensor parallelism.

The reference shards the batch over the mesh's ``dp`` axis and lets XLA
sum the gradients.  One process of the port holds a replica of the
module on each data position of the global mesh -- dp x sharding, as in
Paddle's hybrid topology (``mesh.replica_count``; ZeRO cuts state over
the sharding axis, ``distributed.sharding``): replica 0 is the module
itself, placed on the first position (``mesh.stage_devices(0)``), and
each further replica a copy on its own (``shards.replicate``).  The
batch's rows split evenly over the replicas; each runs on its copies
tied across the replicas (``shards.tie_slots``), so every copy applies
the sum of the replicas' gradients, bit for bit the same, and the
outputs are joined in row order on replica 0's device: a loss over them
is the reference's.  A model whose sp positions hold copies on devices
of their own (the layered GPT's ``sequence_copies``) is replicated with
them: replica ``r``'s copy for sp position ``s`` is placed on the
mesh's devices at (replica ``r``, sp ``s``) (``mesh.stage_devices``,
handed to ``shards.place_on_stage``), and the replica's own sp ties run
inside its dp binding, so every copy applies the sum over all dp x sp
parts.  ``scale_loss`` and ``apply_collective_grads`` keep the
reference's meaning (the loss is already the batch's mean, the
gradients already summed).

Build the optimizer over the wrapper's ``parameters()``, which hold
every replica's copies, as ``paddle.DataParallel``'s users do: an
optimizer over the bare module's would step replica 0 alone.
"""
from __future__ import annotations

import torch
from torch import nn

from . import mesh as _mesh
from .shards import (
    Bound, load_state, param_slots, place_on_stage, replicate, sync_replicas,
    tie_slots,
)

__all__ = ["DataParallel", "ReplicatedModule"]


def _split(x, n):
    if not isinstance(x, torch.Tensor):
        return [x] * n
    if x.dim() == 0 or x.shape[0] % n:
        raise ValueError(f"an input of shape {tuple(x.shape)} does not split "
                         f"its rows over dp={n} replicas")
    return list(x.split(x.shape[0] // n))


def _join(outs):
    """The replicas' outputs joined in row order on replica 0's device."""
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([o.to(first.device) for o in outs])
    if isinstance(first, (list, tuple)):
        return type(first)(_join(list(z)) for z in zip(*outs))
    raise TypeError(f"replica outputs of type {type(first).__name__}: a "
                    "replicated module returns tensors, or lists or tuples "
                    "of them")


class ReplicatedModule(nn.Module):
    """A module with a copy on each data position (dp x sharding) of the
    global mesh (module docstring); one replica, the module itself,
    without a mesh or at dp = sharding = 1."""

    def __init__(self, layers):
        super().__init__()
        self._layers = layers
        self._replicas = nn.ModuleList()
        dp = _mesh.replica_count()
        if dp > 1:
            place_on_stage(layers, 0, _mesh.stage_devices(0, 0), 0)
            sps = range(1, _mesh.axis_size("sp"))
            for r in range(1, dp):
                copy = replicate(layers)
                place_on_stage(copy, 0, _mesh.stage_devices(0, r), r,
                               sp_devices={s: _mesh.stage_devices(0, r, s)
                                           for s in sps})
                self._replicas.append(copy)

    @property
    def num_replicas(self) -> int:
        return 1 + len(self._replicas)

    def forward(self, *inputs, **kwargs):
        n = self.num_replicas
        if n == 1:
            return self._layers(*inputs, **kwargs)
        args = list(zip(*[_split(x, n) for x in inputs])) or [()] * n
        kws = [dict(zip(kwargs, vals)) for vals in zip(
            *[_split(v, n) for v in kwargs.values()])] or [{}] * n
        models = [self._layers] + list(self._replicas)
        slots = [param_slots([m]) for m in models]
        outs = []
        for m, s, v, a, kw in zip(models, slots, tie_slots(slots), args,
                                  kws):
            with Bound(s, v):
                outs.append(m(*a, **kw))
        return _join(outs)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def load_state_dict(self, state_dict, strict: bool = True,
                        assign: bool = False):
        """The wrapped model's keys, each whole tensor cut into its parts
        and copied to every replica (``shards.load_state``)."""
        missing, unexpected = load_state(self._layers, state_dict, strict)
        sync_replicas(self)
        return nn.modules.module._IncompatibleKeys(missing, unexpected)

    set_state_dict = load_state_dict


class DataParallel(ReplicatedModule):
    """``DataParallel(layers, strategy=None, comm_buffer_size=25,
    last_comm_buffer_size=1, find_unused_parameters=False, group=None)``:
    the reference's arguments; the buffer sizes, ``strategy`` and
    ``group`` are accepted and not read (one process sums the gradients
    in the backward)."""

    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__(layers)
        self.find_unused_parameters = find_unused_parameters

    def scale_loss(self, loss):
        """``loss`` unchanged: it is already the whole batch's mean."""
        return loss

    def apply_collective_grads(self):
        """Nothing: the backward already gave every copy the replicas'
        summed gradient."""
