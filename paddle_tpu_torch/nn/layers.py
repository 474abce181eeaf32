"""The layers the ported models are built of (counterparts of
``paddle_tpu/nn/modules/common.py`` ``Linear`` and ``Dropout`` and of
``nn/modules/norm.py`` ``LayerNorm``), in the JAX package's layout, so a
JAX module's ``state_dict()`` keys and shapes are the port's:
``Linear.weight`` is ``[in, out]`` (``x @ weight``), not ``nn.Linear``'s
``[out, in]``.

Also what every ported model of these layers shares: :class:`PortModule`
(device and dtype resolution and ``load_jax_state``), :func:`load_jax_state`,
which carries a JAX module's weights across, and :func:`init_weights`,
which draws fresh ones from a seed.
"""
from __future__ import annotations

import contextlib
import math
from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from ..core import resolve_device, to_torch_dtype
from . import functional as F

__all__ = ["Linear", "LayerNorm", "Dropout", "PortModule", "load_jax_state",
           "init_weights"]


class Linear(nn.Module):
    """``y = x @ weight + bias``, ``weight`` ``[in_features,
    out_features]``.  Parameters are allocated, not initialised: the model
    that owns the layer draws them (:func:`init_weights`)."""

    def __init__(self, in_features: int, out_features: int, *,
                 bias: bool = True, device=None, dtype=None):
        super().__init__()
        factory = dict(device=device, dtype=dtype)
        self.weight = nn.Parameter(torch.empty((in_features, out_features),
                                               **factory))
        self.bias = (nn.Parameter(torch.empty((out_features,), **factory))
                     if bias else None)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis, gain ``weight`` and shift ``bias``
    (the JAX ``LayerNorm``; its ``_epsilon`` is ``epsilon`` here)."""

    def __init__(self, hidden: int, epsilon: float = 1e-5, *, device=None,
                 dtype=None):
        super().__init__()
        self.epsilon = float(epsilon)
        self.weight = nn.Parameter(torch.ones((hidden,), device=device,
                                              dtype=dtype))
        self.bias = nn.Parameter(torch.zeros((hidden,), device=device,
                                             dtype=dtype))

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1], self.weight, self.bias,
                            self.epsilon)


class Dropout(nn.Module):
    """:func:`F.dropout` as a layer, in the reference's order ``(p, axis,
    mode)``: applied in training mode, drawn from ``generator`` (``None``:
    PyTorch's default generator), or from the one a call passes; in eval
    mode the identity (``"upscale_in_train"``) or a multiplication by
    ``1 - p`` (``"downscale_in_infer"``)."""

    def __init__(self, p: float = 0.5, axis=None,
                 mode: str = "upscale_in_train", name=None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.p = float(p)
        self.axis = axis
        self.mode = mode
        self.generator = generator

    def forward(self, x, generator: Optional[torch.Generator] = None):
        return F.dropout(x, self.p, self.axis, self.training, self.mode,
                         generator=self.generator if generator is None
                         else generator)


class PortModule(nn.Module):
    """A ported module a user builds: ``device`` (``None``: the card) and
    ``dtype`` resolved once by :meth:`_place`, and the JAX module's weights
    taken by :meth:`load_jax_state`."""

    def _place(self, device, dtype) -> dict:
        self.device = resolve_device(device)
        self.dtype = to_torch_dtype(dtype)
        return dict(device=self.device, dtype=self.dtype)

    def load_jax_state(self, state: Mapping[str, np.ndarray]):
        """Copy the JAX module's ``state_dict()`` (numpy arrays keyed as the
        JAX module keys them); missing, unknown or mis-shaped keys
        raise."""
        load_jax_state(self, state)


@torch.no_grad()
def init_weights(module: nn.Module, seed: int, std: Optional[float] = None):
    """Fresh weights for every ``Linear`` and ``nn.Embedding`` of
    ``module`` (and every mpu layer: ``ColumnParallelLinear`` and
    ``RowParallelLinear`` as a ``Linear``, ``VocabParallelEmbedding`` as
    an embedding, each whole tensor drawn and then cut into its parts),
    drawn in module order from ``torch.Generator(seed)`` on the first
    weight's device (and copied to each weight's own): N(0, ``std``), or
    with ``std`` None Xavier-uniform over a Linear's ``[in, out]``.
    Biases 0; LayerNorms keep gain 1, shift 0.  A dp replica's copies
    (``shards.replicate``) draw nothing: they take replica 0's values."""
    from ..distributed.fleet.layers.mpu.mp_layers import (
        ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding,
    )
    from ..distributed.shards import (
        ShardedParameter, replica_of, sync_replicas,
    )

    linears = (Linear, ColumnParallelLinear, RowParallelLinear)
    gen = None
    for m in module.modules():
        if not isinstance(m, linears + (nn.Embedding,
                                        VocabParallelEmbedding)):
            continue
        w = m.weight
        if replica_of(w) is not None:
            continue
        placed = isinstance(w, ShardedParameter)
        shape = w.whole_shape if placed else w.shape
        if gen is None:
            gen = torch.Generator(
                device=w.parts[0].device if placed else w.device)
            gen.manual_seed(int(seed))
        if std is None and isinstance(m, linears):
            bound = math.sqrt(6.0 / sum(shape))
            t = (torch.rand(shape, generator=gen, device=gen.device) * 2.0
                 - 1.0) * bound
        else:
            t = (torch.randn(shape, generator=gen, device=gen.device)
                 * (1.0 if std is None else std))
        if placed:
            w.load_whole(t.to(w.whole_dtype))
        else:
            w.copy_(t)
        bias = getattr(m, "bias", None)
        if isinstance(bias, ShardedParameter):
            bias.load_whole(torch.zeros(bias.whole_shape,
                                        dtype=bias.whole_dtype))
        elif bias is not None:
            bias.zero_()
    sync_replicas(module)


@torch.no_grad()
def load_jax_state(module: nn.Module, state: Mapping[str, np.ndarray]):
    """Carry a JAX module's weights across: ``state`` maps every key of the
    JAX module's ``state_dict()`` to a numpy array (or anything
    ``np.asarray`` takes) of the port parameter's shape; the values are
    cast to the parameter's dtype.  ``Linear`` weights keep the JAX
    ``[in, out]`` layout, so nothing is transposed.  A ``ShardedParameter``
    (an mpu layer's weight) takes the whole tensor under its logical key
    and cuts it into its parts; replica copies (``shards.replicate``)
    take their sources' values.  Missing, unknown or mis-shaped keys
    raise."""
    from ..distributed.shards import (
        replica_of, shard_info, sharded_parameters, sync_replicas,
    )

    own = {n: p for n, p in module.named_parameters()
           if shard_info(p) is None and replica_of(p) is None}
    own.update(sharded_parameters(module))
    missing = sorted(set(own) - set(state))
    unknown = sorted(set(state) - set(own))
    if missing or unknown:
        raise KeyError(f"load_jax_state: missing {missing}, unknown "
                       f"{unknown}")
    arrays = {}
    for name, p in own.items():
        a = np.array(state[name], np.float32)
        shape = getattr(p, "whole_shape", None) or tuple(p.shape)
        if tuple(a.shape) != shape:
            raise ValueError(f"load_jax_state: {name} has shape {a.shape}, "
                             f"expected {shape}")
        arrays[name] = torch.from_numpy(a)
    # under ZeRO (distributed.sharding) the copies are whole while loading
    # and the slices take the values after
    plan = getattr(module, "_zero_plan", None)
    with plan.writing() if plan is not None else contextlib.nullcontext():
        for name, p in own.items():
            if hasattr(p, "whole_shape"):
                p.load_whole(arrays[name].to(p.whole_dtype))
            else:
                p.copy_(arrays[name].to(p.dtype))
        # replica copies (dp replicas, sp copies) take their sources'
        sync_replicas(module)
