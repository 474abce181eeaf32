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
    """Inverted dropout with probability ``p`` in training mode, drawn from
    ``generator`` (``None``: PyTorch's default generator); the identity in
    eval mode."""

    def __init__(self, p: float = 0.5,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.p = float(p)
        self.generator = generator

    def forward(self, x):
        return F.dropout(x, self.p, self.training, self.generator)


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
    ``module``, drawn in module order from ``torch.Generator(seed)`` on
    the parameters' device: N(0, ``std``), or with ``std`` None
    Xavier-uniform over a Linear's ``[in, out]``.  Biases 0; LayerNorms
    keep gain 1, shift 0."""
    gen = None
    for m in module.modules():
        if isinstance(m, (Linear, nn.Embedding)):
            w = m.weight
            if gen is None:
                gen = torch.Generator(device=w.device)
                gen.manual_seed(int(seed))
            if std is None and isinstance(m, Linear):
                bound = math.sqrt(6.0 / sum(w.shape))
                w.copy_((torch.rand(w.shape, generator=gen, device=w.device)
                         * 2.0 - 1.0) * bound)
            else:
                w.copy_(torch.randn(w.shape, generator=gen, device=w.device)
                        * (1.0 if std is None else std))
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()


@torch.no_grad()
def load_jax_state(module: nn.Module, state: Mapping[str, np.ndarray]):
    """Carry a JAX module's weights across: ``state`` maps every key of the
    JAX module's ``state_dict()`` to a numpy array (or anything
    ``np.asarray`` takes) of the port parameter's shape; the values are
    cast to the parameter's dtype.  ``Linear`` weights keep the JAX
    ``[in, out]`` layout, so nothing is transposed.  Missing, unknown or
    mis-shaped keys raise."""
    own = dict(module.named_parameters())
    missing = sorted(set(own) - set(state))
    unknown = sorted(set(state) - set(own))
    if missing or unknown:
        raise KeyError(f"load_jax_state: missing {missing}, unknown "
                       f"{unknown}")
    arrays = {}
    for name, p in own.items():
        a = np.array(state[name], np.float32)
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"load_jax_state: {name} has shape {a.shape}, "
                             f"expected {tuple(p.shape)}")
        arrays[name] = a
    for name, p in own.items():
        p.copy_(torch.from_numpy(arrays[name]).to(p.dtype))
