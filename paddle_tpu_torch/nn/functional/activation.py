"""Activations (port of the parts of
``paddle_tpu/nn/functional/activation.py`` the ported layers name)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...amp.auto_cast import maybe_cast

__all__ = ["gelu", "relu", "softmax", "log_softmax"]


def gelu(x, approximate: bool = False):
    """GELU, exact (erf) by default, as ``jax.nn.gelu(approximate=False)``
    of the JAX ``gelu``; ``approximate=True`` the tanh form."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def relu(x):
    return torch.relu(x)


def softmax(x, axis: int = -1, dtype=None, name=None):
    """Softmax along ``axis`` (``dtype``: cast x first).  Under
    ``auto_cast`` O1 in fp32 (a black-list op)."""
    if dtype is not None:
        x = x.to(getattr(torch, dtype) if isinstance(dtype, str) else dtype)
    (x,) = maybe_cast("softmax", x)
    return torch.softmax(x, dim=axis)


def log_softmax(x, axis: int = -1, dtype=None, name=None):
    """Log-softmax along ``axis`` (``dtype``: cast x first).  Under
    ``auto_cast`` O1 in fp32 (a black-list op)."""
    if dtype is not None:
        x = x.to(getattr(torch, dtype) if isinstance(dtype, str) else dtype)
    (x,) = maybe_cast("log_softmax", x)
    return torch.log_softmax(x, dim=axis)
