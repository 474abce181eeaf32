"""Activations (port of the parts of
``paddle_tpu/nn/functional/activation.py`` the ported layers name)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["gelu", "relu"]


def gelu(x, approximate: bool = False):
    """GELU, exact (erf) by default, as ``jax.nn.gelu(approximate=False)``
    of the JAX ``gelu``; ``approximate=True`` the tanh form."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def relu(x):
    return torch.relu(x)
