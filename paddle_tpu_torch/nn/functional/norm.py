"""Normalisation (port of ``paddle_tpu/nn/functional/norm.py``
``layer_norm``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...amp.auto_cast import maybe_cast
from .common import promote

__all__ = ["layer_norm"]


def layer_norm(x, normalized_shape, weight=None, bias=None,
               epsilon: float = 1e-5):
    """LayerNorm over the trailing ``normalized_shape`` axes, in the
    promoted dtype of x and the parameters.  ``F.layer_norm`` keeps the
    statistics in fp32 for a bf16 input and rounds the result once, where
    the JAX expression rounds each step in the input dtype: the two agree
    in fp32.  Under ``auto_cast`` O1 all three are cast to fp32 (a
    black-list op)."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    x, weight, bias = promote(*maybe_cast("layer_norm", x, weight, bias))
    return F.layer_norm(x, tuple(normalized_shape), weight, bias, epsilon)
