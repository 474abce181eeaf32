"""Normalisation (port of ``paddle_tpu/nn/functional/norm.py``
``layer_norm``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import promote

__all__ = ["layer_norm"]


def layer_norm(x, normalized_shape, weight=None, bias=None,
               epsilon: float = 1e-5):
    """LayerNorm over the trailing ``normalized_shape`` axes, in the
    promoted dtype of x and the parameters.  ``F.layer_norm`` keeps the
    statistics in fp32 for a bf16 input and rounds the result once, where
    the JAX expression rounds each step in the input dtype: the two agree
    in fp32."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    x, weight, bias = promote(x, weight, bias)
    return F.layer_norm(x, tuple(normalized_shape), weight, bias, epsilon)
