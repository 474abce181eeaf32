"""Counterpart of ``paddle_tpu/incubate``: the fused transformer layers
(``incubate.nn``)."""
from . import nn
from .nn import (
    FusedFeedForward, FusedLinear, FusedMultiHeadAttention,
    FusedMultiTransformer,
)

__all__ = ["nn", "FusedMultiHeadAttention", "FusedFeedForward",
           "FusedLinear", "FusedMultiTransformer"]
