"""Functions on tensors (port of ``paddle_tpu/nn/functional``, one module
per JAX file: ``loss``, ``attention``, ``norm``, ``activation``,
``common``), reduced to what the ported models call."""
from .activation import gelu, relu
from .attention import (
    flash_eligible, scaled_dot_product_attention, sdpa_reference,
)
from .common import dropout, linear, promote
from .loss import cross_entropy, fused_linear_cross_entropy
from .norm import layer_norm

__all__ = ["gelu", "relu", "scaled_dot_product_attention", "sdpa_reference",
           "flash_eligible", "dropout", "linear", "promote", "cross_entropy",
           "fused_linear_cross_entropy", "layer_norm"]
