"""Functions on tensors (port of ``paddle_tpu/nn/functional``, one module
per JAX file: ``loss``, ``attention``, ``norm``, ``activation``,
``common``), reduced to what the ported models call."""
from .activation import gelu, log_softmax, relu, softmax
from .attention import (
    flash_eligible, scaled_dot_product_attention, sdpa_reference,
)
from .common import dropout, linear, promote
from .loss import (
    cross_entropy, fused_linear_cross_entropy, sharded_softmax_losses,
    vocab_parallel_cross_entropy,
)
from .norm import layer_norm

__all__ = ["gelu", "relu", "softmax", "log_softmax", "scaled_dot_product_attention", "sdpa_reference",
           "flash_eligible", "dropout", "linear", "promote", "cross_entropy",
           "fused_linear_cross_entropy", "vocab_parallel_cross_entropy",
           "sharded_softmax_losses",
           "layer_norm"]
