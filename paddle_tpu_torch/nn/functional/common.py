"""Linear and dropout (port of the parts of
``paddle_tpu/nn/functional/common.py`` that the ported models call).

The JAX package lets operands of two float dtypes meet and promotes them
(a bf16 activation against fp32 weights computes in fp32); PyTorch's
products refuse mixed operands, so these functions promote explicitly,
with :func:`promote`, and give the JAX package's result dtype."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["promote", "linear", "dropout", "keep_mask"]


def promote(*tensors):
    """The tensors cast to their common promoted dtype (``None`` kept)."""
    dt = None
    for t in tensors:
        if t is not None:
            dt = t.dtype if dt is None else torch.promote_types(dt, t.dtype)
    return [None if t is None else t.to(dt) for t in tensors]


def linear(x, weight, bias=None):
    """``x @ weight + bias`` with ``weight`` as ``[in, out]`` (the JAX
    layout), in the promoted dtype of the three."""
    x, weight, bias = promote(x, weight, bias)
    return F.linear(x, weight.t(), bias)


def dropout(x, p: float = 0.5, training: bool = True,
            generator: Optional[torch.Generator] = None):
    """Inverted dropout: each element kept with probability ``1 - p`` and
    scaled by ``1 / (1 - p)``, else 0, the keep mask drawn from
    ``generator`` (a ``torch.Generator`` on x's device; ``None`` draws from
    PyTorch's default one).  The identity when not ``training`` or when
    ``p`` is 0.  The bits are PyTorch's, not the JAX package's threefry
    bits: the two agree in distribution only."""
    if not training or p == 0.0:
        return x
    if not 0.0 <= p < 1.0:
        raise ValueError(f"dropout p={p}: expected 0 <= p < 1")
    keep = keep_mask(x.shape, p, generator, x.device)
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def keep_mask(shape, p: float, generator: Optional[torch.Generator],
              device) -> torch.Tensor:
    """Dropout's boolean keep mask of ``shape`` on ``device``: each element
    True with probability ``1 - p``, drawn from ``generator``."""
    return torch.rand(shape, generator=generator, device=device) >= p
