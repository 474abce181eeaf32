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

from ...amp.auto_cast import maybe_cast

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
    layout), in the promoted dtype of the three (under ``auto_cast`` O1,
    all three in the amp dtype: a white-list op)."""
    x, weight, bias = promote(*maybe_cast("linear", x, weight, bias))
    return F.linear(x, weight.t(), bias)


def dropout(x, p: float = 0.5, axis=None, training: bool = True,
            mode: str = "upscale_in_train", name=None, *,
            generator: Optional[torch.Generator] = None):
    """Dropout in the reference's order (``paddle_tpu/nn/functional/
    common.py`` ``dropout``): each element kept with probability ``1 - p``,
    else 0, the keep mask drawn from ``generator`` (a ``torch.Generator``
    on x's device; ``None`` draws from PyTorch's default one).

    - ``axis`` (an int or a list of them): one mask over the named axes,
      broadcast over the others (``None``: a mask over every axis);
    - ``mode="upscale_in_train"``: the kept elements are scaled by
      ``1 / (1 - p)`` in training, and eval is the identity;
      ``"downscale_in_infer"``: the kept elements keep their value in
      training, and eval multiplies by ``1 - p``.

    The identity in training when ``p`` is 0.  The bits are PyTorch's,
    not the JAX package's threefry bits: the two agree in distribution
    only.  ``name`` is accepted, as the reference accepts it."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"dropout mode {mode!r}: expected "
                         "'upscale_in_train' or 'downscale_in_infer'")
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    if not 0.0 <= p < 1.0:
        raise ValueError(f"dropout p={p}: expected 0 <= p < 1")
    shape = x.shape
    if axis is not None:
        axes = axis if isinstance(axis, (list, tuple)) else [axis]
        axes = {a % x.dim() for a in axes}
        shape = [s if i in axes else 1 for i, s in enumerate(x.shape)]
    keep = keep_mask(shape, p, generator, x.device)
    kept = x / (1.0 - p) if mode == "upscale_in_train" else x
    return torch.where(keep, kept, torch.zeros_like(x))


def keep_mask(shape, p: float, generator: Optional[torch.Generator],
              device) -> torch.Tensor:
    """Dropout's boolean keep mask of ``shape`` on ``device``: each element
    True with probability ``1 - p``, drawn from ``generator``."""
    return torch.rand(shape, generator=generator, device=device) >= p
