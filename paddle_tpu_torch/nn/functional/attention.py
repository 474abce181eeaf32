"""Attention (port of ``paddle_tpu/nn/functional/attention.py``
``scaled_dot_product_attention``), over ``[batch, seq, heads, head_dim]``
operands.

The routing is the JAX package's: without a mask and without active
dropout, and where its flash gate (``_flash_eligible``, copied here as
:func:`flash_eligible`) takes the shape, the call runs the flash forward
of ``ops/kernels/flash_attention.py`` -- the kernel on the card, its plain
version on the CPU, and under autograd the flash backward kernels --
on ``[B, N, S, D]`` views of the operands.  Every other call (a mask,
dropout, a sequence that is not a 128-multiple) runs
:func:`sdpa_reference`, the plain expression of the JAX
``_sdpa_reference``, on any device: the reference's own route, not a
fallback.  Where the gate takes a shape that the card's kernels refuse
(head_dim other than 64 or 128), the call raises ``ValueError`` on the
card."""
from __future__ import annotations

import math
from typing import Optional

import torch

from ...amp.auto_cast import maybe_cast
from ...ops.kernels.flash_attention import (
    flash_attention_bnsd, shape_unsupported_reason,
)
from .common import dropout, promote

__all__ = ["scaled_dot_product_attention", "sdpa_reference",
           "flash_eligible"]


def flash_eligible(q_shape, dropout_p: float, mask) -> bool:
    """The JAX ``_flash_eligible``: no mask, no dropout, and a shape the
    flash rule takes (seq a 128-multiple, head_dim a 64-multiple)."""
    if mask is not None or dropout_p > 0.0:
        return False
    _, s, _, d = q_shape
    return shape_unsupported_reason(s, d) is None


def sdpa_reference(q, k, v, mask=None, dropout_p: float = 0.0,
                   is_causal: bool = False,
                   generator: Optional[torch.Generator] = None):
    """The JAX ``_sdpa_reference`` in its dtypes: scores ``q k^T * scale``
    in the operands' dtype; a causal or boolean mask sets the dtype's
    lowest value, an additive mask is added (a bf16 score plus an fp32
    mask promotes to fp32); softmax in the scores' dtype; dropout on the
    probabilities; the PV product in the promoted dtype of the
    probabilities and v."""
    q, k, v = promote(q, k, v)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * scale
    lowest = torch.finfo(scores.dtype).min
    if is_causal:
        s_q, s_k = scores.shape[-2], scores.shape[-1]
        causal = torch.ones((s_q, s_k), dtype=torch.bool,
                            device=q.device).tril(s_k - s_q)
        scores = scores.masked_fill(~causal, lowest)
    if mask is not None:
        if mask.dtype == torch.bool:
            scores = scores.masked_fill(~mask, lowest)
        else:
            scores = scores + mask
    probs = dropout(torch.softmax(scores, dim=-1), dropout_p,
                    generator=generator)
    probs, vh = promote(probs, vh)
    return torch.einsum("bhqk,bhkd->bhqd", probs, vh).transpose(1, 2)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True, name=None,
                                 use_flash: Optional[bool] = None, *,
                                 generator: Optional[torch.Generator] = None):
    """Attention of ``[B, S, H, D]`` query, key and value with the softmax
    scale ``1 / sqrt(D)``, returning ``[B, S, H, D]``.  ``dropout_p``
    applies only when ``training``, drawn from ``generator``.  Routed as
    the module docstring says; ``use_flash=False`` takes the plain
    expression whatever the shape (``None``, the JAX package's default
    flag, and ``True`` leave it to the gate).  ``name`` is accepted, as
    the reference accepts it.  Under ``auto_cast`` O1 the operands (and a
    float mask) are cast to the amp dtype, on either route (``sdpa`` and
    ``flash_attention`` are white-list ops)."""
    query, key, value, attn_mask = maybe_cast("sdpa", query, key, value,
                                              attn_mask)
    if not training:
        dropout_p = 0.0
    if use_flash is not False and flash_eligible(tuple(query.shape),
                                                 dropout_p, attn_mask):
        out = flash_attention_bnsd(query.transpose(1, 2),
                                   key.transpose(1, 2),
                                   value.transpose(1, 2), causal=is_causal)
        return out.transpose(1, 2)
    return sdpa_reference(query, key, value, attn_mask, dropout_p, is_causal,
                          generator)
