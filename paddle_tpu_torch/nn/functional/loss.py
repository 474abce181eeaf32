"""Losses (port of ``paddle_tpu/nn/functional/loss.py``): ``cross_entropy``
and the training loss head, ``fused_linear_cross_entropy`` with
``_lm_head_dot``.

The LM head of a 50k-word vocabulary makes logits too large to keep for
the backward ([8192, 50304] fp32 is 1.6 GB).  As in the reference, tokens
are taken in chunks, and each chunk's loss runs under activation
checkpointing, so at most one chunk's logits are live: the backward
recomputes them and forms softmax-minus-one-hot locally.

Logits are summed in fp32 out of operands in their storage dtype, as
``_lm_head_dot`` does.  On the card a bf16 product with an fp32 result is
one cuBLAS call (``torch.mm(..., out_dtype=torch.float32)``); the CPU has
no such kernel, so there the operands are widened to fp32 first, which
gives the same numbers (a product of two bf16 values is exact in fp32).
The backward casts the fp32 cotangent down to the operand dtype before
the dW/dh products, as the reference's custom VJP does.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

__all__ = ["cross_entropy", "fused_linear_cross_entropy"]


def cross_entropy(input, label, ignore_index: int = -100,  # noqa: A002
                  reduction: str = "mean", axis: int = -1) -> torch.Tensor:
    """Softmax cross entropy against integer labels (the reference's hard
    label path): ``-log_softmax(input)[label]`` along ``axis``, 0 where the
    label is ``ignore_index``; ``reduction`` "mean" divides the sum by the
    number of labels that are not ignored (at least 1), "sum" sums, "none"
    keeps each row's loss.  ``label`` may carry a trailing unit axis."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction {reduction!r}: expected 'mean', 'sum' "
                         "or 'none'")
    lp = torch.log_softmax(input, dim=axis)
    lab = label.long()
    if lab.dim() == lp.dim():
        lab = lab.squeeze(axis)
    valid = lab != ignore_index
    safe = torch.where(valid, lab, 0)
    picked = lp.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
    loss = torch.where(valid, -picked, torch.zeros_like(picked))
    if reduction == "mean":
        return loss.sum() / valid.sum().clamp_min(1).to(loss.dtype)
    return loss.sum() if reduction == "sum" else loss


def _dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` summed and returned in fp32, operands as stored."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _LMHeadDot(torch.autograd.Function):
    """Chunk logits ``h [c, H] x w [V, H] -> fp32 [c, V]``."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        return _dot_f32(h, w.t())

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        # dh [c, H] = g [c, V] . w [V, H];  dw [V, H] = g^T [V, c] . h [c, H]
        dh = _dot_f32(g.to(h.dtype), w).to(h.dtype)
        dw = _dot_f32(g.to(w.dtype).t(), h).to(w.dtype)
        return dh, dw


def _chunk_loss(h, w, labels):
    logits = _LMHeadDot.apply(h, w)
    picked = logits.gather(-1, labels[:, None])[:, 0]
    return torch.logsumexp(logits, dim=-1) - picked


def fused_linear_cross_entropy(hidden: torch.Tensor, weight: torch.Tensor,
                               labels: torch.Tensor, *,
                               chunk_tokens: int = 2048) -> torch.Tensor:
    """Mean over tokens of ``logsumexp(h w^T) - (h w^T)[label]``.

    hidden: ``[..., H]``; weight: ``[V, H]`` (the tied LM head); labels:
    integer ``[...]``, used as given (no shift).  Tokens are taken
    ``chunk_tokens`` at a time, each chunk under
    ``torch.utils.checkpoint``; the last chunk may be shorter."""
    hs = hidden.shape[-1]
    h2 = hidden.reshape(-1, hs)
    lab = labels.reshape(-1).to(device=hidden.device, dtype=torch.long)
    losses = [checkpoint(_chunk_loss, h2[i:i + chunk_tokens], weight,
                         lab[i:i + chunk_tokens], use_reentrant=False)
              for i in range(0, h2.shape[0], chunk_tokens)]
    return torch.cat(losses).mean()
