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

from ...amp.auto_cast import maybe_cast
from ...core.recompute import checkpoint
from ...distributed.serving_mesh import broadcast, reduce_max, reduce_sum

__all__ = ["cross_entropy", "fused_linear_cross_entropy",
           "vocab_parallel_cross_entropy", "sharded_softmax_losses"]


def _reduce(loss, reduction: str):
    if reduction == "mean":
        return loss.mean()
    return loss.sum() if reduction == "sum" else loss


def cross_entropy(input, label, weight=None,  # noqa: A002
                  ignore_index: int = -100, reduction: str = "mean",
                  soft_label: bool = False,
                  axis: int = -1, use_softmax: bool = True,
                  label_smoothing: float = 0.0, name=None) -> torch.Tensor:
    """Softmax cross entropy in the reference's order and arithmetic
    (``paddle_tpu/nn/functional/loss.py`` ``cross_entropy``):

    - ``use_softmax``: ``log_softmax(input)`` along ``axis``; False takes
      ``input`` as probabilities, ``log(max(input, 1e-30))``;
    - hard labels (integers; a trailing unit axis is allowed): the loss
      ``-lp[label]``, with ``label_smoothing`` ``(1 - e) (-lp[label]) + e
      mean(-lp)``, 0 where the label is ``ignore_index``; ``weight`` (one
      per class) multiplies each row's loss by its class's weight, and
      "mean" is then ``sum(loss) / max(sum(weights of the kept rows),
      1e-12)``; without ``weight`` "mean" divides by the number of kept
      labels (at least 1);
    - ``soft_label``: ``label`` holds a distribution over classes (smoothed
      by ``label_smoothing`` toward uniform), the loss ``-sum(label *
      lp)``; ``weight`` and ``ignore_index`` play no part, as in the
      reference;
    - ``reduction`` "mean", "sum" or "none" (each row's loss).

    Under ``amp.auto_cast`` O1 the operands are cast to fp32 (a black-list
    op)."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction {reduction!r}: expected 'mean', 'sum' "
                         "or 'none'")
    input, weight = maybe_cast("cross_entropy", input, weight)  # noqa: A001
    if use_softmax:
        lp = torch.log_softmax(input, dim=axis)
    else:
        lp = torch.log(torch.clamp(input, min=1e-30))
    if soft_label:
        tgt = label.to(lp.dtype)
        if label_smoothing > 0:
            tgt = (tgt * (1 - label_smoothing)
                   + label_smoothing / lp.shape[axis])
        return _reduce(-(tgt * lp).sum(axis), reduction)
    lab = label.long()
    if lab.dim() == lp.dim():
        lab = lab.squeeze(axis)
    valid = lab != ignore_index
    safe = torch.where(valid, lab, 0)
    picked = lp.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
    loss = -picked
    if label_smoothing > 0:
        loss = ((1 - label_smoothing) * loss
                + label_smoothing * -lp.mean(axis))
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if weight is not None:
        wv = torch.where(valid, weight[safe], torch.zeros_like(loss))
        loss = loss * wv
        if reduction == "mean":
            return loss.sum() / torch.clamp(wv.sum(), min=1e-12)
    if reduction == "mean":
        return loss.sum() / valid.sum().clamp_min(1).to(loss.dtype)
    return _reduce(loss, reduction)


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
                               chunk_tokens: int = 2048,
                               compute_dtype=None,
                               reduction: str = "mean") -> torch.Tensor:
    """Each token's ``logsumexp(h w^T) - (h w^T)[label]``, reduced by
    ``reduction``: "mean" over tokens, "sum", or "none" (the per-token
    losses, flat ``[N]``), the reference's three cases.

    hidden: ``[..., H]``; weight: ``[V, H]`` (the tied LM head); labels:
    integer ``[...]``, used as given (no shift).  ``compute_dtype``: the
    dtype both operands are cast to before the product (the reference's
    ``compute_dtype``, which the stacked GPT passes under ``auto_cast``);
    ``None`` keeps hidden's dtype for both.  The logits are summed in
    fp32 either way.  Tokens are taken ``chunk_tokens`` at a time, each
    chunk under the port's checkpoint (``core.recompute``); the last
    chunk may be shorter."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction {reduction!r}: expected 'mean', 'sum' "
                         "or 'none'")
    hs = hidden.shape[-1]
    cdt = hidden.dtype if compute_dtype is None else compute_dtype
    h2 = hidden.reshape(-1, hs).to(cdt)
    w = weight.to(cdt)
    lab = labels.reshape(-1).to(device=hidden.device, dtype=torch.long)
    losses = [checkpoint(_chunk_loss, h2[i:i + chunk_tokens], w,
                         lab[i:i + chunk_tokens])
              for i in range(0, h2.shape[0], chunk_tokens)]
    return _reduce(torch.cat(losses), reduction)


def sharded_softmax_losses(zs, labels, devices, root) -> torch.Tensor:
    """Each row's softmax cross entropy ``logsumexp(z) - z[label]`` over
    logits cut by class: ``zs[i]`` [N, V_i] fp32, shard ``i``'s classes
    (in shard order) on ``devices[i]``; ``labels`` [N].  The global row
    max and sum of exponentials, summed on ``root`` in shard order, and
    the label's logit from the shard that holds it.  [N] fp32 on
    ``root``."""
    labs = broadcast(labels, devices)
    # the max only steadies the exponentials: it takes no gradient
    m = reduce_max([z.detach().amax(-1) for z in zs], (root,))[root]
    ms = broadcast(m, devices)
    se = reduce_sum([torch.exp(z - ms[d][:, None]).sum(-1)
                     for d, z in zip(devices, zs)], (root,))[root]
    picked, off = [], 0
    for d, z in zip(devices, zs):
        loc = labs[d] - off
        ok = (loc >= 0) & (loc < z.shape[-1])
        v = z.gather(-1, torch.where(ok, loc, 0)[:, None])[:, 0]
        picked.append(torch.where(ok, v, 0.0))
        off += z.shape[-1]
    return torch.log(se) + m - reduce_sum(picked, (root,))[root]


def _vocab_parallel_chunk(h, labels, devices, *ws):
    """One token chunk's losses over vocabulary shards ``ws`` (shard
    ``i`` on ``devices[i]``, rows in shard order): each shard's fp32
    logits, then :func:`sharded_softmax_losses` on h's device."""
    hs = broadcast(h, devices)
    zs = [_LMHeadDot.apply(hs[d], w) for d, w in zip(devices, ws)]
    return sharded_softmax_losses(zs, labels, devices, h.device)


def vocab_parallel_cross_entropy(hidden: torch.Tensor, weights, labels, *,
                                 devices, chunk_tokens: int = 2048,
                                 compute_dtype=None) -> torch.Tensor:
    """:func:`fused_linear_cross_entropy` over a head cut by vocabulary
    rows: ``weights[i]`` is rows ``[o_i, o_i + V_i)`` of the ``[V, H]``
    table on ``devices[i]`` (the reference's ``ParallelCrossEntropy``
    over ``VocabParallelEmbedding``'s shards).  The same token chunks,
    each under the port's checkpoint; the mean on ``hidden``'s
    device."""
    hs = hidden.shape[-1]
    cdt = hidden.dtype if compute_dtype is None else compute_dtype
    h2 = hidden.reshape(-1, hs).to(cdt)
    ws = [w.to(cdt) for w in weights]
    lab = labels.reshape(-1).to(device=hidden.device, dtype=torch.long)
    devices = tuple(devices)
    losses = [checkpoint(_vocab_parallel_chunk, h2[i:i + chunk_tokens],
                         lab[i:i + chunk_tokens], devices, *ws)
              for i in range(0, h2.shape[0], chunk_tokens)]
    return torch.cat(losses).mean()
