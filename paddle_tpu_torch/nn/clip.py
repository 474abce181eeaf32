"""Gradient clipping (port of ``paddle_tpu/nn/clip.py``).

``ClipGradByValue``, ``ClipGradByNorm`` and ``ClipGradByGlobalNorm`` take
a list of ``(param, grad)`` pairs and return a new one, as an optimizer's
``grad_clip`` consumes them (``AdamW.step`` applies it before any
update); ``clip_grad_norm_`` scales the parameters' ``.grad`` in place.
Every norm and scale stays a tensor on the gradients' device: clipping
never waits for the card.  The arithmetic, dtypes included, is the
reference's.
"""
from __future__ import annotations

import torch

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "clip_grad_norm_"]


class ClipGradByValue:
    """Each gradient clamped to ``[min, max]`` (``min`` defaults to
    ``-max``), in its own dtype."""

    def __init__(self, max, min=None):  # noqa: A002
        self.max = max
        self.min = -max if min is None else min

    def __call__(self, params_grads):
        return [(p, g if g is None else torch.clamp(g, self.min, self.max))
                for p, g in params_grads]


class ClipGradByNorm:
    """Each gradient scaled to an L2 norm of at most ``clip_norm``, norm
    and scale in the gradient's own dtype."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            if g is not None:
                n = torch.sqrt(torch.sum(torch.square(g)))
                scale = torch.clamp(self.clip_norm / torch.clamp(n, min=1e-12),
                                    max=1.0)
                g = g * scale
            out.append((p, g))
        return out


class ClipGradByGlobalNorm:
    """Every gradient scaled by ``clip_norm / max(gn, clip_norm)``, where
    ``gn`` is the L2 norm of all of them together: the sum of squares of
    each gradient in fp32, summed over the gradients in order; each
    gradient is scaled in fp32 and rounded back to its own dtype.
    ``group_name`` is accepted as the reference accepts it (one card: one
    group)."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = clip_norm

    def _global_norm_sq(self, params_grads):
        """``gn ** 2`` as an fp32 0-d tensor on the gradients' device
        (None without gradients)."""
        sq = None
        for _, g in params_grads:
            if g is not None:
                v = torch.sum(torch.square(g.float()))
                sq = v if sq is None else sq + v
        return sq

    def __call__(self, params_grads):
        sq = self._global_norm_sq(params_grads)
        if sq is None:
            return params_grads
        gn = torch.sqrt(sq)
        scale = self.clip_norm / torch.clamp(gn, min=self.clip_norm)
        return [(p, g if g is None else (g.float() * scale).to(g.dtype))
                for p, g in params_grads]


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale every parameter's ``.grad`` in place so that their total
    ``norm_type`` norm is at most ``max_norm`` (in the gradients' dtype),
    and return that total norm, before scaling, as a tensor.
    ``error_if_nonfinite`` is accepted and ignored, as in the reference:
    checking it would wait for the card."""
    params = [p for p in parameters if p.grad is not None]
    if not params:
        return torch.zeros([], dtype=torch.float32)
    if norm_type == float("inf"):
        total = torch.max(torch.stack([torch.max(torch.abs(p.grad))
                                       for p in params]))
    else:
        total = torch.pow(
            sum(torch.sum(torch.pow(torch.abs(p.grad), norm_type))
                for p in params), 1.0 / norm_type)
    scale = torch.clamp(max_norm / torch.clamp(total, min=1e-6), max=1.0)
    for p in params:
        p.grad.mul_(scale)
    return total
