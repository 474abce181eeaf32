"""One training step as one call (port of ``FusedTrainStep`` of
``paddle_tpu/optimizer/fused_step.py``).

The reference traces forward, backward and the optimizer update into one
donated XLA program.  PyTorch runs eagerly, so here the step is the same
sequence, issued call after call on the card's stream: the forward, one
``backward()``, ``optimizer.step()`` (which updates parameters and
moments in place) and zeroing the gradients.  Nothing waits for the card:
the loss comes back as a device tensor.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

__all__ = ["FusedTrainStep"]


class FusedTrainStep:
    """``FusedTrainStep(loss_fn, optimizer, amp_level=None)``; calling it
    with a batch runs ``loss_fn(*batch)``, its backward, the optimizer
    step and ``zero_grad``, and returns the loss (detached, not synced).

    ``amp_level="O1"`` is accepted for a model whose floating-point
    parameters are already low precision (the bench regime: ``amp.decorate``
    O2 weights plus an O1 step), where O1 changes no dtype.  O1 over fp32
    parameters is not ported yet and raises."""

    def __init__(self, loss_fn: Callable, optimizer, *,
                 amp_level: Optional[str] = None):
        if amp_level not in (None, "O1"):
            raise ValueError(f"amp_level must be None or 'O1', got "
                             f"{amp_level!r}")
        if amp_level == "O1" and any(
                p.dtype == torch.float32
                for g in optimizer.param_groups for p in g["params"]):
            raise NotImplementedError(
                "FusedTrainStep: amp_level='O1' over fp32 parameters is not "
                "ported yet (ROADMAP.md queue 1, item 2, training); "
                "cast the model to bfloat16 first")
        self._loss_fn = loss_fn
        self._optimizer = optimizer

    def __call__(self, *batch) -> torch.Tensor:
        loss = self._loss_fn(*batch)
        loss.backward()
        self._optimizer.step()
        self._optimizer.zero_grad(set_to_none=True)
        return loss.detach()
