"""One training step as one call (port of ``FusedTrainStep`` of
``paddle_tpu/optimizer/fused_step.py``).

The reference traces forward, backward, the scaler's unscale and check,
and the optimizer update into one donated XLA program.  PyTorch runs
eagerly, so here the step is the same sequence, issued call after call on
the card's stream: the forward (under ``amp.auto_cast`` at O1 when asked),
one ``backward()``, the optimizer step and zeroing the gradients.
Nothing waits for the card: the loss comes back as a device tensor.

With an enabled ``GradScaler`` the reference's skip-on-overflow protocol
runs without a host sync, as it does inside its one program: the
gradients are unscaled in place and their finiteness reduced into one
device flag (``checkpoint.sentry.unscale_and_check_``); ``AdamW.step``
takes the flag (and copies it to each device that holds parameters: a
model placed on a mesh), and its kernels write nothing when it is false,
so a non-finite step leaves parameters, moments, fp32 masters and the beta
powers (then a device pair) bitwise unchanged; the scale and the
good/bad counters update as device tensors by ``_traced_scaler_update``'s
rules.  As in the reference, the scaler's host counters stay untouched
and :attr:`last_step_applied` reads the flag (one sync).

The reference's ``program_count``, ``lint_reports`` and ``cost_reports``
count compiled XLA programs, which an eager step does not have; they are
absent (ROADMAP.md queue 1, item 10).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..amp.auto_cast import auto_cast
from ..checkpoint.sentry import grads_of, unscale_and_check_

__all__ = ["FusedTrainStep"]


class FusedTrainStep:
    """``FusedTrainStep(loss_fn, optimizer, *, scaler=None,
    amp_level=None, amp_dtype="bfloat16")``; calling it with a batch runs
    ``loss_fn(*batch)``, its backward, the optimizer step and
    ``zero_grad``, and returns the loss (detached, not synced; unscaled).

    - ``scaler``: a ``GradScaler``; a disabled one passes through, an
      enabled one runs the protocol of the module docstring (the
      optimizer must be the port's ``AdamW``, whose ``step`` takes the
      device flag);
    - ``amp_level="O1"`` wraps the forward in ``amp.auto_cast(level="O1",
      dtype=amp_dtype)``, over fp32 or low-precision parameters alike;
      ``None`` leaves dtypes to the caller.  ``"O2"`` raises: O2 is a
      model decoration (``amp.decorate``), not a per-step cast."""

    def __init__(self, loss_fn: Callable, optimizer, *, scaler=None,
                 amp_level: Optional[str] = None,
                 amp_dtype: str = "bfloat16"):
        if amp_level not in (None, "O1"):
            raise ValueError(
                f"amp_level must be None or 'O1', got {amp_level!r} (O2 is "
                "a model decoration -- amp.decorate -- not a per-step cast)")
        self._loss_fn = loss_fn
        self._optimizer = optimizer
        self._scaler = scaler
        self._amp_level = amp_level
        self._amp_dtype = amp_dtype
        self._finite_t = None
        self.dispatch_count = 0
        if self._scaling():
            dev = scaler._scale.device
            self._good_t = torch.zeros((), dtype=torch.int32, device=dev)
            self._bad_t = torch.zeros((), dtype=torch.int32, device=dev)

    def _scaling(self) -> bool:
        s = self._scaler
        return s is not None and s.is_enable()

    def _forward(self, *batch):
        if self._amp_level == "O1":
            with auto_cast(enable=True, level="O1", dtype=self._amp_dtype):
                return self._loss_fn(*batch)
        return self._loss_fn(*batch)

    def _backward_and_update(self, loss):
        opt = self._optimizer
        if not self._scaling():
            loss.backward()
            opt.step()
            return
        scaler = self._scaler
        scaler.scale(loss).backward()
        finite = unscale_and_check_(grads_of(opt), scaler._scale)
        opt.step(finite=finite)
        self._traced_scaler_update(finite)
        self._finite_t = finite

    def _traced_scaler_update(self, finite):
        """``GradScaler.update()``'s rule with the counters as device
        tensors: finite -> good + 1 (scale times ``incr_ratio`` every
        ``incr_every``), non-finite -> bad + 1 (scale = max(scale *
        ``decr_ratio``, 1) every ``decr_every``)."""
        s = self._scaler
        if not s.is_use_dynamic_loss_scaling():
            return
        good2 = torch.where(finite, self._good_t + 1, 0)
        bad2 = torch.where(finite, 0, self._bad_t + 1)
        incr = finite & (good2 >= s._incr_every)
        decr = ~finite & (bad2 >= s._decr_every)
        scale = s._scale
        scale = torch.where(incr, scale * s._incr_ratio, scale)
        scale = torch.where(decr, torch.clamp(scale * s._decr_ratio, min=1.0),
                            scale)
        self._good_t.copy_(torch.where(incr, 0, good2))
        self._bad_t.copy_(torch.where(decr, 0, bad2))
        s._set_scale(scale)

    def __call__(self, *batch) -> torch.Tensor:
        loss = self._forward(*batch)
        self._backward_and_update(loss)
        self._optimizer.zero_grad(set_to_none=True)
        self.dispatch_count += 1
        return loss.detach()

    @property
    def last_step_applied(self) -> bool:
        """Whether the most recent step's gradients were all finite
        (always True without an enabled scaler).  Reading syncs."""
        return True if self._finite_t is None else bool(self._finite_t)
