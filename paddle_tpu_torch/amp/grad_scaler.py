"""GradScaler (port of ``paddle_tpu/amp/grad_scaler.py``): dynamic loss
scaling with the reference's protocol and state.

The scale is an fp32 tensor on the device (``device=None``: the card).
``unscale_`` is the reference's one unscale-and-check over every gradient
(``checkpoint.sentry.unscale_and_check_``: each gradient times ``1 /
scale`` in fp32, cast back to its dtype, finiteness of the fp32 values)
followed by one host read of the flag.  ``FusedTrainStep(scaler=)`` runs
the same check without that read, keeping the flag and the counters on
the device (``optimizer/fused_step.py``).

The scale is one master tensor, which the checks read.  A loss that lies
on another device (a pipeline whose data replicas end on different
cards) is scaled by a copy of the master made there on its first use,
as ``AdamW`` keeps its beta powers per device; every change of the
master is copied to each copy, so they are equal bit for bit.
"""
from __future__ import annotations

import torch

from ..core import resolve_device

__all__ = ["AmpScaler", "GradScaler"]


class AmpScaler:
    """``AmpScaler(enable=True, init_loss_scaling=2**15, incr_ratio=2.0,
    decr_ratio=0.5, incr_every_n_steps=1000, decr_every_n_nan_or_inf=1,
    use_dynamic_loss_scaling=True, *, device=None)``: the reference's
    options and defaults.  A disabled scaler passes losses and steps
    through."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True,
                 *, device=None):
        self._enable = bool(enable)
        self._scale = torch.tensor(
            float(init_loss_scaling) if enable else 1.0,
            dtype=torch.float32, device=resolve_device(device))
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        # device -> the master scale's copy there (``scale`` of a loss on
        # another device)
        self._copies = {}

    def is_enable(self) -> bool:
        return self._enable

    def is_use_dynamic_loss_scaling(self) -> bool:
        return self._dynamic

    def get_loss_scaling(self) -> float:
        """The scale as a Python float (one host read)."""
        return float(self._scale)

    def scale(self, var):
        """``var * scale`` (``var`` unchanged when disabled)."""
        if not self._enable:
            return var
        return var * self._scale_on(var.device)

    def _scale_on(self, device):
        """The master scale, or its copy on ``device``: made from the
        master on first use (to the host that copy waits for the card
        once), then kept equal to it by :meth:`_set_scale`."""
        if device == self._scale.device:
            return self._scale
        copy = self._copies.get(device)
        if copy is None:
            copy = self._copies[device] = self._scale.to(device)
        return copy

    def _set_scale(self, value):
        """Write ``value`` into the master scale and each of its copies."""
        self._scale.copy_(value)
        for copy in self._copies.values():
            copy.copy_(self._scale, non_blocking=copy.is_cuda)

    def unscale_(self, optimizer):
        """Unscale every gradient of ``optimizer`` in place and set
        ``_found_inf``: one fused check, one host read."""
        if not self._enable:
            return
        from ..checkpoint.sentry import grads_of, unscale_and_check_

        grads = grads_of(optimizer)
        if not grads:
            self._found_inf = False
            return
        self._found_inf = not bool(unscale_and_check_(grads, self._scale))

    def step(self, optimizer):
        """Unscale, step the optimizer unless a gradient is not finite,
        and update the scale."""
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self.update()

    def update(self):
        """The dynamic-scaling rule on the host counters: a non-finite
        step counts bad (the scale times ``decr_ratio``, at least 1, every
        ``decr_every_n_nan_or_inf`` of them in a row), a finite one good
        (times ``incr_ratio`` every ``incr_every_n_steps``)."""
        if not (self._enable and self._dynamic):
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._set_scale(torch.clamp(self._scale * self._decr_ratio,
                                            min=1.0))
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._set_scale(self._scale * self._incr_ratio)
                self._good_steps = 0
        self._found_inf = False

    def minimize(self, optimizer, scaled_loss):
        """``scaled_loss.backward()``, :meth:`step`, then clear the
        gradients."""
        scaled_loss.backward()
        self.step(optimizer)
        optimizer.zero_grad(set_to_none=True)

    def state_dict(self) -> dict:
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def load_state_dict(self, state):
        """Take :meth:`state_dict`'s scale (a tensor, an array or a
        number) into this scaler's device tensor, and its counters."""
        self._set_scale(torch.as_tensor(state["scale"], dtype=torch.float32))
        self._good_steps = int(state.get("good_steps", 0))
        self._bad_steps = int(state.get("bad_steps", 0))


GradScaler = AmpScaler
