"""Bad-step sentry: one finiteness reduction over all gradients (port of
``paddle_tpu/checkpoint/sentry.py``).

The flag of every check here is a 0-d bool tensor on the gradients'
device, reduced over all of them before anything is read back, so a
caller pays one host read per check, not one per gradient (``all_finite``
and ``BadStepSentry.guard_step`` read it; ``FusedTrainStep`` keeps it on
the device).  ``BadStepSentry`` skips non-finite steps and, after a run
of them, rolls the training state back to the last valid checkpoint.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional

import numpy as np
import torch

__all__ = ["all_finite", "tree_all_finite", "unscale_and_check",
           "unscale_and_check_", "grads_of", "BadStepSentry"]


def grads_of(optimizer):
    """Every gradient of ``optimizer``'s parameters, group after group
    (parameters without one are skipped); under ZeRO the slices', given
    them first (``distributed.sharding``)."""
    from ..distributed.shards import _optimizer_chain

    zero = getattr(_optimizer_chain(optimizer)[-1], "_zero", None)
    if zero is not None:
        zero.prepare_grads()
    return [p.grad for g in optimizer.param_groups for p in g["params"]
            if p.grad is not None]


def _leaves(obj) -> List[Any]:
    if isinstance(obj, dict):
        return [x for v in obj.values() for x in _leaves(v)]
    if isinstance(obj, (list, tuple)):
        return [x for v in obj for x in _leaves(v)]
    return [obj]


def tree_all_finite(leaves) -> torch.Tensor:
    """Whether every floating-point tensor of ``leaves`` (a tensor or a
    nested list/tuple/dict of them, on one device) is finite, as a 0-d
    bool tensor on their device; integer and bool leaves are finite by
    construction and skipped."""
    flags = [torch.isfinite(t).all() for t in _leaves(leaves)
             if isinstance(t, torch.Tensor) and t.is_floating_point()]
    if not flags:
        return torch.ones((), dtype=torch.bool)
    return torch.stack(flags).all()


def all_finite(values) -> bool:
    """Host-side: True iff every float leaf of ``values`` (tensors, numpy
    arrays, nested containers) is finite.  One read back per device the
    tensors live on."""
    leaves = _leaves(values)
    for a in leaves:
        if isinstance(a, np.ndarray) and np.issubdtype(a.dtype, np.inexact) \
                and not np.isfinite(a).all():
            return False
    by_device = {}
    for t in leaves:
        if isinstance(t, torch.Tensor) and t.is_floating_point():
            by_device.setdefault(t.device, []).append(t)
    return all(bool(tree_all_finite(ts)) for ts in by_device.values())


def unscale_and_check(grads, scale):
    """``GradScaler.unscale_``'s body as a function: every gradient times
    ``1 / scale`` in fp32, cast back to its dtype, and the finiteness of
    the fp32 values reduced into one flag.  Returns ``(new_grads,
    finite)``, ``finite`` a 0-d bool tensor on the scale's device."""
    new = [g.clone() for g in grads]
    return new, unscale_and_check_(new, scale)


def unscale_and_check_(grads, scale) -> torch.Tensor:
    """:func:`unscale_and_check` in place: each gradient is overwritten
    with its unscaled value (one fp32 copy alive at a time), and the flag
    (a 0-d bool tensor on the scale's device) is returned, not read.
    Gradients on several devices (a model placed on a mesh) are unscaled
    there; each device's flags are reduced on that device, and the
    devices' flags then combined on the scale's."""
    inv = {scale.device: 1.0 / scale.float()}
    flags = {}
    for g in grads:
        d = g.device
        if d not in inv:
            inv[d] = inv[scale.device].to(d)
        if g.dtype == torch.float32:
            s = g.mul_(inv[d])
        else:
            s = g.float() * inv[d]
            g.copy_(s)
        ok = torch.isfinite(s).all()
        flags[d] = ok if d not in flags else flags[d] & ok
    finite = torch.ones((), dtype=torch.bool, device=scale.device)
    for d, ok in flags.items():
        finite = finite & (ok if d == scale.device else ok.to(scale.device))
    return finite


class BadStepSentry:
    """Skip non-finite optimizer steps; roll back after a run of them.

    Usage (raw loop)::

        sentry = BadStepSentry(manager=mgr, train_state=ts,
                               max_consecutive_bad=3)
        loss.backward()
        sentry.guard_step(opt)      # steps only when all grads are finite
        opt.zero_grad()

    ``guard_step`` costs one reduction over the gradients and one host
    read.  On rollback the last VALID checkpoint is restored through
    ``(manager, train_state)``, or a custom ``on_rollback`` callback
    runs."""

    def __init__(self, max_consecutive_bad: int = 3, manager=None,
                 train_state=None,
                 on_rollback: Optional[Callable[[], Any]] = None):
        if max_consecutive_bad < 1:
            raise ValueError("max_consecutive_bad must be >= 1")
        self.max_consecutive_bad = max_consecutive_bad
        self.manager = manager
        self.train_state = train_state
        self.on_rollback = on_rollback
        self.stats = {"steps": 0, "good_steps": 0, "bad_steps": 0,
                      "consecutive_bad": 0, "rollbacks": 0}

    def grads_finite(self, optimizer) -> bool:
        grads = grads_of(optimizer)
        return True if not grads else bool(tree_all_finite(grads))

    def guard_step(self, optimizer) -> bool:
        """``optimizer.step()`` iff every gradient is finite; returns
        whether the step was applied.  Counts bad steps and rolls back
        after ``max_consecutive_bad`` in a row."""
        self.stats["steps"] += 1
        if self.grads_finite(optimizer):
            self.stats["good_steps"] += 1
            self.stats["consecutive_bad"] = 0
            optimizer.step()
            return True
        self.stats["bad_steps"] += 1
        self.stats["consecutive_bad"] += 1
        if self.stats["consecutive_bad"] >= self.max_consecutive_bad:
            self.rollback()
        return False

    def rollback(self):
        """Restore the last valid checkpoint (or run on_rollback)."""
        self.stats["consecutive_bad"] = 0
        if self.on_rollback is not None:
            self.on_rollback()
            self.stats["rollbacks"] += 1
            return
        if self.manager is None or self.train_state is None:
            return
        info = self.manager.latest()
        if info is None:
            return
        tree, _ = self.manager.restore(info)
        self.train_state.restore(tree)
        self.stats["rollbacks"] += 1
