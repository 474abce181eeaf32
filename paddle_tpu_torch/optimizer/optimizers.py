"""AdamW with decoupled weight decay (port of ``AdamW``/``Adam`` of
``paddle_tpu/optimizer/optimizers.py``), as a ``torch.optim.Optimizer``.

Every parameter's update is one call of
``ops/kernels/fused_adamw.fused_adamw_update``: the Hopper kernel for a
parameter on the card, its plain PyTorch version for one on the CPU --
the same update the reference's composed chain (``AdamW._apply_one``)
and its Pallas route (``use_fused_kernel=True``) compute, in fp32, with
p, moment1 and moment2 written back in place in their storage dtype.

As in the reference, the bias-correction powers beta1^t and beta2^t are
one pair for the optimizer, kept in fp32 and advanced once per
``step()`` before any update; they live on the host and reach the kernel
as launch arguments.  With ``multi_precision=False`` (the pure-bf16
regime of ``bench.py``) the moments live in the parameter dtype; fp32
parameters keep fp32 moments either way.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.kernels.fused_adamw import fused_adamw_update

__all__ = ["AdamW"]


def _unported(what: str):
    return NotImplementedError(
        f"AdamW: {what} is not ported yet (ROADMAP.md queue 1, item 2, "
        "training)")


class AdamW(torch.optim.Optimizer):
    """``AdamW(parameters, learning_rate=1e-3, beta1=0.9, beta2=0.999,
    epsilon=1e-8, weight_decay=0.01, multi_precision=True)``: the
    reference's defaults; weight decay applies to every parameter.

    Not ported yet, and raising ``NotImplementedError``: a learning-rate
    scheduler in place of a float ``learning_rate``, ``grad_clip``,
    ``lr_ratio``, ``apply_decay_param_fun``, and low-precision parameters
    with ``multi_precision=True`` (fp32 master weights)."""

    def __init__(self, parameters, learning_rate=0.001, beta1=0.9,
                 beta2=0.999, epsilon=1e-8, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 multi_precision=True):
        if not isinstance(learning_rate, (int, float)):
            raise _unported("a learning-rate scheduler")
        if grad_clip is not None:
            raise _unported("grad_clip")
        if lr_ratio is not None:
            raise _unported("lr_ratio")
        if apply_decay_param_fun is not None:
            raise _unported("apply_decay_param_fun")
        if not isinstance(weight_decay, (int, float)):
            raise TypeError("AdamW applies decoupled L2 decay: weight_decay "
                            "must be a float coefficient")
        defaults = dict(lr=float(learning_rate), eps=float(epsilon),
                        weight_decay=float(weight_decay))
        super().__init__(parameters, defaults)
        self.beta1, self.beta2 = float(beta1), float(beta2)
        if multi_precision and any(
                p.dtype != torch.float32
                for g in self.param_groups for p in g["params"]):
            raise _unported("multi_precision=True for low-precision "
                            "parameters (fp32 master weights)")
        # beta1^t and beta2^t, fp32 as the reference keeps them
        self.beta1_pow = np.float32(1.0)
        self.beta2_pow = np.float32(1.0)

    @torch.no_grad()
    def step(self):
        self.beta1_pow = np.float32(self.beta1_pow * np.float32(self.beta1))
        self.beta2_pow = np.float32(self.beta2_pow * np.float32(self.beta2))
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["moment1"] = torch.zeros_like(
                        p, memory_format=torch.contiguous_format)
                    state["moment2"] = torch.zeros_like(
                        p, memory_format=torch.contiguous_format)
                fused_adamw_update(
                    p, p.grad, state["moment1"], state["moment2"],
                    group["lr"], self.beta1_pow, self.beta2_pow,
                    beta1=self.beta1, beta2=self.beta2, eps=group["eps"],
                    wd=group["weight_decay"])
