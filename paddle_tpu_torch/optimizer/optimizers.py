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
as launch arguments, as does the learning rate (a float, or an
``LRScheduler``'s value).  ``grad_clip`` sees every ``(param, grad)``
pair before any update.

Precision, as the reference's ``multi_precision``:

- ``multi_precision=True`` (the default): fp32 moments; a bf16 or fp16
  parameter also gets an fp32 master weight, made when the optimizer is
  built from the value it has then, and updated by the kernel's master
  form (``p`` is written from the master, never read);
- ``multi_precision=False`` (the pure-bf16 regime of ``bench.py``): the
  moments live in the parameter dtype and there are no masters.

State (moments, masters) is made for a parameter when it joins the
optimizer -- when the optimizer is built, as the reference makes it, or
by ``add_param_group`` -- from the value it has then.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..ops.kernels.fused_adamw import fused_adamw_update
from .lr import LRScheduler

__all__ = ["AdamW"]

_LOW = (torch.bfloat16, torch.float16)


def _split_names(parameters):
    """``(params, names)`` from an iterable of parameters or of
    ``(name, param)`` pairs (``named_parameters()``); a bare parameter's
    name is the reference's ``p.name or ""``: the ``name`` attribute a
    caller set on it, else ``""``."""
    params, names = [], []
    for item in parameters:
        if isinstance(item, tuple):
            name, p = item
        else:
            name, p = getattr(item, "name", None) or "", item
        params.append(p)
        names.append(name)
    return params, names


class AdamW(torch.optim.Optimizer):
    """``AdamW(parameters, learning_rate=1e-3, beta1=0.9, beta2=0.999,
    epsilon=1e-8, weight_decay=0.01, lr_ratio=None,
    apply_decay_param_fun=None, grad_clip=None, multi_precision=True)``:
    the reference's options and defaults.

    - ``parameters``: parameters, ``(name, param)`` pairs such as
      ``model.named_parameters()``, or dicts of either as param groups:
      the names are what ``apply_decay_param_fun(name)`` sees (a bare
      parameter's ``p.name``, ``""`` without one);
    - ``learning_rate``: a float or an ``LRScheduler``, read at every
      ``step()`` (the caller steps the scheduler);
    - ``lr_ratio(p)``: a factor on each parameter's rate;
    - ``apply_decay_param_fun(name)``: whether a parameter is decayed
      (every parameter is, without it);
    - ``grad_clip``: a ``ClipGradBy*`` object, applied to every
      ``(param, grad)`` pair before any update."""

    def __init__(self, parameters, learning_rate=0.001, beta1=0.9,
                 beta2=0.999, epsilon=1e-8, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 multi_precision=True):
        if not isinstance(weight_decay, (int, float)):
            raise TypeError("AdamW applies decoupled L2 decay: weight_decay "
                            "must be a float coefficient")
        sched = isinstance(learning_rate, LRScheduler)
        defaults = dict(lr=learning_rate() if sched else float(learning_rate),
                        eps=float(epsilon), weight_decay=float(weight_decay))
        self._learning_rate = learning_rate
        self._names = {}
        self.beta1, self.beta2 = float(beta1), float(beta2)
        self._lr_ratio = lr_ratio
        self._apply_decay_fun = apply_decay_param_fun
        self._grad_clip = grad_clip
        self._multi_precision = bool(multi_precision)
        # beta1^t and beta2^t, fp32 as the reference keeps them
        self.beta1_pow = np.float32(1.0)
        self.beta2_pow = np.float32(1.0)
        # torch's constructor hands every group to add_param_group below
        super().__init__(parameters, defaults)

    def add_param_group(self, param_group):
        """torch's ``add_param_group``, whose ``params`` may also be
        ``(name, param)`` pairs; the group's parameters get their names
        and their state now."""
        items = param_group["params"]
        items = [items] if isinstance(items, torch.Tensor) else list(items)
        params, names = _split_names(items)
        super().add_param_group({**param_group, "params": params})
        for p, name in zip(params, names):
            self._names[id(p)] = name
            self._init_state(p)

    def _params(self):
        """Every parameter, group after group: the reference's
        ``_parameter_list``, whose indices key ``state_dict()``."""
        return [p for g in self.param_groups for p in g["params"]]

    @torch.no_grad()
    def _init_state(self, p):
        state = self.state[p]
        low = p.dtype in _LOW
        moment_dtype = (torch.float32 if self._multi_precision
                        else p.dtype)
        fmt = torch.contiguous_format
        state["moment1"] = torch.zeros_like(p, dtype=moment_dtype,
                                            memory_format=fmt)
        state["moment2"] = torch.zeros_like(p, dtype=moment_dtype,
                                            memory_format=fmt)
        if self._multi_precision and low:
            state["master"] = p.detach().float().contiguous()

    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return self._learning_rate()
        return self.param_groups[0]["lr"]

    def _lr(self, group, p):
        """This step's rate for ``p`` and whether the reference holds it as
        an fp32 tensor (a scheduler's value; times ``lr_ratio(p)`` in
        fp32) or as a Python float (times ``lr_ratio(p)`` in double)."""
        sched = isinstance(self._learning_rate, LRScheduler)
        lr = np.float32(self._learning_rate()) if sched else group["lr"]
        if self._lr_ratio is not None:
            ratio = self._lr_ratio(p)
            lr = np.float32(lr * np.float32(ratio)) if sched else lr * ratio
        return lr, sched

    @torch.no_grad()
    def step(self):
        params_grads = [(p, p.grad) for p in self._params()
                        if p.grad is not None]
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        self.beta1_pow = np.float32(self.beta1_pow * np.float32(self.beta1))
        self.beta2_pow = np.float32(self.beta2_pow * np.float32(self.beta2))
        group_of = {id(p): g for g in self.param_groups for p in g["params"]}
        for p, g in params_grads:
            group = group_of[id(p)]
            state = self.state[p]
            lr, fp32_lr = self._lr(group, p)
            decay = (self._apply_decay_fun is None
                     or self._apply_decay_fun(self._names[id(p)]))
            fused_adamw_update(
                p, g, state["moment1"], state["moment2"], lr, self.beta1_pow,
                self.beta2_pow, beta1=self.beta1, beta2=self.beta2,
                eps=group["eps"],
                wd=group["weight_decay"] if decay else 0.0, fp32_lr=fp32_lr,
                master=state.get("master"))

    # -- the reference's state_dict --------------------------------------
    def state_dict(self):
        """The reference's keys: ``moment1_i``, ``moment2_i`` and, for a
        parameter with a master weight, ``master_i`` (i: the parameter's
        index in the list the optimizer was built from); ``aux_0`` and
        ``aux_1``, beta1^t and beta2^t as fp32 0-d tensors; and
        ``LR_Scheduler`` when the rate is a scheduler."""
        sd = {}
        for i, p in enumerate(self._params()):
            for name in ("moment1", "moment2", "master"):
                if name in self.state[p]:
                    sd[f"{name}_{i}"] = self.state[p][name]
        sd["aux_0"] = torch.tensor(self.beta1_pow)
        sd["aux_1"] = torch.tensor(self.beta2_pow)
        if isinstance(self._learning_rate, LRScheduler):
            sd["LR_Scheduler"] = self._learning_rate.state_dict()
        return sd

    @torch.no_grad()
    def set_state_dict(self, state_dict: Mapping):
        """Load :meth:`state_dict`'s keys from this optimizer or the JAX
        package's (values as tensors or numpy arrays): a JAX-trained run
        resumes here with its moments, masters, beta powers and
        schedule.  Keys that name no state of this optimizer are
        ignored, as the reference ignores them."""
        for i, p in enumerate(self._params()):
            for name in ("moment1", "moment2", "master"):
                key = f"{name}_{i}"
                if name in self.state[p] and key in state_dict:
                    dst = self.state[p][name]
                    v = state_dict[key]
                    v = v if isinstance(v, torch.Tensor) else \
                        torch.from_numpy(np.array(v, np.float32))
                    if tuple(v.shape) != tuple(dst.shape):
                        raise ValueError(f"set_state_dict: {key} has shape "
                                         f"{tuple(v.shape)}, expected "
                                         f"{tuple(dst.shape)}")
                    dst.copy_(v)
        for key, attr in (("aux_0", "beta1_pow"), ("aux_1", "beta2_pow")):
            if key in state_dict:
                v = state_dict[key]
                v = v.cpu().numpy() if isinstance(v, torch.Tensor) else v
                setattr(self, attr, np.float32(np.asarray(v).reshape(())))
        if "LR_Scheduler" in state_dict and isinstance(self._learning_rate,
                                                       LRScheduler):
            self._learning_rate.set_state_dict(state_dict["LR_Scheduler"])

    load_state_dict = set_state_dict
