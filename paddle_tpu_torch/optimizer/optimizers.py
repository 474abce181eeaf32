"""AdamW with decoupled weight decay (port of ``AdamW``/``Adam`` of
``paddle_tpu/optimizer/optimizers.py``), as a ``torch.optim.Optimizer``,
and ``SGD`` and ``Momentum`` (:class:`SGD`, :class:`Momentum`).

Every parameter's update is one call of
``ops/kernels/fused_adamw.fused_adamw_update``: the Hopper kernel for a
parameter on the card, its plain PyTorch version for one on the CPU --
the same update the reference's composed chain (``AdamW._apply_one``)
and its Pallas route (``use_fused_kernel=True``) compute, in fp32, with
p, moment1 and moment2 written back in place in their storage dtype.

As in the reference, the bias-correction powers beta1^t and beta2^t are
one pair for the optimizer, kept in fp32 and advanced once per
``step()`` before any update.  They live on the host and reach the kernel
as launch arguments, as does the learning rate (a float, or an
``LRScheduler``'s value) -- until a step is gated by a device finiteness
flag (``step(finite=)``, which ``FusedTrainStep`` passes under an enabled
``GradScaler``): from then on they live in a device fp32 pair that the
kernel reads, so a skipped step needs no host sync.  Parameters on
several devices (a model placed on a mesh) get one such pair on each
device, advanced alike.  ``grad_clip`` sees every ``(param, grad)`` pair
before any update.

The parts of a logical tensor of a placed model
(``distributed.shards.ShardedParameter``) save and load their moments
and masters as the whole tensor, under the index the logical tensor
first takes among the parameters: an optimizer over an unplaced model
and one over the same model placed on any mesh have the same
``state_dict()`` keys and shapes.  Under ZeRO
(``distributed.sharding.group_sharded_parallel``) the optimizer steps
flat slices of the pieces, each with its own state, and ``_zero`` (the
layout) gives the slices their gradients before a step, copies the
updated slices into the replicas after it (``os``, ``os_g``), and clears
the replicas' gradients with the slices'; the state dict stays whole.

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

from ..distributed.shards import (
    held_cuts, logical_owner, logical_value, replica_of, slice_info,
)
from ..ops.kernels.fused_adamw import fused_adamw_update
from .lr import LRScheduler

__all__ = ["AdamW", "SGD", "Momentum", "PlainOptimizer"]

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


@torch.no_grad()
def copy_replica_state(opt, names):
    """Give each dp replica copy among ``opt``'s parameters the state
    ``names`` of its replica-0 source (after a load)."""
    for p in (p for g in opt.param_groups for p in g["params"]):
        src = replica_of(p)
        if src is None:
            continue
        for name in names:
            if name in opt.state[p] and name in opt.state[src]:
                opt.state[p][name].copy_(opt.state[src][name])


class AdamW(torch.optim.Optimizer):
    """``AdamW(learning_rate=1e-3, beta1=0.9, beta2=0.999, epsilon=1e-8,
    parameters=None, weight_decay=0.01, lr_ratio=None,
    apply_decay_param_fun=None, grad_clip=None, lazy_mode=False,
    multi_precision=True, use_fused_kernel=False, name=None)``: the
    reference's options, defaults and order.

    - ``parameters`` (required): parameters, ``(name, param)`` pairs such
      as ``model.named_parameters()``, or dicts of either as param groups:
      the names are what ``apply_decay_param_fun(name)`` sees (a bare
      parameter's ``p.name``, ``""`` without one);
    - ``learning_rate``: a float or an ``LRScheduler``, read at every
      ``step()`` (the caller steps the scheduler);
    - ``lr_ratio(p)``: a factor on each parameter's rate (called with
      the parameter the optimizer was given, also once an Engine's plan
      or ZeRO steps its blocks or slices);
    - ``apply_decay_param_fun(name)``: whether a parameter is decayed
      (every parameter is, without it);
    - ``grad_clip``: a ``ClipGradBy*`` object, applied to every
      ``(param, grad)`` pair before any update;
    - ``lazy_mode=True`` (the reference's sparse-row update) raises;
      ``use_fused_kernel`` and ``name`` are accepted and ignored: every
      update runs the fused kernel."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=True,
                 use_fused_kernel=False, name=None):
        if parameters is None:
            raise ValueError("AdamW: pass parameters= (the port has no "
                             "global program to take them from)")
        if lazy_mode:
            raise NotImplementedError(
                "AdamW(lazy_mode=True): the sparse-row update is not "
                "ported (ROADMAP.md queue 1, item 10)")
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
        # beta1^t and beta2^t, fp32 as the reference keeps them: host
        # scalars, until a step gated by a device flag moves them into
        # a device pair on each parameters' device, _pairs (see step)
        self._host_pows = [np.float32(1.0), np.float32(1.0)]
        self._pairs = self._betas = None
        # torch's constructor hands every group to add_param_group below
        super().__init__(parameters, defaults)

    @property
    def beta1_pow(self) -> np.float32:
        """beta1^t (read from the card, one sync, while the device pair
        holds it)."""
        return self._pow(0)

    @beta1_pow.setter
    def beta1_pow(self, v):
        self._set_pow(0, v)

    @property
    def beta2_pow(self) -> np.float32:
        return self._pow(1)

    @beta2_pow.setter
    def beta2_pow(self, v):
        self._set_pow(1, v)

    @property
    def _pows(self):
        """The first device's pair of beta powers (None on the host)."""
        return next(iter(self._pairs.values())) if self._pairs else None

    def _pow(self, i):
        if self._pows is not None:
            return np.float32(self._pows[i].item())
        return self._host_pows[i]

    def _set_pow(self, i, v):
        self._host_pows[i] = np.float32(v)
        for pair in (self._pairs or {}).values():
            pair[i] = float(self._host_pows[i])

    def _device_pows(self, devices):
        """The device pairs of beta powers (and betas), one on each of
        ``devices``; a new one starts from the host values, or from the
        first pair once the pairs have advanced."""
        if self._pairs is None:
            self._pairs, self._betas = {}, {}
        for dev in devices:
            if dev in self._pairs:
                continue
            pair = torch.empty(2, dtype=torch.float32, device=dev)
            betas = torch.empty(2, dtype=torch.float32, device=dev)
            if self._pairs:
                pair.copy_(self._pows)
            else:
                # filled on the device (no host-to-device copy waits here)
                for i in range(2):
                    pair[i] = float(self._host_pows[i])
            for i in range(2):
                betas[i] = (self.beta1, self.beta2)[i]
            self._pairs[dev], self._betas[dev] = pair, betas

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
            # a ZeRO slice's piece, a placed block's whole parameter
            sl = slice_info(p)
            held = p if sl is None else sl.owner
            ratio = self._lr_ratio(getattr(held, "placed_from", held))
            lr = np.float32(lr * np.float32(ratio)) if sched else lr * ratio
        return lr, sched

    @torch.no_grad()
    def step(self, *, finite=None):
        """One update of every parameter with a gradient.  ``finite``: a
        0-d bool tensor, the step's finiteness flag, as ``FusedTrainStep``
        computes it under an enabled ``GradScaler``; it is copied to each
        parameters' device.  With it, nothing waits for the card: the beta
        powers move into a device fp32 pair on each parameters' device
        (once) and advance there as ``where(finite, pow * beta, pow)``;
        each kernel reads its device's pair and flag,
        and writes nothing when the flag is false, so a non-finite step
        leaves parameters, moments, masters and the powers bitwise
        unchanged.  Without it the powers are host scalars, passed to each
        launch (or, once the pairs exist, advanced there
        unconditionally)."""
        zero = getattr(self, "_zero", None)
        if zero is not None:
            zero.prepare_grads()
        params_grads = [(p, p.grad) for p in self._params()
                        if p.grad is not None]
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        devices = list(dict.fromkeys(p.device for p, _ in params_grads))
        if (finite is not None and params_grads) or self._pairs is not None:
            self._device_pows(devices)
        flags = None
        if finite is not None:
            # each device's kernels read the flag's copy on that device
            flags = {d: finite if finite.device == d else finite.to(d)
                     for d in dict.fromkeys(list(self._pairs or ()) + devices)}
        if self._pairs is not None:
            for dev, pair in self._pairs.items():
                adv = pair * self._betas[dev]
                pair.copy_(adv if flags is None
                           else torch.where(flags[dev], adv, pair))
            b1p = b2p = None
        else:
            self._host_pows = [
                np.float32(self._host_pows[0] * np.float32(self.beta1)),
                np.float32(self._host_pows[1] * np.float32(self.beta2))]
            b1p, b2p = self._host_pows
        group_of = {id(p): g for g in self.param_groups for p in g["params"]}
        for p, g in params_grads:
            group = group_of[id(p)]
            state = self.state[p]
            lr, fp32_lr = self._lr(group, p)
            decay = (self._apply_decay_fun is None
                     or self._apply_decay_fun(self._names[id(p)]))
            fused_adamw_update(
                p, g, state["moment1"], state["moment2"], lr, b1p, b2p,
                beta1=self.beta1, beta2=self.beta2, eps=group["eps"],
                wd=group["weight_decay"] if decay else 0.0, fp32_lr=fp32_lr,
                master=state.get("master"),
                finite=None if flags is None else flags[p.device],
                pows=None if self._pairs is None else self._pairs[p.device])
        if zero is not None:
            zero.after_step()

    def _logical(self):
        return _logical_entries(self._params())

    def _state_of(self, entry, name):
        """``entry``'s state ``name`` (a whole tensor: a sharded entry's
        is gathered from its replica-0 parts or ZeRO slices), or None."""
        return logical_value(entry,
                             lambda t: self.state.get(t, {}).get(name))

    # -- the reference's state_dict --------------------------------------
    def state_dict(self):
        """The reference's keys: ``moment1_i``, ``moment2_i`` and, for a
        parameter with a master weight, ``master_i`` (i: the parameter's
        index in the list the optimizer was built from, counting a placed
        model's logical tensor once: its whole state); ``aux_0`` and
        ``aux_1``, beta1^t and beta2^t as fp32 0-d tensors (on the card
        while the device pair holds them); and
        ``LR_Scheduler`` when the rate is a scheduler."""
        sd = {}
        for i, entry in enumerate(self._logical()):
            for name in ("moment1", "moment2", "master"):
                t = self._state_of(entry, name)
                if t is not None:
                    sd[f"{name}_{i}"] = t
        if self._pows is not None:
            sd["aux_0"], sd["aux_1"] = (t.clone() for t in self._pows)
        else:
            sd["aux_0"] = torch.tensor(self._host_pows[0])
            sd["aux_1"] = torch.tensor(self._host_pows[1])
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
        for i, entry in enumerate(self._logical()):
            placed = not isinstance(entry, torch.Tensor)
            for name in ("moment1", "moment2", "master"):
                key = f"{name}_{i}"
                if key not in state_dict:
                    continue
                v = state_dict[key]
                v = v if isinstance(v, torch.Tensor) else \
                    torch.from_numpy(np.array(v, np.float32))
                shape = entry.whole_shape if placed else tuple(entry.shape)
                if tuple(v.shape) != shape:
                    raise ValueError(f"set_state_dict: {key} has shape "
                                     f"{tuple(v.shape)}, expected {shape}")
                _load_cuts(self, entry, name, v)
        copy_replica_state(self, ("moment1", "moment2", "master"))
        for key, attr in (("aux_0", "beta1_pow"), ("aux_1", "beta2_pow")):
            if key in state_dict:
                v = state_dict[key]
                v = v.cpu().numpy() if isinstance(v, torch.Tensor) else v
                setattr(self, attr, np.float32(np.asarray(v).reshape(())))
        if "LR_Scheduler" in state_dict and isinstance(self._learning_rate,
                                                       LRScheduler):
            self._learning_rate.set_state_dict(state_dict["LR_Scheduler"])

    load_state_dict = set_state_dict

    def zero_grad(self, set_to_none: bool = True):
        super().zero_grad(set_to_none=set_to_none)
        _clear_zero_grads(self, set_to_none)

    def clear_grad(self, set_to_zero=False):
        """The reference's ``clear_grad``: drop every gradient, or with
        ``set_to_zero`` zero those that exist (the next backward adds
        into them)."""
        self.zero_grad(set_to_none=not set_to_zero)

    clear_gradients = clear_grad


def _logical_entries(params):
    """The parameters as a state dict indexes them: one entry a logical
    tensor, in the order each first appears -- a parameter, or a placed
    model's ``ShardedParameter`` (every part of it must be in the
    optimizer); a dp replica's copies, and ZeRO slices of groups other
    than 0, are left out."""
    out, seen = [], set()
    for p in params:
        sl = slice_info(p)
        if replica_of(p) is not None or (sl is not None and sl.group):
            continue
        entry = logical_owner(p)
        if id(entry) not in seen:
            seen.add(id(entry))
            out.append(entry)
    return out


@torch.no_grad()
def _load_cuts(opt, entry, name, whole):
    """``whole`` (a logical tensor's state ``name``) into every tensor the
    optimizer holds it in: the parts, or the ZeRO slices of every
    group."""
    for t, v in held_cuts(entry, whole):
        st = opt.state.get(t, {}).get(name)
        if st is not None:
            st.copy_(v.reshape(st.shape))


def _clear_zero_grads(opt, set_to_none):
    zero = getattr(opt, "_zero", None)
    if zero is not None:
        zero.clear_grads(set_to_none)


class PlainOptimizer(torch.optim.Optimizer):
    """The base of the optimizers the JAX package updates with plain array
    expressions, outside any Pallas kernel (:class:`SGD`,
    :class:`Momentum`, the fleet meta-optimizers): the reference's
    ``Optimizer`` protocol as a ``torch.optim.Optimizer``.

    - ``parameters`` (required): parameters, ``(name, param)`` pairs or
      dicts of either as param groups, as :class:`AdamW` takes them;
    - ``learning_rate``: a float or an ``LRScheduler``, read at every
      ``step()``;
    - ``weight_decay``: None, or a float ``c``: the reference's L2 term
      ``g + c * p`` (``_decayed_grad``) added to each gradient; a
      regularizer object raises;
    - ``grad_clip`` sees every ``(param, grad)`` pair before any update.

    Each of :attr:`ACCUMULATORS` is an fp32 zero tensor a parameter, made
    when the parameter joins; updates run in fp32 and are cast back to
    the parameter's dtype.  ``state_dict()`` keys them ``{name}_{i}``
    (``i`` a logical tensor's index, as :class:`AdamW` counts them) with
    ``LR_Scheduler`` under a scheduler."""

    ACCUMULATORS: tuple = ()

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None):
        if parameters is None:
            raise ValueError(f"{type(self).__name__}: pass parameters= (the "
                             "port has no global program to take them "
                             "from)")
        if weight_decay is not None and not isinstance(weight_decay,
                                                       (int, float)):
            raise NotImplementedError(
                f"{type(self).__name__}(weight_decay="
                f"{type(weight_decay).__name__}): regularizer objects are "
                "not ported (ROADMAP.md queue 1, item 10); a float is the "
                "L2 coefficient")
        self._learning_rate = learning_rate
        self._weight_decay = (None if weight_decay is None
                              else float(weight_decay))
        self._grad_clip = grad_clip
        self._names = {}
        sched = isinstance(learning_rate, LRScheduler)
        super().__init__(parameters, dict(
            lr=learning_rate() if sched else float(learning_rate)))

    def add_param_group(self, param_group):
        items = param_group["params"]
        items = [items] if isinstance(items, torch.Tensor) else list(items)
        params, names = _split_names(items)
        super().add_param_group({**param_group, "params": params})
        for p, name in zip(params, names):
            self._names[id(p)] = name
            for acc in self.ACCUMULATORS:
                self.state[p][acc] = torch.zeros_like(
                    p, dtype=torch.float32,
                    memory_format=torch.contiguous_format)

    def _params(self):
        return [p for g in self.param_groups for p in g["params"]]

    @property
    def _parameter_list(self):
        return self._params()

    def name_of(self, p) -> str:
        return self._names[id(p)]

    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self.param_groups[0]["lr"])

    def _decayed_grad(self, p, g32):
        """The reference's ``_decayed_grad``: ``g + c * p``, the product in
        the parameter's dtype."""
        if self._weight_decay is None:
            return g32
        return g32 + self._weight_decay * p

    @torch.no_grad()
    def step(self):
        zero = getattr(self, "_zero", None)
        if zero is not None:
            zero.prepare_grads()
        params_grads = [(p, p.grad) for p in self._params()
                        if p.grad is not None]
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        self._update(params_grads)
        if zero is not None:
            zero.after_step()

    def _update(self, params_grads):
        lr = self.get_lr()
        for p, g in params_grads:
            self._apply_one(p, g, lr)

    def _apply_one(self, p, g, lr):
        raise NotImplementedError

    def zero_grad(self, set_to_none: bool = True):
        super().zero_grad(set_to_none=set_to_none)
        _clear_zero_grads(self, set_to_none)

    def clear_grad(self, set_to_zero=False):
        self.zero_grad(set_to_none=not set_to_zero)

    clear_gradients = clear_grad

    def _logical(self):
        return _logical_entries(self._params())

    def state_dict(self):
        sd = {}
        entries = self._logical()
        for name in self.ACCUMULATORS:
            for i, entry in enumerate(entries):
                sd[f"{name}_{i}"] = logical_value(
                    entry, lambda t: self.state.get(t, {}).get(name))
        if isinstance(self._learning_rate, LRScheduler):
            sd["LR_Scheduler"] = self._learning_rate.state_dict()
        return sd

    @torch.no_grad()
    def set_state_dict(self, state_dict: Mapping):
        for i, entry in enumerate(self._logical()):
            for name in self.ACCUMULATORS:
                key = f"{name}_{i}"
                if key not in state_dict:
                    continue
                v = state_dict[key]
                v = v if isinstance(v, torch.Tensor) else \
                    torch.from_numpy(np.array(v, np.float32))
                _load_cuts(self, entry, name, v)
        copy_replica_state(self, self.ACCUMULATORS)
        if "LR_Scheduler" in state_dict and isinstance(self._learning_rate,
                                                       LRScheduler):
            self._learning_rate.set_state_dict(state_dict["LR_Scheduler"])

    load_state_dict = set_state_dict


class SGD(PlainOptimizer):
    """``SGD(learning_rate=0.001, parameters=None, weight_decay=None,
    grad_clip=None, name=None)``: ``p - lr * (g + c p)`` in fp32."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)

    def _apply_one(self, p, g, lr):
        g32 = self._decayed_grad(p, g.float())
        p.copy_((p.float() - lr * g32).to(p.dtype))


class Momentum(PlainOptimizer):
    """``Momentum(learning_rate=0.001, momentum=0.9, parameters=None,
    use_nesterov=False, weight_decay=None, grad_clip=None, name=None)``:
    ``v = m v + g``; ``p - lr * v``, or with ``use_nesterov`` ``p - lr *
    (g + m v)``, in fp32 (``g`` with the L2 term)."""

    ACCUMULATORS = ("velocity",)

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None):
        self._momentum = momentum
        self._nesterov = bool(use_nesterov)
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)

    def _apply_one(self, p, g, lr):
        v = self.state[p]["velocity"]
        g32 = self._decayed_grad(p, g.float())
        new_v = self._momentum * v + g32
        update = g32 + self._momentum * new_v if self._nesterov else new_v
        v.copy_(new_v)
        p.copy_((p.float() - lr * update).to(p.dtype))
