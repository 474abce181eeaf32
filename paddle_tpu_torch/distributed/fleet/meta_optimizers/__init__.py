"""The fleet meta-optimizers (port of
``paddle_tpu/distributed/fleet/meta_optimizers/__init__.py``):
``LarsMomentum``, ``DGCMomentum``, ``LocalSGD`` and ``GradientMerge``,
and the strategy's selection pass, :func:`apply_strategy_meta_optimizers`,
which ``fleet.distributed_optimizer`` runs.

The JAX package computes each update as plain array expressions (no
Pallas kernel), and so does the port, in fp32, cast back to each
parameter's dtype.  On a placed model a logical tensor is held as parts
(``shards.ShardedParameter``) and dp replica copies: LARS's norms and
DGC's threshold are the logical tensor's -- squares summed, or values
gathered, over the pieces that hold it once (``shards.covers_once``) --
and every piece gets the same scalar, so each equals the update of the
whole tensor.  Under ZeRO (``distributed.sharding``) the pieces are the
slices, and ``GradientMerge``'s accumulators are sliced with them.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ....optimizer.optimizers import (
    Momentum, PlainOptimizer, SGD, _logical_entries,
)
from ...shards import (
    ShardedParameter, _optimizer_chain, covers_once, held_cuts,
    logical_owner, logical_value, replica_of, shard_info, slice_info,
)

__all__ = ["LarsMomentum", "DGCMomentum", "LocalSGD", "GradientMerge",
           "apply_strategy_meta_optimizers"]


def _by_logical(params_grads) -> List[list]:
    """``(param, grad)`` pairs grouped by logical tensor, in the order each
    first appears."""
    groups: Dict[int, list] = {}
    for p, g in params_grads:
        groups.setdefault(id(logical_owner(p)), []).append((p, g))
    return list(groups.values())


def _sum_sq(tensors) -> torch.Tensor:
    """The sum of squares (fp32) of the pieces among ``tensors`` that hold
    their logical tensor once, on the first one's device."""
    once = [t for t in tensors if covers_once(t[0])]
    root = once[0][1].device
    total = None
    for _, v in once:
        sq = torch.sum(torch.square(v.float())).to(root)
        total = sq if total is None else total + sq
    return total


class LarsMomentum(PlainOptimizer):
    """Layer-wise adaptive rate scaling (the reference's ``LarsMomentum``):
    ``local_lr = lr * coeff * ||w|| / (||g|| + wd ||w|| + eps)`` (``lr``
    where either norm is 0), ``v = m v + local_lr (g + wd w)``, ``w - v``.
    ``wd`` is 0 for a parameter whose name holds a tag of
    ``exclude_from_weight_decay`` (the name of a ``(name, param)`` pair,
    or ``p.name``)."""

    ACCUMULATORS = ("velocity",)

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 lars_coeff=0.001, lars_weight_decay=0.0005, epsilon=1e-9,
                 exclude_from_weight_decay=None, grad_clip=None, name=None):
        self._momentum = momentum
        self._coeff = lars_coeff
        self._lars_wd = lars_weight_decay
        self._eps = epsilon
        self._exclude = exclude_from_weight_decay or []
        super().__init__(learning_rate, parameters, None, grad_clip)

    def _update(self, params_grads):
        lr = self.get_lr()
        for group in _by_logical(params_grads):
            name = self.name_of(group[0][0])
            wd = 0.0 if any(tag in name for tag in self._exclude) \
                else self._lars_wd
            w_norm = torch.sqrt(_sum_sq([(p, p) for p, _ in group]))
            g_norm = torch.sqrt(_sum_sq(group))
            local = torch.where(
                (w_norm > 0) & (g_norm > 0),
                lr * self._coeff * w_norm / (g_norm + wd * w_norm
                                             + self._eps),
                torch.tensor(lr, dtype=torch.float32, device=w_norm.device))
            for p, g in group:
                v = self.state[p]["velocity"]
                pv = p.float()
                new_v = self._momentum * v + local.to(p.device) * (
                    g.float() + wd * pv)
                v.copy_(new_v)
                p.copy_((pv - new_v).to(p.dtype))


def percentile(parts, q: float) -> torch.Tensor:
    """``jnp.percentile`` of the values of ``parts`` (fp32 tensors,
    together one logical tensor) at ``q`` percent, with its linear
    interpolation and its fp32 arithmetic, as a 0-d tensor on the first
    part's device: two order statistics by ``kthvalue`` (``torch.quantile``
    refuses inputs above 2^24 elements)."""
    root = parts[0].device
    flat = torch.cat([t.reshape(-1).to(root) for t in parts])
    n = np.float32(flat.numel())
    pos = np.float32(np.float32(np.float32(q) / np.float32(100.0))
                     * np.float32(n - np.float32(1.0)))
    low = np.clip(np.floor(pos), np.float32(0.0), n - np.float32(1.0))
    high = np.clip(np.ceil(pos), np.float32(0.0), n - np.float32(1.0))
    hw = np.float32(pos - np.floor(pos))
    lw = np.float32(np.float32(1.0) - hw)
    lo = torch.kthvalue(flat, int(low) + 1).values
    hi = lo if high == low else torch.kthvalue(flat, int(high) + 1).values
    return lo * float(lw) + hi * float(hw)


class DGCMomentum(PlainOptimizer):
    """Deep gradient compression (the reference's ``DGCMomentum``):
    momentum correction ``u = m u + g``, ``acc = v + u``; the entries of
    ``acc`` at or above the ``sparsity`` percentile of ``|acc|`` (over the
    whole logical tensor) are sent, ``w - lr * sent``, and the rest stay
    in ``u`` and ``v``.  Until the step count passes ``rampup_begin_step``
    the update is plain momentum (everything sent, the momentum buffer
    kept).  The step count lives on each parameters' device, one int32
    counter a device, so the switch needs no host read; a logical tensor
    of fewer than 2 elements always takes ``w - lr * u``."""

    ACCUMULATORS = ("u", "v")

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 rampup_begin_step=0, sparsity=0.999, grad_clip=None,
                 name=None):
        self._momentum = momentum
        self._sparsity = float(sparsity)
        self._rampup_begin = int(rampup_begin_step)
        self._steps: Dict[torch.device, torch.Tensor] = {}
        super().__init__(learning_rate, parameters, None, grad_clip)

    @torch.no_grad()
    def step(self):
        for p in self._params():
            if p.device not in self._steps:
                self._steps[p.device] = torch.zeros((), dtype=torch.int32,
                                                    device=p.device)
        for t in self._steps.values():
            t.add_(1)
        super().step()

    def _update(self, params_grads):
        lr = self.get_lr()
        m = self._momentum
        for group in _by_logical(params_grads):
            new_u = {id(p): m * self.state[p]["u"] + g.float()
                     for p, g in group}
            acc = {id(p): self.state[p]["v"] + new_u[id(p)]
                   for p, _ in group}
            owner = logical_owner(group[0][0])
            numel = (int(np.prod(owner.whole_shape))
                     if isinstance(owner, ShardedParameter)
                     else owner.numel())
            if numel < 2:
                for p, _ in group:
                    self.state[p]["u"].copy_(new_u[id(p)])
                    p.copy_((p.float() - lr * new_u[id(p)]).to(p.dtype))
                continue
            q = percentile([acc[id(p)].abs() for p, _ in group
                            if covers_once(p)], self._sparsity * 100.0)
            for p, _ in group:
                u, v = self.state[p]["u"], self.state[p]["v"]
                a, nu = acc[id(p)], new_u[id(p)]
                warm = self._steps[p.device] <= self._rampup_begin
                mask = (a.abs() >= q.to(p.device)).float()
                mask = torch.where(warm, torch.ones_like(mask), mask)
                sent = torch.where(warm, nu, a * mask)
                u.copy_(torch.where(warm, nu, nu * (1.0 - mask)))
                v.copy_(torch.where(warm, v, a * (1.0 - mask)))
                p.copy_((p.float() - lr * sent).to(p.dtype))


def _replica_sets(params):
    """The dp replicas among ``params`` grouped: each list one piece's
    copies in replica order (a placed stacked model's replica parts, or a
    fleet replica's copies with their source); pieces without replicas
    are left out."""
    sets: Dict[tuple, list] = {}
    for p in params:
        sl = slice_info(p)
        if sl is not None:
            # a ZeRO slice and its counterparts in the other groups
            sets.setdefault(("slice", id(sl.owner), sl.index), []).append(p)
            continue
        src = replica_of(p)
        if src is not None:
            key = ("copy", id(src))
            sets.setdefault(key, [src]).append(p)
            continue
        info = shard_info(p)
        if info is not None:
            part = info[0].parts[info[1]]
            sets.setdefault(("part", id(info[0]), part.position[1:]),
                            []).append(p)
    return [s for s in sets.values() if len(s) > 1]


class _Wrapper:
    """The inner optimizer's protocol, delegated."""

    def __init__(self, inner):
        self._inner = inner

    @property
    def param_groups(self):
        return self._inner.param_groups

    @property
    def _parameter_list(self):
        return [p for g in self._inner.param_groups for p in g["params"]]

    def clear_grad(self, set_to_zero=False):
        self._inner.clear_grad(set_to_zero)

    clear_gradients = clear_grad

    def get_lr(self):
        return self._inner.get_lr()


class LocalSGD(_Wrapper):
    """Local SGD (the reference's ``LocalSGD``): the inner optimizer's
    step, and every ``k_steps`` steps each parameter averaged over its dp
    replicas.  The reference averages over the process world (one
    process here) and, under tracing, over replicas the mesh keeps equal;
    the port's replicas are tied, so they hold the same bits and the
    average (their sum, in replica order, over their count) gives them
    back."""

    def __init__(self, inner_optimizer, k_steps=4, group=None, name=None):
        super().__init__(inner_optimizer)
        self._k = int(k_steps)
        self._n = 0

    def step(self):
        self._inner.step()
        self._n += 1
        if self._n % self._k == 0:
            self._average_params()

    @torch.no_grad()
    def _average_params(self):
        for copies in _replica_sets(self._parameter_list):
            root = copies[0].device
            total = None
            for t in copies:
                total = t.to(root) if total is None else total + t.to(root)
            mean = (total / len(copies)).to(copies[0].dtype)
            for t in copies:
                t.copy_(mean.to(t.device))

    def state_dict(self):
        return self._inner.state_dict()

    def set_state_dict(self, sd):
        return self._inner.set_state_dict(sd)

    load_state_dict = set_state_dict


class GradientMerge(_Wrapper):
    """Gradient merging (the reference's ``GradientMerge``): each step adds
    the gradients into fp32 accumulators, and every ``k_steps``-th step
    the inner optimizer steps once on the merged gradient (``acc / k``
    with ``avg``, else ``acc``, cast to each gradient's dtype) and the
    accumulators are zeroed.  The reference runs the inner step on every
    call and rolls every state tensor back on the others; the port steps
    only on the k-th, which leaves the same weights, moments, beta powers
    and flags.  ``state_dict()`` adds ``gradient_merge``: the step count
    and the accumulators (whole logical tensors, in the inner optimizer's
    parameter order), so a run resumes mid-window."""

    def __init__(self, inner_optimizer, k_steps=1, avg=True):
        super().__init__(inner_optimizer)
        self._k = int(k_steps)
        self._avg = avg
        self._step = 0
        self._acc = {id(p): torch.zeros_like(p, dtype=torch.float32)
                     for p in self._parameter_list}

    @torch.no_grad()
    def step(self):
        if self._k <= 1:
            self._inner.step()
            return
        zero = getattr(_optimizer_chain(self)[-1], "_zero", None)
        if zero is not None:
            zero.prepare_grads()
        self._step += 1
        for p in self._parameter_list:
            if p.grad is not None:
                self._acc[id(p)].add_(p.grad.float())
        if self._step % self._k:
            return
        for p in self._parameter_list:
            if p.grad is not None:
                acc = self._acc[id(p)]
                merged = acc / self._k if self._avg else acc
                p.grad = merged.to(p.grad.dtype)
        self._inner.step()
        for acc in self._acc.values():
            acc.zero_()

    def _logical(self):
        return _logical_entries(self._parameter_list)

    def state_dict(self):
        sd = dict(self._inner.state_dict())
        acc = [logical_value(entry, lambda t: self._acc.get(id(t)))
               .cpu().numpy() for entry in self._logical()]
        sd["gradient_merge"] = {"step": np.asarray(self._step, np.int32),
                                "acc": acc}
        return sd

    @torch.no_grad()
    def set_state_dict(self, sd):
        sd = dict(sd)
        gm = sd.pop("gradient_merge", None)
        self._inner.set_state_dict(sd)
        if gm is None:
            return
        self._step = int(np.asarray(gm["step"]))
        for entry, a in zip(self._logical(), gm["acc"]):
            whole = torch.as_tensor(np.asarray(a, np.float32))
            for t, c in held_cuts(entry, whole):
                if id(t) in self._acc:
                    self._acc[id(t)].copy_(c.reshape(self._acc[id(t)].shape))
        for p in self._parameter_list:
            src = replica_of(p)
            if src is not None:
                self._acc[id(p)].copy_(self._acc[id(src)])

    load_state_dict = set_state_dict


def apply_strategy_meta_optimizers(optimizer, strategy):
    """The reference's meta-optimizer selection pass: ``lars``, then
    ``dgc``, then ``localsgd``, then ``gradient_merge`` with ``k_steps >
    1`` picks a wrapped optimizer; LARS and DGC take only an optimizer of
    the momentum family (``ValueError`` otherwise), and step its
    parameters (under ZeRO its slices, with its layout)."""
    if strategy is None:
        return optimizer
    lars = getattr(strategy, "lars", False)
    dgc = getattr(strategy, "dgc", False)
    if (lars or dgc) and not isinstance(
            optimizer, (SGD, Momentum, LarsMomentum, DGCMomentum)):
        raise ValueError(
            f"strategy.lars/dgc requires a momentum-family optimizer, got "
            f"{type(optimizer).__name__}")
    if lars or dgc:
        params = [(optimizer.name_of(p), p)
                  for p in optimizer._parameter_list]
        momentum = getattr(optimizer, "_momentum", 0.9)
    if lars:
        cfg = getattr(strategy, "lars_configs", {}) or {}
        made = LarsMomentum(
            learning_rate=optimizer._learning_rate, momentum=momentum,
            parameters=params, lars_coeff=cfg.get("lars_coeff", 0.001),
            lars_weight_decay=cfg.get("lars_weight_decay", 0.0005),
            epsilon=cfg.get("epsilon", 1e-9),
            exclude_from_weight_decay=cfg.get("exclude_from_weight_decay"),
            grad_clip=optimizer._grad_clip)
    elif dgc:
        cfg = getattr(strategy, "dgc_configs", {}) or {}
        made = DGCMomentum(
            learning_rate=optimizer._learning_rate, momentum=momentum,
            parameters=params,
            rampup_begin_step=cfg.get("rampup_begin_step", 0),
            sparsity=(cfg.get("sparsity", [0.999]) or [0.999])[-1],
            grad_clip=optimizer._grad_clip)
    if lars or dgc:
        made._zero = getattr(optimizer, "_zero", None)
        return made
    if getattr(strategy, "localsgd", False):
        cfg = getattr(strategy, "localsgd_configs", {}) or {}
        return LocalSGD(optimizer, k_steps=cfg.get("k_steps", 4))
    if getattr(strategy, "gradient_merge", False):
        cfg = getattr(strategy, "gradient_merge_configs", {}) or {}
        k = int(cfg.get("k_steps", 1))
        if k > 1:
            return GradientMerge(optimizer, k_steps=k,
                                 avg=cfg.get("avg", True))
    return optimizer
