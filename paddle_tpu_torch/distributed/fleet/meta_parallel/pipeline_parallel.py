"""Pipeline parallelism through the fleet API (port of
``paddle_tpu/distributed/fleet/meta_parallel/pipeline_parallel.py``).

``PipelineLayer`` builds a list of layers (``LayerDesc``s, built
modules, ``SharedLayerDesc``s or plain callables), cuts it into
``num_stages`` segments by the reference's uniform rule
(``segment_bounds``), and, under a global mesh, places each stage's
layers on that stage's position of replica 0: the shard devices
``mesh.stage_devices(s)`` (``shards.place_on_stage``).  A stage runs on
its first shard device; its input is moved there.

``PipelineParallel.train_batch`` runs the reference's 1F1B order over
``accumulate_steps`` microbatches: S - 1 forwards fill the pipe, then
each new forward is followed by the backward of the oldest microbatch
in flight, then the rest drain.  A forward is detached at each stage
boundary; a backward runs stage by stage from the last, each stage's
input gradient seeding the backward of the stage before it (what the
reference's p2p send of activation gradients carries).  One process
drives every stage in order on its devices, so stages do not overlap in
time: the order bounds the activations in flight (``last_peak_inflight``
<= S), as 1F1B does.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ... import mesh as _mesh
from ...shards import load_state, place_on_stage

__all__ = ["LayerDesc", "SharedLayerDesc", "PipelineLayer",
           "PipelineParallel"]


class LayerDesc:
    """A layer to build later: ``layer_cls(*args, **kwargs)``."""

    def __init__(self, layer_cls, *args, **kwargs):
        self.layer_cls = layer_cls
        self.args = args
        self.kwargs = kwargs

    def build_layer(self):
        return self.layer_cls(*self.args, **self.kwargs)


class SharedLayerDesc(LayerDesc):
    """A layer built once and used again wherever its ``key`` recurs,
    through ``forward_func(layer, x)`` when given.  Its weights stay on
    the stage that first uses it; a later use reads them from there."""

    def __init__(self, key, layer_cls, forward_func=None,
                 shared_weight_attr="weight", *args, **kwargs):
        super().__init__(layer_cls, *args, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class PipelineLayer(nn.Module):
    """The layers of a pipeline and their stages (module docstring).
    ``state_dict()`` keys each built layer ``run_function.{n}``, as the
    reference does; ``load_jax_state`` and ``set_state_dict`` take those
    keys (whole tensors, cut into the parts).  ``recompute_interval`` and
    virtual stages are not ported (ROADMAP.md queue 1, item 9);
    ``topology``, ``seg_method`` ("uniform" only) and ``recompute_ctx``
    are accepted, as the reference takes them."""

    def __init__(self, layers, num_stages=None, topology=None, loss_fn=None,
                 seg_method="uniform", recompute_interval=0,
                 recompute_ctx=None, num_virtual_pipeline_stages=None):
        super().__init__()
        if recompute_interval:
            raise NotImplementedError(
                "PipelineLayer(recompute_interval > 0): fleet.recompute is "
                "not ported (ROADMAP.md queue 1, item 9)")
        if (num_virtual_pipeline_stages or 1) > 1:
            raise NotImplementedError(
                "PipelineLayer(num_virtual_pipeline_stages > 1): the "
                "interleaved fleet pipeline is not ported (ROADMAP.md "
                "queue 1, item 9; GPTStackedForPretraining's "
                "virtual_pp_degree is)")
        if seg_method != "uniform":
            raise ValueError(f"seg_method={seg_method!r}: the reference "
                             "segments uniformly")
        self._loss_fn = loss_fn
        self._num_stages = int(num_stages or 1)
        self._shared = {}
        built = []
        for d in layers:
            if isinstance(d, SharedLayerDesc):
                if d.layer_name in self._shared:
                    built.append(("shared", d.layer_name, d.forward_func))
                    continue
                layer = d.build_layer()
                self._shared[d.layer_name] = layer
                built.append(("layer", layer, d.forward_func))
            elif isinstance(d, LayerDesc):
                built.append(("layer", d.build_layer(), None))
            elif isinstance(d, nn.Module):
                built.append(("layer", d, None))
            elif callable(d):
                built.append(("fn", d, None))
            else:
                raise TypeError(f"bad pipeline item {d!r}")
        self._items = built
        self.run_function = nn.ModuleList(
            [item for kind, item, _ in built if kind == "layer"])
        n = len(built)
        per = int(np.ceil(n / self._num_stages))
        self.segment_bounds = [min(i * per, n)
                               for i in range(self._num_stages + 1)]
        self.segment_bounds[-1] = n
        self._roots = self._place()

    def _place(self):
        """Each stage's layers on its mesh position (none without a
        mesh); the first shard device of each stage, or None."""
        if not _mesh.has_mesh():
            return [None] * self._num_stages
        pp = _mesh.axis_size("pp")
        if pp > 1 and pp != self._num_stages:
            raise ValueError(f"num_stages={self._num_stages} on a mesh of "
                             f"pp={pp}")
        roots = []
        for s in range(self._num_stages):
            at = s if pp > 1 else 0
            devices = _mesh.stage_devices(at)
            for kind, item, _ in self.stage_items(s):
                if kind == "layer":
                    place_on_stage(item, at, devices)
            roots.append(devices[0])
        return roots

    def get_num_stages(self):
        return self._num_stages

    def stage_items(self, stage_id):
        lo, hi = (self.segment_bounds[stage_id],
                  self.segment_bounds[stage_id + 1])
        return self._items[lo:hi]

    def run_stage(self, stage_id, x):
        """Stage ``stage_id``'s segment on ``x``, moved first to the
        stage's first device."""
        root = self._roots[stage_id]
        if root is not None and isinstance(x, torch.Tensor):
            x = x.to(root)
        for kind, item, ffn in self.stage_items(stage_id):
            if kind == "shared":
                layer = self._shared[item]
                x = ffn(layer, x) if ffn else layer(x)
            elif kind == "fn":
                x = item(x)
            else:
                x = ffn(item, x) if ffn else item(x)
        return x

    def forward(self, x):
        for s in range(self._num_stages):
            x = self.run_stage(s, x)
        return x

    def loss(self, out, labels):
        """The loss of the last stage's output, the labels moved to the
        last stage's first device."""
        root = self._roots[-1]
        if root is not None:
            labels = labels.to(root)
        return self._loss_fn(out, labels)

    def load_state_dict(self, state_dict, strict: bool = True,
                        assign: bool = False):
        """``nn.Module.load_state_dict`` over whole tensors keyed
        ``run_function.{n}...`` (tensors or numpy arrays: the JAX
        ``PipelineLayer``'s ``state_dict()`` too), each cut into its
        parts (``shards.load_state``)."""
        return nn.modules.module._IncompatibleKeys(
            *load_state(self, state_dict, strict))

    # the reference's name, and the port's for a JAX model's weights
    set_state_dict = load_jax_state = load_state_dict


class PipelineParallel(nn.Module):
    """The 1F1B runtime over a :class:`PipelineLayer` (module docstring).
    ``strategy.pipeline_configs["accumulate_steps"]`` microbatches a
    ``train_batch`` (the batch must split evenly);
    ``last_peak_inflight`` is the most microbatches whose activations
    were live at once in the last one."""

    def __init__(self, layers, hcg=None, strategy=None):
        super().__init__()
        if not isinstance(layers, PipelineLayer):
            raise TypeError(f"PipelineParallel wraps a PipelineLayer, got "
                            f"{type(layers).__name__}")
        self._layers = layers
        self._hcg = hcg
        cfg = strategy.pipeline_configs if strategy is not None else {}
        self.accumulate_steps = int(cfg.get("accumulate_steps", 1))
        self.micro_batch_size = int(cfg.get("micro_batch_size", 1))
        self.last_peak_inflight = 0

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def _split_micro(self, data):
        inputs, labels = data
        n = self.accumulate_steps
        if inputs.shape[0] % n:
            raise ValueError(f"a batch of {inputs.shape[0]} rows does not "
                             f"split into accumulate_steps={n} microbatches")
        size = inputs.shape[0] // n
        return list(zip(inputs.split(size), labels.split(size)))

    def _forward_micro(self, x, y, inv, scaler):
        """One microbatch through every stage, detached at each stage
        boundary: per stage ``(input, output, None)``, the last stage's
        output being ``(input, loss to backpropagate, loss)``."""
        layers = self._layers
        stages = layers.get_num_stages()
        records = []
        h = x
        for s in range(stages):
            if s > 0:
                if not isinstance(h, torch.Tensor):
                    raise TypeError(f"stage {s - 1} hands on "
                                    f"{type(h).__name__}: a stage boundary "
                                    "takes one tensor")
                h = h.detach().requires_grad_(h.is_floating_point())
            out = layers.run_stage(s, h)
            if s == stages - 1:
                loss = layers.loss(out, y) * inv
                records.append((h, loss if scaler is None
                                else scaler.scale(loss), loss))
            else:
                records.append((h, out, None))
            h = out
        return records

    @staticmethod
    def _backward_micro(records):
        """One microbatch's backward, stage by stage from the last: each
        stage's input gradient seeds the stage before it; each stage's
        activations are released once it is done."""
        grad: Optional[torch.Tensor] = None
        for s in reversed(range(len(records))):
            h, out, _ = records[s]
            records[s] = None
            if s < len(records) - 1:
                if grad is None:
                    # nothing of the loss flows through this boundary
                    break
                torch.autograd.backward(out, grad.to(out.device))
            else:
                torch.autograd.backward(out)
            grad = h.grad if s > 0 else None

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        """One optimizer step over ``data`` = (inputs, labels) in 1F1B
        order; returns the sum of the microbatches' losses (each divided
        by their count), detached.  ``scaler``: the loss is scaled, and
        ``scaler.step(optimizer)`` unscales and steps; ``lr_scheduler`` is
        stepped after the optimizer."""
        if self._layers._loss_fn is None:
            raise ValueError("PipelineLayer needs loss_fn to train")
        micro = self._split_micro(data)
        stages = self._layers.get_num_stages()
        inv = 1.0 / len(micro)
        total = None
        inflight = {}
        peak = 0
        for j, (x, y) in enumerate(micro):
            records = self._forward_micro(x, y, inv, scaler)
            # the detached loss: a live one would keep every microbatch's
            # last-stage graph until the end of the batch
            lt = records[-1][2].detach()
            total = lt if total is None else total + lt.to(total.device)
            inflight[j] = records
            peak = max(peak, len(inflight))
            if j >= stages - 1:
                self._backward_micro(inflight.pop(j - (stages - 1)))
        for j in sorted(inflight):
            self._backward_micro(inflight.pop(j))
        self.last_peak_inflight = peak
        if scaler is not None:
            scaler.step(optimizer)
        else:
            optimizer.step()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return total

    @torch.no_grad()
    def eval_batch(self, data, compute_loss=True):
        """The mean over microbatches of the loss (or, with
        ``compute_loss=False``, of the outputs), without gradients."""
        micro = self._split_micro(data)
        total = None
        for x, y in micro:
            out = self._layers(x)
            if compute_loss:
                out = self._layers.loss(out, y)
            total = out if total is None else total + out.to(total.device)
        return total * (1.0 / len(micro))

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def load_state_dict(self, state_dict, strict: bool = True,
                        assign: bool = False):
        return self._layers.load_state_dict(state_dict, strict)

    set_state_dict = load_state_dict
