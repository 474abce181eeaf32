"""Pipeline parallelism through the fleet API (port of
``paddle_tpu/distributed/fleet/meta_parallel/pipeline_parallel.py``).

``PipelineLayer`` builds a list of layers (``LayerDesc``s, built
modules, ``SharedLayerDesc``s or plain callables), cuts it into
``num_stages x num_virtual_pipeline_stages`` chunks by a uniform rule
(``segment_bounds``), chunk ``c`` on stage ``c mod num_stages``, and,
under a global mesh, places each chunk's layers on that stage's position
of replica 0: the shard devices ``mesh.stage_devices(s)``
(``shards.place_on_stage``).  A chunk runs on its first shard device;
its input is moved there.  With ``recompute_interval`` k, each run of k
items of a chunk that holds parameters runs under ``fleet.recompute``
(as Paddle's ``PipelineLayer`` does; the JAX ``PipelineLayer`` takes the
knob and does not read it, which gives the same losses and gradients).

On a mesh with dp x sharding > 1 (the data replicas,
``mesh.replica_count``) the layer holds a copy of every chunk for each
further replica (``shards.replicate``) on positions ``(r, stage, i)``;
``state_dict()`` shows replica 0's, every copy is among
``parameters()`` (an optimizer steps each), and a batch's rows split
over the replicas, each running on its copies tied across replicas
(``shards.tie_slots``), so every copy applies the sum of the replicas'
gradients.

``PipelineParallel.train_batch`` runs Paddle's 1F1B order over
``accumulate_steps`` microbatches -- with virtual stages, its interleaved
order (``schedule``) over (microbatch, round) units, a round being one
trip through the stages (chunks ``v S .. v S + S - 1``): warm-up
forwards fill the pipe, then each new forward is followed by the
backward of the oldest unit in flight, then the rest drain.  A forward
is detached at each chunk boundary; a backward runs chunk by chunk from
the last, each chunk's input gradient seeding the backward of the chunk
before it (what the reference's p2p send of activation gradients
carries).  One process drives every stage in order on its devices, so
stages do not overlap in time: the order bounds the activations in
flight (``last_peak_inflight``), as 1F1B does.
"""
from __future__ import annotations

from contextlib import ExitStack
from functools import partial
from typing import List

import numpy as np
import torch
from torch import nn

from ... import mesh as _mesh
from ...shards import (
    Bound, load_state, param_slots, place_on_stage, replicate, tie_slots,
)
from ..recompute.recompute import recompute

__all__ = ["LayerDesc", "SharedLayerDesc", "PipelineLayer",
           "PipelineParallel", "schedule"]


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




def schedule(n_micro: int, stages: int, virtual: int = 1):
    """Paddle's 1F1B order over ``n_micro`` microbatches of ``stages``
    stages, each run in ``virtual`` rounds, as its first stage runs it:
    a list of ``("F" or "B", microbatch, round)``.  Warm-up forwards:
    ``stages - 1`` (plain 1F1B) or, interleaved, ``2 (stages - 1) +
    (virtual - 1) stages`` (every forward when ``n_micro == stages``);
    unit ``k`` of each kind is microbatch ``(k // (S V)) S + k % S`` in
    round ``(k % (S V)) // S``, the backwards' rounds reversed."""
    S, V = stages, virtual
    n = n_micro * V
    if V == 1:
        warm = min(S - 1, n)
    else:
        if n_micro % S:
            raise ValueError(f"accumulate_steps={n_micro} is not divisible "
                             f"by the {S} stages: the interleaved pipeline "
                             "needs whole groups of microbatches")
        warm = n if n_micro == S else min(2 * (S - 1) + (V - 1) * S, n)

    def unit(k, forward):
        v = (k % (S * V)) // S
        return (k // (S * V)) * S + k % S, v if forward else V - 1 - v

    order = [("F",) + unit(k, True) for k in range(warm)]
    for i in range(n - warm):
        order += [("F",) + unit(warm + i, True), ("B",) + unit(i, False)]
    order += [("B",) + unit(i, False) for i in range(n - warm, n)]
    return order


def _segments(n: int, stages: int, virtual: int) -> List[int]:
    """The chunk bounds of ``n`` items: without virtual stages the JAX
    ``PipelineLayer``'s rule (``ceil(n / stages)`` items a stage); with
    them Paddle's uniform rule over ``stages x virtual`` chunks (``n //
    chunks`` items each, the last ``n % chunks`` one more), which the
    JAX package, reading no virtual stages, does not have."""
    if virtual == 1:
        per = int(np.ceil(n / stages))
        return [min(i * per, n) for i in range(stages)] + [n]
    chunks = stages * virtual
    if n < chunks:
        raise ValueError(f"{n} pipeline items do not fill {chunks} chunks "
                         f"({stages} stages x {virtual} virtual)")
    per, extra = divmod(n, chunks)
    bounds = [0]
    for i in range(1, chunks):
        bounds.append(bounds[-1] + per + (1 if i > chunks - extra else 0))
    return bounds + [n]


class PipelineLayer(nn.Module):
    """The layers of a pipeline, their chunks and their replicas (module
    docstring).  ``state_dict()`` keys each built layer
    ``run_function.{n}``, as the reference does; ``load_jax_state`` and
    ``set_state_dict`` take those keys (whole tensors, cut into the parts
    and copied to every replica).  ``topology``, ``seg_method``
    ("uniform" only) and ``recompute_ctx`` are accepted, as the reference
    takes them."""

    def __init__(self, layers, num_stages=None, topology=None, loss_fn=None,
                 seg_method="uniform", recompute_interval=0,
                 recompute_ctx=None, num_virtual_pipeline_stages=None):
        super().__init__()
        if seg_method != "uniform":
            raise ValueError(f"seg_method={seg_method!r}: the reference "
                             "segments uniformly")
        self._loss_fn = loss_fn
        self._num_stages = int(num_stages or 1)
        self._num_virtual = int(num_virtual_pipeline_stages or 1)
        self._recompute_interval = int(recompute_interval or 0)
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
        self.segment_bounds = _segments(len(built), self._num_stages,
                                        self._num_virtual)
        self._replicas = nn.ModuleList()
        # per replica: its items, and its copy of each shared layer
        self._replica_items = [built]
        self._replica_shared = [self._shared]
        self._roots = self._place()

    def _place(self):
        """Each chunk's layers on its stage's mesh position (none without
        a mesh), and at dp x sharding > 1 a placed copy for each further
        replica; per replica, the first shard device of each chunk, or
        None."""
        chunks = self.num_chunks
        if not _mesh.has_mesh():
            return [[None] * chunks]
        pp = _mesh.axis_size("pp")
        if pp > 1 and pp != self._num_stages:
            raise ValueError(f"num_stages={self._num_stages} on a mesh of "
                             f"pp={pp}")
        dp = _mesh.replica_count()
        stage = [self.chunk_stage(c) if pp > 1 else 0 for c in range(chunks)]
        for r in range(1, dp):
            copies = replicate(self.run_function)
            self._replicas.append(copies)
            of = {id(m): c for m, c in zip(self.run_function, copies)}
            self._replica_items.append([
                (kind, of[id(item)] if kind == "layer" else item, ffn)
                for kind, item, ffn in self._items])
            self._replica_shared.append(
                {key: of[id(m)] for key, m in self._shared.items()})
        roots = []
        for r in range(dp):
            roots.append([])
            for c in range(chunks):
                devices = _mesh.stage_devices(stage[c], r)
                for kind, item, _ in self.chunk_items(c, r):
                    if kind == "layer":
                        place_on_stage(item, stage[c], devices, r)
                roots[r].append(devices[0])
        return roots

    @property
    def num_chunks(self) -> int:
        return len(self.segment_bounds) - 1

    @property
    def num_replicas(self) -> int:
        return len(self._replica_items)

    def get_num_stages(self):
        return self._num_stages

    def get_num_virtual_stages(self):
        return self._num_virtual

    def chunk_stage(self, c: int) -> int:
        return c % self._num_stages

    def chunk_items(self, c: int, replica: int = 0):
        lo, hi = self.segment_bounds[c], self.segment_bounds[c + 1]
        return self._replica_items[replica][lo:hi]

    def stage_items(self, stage_id):
        """The items of stage ``stage_id``'s chunks, in chunk order."""
        return [it for c in range(stage_id, self.num_chunks,
                                  self._num_stages)
                for it in self.chunk_items(c)]

    def _layer(self, kind, item, replica):
        """The module an item runs (a shared layer's key looked up in
        ``replica``'s copies), or None for a plain callable."""
        if kind == "fn":
            return None
        return self._replica_shared[replica][item] if kind == "shared" \
            else item

    def _run_items(self, items, x, replica=0):
        for kind, item, ffn in items:
            layer = self._layer(kind, item, replica)
            if layer is None:
                x = item(x)
            else:
                x = ffn(layer, x) if ffn else layer(x)
        return x

    def run_chunk(self, c: int, x, replica: int = 0):
        """Chunk ``c`` of replica ``replica`` on ``x``, moved first to the
        chunk's first device; with ``recompute_interval`` k, each run of k
        items holding parameters under ``fleet.recompute`` when ``x``
        needs a gradient."""
        root = self._roots[replica][c]
        if root is not None and isinstance(x, torch.Tensor):
            x = x.to(root)
        items = self.chunk_items(c, replica)
        k = self._recompute_interval
        if not k:
            return self._run_items(items, x, replica)
        for lo in range(0, len(items), k):
            # shared keys resolved: the group names the modules it runs
            group = []
            for kind, item, ffn in items[lo:lo + k]:
                layer = self._layer(kind, item, replica)
                group.append((kind, item, ffn) if layer is None
                             else ("layer", layer, ffn))
            held = any(next(item.parameters(), None) is not None
                       for kind, item, _ in group if kind == "layer")
            if held and isinstance(x, torch.Tensor) and x.requires_grad:
                x = recompute(partial(self._run_items, group,
                                      replica=replica), x)
            else:
                x = self._run_items(group, x, replica)
        return x

    def forward(self, x):
        for c in range(self.num_chunks):
            x = self.run_chunk(c, x)
        return x

    def loss(self, out, labels, replica: int = 0):
        """The loss of the last chunk's output, the labels moved to the
        last chunk's first device of ``replica``."""
        root = self._roots[replica][-1]
        if root is not None:
            labels = labels.to(root)
        return self._loss_fn(out, labels)

    def replica_bindings(self) -> List[Bound]:
        """One :class:`~paddle_tpu_torch.distributed.shards.Bound` a
        replica: its parameter slots filled with its copies tied across
        the replicas (``shards.tie_slots``)."""
        slots = [param_slots([self.run_function])] + [
            param_slots([c]) for c in self._replicas]
        return [Bound(s, v) for s, v in zip(slots, tie_slots(slots))]

    def state_dict(self, *args, destination=None, prefix="",
                   keep_vars=False):
        """Replica 0's tensors (the copies are left out)."""
        out = super().state_dict(*args, destination=destination,
                                 prefix=prefix, keep_vars=keep_vars)
        for k in [k for k in out if k.startswith(prefix + "_replicas.")]:
            del out[k]
        return out

    def load_state_dict(self, state_dict, strict: bool = True,
                        assign: bool = False):
        """``nn.Module.load_state_dict`` over whole tensors keyed
        ``run_function.{n}...`` (tensors or numpy arrays: the JAX
        ``PipelineLayer``'s ``state_dict()`` too), each cut into its
        parts and copied to every replica (``shards.load_state``)."""
        return nn.modules.module._IncompatibleKeys(
            *load_state(self, state_dict, strict))

    # the reference's name, and the port's for a JAX model's weights
    set_state_dict = load_jax_state = load_state_dict


class PipelineParallel(nn.Module):
    """The 1F1B runtime over a :class:`PipelineLayer` (module docstring).
    ``strategy.pipeline_configs["accumulate_steps"]`` microbatches a
    ``train_batch``; with dp x sharding > 1 replicas each microbatch's
    rows split evenly over them (a batch that does not split into
    replicas x accumulate_steps equal parts raises).  ``last_peak_inflight`` is the most units
    (microbatch, round) whose activations were live at once in the last
    one: microbatches without virtual stages."""

    def __init__(self, layers, hcg=None, strategy=None):
        super().__init__()
        if not isinstance(layers, PipelineLayer):
            raise TypeError(f"PipelineParallel wraps a PipelineLayer, got "
                            f"{type(layers).__name__}")
        dp = (hcg.get_data_parallel_world_size()
              * hcg.get_sharding_parallel_world_size()
              if hcg is not None else layers.num_replicas)
        if dp != layers.num_replicas:
            raise ValueError(f"the PipelineLayer holds {layers.num_replicas} "
                             f"replicas, the topology asks dp x sharding = "
                             f"{dp}: build it under the mesh fleet.init "
                             "holds")
        self._layers = layers
        self._hcg = hcg
        cfg = strategy.pipeline_configs if strategy is not None else {}
        self.accumulate_steps = int(cfg.get("accumulate_steps", 1))
        self.micro_batch_size = int(cfg.get("micro_batch_size", 1))
        self.last_peak_inflight = 0

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def _split_micro(self, data, replicas=1):
        inputs, labels = data
        n = self.accumulate_steps * replicas
        if inputs.shape[0] % n:
            raise ValueError(
                f"a batch of {inputs.shape[0]} rows does not split into "
                f"accumulate_steps={self.accumulate_steps} microbatches"
                + (f" over dp={replicas} replicas" if replicas > 1 else ""))
        size = inputs.shape[0] // self.accumulate_steps
        return list(zip(inputs.split(size), labels.split(size)))

    def _forward_unit(self, r, x, y, v, carry, scale, scaler):
        """Round ``v`` of replica ``r``'s rows of a microbatch, detached at
        each chunk boundary: per chunk ``(input, output, None)``, the last
        chunk's ``(input, loss to backpropagate, loss)``.  ``carry``: the
        previous round's output."""
        layers = self._layers
        S, last = layers.get_num_stages(), layers.num_chunks - 1
        records = []
        h = x if v == 0 else carry
        for c in range(v * S, v * S + S):
            if c > 0:
                if not isinstance(h, torch.Tensor):
                    raise TypeError(f"chunk {c - 1} hands on "
                                    f"{type(h).__name__}: a chunk boundary "
                                    "takes one tensor")
                h = h.detach().requires_grad_(h.is_floating_point())
            out = layers.run_chunk(c, h, r)
            if c == last:
                loss = layers.loss(out, y, r) * scale
                records.append((h, loss if scaler is None
                                else scaler.scale(loss), loss))
            else:
                records.append((h, out, None))
            h = out
        return records

    @staticmethod
    def _backward_unit(units, grads):
        """One round's backward over every replica together, chunk by
        chunk from the last: each chunk's input gradients seed the chunk
        before it; each chunk's activations are released once it is done.
        ``grads``: per replica, the gradient of the round's output (None
        for the last round, which ends in the loss); returns the round
        input's gradients."""
        for i in reversed(range(len(units[0]))):
            ins, outs, seeds = [], [], []
            for r, records in enumerate(units):
                h, out, _ = records[i]
                records[i] = None
                ins.append(h)
                if grads is None:
                    outs.append(out)
                elif grads[r] is not None:
                    outs.append(out)
                    seeds.append(grads[r].to(out.device))
            # none where nothing of the loss flows through the boundary
            if outs:
                torch.autograd.backward(outs, seeds if grads is not None
                                        else None)
            grads = [h.grad if isinstance(h, torch.Tensor)
                     and h.requires_grad else None for h in ins]
        return grads

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        """One optimizer step over ``data`` = (inputs, labels) in
        :func:`schedule`'s order; returns the sum of the microbatches'
        losses (each divided by their count), detached: the reference's
        loss.  With R = dp x sharding replicas each replica's loss is the
        mean over its rows divided by R, so the replicas' gradients sum to
        the gradient of the microbatch's mean.  ``scaler``: the loss is scaled, and
        ``scaler.step(optimizer)`` unscales and steps; ``lr_scheduler`` is
        stepped after the optimizer."""
        layers = self._layers
        if layers._loss_fn is None:
            raise ValueError("PipelineLayer needs loss_fn to train")
        dp = layers.num_replicas
        micro = [(x.split(x.shape[0] // dp), y.split(y.shape[0] // dp))
                 for x, y in self._split_micro(data, dp)]
        scale = 1.0 / len(micro) / dp
        total = None
        records, carry, grads = {}, {}, {}
        peak = 0
        with ExitStack() as stack:
            if dp > 1:
                for b in layers.replica_bindings():
                    stack.enter_context(b)
            for op, j, v in schedule(len(micro), layers.get_num_stages(),
                                     layers.get_num_virtual_stages()):
                if op == "F":
                    units = []
                    for r in range(dp):
                        units.append(self._forward_unit(
                            r, micro[j][0][r], micro[j][1][r], v,
                            carry.get((j, r)), scale, scaler))
                        carry[(j, r)] = units[-1][-1][1]
                        lt = units[-1][-1][2]
                        if lt is not None:
                            # the detached loss: a live one would keep the
                            # last chunk's graph until the end of the batch
                            lt = lt.detach()
                            total = lt if total is None else \
                                total + lt.to(total.device)
                    records[(j, v)] = units
                    peak = max(peak, len(records))
                else:
                    grads[j] = self._backward_unit(records.pop((j, v)),
                                                   grads.get(j))
            carry.clear()
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
        ``compute_loss=False``, of the outputs), without gradients, on
        replica 0."""
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
