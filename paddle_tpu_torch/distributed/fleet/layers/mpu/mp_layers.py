"""Megatron's tensor-parallel layers, run by hand (port of
``paddle_tpu/distributed/fleet/layers/mpu/mp_layers.py``).

The reference declares each weight's partition over the mesh's ``mp``
axis and lets XLA insert the all-reduce and the gathers.  One process of
the port holds each cut weight as a ``shards.ShardedParameter`` -- one
part on each mp device of the layer's pipeline stage, no whole tensor
beside them -- and runs Megatron's forward itself:

- :class:`ColumnParallelLinear`: each shard's product over its columns
  of the input sent to its device; with ``gather_output=False`` the
  output stays a :class:`ShardedTensor`, one tensor a shard, which
  nothing gathers unless asked;
- :class:`RowParallelLinear`: each shard's partial product over its rows,
  the partials summed on the first shard's device in shard order
  (``serving_mesh.reduce_sum``), the bias (one whole part, on that
  device) added once;
- :class:`VocabParallelEmbedding`: each shard looks up the ids in its
  rows, zeros the others, and the parts are summed;
- :class:`ParallelCrossEntropy`: softmax cross entropy over logits cut by
  class (a :class:`ShardedTensor`), from the global row max and sum of
  exponentials (``nn.functional.sharded_softmax_losses``).

A layer is built on the shard devices of stage 0 of replica 0 of the
global mesh (``mesh.stage_devices``; without a mesh, one part on
``device``, the card by default); ``shards.place_on_stage`` moves it to
another stage.  ``state_dict()`` shows each whole tensor under the
reference's key.  The weights are allocated, not initialised: the model
that owns a layer draws them (``nn.layers.init_weights``), or loads
them.  ``weight_attr``, ``fuse_matmul_bias``, ``mp_group`` and ``name``
are accepted, as the reference takes them, and not read.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .....amp.auto_cast import maybe_cast
from .....core import canonical_device, resolve_device
from .....nn.functional import (
    cross_entropy, linear, promote, sharded_softmax_losses,
)
from .... import mesh as _mesh
from ....serving_mesh import broadcast, reduce_sum
from ....shards import Part, ShardedParameter

__all__ = ["ShardedTensor", "VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy",
           "vocab_parallel_lookup"]


class ShardedTensor:
    """A column-parallel value: ``parts[i]`` holds shard ``i``'s slice of
    the last axis, on shard ``i``'s device.  It is not a tensor: a
    row-parallel layer takes it as it is, :meth:`map` runs a function on
    each shard, and :meth:`gather` makes the whole tensor only when
    called."""

    __slots__ = ("parts",)

    def __init__(self, parts: Sequence[torch.Tensor]):
        self.parts = tuple(parts)

    @property
    def devices(self):
        return tuple(t.device for t in self.parts)

    def map(self, fn: Callable) -> "ShardedTensor":
        """``fn(part, i)`` on each shard ``i``."""
        return ShardedTensor(fn(t, i) for i, t in enumerate(self.parts))

    def gather(self, device=None) -> torch.Tensor:
        """The shards side by side on ``device`` (default: shard 0's)."""
        device = self.parts[0].device if device is None else device
        return torch.cat([t.to(device) for t in self.parts], -1)

    def __repr__(self):
        return (f"ShardedTensor({[tuple(t.shape) for t in self.parts]}, "
                f"devices={[str(d) for d in self.devices]})")


def _devices(device) -> tuple:
    """Where a new layer's parts go: stage 0's shard devices on the global
    mesh, else ``device`` (the card by default).  A ``device`` other than
    the mesh's first raises."""
    if not _mesh.has_mesh():
        return (resolve_device(device),)
    devs = _mesh.stage_devices(0)
    if device is not None and canonical_device(device) != devs[0]:
        raise ValueError(f"device={device}: a layer built under a mesh "
                         f"lives on the mesh's devices, first {devs[0]}")
    return devs


def _contiguous(i: int, mp: int, n: int) -> torch.Tensor:
    """Shard ``i``'s indices of ``n`` cut into ``mp`` contiguous runs."""
    if n % mp:
        raise ValueError(f"{n} is not divisible by mp={mp}")
    k = n // mp
    return torch.arange(i * k, (i + 1) * k)


def _cut(shape, dtype, devices, dim: int, index: Callable[[int], torch.Tensor]
         ) -> ShardedParameter:
    """A :class:`ShardedParameter` of ``shape`` with shard ``i``'s part at
    ``index(i)`` along ``dim`` on ``devices[i]`` (the whole at mp = 1)."""
    mp = len(devices)
    return ShardedParameter(shape, dtype, [
        Part((0, 0, i), d, ((dim, index(i)),) if mp > 1 else ())
        for i, d in enumerate(devices)])


class VocabParallelEmbedding(nn.Module):
    """The ``[num_embeddings, embedding_dim]`` table cut by rows (the
    vocabulary) over mp."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, *, device=None, dtype=None):
        super().__init__()
        devs = _devices(device)
        self.weight = _cut((num_embeddings, embedding_dim), dtype, devs, 0,
                           lambda i: _contiguous(i, len(devs),
                                                 num_embeddings))

    def forward(self, x):
        return vocab_parallel_lookup(x, list(self.weight),
                                     self.weight.parts[0].device)


def vocab_parallel_lookup(ids, tables: Sequence[torch.Tensor], root):
    """The embeddings of ``ids`` from a table cut by rows: ``tables[i]``
    holds rows ``[o_i, o_i + V_i)`` (in shard order) on its device; each
    shard looks up the ids in its rows and zeros the others, and the
    parts are summed on ``root`` in shard order."""
    parts, off = [], 0
    for w in tables:
        loc = ids.to(w.device) - off
        ok = (loc >= 0) & (loc < w.shape[0])
        e = F.embedding(torch.where(ok, loc, 0), w)
        parts.append(torch.where(ok[..., None], e, 0.0))
        off += w.shape[0]
    return reduce_sum(parts, (root,))[root]


class ColumnParallelLinear(nn.Module):
    """``x @ weight + bias``, ``weight`` ``[in, out]`` cut by columns
    over mp (``bias`` with it).  ``gather_output=True`` returns the whole
    output on shard 0's device; False, a :class:`ShardedTensor`.

    ``columns`` (the port's, keyword only): ``columns(i, mp)``, the
    columns of shard ``i``, for a layer whose output is laid out so that
    a contiguous cut would split the wrong way (the fused QKV
    projection's ``[3, heads, head_dim]``: shard ``i`` takes the q, k and
    v columns of its heads); default the contiguous cut.  The state dict
    keeps the reference's layout either way."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=None, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, *, device=None, dtype=None,
                 columns: Optional[Callable[[int, int], torch.Tensor]] = None
                 ):
        super().__init__()
        devs = _devices(device)
        mp = len(devs)
        columns = columns or (lambda i, n: _contiguous(i, n, out_features))
        self._columns = [columns(i, mp) for i in range(mp)]
        self.gather_output = gather_output
        self.weight = _cut((in_features, out_features), dtype, devs, 1,
                           self._columns.__getitem__)
        self.bias = (_cut((out_features,), dtype, devs, 0,
                          self._columns.__getitem__)
                     if has_bias is None or has_bias else None)

    @property
    def devices(self):
        return tuple(p.device for p in self.weight.parts)

    def forward(self, x):
        devs = self.devices
        xs = broadcast(x, devs)
        out = ShardedTensor(
            linear(xs[d], w, None if self.bias is None else self.bias[i])
            for i, (d, w) in enumerate(zip(devs, self.weight)))
        if not self.gather_output:
            return out
        whole = out.gather()
        order = torch.cat(self._columns)
        if torch.equal(order, torch.arange(len(order))):
            return whole
        return whole[..., torch.argsort(order).to(whole.device)]


class RowParallelLinear(nn.Module):
    """``x @ weight + bias``, ``weight`` ``[in, out]`` cut by rows over
    mp, ``bias`` whole on shard 0's device.  ``input_is_parallel=True``
    takes the :class:`ShardedTensor` a ``ColumnParallelLinear(...,
    gather_output=False)`` gives; False, the whole input, cut here."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None, *,
                 device=None, dtype=None):
        super().__init__()
        devs = _devices(device)
        self.input_is_parallel = input_is_parallel
        self.weight = _cut((in_features, out_features), dtype, devs, 0,
                           lambda i: _contiguous(i, len(devs), in_features))
        # one part, whole, on shard 0's device: after the weight in the
        # parameters and the state dict, as the reference orders them
        self.bias = (_cut((out_features,), dtype, devs[:1], 0, None)
                     if has_bias else None)

    @property
    def devices(self):
        return tuple(p.device for p in self.weight.parts)

    def forward(self, x):
        devs = self.devices
        if self.input_is_parallel:
            if not isinstance(x, ShardedTensor) or len(x.parts) != len(devs):
                raise TypeError(
                    f"RowParallelLinear(input_is_parallel=True) takes a "
                    f"ShardedTensor of {len(devs)} shards, got {x!r}")
            xs = x.parts
        else:
            n = x.shape[-1] // len(devs)
            xs = [x[..., i * n:(i + 1) * n] for i in range(len(devs))]
        partials = [linear(xi.to(d), w)
                    for xi, d, w in zip(xs, devs, self.weight)]
        out = reduce_sum(partials, (devs[0],))[devs[0]]
        if self.bias is None:
            return out
        out, bias = promote(*maybe_cast("linear", out, self.bias[0]))
        return out + bias


class ParallelCrossEntropy(nn.Module):
    """Per-token softmax cross entropy (``reduction="none"``): over a
    :class:`ShardedTensor` of logits cut by class, from the global row max
    and sum of exponentials, each token's loss computed in fp32 and given
    the logits' dtype, as ``cross_entropy`` gives it; over a whole tensor,
    ``cross_entropy``.  A label equal to ``ignore_index`` gives 0."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index

    def forward(self, input, label):  # noqa: A002
        if not isinstance(input, ShardedTensor):
            return cross_entropy(input, label, reduction="none",
                                 ignore_index=self.ignore_index)
        zs = maybe_cast("cross_entropy", *input.parts)
        dtype = zs[0].dtype
        devs = input.devices
        lab = label.long().reshape(-1).to(devs[0])
        valid = lab != self.ignore_index
        losses = sharded_softmax_losses(
            [z.reshape(-1, z.shape[-1]).float() for z in zs],
            torch.where(valid, lab, 0), devs, devs[0]).to(dtype)
        return torch.where(valid, losses, 0.0).reshape(label.shape)
