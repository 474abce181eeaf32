"""Semi-auto parallel annotation API (port of
``paddle_tpu/distributed/auto_parallel/api.py``; reference: Paddle's
``auto_parallel/interface.py:28`` ``shard_tensor`` and ``:117``
``shard_op``).

A placement list names, for each mesh dimension, how the tensor lies
along it: ``Shard(d)`` cuts tensor dimension ``d`` over it, ``Replicate()``
and ``Partial()`` copy the tensor (a pending sum is a state of the
propagation pass, not of a placed value, as in the reference).  The
port's placed value is a :class:`~paddle_tpu_torch.distributed.mesh.
PlacedTensor`: each distinct block once on each device of the positions
that hold it, under a :class:`~paddle_tpu_torch.distributed.mesh.
NamedSharding` whose entries may be tuples of axes (two mesh dimensions
cutting one tensor dimension, the first major).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..mesh import NamedSharding, PlacedTensor
from .process_mesh import ProcessMesh

__all__ = ["Placement", "Replicate", "Shard", "Partial", "shard_tensor",
           "dtensor_from_fn", "reshard", "shard_op"]


class Placement:
    pass


class Replicate(Placement):
    def __repr__(self):
        return "Replicate()"


class Shard(Placement):
    def __init__(self, dim):
        self.dim = dim

    def __repr__(self):
        return f"Shard(dim={self.dim})"


class Partial(Placement):
    def __repr__(self):
        return "Partial()"


def _to_partition_spec(mesh: ProcessMesh, placements) -> tuple:
    """The :class:`NamedSharding` spec of ``placements`` (``placements[i]``
    describes how mesh dimension ``i`` maps onto tensor dimensions): one
    entry a tensor dimension up to the last one cut, each a tuple of the
    mesh axes that cut it, in mesh order (empty: whole).  ``Partial``
    replicates, as in the reference."""
    if placements is None:
        return ()
    entries = {}
    for mesh_dim, pl in enumerate(placements):
        if isinstance(pl, Shard):
            entries.setdefault(pl.dim, []).append(mesh.dim_names[mesh_dim])
    if not entries:
        return ()
    return tuple(tuple(entries.get(d, ())) for d in range(max(entries) + 1))


def _place(t: torch.Tensor, sharding: NamedSharding) -> PlacedTensor:
    """``t`` cut by ``sharding``: a copy of each distinct (block, device)
    pair of the mesh's positions.  A dimension the spec's axes do not
    divide raises ``ValueError`` (``NamedSharding.cuts``)."""
    cuts = sharding.cuts(t.shape)
    blocks = {}
    for coords, device in sharding.positions():
        idx = sharding.block_of(coords)
        if (idx, device) not in blocks:
            part = t
            for k, (i, n) in enumerate(zip(idx, cuts)):
                size = t.shape[k] // n
                part = part.narrow(k, i * size, size)
            blocks[(idx, device)] = part.to(
                device=device, copy=True,
                memory_format=torch.contiguous_format)
    return PlacedTensor(sharding, t.shape, t.dtype, blocks)


def _whole(x) -> torch.Tensor:
    if isinstance(x, PlacedTensor):
        return x.gather()
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x)
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def _annotate(placed: PlacedTensor, mesh: ProcessMesh, spec, placements,
              stop_gradient):
    placed.process_mesh = mesh
    placed.dist_spec = spec
    placed.placements = list(placements) if placements is not None else None
    if stop_gradient is False:
        for b in placed.blocks.values():
            b.requires_grad_()
    return placed


def shard_tensor(x, mesh: ProcessMesh, placements=None, dist_attr=None,
                 stop_gradient: Optional[bool] = None) -> PlacedTensor:
    """``x`` placed on ``mesh`` by ``placements`` (reference
    ``interface.py:28``), as a :class:`PlacedTensor` that carries
    ``process_mesh``, its spec (``dist_spec``) and ``placements``.

    The reference re-commits its ``Tensor`` to the sharded layout in
    place; a ``torch.Tensor`` cannot change its layout in place, so the
    port returns the placed value and leaves ``x`` as it was.  A spec
    whose axes do not divide a dimension raises ``ValueError``.  The
    blocks are copies, detached; ``stop_gradient=False`` makes them
    leaves that take gradients."""
    spec = _to_partition_spec(mesh, placements)
    placed = _place(_whole(x).detach(), NamedSharding(mesh.mesh, spec))
    return _annotate(placed, mesh, spec, placements, stop_gradient)


def dtensor_from_fn(fn, mesh: ProcessMesh, placements, *args, **kwargs):
    """``fn(*args, **kwargs)`` placed by :func:`shard_tensor`."""
    return shard_tensor(fn(*args, **kwargs), mesh, placements)


def reshard(x, mesh: ProcessMesh, placements) -> PlacedTensor:
    """An explicit relayout (reference ``reshard.py:2772``, the
    Resharder): the whole tensor (a placed one gathered), cut again on
    ``mesh`` by ``placements``."""
    return shard_tensor(x, mesh, placements)


def shard_op(op_fn, mesh: ProcessMesh = None, in_specs=None,
             out_specs=None, **kw):
    """``op_fn`` whose outputs are placed on ``mesh`` by ``out_specs``
    (reference ``interface.py:117``): one spec an output, each a tuple of
    mesh axis names (or tuples of them, or None) per tensor dimension.
    Without ``out_specs`` or ``mesh`` the outputs are returned as they
    are.  ``in_specs`` is accepted, as the reference accepts it."""

    def place(o, spec):
        placed = _place(_whole(o), NamedSharding(mesh.mesh, tuple(spec or ())))
        return _annotate(placed, mesh, placed.sharding.spec, None, None)

    def wrapper(*args, **kwargs):
        out = op_fn(*args, **kwargs)
        if out_specs is None or mesh is None:
            return out
        if isinstance(out, (list, tuple)):
            return type(out)(place(o, s) for o, s in zip(out, out_specs))
        return place(out, out_specs)

    return wrapper
