"""A planned model's tensors held as blocks at mesh positions (the
placement the JAX Engine's ``plan()`` gives its parameters through
``NamedSharding``s, ``paddle_tpu/distributed/auto_parallel/engine.py``).

:func:`place_model` turns every parameter and buffer of a model into a
``shards.ShardedParameter`` with one part a mesh position: the block
the position holds under the tensor's ``DistSpec`` (a whole copy where
it has none), on the position's device, at position ``(dp, pp, mp)``.
Each position holds its own block, so four positions on one card hold
what four cards would.  The parts that hold the same block point at
the first of them (``replica_of``), so a state dict, the clip and the
optimizer's state dict count each element once.  The model keeps its
parameters as shapes without storage (``untyped_storage().resize_(0)``)
until :meth:`PlacedModel.unplace` gives them their whole values back.

The executor reads a tensor through :meth:`PlacedModel.inputs`: one
``HeldBlocks`` a tensor, whose ``bind()`` ties the parts of each block
(``shards.tie_replicas``: in the backward every part receives the sum
of all their gradients, in position order -- the dp replicas' batch
shares, the mp positions' partial sums of a tensor they all hold, and
nothing from a copy whose output no loss reads, as a pp copy's), so
the gradients land summed on every part.  Under ZeRO
(``sharding.group_sharded_parallel`` over the placed model, which builds
its layout from the parts: ``_build_block_plan``) the ties land them in
the slices instead, and at ``p_g_os`` ``bind()`` gathers each part from
its slices, ``release()`` frees it after the graph's last read, and
``again()`` gathers it again for the backward.

:func:`repoint_optimizer` moves an optimizer from the whole parameters
to the parts in place: each parameter's place in its group goes to its
parts, its state is cut the same way, its name (the decay mask's key)
goes with it, and each part carries ``placed_from``, the whole
parameter, which ``lr_ratio`` is called with.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from .. import mesh as _mesh
from ..shards import (
    Part, ShardedParameter, _optimizer_chain, cut, load_state,
    logical_owner, logical_value, state_bytes_by_position, tie_replicas,
)
from .propagation import DistSpec, HeldBlocks, _ax

__all__ = ["PlacedModel", "place_model", "repoint_optimizer",
           "state_dict_hooks", "position_of_coords"]


def position_of_coords(mesh: _mesh.Mesh, coords) -> tuple:
    """The ``(dp, pp, mp)`` position of mesh coordinates ``coords`` (an
    axis the mesh lacks at 0)."""
    at = dict(zip(mesh.axis_names, coords))
    return tuple(int(at.get(a, 0)) for a in ("dp", "pp", "mp"))


def _region(index, cuts, shape):
    """Block ``index`` of a tensor of ``shape`` cut ``cuts`` ways along
    each dimension, as a ``shards`` region."""
    out = []
    for k, (i, n) in enumerate(zip(index, cuts)):
        if n > 1:
            size = shape[k] // n
            out.append((k, torch.arange(i * size, (i + 1) * size)))
    return tuple(out)


def _attach(root: nn.Module, name: str, module: nn.Module):
    """``module`` at dotted ``name`` under ``root`` (plain modules made
    for the prefixes), so ``root.state_dict()`` keys it by ``name``."""
    *path, leaf = name.split(".")
    m = root
    for p in path:
        if p not in m._modules:
            m.add_module(p, nn.Module())
        m = m._modules[p]
    m.add_module(leaf, module)


class _Entry:
    __slots__ = ("name", "tensor", "blocks", "sharding", "groups",
                 "buffer")

    def __init__(self, name, tensor, blocks, sharding, groups, buffer):
        self.name, self.tensor, self.blocks = name, tensor, blocks
        self.sharding, self.groups, self.buffer = sharding, groups, buffer


class PlacedModel(nn.Module):
    """The blocks of a placed model (module docstring): ``entries[name]``
    the ``ShardedParameter`` of each tensor, keyed in ``state_dict()`` by
    the model's own names; ``_position_blocks`` tells
    ``group_sharded_parallel`` how its parts lie."""

    _position_blocks = True

    def __init__(self, mesh: _mesh.Mesh):
        super().__init__()
        self.mesh = mesh
        self.coords = list(np.ndindex(*mesh.devices.shape))
        self.entries: Dict[str, _Entry] = {}

    # -- the executor's side -------------------------------------------
    def inputs(self, names) -> List[HeldBlocks]:
        """One ``HeldBlocks`` a tensor of ``names`` (module docstring)."""
        return [self._held(self.entries[k]) for k in names]

    def _held(self, e: _Entry) -> HeldBlocks:
        parts = list(e.blocks)
        zero = [getattr(t, "zero", None) for t in parts]
        zero = [z for z in zero if z is not None]

        def bind():
            for rec, r in zero:
                rec.acquire(r)
            held = list(parts)
            if torch.is_grad_enabled() and not e.buffer:
                for idx in e.groups:
                    tied = tie_replicas([held[i] for i in idx])
                    for i, t in zip(idx, tied):
                        held[i] = t
            return dict(zip(self.coords, held))

        def release():
            for rec, r in zero:
                rec.release(r)

        def again():
            for rec, r in zero:
                rec.acquire(r, backward=True)

        stored = any(rec.stored_as_slices for rec, _ in zero)
        return HeldBlocks(e.sharding, e.tensor.shape, e.tensor.dtype,
                          dict(zip(self.coords, parts)), bind=bind,
                          release=release if stored else None,
                          again=again if stored else None)

    # -- bytes ---------------------------------------------------------
    def state_bytes(self, optimizer) -> dict:
        """``shards.state_bytes_by_position`` of the blocks and
        ``optimizer``: ``{(dp, pp, mp): {"params", "grads", "state"}}``."""
        return state_bytes_by_position(self, optimizer)

    def whole_copies(self) -> list:
        """The names whose model tensor still holds storage while its
        spec cuts it (none, once placed)."""
        return [k for k, e in self.entries.items()
                if e.tensor.untyped_storage().nbytes() and
                any(n > 1 for n in e.sharding.cuts(e.tensor.shape))]

    # -- the way back --------------------------------------------------
    @torch.no_grad()
    def unplace(self, optimizer=None):
        """The model's tensors whole again (their values gathered from
        the blocks), ``optimizer`` moved back to them with its state
        gathered whole, and the blocks freed."""
        if optimizer is not None:
            _repoint_back(optimizer, self)
        values = self.state_dict()
        plan = getattr(self, "_zero_plan", None)
        for h in (plan.hooks if plan is not None else ()):
            h.remove()
        for k, e in self.entries.items():
            t = e.tensor
            t.untyped_storage().resize_(t.numel() * t.element_size())
            t.copy_(values.pop(k).to(t.device))
            for part in e.blocks:
                part.data = torch.empty(0, dtype=part.dtype,
                                        device=part.device)
                part.grad = None
        for rec in (plan.pieces if plan is not None else ()):
            for sl in [sl for g in rec.slices for sl in g]:
                sl.tensor.data = torch.empty(0, dtype=sl.tensor.dtype,
                                             device=sl.tensor.device)
                sl.tensor.grad = None
        self._zero_plan = None


def place_model(model: nn.Module, mesh: _mesh.Mesh,
                specs: Dict[str, Optional[DistSpec]]) -> PlacedModel:
    """Every parameter and buffer of ``model`` as its blocks over
    ``mesh`` by ``specs`` (state-dict name -> ``DistSpec``; a name
    without one is held whole at every position); the model's own
    tensors are left as shapes without storage (module docstring)."""
    placed = PlacedModel(mesh)
    tensors = [(k, p, False) for k, p in model.named_parameters()]
    tensors += [(k, b, True) for k, b in model.named_buffers()]
    for name, t, buffer in tensors:
        spec = specs.get(name)
        dims = tuple(_ax(d) for d in spec.dims) if spec is not None else ()
        sh = _mesh.NamedSharding(mesh, dims)
        cuts = sh.cuts(t.shape)
        index = [sh.block_of(c) for c in placed.coords]
        parts = [Part(position_of_coords(mesh, c), mesh.devices[c],
                      _region(i, cuts, t.shape))
                 for c, i in zip(placed.coords, index)]
        sp = ShardedParameter(t.shape, t.dtype, parts)
        sp.load_whole(t.detach())
        groups: Dict[tuple, list] = {}
        for k, (part, i) in enumerate(zip(sp, index)):
            part.placed_from = t
            if buffer or not t.requires_grad:
                part.requires_grad_(False)
            if i in groups:
                part.replica_of = sp[groups[i][0]]
            groups.setdefault(i, []).append(k)
        _attach(placed, name, sp)
        placed.entries[name] = _Entry(name, t, sp, sh, list(groups.values()),
                                      buffer)
        # the whole tensor keeps its shape and gives up its storage
        t.untyped_storage().resize_(0)
    return placed


def state_dict_hooks(model: nn.Module, placed: PlacedModel) -> list:
    """Hooks that make ``model.state_dict()`` give the placed tensors
    whole (gathered from the blocks) under their names, and
    ``model.load_state_dict()`` cut them straight into the blocks (a
    name it lacks is still missing); returns their handles."""
    loaded = []

    def after_save(mod, state_dict, prefix, local_metadata):
        whole = placed.state_dict()
        for k, v in whole.items():
            if prefix + k in state_dict:
                state_dict[prefix + k] = v

    def before_load(mod, state_dict, prefix, *args):
        sub = {k: state_dict.pop(prefix + k) for k in placed.entries
               if prefix + k in state_dict}
        load_state(placed, sub, strict=False)
        loaded.append([prefix + k for k in sub])

    def after_load(mod, incompatible):
        done = set(loaded.pop()) if loaded else set()
        incompatible.missing_keys[:] = [k for k in incompatible.missing_keys
                                        if k not in done]

    return [model._register_state_dict_hook(after_save),
            model._register_load_state_dict_pre_hook(before_load,
                                                     with_module=True),
            model.register_load_state_dict_post_hook(after_load)]


def _cut_value(v, whole_shape, part: Part):
    """A state value of a whole tensor as a part's: cut where it has the
    whole's shape, else copied."""
    if isinstance(v, torch.Tensor) and v.dim() > 0 and \
            tuple(v.shape) == tuple(whole_shape):
        return cut(v.detach(), part.region).to(part.device)
    return v.clone() if isinstance(v, torch.Tensor) else v


@torch.no_grad()
def repoint_optimizer(optimizer, placed: PlacedModel):
    """``optimizer`` (and each optimizer it wraps) moved in place from the
    placed model's whole parameters to their parts (module docstring)."""
    by_id = {id(e.tensor): e for e in placed.entries.values()
             if not e.buffer}
    chain = _optimizer_chain(optimizer)
    inner = chain[-1]
    names = getattr(inner, "_names", None)
    for group in inner.param_groups:
        params = []
        for p in group["params"]:
            e = by_id.get(id(p))
            if e is None:
                params.append(p)
                continue
            state = inner.state.pop(p, None)
            name = names.pop(id(p), "") if names is not None else ""
            for t, part in zip(e.blocks, e.blocks.parts):
                params.append(t)
                if state:
                    inner.state[t] = {k: _cut_value(v, p.shape, part)
                                      for k, v in state.items()}
                if names is not None:
                    names[id(t)] = name
        group["params"] = params
    for opt in chain[:-1]:
        acc = vars(opt).get("_acc")
        if acc is None:
            continue
        for e in by_id.values():
            old = acc.pop(id(e.tensor), None)
            if old is not None:
                for t, part in zip(e.blocks, e.blocks.parts):
                    acc[id(t)] = _cut_value(old, e.tensor.shape, part)


@torch.no_grad()
def _repoint_back(optimizer, placed: PlacedModel):
    """:func:`repoint_optimizer` undone: each logical tensor's parts (or
    ZeRO slices) give their place back to the whole parameter, with the
    state gathered whole."""
    chain = _optimizer_chain(optimizer)
    inner = chain[-1]
    names = getattr(inner, "_names", None)
    owner = {id(e.blocks): e for e in placed.entries.values()}
    for group in inner.param_groups:
        params, done = [], set()
        for t in group["params"]:
            entry = logical_owner(t)
            e = owner.get(id(entry))
            if e is None:
                params.append(t)
                continue
            name = names.pop(id(t), "") if names is not None else ""
            if id(e) in done:
                continue
            done.add(id(e))
            held = [x for x in group["params"]
                    if owner.get(id(logical_owner(x))) is e]
            keys = list(dict.fromkeys(k for x in held
                                      for k in inner.state.get(x, {})))
            state = {}
            for k in keys:
                v = logical_value(entry, lambda x: inner.state.get(x, {})
                                  .get(k))
                if v is None:
                    v = next(inner.state[x][k] for x in held
                             if k in inner.state.get(x, {}))
                state[k] = v.to(e.tensor.device) \
                    if isinstance(v, torch.Tensor) else v
            for x in held:
                inner.state.pop(x, None)
            params.append(e.tensor)
            if state:
                inner.state[e.tensor] = state
            if names is not None:
                names[id(e.tensor)] = name
        group["params"] = params
    if getattr(inner, "_zero", None) is not None:
        inner._zero = None
    for opt in chain[:-1]:
        acc = vars(opt).get("_acc")
        if acc is None:
            continue
        for e in placed.entries.values():
            v = logical_value(e.blocks, lambda x: acc.get(id(x)))
            for x in list(e.blocks) + [sl.tensor for sl in _slices(e)]:
                acc.pop(id(x), None)
            if v is not None:
                acc[id(e.tensor)] = v.to(e.tensor.device)


def _slices(e: _Entry) -> list:
    out = []
    for t in e.blocks:
        zero = getattr(t, "zero", None)
        if zero is not None and zero[1] == 0:
            out.extend(sl for g in zero[0].slices for sl in g)
    return out
