"""Logical tensors held as shards on a mesh, by one process.

A model placed on a training mesh (``GPTStackedForPretraining`` under
``mesh.set_mesh``) holds each logical weight -- what the unplaced model
holds as one parameter -- as a :class:`ShardedParameter`: a
``ParameterList`` of parts, each its own ``nn.Parameter`` on its mesh
position's device, each the elements of the whole at its ``region``
(index lists along some dimensions).  No whole tensor stays beside the
parts.  ``parameters()`` yields the parts, so an optimizer steps them;
``state_dict()`` shows the whole tensor under the logical name, gathered
from replica 0's parts, and :func:`load_state` cuts a whole tensor into
every part.

Each part carries ``part.shard = (owner, k)``: :func:`shard_info` reads
it, so the optimizer can save and load moments as whole tensors and the
global-norm clip can count each logical tensor once (replica 0's parts).

The ``dp`` replicas of one part meet in :func:`tie_replicas`: identity
in the forward; in the backward each replica receives the sum of all
replicas' gradients, added in replica order, so every replica applies
the same bits.

The fleet API's layers (``distributed/fleet``) hold their cut weights
the same way, beside whole parameters (LayerNorms, the position table):
:func:`place_on_stage` moves a module to a pipeline stage's devices and
marks each whole parameter's position, and :func:`load_state` loads
both kinds.  Their ``dp`` replicas are whole copies of replica 0's
modules (:func:`replicate`): each copied tensor carries ``replica_of``,
its replica-0 source, so the state dict, the loaders, the optimizer's
state and the global-norm clip see one logical tensor, while the
optimizer steps every copy.  A replica runs with its parameter slots
bound (:class:`Bound`) to its copies tied across replicas
(:func:`tie_slots`), so each copy applies the sum of the replicas'
gradients.

A module may hold copies of its own on sp positions of their own (the
layered GPT's ``sequence_copies``, each marked ``sp_coordinate``): they
lie at mesh position ``(replica, stage, shard, sp)`` -- a fourth
coordinate only for sp from 1 on, so every other position stays
``(replica, stage, shard)`` -- and :func:`place_on_stage` puts each on
the devices its caller names for that sp coordinate.  The sp ties
(inside a replica) and the dp ties (across replicas, over each slot of
body and copies alike) together give every copy the sum over all dp x sp
parts once.

ZeRO (``distributed.sharding``) cuts each tensor replica 0 holds -- a
*piece*: a whole parameter or a part -- into flat slices over the ZeRO
axis (:class:`Slice`, :func:`slice_info`), kept by a :class:`ZeroPiece`
that every replica's copy of the piece points at (``copy.zero = (piece,
replica)``).  The helpers here read a logical tensor's value from
whatever holds it (:func:`logical_value`, :func:`held_cuts`), so the
optimizers' state dicts, the clip and the meta-optimizers see whole
tensors at every level.
"""
from __future__ import annotations

import copy
import threading
from contextlib import nullcontext
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .serving_mesh import reduce_sum

__all__ = ["Part", "ShardedParameter", "shard_info", "sharded_parameters",
           "load_state", "tie_replicas", "cut", "weight_bytes_by_position",
           "place_on_stage", "copy_key", "replica_of",
           "replicate", "sync_replicas",
           "param_slots", "tie_slots", "Bound", "bound_now",
           "logical_owner", "covers_once", "Slice", "ZeroPiece",
           "slice_info", "position_of", "logical_value", "held_cuts",
           "state_bytes_by_position"]

Region = Tuple[Tuple[int, torch.Tensor], ...]


class Part(NamedTuple):
    """Where one part lies: its mesh ``position`` (``(replica, stage,
    shard)``, with the sp coordinate fourth on an sp copy: module
    docstring), its ``device`` and its ``region``."""
    position: Tuple[int, ...]
    device: torch.device
    region: Region

    @property
    def replica(self) -> int:
        return self.position[0]


def cut(whole: torch.Tensor, region: Region) -> torch.Tensor:
    """The elements of ``whole`` at ``region``, in storage of their own."""
    t = whole
    for dim, idx in region:
        t = t.index_select(dim, idx.to(t.device))
    return t if region else t.clone()


def _put(whole: torch.Tensor, region: Region, part: torch.Tensor):
    """Write ``part`` into ``whole`` at ``region``."""
    if not region:
        whole.copy_(part)
        return
    (dim, idx), rest = region[0], region[1:]
    idx = idx.to(whole.device)
    part = part.to(whole.device)
    if rest:
        sub = whole.index_select(dim, idx)
        _put(sub, rest, part)
        part = sub
    whole.index_copy_(dim, idx, part)


def _position(replica: int, stage: int, shard: int, sp: int = 0
              ) -> Tuple[int, ...]:
    """A mesh position: the sp coordinate fourth only from 1 on."""
    return (replica, stage, shard) + ((sp,) if sp else ())


def copy_key(position) -> Tuple[int, int]:
    """``(replica, sp coordinate)`` of a mesh position: which dp replica's
    copy, and which of its sp positions', a tensor there is."""
    return position[0], (position[3] if len(position) > 3 else 0)


class ShardedParameter(nn.ParameterList):
    """One logical tensor of ``shape`` as parts (module docstring).  The
    parts are made empty on their devices; fill them with
    :meth:`load_whole`."""

    def __init__(self, shape, dtype, parts: Sequence[Part]):
        super().__init__()
        self.whole_shape = tuple(shape)
        self.whole_dtype = dtype
        self.parts = list(parts)
        self.index = {p.position: k for k, p in enumerate(self.parts)}
        for k, p in enumerate(self.parts):
            sub = [self.whole_shape[d] for d in range(len(self.whole_shape))]
            for dim, idx in p.region:
                sub[dim] = len(idx)
            t = nn.Parameter(torch.empty(sub, dtype=dtype, device=p.device))
            t.shard = (self, k)
            self.append(t)

    def at(self, position) -> torch.Tensor:
        return self[self.index[tuple(position)]]

    @torch.no_grad()
    def gather(self, values: Optional[Sequence[torch.Tensor]] = None,
               device=None) -> torch.Tensor:
        """The whole tensor from replica 0's parts (or from ``values``,
        one tensor a part in part order: their gradients or moments), on
        ``device`` (default: the first part's)."""
        values = list(self) if values is None else list(values)
        device = self.parts[0].device if device is None else device
        first = next((v for v, k in zip(values, self._covering())
                      if k), values[0])
        whole = torch.empty(self.whole_shape, dtype=first.dtype,
                            device=device)
        for p, v, k in zip(self.parts, values, self._covering()):
            if k:
                _put(whole, p.region, v.detach())
        return whole

    def _covering(self) -> List[bool]:
        """Which parts a gather reads: replica 0's, less those that copy
        another part of this tensor (``replica_of``: a block several mesh
        positions hold, ``auto_parallel.placed``)."""
        return [p.replica == 0 and replica_of(t) is None
                for t, p in zip(self, self.parts)]

    def cut_whole(self, whole: torch.Tensor) -> List[torch.Tensor]:
        """Each part's elements of ``whole``, on the part's device."""
        return [cut(whole, p.region).to(p.device) for p in self.parts]

    @torch.no_grad()
    def load_whole(self, whole: torch.Tensor):
        if tuple(whole.shape) != self.whole_shape:
            raise ValueError(f"shape {tuple(whole.shape)}, expected "
                             f"{self.whole_shape}")
        for t, p in zip(self, self.parts):
            t.copy_(cut(whole, p.region).to(p.device))

    @torch.no_grad()
    def relocate(self, stage: int, devices: Sequence[torch.device],
                 replica: int, sp: int = 0):
        """Move every part to pipeline stage ``stage`` of replica
        ``replica`` at sp coordinate ``sp``: the part of shard ``i`` to
        position ``(replica, stage, i)`` (``sp`` fourth where it is not
        0) on ``devices[i]``."""
        for k, (t, p) in enumerate(zip(self, self.parts)):
            i = p.position[2]
            if t.device != devices[i]:
                t.data = t.data.to(devices[i])
            self.parts[k] = Part(_position(replica, stage, i, sp),
                                 devices[i], p.region)
        self.index = {p.position: k for k, p in enumerate(self.parts)}

    # the logical name in the state dict: this module's own prefix
    def _save_to_state_dict(self, destination, prefix, keep_vars):
        destination[prefix[:-1]] = self.gather()

    def _load_from_state_dict(self, state_dict, prefix, local_metadata,
                              strict, missing_keys, unexpected_keys,
                              error_msgs):
        # nn.Module.load_state_dict hands a child only the keys under its
        # prefix, which the logical name is not: load_state()
        # loads the parts
        pass


def load_state(module: nn.Module, state_dict, strict: bool = True):
    """``module.load_state_dict`` for a module that holds
    :class:`ShardedParameter`s: each whole tensor of ``state_dict``
    (keyed by its logical name) cut into its parts, every other
    parameter copied in its own dtype and device.  Returns ``(missing,
    unexpected)`` keys; with ``strict`` either raises."""
    owned = {**sharded_parameters(module), **_plain_parameters(module)}
    missing = [k for k in owned if k not in state_dict]
    unexpected = [k for k in state_dict if k not in owned]
    if strict and (missing or unexpected):
        raise RuntimeError(f"Error(s) in loading state_dict for "
                           f"{type(module).__name__}: missing {missing}, "
                           f"unexpected {unexpected}")
    # under ZeRO the copies are whole while loading, and the slices take
    # the loaded values after
    plan = getattr(module, "_zero_plan", None)
    with plan.writing() if plan is not None else nullcontext():
        _load_owned(module, owned, state_dict)
    return missing, unexpected


def _load_owned(module, owned, state_dict):
    for key, t in owned.items():
        if key not in state_dict:
            continue
        v = state_dict[key]
        v = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.array(v))
        if isinstance(t, ShardedParameter):
            t.load_whole(v.to(t.whole_dtype))
            continue
        if tuple(v.shape) != tuple(t.shape):
            raise ValueError(f"{key} has shape {tuple(v.shape)}, expected "
                             f"{tuple(t.shape)}")
        with torch.no_grad():
            t.copy_(v.to(t.dtype))
    sync_replicas(module)


def _plain_parameters(module: nn.Module) -> Dict[str, torch.Tensor]:
    """The parameters of ``module`` that are neither parts nor replica
    copies, by name."""
    return {n: p for n, p in module.named_parameters()
            if shard_info(p) is None and replica_of(p) is None}


def shard_info(p: torch.Tensor):
    """``(owner ShardedParameter, part index)`` of a part, else None."""
    return getattr(p, "shard", None)


def sharded_parameters(module: nn.Module) -> Dict[str, ShardedParameter]:
    """Every :class:`ShardedParameter` of ``module`` by its state-dict
    key, replica copies (:func:`replicate`) left out."""
    return {name: m for name, m in module.named_modules()
            if isinstance(m, ShardedParameter) and replica_of(m) is None}


def logical_owner(p):
    """The logical tensor ``p`` is a piece of: the :class:`ShardedParameter`
    owning it (or its replica-0 source), else that source, else ``p``; a
    ZeRO slice's is its piece's."""
    sl = slice_info(p)
    if sl is not None:
        return logical_owner(sl.owner)
    src = replica_of(p)
    src = p if src is None else src
    info = shard_info(src)
    return src if info is None else info[0]


def covers_once(p) -> bool:
    """Whether ``p`` is among the tensors that hold its logical tensor
    exactly once: not a replica copy (:func:`replicate`), not a part of a
    replica other than 0, and not a ZeRO slice of a group other than 0
    (group 0's slices of replica 0's pieces cover each element once)."""
    sl = slice_info(p)
    if sl is not None:
        return sl.group == 0 and covers_once(sl.owner)
    if replica_of(p) is not None:
        return False
    info = shard_info(p)
    return info is None or info[0].parts[info[1]].replica == 0


def replica_of(p):
    """The replica-0 tensor (or :class:`ShardedParameter`) a replica copy
    (:func:`replicate`) was made from, else None."""
    return getattr(p, "replica_of", None)


# ---------------------------------------------------------------------------
# ZeRO slices
# ---------------------------------------------------------------------------

class Slice(NamedTuple):
    """One ZeRO slice: ``tensor`` holds elements ``[lo, hi)`` of the
    flattened ``owner`` (the piece: replica 0's whole parameter or part)
    at mesh ``position`` (the holding replica, then the piece's stage and
    shard), as slice ``index`` of ZeRO group ``group``.  At ``os`` and
    ``os_g`` ``tensor`` is a view into the holding replica's copy (where
    that replica exists on the slice's device), else storage of its
    own."""
    tensor: torch.Tensor
    owner: torch.Tensor
    position: Tuple[int, ...]
    group: int
    index: int
    lo: int
    hi: int


def slice_info(t) -> Optional[Slice]:
    """The :class:`Slice` ``t`` holds, else None."""
    return getattr(t, "zero_slice", None)


class ZeroPiece:
    """The ZeRO layout of one piece: ``copies[r]`` for ``r <
    replicas``, its copy in replica ``r`` (replica 0's is the piece),
    then the copies on sp positions of their own (module docstring), each
    filled from its replica's group; ``group[k]``, the ZeRO group of copy
    ``k``; ``slices[g]``, group ``g``'s :class:`Slice`s in index order;
    ``views``, the slices that view a copy, ``{(g, j): r}``.  An sp
    copy's gradient is the one its replica's copy receives (the sp tie
    gave both the same sum), so only the replicas' ties land gradients in
    the slices (:class:`_TieReplicas`).

    At ``p_g_os`` the copies keep their shape and no storage: a use
    acquires a copy (its storage is allocated and filled from its group's
    slices: the all-gather) and releases it after; the last release frees
    the storage again.  Autograd's saved views of a copy share that
    storage, so a backward acquires again before reading them
    (:meth:`acquire` with ``backward=True``) and the gradient's arrival at
    the tie releases (:meth:`release_backward`)."""

    def __init__(self, level: str, replicas: int, copies, group, slices,
                 views):
        self.level, self.replicas = level, replicas
        self.copies = list(copies)
        self.group = list(group)
        self.slices = [list(g) for g in slices]
        self.views = dict(views)
        self.uses = [0] * len(self.copies)
        self._backward = [0] * len(self.copies)

    @property
    def stored_as_slices(self) -> bool:
        return self.level == "p_g_os"

    @torch.no_grad()
    def fill(self, r: int):
        """Write copy ``r``'s group's slices into it (through
        ``.data``: autograd's saved views of the copy see the values, and
        their version stays)."""
        flat = self.copies[r].data.view(-1)
        for sl in self.slices[self.group[r]]:
            if self.views.get((sl.group, sl.index)) != r:
                flat[sl.lo:sl.hi].copy_(sl.tensor.reshape(-1))

    def acquire(self, r: int, backward: bool = False):
        if not self.stored_as_slices:
            return
        with _ZERO_LOCK:
            if self.uses[r] == 0:
                c = self.copies[r]
                c.untyped_storage().resize_(c.numel() * c.element_size())
                self.fill(r)
            self.uses[r] += 1
            if backward:
                self._backward[r] += 1

    def release(self, r: int, n: int = 1):
        if not self.stored_as_slices:
            return
        with _ZERO_LOCK:
            self.uses[r] -= n
            if self.uses[r] == 0:
                self.copies[r].untyped_storage().resize_(0)

    def release_backward(self):
        """Release what the backward acquired (every use's gradient has
        arrived)."""
        with _ZERO_LOCK:
            for r, n in enumerate(self._backward):
                if n:
                    self._backward[r] = 0
                    self.release(r, n)

    def free(self):
        for r, c in enumerate(self.copies):
            if self.uses[r] == 0:
                c.untyped_storage().resize_(0)

    @torch.no_grad()
    def scatter_grad(self, sums: Dict[torch.device, torch.Tensor]):
        """Add slice ``[lo, hi)`` of the replicas' summed gradient
        (``sums``: on each device of the copies) into every slice's
        ``.grad``, the first addition a copy: what accumulating the whole
        sum into a whole gradient gives, element for element."""
        first = next(iter(sums.values()))
        for group in self.slices:
            for sl in group:
                t = sl.tensor
                whole = sums.get(t.device, first)
                v = whole.reshape(-1)[sl.lo:sl.hi].to(t.device)
                if t.grad is None:
                    t.grad = v.clone()
                else:
                    t.grad.add_(v)

    @torch.no_grad()
    def push(self):
        """Replica 0's copy (whole now) into every slice that is not a
        view: after a load."""
        flat = self.copies[0].detach().reshape(-1)
        for group in self.slices:
            for sl in group:
                if (sl.group, sl.index) not in self.views:
                    sl.tensor.copy_(flat[sl.lo:sl.hi].to(sl.tensor.device)
                                    .view_as(sl.tensor))

    @torch.no_grad()
    def all_gather(self):
        """After an update at ``os`` or ``os_g``: each slice into every
        copy of its group (sp copies included) that does not hold it
        already."""
        for r, c in enumerate(self.copies):
            flat = c.data.view(-1)
            for sl in self.slices[self.group[r]]:
                if self.views.get((sl.group, sl.index)) != r:
                    flat[sl.lo:sl.hi].copy_(sl.tensor.reshape(-1).to(
                        c.device))


# A backward over distinct cards acquires and releases copies from the
# threads autograd runs each card's work on.  Module-level, not a field:
# a ZeroPiece rides on its copies' attributes, which a deep copy visits.
_ZERO_LOCK = threading.RLock()


def _piece_value(piece, value_of):
    """``value_of`` read for ``piece``: its own, or, for a piece ZeRO
    holds, its group-0 slices' joined into the piece's shape (None where
    a slice has none)."""
    zero = getattr(piece, "zero", None)
    if zero is None:
        return value_of(piece)
    vals = [value_of(sl.tensor) for sl in zero[0].slices[0]]
    if any(v is None for v in vals):
        return None
    root = vals[0].device
    return torch.cat([v.reshape(-1).to(root) for v in vals]).view(
        piece.shape)


def logical_value(entry, value_of):
    """The whole value of logical tensor ``entry`` (a parameter or a
    :class:`ShardedParameter`), from ``value_of(t)`` of the tensors that
    hold it once: replica 0's parts or the parameter, or their ZeRO
    slices of group 0.  ``value_of`` gives a held tensor's value (its
    gradient, a moment, ...) or None; so does this."""
    if isinstance(entry, ShardedParameter):
        covering = entry._covering()
        vals = [_piece_value(t, value_of) if k else None
                for t, k in zip(entry, covering)]
        if any(v is None for v, k in zip(vals, covering) if k):
            return None
        return entry.gather(vals)
    return _piece_value(entry, value_of)


def held_cuts(entry, whole: torch.Tensor):
    """``(held tensor, its elements of whole)`` for every tensor an
    optimizer steps for logical tensor ``entry``: each part (or the
    parameter), or, under ZeRO, each slice of every group (the copies of
    other replicas are left out)."""
    if isinstance(entry, ShardedParameter):
        pieces = list(zip(entry, entry.cut_whole(whole)))
    else:
        pieces = [(entry, whole)]
    out = []
    for t, v in pieces:
        zero = getattr(t, "zero", None)
        if zero is None:
            out.append((t, v))
        elif zero[1] == 0:
            flat = v.reshape(-1)
            out.extend((sl.tensor, flat[sl.lo:sl.hi])
                       for group in zero[0].slices for sl in group)
    return out


class _TieReplicas(torch.autograd.Function):
    """Identity on the replicas' copies of one part; the backward gives
    each the sum of all their gradients, in replica order."""

    @staticmethod
    def forward(ctx, *copies):
        ctx.devices = [c.device for c in copies]
        ctx.zero = getattr(copies[0], "zero", None)
        return tuple(c.view_as(c) for c in copies)

    @staticmethod
    def backward(ctx, *grads):
        zero = None if ctx.zero is None or ctx.zero[0].level == "os" \
            else ctx.zero[0]
        if zero is not None and ctx.zero[1] >= zero.replicas:
            # sp copies: their replicas' ties carry the same sums into
            # the slices
            zero.release_backward()
            return (None,) * len(grads)
        if all(g is None for g in grads):
            if zero is not None:
                zero.release_backward()
            return grads
        grads = [torch.zeros((), device=d) if g is None else g
                 for g, d in zip(grads, ctx.devices)]
        sums = reduce_sum(grads, ctx.devices)
        if zero is not None:
            # os_g and p_g_os: the sum lands in the slices (the
            # reduce-scatter); no copy keeps a whole gradient
            zero.scatter_grad(sums)
            zero.release_backward()
            return (None,) * len(grads)
        out, given = [], set()
        for d in ctx.devices:
            # co-resident replicas get copies: each leaf owns its .grad
            out.append(sums[d].clone() if d in given else sums[d])
            given.add(d)
        return tuple(out)


def tie_replicas(copies: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """:class:`_TieReplicas` over one part's replica copies (replica
    order); one copy passes through, unless ZeRO reduce-scatters its
    gradient (``os_g``, ``p_g_os``)."""
    zero = getattr(copies[0], "zero", None)
    if len(copies) == 1 and (zero is None or zero[0].level == "os"):
        return tuple(copies)
    return _TieReplicas.apply(*copies)


def _own_modules(module: nn.Module, copies: list) -> list:
    """``module`` and its submodules, each once, without the subtrees of
    the sp copies below it (``sp_coordinate``), which go to ``copies``."""
    out, seen, stack = [], set(), [module]
    while stack:
        m = stack.pop()
        if id(m) in seen:
            continue
        seen.add(id(m))
        if m is not module and getattr(m, "sp_coordinate", 0):
            copies.append(m)
            continue
        out.append(m)
        stack.extend(c for c in m._modules.values() if c is not None)
    return out


def place_on_stage(module: nn.Module, stage: int,
                   devices: Sequence[torch.device], replica: int = 0,
                   sp: int = 0,
                   sp_devices: Optional[Dict[int, Sequence[torch.device]]]
                   = None):
    """Place ``module`` on pipeline stage ``stage`` of replica
    ``replica`` at sp coordinate ``sp``, whose tensor-parallel shards lie
    on ``devices``: every :class:`ShardedParameter`'s parts there
    (:meth:`ShardedParameter.relocate`); every other parameter and buffer
    on ``devices[0]``, each parameter marked with its mesh position
    ``(replica, stage, 0)``, ``sp`` fourth where it is not 0
    (``mesh_position``, which :func:`weight_bytes_by_position` reads);
    and each submodule with a ``stage_devices`` attribute told
    ``devices``.  An sp copy below ``module`` (a submodule marked
    ``sp_coordinate`` s) is not placed with it: ``sp_devices[s]``, where
    the caller gives it, places the copy at the same replica and stage
    at sp coordinate s; else the copy stays where it is."""
    devices = tuple(devices)
    root = devices[0]
    copies: list = []
    own = _own_modules(module, copies)
    for m in own:
        if isinstance(m, ShardedParameter):
            m.relocate(stage, devices, replica, sp)
        if hasattr(m, "stage_devices"):
            m.stage_devices = devices
        for name, b in m._buffers.items():
            if b is not None and b.device != root:
                m._buffers[name] = b.to(root)
    for m in own:
        for p in m._parameters.values():
            if p is None or shard_info(p) is not None:
                continue
            if p.device != root:
                p.data = p.data.to(root)
            p.mesh_position = _position(replica, stage, 0, sp)
    for c in copies:
        s = c.sp_coordinate
        if sp_devices is not None:
            place_on_stage(c, stage, sp_devices[s], replica, s)


def _held_bytes(t: torch.Tensor) -> int:
    """Bytes ``t`` holds: none while ZeRO keeps it only as slices (its
    storage freed)."""
    if t.untyped_storage().nbytes() == 0:
        return 0
    return t.numel() * t.element_size()


def position_of(t) -> Tuple[int, ...]:
    """The mesh position holding ``t``: a slice's, a part's, a whole
    parameter's mark (:func:`place_on_stage`; an sp copy's names its sp
    coordinate fourth), else ``(0, 0, 0)``."""
    sl = slice_info(t)
    if sl is not None:
        return sl.position
    info = shard_info(t)
    if info is not None:
        return info[0].parts[info[1]].position
    return getattr(t, "mesh_position", None) or (0, 0, 0)


def _zero_target(model):
    """The module holding every replica: through ``PipelineParallel`` to
    its ``PipelineLayer`` (a replicated module holds its replicas
    itself)."""
    while not hasattr(model, "_replicas") and isinstance(
            getattr(model, "_layers", None), nn.Module):
        model = model._layers
    return model


def weight_bytes_by_position(module: nn.Module) -> Dict[Tuple[int, ...], int]:
    """Bytes of the parameters each mesh position holds: the parts, and
    the whole parameters :func:`place_on_stage` marked, of every replica
    and every sp copy (at ``(replica, stage, shard, sp)``), counted from
    their tensors (what each position's device would hold on distinct
    devices).  Under ZeRO (``module._zero_plan``) every
    parameter counts (an unmarked one at ``(0, 0, 0)``), a copy stored
    only as slices counts nothing, and each slice with storage of its own
    counts at its position."""
    module = _zero_target(module)
    plan = getattr(module, "_zero_plan", None)
    out: Dict[Tuple[int, ...], int] = {}

    def add(position, n):
        out[position] = out.get(position, 0) + n

    for sp in module.modules():
        if isinstance(sp, ShardedParameter):
            for t, p in zip(sp, sp.parts):
                add(p.position, _held_bytes(t))
    for p in module.parameters():
        if shard_info(p) is None and (
                plan is not None
                or getattr(p, "mesh_position", None) is not None):
            add(position_of(p), _held_bytes(p))
    for sl in plan.slices if plan is not None else ():
        if sl.tensor._base is None:
            add(sl.position, _held_bytes(sl.tensor))
    return dict(sorted(out.items()))


def _optimizer_chain(optimizer) -> list:
    """``optimizer`` and each optimizer it wraps (a hybrid wrapper's
    ``_inner_opt``, a meta-optimizer's ``_inner``), outermost first."""
    chain = [optimizer]
    while True:
        attrs = vars(chain[-1])
        nxt = attrs.get("_inner_opt", attrs.get("_inner"))
        if nxt is None:
            return chain
        chain.append(nxt)


def state_bytes_by_position(model, optimizer
                            ) -> Dict[Tuple[int, ...], Dict[str, int]]:
    """Per mesh position, the bytes of parameters
    (:func:`weight_bytes_by_position`), of the gradients that exist now
    (every copy's ``.grad``; a ZeRO slice's, where it has storage of its
    own) and of optimizer state (the innermost optimizer's ``state`` and
    a meta-optimizer's accumulators, at their tensors' positions):
    ``{position: {"params": n, "grads": n, "state": n}}``."""
    model = _zero_target(model)
    plan = getattr(model, "_zero_plan", None)
    out: Dict[Tuple[int, ...], Dict[str, int]] = {}

    def add(position, kind, t):
        row = out.setdefault(position, {"params": 0, "grads": 0, "state": 0})
        row[kind] += _held_bytes(t)

    for pos, n in weight_bytes_by_position(model).items():
        out.setdefault(pos, {"params": 0, "grads": 0, "state": 0})
        out[pos]["params"] += n
    for p in model.parameters():
        if p.grad is not None:
            add(position_of(p), "grads", p.grad)
    for sl in plan.slices if plan is not None else ():
        g = sl.tensor.grad
        if g is not None and g._base is None:
            add(sl.position, "grads", g)
    chain = _optimizer_chain(optimizer)
    inner = chain[-1]
    params = [p for g in inner.param_groups for p in g["params"]]
    for p in params:
        for v in inner.state.get(p, {}).values():
            if isinstance(v, torch.Tensor) and v.dim() > 0:
                add(position_of(p), "state", v)
        for opt in chain[:-1]:
            acc = vars(opt).get("_acc", {}).get(id(p))
            if acc is not None:
                add(position_of(p), "state", acc)
    return dict(sorted(out.items()))


# ---------------------------------------------------------------------------
# dp replicas of a module tree
# ---------------------------------------------------------------------------

def replicate(obj):
    """A deep copy of ``obj`` (a module, or a list or tuple holding
    modules; references between them are kept inside the copy) whose
    every parameter carries ``replica_of``: the parameter it was copied
    from, or that one's own source (a copy of a copy, as a dp replica's
    sp copies are, points at replica 0's body).  The copy's
    :class:`ShardedParameter` parts point at their own owner
    (``shard``); place the copy with :func:`place_on_stage`."""
    memo: dict = {}
    out = copy.deepcopy(obj, memo)
    roots = obj if isinstance(obj, (list, tuple)) else [obj]
    for root in roots:
        if not isinstance(root, nn.Module):
            continue
        for p in root.parameters():
            c = memo.get(id(p))
            if c is not None:
                c.replica_of = replica_of(p) if replica_of(p) is not None \
                    else p
        for m in root.modules():
            if isinstance(m, ShardedParameter) and id(m) in memo:
                c = memo[id(m)]
                # a plain attribute: a module assigned as one would
                # register as a submodule
                object.__setattr__(c, "replica_of", m)
                for k, t in enumerate(c):
                    t.shard = (c, k)
    return out


@torch.no_grad()
def sync_replicas(module: nn.Module):
    """Copy every replica copy's source (``replica_of``) into it: the
    replicas of ``module`` hold replica 0's values again (a copy ZeRO
    keeps only as slices is left alone)."""
    for p in module.parameters():
        src = replica_of(p)
        if src is not None and _held_bytes(p) and _held_bytes(src):
            p.copy_(src if src.device == p.device else src.to(p.device))


def param_slots(modules: Sequence[nn.Module]) -> List[Tuple[nn.Module, str]]:
    """Every ``(module, name)`` holding a parameter under ``modules``, in
    module order (each module once): the slots :class:`Bound` fills.  The
    copies :func:`replicate` makes list theirs in the same order."""
    slots, seen = [], set()
    for root in modules:
        for m in root.modules():
            if id(m) in seen:
                continue
            seen.add(id(m))
            slots.extend((m, n) for n, t in m._parameters.items()
                         if t is not None)
    return slots


def tie_slots(replica_slots: Sequence[Sequence[Tuple[nn.Module, str]]]
              ) -> List[List[torch.Tensor]]:
    """The tensors of each replica's slots tied slot by slot
    (:func:`tie_replicas`): ``out[r][k]`` stands for replica ``r``'s
    tensor in slot ``k``; in the backward every replica's copy receives
    the sum of all replicas' gradients, added in replica order."""
    copies = [[m._parameters[n] for m, n in slots] for slots in replica_slots]
    tied = [tie_replicas(list(ts)) for ts in zip(*copies)]
    return [list(ts) for ts in zip(*tied)] if tied else [[] for _ in copies]


_BOUND: List["Bound"] = []


class Bound:
    """A context in which ``slots`` hold ``tensors`` (their ``_parameters``
    entries swapped, and put back on leaving): a replica's modules run on
    its tied views.  Entering an active one again is a no-op, so a
    recompute (``fleet.recompute``) re-enters the contexts its forward
    ran in (:func:`bound_now`)."""

    def __init__(self, slots, tensors):
        self.slots, self.tensors = list(slots), list(tensors)
        self._depth, self._saved = 0, None

    def __enter__(self):
        if self._depth == 0:
            self._saved = [m._parameters[n] for m, n in self.slots]
            for (m, n), t in zip(self.slots, self.tensors):
                m._parameters[n] = t
            _BOUND.append(self)
        self._depth += 1
        return self

    def __exit__(self, *exc):
        self._depth -= 1
        if self._depth == 0:
            for (m, n), t in zip(self.slots, self._saved):
                m._parameters[n] = t
            self._saved = None
            _BOUND.remove(self)


def bound_now() -> Tuple[Bound, ...]:
    """The :class:`Bound` contexts active now, outermost first."""
    return tuple(_BOUND)
