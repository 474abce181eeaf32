"""ZeRO through the reference's ``group_sharded_parallel`` (port of
``paddle_tpu/distributed/sharding/__init__.py``).

One process drives every mesh position.  A model's data replicas run over
dp x sharding (``mesh.replica_count``): ``PipelineLayer``,
``DataParallel``, ``TensorParallel`` and the stacked GPT's mesh hold a
copy of each *piece* (a whole parameter, or an mp part) per replica; a
bare module given here is one replica.  The ZeRO axis is the mesh's
``sharding`` axis, else ``dp`` (the reference's default group).  The
ZeRO group of a piece is the replicas along that axis that share its
other coordinates (one group for a bare module); each group cuts the
piece into ``n`` flat slices (:class:`~paddle_tpu_torch.distributed.
shards.Slice`), slice ``j`` on the group's ``j``-th position.  The
ranges start at multiples of 16 bytes (the fused AdamW kernel's vector
width); a piece of fewer than ``n x 16`` bytes stays one slice, on
position 0.  The levels:

- ``os``: each slice holds the optimizer state of its range once per
  group (AdamW's moments and masters, ``Momentum``'s velocity, a
  ``GradientMerge`` accumulator, and state made later, which is made
  from the slices); the optimizer steps the slices, which view the
  holding replica's copy, from the matching range of its whole summed
  gradient, and each updated range is then copied into the group's other
  copies (the all-gather);
- ``os_g``: also the gradients: the replicas' gradients are summed, in
  replica order, straight into the slices (the reduce-scatter), and no
  whole gradient is kept;
- ``p_g_os``: also the parameters: every copy keeps its shape and no
  storage.  A module that reads a copy (one holding parameters, an mp
  layer's parts, or a module that names another's in
  ``_zero_tied_modules``: the tied LM head) gathers it from its group's slices before its forward and
  frees it after; autograd's saved views share the copy's storage, so
  the first gradient of the module's outputs gathers it again, and the
  piece's summed gradient reaching its slices frees it.  A module
  marked ``_zero_unit`` (the stacked GPT) gathers its whole tree around
  its forward in the same way.

A model whose sp positions hold copies on devices of their own (the
layered GPT's ``sequence_copies``) gives each piece, beside its
replicas' copies, one copy for each (replica, sp position) from sp 1 on:
each is filled from its replica's group (gathered around its use at
``p_g_os``, written after each update at ``os`` and ``os_g``), and its
gradient, which the replica's sp tie already summed into the replica's
copy, lands in no slice.

A model placed by ``auto_parallel``'s Engine (``auto_parallel.placed``:
one part a mesh position, at ``(dp, pp, mp)``) is laid out by its
blocks (``_build_block_plan``): each block is a piece whose copies are
every position holding it, and a ZeRO group the copies that differ only
along ``dp``; its executor ties and gathers the copies itself, so no
module hook is installed there.

Every level sums the replicas' gradients in the same order as the same
mesh without ZeRO and runs the same elementwise updates, so the levels
and the run without ZeRO hold the same bits.  ``state_dict()``, the
optimizer's ``state_dict()`` and the loaders (``load_jax_state``,
``set_state_dict``) see whole tensors under the unsharded keys.  The
gathers, scatters and slice copies are plain copies and adds: the JAX
package computes them with XLA collectives outside any Pallas kernel.
Clear gradients through the optimizer (``clear_grad``/``zero_grad``),
which clears the copies' and the slices'.
"""
from __future__ import annotations

import os
import tempfile
from contextlib import contextmanager
from typing import Dict, List

import torch
from torch import nn

from .. import mesh as _mesh
from ..shards import (
    Bound, ShardedParameter, Slice, ZeroPiece, _optimizer_chain,
    _plain_parameters, _zero_target, copy_key, logical_value, param_slots,
    position_of, replica_of, shard_info, sharded_parameters, tie_slots,
)

__all__ = ["group_sharded_parallel", "save_group_sharded_model",
           "gathered_grads"]

LEVELS = ("os", "os_g", "p_g_os")
# the slice boundaries' alignment: the fused AdamW kernel's 16-byte loads
_ALIGN_BYTES = 16


def _pick_axis():
    if not _mesh.has_mesh():
        return None
    shape = _mesh.get_mesh().shape
    for ax in ("sharding", "dp"):
        if shape.get(ax, 1) > 1:
            return ax
    return None


def _ranges(numel: int, elem: int, n: int) -> List[tuple]:
    """``[(j, lo, hi)]``: ``n`` contiguous ranges of a flat tensor, the
    boundaries at multiples of 16 bytes; empty ranges left out, and fewer
    than ``n x 16`` bytes one range on slice 0."""
    align = max(1, _ALIGN_BYTES // elem)
    if numel < n * align:
        return [(0, 0, numel)]
    per = -(-numel // n)
    per = -(-per // align) * align
    return [(j, j * per, min((j + 1) * per, numel)) for j in range(n)
            if j * per < numel]


def _piece(p):
    """The replica-0 tensor that ``p`` is a copy of."""
    src = replica_of(p)
    src = p if src is None else src
    info = shard_info(src)
    if info is None:
        return src
    sp, k = info
    return sp.at((0,) + tuple(sp.parts[k].position[1:]))


def _position(piece):
    info = shard_info(piece)
    if info is not None:
        return tuple(info[0].parts[info[1]].position)
    return tuple(getattr(piece, "mesh_position", None) or (0, 0, 0))


class ZeroPlan:
    """The ZeRO layout of one model (module docstring): its
    :class:`~paddle_tpu_torch.distributed.shards.ZeroPiece`s and the
    optimizer side's calls."""

    def __init__(self, level: str, axis: str, pieces: List[ZeroPiece]):
        self.level, self.axis, self.pieces = level, axis, pieces
        self.slices: List[Slice] = [sl for rec in pieces
                                    for g in rec.slices for sl in g]
        self.roots: List[nn.Module] = []      # the modules marked _zero_plan
        self.hooks: list = []                 # the hooks' removable handles

    @torch.no_grad()
    def dissolve(self):
        """Hand the model back without ZeRO (a model leaving its training
        mesh: ``leave_training_mesh``): the plan's hooks go, then piece by
        piece replica 0's copy keeps its whole value (gathered from the
        slices where ``p_g_os`` freed it) and the piece's slices and other
        copies are freed, so the peak is the placement and one piece; then
        ``_zero_plan`` goes from its modules.  The optimizer keeps the
        freed slices: stepping it again steps nothing."""
        for h in self.hooks:
            h.remove()
        self.hooks = []
        for rec in self.pieces:
            rec.acquire(0)
            for t in [sl.tensor for g in rec.slices for sl in g] + \
                    rec.copies[1:]:
                t.data = torch.empty(0, dtype=t.dtype, device=t.device)
                t.grad = None
        for m in self.roots:
            m._zero_plan = None

    # -- the optimizer's side ------------------------------------------
    @torch.no_grad()
    def prepare_grads(self):
        """At ``os``: each slice without a gradient gets the matching
        range of its holder's whole gradient (a view; a copy where the
        slice lives on another device)."""
        if self.level != "os":
            return
        for rec in self.pieces:
            for group in rec.slices:
                for sl in group:
                    if sl.tensor.grad is not None:
                        continue
                    r = rec.views.get((sl.group, sl.index), 0)
                    g = rec.copies[r].grad
                    if g is not None:
                        v = g.view(-1)[sl.lo:sl.hi]
                        sl.tensor.grad = (v if v.device == sl.tensor.device
                                          else v.to(sl.tensor.device))

    @torch.no_grad()
    def clear_grads(self, set_to_none: bool = True):
        for rec in self.pieces:
            for t in rec.copies + [sl.tensor for g in rec.slices for sl in g]:
                if t.grad is None:
                    continue
                if set_to_none:
                    t.grad = None
                else:
                    t.grad.zero_()

    def after_step(self):
        """At ``os`` and ``os_g``: the updated slices into every copy."""
        if self.level != "p_g_os":
            for rec in self.pieces:
                rec.all_gather()

    # -- whole tensors for the state dicts and the loaders -------------
    @contextmanager
    def reading(self):
        """Replica 0's copies whole for the body."""
        for rec in self.pieces:
            rec.acquire(0)
        try:
            yield
        finally:
            for rec in self.pieces:
                rec.release(0)

    @contextmanager
    def writing(self):
        """Every copy whole for the body, then replica 0's values into the
        slices."""
        for rec in self.pieces:
            for r in range(len(rec.copies)):
                rec.acquire(r)
        try:
            yield
            for rec in self.pieces:
                rec.push()
        finally:
            for rec in self.pieces:
                for r in range(len(rec.copies)):
                    rec.release(r)


def _build_plan(target: nn.Module, level: str, axis: str) -> ZeroPlan:
    copies: Dict[int, Dict[tuple, torch.Tensor]] = {}
    pieces = {}
    for p in target.parameters():
        piece = _piece(p)
        pieces[id(piece)] = piece
        copies.setdefault(id(piece), {})[copy_key(position_of(p))] = p
    R = 1 + max(r for c in copies.values() for r, _ in c)
    dp, S = _mesh.axis_size("dp"), _mesh.axis_size("sharding")
    n = _mesh.axis_size(axis)
    if R == 1:
        group = [0]
    elif R == dp * S:
        group = [r // S if axis == "sharding" else 0 for r in range(R)]
    else:
        raise ValueError(f"group_sharded_parallel: the model holds {R} "
                         f"replicas, the mesh asks dp x sharding = {dp * S}")

    def holder(g, j):
        """The mesh replica holding slice j of group g."""
        return g * S + j if axis == "sharding" else j

    out = []
    for key, piece in pieces.items():
        have = copies[key]
        got = sorted({r for r, _ in have})
        sps = sorted({s for _, s in have})
        if got != list(range(R)) or len(have) != R * len(sps):
            raise ValueError(f"group_sharded_parallel: a tensor of shape "
                             f"{tuple(piece.shape)} has copies at (replica, "
                             f"sp) {sorted(have)}, not at each sp position "
                             f"of each of {R} replicas")
        reps = [have[(r, 0)] for r in range(R)]
        # the sp copies, each filled from its replica's group
        extra = [(r, have[(r, s)]) for r, s in sorted(have) if s]
        pos = _position(piece)
        flat0 = piece.detach().reshape(-1)
        slices, views = [], {}
        for g in range(max(group) + 1):
            slices.append([])
            for j, lo, hi in _ranges(piece.numel(), piece.element_size(), n):
                h = holder(g, j)
                if h < R:
                    dev = reps[h].device
                else:
                    dev = _mesh.stage_devices(pos[1], h)[pos[2]]
                if level != "p_g_os" and h < R:
                    t = reps[h].detach().view(-1)[lo:hi]
                    views[(g, j)] = h
                else:
                    t = flat0[lo:hi].to(dev).clone()
                sl = Slice(t, piece, (h,) + pos[1:], g, j, lo, hi)
                t.zero_slice = sl
                slices[-1].append(sl)
        rec = ZeroPiece(level, R, reps + [c for _, c in extra],
                        group + [group[r] for r, _ in extra], slices, views)
        for k, c in enumerate(rec.copies):
            c.zero = (rec, k)
        out.append(rec)
    return ZeroPlan(level, axis, out)


def _build_block_plan(target: nn.Module, level: str, axis: str
                      ) -> ZeroPlan:
    """The ZeRO layout of a model placed by ``auto_parallel``'s Engine
    (``auto_parallel.placed``: one part a mesh position at ``(dp, pp,
    mp)``, the parts that hold one block pointing at the first by
    ``replica_of``).  Each block is a piece, its copies every part that
    holds it, in position order; a ZeRO group is the copies that differ
    only along ``axis``, and slice ``j`` of a group lies at its copy whose
    coordinate on the axis is ``j``."""
    if axis != "dp":
        raise ValueError(f"group_sharded_parallel: a placed model's ZeRO "
                         f"axis is dp, not {axis}")
    n = _mesh.axis_size(axis)
    out = []
    for sp in target.modules():
        if not isinstance(sp, ShardedParameter) or \
                not sp[0].requires_grad:
            continue
        blocks: Dict[int, list] = {}
        for t, part in zip(sp, sp.parts):
            src = replica_of(t)
            blocks.setdefault(id(t if src is None else src), []).append(
                (t, part.position))
        for members in blocks.values():
            copies = [t for t, _ in members]
            piece = copies[0]
            keys: Dict[tuple, int] = {}
            group = [keys.setdefault(pos[1:], len(keys))
                     for _, pos in members]
            at = {(g, pos[0]): r for r, (g, (_, pos)) in
                  enumerate(zip(group, members))}
            flat0 = piece.detach().reshape(-1)
            slices, views = [], {}
            for g in range(len(keys)):
                slices.append([])
                for j, lo, hi in _ranges(piece.numel(),
                                         piece.element_size(), n):
                    r = at[(g, j)]
                    if level != "p_g_os":
                        t = copies[r].detach().view(-1)[lo:hi]
                        views[(g, j)] = r
                    else:
                        t = flat0[lo:hi].to(copies[r].device).clone()
                    sl = Slice(t, piece, members[r][1], g, j, lo, hi)
                    t.zero_slice = sl
                    slices[-1].append(sl)
            rec = ZeroPiece(level, len(copies), copies, group, slices,
                            views)
            for k, c in enumerate(copies):
                c.zero = (rec, k)
            out.append(rec)
    return ZeroPlan(level, axis, out)


def _cut_state(v, sl: Slice):
    if isinstance(v, torch.Tensor) and v.numel() == sl.owner.numel() \
            and v.dim() > 0:
        return v.detach().reshape(-1)[sl.lo:sl.hi].to(
            sl.tensor.device).clone()
    return v


def _shard_optimizer(chain, plan: ZeroPlan):
    """The innermost optimizer steps the slices: each group's parameter
    list has each piece's slices in its place (other replicas' copies
    left out), their state cut from the piece's; a meta-optimizer's
    accumulators (``_acc``) likewise."""
    inner = chain[-1]
    names = getattr(inner, "_names", None)
    for group in inner.param_groups:
        params = []
        for p in group["params"]:
            zero = getattr(p, "zero", None)
            if zero is None:
                params.append(p)
                continue
            rec, r = zero
            state = inner.state.pop(p, None)
            name = names.pop(id(p), "") if names is not None else ""
            if r:
                continue
            for g in rec.slices:
                for sl in g:
                    params.append(sl.tensor)
                    if state:
                        inner.state[sl.tensor] = {
                            k: _cut_state(v, sl) for k, v in state.items()}
                    if names is not None:
                        names[id(sl.tensor)] = name
        group["params"] = params
    for opt in chain[:-1]:
        acc = vars(opt).get("_acc")
        if acc is None:
            continue
        new = {}
        for rec in plan.pieces:
            old = acc.get(id(rec.copies[0]))
            for g in rec.slices:
                for sl in g:
                    new[id(sl.tensor)] = (
                        torch.zeros_like(sl.tensor, dtype=torch.float32)
                        if old is None else _cut_state(old, sl))
        copies = {id(c) for rec in plan.pieces for c in rec.copies}
        opt._acc = {**{k: v for k, v in acc.items() if k not in copies},
                    **new}
    inner._zero = plan


def _outputs(out) -> List[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _outputs(o)]
    if isinstance(out, dict):
        return [t for o in out.values() for t in _outputs(o)]
    parts = getattr(out, "parts", None)        # an mp ShardedTensor
    return _outputs(list(parts)) if parts is not None else []


def _gather_around(module: nn.Module, slots):
    """p_g_os: ``module``'s forward gathers the copies in ``slots`` and
    frees them after; the first gradient of its outputs gathers them
    again for the backward (module docstring)."""
    active = []

    def pre(mod, args):
        held = []
        for owner, name in slots:
            t = owner._parameters.get(name)
            if t is None:
                continue
            src = t if t._base is None else t._base
            zero = getattr(src, "zero", None)
            if zero is not None:
                zero[0].acquire(zero[1])
                held.append(zero)
        active.append(held)

    def post(mod, args, out):
        held = active.pop()
        outs = [t for t in _outputs(out) if t.requires_grad] \
            if torch.is_grad_enabled() else []
        if outs and held:
            done = []

            def again(grad):
                if not done:
                    done.append(True)
                    for rec, r in held:
                        rec.acquire(r, backward=True)

            for t in outs:
                t.register_hook(again)
        for rec, r in held:
            rec.release(r)

    return [module.register_forward_pre_hook(pre),
            module.register_forward_hook(post, always_call=True)]


def _install_gathers(root: nn.Module) -> list:
    """p_g_os: :func:`_gather_around` every module that reads a copy;
    returns the hooks' handles."""
    seen, handles = set(), []

    def visit(m):
        if id(m) in seen or isinstance(m, ShardedParameter):
            return
        seen.add(id(m))
        if getattr(m, "_zero_unit", False):
            handles.extend(_gather_around(m, param_slots([m])))
            return
        slots = [(m, n) for n, t in m._parameters.items() if t is not None]
        for c in m._modules.values():
            if isinstance(c, ShardedParameter):
                slots += [(c, n) for n, t in c._parameters.items()
                          if t is not None]
        for tied in getattr(m, "_zero_tied_modules", ()):
            slots += param_slots([tied])
        if slots:
            handles.extend(_gather_around(m, slots))
        for c in m._modules.values():
            if c is not None:
                visit(c)

    visit(root)
    return handles


def _bind_one_replica(root: nn.Module):
    """A bare module at os_g or p_g_os runs with its slots bound to ties
    of one copy, whose backward lands the gradients in the slices."""
    slots = param_slots([root])
    active = []

    def pre(mod, args):
        b = Bound(slots, tie_slots([slots])[0])
        b.__enter__()
        active.append(b)

    def post(mod, args, out):
        active.pop().__exit__(None, None, None)

    return [root.register_forward_pre_hook(pre, prepend=True),
            root.register_forward_hook(post, always_call=True)]


def _whole_state_dicts(root: nn.Module, plan: ZeroPlan):
    """p_g_os: ``state_dict()`` and ``load_state_dict()`` of ``root`` see
    whole tensors (the port's own loaders read ``_zero_plan``)."""
    reading, writing = [], []

    def before_save(mod, prefix, keep_vars):
        ctx = plan.reading()
        ctx.__enter__()
        reading.append(ctx)

    def after_save(mod, state_dict, prefix, local_metadata):
        held = {rec.copies[0].untyped_storage().data_ptr()
                for rec in plan.pieces}
        for k, v in list(state_dict.items()):
            if isinstance(v, torch.Tensor) and \
                    v.untyped_storage().data_ptr() in held:
                state_dict[k] = v.clone()
        reading.pop().__exit__(None, None, None)

    def before_load(mod, *args):
        ctx = plan.writing()
        ctx.__enter__()
        writing.append(ctx)

    def after_load(mod, incompatible):
        writing.pop().__exit__(None, None, None)

    return [root.register_state_dict_pre_hook(before_save),
            root._register_state_dict_hook(after_save),
            root._register_load_state_dict_pre_hook(before_load,
                                                    with_module=True),
            root.register_load_state_dict_post_hook(after_load)]


def _unwrap_optimizer(optimizer):
    chain = _optimizer_chain(optimizer)
    if not isinstance(chain[-1], torch.optim.Optimizer):
        raise TypeError(f"group_sharded_parallel: {type(chain[-1]).__name__} "
                        "is not an optimizer of the port")
    return chain


def group_sharded_parallel(model, optimizer, level, scaler=None, group=None,
                           offload=False, sync_buffers=False,
                           buffer_max_size=2**23, segment_size=2**20,
                           sync_comm=False, dp_group=None,
                           exclude_layer=None):
    """The reference's ``group_sharded_parallel``: ``(model, optimizer,
    scaler)`` with ZeRO at ``level`` ("os", "os_g" or "p_g_os"; another
    raises ``ValueError``) over the mesh's ZeRO axis (module docstring);
    without one (no mesh, or sharding and dp both 1) the triple comes back
    unchanged.  ``model`` may be a ``PipelineParallel``,
    ``TensorParallel``, ``DataParallel`` or a bare module, ``optimizer``
    a ``HybridParallelOptimizer`` or a meta-optimizer over one of the
    port's optimizers; the returned objects are the ones given, changed in
    place.  ``group``, ``offload``, ``sync_buffers``, ``buffer_max_size``,
    ``segment_size``, ``sync_comm``, ``dp_group`` and ``exclude_layer``
    are accepted and not read, as the JAX function does."""
    if level not in LEVELS:
        raise ValueError(f"level must be os | os_g | p_g_os, got {level}")
    axis = _pick_axis()
    if axis is None:
        return model, optimizer, scaler
    target = _zero_target(model)
    if getattr(target, "_zero_plan", None) is not None:
        raise ValueError("group_sharded_parallel: the model is sharded "
                         "already")
    chain = _unwrap_optimizer(optimizer)
    blocks = getattr(target, "_position_blocks", False)
    plan = (_build_block_plan if blocks else _build_plan)(target, level,
                                                          axis)
    _shard_optimizer(chain, plan)
    # a replicated wrapper's state dicts are its replica 0's, ``_layers``
    roots = [target] + ([target._layers] if isinstance(
        getattr(target, "_layers", None), nn.Module) else [])
    for m in roots:
        m._zero_plan = plan
    plan.roots = roots
    # a placed model's executor ties and gathers its blocks itself
    single = plan.pieces[0].replicas == 1 if plan.pieces else False
    if level != "os" and single and not blocks:
        plan.hooks += _bind_one_replica(target)
    if level == "p_g_os":
        if not blocks:
            plan.hooks += _install_gathers(target)
        plan.hooks += _whole_state_dicts(roots[-1], plan)
        for rec in plan.pieces:
            rec.free()
    return model, optimizer, scaler


def gathered_grads(model) -> Dict[str, torch.Tensor]:
    """Every gradient of ``model`` as a whole tensor under its state-dict
    key: gathered from the parts, or from the ZeRO slices (at ``os``
    their holders' ranges), on the first part's or slice's device."""
    target = _zero_target(model)
    plan = getattr(target, "_zero_plan", None)
    if plan is not None:
        plan.prepare_grads()

    def grad(t):
        return t.grad

    out = {k: logical_value(sp, grad)
           for k, sp in sharded_parameters(target).items()}
    out.update({k: logical_value(p, grad)
                for k, p in _plain_parameters(target).items()})
    return out


def _atomic_save(obj, path: str):
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path)
                               + ".tmp-")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(obj, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def save_group_sharded_model(model, output, optimizer=None):
    """The reference's ``save_group_sharded_model``: ``model``'s whole
    ``state_dict()`` to ``output/model.pdparams`` and, given
    ``optimizer``, its whole ``state_dict()`` to ``output/model.pdopt``
    (``torch.save`` each, written to a temp file, fsynced, then renamed
    over the path)."""
    os.makedirs(output, exist_ok=True)
    _atomic_save(model.state_dict(), os.path.join(output, "model.pdparams"))
    if optimizer is not None:
        _atomic_save(optimizer.state_dict(),
                     os.path.join(output, "model.pdopt"))
