"""Serving-mesh helpers: ``dp`` replicas of ``mp`` head shards driven by
one process (port of ``paddle_tpu/distributed/serving_mesh.py``).

The reference partitions a replica's weights with GSPMD and runs the
paged attention per head shard under ``shard_map``.  PyTorch has neither,
so the port makes the split explicit:

- a replica's mesh is a tuple of ``mp`` ``torch.device``s (a device may
  appear more than once: co-residence is what the caller names);
- shard ``i`` holds its weight slices on ``mesh[i]``
  (:func:`shard_model_for_serving`): the QKV and fc1 products are
  column-parallel (shard ``i`` owns heads ``i*H/mp .. (i+1)*H/mp`` of
  each of q, k and v, and a contiguous ``F/mp`` of fc1's columns), the
  output projection and fc2 row-parallel (the matching rows); LayerNorms,
  embeddings, the LM head and the row-parallel biases stay whole;
- shard ``i`` holds its own contiguous ``[P, H/mp, page, D]`` slice of the
  page pool on ``mesh[i]`` (:func:`shard_paged_cache`);
- the row-parallel partials meet in :func:`reduce_sum`: a sum onto every
  device of the mesh in shard order (bit for bit the same total on each),
  one sum when the shards share a device.

With ``mp > 1`` the shards own the tensor-parallel weights: once they
are cut, the model's whole QKV, output-projection, fc1 and fc2 tensors
(and a quantized stacked decoder's unused fp slabs) are dropped to the
``meta`` device, so ``mesh[i]`` holds the replicated tensors and shard
``i``'s slices, about ``1/mp`` of the projections' bytes
(:func:`weight_bytes_by_device`), as the reference's GSPMD placement
does.  :func:`unshard_model` gathers them back (a clone, a new mesh or a
quantization does it); until then the model serves only over its
sharded pool.  There is no
``activate()``/``active_mesh()``: the reference's thread-local is a
trace-time context, and an eager model reads its shards from the cache it
is handed.
"""
from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..core import canonical_device
from ..quantization.int8 import k_major

__all__ = [
    "replica_meshes", "mp_size", "validate_head_sharding",
    "shard_model_for_serving", "shard_paged_cache", "clone_model",
    "reduce_sum", "reduce_max", "broadcast", "unique_devices",
    "qkv_columns", "ShardedLayer", "unshard_model", "weight_bytes_by_device",
    "shard_weight_bytes", "take_weights",
]

Mesh = Tuple[torch.device, ...]


def _visible_cards() -> List[torch.device]:
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def replica_meshes(dp: int, mp: int,
                   devices: Optional[Sequence] = None) -> List[Mesh]:
    """One ``mp``-device mesh per ``dp`` replica, over consecutive rows of
    the first ``dp*mp`` entries of ``devices`` (default: the visible
    cards, one each).  Too few devices raise and say how many were
    found; nothing falls back.  Naming a device more than once puts
    replicas or shards on it together."""
    dp, mp = int(dp), int(mp)
    if dp < 1 or mp < 1:
        raise ValueError(f"mesh axes must be >= 1, got dp={dp} mp={mp}")
    devs = _visible_cards() if devices is None else list(devices)
    if dp * mp > len(devs):
        where = "visible CUDA devices" if devices is None else "devices"
        raise ValueError(
            f"serving mesh (dp={dp}, mp={mp}) needs {dp * mp} devices, "
            f"found {len(devs)} {where}; name a device more than once to "
            "put replicas or shards on it together")
    devs = [canonical_device(d) for d in devs[:dp * mp]]
    return [tuple(devs[i * mp:(i + 1) * mp]) for i in range(dp)]


def mp_size(mesh) -> int:
    """Shards of a replica mesh (1 for None)."""
    return 1 if mesh is None else len(mesh)


def unique_devices(mesh: Sequence[torch.device]) -> List[torch.device]:
    """The mesh's distinct devices, in shard order."""
    out: List[torch.device] = []
    for d in mesh:
        if d not in out:
            out.append(d)
    return out


def validate_head_sharding(num_heads: int, mp: int,
                           kernel: str = "ragged_paged_attention") -> int:
    """Heads per shard; a ``ValueError`` in the reference's GL002 wording
    when the per-head partition cannot exist."""
    mp = int(mp)
    problems = []
    if mp > 1:
        if num_heads % mp:
            problems.append(f"num_heads={num_heads} is not divisible by "
                            f"mp={mp} (per-head pool shard)")
        elif num_heads // mp < 1:
            problems.append(f"num_heads={num_heads} leaves no head per "
                            f"shard at mp={mp}")
    if problems:
        raise ValueError(f"[GL002 tile-misalignment] {kernel}: "
                         + "; ".join(problems))
    return num_heads // max(mp, 1)


# ---------------------------------------------------------------------------
# collectives of one process: partials that live on the mesh's devices
# ---------------------------------------------------------------------------

def broadcast(t: torch.Tensor, mesh: Sequence[torch.device]
              ) -> Dict[torch.device, torch.Tensor]:
    """``t`` on every device of the mesh (itself where it already is)."""
    return {d: (t if t.device == d else t.to(d))
            for d in unique_devices(mesh)}


def _reduce(parts: Sequence[torch.Tensor], mesh, op
            ) -> Dict[torch.device, torch.Tensor]:
    out = {}
    for d in unique_devices(mesh):
        acc = None
        for p in parts:                       # shard order on every device
            p = p if p.device == d else p.to(d)
            acc = p if acc is None else op(acc, p)
        out[d] = acc
    return out


def reduce_sum(parts: Sequence[torch.Tensor], mesh
               ) -> Dict[torch.device, torch.Tensor]:
    """The row-parallel reduce: the sum of ``parts`` (one per shard, on
    its shard's device) on every device of ``mesh``, added in shard order
    so each device holds the same bits; one sum when the shards share a
    device."""
    return _reduce(parts, mesh, torch.add)


def reduce_max(parts: Sequence[torch.Tensor], mesh
               ) -> Dict[torch.device, torch.Tensor]:
    """The elementwise maximum of ``parts`` on every device of ``mesh``
    (the whole-row activation scale of a row-parallel int8 product)."""
    return _reduce(parts, mesh, torch.maximum)


# ---------------------------------------------------------------------------
# the weights: column/row-parallel slices per shard
# ---------------------------------------------------------------------------

def qkv_columns(num_heads: int, head_dim: int, mp: int, i: int,
                device=None) -> torch.Tensor:
    """The fused QKV columns of shard ``i``: its heads of q, then of k,
    then of v.  The columns are laid out ``[3, heads, head_dim]``, so a
    contiguous third of them would be the wrong heads."""
    hs = num_heads // mp
    hidden = num_heads * head_dim
    base = torch.arange(i * hs * head_dim, (i + 1) * hs * head_dim)
    cols = torch.cat([base + j * hidden for j in range(3)])
    return cols.to(device) if device is not None else cols


class ShardedLayer:
    """One decoder layer split for a mesh.  ``rep[device]`` holds the
    whole tensors every device needs (``ln1_g``, ``ln1_b``, ``ln2_g``,
    ``ln2_b``, the row-parallel biases ``proj_b``/``fc2_b`` and, for int8
    weights, their full scale vectors ``proj_s``/``fc2_s``);
    ``shards[i]`` holds shard ``i``'s slices on ``mesh[i]`` (``qkv_w``,
    ``qkv_b``, ``proj_w``, ``fc1_w``, ``fc1_b``, ``fc2_w`` and, for int8
    weights, the column-parallel scale slices ``qkv_s``/``fc1_s``).
    ``act`` holds the static activation scales of the layered model's
    ``Int8Linear`` layers (None: per-row dynamic)."""

    __slots__ = ("rep", "shards", "act")

    def __init__(self, rep, shards, act):
        self.rep = rep
        self.shards = shards
        self.act = act


def _on(t: Optional[torch.Tensor], d: torch.device):
    if t is None:
        return None
    return t if t.device == d else t.to(d)


def _own(t: torch.Tensor, whole: torch.Tensor) -> torch.Tensor:
    """``t`` in storage of its own: a slice that is a view of ``whole``
    would keep the whole tensor's memory alive after it is dropped."""
    if t.untyped_storage().data_ptr() == whole.untyped_storage().data_ptr():
        return t.clone()
    return t


# the tensors of a layer that shards slice (each shard holds its part);
# the rest of a layer's tensors are replicated
TP_KEYS = ("qkv_w", "qkv_b", "proj_w", "fc1_w", "fc1_b", "fc2_w", "qkv_s",
           "fc1_s")


def _split_layer(w: dict, act: dict, cfg, mesh: Mesh, int8: bool
                 ) -> ShardedLayer:
    """Slice one layer's whole tensors ``w`` (the keys of
    :class:`ShardedLayer`, with ``qkv_s``/``fc1_s`` whole) for ``mesh``.
    Int8 slices are stored :func:`k_major` again (a slice of a k-major
    matrix is not)."""
    mp = len(mesh)
    nh, hd, f = cfg.num_heads, cfg.head_dim, cfg.ffn_size
    rows_a, cols_f = nh * hd // mp, f // mp
    rep = {}
    for d in unique_devices(mesh):
        rep[d] = {k: _on(w.get(k), d) for k in
                  ("ln1_g", "ln1_b", "ln2_g", "ln2_b", "proj_b", "fc2_b",
                   "proj_s", "fc2_s")}
    shards = []
    for i, d in enumerate(mesh):
        cols = qkv_columns(nh, hd, mp, i, w["qkv_w"].device)
        s = {"qkv_w": w["qkv_w"].index_select(-1, cols),
             "qkv_b": w["qkv_b"].index_select(-1, cols),
             "proj_w": w["proj_w"].narrow(-2, i * rows_a, rows_a),
             "fc1_w": w["fc1_w"].narrow(-1, i * cols_f, cols_f),
             "fc1_b": w["fc1_b"].narrow(-1, i * cols_f, cols_f),
             "fc2_w": w["fc2_w"].narrow(-2, i * cols_f, cols_f)}
        if int8:
            s["qkv_s"] = w["qkv_s"].index_select(-1, cols)
            s["fc1_s"] = w["fc1_s"].narrow(-1, i * cols_f, cols_f)
            for k in ("qkv_w", "proj_w", "fc1_w", "fc2_w"):
                s[k] = k_major(s[k])
        else:
            # the column slices as contiguous blocks (a strided operand
            # would be copied by every product)
            s["fc1_w"] = s["fc1_w"].contiguous()
        shards.append({k: _own(_on(v, d).contiguous() if k.endswith("_b")
                               or k.endswith("_s") else _on(v, d), w[k])
                       for k, v in s.items()})
    return ShardedLayer(rep, shards, act)


def _gather_layer(layer: ShardedLayer, cfg, device, int8: bool) -> dict:
    """The inverse of :func:`_split_layer`: the whole tensor of every key
    of :data:`TP_KEYS` the shards hold, on ``device`` (int8 matrices
    :func:`k_major`)."""
    mp = len(layer.shards)
    out = {}
    for k in TP_KEYS:
        if k not in layer.shards[0]:
            continue
        parts = [_on(sh[k], device) for sh in layer.shards]
        if k.startswith("qkv"):
            shape = parts[0].shape[:-1] + (parts[0].shape[-1] * mp,)
            t = parts[0].new_empty(shape)
            for i, p in enumerate(parts):
                t.index_copy_(t.dim() - 1, qkv_columns(
                    cfg.num_heads, cfg.head_dim, mp, i, device), p)
        else:
            t = torch.cat(parts, dim=-2 if k in ("proj_w", "fc2_w") else -1)
        out[k] = k_major(t) if int8 and k.endswith("_w") else t
    return out


def _stacked_layers(model):
    """Each layer's tensors keyed as :class:`ShardedLayer` keys them, with
    the static activation scales (None), and the owners of the
    :data:`TP_KEYS` tensors: ``{key: (module, attribute)}`` of the
    ``[L, ...]`` slabs."""
    dec = model.decoder
    int8 = dec.weight_int8
    names = {"ln1_g": "ln1_g", "ln1_b": "ln1_b", "ln2_g": "ln2_g",
             "ln2_b": "ln2_b", "qkv_b": "qkv_b", "proj_b": "proj_b",
             "fc1_b": "fc1_b", "fc2_b": "fc2_b"}
    for k in ("qkv", "proj", "fc1", "fc2"):
        names[k + "_w"] = k + ("_w_int8" if int8 else "_w")
        if int8:
            names[k + "_s"] = k + "_w_s"
    slabs = {k: getattr(dec, n) for k, n in names.items()}
    layers = [({k: v[layer] for k, v in slabs.items()},
               dict.fromkeys(("qkv", "proj", "fc1", "fc2")))
              for layer in range(model.config.num_layers)]
    return layers, {k: (dec, names[k]) for k in TP_KEYS if k in names}


def _layered_layers(model):
    """As :func:`_stacked_layers`, for the layered model: one owner map
    a layer."""
    out, owners = [], []
    for layer in model.gpt.layers:
        w = {"ln1_g": layer.ln1.weight, "ln1_b": layer.ln1.bias,
             "ln2_g": layer.ln2.weight, "ln2_b": layer.ln2.bias}
        act, own = {}, {}
        for k, lin in (("qkv", layer.attn.qkv_proj),
                       ("proj", layer.attn.out_proj),
                       ("fc1", layer.mlp.fc1), ("fc2", layer.mlp.fc2)):
            if hasattr(lin, "weight_int8"):
                w[k + "_w"], w[k + "_s"] = lin.weight_int8, lin.w_scale
                act[k] = lin._act_scale
                own[k + "_w"], own[k + "_s"] = ((lin, "weight_int8"),
                                                (lin, "w_scale"))
            else:
                w[k + "_w"] = lin.weight
                act[k] = None
                own[k + "_w"] = (lin, "weight")
            w[k + "_b"] = lin.bias
            own[k + "_b"] = (lin, "bias")
        out.append((w, act))
        owners.append({k: v for k, v in own.items() if k in TP_KEYS})
    return out, owners


def _set_tensor(owner, name: str, t: torch.Tensor):
    """Put ``t`` in place of ``owner``'s parameter or buffer ``name``."""
    if name in owner._parameters:
        old = owner._parameters[name]
        owner._parameters[name] = torch.nn.Parameter(
            t, requires_grad=old.requires_grad)
    else:
        owner._buffers[name] = t


def _drop(owner, name: str):
    """Put a ``meta`` tensor of the same shape, strides and dtype in place
    of ``owner``'s tensor ``name``: its memory is freed."""
    old = getattr(owner, name)
    _set_tensor(owner, name, torch.empty_strided(
        old.shape, old.stride(), dtype=old.dtype, device="meta"))


def _tp_owners(model) -> List[dict]:
    """The owners of the :data:`TP_KEYS` tensors: one ``{key: (module,
    attribute)}`` for the stacked model's ``[L, ...]`` slabs, one a layer
    for the layered model."""
    if model.stacked:
        return [_stacked_layers(model)[1]]
    return _layered_layers(model)[1]


def _release(model):
    """Drop the whole tensor-parallel tensors the shards now hold (and a
    quantized stacked decoder's fp slabs, which serving never reads)."""
    for own in _tp_owners(model):
        for m, n in own.values():
            _drop(m, n)
    if model.stacked and model.weight_int8:
        for n in model.decoder.QUANTIZED:
            _drop(model.decoder, n)
    model._serving_released = True


def unshard_model(model):
    """Gather a sharded model's tensor-parallel weights back from its
    shards onto ``mesh[0]`` (its device) and forget the shards: the model
    is whole again (a quantized stacked decoder's fp slabs, dropped when
    it was sharded, stay dropped: it serves only).  A no-op for a model
    that is not sharded.  Returns ``model``."""
    if not getattr(model, "_serving_released", False):
        return model
    cfg, dev = model.config, model.device
    with torch.no_grad():
        wholes = [_gather_layer(layer, cfg, dev, model.weight_int8)
                  for layer in model._serving_shards]
        if model.stacked:
            for k, (m, n) in _tp_owners(model)[0].items():
                t = torch.stack([w[k] for w in wholes])
                _set_tensor(m, n, k_major(t) if t.dtype == torch.int8
                            else t)
        else:
            for w, own in zip(wholes, _tp_owners(model)):
                for k, (m, n) in own.items():
                    _set_tensor(m, n, w[k])
    model._serving_shards = None
    model._serving_released = False
    model._serving_key = None
    return model


def _own_tensors(model) -> List[torch.Tensor]:
    """The model's parameters and buffers that hold memory (a dropped
    tensor is on ``meta``)."""
    return [t for t in list(model.parameters()) + list(model.buffers())
            if t.device.type != "meta"]


def _bytes_by_device(tensors) -> Dict[torch.device, int]:
    """Bytes of ``tensors``' storages on each device, each counted once."""
    out: Dict[torch.device, int] = {}
    seen = set()
    for t in tensors:
        st = t.untyped_storage()
        key = (t.device, st.data_ptr())
        if key not in seen:
            seen.add(key)
            out[t.device] = out.get(t.device, 0) + st.nbytes()
    return out


def weight_bytes_by_device(model) -> Dict[torch.device, int]:
    """Bytes of weights ``model`` holds on each device, each storage
    counted once: its own parameters and buffers (a dropped tensor holds
    none) and its serving shards' replicated tensors and slices."""
    tensors = _own_tensors(model)
    for layer in getattr(model, "_serving_shards", None) or ():
        for rep in layer.rep.values():
            tensors += [t for t in rep.values() if t is not None]
        for sh in layer.shards:
            tensors += list(sh.values())
    return _bytes_by_device(tensors)


def shard_weight_bytes(model) -> List[int]:
    """Weight bytes each shard's device holds when the mesh's devices are
    distinct: shard 0's device the model's own tensors (embeddings, head,
    replicated layer tensors) and its slices, shard ``i > 0``'s a copy of
    the replicated layer tensors and its slices.  One entry, the model's
    bytes, for a model that is not sharded."""
    own = sum(_bytes_by_device(_own_tensors(model)).values())
    layers = getattr(model, "_serving_shards", None)
    if not layers:
        return [own]
    rep = sum(t.numel() * t.element_size() for layer in layers
              for t in next(iter(layer.rep.values())).values()
              if t is not None)
    return [(own if i == 0 else rep)
            + sum(t.untyped_storage().nbytes() for layer in layers
                  for t in layer.shards[i].values())
            for i in range(len(layers[0].shards))]


def shard_model_for_serving(model, mesh):
    """Commit ``model`` to the replica ``mesh``: its parameters and
    buffers move to ``mesh[0]`` (and ``model.device`` with them), and with
    ``mp > 1`` every layer's column/row-parallel slices are made on their
    shards' devices (``model._serving_shards``, read by the paged
    forward) and the whole tensors they were cut from are dropped (module
    docstring).  Idempotent for one mesh and one weight dtype; a model
    sharded for another mesh, or quantized since, is gathered first
    (:func:`unshard_model`).  A model placed on a training mesh leaves
    it first (its ``leave_training_mesh``), as the reference commits its
    parameters from wherever they were placed."""
    model.leave_training_mesh()
    mesh = tuple(canonical_device(d) for d in mesh)
    mp = len(mesh)
    cfg = model.config
    if mp > 1:
        validate_head_sharding(cfg.num_heads, mp)
    key = (mesh, bool(model.weight_int8))
    if getattr(model, "_serving_key", None) == key:
        return model
    unshard_model(model)
    if canonical_device(model.device) != mesh[0]:
        model.to(mesh[0])
    model.device = mesh[0]
    model._serving_shards = None
    if mp > 1:
        split = _stacked_layers if model.stacked else _layered_layers
        with torch.no_grad():
            model._serving_shards = [
                _split_layer(w, act, cfg, mesh, model.weight_int8)
                for w, act in split(model)[0]]
        _release(model)
    model._serving_mesh = mesh
    model._serving_key = key
    return model


def shard_paged_cache(cache, mesh):
    """Split a page pool per head over ``mesh`` (the pool's head axis:
    ``[P, H, page, D]`` a layer, ``[L, P, H, page, D]`` stacked; an int8
    pool's ``[P, H]``/``[L, P, H]`` scales on the same axis): shard ``i``
    gets its own contiguous pool of ``H/mp`` heads on ``mesh[i]``, so its
    bytes are ``nbytes / mp``.  Sets ``cache.mesh_shards``.  In place;
    returns ``cache``."""
    mesh = tuple(canonical_device(d) for d in mesh)
    if len(mesh) > 1:
        validate_head_sharding(cache.num_heads, len(mesh))
    cache.shard(mesh)
    return cache


def clone_model(model, model_factory=None):
    """A fresh model with ``model``'s exact weights, on ``model``'s device
    (each dp replica owns a full copy).  A deep copy of the module (its
    parameters and buffers copied, nothing drawn or quantized again: a
    model quantized for serving gives a clone with the same int8 buffers),
    without the serving shards, which the clone makes for its own mesh;
    a sharded model's tensor-parallel weights are gathered from its
    shards into the clone.  ``model_factory`` builds the fresh instance
    instead, for classes that cannot be copied; the weights are then
    loaded into it by state-dict key (:func:`take_weights`).  A model under
    ZeRO (``group_sharded_parallel``), whose copies and hooks belong to
    its plan, gives an unplaced clone of replica 0's whole weights (its
    ``_unplaced_twin``), quantized as the model is.  The mode (train/eval)
    is copied."""
    if model_factory is None and getattr(model, "_zero_plan",
                                         None) is not None:
        fresh = model._unplaced_twin()
        if model.weight_int8:
            fresh.quantize_weights()
        return fresh.train(model.training)
    if model_factory is None:
        memo = {}
        if getattr(model, "_serving_shards", None) is not None:
            memo[id(model._serving_shards)] = None
        fresh = copy.deepcopy(model, memo)
        fresh._serving_key = None
        if getattr(model, "_serving_released", False):
            fresh._serving_shards = model._serving_shards
            unshard_model(fresh)
        return fresh
    fresh = model_factory()
    whole = model
    if getattr(model, "_serving_released", False):
        whole = clone_model(model)
    take_weights(fresh, whole)
    fresh.train(model.training)
    return fresh


@torch.no_grad()
def take_weights(fresh, model):
    """Load ``model``'s weights into ``fresh``, a new instance of its class
    (a clone, or a truncated draft: each stacked ``[L, ...]`` slab cut to
    ``fresh``'s first layers), by state-dict key through ``fresh``'s
    ``load_state_dict`` (which cuts them onto a placed model's parts), and
    quantize ``fresh`` as ``model`` is.  Where the int8 weights are state-
    dict keys (an unplaced ``fresh``) it takes the quantized structure
    first and then ``model``'s int8 values; a model placed on a training
    mesh keeps them beside its parts, so a placed ``fresh`` quantizes
    after loading the fp weights (the same values: the scales are per
    layer and channel).  A tensor ``model`` dropped (on ``meta``: a sharded
    quantized decoder's fp slabs, which serving never reads) stays as
    ``fresh`` drew it."""
    placed = getattr(fresh, "_train_mesh", None) is not None
    int8 = model.weight_int8 and not fresh.weight_int8
    if int8 and not placed:
        fresh.quantize_weights()
    src = model.state_dict()
    want = fresh.state_dict()
    lost = sorted(k for k in want if k not in src)
    if lost:
        raise ValueError(
            f"the {type(model).__name__} holds no {lost} in its state dict: "
            "a quantized model placed on a training mesh keeps its int8 "
            "weights beside its parts; build the copy under that mesh")
    fresh.load_state_dict(
        {k: src[k] if src[k].shape == t.shape else src[k][:t.shape[0]]
         for k, t in want.items() if src[k].device.type != "meta"},
        strict=False)
    if int8 and placed:
        fresh.quantize_weights()
