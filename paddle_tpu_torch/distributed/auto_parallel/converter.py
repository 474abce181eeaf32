"""Checkpoint reshard converter (port of
``paddle_tpu/distributed/auto_parallel/converter.py``; reference: Paddle's
``auto_parallel/static/converter.py`` and ``dist_saver.py``).

A distributed checkpoint is a directory holding ``shards.npz`` (one array
a distinct block) and ``meta.json``: for each tensor its ``global_shape``,
``dtype``, ``spec`` (one entry a dimension: an axis name, a list of them,
or null) and ``shards`` (each an ``id`` in the npz and the ``index`` of
its global slice, ``[start, stop]`` a dimension, ``[null, null]`` for the
whole).  The format is the JAX package's, so a checkpoint written by
either package loads in the other.  Saving a placed tensor writes each
distinct block once, with its global slice; loading merges the blocks
into the global tensor, checks that they tile it, and places it under the
current mesh.

bfloat16: numpy has no bfloat16.  The JAX package's ``np.savez`` of an
``ml_dtypes`` bfloat16 array records it as raw 2-byte words (descr
``<V2``) beside ``"dtype": "bfloat16"``; ``np.load`` gives them back as
``|V2``.  The port reads such words as ``torch.bfloat16`` bits, and
writes bfloat16 the same way.  ``merge`` returns a torch tensor on the
CPU (numpy cannot hold a bfloat16 result).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import mesh as _mesh
from ..mesh import NamedSharding, PlacedTensor
from .api import _place

__all__ = ["Converter", "save_distributed_checkpoint",
           "load_distributed_checkpoint"]


def _index_to_json(idx) -> List[List[Optional[int]]]:
    return [[None if sl.start is None else int(sl.start),
             None if sl.stop is None else int(sl.stop)] for sl in idx]


def _json_to_index(spec) -> Tuple[slice, ...]:
    return tuple(slice(a, b) for a, b in spec)


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(the array ``shards.npz`` holds, the dtype name ``meta.json``
    records): bfloat16 as raw 2-byte words."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2"), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _to_torch(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        if a.dtype.itemsize != 2:
            raise ValueError(f"a bfloat16 shard holds {a.dtype} values; "
                             "expected 2-byte words")
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)) \
            .view(torch.bfloat16)
    return torch.from_numpy(np.asarray(a, dtype=np.dtype(dtype)))


def _spec_to_json(spec):
    """A :class:`NamedSharding` spec as the JAX package records a
    ``PartitionSpec``: a name, a list of names, or null, a dimension."""
    return [None if not axes else axes[0] if len(axes) == 1
            else list(axes) for axes in spec]


def _blocks_of(t: PlacedTensor):
    """(global index, block) of each distinct block of ``t``."""
    seen = {}
    for (idx, _), b in t.blocks.items():
        if idx not in seen:
            seen[idx] = b
    ndim = len(t.shape)
    for idx, b in seen.items():
        index = []
        for k in range(ndim):
            n = t.cuts[k] if k < len(t.cuts) else 1
            if n == 1:
                index.append(slice(None, None))
            else:
                size = t.shape[k] // n
                index.append(slice(idx[k] * size, (idx[k] + 1) * size))
        yield tuple(index), b


def save_distributed_checkpoint(state_dict: Dict[str, torch.Tensor],
                                path: str, extra_meta: Optional[dict] = None):
    """Save a state dict of tensors and placed tensors as shard arrays and
    metadata (reference analog: ``DistributedSaver.save`` with per-rank
    files).  A placed tensor contributes each distinct block once with its
    global slice; a plain tensor one shard covering it."""
    os.makedirs(path, exist_ok=True)
    meta = {"tensors": {}, "extra": extra_meta or {}}
    arrays = {}
    for name, t in state_dict.items():
        if isinstance(t, np.ndarray):
            t = torch.from_numpy(t)
        entries, dtype = [], None
        if isinstance(t, PlacedTensor):
            shards = list(_blocks_of(t))
            spec = _spec_to_json(t.sharding.spec)
        else:
            shards = [(tuple(slice(0, d) for d in t.shape), t)]
            spec = None
        for index, block in shards:
            sid = f"{name}::{len(entries)}"
            arrays[sid], dtype = _to_numpy(block)
            entries.append({"id": sid, "index": _index_to_json(index)})
        meta["tensors"][name] = {
            "global_shape": [int(d) for d in t.shape],
            "dtype": dtype,
            "spec": spec,
            "shards": entries,
        }
    np.savez(os.path.join(path, "shards.npz"), **arrays)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)


class Converter:
    """Merge shard sets into global tensors and place them for a new
    parallel config (reference ``converter.py`` ``Converter.convert``:
    ``merge_with_dist_attr`` + ``slice_with_dist_attr``)."""

    def __init__(self, shard_arrays: Dict[str, np.ndarray], meta: dict):
        self._arrays = shard_arrays
        self._meta = meta

    @classmethod
    def load(cls, path: str) -> "Converter":
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        with np.load(os.path.join(path, "shards.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        return cls(arrays, meta)

    def tensor_names(self):
        return list(self._meta["tensors"].keys())

    def merge(self, name: str) -> torch.Tensor:
        """The GLOBAL tensor from its shards by slice index, on the CPU.
        The shards must tile the global shape, checked arithmetically
        (volume sum and pairwise-disjoint boxes, the reference's check):
        a shard set where each process saved only its local blocks would
        otherwise give silently corrupted weights."""
        info = self._meta["tensors"][name]
        gshape = tuple(info["global_shape"])
        parts = [(_json_to_index(e["index"]),
                  _to_torch(self._arrays[e["id"]], info["dtype"]))
                 for e in info["shards"]]
        out = torch.empty(gshape, dtype=parts[0][1].dtype if parts
                          else torch.float32)
        boxes = []
        for idx, part in parts:
            out[idx] = part
            full = idx + tuple(slice(None)
                               for _ in range(len(gshape) - len(idx)))
            bounds = []
            for d, sl in enumerate(full):
                start, stop, step = sl.indices(gshape[d])
                if step != 1:
                    raise ValueError(f"non-unit-stride shard slice for "
                                     f"'{name}'")
                bounds.append((start, stop))
            boxes.append(bounds)
        total = sum(int(np.prod([max(0, b - a) for a, b in box],
                                dtype=np.int64)) for box in boxes)
        volume = int(np.prod(gshape, dtype=np.int64))
        overlap = any(
            all(a1 < b2 and a2 < b1 for (a1, b1), (a2, b2) in zip(x, y))
            for i, x in enumerate(boxes) for y in boxes[i + 1:])
        if total != volume or overlap:
            raise ValueError(
                f"checkpoint shard set for '{name}' does not tile the "
                f"global shape {info['global_shape']} (shard volume {total} "
                f"vs {volume}, overlap={overlap}) — on multi-host jobs "
                "every process must save to its OWN directory, or rank 0 "
                "must save fully-addressable arrays")
        return out

    def convert(self, target_specs: Optional[Dict[str, tuple]] = None):
        """A state dict for the CURRENT mesh: each merged tensor placed
        with ``target_specs[name]`` when given, else with the checkpoint's
        recorded spec when every axis it names is on the mesh, else
        replicated; with no mesh set, plain tensors on the CPU."""
        out = {}
        mesh = _mesh.get_mesh() if _mesh.has_mesh() else None
        for name in self.tensor_names():
            merged = self.merge(name)
            spec = None
            if target_specs and name in target_specs:
                spec = tuple(target_specs[name])
            else:
                rec = self._meta["tensors"][name].get("spec")
                if rec is not None:
                    flat = tuple(tuple(p) if isinstance(p, list) else p
                                 for p in rec)
                    usable = mesh is not None and all(
                        ax is None or ax in mesh.axis_names
                        for p in flat
                        for ax in (p if isinstance(p, tuple) else (p,)))
                    spec = flat if usable else None
            if mesh is None:
                out[name] = merged
            else:
                out[name] = _place(merged, NamedSharding(mesh, spec or ()))
        return out


def load_distributed_checkpoint(path: str,
                                target_specs: Optional[Dict[str, tuple]] = None
                                ) -> Dict[str, torch.Tensor]:
    """Load a distributed checkpoint into the CURRENT mesh -- the TP=2 ->
    TP=4 / PP on<->off reshard path (reference
    ``load_checkpoint_into_program`` + ``Converter.convert``)."""
    return Converter.load(path).convert(target_specs)
