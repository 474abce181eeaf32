"""The device mesh (port of ``paddle_tpu/distributed/mesh.py``).

The reference keeps one global ``jax.sharding.Mesh``: a named-axis array
of devices, every "process group" a named axis of it.  The port keeps
the same thing as a named-axis array of ``torch.device``s, driven by one
process: a model placed on the mesh holds each shard as a tensor on its
device, and partial results meet in ``serving_mesh.reduce_sum``, with no
collective library.  A device may appear more than once: naming one
card n times puts n mesh positions on it together, which is how the CPU
tests (``["cpu"] * n``) and a one-card run lay out a mesh.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..core import canonical_device

__all__ = ["HYBRID_AXES", "Mesh", "build_mesh", "set_mesh", "get_mesh",
           "has_mesh", "axis_size", "replica_count", "stage_devices"]

# canonical axis order for hybrid parallelism (the reference's topology
# order: data, pipe, sharding, sep, model)
HYBRID_AXES = ("dp", "pp", "sharding", "sep", "mp")


class Mesh:
    """``devices``: an object array of ``torch.device``s, one axis per
    name of ``axis_names`` (``shape`` maps each name to its size, as
    ``jax.sharding.Mesh.shape`` does)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim} device axes for axis names "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def grid(self, names: Sequence[str]) -> np.ndarray:
        """The devices as an array over the axes ``names``, in that order:
        an axis the mesh lacks has size 1; every axis of the mesh must be
        named or have size 1."""
        extra = [a for a in self.axis_names
                 if a not in names and self.shape[a] > 1]
        if extra:
            raise ValueError(f"mesh axes {extra} are not among {tuple(names)}")
        arr = self.devices.reshape([self.shape[a] for a in self.axis_names
                                    if a in names])
        have = [a for a in self.axis_names if a in names]
        arr = np.transpose(arr, [have.index(a) for a in names if a in have])
        return arr.reshape([self.shape.get(a, 1) for a in names])

    def __repr__(self):
        return f"Mesh({self.shape}, devices={self.devices.ravel().tolist()})"


_global_mesh: Optional[Mesh] = None


def _visible_cards():
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def build_mesh(axes: Dict[str, int], devices: Optional[Sequence] = None
               ) -> Mesh:
    """A :class:`Mesh` from ``{axis_name: size}`` over the first
    ``prod(sizes)`` entries of ``devices`` (default: the visible cards,
    one each), laid out row-major in the order of ``axes``.  Too few
    devices raise and say how many were found; nothing falls back to the
    CPU.  Naming a device more than once puts mesh positions on it
    together."""
    devs = _visible_cards() if devices is None else list(devices)
    shape = [max(1, int(s)) for s in axes.values()]
    need = int(np.prod(shape))
    if need > len(devs):
        where = "visible CUDA devices" if devices is None else "devices"
        raise ValueError(f"mesh needs {need} devices, have {len(devs)} "
                         f"{where}; name a device more than once to put "
                         "mesh positions on it together")
    arr = np.empty(need, dtype=object)
    for i, d in enumerate(devs[:need]):
        arr[i] = canonical_device(d)
    return Mesh(arr.reshape(shape), tuple(axes.keys()))


def set_mesh(mesh: Optional[Mesh]):
    global _global_mesh
    _global_mesh = mesh


def get_mesh() -> Mesh:
    """The mesh :func:`set_mesh` set; without one, a ``("dp",)`` mesh over
    the visible cards (none raise), as the reference's default."""
    global _global_mesh
    if _global_mesh is None:
        devs = _visible_cards()
        if not devs:
            raise RuntimeError("get_mesh: no mesh is set and no CUDA device "
                               "is visible; build_mesh(..., devices=[...]) "
                               "names the devices")
        _global_mesh = build_mesh({"dp": len(devs)}, devs)
    return _global_mesh


def has_mesh() -> bool:
    return _global_mesh is not None


def axis_size(axis: str) -> int:
    mesh = get_mesh()
    return mesh.shape.get(axis, 1)


def replica_count() -> int:
    """The data replicas the global mesh asks for: dp x sharding (a
    ``sharding`` axis is a data axis, as in Paddle's hybrid topology;
    ZeRO cuts state over it, ``distributed.sharding``); 1 without a
    mesh."""
    if not has_mesh():
        return 1
    return axis_size("dp") * axis_size("sharding")


def stage_devices(stage: int = 0, replica: int = 0) -> tuple:
    """The devices of pipeline stage ``stage`` of replica ``replica`` on
    the global mesh, one a tensor-parallel shard, in shard order: where a
    layer of that stage holds its parts (``mp`` of them; one without an
    mp axis).  Replicas run over dp x sharding, dp major: replica ``d *
    sharding + k`` is position ``d`` on ``dp`` and ``k`` on
    ``sharding``."""
    grid = get_mesh().grid(("dp", "sharding", "pp", "sep", "sp", "mp"))
    grid = grid.reshape((-1,) + grid.shape[2:])
    return tuple(grid[replica, stage, 0, 0, :])
