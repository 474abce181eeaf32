"""The device mesh (port of ``paddle_tpu/distributed/mesh.py``).

The reference keeps one global ``jax.sharding.Mesh``: a named-axis array
of devices, every "process group" a named axis of it.  The port keeps
the same thing as a named-axis array of ``torch.device``s, driven by one
process: a model placed on the mesh holds each shard as a tensor on its
device, and partial results meet in ``serving_mesh.reduce_sum``, with no
collective library.  A device may appear more than once: naming one
card n times puts n mesh positions on it together, which is how the CPU
tests (``["cpu"] * n``) and a one-card run lay out a mesh.

:class:`NamedSharding` is the counterpart of the reference's
``NamedSharding(mesh, PartitionSpec(...))``: how a batch lies over the
mesh.  :class:`PlacedTensor` is such a batch leaf, held as one block for
each distinct (block, device) pair (``io.DevicePrefetcher(sharding=)``
makes them).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import canonical_device

__all__ = ["HYBRID_AXES", "Mesh", "build_mesh", "set_mesh", "get_mesh",
           "has_mesh", "axis_size", "replica_count", "stage_devices",
           "NamedSharding", "PlacedTensor"]

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


def stage_devices(stage: int = 0, replica: int = 0, sp: int = 0) -> tuple:
    """The devices of pipeline stage ``stage`` of replica ``replica`` at
    coordinate ``sp`` of the sp axis on the global mesh, one a
    tensor-parallel shard, in shard order: where a layer of that stage
    holds its parts (``mp`` of them; one without an mp axis).  Replicas
    run over dp x sharding, dp major: replica ``d * sharding + k`` is
    position ``d`` on ``dp`` and ``k`` on ``sharding``."""
    grid = get_mesh().grid(("dp", "sharding", "pp", "sep", "sp", "mp"))
    grid = grid.reshape((-1,) + grid.shape[2:])
    return tuple(grid[replica, stage, 0, sp, :])


# ---------------------------------------------------------------------------
# batches placed over a mesh
# ---------------------------------------------------------------------------

class NamedSharding:
    """How a leaf lies over ``mesh`` (default: the global mesh): ``spec``
    names, for each leading dimension, a mesh axis, a tuple of axes (the
    dimension cut over their product, the first axis major, as a
    ``PartitionSpec`` entry cuts it) or None (whole).  Axes the spec does
    not name replicate: every position along them holds the same block.
    A spec that is not a tuple or list raises ``TypeError``; an axis the
    mesh lacks, or one named twice, ``ValueError``."""

    def __init__(self, mesh: Optional[Mesh] = None, spec=()):
        if not isinstance(spec, (tuple, list)):
            raise TypeError(f"sharding spec {spec!r}: expected a tuple of "
                            "mesh axes, tuples of axes or None, one a "
                            "leading dimension")
        self.mesh = get_mesh() if mesh is None else mesh
        dims, seen = [], set()
        for entry in spec:
            axes = ((entry,) if isinstance(entry, str) else
                    () if entry is None else entry)
            if not isinstance(axes, (tuple, list)) or not all(
                    isinstance(a, str) for a in axes):
                raise TypeError(f"sharding spec {tuple(spec)!r}: entry "
                                f"{entry!r} is not an axis name, a tuple of "
                                "them or None")
            for a in axes:
                if a not in self.mesh.axis_names:
                    raise ValueError(f"sharding spec {tuple(spec)!r}: the "
                                     f"mesh has no axis {a!r} (axes "
                                     f"{self.mesh.axis_names})")
                if a in seen:
                    raise ValueError(f"sharding spec {tuple(spec)!r} names "
                                     f"axis {a!r} twice")
                seen.add(a)
            dims.append(tuple(axes))
        self.spec = tuple(dims)

    def cuts(self, shape) -> Tuple[int, ...]:
        """The blocks along each dimension the spec names, for a leaf of
        ``shape``; a rank below the spec's, or a dimension its axes do not
        divide, raises ``ValueError`` (as ``jax.device_put`` refuses)."""
        if len(shape) < len(self.spec):
            raise ValueError(f"sharding spec {self.spec} names "
                             f"{len(self.spec)} dimensions; the leaf has "
                             f"shape {tuple(shape)}")
        sizes = self.mesh.shape
        out = []
        for k, axes in enumerate(self.spec):
            n = int(np.prod([sizes[a] for a in axes], dtype=np.int64))
            if shape[k] % n:
                raise ValueError(
                    f"dimension {k} of shape {tuple(shape)} is not divisible "
                    f"by {n}, the size of mesh axes {axes}")
            out.append(n)
        return tuple(out)

    def positions(self):
        """``(coordinates, device)`` of every mesh position, in the mesh's
        row-major order."""
        for coords in np.ndindex(*self.mesh.devices.shape):
            yield coords, self.mesh.devices[coords]

    def block_of(self, coords) -> Tuple[int, ...]:
        """The block index along each named dimension held at the mesh
        position ``coords``."""
        sizes, names = self.mesh.shape, self.mesh.axis_names
        out = []
        for axes in self.spec:
            i = 0
            for a in axes:
                i = i * sizes[a] + int(coords[names.index(a)])
            out.append(i)
        return tuple(out)

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec})"


class PlacedTensor:
    """A leaf of ``shape`` placed by ``sharding``: ``blocks[(block index,
    device)]`` holds each distinct block once on each device of the
    positions that hold it.  It stands for the whole tensor.  A model's
    placed forward reads each part where it lies (:meth:`take`); any
    other consumer -- a torch function, a tensor method, an operator, an
    index -- gets the whole tensor, gathered on the first position's
    device (:meth:`gather`) once and kept."""

    def __init__(self, sharding: NamedSharding, shape, dtype, blocks):
        self.sharding = sharding
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.blocks = dict(blocks)
        self.cuts = sharding.cuts(self.shape)
        self.wholes = {}          # device -> the gathered whole there

    @property
    def device(self) -> torch.device:
        return next(iter(self.sharding.positions()))[1]

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def dim(self) -> int:
        return len(self.shape)

    def size(self, dim: Optional[int] = None):
        return self.shape if dim is None else self.shape[dim]

    def block(self, index, device) -> torch.Tensor:
        """Block ``index`` on ``device``: its copy there, else a copy of
        another device's."""
        device = canonical_device(device)
        t = self.blocks.get((tuple(index), device))
        if t is not None:
            return t
        for (idx, _), t in self.blocks.items():
            if idx == tuple(index):
                return t.to(device)
        raise KeyError(f"no block {tuple(index)}")

    def on(self, coords) -> torch.Tensor:
        """The block the mesh position ``coords`` holds, on its device."""
        coords = tuple(coords)
        return self.block(self.sharding.block_of(coords),
                          self.sharding.mesh.devices[coords])

    def take(self, dim: int, lo: int, hi: int, device) -> torch.Tensor:
        """Elements ``lo .. hi - 1`` along ``dim`` on ``device``: a view of
        the block there when one block along ``dim`` holds them and no
        other dimension is cut, else from the gathered whole."""
        cuts = self.cuts + (1,) * (len(self.shape) - len(self.cuts))
        if all(n == 1 for k, n in enumerate(cuts) if k != dim):
            size = self.shape[dim] // cuts[dim]
            k = lo // size
            if (hi - 1) // size == k:
                idx = tuple(k if j == dim else 0
                            for j in range(len(self.cuts)))
                return self.block(idx, device).narrow(dim, lo - k * size,
                                                      hi - lo)
        return self.gather(device).narrow(dim, lo, hi - lo)

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: the first position's),
        the blocks joined in order; built once a device and kept."""
        device = self.device if device is None else canonical_device(device)
        if device not in self.wholes:
            self.wholes[device] = self._join((), device)
        return self.wholes[device]

    def _join(self, prefix, device) -> torch.Tensor:
        """The blocks whose index starts with ``prefix`` joined along the
        remaining cut dimensions (a method, not a nested closure: a
        closure that calls itself is a reference cycle, which would keep
        the gathered whole, and any autograd graph it carries, until a
        garbage collection)."""
        k = len(prefix)
        if k == len(self.cuts):
            return self.block(prefix, device)
        parts = [self._join(prefix + (i,), device)
                 for i in range(self.cuts[k])]
        return parts[0] if len(parts) == 1 else torch.cat(parts, k)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        def whole(x):
            if isinstance(x, PlacedTensor):
                return x.gather()
            if isinstance(x, (list, tuple)):
                return type(x)(whole(v) for v in x)
            return x
        return func(*whole(args), **{k: whole(v)
                                     for k, v in (kwargs or {}).items()})

    def __getattr__(self, name):
        # only names the class lacks land here; its own fields missing
        # (a half-built copy) must not recurse through gather()
        if name.startswith("__") or name in ("sharding", "shape", "dtype",
                                             "blocks", "cuts", "wholes"):
            raise AttributeError(name)
        return getattr(self.gather(), name)

    def __getitem__(self, index):
        return self.gather()[index]

    def __len__(self):
        return self.shape[0]

    def __array__(self, dtype=None):
        a = self.gather().cpu().numpy()
        return a if dtype is None else a.astype(dtype)

    def __repr__(self):
        return (f"PlacedTensor(shape={tuple(self.shape)}, dtype={self.dtype}"
                f", spec={self.sharding.spec}, {len(self.blocks)} blocks)")

    __hash__ = object.__hash__


def _whole_op(name):
    def op(self, *args):
        return getattr(self.gather(), name)(*args)
    op.__name__ = name
    return op


# the operators, on the whole tensor
for _name in ("add", "radd", "sub", "rsub", "mul", "rmul", "truediv",
              "rtruediv", "floordiv", "rfloordiv", "mod", "pow", "matmul",
              "rmatmul", "and", "or", "xor", "eq", "ne", "lt", "le", "gt",
              "ge", "neg", "invert", "abs"):
    setattr(PlacedTensor, f"__{_name}__", _whole_op(f"__{_name}__"))
