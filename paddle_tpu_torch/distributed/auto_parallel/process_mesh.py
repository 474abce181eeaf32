"""ProcessMesh (port of ``paddle_tpu/distributed/auto_parallel/
process_mesh.py``; reference: Paddle's ``auto_parallel/process_mesh.py``).

A thin wrapper over the port's own :class:`~paddle_tpu_torch.distributed.
mesh.Mesh` carrying the reference API.  Process id ``i`` maps to visible
card ``i % n_cards``, as the reference maps ids onto ``jax.devices()``:
on one card every position is ``cuda:0``.  ``device`` names one device
for every position instead (``device="cpu"`` lays a mesh out as the CPU
tests do, ``["cpu"] * n``).  Without a card and without ``device`` it
raises; nothing falls back to the CPU.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .. import mesh as _mesh
from ...core import canonical_device

__all__ = ["ProcessMesh"]


class ProcessMesh:
    def __init__(self, mesh: Sequence, dim_names: Optional[List[str]] = None,
                 process_ids=None, device=None):
        arr = np.asarray(mesh)
        self._shape = list(arr.shape)
        self._process_ids = arr.flatten().tolist()
        if dim_names is None:
            dim_names = [f"d{i}" for i in range(arr.ndim)]
        self._dim_names = list(dim_names)
        if device is not None:
            devs = [canonical_device(device)] * len(self._process_ids)
        else:
            cards = _mesh._visible_cards()
            if not cards:
                raise RuntimeError("ProcessMesh: no CUDA device is visible; "
                                   "pass device='cpu' to lay the mesh out "
                                   "on the CPU")
            devs = [cards[i % len(cards)] for i in self._process_ids]
        dev_arr = np.empty(len(devs), dtype=object)
        for i, d in enumerate(devs):
            dev_arr[i] = d
        self._mesh = _mesh.Mesh(dev_arr.reshape(self._shape),
                                tuple(self._dim_names))

    @property
    def shape(self):
        return self._shape

    @property
    def process_ids(self):
        return self._process_ids

    @property
    def dim_names(self):
        return self._dim_names

    @property
    def ndim(self):
        return len(self._shape)

    @property
    def mesh(self) -> _mesh.Mesh:
        """The port's device mesh (the reference's ``jax_mesh``)."""
        return self._mesh

    def activate(self):
        """Install as the global mesh (``mesh.set_mesh``)."""
        _mesh.set_mesh(self._mesh)
        return self

    def get_dim_size(self, name):
        return self._shape[self._dim_names.index(name)]

    def __eq__(self, other):
        return (isinstance(other, ProcessMesh)
                and self._shape == other._shape
                and self._process_ids == other._process_ids)

    __hash__ = object.__hash__

    def __repr__(self):
        return f"ProcessMesh(shape={self._shape}, dim_names={self._dim_names})"
