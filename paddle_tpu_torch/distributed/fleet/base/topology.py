"""The hybrid-parallel topology (port of
``paddle_tpu/distributed/fleet/base/topology.py``).

``CommunicateTopology`` is the reference's rank arithmetic over the named
axes.  ``HybridCommunicateGroup`` keeps the degrees, the parallel mode
and the ranks one controller sees (rank 0 of each axis), and owns the
global mesh (``distributed.mesh``) in the reference's axis order: dp,
pp, sharding, sep, mp.  A mesh already set is held to the degrees (this
is how one card takes several positions: ``set_mesh(build_mesh({"pp": 2,
"mp": 2}, ["cuda:0"] * 4))``); otherwise the mesh is built over the
visible cards, and too few raise.  One process drives every position, so
there is no communicator to set up and no group object.
"""
from __future__ import annotations

import itertools
from typing import Optional

import numpy as np

from ... import mesh as _mesh

__all__ = ["CommunicateTopology", "HybridCommunicateGroup",
           "get_hybrid_communicate_group", "set_hybrid_communicate_group"]


class CommunicateTopology:
    def __init__(self, hybrid_group_names=("data", "pipe", "sharding", "sep",
                                           "model"),
                 dims=(1, 1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(dims)
        self.coordinate = None
        self._world = int(np.prod(self._dims))

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self):
        return self._world

    def get_rank(self, **kwargs):
        coords = [kwargs[n] for n in self._parallel_names]
        return int(np.ravel_multi_index(coords, self._dims))

    def get_coord(self, rank):
        return tuple(np.unravel_index(rank, self._dims))

    def get_axis_list(self, axis_name, index):
        axis = self._parallel_names.index(axis_name)
        ranks = [
            self.get_rank(**dict(zip(self._parallel_names, coord)))
            for coord in itertools.product(*[range(d) for d in self._dims])
            if coord[axis] == index
        ]
        return sorted(ranks)

    def get_comm_list(self, axis_name):
        axis = self._parallel_names.index(axis_name)
        other_dims = [d for i, d in enumerate(self._dims) if i != axis]
        lists = []
        for other_coord in itertools.product(*[range(d) for d in other_dims]):
            ranks = []
            for k in range(self._dims[axis]):
                coord = list(other_coord)
                coord.insert(axis, k)
                ranks.append(self.get_rank(**dict(zip(self._parallel_names,
                                                      coord))))
            lists.append(ranks)
        return lists


# topology axis name -> mesh axis name
_AXIS_MAP = {"data": "dp", "pipe": "pp", "sharding": "sharding", "sep": "sep",
             "model": "mp"}


def _hold_mesh(axes):
    """The global mesh for the degrees ``axes`` ({mesh axis: size}, in
    topology order): the one already set, if its axes have these sizes
    (an axis it lacks has size 1; any other axis must have size 1), else
    one built over the visible cards."""
    if not _mesh.has_mesh():
        _mesh.set_mesh(_mesh.build_mesh(axes))
        return
    shape = _mesh.get_mesh().shape
    wrong = {a: shape.get(a, 1) for a, n in axes.items()
             if shape.get(a, 1) != n}
    wrong.update({a: n for a, n in shape.items()
                  if a not in axes and n > 1})
    if wrong:
        raise ValueError(f"fleet.init: the mesh already set has axes "
                         f"{shape}, the strategy's degrees are {axes} "
                         f"(they part at {wrong}); set a mesh of these "
                         "degrees, or none")


class HybridCommunicateGroup:
    """The degrees of each axis and the controller's view of the ranks
    (rank 0 of each axis), over the global mesh (module docstring)."""

    def __init__(self, topology: CommunicateTopology):
        self._topo = topology
        names = topology.get_hybrid_group_names()

        def degree(name):
            return topology.get_dim(name) if name in names else 1

        self._dp_degree = degree("data")
        self._pp_degree = degree("pipe")
        self._sharding_degree = degree("sharding")
        self._sep_degree = degree("sep")
        self._mp_degree = degree("model")
        _hold_mesh({_AXIS_MAP.get(n, n): topology.get_dim(n) for n in names})
        self.global_rank = 0

    def get_parallel_mode(self):
        if self._pp_degree > 1:
            return "pipeline"
        if self._mp_degree > 1:
            return "model"
        if self._sharding_degree > 1:
            return "sharding"
        return "data"

    def topology(self):
        return self._topo

    def get_global_rank(self):
        return self.global_rank

    # data parallel
    def get_data_parallel_rank(self):
        return 0

    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_data_parallel_group_src_rank(self):
        return 0

    # model parallel
    def get_model_parallel_rank(self):
        return 0

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_model_parallel_group_src_rank(self):
        return 0

    # pipeline
    @property
    def stage_id(self):
        return 0

    def get_stage_id(self):
        return 0

    def get_pipe_parallel_rank(self):
        return 0

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    # sharding
    def get_sharding_parallel_rank(self):
        return 0

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    def get_sharding_parallel_group_src_rank(self):
        return 0

    # sep
    def get_sep_parallel_rank(self):
        return 0

    def get_sep_parallel_world_size(self):
        return self._sep_degree

    def get_rank_from_stage(self, stage_id, **kwargs):
        return stage_id


_hcg: Optional[HybridCommunicateGroup] = None


def set_hybrid_communicate_group(hcg):
    global _hcg
    _hcg = hcg


def get_hybrid_communicate_group() -> Optional[HybridCommunicateGroup]:
    return _hcg
