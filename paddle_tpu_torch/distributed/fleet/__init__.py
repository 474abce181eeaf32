"""The fleet API (port of ``paddle_tpu/distributed/fleet``): ``init``,
``distributed_model``, ``distributed_optimizer``, ``recompute`` and the
worker queries.

One process drives every mesh position: ``init`` holds the global mesh
to the strategy's ``hybrid_configs`` (``base/topology.py``), the mpu
layers cut the weights over its ``mp`` axis, ``PipelineLayer`` places
chunks on its ``pp`` axis and replicas on its ``dp`` axis, and
``PipelineParallel.train_batch`` runs 1F1B (interleaved with virtual
stages).  The recipe on one card::

    from paddle_tpu_torch.distributed import fleet, mesh
    mesh.set_mesh(mesh.build_mesh({"dp": 2, "pp": 2, "mp": 2},
                                  ["cuda:0"] * 8))
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 2, "pp_degree": 2,
                               "mp_degree": 2}
    strategy.pipeline_configs = {"accumulate_steps": 4,
                                 "micro_batch_size": 2}
    fleet.init(is_collective=True, strategy=strategy)
    model = fleet.distributed_model(PipelineLayer(...))
    opt = fleet.distributed_optimizer(AdamW(...))
    loss = model.train_batch((ids, labels), opt)

A ``sharding`` axis is a data axis: the wrappers hold replicas over dp x
sharding, and ``distributed.sharding.group_sharded_parallel`` cuts
their optimizer state, gradients and parameters over it (ZeRO).  A
``sep`` axis is a mesh axis no wrapper or model reads, as in the
reference: the result is the run's without it (sequence parallelism is
the layered GPT's, on an ``sp`` axis with ``sequence_parallel``).  Not
ported, and raising: the parameter-server calls (ROADMAP.md queue 1,
item 10).
"""
from __future__ import annotations

from typing import Optional

from .base.distributed_strategy import DistributedStrategy
from .base.topology import (
    CommunicateTopology, HybridCommunicateGroup,
    get_hybrid_communicate_group, set_hybrid_communicate_group,
)
from . import meta_optimizers, meta_parallel  # noqa: F401
from .meta_optimizers import apply_strategy_meta_optimizers
from .meta_parallel import (  # noqa: F401
    HybridParallelOptimizer, PipelineLayer, PipelineParallel, TensorParallel,
)
from .recompute import recompute, recompute_sequential  # noqa: F401
from ..parallel import DataParallel

__all__ = ["DistributedStrategy", "CommunicateTopology",
           "HybridCommunicateGroup", "get_hybrid_communicate_group",
           "set_hybrid_communicate_group", "init", "distributed_model",
           "distributed_optimizer", "worker_index", "worker_num",
           "is_first_worker", "init_server", "run_server", "stop_worker",
           "barrier_worker", "save_model", "recompute",
           "recompute_sequential"]

_user_strategy: Optional[DistributedStrategy] = None


def init(role_maker=None, is_collective=False, strategy=None,
         log_level="INFO"):
    """Set the hybrid topology of ``strategy.hybrid_configs`` (its
    ``order``, default dp, pp, sharding, sep, mp) and the global mesh:
    the one already set, which must have those degrees, or one over the
    visible cards (too few raise)."""
    global _user_strategy
    strategy = strategy or DistributedStrategy()
    _user_strategy = strategy
    hc = strategy.hybrid_configs
    order = hc.get("order", ["dp", "pp", "sharding", "sep", "mp"])
    names = {"dp": "data", "pp": "pipe", "sharding": "sharding",
             "sep": "sep", "mp": "model"}
    topo = CommunicateTopology([names[o] for o in order],
                               [int(hc.get(f"{o}_degree", 1)) for o in order])
    set_hybrid_communicate_group(HybridCommunicateGroup(topo))


def is_first_worker():
    return worker_index() == 0


def worker_index():
    """0: one process drives every position."""
    return 0


def worker_num():
    """1: one process drives every position."""
    return 1


def distributed_model(model):
    """The wrapper the topology asks for, in the reference's order:
    ``PipelineParallel`` at pp > 1 (its ``PipelineLayer`` holds the
    replicas), ``TensorParallel`` at mp > 1, ``DataParallel`` over the dp
    x sharding replicas at sharding > 1 or dp > 1, else ``model``
    itself.  sep is not read (the reference's has no sep branch)."""
    hcg = get_hybrid_communicate_group()
    if hcg is None:
        return model
    mode = hcg.get_parallel_mode()
    if mode == "pipeline":
        return PipelineParallel(model, hcg, _user_strategy)
    if mode == "model":
        return TensorParallel(model, hcg)
    if mode == "sharding" or hcg.get_data_parallel_world_size() > 1:
        return DataParallel(model)
    return model


def distributed_optimizer(optimizer, strategy=None):
    """The reference's meta-optimizer selection pass over ``optimizer``
    (``meta_optimizers.apply_strategy_meta_optimizers``: ``lars``,
    ``dgc``, ``localsgd``, ``gradient_merge``), in a
    ``HybridParallelOptimizer`` when a topology is set."""
    strategy = strategy or _user_strategy
    optimizer = apply_strategy_meta_optimizers(optimizer, strategy)
    hcg = get_hybrid_communicate_group()
    if hcg is None:
        return optimizer
    return HybridParallelOptimizer(optimizer, hcg, strategy)


def _parameter_server(what):
    raise NotImplementedError(f"fleet.{what}: the parameter-server mode is "
                              "not ported (ROADMAP.md queue 1, item 10)")


def init_server(*args, **kwargs):
    _parameter_server("init_server")


def run_server():
    _parameter_server("run_server")


def stop_worker():
    pass


def barrier_worker():
    """Nothing to wait for: one process."""


def save_model(path, mode=0):
    raise NotImplementedError(
        "fleet.save_model is not ported (ROADMAP.md queue 1, item 10): "
        "save model.state_dict() with torch.save")
