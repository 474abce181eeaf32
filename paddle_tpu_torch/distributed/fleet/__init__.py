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

Not ported, and raising: ZeRO (sharding > 1) and sequence parallelism
(sep > 1) through the wrappers (ROADMAP.md queue 1, item 9, steps 2 and
3); the parameter-server calls (item 10).
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
    """The wrapper the topology asks for: ``PipelineParallel`` at pp > 1
    (its ``PipelineLayer`` holds the dp replicas), ``TensorParallel`` at
    mp > 1, ``DataParallel`` at dp > 1, else ``model`` itself."""
    hcg = get_hybrid_communicate_group()
    if hcg is None:
        return model
    big = {name: n for name, n in (
        ("sharding", hcg.get_sharding_parallel_world_size()),
        ("sep", hcg.get_sep_parallel_world_size())) if n > 1}
    if big:
        raise NotImplementedError(
            f"fleet.distributed_model at {big}: ZeRO (sharding, step 2) and "
            "sequence parallelism (sep, step 3) through the fleet wrappers "
            "are not ported (ROADMAP.md queue 1, item 9)")
    mode = hcg.get_parallel_mode()
    if mode == "pipeline":
        return PipelineParallel(model, hcg, _user_strategy)
    if mode == "model":
        return TensorParallel(model, hcg)
    if hcg.get_data_parallel_world_size() > 1:
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
