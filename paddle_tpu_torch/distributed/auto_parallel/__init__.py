"""auto_parallel (port of ``paddle_tpu/distributed/auto_parallel/``;
reference: Paddle's ``python/paddle/distributed/auto_parallel/``): the
annotation half -- ``ProcessMesh``, the placements, ``shard_tensor`` /
``reshard`` / ``dtensor_from_fn`` / ``shard_op``, the checkpoint
``Converter``, and sharding propagation over a captured aten graph
(``capture_graph``/``propagate_graph``, the reference's
``capture_jaxpr``/``propagate_jaxpr``) with its per-position executor
``apply_propagation`` and ``graph_cost``.  ``Engine`` and ``Strategy``
are not ported yet: they raise, naming their ROADMAP.md item."""
from .api import (  # noqa: F401
    Partial, Placement, Replicate, Shard, dtensor_from_fn, reshard, shard_op,
    shard_tensor,
)
from .converter import (  # noqa: F401
    Converter, load_distributed_checkpoint, save_distributed_checkpoint,
)
from .process_mesh import ProcessMesh  # noqa: F401
from .propagation import (  # noqa: F401
    DistSpec, PropagationResult, apply_propagation, capture_graph,
    graph_cost, parameters_as_inputs, propagate_graph,
)

_NOT_PORTED = ("auto_parallel's {} (strategy.py, planner.py, engine.py) is "
               "not ported yet: ROADMAP.md queue 1, item 9 (step 6b)")


class Engine:
    """Not ported yet (module docstring)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_NOT_PORTED.format("Engine"))


class Strategy:
    """Not ported yet (module docstring)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_NOT_PORTED.format("Strategy"))
