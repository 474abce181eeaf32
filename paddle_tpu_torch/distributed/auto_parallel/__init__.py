"""auto_parallel (port of ``paddle_tpu/distributed/auto_parallel/``;
reference: Paddle's ``python/paddle/distributed/auto_parallel/``).

- The annotation half: ``ProcessMesh``, the placements,
  ``shard_tensor`` / ``reshard`` / ``dtensor_from_fn`` / ``shard_op``,
  the checkpoint ``Converter``, and sharding propagation over a captured
  aten graph (``capture_graph``/``propagate_graph``, the reference's
  ``capture_jaxpr``/``propagate_jaxpr``) with its per-position executor
  ``apply_propagation`` (a forward, or with ``grad=True`` a step
  autograd differentiates) and ``graph_cost``.
- The semi-auto half: ``Strategy``, the planner (``ModelSpec``,
  ``ClusterSpec`` with an H100 host's defaults, ``plan``) and
  ``Engine``, whose ``plan()`` picks and installs a mesh and whose
  ``fit`` trains through the executor on the flash kernels.
"""
from .api import (  # noqa: F401
    Partial, Placement, Replicate, Shard, dtensor_from_fn, reshard, shard_op,
    shard_tensor,
)
from .converter import (  # noqa: F401
    Converter, load_distributed_checkpoint, save_distributed_checkpoint,
)
from .engine import Engine  # noqa: F401
from .planner import (  # noqa: F401
    Candidate, ClusterSpec, ModelSpec, apply_placement_rules,
    placement_decisions, plan, plan_measured,
)
from .process_mesh import ProcessMesh  # noqa: F401
from .propagation import (  # noqa: F401
    DistSpec, PropagationResult, apply_propagation, capture_graph,
    graph_cost, parameters_as_inputs, propagate_graph,
)
from .strategy import Strategy  # noqa: F401
