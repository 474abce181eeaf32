"""The hybrid-parallel wrappers (port of
``paddle_tpu/distributed/fleet/meta_parallel``)."""
from .hybrid_optimizer import HybridParallelOptimizer  # noqa: F401
from .pipeline_parallel import (  # noqa: F401
    LayerDesc, PipelineLayer, PipelineParallel, SharedLayerDesc, schedule,
)
from .tensor_parallel import TensorParallel  # noqa: F401
