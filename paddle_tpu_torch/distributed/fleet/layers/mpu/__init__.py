"""The tensor-parallel (mpu) layers and random streams (port of
``paddle_tpu/distributed/fleet/layers/mpu``)."""
from .mp_layers import (  # noqa: F401
    ColumnParallelLinear,
    ParallelCrossEntropy,
    RowParallelLinear,
    ShardedTensor,
    VocabParallelEmbedding,
)
from .random import (  # noqa: F401
    RNGStatesTracker, get_rng_state_tracker, model_parallel_random_seed,
)
