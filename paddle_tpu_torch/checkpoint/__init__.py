"""Fault-tolerant training state (port of ``paddle_tpu/checkpoint/``):
crash-consistent atomic checkpoints with an asynchronous writer
(``manager``), preemption-safe exit (``preemption``), the full resumable
state of a torch training loop (``state``) and the bad-step sentry with
the fused unscale-and-check (``sentry``).  ``manager`` and
``preemption`` are host code, copied; ``state`` and ``sentry`` are
written over torch tensors."""
from .manager import CheckpointError, CheckpointInfo, CheckpointManager
from .preemption import GracefulExit, PreemptionHandler
from .sentry import (
    BadStepSentry, all_finite, tree_all_finite, unscale_and_check,
    unscale_and_check_,
)
from .state import TrainState, to_host

__all__ = [
    "CheckpointManager", "CheckpointInfo", "CheckpointError",
    "TrainState", "to_host",
    "BadStepSentry", "all_finite", "tree_all_finite", "unscale_and_check",
    "unscale_and_check_",
    "PreemptionHandler", "GracefulExit",
]
