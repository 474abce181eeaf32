from . import lr
from .fused_step import FusedTrainStep
from .optimizers import AdamW, Momentum, SGD

__all__ = ["AdamW", "FusedTrainStep", "Momentum", "SGD", "lr"]
