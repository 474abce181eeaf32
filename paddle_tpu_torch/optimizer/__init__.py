from . import lr
from .fused_step import FusedTrainStep
from .optimizers import AdamW

__all__ = ["AdamW", "FusedTrainStep", "lr"]
