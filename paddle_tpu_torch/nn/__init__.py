from . import clip, functional, layers
from .clip import (
    ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue, clip_grad_norm_,
)

__all__ = ["clip", "functional", "layers", "ClipGradByValue",
           "ClipGradByNorm", "ClipGradByGlobalNorm", "clip_grad_norm_"]
