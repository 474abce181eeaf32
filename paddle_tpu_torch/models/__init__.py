from . import generation
from .generation import GenerationMixin, KVCache, generate
from .gpt import (
    GPTConfig, GPTStackedForPretraining, gpt_1p3b, gpt_13b, gpt_small,
    gpt_tiny,
)

__all__ = ["GPTConfig", "GPTStackedForPretraining", "gpt_tiny", "gpt_small",
           "gpt_1p3b", "gpt_13b", "generation", "KVCache", "GenerationMixin",
           "generate"]
