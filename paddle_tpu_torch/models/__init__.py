from . import generation
from .bert import (
    BertConfig, BertForPretraining, BertModel, BertPretrainingCriterion,
    bert_base, bert_tiny,
)
from .generation import GenerationMixin, KVCache, generate
from .gpt import (
    GPTConfig, GPTPretrainingCriterion, GPTStackedForPretraining, gpt_1p3b,
    gpt_13b, gpt_small, gpt_tiny,
)

__all__ = ["GPTConfig", "GPTStackedForPretraining",
           "GPTPretrainingCriterion", "gpt_tiny", "gpt_small",
           "gpt_1p3b", "gpt_13b", "generation", "KVCache", "GenerationMixin",
           "generate", "BertConfig", "BertModel", "BertForPretraining",
           "BertPretrainingCriterion", "bert_tiny", "bert_base"]
