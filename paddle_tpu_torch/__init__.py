"""paddle_tpu_torch: the PyTorch/CUDA port of ``paddle_tpu`` for NVIDIA
Hopper (H100).

The JAX package ``paddle_tpu`` stays the reference; this package never
imports it, nor JAX.  It is ported slice by slice (ROADMAP.md queue 1).
Three slices are ported.  Serving: ``GPTStackedForPretraining`` behind the
continuous-batching ``ServingEngine``, whose fused mixed prefill/decode
step runs the hand-written ragged-paged-attention kernel
(``ops/kernels/csrc/ragged_paged_attention.cu``).  Training: the same
model's ``forward(ids, labels=...)`` with ``optimizer.AdamW`` through
``optimizer.FusedTrainStep``, on the hand-written flash-attention forward
and backward (``ops/kernels/csrc/flash_attention.cu``) and fused-AdamW
(``ops/kernels/csrc/fused_adamw.cu``) kernels.  Generation:
``model.generate(...)`` over a contiguous KV cache (flash forward for the
prompt, the hand-written decode-attention kernel for every later token)
and the paged step without a ragged plan (the paged-attention kernel),
both in ``ops/kernels/csrc/decode_attention.cu``.

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``); on the CPU every kernel is replaced by its plain
PyTorch version.
"""
from . import core, models, nn, optimizer, serving, telemetry
from .models import (
    GenerationMixin, GPTConfig, GPTStackedForPretraining, KVCache, generate,
    generation, gpt_1p3b, gpt_13b, gpt_small, gpt_tiny,
)
from .serving import SamplingParams, ServingEngine

__all__ = ["core", "models", "nn", "optimizer", "serving", "telemetry",
           "GPTConfig",
           "GPTStackedForPretraining", "gpt_tiny", "gpt_small", "gpt_1p3b",
           "gpt_13b", "generation", "KVCache", "GenerationMixin", "generate",
           "ServingEngine", "SamplingParams"]
