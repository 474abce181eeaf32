"""paddle_tpu_torch: the PyTorch/CUDA port of ``paddle_tpu`` for NVIDIA
Hopper (H100).

The JAX package ``paddle_tpu`` stays the reference; this package never
imports it, nor JAX.  It is ported slice by slice (ROADMAP.md queue 1).
Serving: ``GPTStackedForPretraining`` and the layered
``GPTForPretraining`` behind the continuous-batching ``ServingEngine``, whose fused mixed prefill/decode
step runs the hand-written ragged-paged-attention kernel
(``ops/kernels/csrc/ragged_paged_attention.cu``).  Training: the same
model's ``forward(ids, labels=...)`` with ``optimizer.AdamW`` through
``optimizer.FusedTrainStep``, on the hand-written flash-attention forward
and backward (``ops/kernels/csrc/flash_attention.cu``) and fused-AdamW
(``ops/kernels/csrc/fused_adamw.cu``) kernels.  Generation:
``model.generate(...)`` over a contiguous KV cache (flash forward for the
prompt, the hand-written decode-attention kernel for every later token)
and the paged step without a ragged plan (the paged-attention kernel),
both in ``ops/kernels/csrc/decode_attention.cu``.  Quantized serving:
``ServingEngine(kv_dtype="int8", weight_dtype="int8")`` over int8 KV pages
and int8 projections, on the int8 variants of those three attention
kernels.  The fused layers and BERT: ``incubate.FusedMultiHeadAttention``
and ``incubate.FusedFeedForward``, whose post-LN residual add and
LayerNorm run the hand-written fused add + norm kernel
(``ops/kernels/csrc/rms_norm.cu``), ``incubate.FusedMultiTransformer``,
and ``BertForPretraining`` (``models/bert.py``), whose unmasked
attention runs the flash forward.  The training recipe of both model
families: dropout (GPT's block redraws its masks in the recompute), the
LR schedulers of ``optimizer.lr``, gradient clipping (``nn.clip``),
``AdamW``'s ``lr_ratio`` and decay mask, and bf16 weights on fp32 master
weights (``amp.decorate`` O2 before ``AdamW(multi_precision=True)``),
updated by the fused-AdamW kernel's master form.  Mixed precision over
fp32 weights: ``amp.auto_cast`` O1 (the reference's op lists) with
``amp.GradScaler``, taken by ``FusedTrainStep(scaler=, amp_level="O1")``,
whose skipped steps make no host sync; ``GPTConfig.recompute_policy``;
crash-consistent training (``checkpoint``: ``CheckpointManager``,
``TrainState``, ``BadStepSentry``, ``PreemptionHandler``) fed by
``io.DevicePrefetcher``.  The layered GPT (``GPTForPretraining``, the
reference's flagship class) generates, serves, quantizes (``Int8Linear``),
takes LoRA adapters and drafts on the same kernels, and ``inference``'s
Predictor runs a live model's decode and serving modes.  Cluster serving:
``serving.ShardedServingEngine`` drives ``dp`` replicas of ``mp`` head
shards from one process (``distributed.serving_mesh``: column/row-parallel
weight slices, a pool sharded per head, the ragged kernel per shard at
``H/mp`` heads), behind the placement layer, with the drain and elastic
lifecycle (``serving.ElasticServingController``) and disaggregated
prefill/decode replicas with page hand-off
(``serving.DisaggServingEngine``).

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``); on the CPU every kernel is replaced by its plain
PyTorch version.
"""
__version__ = "0.13.0"

from . import (
    amp, checkpoint, core, distributed, incubate, inference, io, models, nn,
    optimizer, serving, telemetry,
)
from .models import (
    BertConfig, BertForPretraining, BertModel, BertPretrainingCriterion,
    GenerationMixin, GPTConfig, GPTForPretraining, GPTPretrainingCriterion,
    GPTStackedForPretraining, KVCache,
    bert_base, bert_tiny, generate, generation, gpt_1p3b, gpt_13b, gpt_small,
    gpt_tiny,
)
from .serving import SamplingParams, ServingEngine

__all__ = ["amp", "checkpoint", "core", "distributed", "incubate", "inference", "io",
           "models", "nn",
           "optimizer", "serving", "telemetry", "BertConfig", "BertModel", "BertForPretraining",
           "BertPretrainingCriterion", "bert_tiny", "bert_base",
           "GPTConfig", "GPTForPretraining", "GPTStackedForPretraining",
           "GPTPretrainingCriterion",
           "gpt_tiny", "gpt_small", "gpt_1p3b", "gpt_13b", "generation", "KVCache", "GenerationMixin", "generate",
           "ServingEngine", "SamplingParams"]
