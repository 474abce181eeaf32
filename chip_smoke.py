#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on
one NVIDIA Hopper card.  Run it from the root of the repository:

    python3 chip_smoke.py

Phases, in order; any failure ends the script with a nonzero exit and no
result line:

1. build -- compile every kernel library from ``paddle_tpu_torch/ops/
   kernels/csrc`` with nvcc (sm_90a) and print the build seconds and
   ptxas's register and spill report for every kernel entry; the bf16
   flash kernels at head_dim 64 and 128, and the split decode kernel
   (its contiguous and paged launches) and the ragged kernel at head_dim
   128 in every dtype, must spill nothing; print each bf16 flash
   kernel's, and the split decode kernel's two launches' and the ragged
   kernel's (fp32, bf16, int8; head_dim 128 and 192), shared memory per
   CTA, registers, CTAs per SM and local memory as the runtime reports
   them;
2. kernel vs plain -- the hand-written ragged-paged-attention kernel
   against its plain PyTorch version on the card, at the served shape
   (16 heads, head_dim 128, page 128) in bf16 and fp32 and at the tiny
   shape (head_dim 16, page 16): a decode at position 0, blocks
   straddling a page edge, 16-row prefill blocks straddling the page
   edges at 128 and 256 (every row on a different prefix), shuffled pool
   pages, padding blocks and a repeated work-list tail.  Every case is
   launched again on the same inputs (bit for bit), and over a pool
   holding NaN at every position no run may see -- pages no run owns,
   and past each run's last position on the pages it does own -- which
   must give bit for bit the output of the same pool with zeros there.
   Then the kernel's and the plain version's times at the decode-heavy
   and the mixed served shapes beside the bytes bound;
3. serve -- GPT-3 1.3B at full width (hidden 2048, 24 layers, 16 heads,
   vocab 50304) with random bf16 weights from a fixed seed, a bf16 pool,
   8 slots, page 128, max_context 512: 16 requests with prompt lengths
   cycling (64, 200, 120, 380) and 32 new tokens each.  Every request
   must end DONE with 32 tokens, every page must come back, and the
   kernel must have launched once per layer of every fused step;
4. card vs CPU -- gpt_tiny in fp32 served on the card and on the CPU
   from the same weights must give the same greedy tokens;
5. train kernels vs plain -- each flash-attention kernel against its
   own plain version on the same inputs (the forward's O and lse; dK/dV
   and dQ from the kernel's lse and delta), elementwise and over each
   whole output; the autograd Function's gradients must be the kernels'
   own, bit for bit, and are held against autograd of the plain forward;
   in bf16 at (B, N, S, D) = (8, 16, 1024, 128), the trained shape,
   (2, 16, 1024, 128) causal, (1, 2, 4096, 128) causal (a long ring of
   streamed blocks), (2, 4, 384, 64) causal and (2, 4, 384, 128) full,
   in fp32 at (2, 16, 1024, 128), at
   (1, 4, 128, 64) causal and full, and at (1, 2, 384, 64) causal; the
   AdamW kernel against its plain version on a bf16 [24, 2048, 8192] slab
   over two consecutive steps and on an unaligned fp32 [3, 257]; then the
   kernels' times beside the bound and their plain versions: flash at the
   trained shape bf16 causal, with the whole backward (delta and both
   kernels) against autograd of the plain forward and
   ``F.scaled_dot_product_attention(is_causal=True)``'s forward and
   backward, each with its ratio to SDPA and its share of the bound;
   AdamW over every tensor of GPT-3 1.3B (bf16 parameters and
   moments; times are for the whole update, 16 launches) against
   ``torch.optim.AdamW(fused=True)``;
6. train -- GPT-3 1.3B at full width and depth (hidden 2048, 24 layers,
   16 heads, vocab 50304, max_position_embeddings 1024) with random bf16
   weights from a fixed seed, dropout 0, recompute_interval 1,
   ``AdamW(lr=1e-4, weight_decay=0.01, multi_precision=False)`` through
   ``FusedTrainStep(amp_level="O1")``, batch 8 x seq 1024 cycling 4 fixed
   random (ids, labels) batches: 2 warm-up steps, then 6 timed steps.
   Every loss must be finite, and every step must launch the flash
   forward 48 times (24 layers, and 24 again in the recompute), each
   backward kernel 24 times and the AdamW kernel once per parameter
   tensor.  Prints step time, tokens/s, MFU (bench.py's formula over
   989 TFLOP/s) and peak device memory;
7. train card vs CPU -- gpt_tiny(hidden 128, 2 heads: head_dim 64, so the
   flash gate passes) in fp32, batch 2 x seq 128, 3 steps from the same
   weights on the card and on the CPU: the losses must agree, and the
   card must have launched the flash kernels;
8. decode kernels vs plain -- the decode-attention kernel at the
   generated shape (B 8, H 16, max_seq 1024, D 128) in bf16 and fp32 at
   lengths 1, 200, 201 and 1024, and at (2, 4, 64, 16) in fp32; the paged
   kernel over 8 slots x 16 heads, page 128, shuffled pool pages, lengths
   0, 1, 128, 129, 512 (and more), at page 16, D 16, and with one slot per
   split-boundary length (``PAGED_SPLIT_CASES``: 0, 1, a key either side
   of the first split boundary, one past the second, a page edge and one
   past it, the full table) at page 16 (splits straddle pages) and 128,
   head_dim 128 and 192, in bf16 and fp32, each launched again bit for
   bit and with NaN at every position no slot may see read through tables
   whose entries past each length name no pool page; the flash
   forward at ragged lengths (``FLASH_RAGGED_CASES``: bf16 at S 1, 50,
   77, 200 and 1000, causal and full, head_dim 64, 128, 192 and 256;
   views of a fused buffer holding NaN past S, which must give bit for
   bit what zeros there give; fp32 (1, 2, 77, 64) causal and full).  Each
   is held to phase 5's two bounds
   (elementwise against the sum of the absolute terms, and over the whole
   output); a cache holding NaN past the length must give a finite output
   equal to that of the same cache with zeros there.  The decode kernel
   (its keys split over CTAs) also at lengths 0, 1, one key either side of
   the first two split boundaries and max_seq, in bf16 and fp32 at (8, 16,
   1024, 128) and (4, 8, 520, 192): length 0 gives zeros, every length is
   launched again bit for bit and with NaN past the length.  Then both
   decode kernels' times at (B 8, H 16, length 264) and at length 1024
   beside the bytes bound, the plain versions and, for the contiguous
   cache, ``F.scaled_dot_product_attention`` on the length-sliced cache;
9. generate -- GPT-3 1.3B at full width and depth with random bf16
   weights from a fixed seed and a bf16 cache: ``generate`` of batch 8,
   prompt 200, 64 new tokens, ``max_seq_len`` 1024, greedy with
   ``return_logits``.  The output must be [8, 264] with every logit
   finite, and the run must launch the flash forward exactly 24 times (the
   prefill) and the decode kernel exactly 24 x 63 times; then a sampled
   ``generate`` (temperature 0.8, top-k 50, top-p 0.9) twice from one
   generator seed must give the same in-vocab tokens.  Prints the prefill
   ms, the mean decode ms per token, tokens/s and peak memory;
10. paged step without a plan -- the same model and prompts in 8 slots of
   page 128 over shuffled pool pages: chunked prefill in chunks of 64,
   then 16 decode steps (C == 1) teacher-forced with phase 9's greedy
   tokens.  Every step's logits must lie within a bf16 tolerance of phase
   9's, and each decode step must launch the paged kernel exactly 24
   times;
11. generate card vs CPU -- gpt_tiny(hidden 128, 2 heads) in fp32: greedy
   ``generate`` from a prompt of 77 and the paged path without a plan must
   give the CPU's tokens, and the card must have launched the flash
   forward, decode and paged kernels;
12. int8 kernels vs plain -- ``torch._int_mm``'s shape rules probed (the
   row counts ``quantization/int8.py`` pads to must be taken); the int8
   variants, fp32 q and scales, each against its plain version under
   the fp32 bounds of phase 8: the ragged kernel at phase 2's served
   shape (mixed, decode-heavy and straddling-prefill runs over shuffled
   pages, padding blocks and a repeated work-list tail; each launched
   again bit for bit, and with NaN scales on the pages no run owns and
   127 at every position no run may see, which must not change the
   output) and at the tiny shape, the paged kernel
   over 8 slots x 16 heads (lengths 0, 1, 128, 129, 512 and more; NaN
   scales on pages no slot sees, other values past the lengths and table
   entries past them naming no pool page must not change the output; each
   launched again bit for bit), at page 16, D 16, and at phase 8's
   split-boundary cases, the decode kernel at
   (8, 16, 1024, 128) and (2, 4, 64, 16); then each int8 kernel's time
   beside its bytes bound, its plain version and the bf16 kernel at the
   same shape (ragged at the decode-heavy served shape, decode and paged
   at phase 8's timed lengths), and ``quantized_matmul`` of [136, 2048]
   x [2048, 6144] and [8, 2048] x [2048, 50304] equal bit for bit on the
   card and the CPU, timed beside ``torch.addmm`` in bf16;
13. int8 serve -- phase 3's model and traffic from an int8 pool, first
   with bf16 weights, then with ``weight_dtype="int8"``: every request
   DONE with 32 tokens, every page back, every scale finite, exactly 24
   ragged launches in every fused step; prints tokens/s, the mean step,
   the pool's bytes against the bf16 pool's and peak memory;
14. int8 paged step without a plan -- phase 9's model quantized, phase
   10's prompts and pages with an int8 pool: chunked prefill in chunks of
   64, then 16 teacher-forced decode steps, each launching the paged
   kernel exactly 24 times; every step's logits within ``INT8_GEN_NORM``
   of phase 9's bf16 logits by relative norm; prints the top-1 agreement;
15. int8 card vs CPU -- gpt_tiny in fp32 with ``kv_dtype="int8"`` and
   ``weight_dtype="int8"``: the engine and the paged path without a plan
   must give the CPU's greedy tokens, and the card must have launched the
   ragged and paged kernels (all over int8 pools);
16. norm kernels vs plain -- the fused residual add + LayerNorm and
   RMSNorm kernel (``csrc/rms_norm.cu``) against its plain versions in
   fp32 and bf16 at eps 1e-12 and 1e-5, at the BERT-base encoder's rows
   [16 x 512, 768], GPT-3 1.3B's [8 x 1024, 2048], [257, 100] (a hidden
   size the TPU gate refuses), one row, zero rows (no launch) and [64,
   20000] (longer than a thread holds); then bf16 activations with fp32
   parameters, operands off a 16-byte boundary, and x and residual of two
   dtypes.  h must equal the plain version bit for bit, normed lie within
   ``NORM_TOL`` elementwise and by norm; a NaN in one row must leave every
   other row unchanged; the bf16 flash kernels at BERT's attention (16,
   12, 512, 64), non-causal, against their plain versions under phase 5's
   bounds.  Then both kernels' times at the BERT and GPT rows beside the
   bytes bound, the plain version and the two calls ``torch.add`` +
   ``F.layer_norm`` / ``F.rms_norm``, and the flash forward's at BERT's
   attention beside SDPA, with its ratio to SDPA and its share of the
   bound;
17. fused encoder -- twelve post-LN ``FusedMultiHeadAttention`` +
   ``FusedFeedForward`` pairs at BERT-base width (768, 12 heads, 3072,
   eps 1e-12, GELU), built from a ``bert_base`` ``BertModel``'s weights,
   against that model's encoder layers on one input in fp32 and bf16
   (``ENC_NORM``); then in bf16 at batch 16 x seq 512 in eval: every
   forward must launch the norm kernel 24 times and the flash forward 12
   times (prints ms per forward, tokens/s and peak memory); a pre-LN stack
   launches the norm kernel 0 times; two fp32 pairs' forward and backward
   give finite gradients within ``ENC_GRAD_NORM`` of autograd of the plain
   forward and launch the flash backward kernels;
18. BERT -- ``BertForPretraining(bert_base())`` in eval, bf16, batch 16 x
   seq 512, 80 masked positions a row: without ``attention_mask`` 12 flash
   launches per forward, with a padding mask (lengths cycling 512, 384,
   200, 77) none; MLM and NSP logits and the criterion finite; prints ms
   per forward and tokens/s;
19. BERT card vs CPU -- ``bert_tiny(hidden 128, 2 heads)`` with and
   without a padding mask, and two fused post-LN pairs at hidden 128, fp32,
   2 x 128, the same weights on the card and the CPU: outputs within
   ``CARD_CPU_NORM``, and the card launched the flash and norm kernels;
20. AdamW master form vs plain -- the fused AdamW kernel's fp32-master
   form (bf16 p and g; fp32 master, m1 and m2) against its plain version
   over two consecutive steps at BERT-base's word embeddings [30522,
   768], a GPT-3 1.3B slab [24, 2048, 8192] and [3, 257] in bf16, each
   also with every operand off a 16-byte boundary, and [3, 257] in fp16:
   master and moments within ``ADAMW_TOL["float32"]``, p within
   ``ADAMW_TOL[dtype]`` of the plain p and exactly the kernel's new master
   rounded.  Then its device ms per update over every tensor of BERT-base
   and of GPT-3 1.3B beside the bound (28 bytes an element over 3.35
   TB/s) and the plain version;
21. BERT-base train -- ``BertForPretraining(bert_base())`` cast to bf16
   by ``amp.decorate`` O2, then the recipe (``AdamW`` on fp32 masters,
   ``LinearWarmup`` over ``PolynomialDecay(power=1)``,
   ``ClipGradByGlobalNorm(1.0)``, weight decay 0.01 off every name that
   holds ``bias``, ``ln`` or ``layer_norm``, lr 1e-4) through
   ``FusedTrainStep``, 16 x 512 with 80 masked positions a row, 10 steps
   on one fixed batch, with attention dropout 0.1 (the plain route: no
   flash launch) and 0 (12 flash forward and 12 of each backward kernel a
   step).  Every step must launch the master form once per parameter
   tensor, the loss must be finite and fall, and the rate must follow the
   schedule (``recipe_lr``).  Prints ms a step, tokens/s, MFU (formula in
   ``bert_train_flops``) and peak memory;
22. GPT-3 1.3B train with dropout -- phase 6's workload with the config's
   default dropout 0.1 (attention on the plain causal route: no flash
   launch), then with attention dropout 0 (48 flash forward launches a
   step); finite losses, one AdamW launch per tensor a step; prints ms a
   step, tokens/s and peak memory;
23. determinism -- GPT-3 1.3B's width at 2 layers, bf16, dropout 0.1, 2 x
   1024: two runs of two steps from the same seeds give the same bits;
   recompute on and off give the same gradients (bit for bit), with
   attention dropout (plain route) and without (flash kernels);
24. recipe card vs CPU -- gpt_tiny and bert_tiny (hidden 128, 2 heads),
   fp32, dropout 0: three steps of the whole recipe on the card and on
   the CPU from the same weights: losses within ``TRAIN_LOSS_ATOL``,
   parameters within two rate-sized steps plus 1e-5 relative and 99.9 %
   of them within 1e-6; the card launched the flash and AdamW kernels.

TF32 is off throughout: fp32 runs in full fp32 on the card.

Output: the card's name and power limit (nvidia-smi), one JSON line with
the kernels' numbers (the flash rows also carry their ratio to SDPA,
their share of the bound, the whole backward's time against SDPA's
backward, and the forward's time at BERT's attention; the ragged row its
time, plain time and bound at the mixed served shape; the AdamW master
form's row its times at BERT-base and, beside them, at GPT-3 1.3B), and
as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3, NVIDIA data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, same source
# kernel vs plain: |kernel - plain| <= atol + rtol * |plain|.  fp32: the
# same arithmetic summed in another order over up to 512 keys; bf16: the
# output and the probabilities are each rounded once to bf16 (2^-8
# relative), and a different summation order can flip a rounding
TOL = {"float32": (1e-5, 0.0), "bfloat16": (2e-2, 1e-2)}
# flash kernels vs plain, each kernel against its own plain version on the
# same inputs (the backward kernels' plain versions take the kernel's lse
# and delta), held to (atol, rtol, norm):
# - elementwise, |kernel - plain| <= atol + rtol * m, where m is the sum of
#   the absolute terms of the output's product (P|V| for O, P^T|dO| for
#   dV, scale |dS|^T|q| for dK, scale |dS||k| for dQ; |lse| for lse).  A
#   rounding of a term or of the output moves the output by a fraction of
#   m, whatever cancels in the output itself.  bf16: the forward rounds P
#   against the running row max, the plain version after normalising
#   (2^-9 of each term, twice), and both round O once (2^-9 of m, twice);
#   the backward kernels share the plain versions' rounding points, and
#   differ where an fp32 sum lands on the other side of a bf16 rounding of
#   P, dS or the output.  fp32: the same arithmetic summed in another order
#   over up to 1024 keys and 128 head elements;
# - over a whole output, ||kernel - plain|| <= norm * ||plain|| (Frobenius):
#   rounding differences are scattered and of both signs, a fault (a
#   dropped or repeated block, a wrong row, a shift of some rows) is not,
#   so this catches what an elementwise bound of a rounding's size cannot.
#   The backward kernels share their plain versions' rounding points (bf16
#   differences ~1.5e-4 of the norm); O does not (~2.9e-3), and takes
#   FLASH_O_NORM.
FLASH_TOL = {"float32": (2e-5, 1e-5, 1e-6),
             "bfloat16": (1e-3, 2.0 ** -7, 2.0 ** -11)}
FLASH_O_NORM = {"float32": 1e-6, "bfloat16": 2.0 ** -8}
# the gradients of the autograd Function against autograd of the plain
# forward (elementwise against |plain|): in bf16 that backward rounds dP
# (the gradient of the bf16 P) instead of dS, and takes delta from the
# unrounded probabilities instead of rowsum(dO * O) over the bf16 O, which
# moves many elements of dq and dk, by up to two bf16 ulps of the largest
# gradients (|g| up to ~4, where an ulp is 2^-6)
FLASH_GRAD_TOL = {"float32": (2e-5, 1e-5, 1e-5),
                  "bfloat16": (2.0 ** -6, 2.0 ** -7, 2.0 ** -7)}
# decode and paged kernels vs plain: held to the flash forward's bounds
# (FLASH_TOL[dtype][:2] elementwise against m = P|V|, FLASH_O_NORM over the
# whole output).  The kernels round P against a local max (each split's,
# in both launches), the plain versions after normalising -- the flash
# forward's case -- and both round O once.
# phase 10 against phase 9 (bf16 GPT-3 1.3B logits, teacher-forced):
# the two runs feed the same tokens and differ where their attention
# rounds in bf16 (the prefill: flash kernel vs the chunked path's plain
# attention; decode: the same arithmetic over K/V that the differing
# prefill left in the caches), carried through 24 bf16 layers.  Held over
# each step's [8, V] logits: ||paged - generate|| <= GEN_NORM ||generate||
# and max |paged - generate| <= GEN_ATOL
GEN_NORM, GEN_ATOL = 2.0 ** -4, 0.25
# AdamW kernel vs plain: the same fp32 formula, which the compiler
# contracts into FMAs: a value at a bf16 rounding midpoint can round
# either way (one bf16 ulp, at most 2^-7 relative), and a sum that cancels
# to ~0 keeps a residue of a few fp32 ulps of its terms (the 1e-6 atol);
# fp16 (the master form's other parameter dtype): one fp16 ulp, 2^-10
ADAMW_TOL = {"float32": (1e-6, 1e-6), "bfloat16": (1e-6, 2.0 ** -7),
             "float16": (1e-6, 2.0 ** -10)}
TRAIN_SHAPE = (8, 16, 1024, 128)           # (B, N, S, D) of GPT-3 1.3B
FLASH_CASES = (("bfloat16", TRAIN_SHAPE, True),
               ("bfloat16", (2, 16, 1024, 128), True),
               # a long ring: 64 key blocks, 32 query blocks per key block
               ("bfloat16", (1, 2, 4096, 128), True),
               ("bfloat16", (2, 4, 384, 64), True),
               ("bfloat16", (2, 4, 384, 128), False),
               ("float32", (2, 16, 1024, 128), True),
               ("float32", (1, 4, 128, 64), True),
               ("float32", (1, 4, 128, 64), False),
               ("float32", (1, 2, 384, 64), True))
TRAIN_BATCH, TRAIN_SEQ = 8, 1024
TRAIN_WARMUP, TRAIN_STEPS = 2, 6
# generate at GPT-3 1.3B: batch, prompt, new tokens, cache length
GEN_BATCH, GEN_PROMPT, GEN_NEW, GEN_MAX_SEQ = 8, 200, 64, 1024
GEN_PAGE, GEN_CHUNK, GEN_PAGED_STEPS = 128, 64, 16
# the flash forward at lengths that are not 128-multiples (dtype, shape,
# causal, rows of NaN past S in the fused buffer the views come from):
# phase 9's prefill; one row; causal with S below one 64-key block and
# one 128-row block; 77, 200 and 1000; head dims 192 and 256 (the bf16
# forward's other instantiations); views into a wider buffer that holds
# NaN past S
FLASH_RAGGED_CASES = (
    ("bfloat16", (GEN_BATCH, 16, GEN_PROMPT, 128), True, 0),
    ("bfloat16", (2, 4, 1, 128), True, 0),
    ("bfloat16", (2, 4, 50, 128), True, 0),
    ("bfloat16", (2, 4, 77, 64), True, 0),
    ("bfloat16", (2, 4, 77, 128), False, 0),
    ("bfloat16", (1, 4, 1000, 128), True, 0),
    ("bfloat16", (1, 4, 1000, 64), False, 0),
    ("bfloat16", (2, 4, 200, 192), True, 0),
    ("bfloat16", (2, 4, 1000, 192), False, 0),
    ("bfloat16", (2, 4, 200, 256), True, 0),
    ("bfloat16", (2, 4, 1000, 256), False, 0),
    ("bfloat16", (2, 4, 200, 128), True, 56),
    ("bfloat16", (2, 4, 77, 64), False, 51),
    ("float32", (1, 2, 77, 64), True, 0),
    ("float32", (1, 2, 77, 64), False, 0))
# decode kernels' timing lengths: the end of phase 9's generate, and a
# full cache
DECODE_TIMED_LENGTHS = (GEN_PROMPT + GEN_NEW, GEN_MAX_SEQ)
SERVE_LAYERS = 24
DEVICE = "cuda"


def import_port():
    """Everything of the port this script drives (kept in one place so a
    test can check the imports without a card)."""
    import torch
    from paddle_tpu_torch import amp, incubate
    from paddle_tpu_torch.models import BertForPretraining, BertModel, \
        BertPretrainingCriterion, GPTStackedForPretraining, bert_base, \
        bert_tiny, gpt_1p3b, gpt_tiny
    from paddle_tpu_torch.nn import clip
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import decode_attention as da
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import fused_adamw as fw
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rpa
    from paddle_tpu_torch.ops.kernels import rms_norm as rn
    from paddle_tpu_torch.optimizer import AdamW, FusedTrainStep, lr
    from paddle_tpu_torch.quantization import int8 as qi8
    from paddle_tpu_torch.serving import RequestState, ServingEngine

    return dict(torch=torch, GPT=GPTStackedForPretraining, gpt_1p3b=gpt_1p3b,
                gpt_tiny=gpt_tiny, build=_build, rpa=rpa, fa=fa, fw=fw,
                da=da, pa=pa, qi8=qi8, rn=rn, F=F, incubate=incubate,
                BertModel=BertModel, BertForPretraining=BertForPretraining,
                BertPretrainingCriterion=BertPretrainingCriterion,
                bert_base=bert_base, bert_tiny=bert_tiny,
                AdamW=AdamW, FusedTrainStep=FusedTrainStep, amp=amp, lr=lr,
                clip=clip, RequestState=RequestState,
                ServingEngine=ServingEngine)


def _check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------

def _ptxas_entries(log):
    """{kernel entry (mangled name): {registers, spill_stores,
    spill_loads}} from ptxas's -v report."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w.$]+)'?", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name].update(spill_stores=int(m.group(1)),
                             spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


# the kernels of the main paths, which must not spill: the bf16 flash
# kernels (template <D, block>) at D 64 and 128, the split decode kernel
# (template <T, KV, D, Addr>: its contiguous and paged launches) and the
# ragged kernel (template <T, KV, D>) at D 128 in every dtype
NO_SPILL = re.compile(r"flash_(?:fwd|bwd_dkv|bwd_dq)_bf16ILi(?:64|128)E"
                      r"|(?:decode_split_kernel|ragged_paged_attention_kernel)"
                      r"I\w*?Li128E")
# the dtypes whose decode, paged and ragged kernels phase 1 reports
ATTN_DTYPES = ("float32", "bfloat16", "int8")


def attention_kernel_info(port, dims=(128, 192)):
    """The split decode kernel's contiguous and paged launches' and the
    ragged kernel's shared memory per CTA, registers, CTAs per SM,
    threads, local memory (spills) and keys per split, as the runtime
    reports them, printed by (kernel, dtype, head_dim)."""
    torch = port["torch"]
    for name, mod in (("decode split", port["da"]), ("paged", port["pa"]),
                      ("ragged", port["rpa"])):
        for dt in ATTN_DTYPES:
            for d in dims:
                print(f"[build] {name} {dt} D {d}: "
                      f"{mod.kernel_info(getattr(torch, dt), d)}")


def phase_build(port):
    torch, fa = port["torch"], port["fa"]
    t0 = time.perf_counter()
    secs = port["build"].build()
    total = time.perf_counter() - t0
    for name, s in secs.items():
        print(f"[build] {name}: {s:.2f} s")
    spills = []
    for name, log in port["build"].build_logs().items():
        for entry, r in _ptxas_entries(log).items():
            print(f"[ptxas] {name}: {entry}: {r}")
            if NO_SPILL.search(entry) and (
                    r.get("spill_stores", 1) or r.get("spill_loads", 1)):
                spills.append(entry)
    print(f"[build] all kernels: {total:.2f} s")
    for which, dims in (("fwd", (64, 128, 192, 256)),
                        ("bwd_dkv", (64, 128)), ("bwd_dq", (64, 128))):
        for d in dims:
            print(f"[build] flash {which} bf16 D {d}: "
                  f"{fa.kernel_info(which, torch.bfloat16, d)}")
    attention_kernel_info(port)
    if port["build"].build_logs():     # this process ran the builds
        _check(not spills, f"kernels of the main paths spill: {spills}")
    return total


# ---------------------------------------------------------------------------
# phase 2: kernel vs plain
# ---------------------------------------------------------------------------

def _case(port, runs, *, num_pages, heads, page_size, head_dim, t_max,
          nb_max, wl_max, max_pages, dtype, seed, layers=1, qkv_view=True):
    """Device tensors for one ragged case.  ``layers`` > 1 gives that many
    separate pools (as the model's layers have), for L2-cold timing;
    ``qkv_view`` makes q a view into a fused [T, 3, H, D] QKV buffer, as
    the model passes it, instead of a contiguous tensor.  ``dtype``
    "int8": int8 pools with their scales, fp32 q."""
    torch, rpa = port["torch"], port["rpa"]
    plan_np, stats = rpa.build_ragged_plan(
        runs, token_block=rpa.TOKEN_BLOCK, page_size=page_size,
        t_max=t_max, nb_max=nb_max, wl_max=wl_max)
    tables = np.zeros((t_max, max_pages), np.int32)
    lengths = np.zeros((t_max,), np.int32)
    for (base, count, tbl), start in zip(runs, stats["run_starts"]):
        tables[start:start + count] = tbl
        lengths[start:start + count] = base + np.arange(count) + 1
    dev = torch.device(DEVICE)
    td = torch.float32 if dtype == "int8" else getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(td)

    pool_shape = (layers, num_pages, heads, page_size, head_dim)
    q = (randn(t_max, 3, heads, head_dim)[:, 0] if qkv_view
         else randn(t_max, heads, head_dim))
    if dtype == "int8":
        (k, ks), (v, vs) = (_int8_pages(torch, pool_shape, gen)
                            for _ in range(2))
    else:
        k, v, ks, vs = randn(*pool_shape), randn(*pool_shape), None, None
    return dict(
        q=q, k=k, v=v, k_scale=ks, v_scale=vs,
        tables=torch.from_numpy(tables).to(dev),
        lengths=torch.from_numpy(lengths).to(dev),
        plan=tuple(torch.from_numpy(plan_np[k]).to(dev)
                   for k in rpa.RAGGED_PLAN_FIELDS),
        stats=stats, plan_np=plan_np, dtype=dtype, runs=runs)


def _unseen(torch, c):
    """[P, page_size] bool on the card: the pool positions that no run of
    case ``c`` may see -- pages no run owns, and positions past each run's
    last one on the pages it does own."""
    num_pages, page = c["k"].shape[1], c["k"].shape[3]
    seen = np.zeros((num_pages, page), bool)
    for base, count, tbl in c["runs"]:
        pos = np.arange(base + count)
        seen[np.asarray(tbl)[pos // page], pos % page] = True
    return torch.from_numpy(~seen).to(DEVICE)


def _ragged_reruns(port, name, c, got, kw=None):
    """Two more launches on ``c``: the same inputs must give ``got`` bit
    for bit; a pool holding stale values at every position no run may see
    must give bit for bit what the same pool with zeros there gives (NaN
    for a float pool; for an int8 pool, 127 there and NaN scales on the
    pages no run owns, which must give ``got`` itself)."""
    torch, rpa = port["torch"], port["rpa"]
    kw = kw or {}
    kp, vp = c["k"][0], c["v"][0]
    args = (c["tables"], c["lengths"], c["plan"])
    again = rpa.ragged_paged_attention(c["q"], kp, vp, *args, **kw)
    unseen = _unseen(torch, c)
    if c["dtype"] == "int8":
        kf, vf = kp.clone(), vp.clone()
        for t in (kf, vf):
            t.masked_fill_(unseen[:, None, :, None], 127)
        page_unseen = unseen.all(dim=1)
        ks, vs = kw["k_scale"].clone(), kw["v_scale"].clone()
        for t in (ks, vs):
            t.masked_fill_(page_unseen[:, None], float("nan"))
        stale = rpa.ragged_paged_attention(c["q"], kf, vf, *args,
                                           k_scale=ks, v_scale=vs)
        zero = got
    else:
        outs = []
        for fill in (float("nan"), 0.0):
            kf, vf = kp.clone(), vp.clone()
            for t in (kf, vf):
                t.masked_fill_(unseen[:, None, :, None], fill)
            outs.append(rpa.ragged_paged_attention(c["q"], kf, vf, *args))
        stale, zero = outs
    torch.cuda.synchronize()
    same = torch.equal(again, got)
    clean = bool(torch.isfinite(stale).all()) and torch.equal(stale, zero)
    print(f"[kernel] {name} {c['dtype']}: a second launch equal bit for bit: "
          f"{same}; stale values at the {int(unseen.sum())} unseen pool "
          f"positions give the clean pool's output bit for bit: {clean}")
    _check(same, f"{name} {c['dtype']}: two launches on the same inputs "
           "differ")
    _check(clean, f"{name} {c['dtype']}: stale pool values reached the "
           "output")


def _compare(port, name, c):
    torch, rpa = port["torch"], port["rpa"]
    scale = 1.0 / c["q"].shape[-1] ** 0.5
    got = rpa.ragged_paged_attention(c["q"], c["k"][0], c["v"][0],
                                     c["tables"], c["lengths"], c["plan"])
    want = rpa.ragged_paged_attention_plain(
        c["q"], c["k"][0], c["v"][0], c["tables"], c["lengths"], scale)
    torch.cuda.synchronize()
    real = c["stats"]["n_tokens"]
    diff = (got[:real].float() - want[:real].float()).abs()
    err = diff.max().item()
    atol, rtol = TOL[c["dtype"]]
    over = (diff - atol - rtol * want[:real].float().abs()).max().item()
    pad_zero = bool((got[real:] == 0).all().item())
    finite = bool(torch.isfinite(got).all().item())
    print(f"[kernel] {name} {c['dtype']}: max_abs_err={err!r} "
          f"tol={atol}+{rtol}*|plain| blocks={c['stats']['n_blocks']} "
          f"items={c['stats']['n_items']} padding_rows_zero={pad_zero}")
    _check(over <= 0, f"{name} {c['dtype']}: kernel vs plain off by {err}")
    _check(pad_zero and finite, f"{name}: padding rows not zero / non-finite")
    _ragged_reruns(port, name, c, got)
    return err


def _served_runs(rng, num_pages, max_pages=4):
    """Pool pages shuffled over the whole pool (page 0 stays the null
    page)."""
    perm = rng.permutation(np.arange(1, num_pages)).astype(np.int32)
    return [perm[i * max_pages:(i + 1) * max_pages] for i in range(8)]


def _bound(c, heads, head_dim, itemsize):
    """The least time the card needs for this launch: every K/V row the
    step's queries may see read once (a run at positions base..base+n-1
    sees base+n keys of its slot), the real tokens' q rows read once, all
    t_max output rows written once (padding rows get zeros), the plan
    read once -- over HBM bandwidth; and the QK and PV multiply-adds over
    the peak rate of the pool dtype.  An int8 pool (``itemsize`` 1):
    fp32 q and output, two fp32 scales per (work item, head), and the
    products in fp32.  Returns (ms, "bytes" | "operations")."""
    plan = c["plan_np"]
    keys = sum(base + count for base, count, _ in c["runs"])
    kv = keys * heads * head_dim * itemsize * 2
    rows = c["stats"]["n_tokens"] + c["q"].shape[0]     # q read, out written
    q_item = c["q"].element_size()
    qo = rows * heads * head_dim * q_item
    plan_bytes = sum(a.nbytes for a in plan.values())
    if c["k_scale"] is not None:
        plan_bytes += c["stats"]["n_items"] * heads * 4 * 2
    lengths = c["lengths"].cpu().numpy()
    flops = 4.0 * heads * head_dim * float(lengths.sum())
    t_bytes = (kv + qo + plan_bytes) / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS["bfloat16" if q_item == 2 else "float32"]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _time_ms(torch, fn, iters, hold=True):
    """(device ms per call, host ms per call).  A sleep kernel holds the
    stream while the host queues every call, so the events time the
    card's work back to back, not the rate at which Python launches.
    ``hold=False`` times without the sleep, for a call that may wait on
    the card itself (a library's optimizer step) and whose device time
    dwarfs its launches."""
    fn(0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    if hold:
        torch.cuda._sleep(200_000_000)    # ~0.1 s of device clock cycles
    start.record()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i)
    host = (time.perf_counter() - t0) / iters
    queued_ahead = not hold or not start.query()   # the sleep still held it
    stop.record()
    torch.cuda.synchronize()
    _check(queued_ahead, "the host did not queue the timed calls within "
           "the sleep kernel; the device timing would be the launch rate")
    return start.elapsed_time(stop) / iters, 1e3 * host


# the served engine's geometry: 16 heads, head_dim 128, page 128, 4 pages
# a slot, 8 slots + a 128-token prefill budget
def served_geometry(rpa):
    mp, nb_max = 4, 8 + 128 // rpa.TOKEN_BLOCK
    return dict(num_pages=8 * mp + 1, heads=16, page_size=128, head_dim=128,
                t_max=8 + 128, nb_max=nb_max, wl_max=nb_max * mp,
                max_pages=mp)


def mixed_runs(tb):
    """The mixed served step."""
    return [(0, 1, tb[0]),                  # decode at position 0
            (400, 1, tb[1]),                # decode over 4 pages
            (120, 40, tb[2]),               # prefill across a page edge
            (0, 16, tb[3]),                 # prefill from position 0
            (255, 1, tb[4]),                # decode at a page's end
            (127, 2, tb[5])]                # 2-token run over the edge


def decode_runs(tb):
    """The decode-heavy served step: 8 decodes at positions 380..401."""
    return [(380 + 3 * i, 1, tb[i]) for i in range(8)]


def straddle_runs(tb):
    """16-row prefill blocks that straddle the page edges at 128 and 256,
    every row of a block on a different prefix, and a short prefill."""
    return [(120, 16, tb[0]), (250, 16, tb[1]), (5, 3, tb[2])]


def ragged_checks(port, dtypes=("bfloat16", "float32")):
    """Phase 2's checks of the ragged kernel: the served cases and the
    tiny one in each dtype, each against the plain version, rerun bit for
    bit and with a stale pool.  Returns the largest error."""
    rpa = port["rpa"]
    served = served_geometry(rpa)
    rng = np.random.RandomState(0)
    errs = []
    for i, dtype in enumerate(dtypes):
        tb = _served_runs(rng, served["num_pages"])
        # seeds: 0, 1, 2 for the first dtype's mixed, decode-heavy and tiny
        # cases, 3, 4, 5 for the second's; 50 + i for the straddling one
        for name, runs, seed in (
                ("mixed", mixed_runs(tb), 3 * i),
                ("decode_heavy", decode_runs(tb), 3 * i + 1),
                ("prefill_straddle", straddle_runs(tb), 50 + i)):
            c = _case(port, runs, dtype=dtype, seed=seed, **served)
            _check(c["stats"]["n_blocks"] < served["nb_max"]
                   and c["stats"]["n_items"] < served["wl_max"],
                   "cases must leave padding blocks and a repeated tail")
            errs.append(_compare(port, name, c))
        tiny_tb = [np.array(t, np.int32) for t in
                   ([5, 3, 1, 7], [2, 0, 0, 0], [4, 6, 8, 9])]
        tiny = _case(port, [(30, 20, tiny_tb[0]), (0, 1, tiny_tb[1]),
                            (47, 1, tiny_tb[2])],
                     num_pages=10, heads=4, page_size=16, head_dim=16,
                     t_max=28, nb_max=6, wl_max=24, max_pages=4,
                     dtype=dtype, seed=3 * i + 2, qkv_view=False)
        errs.append(_compare(port, "tiny", tiny))
    return max(errs)


def time_ragged(port, runs, dtype="bfloat16", plain=True, seed=99,
                launch=None):
    """Device ms per launch of the ragged kernel at the served geometry
    over ``runs``, one pool per layer (24 x 35 MiB) so each launch finds
    its pages cold in the 50 MB L2: the kernel twice, its plain version,
    and the launch's bound.  ``dtype`` "int8": int8 pools and scales.
    ``launch`` (the wrapper's arguments) times another build of the
    kernel in the wrapper's place."""
    torch, rpa = port["torch"], port["rpa"]
    launch = launch or rpa.ragged_paged_attention
    served = served_geometry(rpa)
    c = _case(port, runs, dtype=dtype, seed=seed, layers=SERVE_LAYERS,
              **served)
    args = (c["tables"], c["lengths"])
    L = SERVE_LAYERS

    def scales(i):
        if c["k_scale"] is None:
            return {}
        return dict(k_scale=c["k_scale"][i % L], v_scale=c["v_scale"][i % L])

    def kernel(i):
        launch(c["q"], c["k"][i % L], c["v"][i % L], *args, c["plan"],
               **scales(i))

    def plain_fn(i):
        sc = scales(i)
        rpa.ragged_paged_attention_plain(
            c["q"], c["k"][i % L], c["v"][i % L], *args,
            1.0 / served["head_dim"] ** 0.5, sc.get("k_scale"),
            sc.get("v_scale"))

    t = {}
    t["ms"], t["host_ms"] = _time_ms(torch, kernel, 240)
    if plain:
        t["plain_ms"], _ = _time_ms(torch, plain_fn, 24)
    t["ms_again"], _ = _time_ms(torch, kernel, 240)
    t["bound"] = _bound(c, served["heads"], served["head_dim"],
                        1 if dtype == "int8" else 2)
    del c
    torch.cuda.empty_cache()
    return t


def phase_kernels(port):
    err = ragged_checks(port)
    # timing in bf16 at the decode-heavy and the mixed served shapes, the
    # pages drawn from the checks' stream after their two draws
    rng = np.random.RandomState(0)
    P = served_geometry(port["rpa"])["num_pages"]
    for _ in range(2):
        _served_runs(rng, P)
    times = {}
    for name, runs in (("decode_heavy", decode_runs(_served_runs(rng, P))),
                       ("mixed", mixed_runs(_served_runs(rng, P)))):
        t = times[name] = time_ragged(port, runs)
        print(f"[kernel] {name} bf16 timing: kernel {t['ms']!r} ms then "
              f"{t['ms_again']!r} ms per launch on the device (wrapper host "
              f"time {t['host_ms']!r} ms per call), plain {t['plain_ms']!r} "
              f"ms, bound {t['bound'][0]!r} ms ({t['bound'][1]}), share of "
              f"the bound {t['bound'][0] / min(t['ms'], t['ms_again']):.3f}")
    t, m = times["decode_heavy"], times["mixed"]
    return dict(max_abs_err=err, ms=min(t["ms"], t["ms_again"]),
                plain_ms=t["plain_ms"], bound_ms=t["bound"][0],
                bound_by=t["bound"][1],
                mixed_ms=min(m["ms"], m["ms_again"]),
                mixed_plain_ms=m["plain_ms"], mixed_bound_ms=m["bound"][0],
                mixed_bound_by=m["bound"][1])


# ---------------------------------------------------------------------------
# phase 3: serve GPT-3 1.3B at full width
# ---------------------------------------------------------------------------

# the serve workload, defined once here; tools/port_serve_profile.py
# profiles the same one
SERVE_PROMPT_LENS = (64, 200, 120, 380)
SERVE_REQUESTS = 16
SERVE_NEW_TOKENS = 32


def serve_engine(port, kv_dtype="bfloat16", weight_dtype=None):
    """GPT-3 1.3B at full width with random bf16 weights (seed 0), a pool
    of ``kv_dtype`` (bf16, or int8 with its scales), the weights quantized
    to int8 with ``weight_dtype="int8"``, 8 slots, page 128, max_context
    512, warmed up by one request (cuBLAS handles and allocator pools).
    Returns ``(engine, rng)``: the workload draws its prompts from
    ``rng``."""
    cfg = port["gpt_1p3b"]()
    _check(cfg.num_layers == SERVE_LAYERS, "gpt_1p3b has 24 layers")
    model = port["GPT"](cfg, device=DEVICE, dtype="bfloat16", seed=0)
    eng = port["ServingEngine"](model, num_slots=8, page_size=128,
                                max_context=512, kv_dtype=kv_dtype,
                                weight_dtype=weight_dtype)
    rng = np.random.RandomState(0)
    eng.generate_batch([rng.randint(0, cfg.vocab_size, (64,))], 2)
    port["torch"].cuda.synchronize()
    return eng, rng


def serve_workload(port, eng, rng, launch_log=None):
    """Submit the 16 requests at once and step ``eng`` until it is idle;
    every request must end DONE with its 32 tokens and every page come
    back.  With ``launch_log`` (a list), each step appends its ragged
    kernel launches.  Returns ``(requests, host seconds per step, wall
    seconds)``."""
    vocab = eng.model.config.vocab_size
    prompts = [rng.randint(0, vocab, (SERVE_PROMPT_LENS[i % 4],))
               for i in range(SERVE_REQUESTS)]
    rpa = port["rpa"].ragged_paged_attention
    t0 = time.perf_counter()
    reqs = [eng.submit(p, SERVE_NEW_TOKENS) for p in prompts]
    step_s = []
    while eng.queue.depth or eng.scheduler.active_slots:
        r0 = rpa.launches
        step_s.append(eng.step()["step_seconds"])
        if launch_log is not None:
            launch_log.append(rpa.launches - r0)
    port["torch"].cuda.synchronize()
    wall = time.perf_counter() - t0
    done = port["RequestState"].DONE
    _check(all(r.state == done and len(r.tokens) == SERVE_NEW_TOKENS
               for r in reqs),
           f"requests not all DONE with {SERVE_NEW_TOKENS} tokens: "
           f"{[(r.state, len(r.tokens)) for r in reqs]}")
    used = eng.metrics()["pages_used"]
    _check(used == 0, f"{used} pages leaked")
    return reqs, step_s, wall


def phase_serve(port):
    torch, rpa = port["torch"], port["rpa"]
    t0 = time.perf_counter()
    eng, rng = serve_engine(port)
    print(f"[serve] gpt_1p3b bf16 set-up {time.perf_counter() - t0:.2f} s, "
          f"pool {eng.metrics()['cache_bytes'] / 2**20:.0f} MiB")
    fused0 = eng.metrics()["fused_steps"]
    rpa.ragged_paged_attention.launches = 0
    reqs, step_s, dt = serve_workload(port, eng, rng)
    launches = rpa.ragged_paged_attention.launches
    m = eng.metrics()
    fused = m["fused_steps"] - fused0
    _check(launches == fused * SERVE_LAYERS,
           f"kernel launches {launches} != fused steps {fused} x 24")
    tokens = sum(len(r.tokens) for r in reqs)
    print(f"[serve] {len(reqs)} requests DONE, {tokens} tokens in {dt:.3f} s: "
          f"{tokens / dt:.1f} tokens/s; {fused} fused steps, mean step "
          f"{1e3 * float(np.mean(step_s)):.2f} ms (host clock, p50 "
          f"{1e3 * float(np.median(step_s)):.2f} ms); kernel launches "
          f"{launches}; ttft p50 {1e3 * m['slo']['ttft']['p50']:.1f} ms, "
          f"itl p50 {1e3 * m['slo']['itl']['p50']:.1f} ms")
    eng.close()
    del eng
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 4: card vs CPU on gpt_tiny, fp32
# ---------------------------------------------------------------------------

def phase_card_vs_cpu(port):
    torch = port["torch"]
    cfg = port["gpt_tiny"]()
    cpu = port["GPT"](cfg, device="cpu", dtype="float32", seed=1)
    card = port["GPT"](cfg, device=DEVICE, dtype="float32", seed=1)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, cfg.vocab_size, (s,))
               for s in (4, 17, 7, 21, 11, 5)]
    kw = dict(num_slots=2, page_size=16, max_context=64,
              cache_dtype="float32", prefill_token_budget=6)
    outs = [port["ServingEngine"](m, **kw).generate_batch(prompts, 8)
            for m in (cpu, card)]
    same = all(np.array_equal(a, b) for a, b in zip(*outs))
    print(f"[card_vs_cpu] gpt_tiny fp32 greedy tokens equal: {same}")
    _check(same, f"card and CPU greedy tokens differ: {outs}")


# ---------------------------------------------------------------------------
# phase 5: train kernels vs plain
# ---------------------------------------------------------------------------

def _qkv(torch, shape, dtype, seed):
    """q, k, v as [B, N, S, D] views into one fused [B, S, 3, N, D] buffer,
    as the training block passes them, and a dO of the same shape."""
    b, n, s, d = shape
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    td = getattr(torch, dtype)
    buf = torch.randn((b, s, 3, n, d), generator=gen, device=DEVICE).to(td)
    do = torch.randn((b, s, n, d), generator=gen, device=DEVICE).to(td)
    return [t.transpose(1, 2) for t in buf.unbind(2)], do.transpose(1, 2)


def _over(got, want, tol, mag=None):
    """(max |got - want|, max of |got - want| - atol - rtol * mag), with
    the magnitude ``mag`` |want| unless given."""
    diff = (got.float() - want.float()).abs()
    atol, rtol = tol
    mag = want.float().abs() if mag is None else mag.float()
    return diff.max().item(), (diff - atol - rtol * mag).max().item()


def _flash_compare(port, dtype, shape, causal, seed):
    """The three kernels against their plain versions on the same inputs
    (the forward's O and lse; dK, dV and dQ from the kernel's lse and
    delta); the autograd Function's gradients must be the kernels' own,
    bit for bit, and are held against autograd of the plain forward.
    Every error is printed beside the plain value's RMS and the relative
    norm of the difference before any check.
    Returns the kernels' max abs errors against their plain versions
    (forward, dK/dV, dQ)."""
    torch, fa = port["torch"], port["fa"]
    (q, k, v), do = _qkv(torch, shape, dtype, seed)
    scale = 1.0 / shape[-1] ** 0.5
    out, lse = fa.flash_attention_fwd(q, k, v, causal, scale)
    delta = fa.backward_delta(do, out)
    args = (q, k, v, do, lse, delta, causal, scale)
    (dk, dv), dq = fa.flash_attention_bwd_dkv(*args), \
        fa.flash_attention_bwd_dq(*args)
    want, want_lse = fa.flash_attention_plain(q, k, v, causal, scale)
    pdk, pdv = fa.flash_attention_bwd_dkv_plain(*args)
    m = _term_magnitudes(torch, *args)
    # (name, kernel, plain, m (None: |plain|), (atol, rtol, norm)); lse is
    # fp32 on both sides whatever the operands' dtype
    tol, grad_tol = FLASH_TOL[dtype], FLASH_GRAD_TOL[dtype]
    checks = [("O", out, want, m["O"], tol[:2] + (FLASH_O_NORM[dtype],)),
              ("lse", lse, want_lse, None, FLASH_TOL["float32"]),
              ("dk", dk, pdk, m["dk"], tol), ("dv", dv, pdv, m["dv"], tol),
              ("dq", dq, fa.flash_attention_bwd_dq_plain(*args), m["dq"],
               tol)]
    del m
    kq, kk, kv = (t.detach().requires_grad_(True) for t in (q, k, v))
    fa.FlashAttention.apply(kq, kk, kv, causal, scale).backward(do)
    own = all(torch.equal(a, b) for a, b in
              ((kq.grad, dq), (kk.grad, dk), (kv.grad, dv)))
    pq, pk, pv = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    fa.flash_attention_plain(pq, pk, pv, causal, scale)[0].backward(do)
    checks += [("autograd " + n, a.grad, b.grad, None, grad_tol)
               for n, a, b in (("dq", kq, pq), ("dk", kk, pk),
                               ("dv", kv, pv))]
    torch.cuda.synchronize()
    _check(all(bool(torch.isfinite(c[1]).all()) for c in checks),
           "flash: non-finite")
    errs, overs, text = {}, [], []
    for name, a, b, mag, (atol, rtol, norm) in checks:
        errs[name], over = _over(a, b, (atol, rtol), mag)
        a, b = a.float(), b.float()
        rel = ((a - b).norm() / b.norm()).item()
        overs += [(over, name), (rel - norm, name + " norm")]
        text.append(f"{name}={errs[name]!r} (rms {b.pow(2).mean().sqrt():.4g}"
                    f", norm {rel:.3g}; tol {atol:.3g}+{rtol:.3g}*"
                    f"{'|plain|' if mag is None else 'm'}, norm {norm:.3g})")
    print(f"[train_kernels] flash {dtype} {shape} causal={causal}: kernel vs "
          "plain " + " ".join(text) + f"; Function's gradients are the "
          f"kernels' own: {own}")
    _check(own, "the autograd Function's gradients are not the kernels'")
    for over, what in overs:
        _check(over <= 0, f"flash {what} {dtype} {shape} causal={causal}: "
               "off by more than the tolerance")
    e = errs
    return max(e["O"], e["lse"]), max(e["dk"], e["dv"]), e["dq"]


def _term_magnitudes(torch, q, k, v, do, lse, delta, causal, scale):
    """{O, dv, dk, dq: the sum of the absolute terms of its product} in
    fp32, with P and dS from the plain formulas: P|V|, P^T|dO|,
    scale |dS|^T|q| and scale |dS||k|."""
    b, n, s, _ = q.shape
    q, k, v, do = (t.float() for t in (q, k, v, do))
    sc = torch.einsum("bnqd,bnkd->bnqk", q, k) * scale
    if causal:
        keep = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        sc = sc.masked_fill(~keep, float("-inf"))
    p = torch.exp(sc - lse.view(b, n, s, 1))
    del sc
    ds = (p * (torch.einsum("bnqd,bnkd->bnqk", do, v)
               - delta.view(b, n, s, 1))).abs_()
    return {"O": torch.einsum("bnqk,bnkd->bnqd", p, v.abs()),
            "dv": torch.einsum("bnqk,bnqd->bnkd", p, do.abs()),
            "dk": scale * torch.einsum("bnqk,bnqd->bnkd", ds, q.abs()),
            "dq": scale * torch.einsum("bnqk,bnkd->bnqd", ds, k.abs())}


def _flash_bounds(shape, causal, itemsize):
    """{kernel: (bound ms, "bytes" | "operations")} for the forward, the
    dK/dV and the dQ kernel, and the whole backward, at ``shape``: each
    input read once and each output written once, over HBM bandwidth;
    the multiply-adds the causal (or full) score pairs need, over the
    tensor-core (bf16) or FMA (fp32) peak.  The backward's least work is
    five products (S recomputed, dP, dV, dK, dQ); dK/dV alone needs four
    of them, dQ alone three."""
    b, n, s, d = shape
    pairs = s * (s + 1) // 2 if causal else s * s
    prod = 2.0 * b * n * d * pairs          # flops of one S-sized product
    tile = b * n * s * d * itemsize          # one [B, N, S, D] operand
    row = b * n * s * 4                      # one fp32 [B * N, S] vector
    peak = PEAK_FLOPS["bfloat16" if itemsize == 2 else "float32"]
    work = {"fwd": (2 * prod, 4 * tile + row),
            "dkv": (4 * prod, 6 * tile + 2 * row),
            "dq": (3 * prod, 5 * tile + 2 * row),
            "bwd": (5 * prod, 7 * tile + 2 * row)}
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
        out[name] = (1e3 * max(t_ops, t_bytes),
                     "bytes" if t_bytes >= t_ops else "operations")
    return out


def _time_flash(port):
    """Device ms of the kernels, the plain version and SDPA at the trained
    shape (bf16, causal)."""
    torch, fa = port["torch"], port["fa"]
    import torch.nn.functional as F

    (q, k, v), do = _qkv(torch, TRAIN_SHAPE, "bfloat16", 7)
    scale = 1.0 / TRAIN_SHAPE[-1] ** 0.5
    out, lse = fa.flash_attention_fwd(q, k, v, True, scale)
    delta = fa.backward_delta(do, out)
    args = (q, k, v, do, lse, delta, True, scale)

    def backward(i):
        # what FlashAttention.backward runs: delta, then both kernels
        d = fa.backward_delta(do, out)
        fa.flash_attention_bwd_dkv(q, k, v, do, lse, d, True, scale)
        fa.flash_attention_bwd_dq(q, k, v, do, lse, d, True, scale)

    t = {}
    t["fwd"], _ = _time_ms(
        torch, lambda i: fa.flash_attention_fwd(q, k, v, True, scale), 40)
    t["dkv"], _ = _time_ms(torch, lambda i: fa.flash_attention_bwd_dkv(*args),
                           20)
    t["dq"], _ = _time_ms(torch, lambda i: fa.flash_attention_bwd_dq(*args),
                          20)
    t["bwd"], _ = _time_ms(torch, backward, 20)
    t["plain_dkv"], _ = _time_ms(
        torch, lambda i: fa.flash_attention_bwd_dkv_plain(*args), 5)
    t["plain_dq"], _ = _time_ms(
        torch, lambda i: fa.flash_attention_bwd_dq_plain(*args), 5)
    t["plain_fwd"], _ = _time_ms(
        torch, lambda i: fa.flash_attention_plain(q, k, v, True, scale), 5)
    pq, pk, pv = (x.detach().requires_grad_(True) for x in (q, k, v))
    pout = fa.flash_attention_plain(pq, pk, pv, True, scale)[0]
    t["plain_bwd"], _ = _time_ms(torch, lambda i: torch.autograd.grad(
        pout, (pq, pk, pv), do, retain_graph=True), 5)
    del pout
    t["sdpa_fwd"], _ = _time_ms(torch, lambda i: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=scale), 40)
    sout = F.scaled_dot_product_attention(pq, pk, pv, is_causal=True,
                                          scale=scale)
    t["sdpa_bwd"], _ = _time_ms(torch, lambda i: torch.autograd.grad(
        sout, (pq, pk, pv), do, retain_graph=True), 20)
    return t


def _adamw_compare(port, shape, dtype, seed):
    """Two consecutive AdamW steps (the beta powers advance between them),
    kernel and plain version on copies of the same tensors, compared
    after each step; the plain copies then take the kernel's state, so
    each step starts both from the same values and a rounding flip of one
    step is not carried into the next.  Returns the max abs error over
    p, m1 and m2."""
    torch, fw = port["torch"], port["fw"]
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    td = getattr(torch, dtype)

    def randn(scale):
        return (torch.randn(shape, generator=gen, device=DEVICE)
                * scale).to(td)

    kern = [randn(1.0), randn(0.01), randn(0.001).abs()]   # p, m1, m2
    plain = [t.clone() for t in kern]
    b1p, b2p = np.float32(1.0), np.float32(1.0)
    err = 0.0
    for step in (1, 2):
        g = randn(0.1)
        b1p, b2p = np.float32(b1p * np.float32(0.9)), np.float32(
            b2p * np.float32(0.999))
        fw.fused_adamw_update(kern[0], g, kern[1], kern[2], 1e-3, b1p, b2p)
        fw.fused_adamw_plain(plain[0], g, plain[1], plain[2],
                             fw.adamw_scalars(1e-3, b1p, b2p))
        torch.cuda.synchronize()
        for name, a, b in zip(("p", "m1", "m2"), kern, plain):
            e, over = _over(a, b, ADAMW_TOL[dtype])
            _check(over <= 0, f"adamw {name} {dtype} {shape} step {step}: "
                   f"kernel vs plain off by {e}")
            err = max(err, e)
            b.copy_(a)
    print(f"[train_kernels] adamw {dtype} {list(shape)} two steps: "
          f"max_abs_err={err!r}")
    return err


def _time_adamw(port):
    """Device ms of one AdamW update over every tensor of GPT-3 1.3B in
    bf16 (16 launches): the kernel, the plain version and
    torch.optim.AdamW(fused=True); and the bound of that update."""
    torch, fw = port["torch"], port["fw"]
    model = port["GPT"](port["gpt_1p3b"](max_position_embeddings=1024),
                        device=DEVICE, dtype="bfloat16", seed=3)
    params = [p.detach() for p in model.parameters()]
    grads = [torch.randn_like(p) * 0.01 for p in params]
    m1 = [torch.zeros_like(p) for p in params]
    m2 = [torch.zeros_like(p) for p in params]

    def kernel(i):
        for p, g, a, b in zip(params, grads, m1, m2):
            fw.fused_adamw_update(p, g, a, b, 1e-4, 0.9, 0.999)

    def plain(i):
        sc = fw.adamw_scalars(1e-4, 0.9, 0.999)
        for p, g, a, b in zip(params, grads, m1, m2):
            fw.fused_adamw_plain(p, g, a, b, sc)

    lib_params = [torch.nn.Parameter(p) for p in params]
    for p, g in zip(lib_params, grads):
        p.grad = g
    lib = torch.optim.AdamW(lib_params, lr=1e-4, weight_decay=0.01,
                            fused=True)
    t = {"ms": _time_ms(torch, kernel, 20)[0],
         "plain_ms": _time_ms(torch, plain, 3, hold=False)[0],
         "library_ms": _time_ms(torch, lambda i: lib.step(), 20,
                                hold=False)[0]}
    n = sum(p.numel() for p in params)
    t_bytes = 7 * 2 * n / HBM_BYTES_PER_S          # read p g m1 m2, write 3
    t_ops = 14.0 * n / PEAK_FLOPS["float32"]        # ~14 fp32 ops / element
    t["bound_ms"] = 1e3 * max(t_bytes, t_ops)
    t["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    t["tensors"], t["elements"] = len(params), n
    del model, lib, lib_params
    return t


def phase_train_kernels(port):
    torch = port["torch"]
    errs = {"fwd": 0.0, "dkv": 0.0, "dq": 0.0}
    for i, (dtype, shape, causal) in enumerate(FLASH_CASES):
        e = _flash_compare(port, dtype, shape, causal, seed=10 + i)
        for name, x in zip(("fwd", "dkv", "dq"), e):
            errs[name] = max(errs[name], x)
    errs["adamw"] = max(
        _adamw_compare(port, (24, 2048, 8192), "bfloat16", 20),
        _adamw_compare(port, (3, 257), "float32", 21))
    torch.cuda.empty_cache()

    t = _time_flash(port)
    bounds = _flash_bounds(TRAIN_SHAPE, True, 2)
    share = {k: bounds[k][0] / t[k] for k in ("fwd", "dkv", "dq", "bwd")}
    print(f"[train_kernels] flash bf16 {TRAIN_SHAPE} causal timing (device "
          f"ms per call): forward {t['fwd']!r}, dK/dV {t['dkv']!r}, dQ "
          f"{t['dq']!r}; plain forward {t['plain_fwd']!r}, plain dK/dV "
          f"{t['plain_dkv']!r}, plain dQ {t['plain_dq']!r}; SDPA forward "
          f"{t['sdpa_fwd']!r}; forward / SDPA forward "
          f"{t['fwd'] / t['sdpa_fwd']!r}; bounds " + ", ".join(
              f"{k} {v[0]!r} ({v[1]}; share of it {share[k]!r})"
              for k, v in bounds.items() if k != "bwd"))
    print(f"[train_kernels] flash bf16 {TRAIN_SHAPE} causal whole backward "
          f"(dq, dk, dv; device ms per call): delta and both kernels "
          f"{t['bwd']!r}, autograd of the plain forward {t['plain_bwd']!r}, "
          f"SDPA backward {t['sdpa_bwd']!r} (ratio "
          f"{t['bwd'] / t['sdpa_bwd']!r}), bound {bounds['bwd'][0]!r} "
          f"({bounds['bwd'][1]}; share of it {share['bwd']!r})")
    torch.cuda.empty_cache()
    a = _time_adamw(port)
    print(f"[train_kernels] adamw over GPT-3 1.3B ({a['tensors']} bf16 "
          f"tensors, {a['elements']} elements), device ms per update: "
          f"kernel {a['ms']!r}, plain {a['plain_ms']!r}, "
          f"torch.optim.AdamW(fused=True) {a['library_ms']!r}, bound "
          f"{a['bound_ms']!r} ({a['bound_by']})")
    torch.cuda.empty_cache()
    rows = {}
    # no single PyTorch call computes dK/dV alone or dQ alone: the
    # library's backward is compared whole on the line above
    for name, lib in (("fwd", t["sdpa_fwd"]), ("dkv", None), ("dq", None)):
        rows[name] = dict(max_abs_err=errs[name], ms=t[name],
                          plain_ms=t["plain_" + name],
                          bound_ms=bounds[name][0],
                          bound_by=bounds[name][1], library_ms=lib,
                          bound_share=share[name])
    rows["fwd"]["library_ratio"] = t["fwd"] / t["sdpa_fwd"]
    # the whole backward (delta and both kernels) against SDPA's backward
    for name in ("dkv", "dq"):
        rows[name].update(whole_backward_ms=t["bwd"],
                          sdpa_backward_ms=t["sdpa_bwd"],
                          whole_backward_ratio=t["bwd"] / t["sdpa_bwd"],
                          whole_backward_bound_share=share["bwd"])
    rows["adamw"] = dict(max_abs_err=errs["adamw"], ms=a["ms"],
                         plain_ms=a["plain_ms"], bound_ms=a["bound_ms"],
                         bound_by=a["bound_by"], library_ms=a["library_ms"])
    return rows


# ---------------------------------------------------------------------------
# phase 6: train GPT-3 1.3B at full width and depth
# ---------------------------------------------------------------------------

def train_setup(port):
    """GPT-3 1.3B (max_position_embeddings 1024, dropout 0,
    recompute_interval 1) with random bf16 weights (seed 0), AdamW(lr
    1e-4, wd 0.01, bf16 moments) through FusedTrainStep(O1), and 4 fixed
    random (ids, labels) batches of 8 x 1024 on the card.  Returns
    ``(model, step, batches)``."""
    torch = port["torch"]
    cfg = port["gpt_1p3b"](hidden_dropout=0.0, attention_dropout=0.0,
                           max_position_embeddings=1024,
                           recompute_interval=1, use_flash_attention=True)
    model = port["GPT"](cfg, device=DEVICE, dtype="bfloat16", seed=0)
    opt = port["AdamW"](model.parameters(), learning_rate=1e-4,
                        weight_decay=0.01, multi_precision=False)
    step = port["FusedTrainStep"](
        lambda ids, labels: model(ids, labels=labels), opt, amp_level="O1")
    rng = np.random.RandomState(0)
    batches = [tuple(torch.from_numpy(rng.randint(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ))).to(DEVICE)
        for _ in range(2)) for _ in range(4)]
    return model, step, batches


def train_steps(port, step, batches, n, first=0):
    """``n`` steps cycling ``batches``, ending in a synchronize.  Returns
    (losses as floats, wall seconds)."""
    torch = port["torch"]
    t0 = time.perf_counter()
    losses = [step(*batches[(first + i) % len(batches)]) for i in range(n)]
    torch.cuda.synchronize()
    return [float(x) for x in losses], time.perf_counter() - t0


def _counted(port):
    """Every kernel wrapper that counts its launches, by short name."""
    fa = port["fa"]
    return {"fwd": fa.flash_attention_fwd, "dkv": fa.flash_attention_bwd_dkv,
            "dq": fa.flash_attention_bwd_dq,
            "adamw": port["fw"].fused_adamw_update,
            "decode": port["da"].decode_attention,
            "paged": port["pa"].paged_attention,
            "ragged": port["rpa"].ragged_paged_attention,
            "ln": port["rn"].fused_add_layer_norm,
            "rms": port["rn"].fused_add_rms_norm}


def _launch_counts(port):
    return {k: f.launches for k, f in _counted(port).items()}


def _reset_launches(port):
    for f in _counted(port).values():
        f.launches = 0


def gpt_train_mfu(cfg, step_s):
    """bench.py's MFU of a GPT train step of TRAIN_BATCH x TRAIN_SEQ taking
    ``step_s`` seconds: 72 b s L h^2 (1 + s/6h + V/12Lh) over 989
    TFLOP/s."""
    L, h, V, s = cfg.num_layers, cfg.hidden_size, cfg.vocab_size, TRAIN_SEQ
    flops = 72 * TRAIN_BATCH * s * L * h * h * (1 + s / (6 * h)
                                                + V / (12 * L * h))
    return flops / step_s / PEAK_FLOPS["bfloat16"]


def phase_train(port):
    torch = port["torch"]
    t0 = time.perf_counter()
    model, step, batches = train_setup(port)
    cfg = model.config
    n_tensors = len(list(model.parameters()))
    warm, _ = train_steps(port, step, batches, TRAIN_WARMUP)
    print(f"[train] gpt_1p3b bf16 set-up and {TRAIN_WARMUP} warm-up steps "
          f"{time.perf_counter() - t0:.2f} s, losses {warm}")
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(port)
    losses, wall = train_steps(port, step, batches, TRAIN_STEPS,
                               first=TRAIN_WARMUP)
    launches = _launch_counts(port)
    peak = torch.cuda.max_memory_allocated()
    _check(all(np.isfinite(losses)), f"non-finite train losses {losses}")
    L = cfg.num_layers
    want = {"fwd": 2 * L, "dkv": L, "dq": L, "adamw": n_tensors}
    _check(all(launches[k] == want[k] * TRAIN_STEPS for k in want),
           f"launches over {TRAIN_STEPS} steps {launches}, expected per "
           f"step {want}")
    step_s = wall / TRAIN_STEPS
    tokens = TRAIN_BATCH * TRAIN_SEQ
    mfu = gpt_train_mfu(cfg, step_s)
    print(f"[train] {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ}: "
          f"losses {losses}; mean step {1e3 * step_s:.2f} ms (host clock), "
          f"{tokens / step_s:.1f} tokens/s, MFU {mfu:.4f} (bench.py "
          f"formula over 989 TFLOP/s); launches per step "
          f"{ {k: v // TRAIN_STEPS for k, v in launches.items()} }; peak "
          f"device memory {peak / 2**30:.2f} GiB")
    del model, step, batches
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 7: train card vs CPU on gpt_tiny, fp32
# ---------------------------------------------------------------------------

# the same fp32 arithmetic summed in another order: losses of ~7 agree to
# a few fp32 ulps after three AdamW steps
TRAIN_LOSS_ATOL = 1e-4


def phase_train_card_vs_cpu(port):
    torch = port["torch"]
    cfg = port["gpt_tiny"](hidden_size=128, num_heads=2, hidden_dropout=0.0,
                           attention_dropout=0.0, recompute_interval=1)
    rng = np.random.RandomState(2)
    batch = [rng.randint(0, cfg.vocab_size, (2, 128)) for _ in range(2)]
    cpu = port["GPT"](cfg, device="cpu", dtype="float32", seed=4)
    card = port["GPT"](cfg, device=DEVICE, dtype="float32", seed=4)
    card.load_state_dict(cpu.state_dict())
    _reset_launches(port)
    out = []
    for m in (cpu, card):
        opt = port["AdamW"](m.parameters(), learning_rate=1e-4)
        step = port["FusedTrainStep"](
            lambda ids, labels, m=m: m(ids, labels=labels), opt)
        dev_batch = [torch.from_numpy(x).to(m.device) for x in batch]
        out.append([float(step(*dev_batch)) for _ in range(3)])
    launches = _launch_counts(port)
    diff = max(abs(a - b) for a, b in zip(*out))
    print(f"[train_card_vs_cpu] gpt_tiny fp32 losses cpu {out[0]} card "
          f"{out[1]}: max diff {diff!r} (tol {TRAIN_LOSS_ATOL}); card "
          f"launches {launches}")
    _check(diff <= TRAIN_LOSS_ATOL, "card and CPU train losses differ")
    _check(launches["fwd"] > 0 and launches["dkv"] > 0 and launches["dq"] > 0,
           "the card's train steps did not launch the flash kernels")


# ---------------------------------------------------------------------------
# phase 8: decode kernels vs plain
# ---------------------------------------------------------------------------

def _randn(torch, shape, dtype, gen):
    return torch.randn(shape, generator=gen, device=DEVICE).to(
        getattr(torch, dtype))


def _hold(torch, name, dtype, got, want, m, tag="decode_kernels"):
    """``got`` against ``want`` under the flash forward's two bounds:
    elementwise against ``m`` (the sum of the absolute terms of each
    output element) and over the whole output.  Returns the max abs
    error."""
    atol, rtol, _ = FLASH_TOL[dtype]
    norm = FLASH_O_NORM[dtype]
    err, over = _over(got, want, (atol, rtol), m)
    a, b = got.float(), want.float()
    rel = ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
    finite = bool(torch.isfinite(a).all())
    print(f"[{tag}] {name} {dtype}: max_abs_err={err!r} (tol "
          f"{atol:.3g}+{rtol:.3g}*m), norm {rel:.3g} (tol {norm:.3g})")
    _check(finite, f"{name} {dtype}: non-finite output")
    _check(over <= 0 and rel <= norm,
           f"{name} {dtype}: kernel vs plain off by more than the tolerance")
    return err


def _masked_probs(torch, q, k, lengths, scale):
    """fp32 softmax P [R, keys] of q [R, D] over k [R, keys, D], masked to
    each row's length (a length-0 row is all zeros)."""
    s = torch.einsum("rd,rkd->rk", q.float(), k.float()) * scale
    valid = torch.arange(k.shape[1], device=k.device)[None] < lengths[:, None]
    p = torch.softmax(s.masked_fill(~valid, float("-inf")), dim=-1)
    return torch.nan_to_num(p, nan=0.0)


def _decode_case(port, dtype, shape, lengths, seed):
    """The decode kernel against its plain version at every length, with
    q a view into a fused QKV buffer; a cache holding NaN past the length
    must give the output of the same cache with zeros there."""
    torch, da = port["torch"], port["da"]
    b, h, s, d = shape
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    q = _randn(torch, (b, 3, h, d), dtype, gen)[:, 0]
    k, v = (_randn(torch, shape, dtype, gen) for _ in range(2))
    scale = 1.0 / d ** 0.5
    err = 0.0
    for n in lengths:
        got = da.decode_attention(q, k, v, torch.tensor(n, device=DEVICE))
        want = da.decode_attention_plain(q, k, v, n, scale)
        p = _masked_probs(torch, q.reshape(b * h, d), k.reshape(b * h, s, d),
                          torch.full((b * h,), n, device=DEVICE), scale)
        m = torch.einsum("rk,rkd->rd", p, v.reshape(b * h, s, d).float().abs())
        err = max(err, _hold(torch, f"decode {shape} length {n}", dtype,
                             got, want,
                             m.reshape(b, h, d)))
    n = lengths[1]
    stale_k, stale_v, zero_k, zero_v = (t.clone() for t in (k, v, k, v))
    for t, fill in ((stale_k, float("nan")), (stale_v, float("nan")),
                    (zero_k, 0.0), (zero_v, 0.0)):
        t[:, :, n:] = fill
    a = da.decode_attention(q, stale_k, stale_v, n)
    z = da.decode_attention(q, zero_k, zero_v, n)
    torch.cuda.synchronize()
    _check(bool(torch.isfinite(a.float()).all()) and torch.equal(a, z),
           f"decode {dtype} {shape}: NaN past the length reached the output")
    return err


def decode_split_case(port, dtype, shape, seed):
    """The split decode kernel around its split boundaries: lengths 0, 1,
    one key either side of the first and second split boundary and
    max_seq.  Each length against the plain version (length 0: zeros, the
    Pallas kernel's l == 0 guard, where the plain version averages V), a
    cache holding NaN past the length against the same cache with zeros
    there, bit for bit, and a second launch bit for bit."""
    torch, da = port["torch"], port["da"]
    b, h, s, d = shape
    keys = da.keys_per_split(d, getattr(torch, dtype))
    lengths = sorted({0, 1, keys - 1, keys, keys + 1, 2 * keys - 1,
                      2 * keys + 1, s})
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    q = _randn(torch, (b, 3, h, d), dtype, gen)[:, 0]
    k, v = (_randn(torch, shape, dtype, gen) for _ in range(2))
    scale = 1.0 / d ** 0.5
    err = 0.0
    for n in lengths:
        length = torch.tensor(n, device=DEVICE)
        got = da.decode_attention(q, k, v, length)
        again = da.decode_attention(q, k, v, length)
        if n == 0:
            torch.cuda.synchronize()
            _check(not bool(got.float().any()),
                   f"decode {dtype} {shape}: length 0 must give zeros")
        else:
            want = da.decode_attention_plain(q, k, v, n, scale)
            p = _masked_probs(torch, q.reshape(b * h, d),
                              k.reshape(b * h, s, d),
                              torch.full((b * h,), n, device=DEVICE), scale)
            m = torch.einsum("rk,rkd->rd", p,
                             v.reshape(b * h, s, d).float().abs())
            err = max(err, _hold(torch, f"decode {shape} length {n} ({keys} "
                                 "keys a split)", dtype, got, want,
                                 m.reshape(b, h, d)))
        stale = []
        for fill in (float("nan"), 0.0):
            kf, vf = k.clone(), v.clone()
            kf[:, :, n:] = fill
            vf[:, :, n:] = fill
            stale.append(da.decode_attention(q, kf, vf, length))
        torch.cuda.synchronize()
        _check(torch.equal(again, got), f"decode {dtype} {shape} length {n}: "
               "two launches on the same inputs differ")
        _check(bool(torch.isfinite(stale[0].float()).all())
               and torch.equal(stale[0], stale[1]),
               f"decode {dtype} {shape} length {n}: NaN past the length "
               "reached the output")
    print(f"[decode_kernels] decode {dtype} {shape}, {keys} keys a split: "
          f"lengths {lengths} each rerun bit for bit, and NaN past the "
          "length gives bit for bit what zeros there give")
    return err


# the split decode kernel's boundary cases (dtype, shape): the generated
# shape and head_dim 192
DECODE_SPLIT_CASES = (("bfloat16", (GEN_BATCH, 16, GEN_MAX_SEQ, 128)),
                      ("float32", (GEN_BATCH, 16, GEN_MAX_SEQ, 128)),
                      ("bfloat16", (4, 8, 520, 192)),
                      ("float32", (4, 8, 520, 192)))


def _paged_tables(rng, slots, max_pages, num_pages):
    perm = rng.permutation(np.arange(1, num_pages)).astype(np.int32)
    return perm[:slots * max_pages].reshape(slots, max_pages)


# the paged kernel's split-boundary cases (page, head_dim, max_pages):
# splits that straddle pages (page 16) and splits inside one page (128),
# at head_dim 128 and 192, each table holding 2 x 128 + 1 positions or
# more; the lengths are paged_split_lengths'
PAGED_SPLIT_CASES = ((16, 128, 17), (128, 128, 3), (16, 192, 17),
                     (128, 192, 3))


def paged_split_lengths(keys, page, max_pages):
    """Per-slot lengths of one paged launch: 0 and 1, a key either side
    of the first split boundary, one past the second, a page edge and one
    past it, and the full table (none past it)."""
    full = max_pages * page
    return tuple(sorted({min(n, full) for n in (
        0, 1, keys - 1, keys, keys + 1, 2 * keys + 1, page, page + 1,
        full)}))


def _paged_pool_setup(port, lengths, page, seed, max_pages=None):
    """Shuffled page tables for one slot a length (``max_pages`` pages
    each; by default one more than the longest length needs), the
    lengths on the card, the pool positions no slot may see, and the
    tables with every entry past a slot's last live page naming a page
    far outside the pool (which the kernel must never follow)."""
    torch = port["torch"]
    rng = np.random.RandomState(seed)
    slots = len(lengths)
    if max_pages is None:
        max_pages = max(-(-n // page) for n in lengths) + 1
    num_pages = slots * max_pages + 1
    tables_np = _paged_tables(rng, slots, max_pages, num_pages)
    seen_np = np.zeros((num_pages, page), bool)
    poisoned = tables_np.copy()
    for s_, n in enumerate(lengths):
        pos = np.arange(n)
        seen_np[tables_np[s_, pos // page], pos % page] = True
        poisoned[s_, -(-n // page):] = 1 << 30
    return dict(num_pages=num_pages,
                tables=torch.from_numpy(tables_np).to(DEVICE),
                poisoned=torch.from_numpy(poisoned).to(DEVICE),
                lens=torch.tensor(lengths, dtype=torch.int32, device=DEVICE),
                seen=torch.from_numpy(seen_np).to(DEVICE))


def _paged_case(port, dtype, slots, heads, page, d, lengths, seed,
                max_pages=None):
    """The paged kernel against its plain version over shuffled pool
    pages, one slot a length (``slots`` is ``len(lengths)``); a second
    launch must give the same bits, and a pool holding NaN in every
    position its slots may not see, read through tables whose entries
    past each length name no pool page, must give the output of the same
    pool with zeros there."""
    torch, pa = port["torch"], port["pa"]
    assert slots == len(lengths)
    c = _paged_pool_setup(port, lengths, page, seed, max_pages)
    tables, lens = c["tables"], c["lens"]
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    q = _randn(torch, (slots, 3, heads, d), dtype, gen)[:, 0]
    kp, vp = (_randn(torch, (c["num_pages"], heads, page, d), dtype, gen)
              for _ in range(2))
    scale = 1.0 / d ** 0.5
    got = pa.paged_attention(q, kp, vp, tables, lens)
    again = pa.paged_attention(q, kp, vp, tables, lens)
    want = pa.paged_attention_plain(q, kp, vp, tables, lens, scale)
    kg, vg = pa.gather_pages(kp, tables), pa.gather_pages(vp, tables)
    ctx = kg.shape[2]
    p = _masked_probs(torch, q.reshape(slots * heads, d),
                      kg.reshape(slots * heads, ctx, d),
                      lens.repeat_interleave(heads), scale)
    m = torch.einsum("rk,rkd->rd", p,
                     vg.reshape(slots * heads, ctx, d).float().abs())
    err = _hold(torch, f"paged {slots} slots x {heads} heads page {page} "
                f"D {d} lengths {list(lengths)}", dtype, got, want,
                m.reshape(slots, heads, d))
    _check(not bool(got[lens == 0].float().any()),
           "paged: a length-0 slot must give zeros")
    # every position no slot may see: NaN (stale) or 0
    outs = []
    for fill, tbl in ((float("nan"), c["poisoned"]), (0.0, tables)):
        kf, vf = kp.clone(), vp.clone()
        for t in (kf, vf):
            t.masked_fill_(~c["seen"][:, None, :, None], fill)
        outs.append(pa.paged_attention(q, kf, vf, tbl, lens))
    torch.cuda.synchronize()
    _check(torch.equal(again, got), f"paged {dtype} page {page} D {d}: two "
           "launches on the same inputs differ")
    _check(bool(torch.isfinite(outs[0].float()).all())
           and torch.equal(outs[0], outs[1]),
           f"paged {dtype}: NaN past the lengths reached the output")
    return err


def paged_checks(port):
    """Phase 8's paged cases: 8 slots x 16 heads at page 128 and D 128,
    a tiny one at D 16, and the split-boundary cases in bf16 and fp32.
    Returns the largest error."""
    torch, pa = port["torch"], port["pa"]
    err = 0.0
    for i, (dtype, slots, heads, page, d, lengths) in enumerate((
            ("bfloat16", 8, 16, 128, 128, (0, 1, 128, 129, 512, 264, 300, 64)),
            ("float32", 8, 16, 128, 128, (0, 1, 128, 129, 512, 264, 300, 64)),
            ("float32", 5, 4, 16, 16, (0, 1, 16, 17, 40)))):
        err = max(err, _paged_case(port, dtype, slots, heads, page, d,
                                   lengths, 50 + i))
    for i, (page, d, max_pages) in enumerate(PAGED_SPLIT_CASES):
        for dtype in ("bfloat16", "float32"):
            keys = pa.keys_per_split(d, getattr(torch, dtype))
            lengths = paged_split_lengths(keys, page, max_pages)
            err = max(err, _paged_case(port, dtype, len(lengths), 4, page, d,
                                       lengths, 53 + i, max_pages))
        print(f"[decode_kernels] paged page {page} D {d}: split-boundary "
              "lengths in bf16 and fp32, each rerun bit for bit, NaN past "
              "the lengths and table entries naming no page never read")
    return err


def _flash_ragged_case(port, dtype, shape, causal, seed, pad=0):
    """The flash forward at a length that is not a 128-multiple: O and lse
    against the plain version, O under the two bounds, lse fp32.  With
    ``pad`` > 0, q, k and v are views of the first S rows of a fused
    [B, S + pad, 3, N, D] buffer whose rows past S hold NaN: the kernel
    must read none of them, and give bit for bit what it gives when those
    rows hold zeros."""
    torch, fa = port["torch"], port["fa"]
    b, n, s, d = shape
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    buf = _randn(torch, (b, s + pad, 3, n, d), dtype, gen)
    q, k, v = (t[:, :s].transpose(1, 2) for t in buf.unbind(2))
    scale = 1.0 / d ** 0.5
    if pad:
        buf[:, s:] = 0.0
        zero_out, zero_lse = fa.flash_attention_fwd(q, k, v, causal, scale)
        buf[:, s:] = float("nan")
    out, lse = fa.flash_attention_fwd(q, k, v, causal, scale)
    if pad:
        torch.cuda.synchronize()
        _check(torch.equal(out, zero_out) and torch.equal(lse, zero_lse),
               f"flash forward {shape}: NaN rows past seq in the fused "
               "buffer changed the output")
        print(f"[decode_kernels] flash forward {shape} causal={causal}: "
              f"{pad} NaN rows past seq in the fused buffer give O and lse "
              "bit for bit those of zeros there")
    want, want_lse = fa.flash_attention_plain(q, k, v, causal, scale)
    sc = torch.einsum("bnqd,bnkd->bnqk", q.float(), k.float()) * scale
    if causal:
        keep = torch.ones((s, s), dtype=torch.bool, device=DEVICE).tril()
        sc = sc.masked_fill(~keep, float("-inf"))
    m = torch.einsum("bnqk,bnkd->bnqd", torch.softmax(sc, dim=-1),
                     v.float().abs())
    err = _hold(torch, f"flash forward {shape} causal={causal} O", dtype, out,
                want, m)
    e_lse, over = _over(lse, want_lse, FLASH_TOL["float32"][:2])
    _check(over <= 0, f"flash forward {shape}: lse off by {e_lse}")
    return max(err, e_lse)


def _decode_bound(b, h, n, d, itemsize, scales=0):
    """(bound ms, "bytes" | "operations") of one decode-kernel launch over
    ``n`` valid positions per row: K and V of those positions, q and the
    output read or written once, over HBM bandwidth; the QK and PV
    multiply-adds over the peak of the cache dtype.  An int8 cache
    (``itemsize`` 1): fp32 q and output, ``scales`` fp32 scales read, and
    the products in fp32."""
    q_item = 4 if itemsize == 1 else itemsize
    nbytes = (2 * b * h * n * d * itemsize + 2 * b * h * d * q_item + 4 * b
              + 4 * scales)
    flops = 4.0 * b * h * n * d
    peak = PEAK_FLOPS["bfloat16" if q_item == 2 else "float32"]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def _time_decode_kernels(port, n):
    """Device ms per launch at (B 8, H 16, D 128, bf16) over ``n`` valid
    positions: the decode kernel (max_seq 1024), its plain version and
    SDPA on the length-sliced cache; the paged kernel (page 128, shuffled
    pages) and its plain version.  One cache per layer (24 x 64 MiB), so
    each launch finds its keys cold in the 50 MB L2."""
    torch, da, pa = port["torch"], port["da"], port["pa"]
    import torch.nn.functional as F

    b, h, d, L = GEN_BATCH, 16, 128, SERVE_LAYERS
    gen = torch.Generator(device=DEVICE).manual_seed(30 + n)
    q = _randn(torch, (b, h, d), "bfloat16", gen)
    scale = 1.0 / d ** 0.5
    cache = [_randn(torch, (L, b, h, GEN_MAX_SEQ, d), "bfloat16", gen)
             for _ in range(2)]
    length = torch.tensor(n, dtype=torch.int32, device=DEVICE)
    t = {}
    t["decode"], _ = _time_ms(torch, lambda i: da.decode_attention(
        q, cache[0][i % L], cache[1][i % L], length), 240)
    t["decode_plain"], _ = _time_ms(torch, lambda i: da.decode_attention_plain(
        q, cache[0][i % L], cache[1][i % L], n, scale), 24)
    q4 = q[:, :, None]
    t["sdpa"], _ = _time_ms(torch, lambda i: F.scaled_dot_product_attention(
        q4, cache[0][i % L][:, :, :n], cache[1][i % L][:, :, :n],
        scale=scale), 240)
    t["decode_again"], _ = _time_ms(torch, lambda i: da.decode_attention(
        q, cache[0][i % L], cache[1][i % L], length), 240)
    del cache
    max_pages = GEN_MAX_SEQ // GEN_PAGE
    num_pages = b * max_pages + 1
    tables = torch.from_numpy(_paged_tables(
        np.random.RandomState(n), b, max_pages, num_pages)).to(DEVICE)
    lens = torch.full((b,), n, dtype=torch.int32, device=DEVICE)
    pools = [_randn(torch, (L, num_pages, h, GEN_PAGE, d), "bfloat16", gen)
             for _ in range(2)]
    t["paged"], _ = _time_ms(torch, lambda i: pa.paged_attention(
        q, pools[0][i % L], pools[1][i % L], tables, lens), 240)
    t["paged_plain"], _ = _time_ms(torch, lambda i: pa.paged_attention_plain(
        q, pools[0][i % L], pools[1][i % L], tables, lens, scale), 24)
    t["paged_again"], _ = _time_ms(torch, lambda i: pa.paged_attention(
        q, pools[0][i % L], pools[1][i % L], tables, lens), 240)
    del pools
    torch.cuda.empty_cache()
    t["bound"] = _decode_bound(b, h, n, d, 2)
    return t


def phase_decode_kernels(port):
    errs = {"decode": 0.0, "paged": 0.0, "fwd": 0.0}
    for i, (dtype, shape, lengths) in enumerate((
            ("bfloat16", (GEN_BATCH, 16, GEN_MAX_SEQ, 128),
             (1, 200, 201, 1024)),
            ("float32", (GEN_BATCH, 16, GEN_MAX_SEQ, 128),
             (1, 200, 201, 1024)),
            ("float32", (2, 4, 64, 16), (1, 17, 64)))):
        errs["decode"] = max(errs["decode"],
                             _decode_case(port, dtype, shape, lengths, 40 + i))
    for i, (dtype, shape) in enumerate(DECODE_SPLIT_CASES):
        errs["decode"] = max(errs["decode"],
                             decode_split_case(port, dtype, shape, 45 + i))
    errs["paged"] = paged_checks(port)
    for i, (dtype, shape, causal, pad) in enumerate(FLASH_RAGGED_CASES):
        errs["fwd"] = max(errs["fwd"], _flash_ragged_case(
            port, dtype, shape, causal, 60 + i, pad))
    times = {}
    for n in DECODE_TIMED_LENGTHS:
        t = times[n] = _time_decode_kernels(port, n)
        print(f"[decode_kernels] bf16 (B 8, H 16, D 128) length {n} timing "
              f"(device ms per launch): decode kernel {t['decode']!r} then "
              f"{t['decode_again']!r}, plain {t['decode_plain']!r}, SDPA on "
              f"the sliced cache {t['sdpa']!r}; paged kernel {t['paged']!r} "
              f"then {t['paged_again']!r}, plain {t['paged_plain']!r}; bound "
              f"{t['bound'][0]!r} ms ({t['bound'][1]})")
    t = times[DECODE_TIMED_LENGTHS[0]]
    bound_ms, bound_by = t["bound"]
    return {"decode": dict(max_abs_err=errs["decode"],
                           ms=min(t["decode"], t["decode_again"]),
                           plain_ms=t["decode_plain"], bound_ms=bound_ms,
                           bound_by=bound_by, library_ms=t["sdpa"]),
            # no one PyTorch call computes it: a gather plus attention is
            # two calls
            "paged": dict(max_abs_err=errs["paged"],
                          ms=min(t["paged"], t["paged_again"]),
                          plain_ms=t["paged_plain"], bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=None),
            "flash_ragged_err": errs["fwd"]}


# ---------------------------------------------------------------------------
# phase 9: generate with GPT-3 1.3B at full width and depth
# ---------------------------------------------------------------------------

# the generate workload's cache, defined once here;
# tools/port_generate_profile.py profiles the same one
GEN_KW = dict(max_seq_len=GEN_MAX_SEQ, cache_dtype="bfloat16")


def generate_setup(port):
    """GPT-3 1.3B at full width and depth with random bf16 weights (seed
    0) and GEN_BATCH fixed random prompts of GEN_PROMPT tokens on the
    card, warmed up by one short ``generate`` (cuBLAS handles, the
    allocator, the bf16 cache).  Returns ``(model, ids)``."""
    torch = port["torch"]
    cfg = port["gpt_1p3b"]()
    _check(cfg.num_layers == SERVE_LAYERS, "gpt_1p3b has 24 layers")
    model = port["GPT"](cfg, device=DEVICE, dtype="bfloat16", seed=0)
    rng = np.random.RandomState(9)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                       (GEN_BATCH, GEN_PROMPT))).to(DEVICE)
    model.generate(ids, 2, **GEN_KW)
    torch.cuda.synchronize()
    return model, ids


def phase_generate(port):
    torch = port["torch"]
    t0 = time.perf_counter()
    model, ids = generate_setup(port)
    cfg, kw = model.config, GEN_KW
    t1 = time.perf_counter()
    model.generate(ids, 1, **kw)                 # the prefill alone
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t1
    print(f"[generate] gpt_1p3b bf16 set-up and warm-up "
          f"{t1 - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(port)
    t1 = time.perf_counter()
    # without eos_token_id the loop must make no host sync: any
    # synchronizing CUDA call raises while this mode is on
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, logits = model.generate(ids, GEN_NEW, return_logits=True, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = _launch_counts(port)
    peak = torch.cuda.max_memory_allocated()
    L = cfg.num_layers
    _check(tuple(out.shape) == (GEN_BATCH, GEN_PROMPT + GEN_NEW),
           f"generate output shape {tuple(out.shape)}")
    _check(tuple(logits.shape) == (GEN_BATCH, GEN_NEW, cfg.vocab_size)
           and bool(torch.isfinite(logits).all()),
           "generate logits not finite / of the wrong shape")
    _check(torch.equal(out[:, :GEN_PROMPT], ids),
           "the prompt came back changed")
    _check(launches["fwd"] == L and launches["decode"] == L * (GEN_NEW - 1)
           and launches["paged"] == 0 and launches["ragged"] == 0,
           f"generate launches {launches}, expected flash forward {L} and "
           f"decode {L * (GEN_NEW - 1)}")
    decode_ms = 1e3 * (wall - prefill_s) / (GEN_NEW - 1)
    print(f"[generate] batch {GEN_BATCH} prompt {GEN_PROMPT} + {GEN_NEW} new "
          f"tokens (greedy, return_logits, no host sync): {1e3 * wall:.2f} "
          f"ms, prefill "
          f"{1e3 * prefill_s:.2f} ms, mean decode {decode_ms:.3f} ms per "
          f"token (host clock), {GEN_BATCH * GEN_NEW / wall:.1f} tokens/s; "
          f"launches {launches}; peak device memory {peak / 2**30:.2f} GiB")
    samples = []
    for _ in range(2):
        g = torch.Generator(device=DEVICE).manual_seed(1234)
        samples.append(model.generate(ids, 16, do_sample=True,
                                      temperature=0.8, top_k=50, top_p=0.9,
                                      generator=g, **kw))
    same = torch.equal(*samples)
    in_vocab = bool(((samples[0] >= 0) & (samples[0] < cfg.vocab_size)).all())
    print(f"[generate] sampled (temperature 0.8, top-k 50, top-p 0.9) twice "
          f"from one seed: equal {same}, in vocab {in_vocab}")
    _check(same and in_vocab, "sampled generate not reproducible / in vocab")
    model.clear_decode_cache()
    return model, ids, out, logits, launches["decode"]


# ---------------------------------------------------------------------------
# phase 10: the paged step without a plan at full width
# ---------------------------------------------------------------------------

def phase_paged(port, model, ids, out, logits):
    torch = port["torch"]
    cfg = model.config
    b = GEN_BATCH
    max_pages = -(-(GEN_PROMPT + GEN_PAGED_STEPS) // GEN_PAGE) + 1
    num_pages = b * max_pages + 1
    cache = model.new_paged_kv_cache(num_pages, GEN_PAGE, dtype="bfloat16")
    tables = torch.from_numpy(_paged_tables(
        np.random.RandomState(11), b, max_pages, num_pages)).to(DEVICE)

    def step(tok, pos):
        with torch.no_grad():
            return model._paged_lm_logits(
                tok, cache, tables,
                torch.full((b,), pos, dtype=torch.int32, device=DEVICE))

    diffs = []

    def compare(got, j):
        want = logits[:, j]
        got = got.float()
        rel = ((got - want).norm() / want.norm()).item()
        err = (got - want).abs().max().item()
        diffs.append((rel, err))
        _check(bool(torch.isfinite(got).all()), "paged logits not finite")
        _check(rel <= GEN_NORM and err <= GEN_ATOL,
               f"paged step {j}: logits off phase 9's by norm {rel} / max "
               f"{err}")

    _reset_launches(port)
    for lo in range(0, GEN_PROMPT, GEN_CHUNK):
        hi = min(GEN_PROMPT, lo + GEN_CHUNK)
        last = step(ids[:, lo:hi], lo)[:, -1]
    compare(last, 0)
    prefill = _launch_counts(port)
    _check(all(v == 0 for v in prefill.values()),
           f"the chunked prefill launched kernels {prefill}")
    per_step = []
    for j in range(GEN_PAGED_STEPS):
        before = port["pa"].paged_attention.launches
        got = step(out[:, GEN_PROMPT + j:GEN_PROMPT + j + 1], GEN_PROMPT + j)
        per_step.append(port["pa"].paged_attention.launches - before)
        compare(got[:, 0], j + 1)
    torch.cuda.synchronize()
    launches = _launch_counts(port)
    L = cfg.num_layers
    print(f"[paged] 8 slots, page {GEN_PAGE}, chunks of {GEN_CHUNK}, then "
          f"{GEN_PAGED_STEPS} teacher-forced decode steps: logits vs phase 9 "
          f"max norm {max(r for r, _ in diffs):.4g} (tol {GEN_NORM:.4g}), "
          f"max abs {max(e for _, e in diffs):.4g} (tol {GEN_ATOL}); paged "
          f"launches per step {sorted(set(per_step))}, total {launches}")
    _check(all(n == L for n in per_step) and launches["paged"] == L *
           GEN_PAGED_STEPS and launches["decode"] == 0
           and launches["fwd"] == 0 and launches["ragged"] == 0,
           f"paged launches {launches}, per step {per_step}")
    del cache
    torch.cuda.empty_cache()
    return launches["paged"]


# ---------------------------------------------------------------------------
# phase 11: generate card vs CPU on gpt_tiny, fp32
# ---------------------------------------------------------------------------

def _paged_greedy(port, model, ids, new, dtype="float32"):
    """Greedy tokens of the paged path without a plan over a pool of
    ``dtype``: the prompt in chunks of 32, then ``new`` one-token
    steps."""
    torch = port["torch"]
    b, s0 = ids.shape
    cache = model.new_paged_kv_cache(b * 8 + 1, 16, dtype=dtype)
    tables = torch.arange(1, b * 8 + 1, dtype=torch.int32,
                          device=model.device).reshape(b, 8)
    toks = []
    with torch.no_grad():
        for lo in range(0, s0, 32):
            hi = min(s0, lo + 32)
            pos = torch.full((b,), lo, dtype=torch.int32, device=model.device)
            last = model._paged_lm_logits(ids[:, lo:hi], cache, tables,
                                          pos)[:, -1]
        for j in range(new):
            tok = last.argmax(-1)
            toks.append(tok)
            pos = torch.full((b,), s0 + j, dtype=torch.int32,
                             device=model.device)
            last = model._paged_lm_logits(tok[:, None], cache, tables,
                                          pos)[:, 0]
    return torch.stack(toks, 1).cpu().numpy()


def phase_generate_card_vs_cpu(port):
    torch = port["torch"]
    cfg = port["gpt_tiny"](hidden_size=128, num_heads=2)
    cpu = port["GPT"](cfg, device="cpu", dtype="float32", seed=5)
    card = port["GPT"](cfg, device=DEVICE, dtype="float32", seed=5)
    card.load_state_dict(cpu.state_dict())
    ids = np.random.RandomState(3).randint(0, cfg.vocab_size, (2, 77))
    _reset_launches(port)
    outs, paged = [], []
    for m in (cpu, card):
        outs.append(m.generate(ids, 16, max_seq_len=128,
                               cache_dtype="float32").cpu().numpy())
        paged.append(_paged_greedy(port, m, torch.from_numpy(ids).to(
            m.device), 16))
    launches = _launch_counts(port)
    same = np.array_equal(*outs)
    same_paged = np.array_equal(*paged)
    print(f"[generate_card_vs_cpu] gpt_tiny fp32 prompt 77: generate tokens "
          f"equal {same}, paged path tokens equal {same_paged}; card "
          f"launches {launches}")
    _check(same and same_paged, f"card and CPU tokens differ: {outs} "
           f"{paged}")
    _check(launches["fwd"] > 0 and launches["decode"] > 0
           and launches["paged"] > 0,
           "the card did not launch the flash, decode and paged kernels")


# ---------------------------------------------------------------------------
# phase 12: int8 kernels vs plain
# ---------------------------------------------------------------------------

# the int8 kernels take fp32 q, dequantize K and V in fp32 exactly as their
# plain versions do (float(int8) * scale) and leave P unrounded: the fp32
# case of the flash forward's two bounds, FLASH_TOL["float32"][:2]
# elementwise against m and FLASH_O_NORM["float32"] over the whole output
INT8_MM_SHAPES = ((136, 2048, 6144), (8, 2048, 50304))


def _int8_pages(torch, shape, gen):
    """int8 pages of ``shape`` [..., H, rows, D], uniform in [-127, 127],
    and fp32 scales [..., H] in [0.005, 0.035) (an absmax-quantized N(0,
    1) page of 128 x 128 has a scale of about 4 / 127 = 0.031)."""
    q = torch.randint(-127, 128, shape, generator=gen, device=DEVICE,
                      dtype=torch.int8)
    s = torch.rand(shape[:-2], generator=gen, device=DEVICE) * 0.03 + 0.005
    return q, s


def _p_abs_v(torch, q, k, v, lengths, scale):
    """m = P |V| per (row, head): q [R, H, D] over the fp32 contexts k, v
    [R, H, ctx, D], each row masked to its length."""
    r, h, ctx, d = k.shape
    p = _masked_probs(torch, q.reshape(r * h, d), k.reshape(r * h, ctx, d),
                      lengths.repeat_interleave(h), scale)
    return torch.einsum("rk,rkd->rd", p,
                        v.reshape(r * h, ctx, d).abs()).reshape(r, h, d)


def _ragged_int8_compare(port, name, c):
    torch, rpa, pa = port["torch"], port["rpa"], port["pa"]
    scale = 1.0 / c["q"].shape[-1] ** 0.5
    kp, vp, ks, vs = c["k"][0], c["v"][0], c["k_scale"][0], c["v_scale"][0]
    got = rpa.ragged_paged_attention(c["q"], kp, vp, c["tables"],
                                     c["lengths"], c["plan"], k_scale=ks,
                                     v_scale=vs)
    want = rpa.ragged_paged_attention_plain(c["q"], kp, vp, c["tables"],
                                            c["lengths"], scale, ks, vs)
    real = c["stats"]["n_tokens"]
    tbl = c["tables"][:real]
    m = _p_abs_v(torch, c["q"][:real], pa.gather_pages(kp, tbl, ks),
                 pa.gather_pages(vp, tbl, vs), c["lengths"][:real], scale)
    torch.cuda.synchronize()
    _check(got.dtype == torch.float32, "ragged int8: output not fp32")
    err = _hold(torch, f"ragged int8 {name} (blocks "
                f"{c['stats']['n_blocks']}, items {c['stats']['n_items']})",
                "float32", got[:real], want[:real], m, tag="int8_kernels")
    _check(bool((got[real:] == 0).all()), f"ragged int8 {name}: padding "
           "rows not zero")
    _ragged_reruns(port, f"ragged int8 {name}", c, got,
                   dict(k_scale=ks, v_scale=vs))
    return err


def _paged_int8_case(port, slots, heads, page, d, lengths, seed,
                     max_pages=None):
    """The paged int8 kernel against its plain version over shuffled pool
    pages, one slot a length; a second launch must give the same bits,
    and with NaN scales on the pages no slot may see, other values at the
    positions no slot may see and table entries past each length naming
    no pool page, the output must not change, bit for bit."""
    torch, pa = port["torch"], port["pa"]
    assert slots == len(lengths)
    c = _paged_pool_setup(port, lengths, page, seed, max_pages)
    tables, lens, seen = c["tables"], c["lens"], c["seen"]
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    q = _randn(torch, (slots, 3, heads, d), "float32", gen)[:, 0]
    (kp, ks), (vp, vs) = (_int8_pages(torch, (c["num_pages"], heads, page, d),
                                      gen) for _ in range(2))
    scale = 1.0 / d ** 0.5
    got = pa.paged_attention(q, kp, vp, tables, lens, k_scale=ks, v_scale=vs)
    again = pa.paged_attention(q, kp, vp, tables, lens, k_scale=ks,
                               v_scale=vs)
    want = pa.paged_attention_plain(q, kp, vp, tables, lens, scale, ks, vs)
    m = _p_abs_v(torch, q, pa.gather_pages(kp, tables, ks),
                 pa.gather_pages(vp, tables, vs), lens, scale)
    err = _hold(torch, f"paged int8 {slots} slots x {heads} heads page "
                f"{page} D {d} lengths {list(lengths)}", "float32", got, want,
                m, tag="int8_kernels")
    _check(not bool(got[lens == 0].any()),
           "paged int8: a length-0 slot must give zeros")
    kf, vf = kp.clone(), vp.clone()
    for t in (kf, vf):
        t.masked_fill_(~seen[:, None, :, None], 127)
    unseen_page = ~seen.any(dim=1)
    ksf, vsf = ks.clone(), vs.clone()
    for t in (ksf, vsf):
        t.masked_fill_(unseen_page[:, None], float("nan"))
    stale = pa.paged_attention(q, kf, vf, c["poisoned"], lens, k_scale=ksf,
                               v_scale=vsf)
    torch.cuda.synchronize()
    _check(torch.equal(again, got), f"paged int8 page {page} D {d}: two "
           "launches on the same inputs differ")
    _check(torch.equal(stale, got), "paged int8: values past the lengths "
           "reached the output")
    return err


def _decode_int8_case(port, shape, lengths, seed):
    """The decode int8 kernel against its plain version at every length,
    with q a view into a fused QKV buffer."""
    torch, da = port["torch"], port["da"]
    b, h, s, d = shape
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    q = _randn(torch, (b, 3, h, d), "float32", gen)[:, 0]
    (k, ks), (v, vs) = (_int8_pages(torch, shape, gen) for _ in range(2))
    kd, vd = (x.float() * sc[:, :, None, None] for x, sc in ((k, ks), (v, vs)))
    scale = 1.0 / d ** 0.5
    err = 0.0
    for n in lengths:
        got = da.decode_attention(q, k, v, torch.tensor(n, device=DEVICE),
                                  k_scale=ks, v_scale=vs)
        want = da.decode_attention_plain(q, k, v, n, scale, ks, vs)
        m = _p_abs_v(torch, q, kd, vd, torch.full((b,), n, device=DEVICE),
                     scale)
        err = max(err, _hold(torch, f"decode int8 {shape} length {n}",
                             "float32", got, want, m, tag="int8_kernels"))
    return err


def _int_mm_rules(torch):
    """Which shapes ``torch._int_mm`` takes on this card: ``{case: None
    (taken and exact) or the refusal's message}``, for the row counts and
    widths around the rules ``quantization/int8.py`` assumes."""
    out = {}
    for m, k, n in ((8, 64, 64), (16, 64, 64), (17, 64, 64), (20, 64, 64),
                    (24, 64, 64), (25, 64, 64), (136, 64, 64),
                    (137, 64, 64), (24, 64, 192), (24, 2048, 50304),
                    (136, 2048, 6144), (32, 60, 64), (32, 64, 60)):
        a = torch.ones((m, k), dtype=torch.int8, device=DEVICE)
        # the right operand K-contiguous, as quantization/int8.py stores it
        b = torch.ones((n, k), dtype=torch.int8, device=DEVICE).t()
        try:
            ok = bool((torch._int_mm(a, b) == k).all())
            out[f"{m}x{k}x{n}"] = None if ok else "inexact"
        except RuntimeError as e:
            out[f"{m}x{k}x{n}"] = str(e).splitlines()[0][:160]
    return out


def _int8_matmul_case(port, m, k, n, seed):
    """``quantized_matmul`` of x [m, k] by an int8 [k, n] on the card
    against the CPU, bit for bit (weights quantized on both devices, which
    must agree too); then its device ms beside ``torch.addmm`` in bf16 at
    the same shape."""
    torch, qi8 = port["torch"], port["qi8"]
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((k, n), dtype=np.float32)
                         * np.float32(0.02))
    bias = torch.from_numpy(rng.standard_normal(n, dtype=np.float32)
                            * np.float32(0.02))
    wq, ws = qi8.quantize_weight(w, 0)
    cpu = qi8.quantized_matmul(x, wq, ws, bias)
    xd, wd, bd = x.to(DEVICE), w.to(DEVICE), bias.to(DEVICE)
    wqd, wsd = qi8.quantize_weight(wd, 0)
    wqd = qi8.k_major(wqd)                      # as the model stores it
    card = qi8.quantized_matmul(xd, wqd, wsd, bd)
    same_w = torch.equal(wqd.cpu(), wq) and torch.equal(wsd.cpu(), ws)
    same = torch.equal(card.cpu(), cpu)
    print(f"[int8_kernels] quantized_matmul [{m}, {k}] x [{k}, {n}]: card "
          f"equals the CPU bit for bit: {same} (weights quantized equal: "
          f"{same_w}; max abs {(card.cpu() - cpu).abs().max().item()!r})")
    _check(same and same_w, f"quantized_matmul [{m}, {k}] x [{k}, {n}]: "
           "card and CPU differ")
    xb, wb, bb = xd.bfloat16(), wd.bfloat16(), bd.bfloat16()
    t = {"int8": _time_ms(torch, lambda i: qi8.quantized_matmul(
             xd, wqd, wsd, bd), 40)[0],
         "bf16": _time_ms(torch, lambda i: torch.addmm(bb, xb, wb), 40)[0]}
    print(f"[int8_kernels] quantized_matmul [{m}, {k}] x [{k}, {n}] device ms "
          f"(quantize, int32 product on {port['qi8'].int_mm_rows(m)} rows, "
          f"epilogue): "
          f"{t['int8']!r}; torch.addmm bf16 {t['bf16']!r}")
    return t


def _time_int8_attention(port, n):
    """Device ms per launch at (B 8, H 16, D 128) over ``n`` valid
    positions: the decode and paged int8 kernels, their plain versions,
    and the bf16 kernels at the same shape, one cache or pool per layer
    (L2 cold)."""
    torch, da, pa = port["torch"], port["da"], port["pa"]
    b, h, d, L = GEN_BATCH, 16, 128, SERVE_LAYERS
    gen = torch.Generator(device=DEVICE).manual_seed(70 + n)
    q = _randn(torch, (b, h, d), "float32", gen)
    qb = q.bfloat16()
    scale = 1.0 / d ** 0.5
    length = torch.tensor(n, dtype=torch.int32, device=DEVICE)
    t = {}
    (k, ks), (v, vs) = (_int8_pages(torch, (L, b, h, GEN_MAX_SEQ, d), gen)
                        for _ in range(2))
    t["decode"], _ = _time_ms(torch, lambda i: da.decode_attention(
        q, k[i % L], v[i % L], length, k_scale=ks[i % L], v_scale=vs[i % L]),
        240)
    t["decode_plain"], _ = _time_ms(torch, lambda i: da.decode_attention_plain(
        q, k[i % L], v[i % L], n, scale, ks[i % L], vs[i % L]), 24)
    del k, v
    kb, vb = (_randn(torch, (L, b, h, GEN_MAX_SEQ, d), "bfloat16", gen)
              for _ in range(2))
    t["decode_bf16"], _ = _time_ms(torch, lambda i: da.decode_attention(
        qb, kb[i % L], vb[i % L], length), 240)
    del kb, vb
    max_pages = GEN_MAX_SEQ // GEN_PAGE
    num_pages = b * max_pages + 1
    tables = torch.from_numpy(_paged_tables(
        np.random.RandomState(n), b, max_pages, num_pages)).to(DEVICE)
    lens = torch.full((b,), n, dtype=torch.int32, device=DEVICE)
    (kp, ks), (vp, vs) = (_int8_pages(torch, (L, num_pages, h, GEN_PAGE, d),
                                      gen) for _ in range(2))
    t["paged"], _ = _time_ms(torch, lambda i: pa.paged_attention(
        q, kp[i % L], vp[i % L], tables, lens, k_scale=ks[i % L],
        v_scale=vs[i % L]), 240)
    t["paged_plain"], _ = _time_ms(torch, lambda i: pa.paged_attention_plain(
        q, kp[i % L], vp[i % L], tables, lens, scale, ks[i % L], vs[i % L]),
        24)
    del kp, vp
    kb, vb = (_randn(torch, (L, num_pages, h, GEN_PAGE, d), "bfloat16", gen)
              for _ in range(2))
    t["paged_bf16"], _ = _time_ms(torch, lambda i: pa.paged_attention(
        qb, kb[i % L], vb[i % L], tables, lens), 240)
    del kb, vb
    torch.cuda.empty_cache()
    t["decode_bound"] = _decode_bound(b, h, n, d, 1, scales=2 * b * h)
    t["paged_bound"] = _decode_bound(b, h, n, d, 1,
                                     scales=2 * b * h * -(-n // GEN_PAGE))
    return t


def _time_ragged_int8(port):
    """Device ms per launch at phase 2's decode-heavy served shape, one
    pool per layer: the int8 kernel, its plain version and the bf16
    kernel; and the int8 launch's bound."""
    P = served_geometry(port["rpa"])["num_pages"]
    runs = decode_runs(_served_runs(np.random.RandomState(7), P))
    t = time_ragged(port, runs, "int8", seed=98)
    b = time_ragged(port, runs, "bfloat16", plain=False, seed=98)
    return {"ms": min(t["ms"], t["ms_again"]), "plain_ms": t["plain_ms"],
            "bound": t["bound"], "bf16_ms": min(b["ms"], b["ms_again"])}


def int8_attention_checks(port):
    """Phase 12's checks of the int8 ragged, paged and decode kernels
    against their plain versions; returns the largest error of each and
    the decode kernel's launches ("decode_launches")."""
    rpa = port["rpa"]
    errs = {"ragged": 0.0, "paged": 0.0, "decode": 0.0}
    served = served_geometry(rpa)
    tb = _served_runs(np.random.RandomState(12), served["num_pages"])
    for name, runs, seed in (("mixed", mixed_runs(tb), 80),
                             ("decode_heavy", decode_runs(tb), 81),
                             ("prefill_straddle", straddle_runs(tb), 88)):
        c = _case(port, runs, dtype="int8", seed=seed, **served)
        _check(c["stats"]["n_blocks"] < served["nb_max"]
               and c["stats"]["n_items"] < served["wl_max"],
               "cases must leave padding blocks and a repeated tail")
        errs["ragged"] = max(errs["ragged"], _ragged_int8_compare(port, name,
                                                                  c))
    tiny_tb = [np.array(t, np.int32) for t in
               ([5, 3, 1, 7], [2, 0, 0, 0], [4, 6, 8, 9])]
    tiny = _case(port, [(30, 20, tiny_tb[0]), (0, 1, tiny_tb[1]),
                        (47, 1, tiny_tb[2])],
                 num_pages=10, heads=4, page_size=16, head_dim=16, t_max=28,
                 nb_max=6, wl_max=24, max_pages=4, dtype="int8", seed=82,
                 qkv_view=False)
    errs["ragged"] = max(errs["ragged"], _ragged_int8_compare(port, "tiny",
                                                              tiny))
    for i, (slots, heads, page, d, lengths) in enumerate((
            (8, 16, 128, 128, (0, 1, 128, 129, 512, 264, 300, 64)),
            (5, 4, 16, 16, (0, 1, 16, 17, 40)))):
        errs["paged"] = max(errs["paged"], _paged_int8_case(
            port, slots, heads, page, d, lengths, 84 + i))
    pa, torch = port["pa"], port["torch"]
    for i, (page, d, max_pages) in enumerate(PAGED_SPLIT_CASES):
        lengths = paged_split_lengths(pa.keys_per_split(d, torch.int8), page,
                                      max_pages)
        errs["paged"] = max(errs["paged"], _paged_int8_case(
            port, len(lengths), 4, page, d, lengths, 92 + i, max_pages))
    decode0 = port["da"].decode_attention.launches
    for i, (shape, lengths) in enumerate((
            ((GEN_BATCH, 16, GEN_MAX_SEQ, 128), (1, 200, 201, 1024)),
            ((2, 4, 64, 16), (1, 17, 64)))):
        errs["decode"] = max(errs["decode"], _decode_int8_case(
            port, shape, lengths, 86 + i))
    errs["decode_launches"] = port["da"].decode_attention.launches - decode0
    return errs


def phase_int8_kernels(port):
    torch = port["torch"]
    rules = _int_mm_rules(torch)
    for case, why in rules.items():
        print(f"[int8_kernels] torch._int_mm {case}: "
              f"{'taken' if why is None else 'refused: ' + why}")

    errs = int8_attention_checks(port)
    decode_launches = errs.pop("decode_launches")
    torch.cuda.empty_cache()

    r = _time_ragged_int8(port)
    print(f"[int8_kernels] ragged decode_heavy timing (device ms per "
          f"launch): int8 kernel {r['ms']!r}, plain {r['plain_ms']!r}, bf16 "
          f"kernel {r['bf16_ms']!r}; int8 bound {r['bound'][0]!r} "
          f"({r['bound'][1]})")
    times = {}
    for n in DECODE_TIMED_LENGTHS:
        t = times[n] = _time_int8_attention(port, n)
        print(f"[int8_kernels] (B 8, H 16, D 128) length {n} timing (device "
              f"ms per launch): decode int8 kernel {t['decode']!r}, plain "
              f"{t['decode_plain']!r}, bf16 kernel {t['decode_bf16']!r}, "
              f"bound {t['decode_bound'][0]!r} ({t['decode_bound'][1]}); "
              f"paged int8 kernel {t['paged']!r}, plain {t['paged_plain']!r},"
              f" bf16 kernel {t['paged_bf16']!r}, bound "
              f"{t['paged_bound'][0]!r} ({t['paged_bound'][1]})")
    mm = [_int8_matmul_case(port, *shape, seed=90 + i)
          for i, shape in enumerate(INT8_MM_SHAPES)]
    t = times[DECODE_TIMED_LENGTHS[0]]
    # no one PyTorch call computes any of them: dequantization and
    # attention are two calls
    rows = {"ragged": dict(max_abs_err=errs["ragged"], ms=r["ms"],
                           plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
                           bound_by=r["bound"][1], library_ms=None)}
    for key in ("paged", "decode"):
        rows[key] = dict(max_abs_err=errs[key], ms=t[key],
                         plain_ms=t[key + "_plain"],
                         bound_ms=t[key + "_bound"][0],
                         bound_by=t[key + "_bound"][1], library_ms=None)
    rows["matmul_ms"] = mm
    rows["decode_launches"] = decode_launches
    return rows


# ---------------------------------------------------------------------------
# phase 13: int8 serve at full width and depth
# ---------------------------------------------------------------------------

def phase_serve_int8(port):
    """Phase 3's engine and traffic with an int8 pool, first alone, then
    with int8 weights too.  Returns the ragged kernel's launches over
    both runs."""
    torch = port["torch"]
    total = 0
    for wd in (None, "int8"):
        t0 = time.perf_counter()
        eng, rng = serve_engine(port, "int8", wd)
        cache = eng.cache
        bf16_bytes = 2 * cache.k.numel() * 2
        print(f"[serve_int8] gpt_1p3b kv int8, weights {wd or 'bf16'}: "
              f"set-up {time.perf_counter() - t0:.2f} s; pool "
              f"{cache.nbytes} bytes = {cache.nbytes / bf16_bytes:.4f} of "
              f"the bf16 pool's {bf16_bytes}")
        fused0 = eng.metrics()["fused_steps"]
        torch.cuda.reset_peak_memory_stats()
        _reset_launches(port)
        per_step = []
        reqs, step_s, dt = serve_workload(port, eng, rng, per_step)
        counts = _launch_counts(port)
        launches = counts.pop("ragged")
        peak = torch.cuda.max_memory_allocated()
        m = eng.metrics()
        fused = m["fused_steps"] - fused0
        _check(fused == len(per_step) and set(per_step) == {SERVE_LAYERS}
               and not any(counts.values()),
               f"int8 serve: ragged launches per step {sorted(set(per_step))}"
               f" over {len(per_step)} steps ({fused} fused), expected "
               f"{SERVE_LAYERS} each; other kernels {counts}")
        finite = all(bool(torch.isfinite(t).all())
                     for t in (cache.k_scale, cache.v_scale))
        _check(finite, "int8 serve: non-finite scales")
        tokens = sum(len(r.tokens) for r in reqs)
        print(f"[serve_int8] weights {wd or 'bf16'}: {len(reqs)} requests "
              f"DONE, {tokens} tokens in {dt:.3f} s: {tokens / dt:.1f} "
              f"tokens/s; {fused} fused steps, mean step "
              f"{1e3 * float(np.mean(step_s)):.2f} ms (host clock, p50 "
              f"{1e3 * float(np.median(step_s)):.2f} ms); ragged launches "
              f"{launches} ({SERVE_LAYERS} every step); scales finite; peak "
              f"device memory {peak / 2**30:.2f} GiB")
        total += launches
        eng.close()
        del eng, cache
        torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# phase 14: the int8 paged step without a plan at full width
# ---------------------------------------------------------------------------

# phase 14 against phase 9 (int8 pool and int8 weights against bf16
# logits, teacher-forced): an element quantized with a step of absmax/127
# is off by at most half a step, an RMS of (absmax/rms)/(127 sqrt 12) of
# its vector's RMS, at most 0.0137 for an absmax of 6 RMS; each layer
# quantizes K, V and the four projections' inputs and weights (10
# independent errors, sqrt(10) x 0.0137 = 0.043 of its contribution),
# which the residual stream carries as ~0.043 over 24 layers; with phase
# 10's bf16 difference (0.0148) about 0.046.  Held, per step over the
# [8, V] logits, to ||int8 - generate|| <= INT8_GEN_NORM ||generate||:
# 2^-3 before the first card run, tightened to 2^-4 after two runs read
# at most 0.0459 on an H100
INT8_GEN_NORM = 2.0 ** -4


def phase_paged_int8(port, model, ids, out, logits):
    torch = port["torch"]
    cfg = model.config
    b = GEN_BATCH
    model.quantize_weights()
    max_pages = -(-(GEN_PROMPT + GEN_PAGED_STEPS) // GEN_PAGE) + 1
    num_pages = b * max_pages + 1
    cache = model.new_paged_kv_cache(num_pages, GEN_PAGE, dtype="int8")
    tables = torch.from_numpy(_paged_tables(
        np.random.RandomState(11), b, max_pages, num_pages)).to(DEVICE)

    def step(tok, pos):
        with torch.no_grad():
            return model._paged_lm_logits(
                tok, cache, tables,
                torch.full((b,), pos, dtype=torch.int32, device=DEVICE))

    rels, agree = [], []

    def compare(got, j):
        want = logits[:, j]
        _check(got.dtype == torch.float32 and bool(torch.isfinite(got).all()),
               "int8 paged logits not fp32 / not finite")
        rels.append(((got - want).norm() / want.norm()).item())
        agree.append((got.argmax(-1) == want.argmax(-1)).float().mean().item())

    _reset_launches(port)
    for lo in range(0, GEN_PROMPT, GEN_CHUNK):
        hi = min(GEN_PROMPT, lo + GEN_CHUNK)
        last = step(ids[:, lo:hi], lo)[:, -1]
    compare(last, 0)
    prefill = _launch_counts(port)
    _check(all(v == 0 for v in prefill.values()),
           f"the int8 chunked prefill launched kernels {prefill}")
    per_step = []
    for j in range(GEN_PAGED_STEPS):
        before = port["pa"].paged_attention.launches
        got = step(out[:, GEN_PROMPT + j:GEN_PROMPT + j + 1], GEN_PROMPT + j)
        per_step.append(port["pa"].paged_attention.launches - before)
        compare(got[:, 0], j + 1)
    torch.cuda.synchronize()
    launches = _launch_counts(port)
    L = cfg.num_layers
    print(f"[paged_int8] int8 pool and weights, 8 slots, page {GEN_PAGE}, "
          f"chunks of {GEN_CHUNK}, then {GEN_PAGED_STEPS} teacher-forced "
          f"decode steps: logits vs phase 9's bf16 relative norm max "
          f"{max(rels):.4g} mean {float(np.mean(rels)):.4g} (tol "
          f"{INT8_GEN_NORM:.4g}); top-1 agreement {float(np.mean(agree)):.4f}"
          f" (min per step {min(agree):.3f}); paged launches per step "
          f"{sorted(set(per_step))}, total {launches}")
    _check(max(rels) <= INT8_GEN_NORM,
           f"int8 paged logits off phase 9's by norm {max(rels)}")
    _check(all(n == L for n in per_step)
           and launches["paged"] == L * GEN_PAGED_STEPS
           and launches["decode"] == 0 and launches["fwd"] == 0
           and launches["ragged"] == 0,
           f"int8 paged launches {launches}, per step {per_step}")
    del cache
    torch.cuda.empty_cache()
    return launches["paged"]


# ---------------------------------------------------------------------------
# phase 15: int8 card vs CPU on gpt_tiny, fp32
# ---------------------------------------------------------------------------

def phase_int8_card_vs_cpu(port):
    torch = port["torch"]
    cfg = port["gpt_tiny"]()
    cpu = port["GPT"](cfg, device="cpu", dtype="float32", seed=6)
    card = port["GPT"](cfg, device=DEVICE, dtype="float32", seed=6)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(6)
    prompts = [rng.randint(0, cfg.vocab_size, (s,))
               for s in (4, 17, 7, 21, 11, 5)]
    kw = dict(num_slots=2, page_size=16, max_context=64, kv_dtype="int8",
              weight_dtype="int8", prefill_token_budget=6)
    _reset_launches(port)
    outs, paged = [], []
    for m in (cpu, card):
        outs.append(port["ServingEngine"](m, **kw).generate_batch(prompts, 8))
        ids = torch.from_numpy(np.stack([p[:4] for p in prompts[:2]]))
        paged.append(_paged_greedy(port, m, ids.to(m.device), 8, "int8"))
    launches = _launch_counts(port)
    same = all(np.array_equal(a, b) for a, b in zip(*outs))
    same_paged = np.array_equal(*paged)
    print(f"[int8_card_vs_cpu] gpt_tiny fp32, int8 KV and weights: engine "
          f"greedy tokens equal {same}, paged path tokens equal "
          f"{same_paged}; card launches {launches}")
    _check(same and same_paged, f"card and CPU int8 tokens differ: {outs} "
           f"{paged}")
    _check(launches["ragged"] > 0 and launches["paged"] > 0,
           "the card did not launch the ragged and paged int8 kernels")


# ---------------------------------------------------------------------------
# phase 16: the fused add + norm kernels vs plain
# ---------------------------------------------------------------------------

# rows x hidden: the BERT-base encoder's rows (batch 16 x seq 512), GPT-3
# 1.3B's trained rows (8 x 1024), a shape the TPU gate refuses (hidden not
# a 128-multiple; bf16 rows not 16-byte multiples, so scalar loads), one
# row, zero rows, and rows longer than the kernel holds in registers
BERT_ROWS, GPT_ROWS = (16 * 512, 768), (8 * 1024, 2048)
NORM_SHAPES = (BERT_ROWS, GPT_ROWS, (257, 100), (1, 768), (0, 768),
               (64, 20000))
NORM_EPS = (1e-12, 1e-5)
# kernel vs plain, normed held to (atol, rtol, norm) as phase 5 holds the
# flash kernels: elementwise |kernel - plain| <= atol + rtol * m, where m
# is the sum of the absolute terms of the output (|h - mu| inv |g| + |b|
# for LayerNorm, |h| inv |g| for RMSNorm), and over the whole output by
# relative norm.  fp32: the statistics summed in another order (a tree of
# warp shuffles against the plain version's reduction), ~1e-7 of each
# term; bf16: the same fp32 values rounded once, so an element near a
# rounding midpoint may round to the neighbouring bf16 value (one ulp,
# at most 2^-7 of m); few do, so the norm stays far below an ulp.
# h is one fp32 add and one cast: held bit for bit.
NORM_TOL = {"float32": (1e-6, 1e-5, 1e-6),
            "bfloat16": (1e-5, 2.0 ** -7, 2.0 ** -11)}
# BERT-base's attention, bf16 and non-causal: the flash forward at the
# shape phases 17 and 18 run
BERT_ATTN_SHAPE = (16, 12, 512, 64)
NORM_TIMING_SETS = 4          # input sets rotated, so the L2 is cold


def _norm_inputs(torch, rows, hidden, dtype, param_dtype, seed):
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    x, r = (_randn(torch, (rows, hidden), dtype, gen) for _ in range(2))
    g, b = (_randn(torch, (hidden,), param_dtype, gen) for _ in range(2))
    return x, r, g, b


def _norm_magnitude(torch, h, g, b, eps, layer_norm):
    """m: the sum of the absolute terms of each normed element, in fp32."""
    h, g = h.float(), g.float()
    if layer_norm:
        d = h - h.mean(-1, keepdim=True)
        inv = 1.0 / torch.sqrt((d * d).mean(-1, keepdim=True) + eps)
        return d.abs() * inv * g.abs() + b.float().abs()
    inv = 1.0 / torch.sqrt((h * h).mean(-1, keepdim=True) + eps)
    return h.abs() * inv * g.abs()


def _norm_case(port, layer_norm, dtype, shape, eps, seed, param_dtype=None,
               residual_dtype=None, misaligned=False):
    """One kernel call against its plain version: h bit for bit, normed
    under NORM_TOL.  ``misaligned`` offsets every operand by one element
    (the kernel's scalar-load path).  Returns the max abs error of
    normed."""
    torch, rn = port["torch"], port["rn"]
    rows, hidden = shape
    x, r, g, b = _norm_inputs(torch, rows + misaligned, hidden, dtype,
                              param_dtype or dtype, seed)
    if misaligned:
        x, r = (t.view(-1)[1:1 + rows * hidden].view(rows, hidden)
                for t in (x, r))
    if residual_dtype:
        r = r.to(getattr(torch, residual_dtype))
    kernel = rn.fused_add_layer_norm if layer_norm else rn.fused_add_rms_norm
    params = (g, b) if layer_norm else (g,)
    before = kernel.launches
    out, h = kernel(x, r, *params, eps=eps)
    want, want_h = (rn.fused_add_layer_norm_plain if layer_norm
                    else rn.fused_add_rms_norm_plain)(x, r, *params, eps=eps)
    torch.cuda.synchronize()
    name = (f"{'layer_norm' if layer_norm else 'rms_norm'} {dtype} "
            f"{shape} eps {eps:g}" + (f" params {param_dtype}" if param_dtype
                                      else "")
            + (f" residual {residual_dtype}" if residual_dtype else "")
            + (" misaligned" if misaligned else ""))
    _check(kernel.launches - before == (1 if rows else 0),
           f"{name}: {kernel.launches - before} launches")
    _check(out.shape == h.shape == x.shape and out.dtype == x.dtype,
           f"{name}: outputs {out.shape} {out.dtype}")
    if not rows:
        print(f"[norm_kernels] {name}: empty outputs, no launch")
        return 0.0
    same_h = torch.equal(h, want_h)
    atol, rtol, norm = NORM_TOL[dtype]
    m = _norm_magnitude(torch, x.float() + r.float(), g, b, eps, layer_norm)
    err, over = _over(out, want, (atol, rtol), m)
    rel = ((out.float() - want.float()).norm()
           / want.float().norm().clamp_min(1e-30)).item()
    finite = bool(torch.isfinite(out).all())
    print(f"[norm_kernels] {name}: normed max_abs_err={err!r} (tol "
          f"{atol:.3g}+{rtol:.3g}*m), norm {rel:.3g} (tol {norm:.3g}); h "
          f"equal bit for bit: {same_h}")
    _check(finite and same_h, f"{name}: non-finite output or h differs")
    _check(over <= 0 and rel <= norm,
           f"{name}: normed off by more than the tolerance")
    return err


def _norm_nan_rows(port):
    """A NaN in one row of x leaves every other row of both outputs
    unchanged, bit for bit."""
    torch, rn = port["torch"], port["rn"]
    x, r, g, b = _norm_inputs(torch, *BERT_ROWS, "bfloat16", "bfloat16", 70)
    clean = rn.fused_add_layer_norm(x, r, g, b, eps=1e-12)
    x[3, 100] = float("nan")
    dirty = rn.fused_add_layer_norm(x, r, g, b, eps=1e-12)
    keep = torch.ones(x.shape[0], dtype=torch.bool, device=DEVICE)
    keep[3] = False
    same = all(torch.equal(a[keep], c[keep]) for a, c in zip(clean, dirty))
    print(f"[norm_kernels] NaN in row 3 of {BERT_ROWS}: other rows "
          f"unchanged: {same}; row 3 normed all NaN: "
          f"{bool(dirty[0][3].float().isnan().all())}")
    _check(same, "a NaN in one row changed another row")


def _norm_bound(rows, hidden, itemsize, params):
    """(bound ms, "bytes"): x and residual read, normed and h written once,
    the parameters read once, over HBM bandwidth (~10 operations an
    element are far below the card's rate)."""
    nbytes = 4 * rows * hidden * itemsize + params * hidden * itemsize
    return 1e3 * nbytes / HBM_BYTES_PER_S, "bytes"


def _time_norms(port, shape):
    """Device ms per call at ``shape`` in bf16 (the L2 cold: NORM_TIMING_SETS
    input sets in turn): each kernel, its plain version, and the two
    PyTorch calls ``torch.add`` then ``F.layer_norm`` / ``F.rms_norm``."""
    torch, rn = port["torch"], port["rn"]
    import torch.nn.functional as F

    sets = [_norm_inputs(torch, *shape, "bfloat16", "bfloat16", 80 + i)
            for i in range(NORM_TIMING_SETS)]
    n = NORM_TIMING_SETS
    hidden = shape[1]
    t = {}
    t["ln"], _ = _time_ms(torch, lambda i: rn.fused_add_layer_norm(
        *sets[i % n], eps=1e-12), 200)
    t["ln_plain"], _ = _time_ms(torch, lambda i: rn.fused_add_layer_norm_plain(
        *sets[i % n], eps=1e-12), 20)
    t["ln_library"], _ = _time_ms(torch, lambda i: F.layer_norm(
        torch.add(sets[i % n][0], sets[i % n][1]), (hidden,), sets[i % n][2],
        sets[i % n][3], 1e-12), 200)
    t["rms"], _ = _time_ms(torch, lambda i: rn.fused_add_rms_norm(
        *sets[i % n][:3], eps=1e-6), 200)
    t["rms_plain"], _ = _time_ms(torch, lambda i: rn.fused_add_rms_norm_plain(
        *sets[i % n][:3], eps=1e-6), 20)
    t["rms_library"] = None
    if hasattr(F, "rms_norm"):
        t["rms_library"], _ = _time_ms(torch, lambda i: F.rms_norm(
            torch.add(sets[i % n][0], sets[i % n][1]), (hidden,),
            sets[i % n][2], 1e-6), 200)
    t["ln_again"], _ = _time_ms(torch, lambda i: rn.fused_add_layer_norm(
        *sets[i % n], eps=1e-12), 200)
    del sets
    torch.cuda.empty_cache()
    return t


def _time_bert_flash(port):
    """Device ms of the flash forward at BERT_ATTN_SHAPE (bf16,
    non-causal), its plain version and SDPA, beside its bound."""
    torch, fa = port["torch"], port["fa"]
    import torch.nn.functional as F

    (q, k, v), _ = _qkv(torch, BERT_ATTN_SHAPE, "bfloat16", 90)
    scale = 1.0 / BERT_ATTN_SHAPE[-1] ** 0.5
    t = {}
    t["fwd"], _ = _time_ms(
        torch, lambda i: fa.flash_attention_fwd(q, k, v, False, scale), 40)
    t["plain"], _ = _time_ms(
        torch, lambda i: fa.flash_attention_plain(q, k, v, False, scale), 5)
    t["sdpa"], _ = _time_ms(torch, lambda i: F.scaled_dot_product_attention(
        q, k, v, scale=scale), 40)
    t["bound"] = _flash_bounds(BERT_ATTN_SHAPE, False, 2)["fwd"]
    return t


def phase_norm_kernels(port):
    torch, rn = port["torch"], port["rn"]
    errs = {"ln": 0.0, "rms": 0.0}
    _reset_launches(port)
    seed = 100
    for layer_norm in (True, False):
        key = "ln" if layer_norm else "rms"
        for dtype in ("float32", "bfloat16"):
            for shape in NORM_SHAPES:
                for eps in NORM_EPS:
                    seed += 1
                    errs[key] = max(errs[key], _norm_case(
                        port, layer_norm, dtype, shape, eps, seed))
        # bf16 activations with fp32 parameters; operands off a 16-byte
        # boundary (scalar loads); x and residual of two dtypes
        for kw in (dict(param_dtype="float32"), dict(misaligned=True),
                   dict(residual_dtype="bfloat16")):
            seed += 1
            dtype = "float32" if "residual_dtype" in kw else "bfloat16"
            errs[key] = max(errs[key], _norm_case(
                port, layer_norm, dtype, BERT_ROWS, 1e-12, seed, **kw))
    rms_launches = rn.fused_add_rms_norm.launches
    _norm_nan_rows(port)
    flash_err = max(_flash_compare(port, "bfloat16", BERT_ATTN_SHAPE, False,
                                   seed=110))
    torch.cuda.empty_cache()
    times = {}
    for shape in (BERT_ROWS, GPT_ROWS):
        t = times[shape] = _time_norms(port, shape)
        ln_bound = _norm_bound(*shape, 2, 2)
        rms_bound = _norm_bound(*shape, 2, 1)
        print(f"[norm_kernels] bf16 {shape} timing (device ms per call): "
              f"layer_norm kernel {t['ln']!r} (again, as a spread check: "
              f"{t['ln_again']!r}), plain "
              f"{t['ln_plain']!r}, torch.add + F.layer_norm (two calls) "
              f"{t['ln_library']!r}, bound {ln_bound[0]!r} ({ln_bound[1]}); "
              f"rms_norm kernel {t['rms']!r}, plain {t['rms_plain']!r}, "
              f"torch.add + F.rms_norm (two calls) {t['rms_library']!r}, "
              f"bound {rms_bound[0]!r} ({rms_bound[1]})")
    fb = _time_bert_flash(port)
    print(f"[norm_kernels] flash forward bf16 {BERT_ATTN_SHAPE} non-causal "
          f"timing (device ms per call): kernel {fb['fwd']!r}, plain "
          f"{fb['plain']!r}, SDPA {fb['sdpa']!r} (kernel / SDPA "
          f"{fb['fwd'] / fb['sdpa']!r}), bound {fb['bound'][0]!r} "
          f"({fb['bound'][1]}; share of it {fb['bound'][0] / fb['fwd']!r})")
    t = times[BERT_ROWS]
    # no one PyTorch call computes it: the add and the norm are two calls
    return {"ln": dict(max_abs_err=errs["ln"], ms=t["ln"],
                       plain_ms=t["ln_plain"],
                       bound_ms=_norm_bound(*BERT_ROWS, 2, 2)[0],
                       bound_by="bytes", library_ms=None),
            "rms": dict(max_abs_err=errs["rms"], ms=t["rms"],
                        plain_ms=t["rms_plain"],
                        bound_ms=_norm_bound(*BERT_ROWS, 2, 1)[0],
                        bound_by="bytes", library_ms=None),
            "rms_launches": rms_launches, "flash_err": flash_err,
            "bert_flash": dict(bert_ms=fb["fwd"], bert_sdpa_ms=fb["sdpa"],
                               bert_ratio=fb["fwd"] / fb["sdpa"],
                               bert_bound_ms=fb["bound"][0],
                               bert_bound_share=fb["bound"][0] / fb["fwd"])}


# ---------------------------------------------------------------------------
# phase 17: the fused post-LN encoder at BERT-base width
# ---------------------------------------------------------------------------

ENC_BATCH, ENC_SEQ = 16, 512
ENC_FORWARDS = 5
# the fused stack against BertModel's layers built from the same weights,
# by relative norm of the encoder output.  The stacks differ only in the
# norms: the fused kernel normalises the fp32 sum x + y, BertLayer the sum
# rounded to the activation dtype, then F.layer_norm.  fp32: the sums'
# order (~1e-7 a norm) carried through 12 layers; bf16: one bf16 rounding
# of h (2^-9 of each element) at each of 24 norms, a random walk of
# ~sqrt(24) 2^-9 = 0.01 that the bf16 products after it keep
ENC_NORM = {"float32": 2.0 ** -16, "bfloat16": 2.0 ** -5}
# phase 17's two-pair backward, fp32, against autograd of the plain
# forward, per gradient by relative norm: the flash backward kernels'
# fp32 sums (FLASH_GRAD_TOL's 1e-5 of the norm per kernel) through two layers
ENC_GRAD_NORM = 2.0 ** -14
ENC_GRAD_BATCH = 4


def _fused_pairs(port, cfg, dtype, normalize_before=False, seed=0,
                 layers=None, dropout=(0.5, 0.5, 0.1), device=None):
    """``layers`` (MHA, FFN) pairs of the incubate layers at ``cfg``'s
    width (GELU, BERT's eps; all of cfg's layers by default), in eval
    mode, on ``device`` (the card by default)."""
    inc, torch = port["incubate"], port["torch"]
    device = device or DEVICE
    pairs = []
    for i in range(cfg.num_layers if layers is None else layers):
        mha = inc.FusedMultiHeadAttention(
            cfg.hidden_size, cfg.num_heads, dropout[0], dropout[1],
            normalize_before=normalize_before, epsilon=cfg.layer_norm_eps,
            device=device, dtype=dtype, seed=seed + 2 * i)
        ffn = inc.FusedFeedForward(
            cfg.hidden_size, cfg.intermediate_size, dropout[2],
            cfg.layer_norm_eps, "gelu", normalize_before=normalize_before,
            device=device, dtype=dtype, seed=seed + 2 * i + 1)
        pairs.append(torch.nn.ModuleList([mha, ffn]))
    return torch.nn.ModuleList(pairs).eval()


def _copy_bert_layers(pairs, bert):
    """The fused pairs take ``bert``'s encoder weights: qkv -> qkv, out ->
    out_proj, ln1 -> the attention's ln, fc1/fc2 -> linear1/linear2, ln2
    -> the feed-forward's ln."""
    for (mha, ffn), layer in zip(pairs, bert.layers):
        for dst, src in ((mha.qkv, layer.attention.qkv),
                         (mha.out_proj, layer.attention.out),
                         (mha.ln, layer.ln1), (ffn.linear1, layer.fc1),
                         (ffn.linear2, layer.fc2), (ffn.ln, layer.ln2)):
            dst.load_state_dict(src.state_dict())


def _run_pairs(pairs, x):
    for mha, ffn in pairs:
        x = ffn(mha(x))
    return x


def _plain_pairs(port, pairs, x):
    """The pairs' post-LN forward from plain versions only: the flash
    forward's and the fused norm's (autograd differentiates them)."""
    fa, rn, F = port["fa"], port["rn"], port["F"]
    for mha, ffn in pairs:
        b, s, e = x.shape
        nh, hd = mha.num_heads, mha.head_dim
        q, k, v = (t.transpose(1, 2) for t in F.linear(
            x, mha.qkv.weight, mha.qkv.bias).view(b, s, 3, nh,
                                                   hd).unbind(2))
        o = fa.flash_attention_plain(q, k, v, False, hd ** -0.5)[0]
        o = F.linear(o.transpose(1, 2).reshape(b, s, e), mha.out_proj.weight,
                     mha.out_proj.bias)
        x = rn.fused_add_layer_norm_plain(o, x, mha.ln.weight, mha.ln.bias,
                                          mha.ln.epsilon)[0]
        y = F.linear(F.gelu(F.linear(x, ffn.linear1.weight,
                                     ffn.linear1.bias)),
                     ffn.linear2.weight, ffn.linear2.bias)
        x = rn.fused_add_layer_norm_plain(y, x, ffn.ln.weight, ffn.ln.bias,
                                          ffn.ln.epsilon)[0]
    return x


def _rel(a, b):
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def _enc_input(torch, dtype, hidden, batch=ENC_BATCH, seed=120):
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    return _randn(torch, (batch, ENC_SEQ, hidden), dtype, gen)


def _enc_vs_bert(port, dtype):
    """The fused stack against a bert_base BertModel's encoder layers
    whose weights it took, on one input: relative norm within
    ENC_NORM."""
    torch = port["torch"]
    bert = port["BertModel"](port["bert_base"](), device=DEVICE, dtype=dtype,
                             seed=7).eval()
    pairs = _fused_pairs(port, bert.config, dtype)
    _copy_bert_layers(pairs, bert)
    x = _enc_input(torch, dtype, bert.config.hidden_size)
    with torch.no_grad():
        got = _run_pairs(pairs, x)
        want = x
        for layer in bert.layers:
            want = layer(want)
    torch.cuda.synchronize()
    rel = _rel(got, want)
    err = (got.float() - want.float()).abs().max().item()
    print(f"[encoder] fused post-LN stack vs BertModel layers, {dtype} "
          f"{tuple(x.shape)}: relative norm {rel:.4g} (tol "
          f"{ENC_NORM[dtype]:.4g}), max abs {err!r}")
    _check(bool(torch.isfinite(got).all()), f"encoder {dtype}: non-finite")
    _check(rel <= ENC_NORM[dtype], f"encoder {dtype}: the fused stack and "
           "BertModel's layers differ by more than the tolerance")
    return bert


def _enc_backward(port):
    """Two post-LN pairs in training mode (dropout 0: the fused branch),
    fp32, BERT-base width: one forward and backward through the kernels
    against autograd of the plain forward, gradient by gradient."""
    torch = port["torch"]
    cfg = port["bert_base"]()
    pairs = _fused_pairs(port, cfg, "float32", seed=30, layers=2,
                         dropout=(0.0, 0.0, 0.0)).train()
    x = _enc_input(torch, "float32", cfg.hidden_size, ENC_GRAD_BATCH, 121)
    gen = torch.Generator(device=DEVICE).manual_seed(122)
    cot = torch.randn(x.shape, generator=gen, device=DEVICE)
    params = list(pairs.parameters())
    _reset_launches(port)
    xk = x.clone().requires_grad_(True)
    (_run_pairs(pairs, xk) * cot).sum().backward()
    launches = _launch_counts(port)
    got = [xk.grad] + [p.grad.clone() for p in params]
    pairs.zero_grad(set_to_none=True)
    xp = x.clone().requires_grad_(True)
    (_plain_pairs(port, pairs, xp) * cot).sum().backward()
    want = [xp.grad] + [p.grad for p in params]
    torch.cuda.synchronize()
    rels = [_rel(a, b) for a, b in zip(got, want)]
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    print(f"[encoder] two fp32 post-LN pairs, forward and backward at "
          f"{tuple(x.shape)}: {len(got)} gradients, max "
          f"relative norm {max(rels):.4g} (tol {ENC_GRAD_NORM:.4g}) against "
          f"autograd of the plain forward; launches {launches}")
    _check(finite, "encoder backward: non-finite gradients")
    _check(max(rels) <= ENC_GRAD_NORM, "encoder backward: gradients off by "
           "more than the tolerance")
    _check(launches["ln"] == 4 and launches["fwd"] == 2
           and launches["dkv"] == 2 and launches["dq"] == 2,
           f"encoder backward launches {launches}")


def phase_encoder(port):
    torch = port["torch"]
    _enc_vs_bert(port, "float32")
    bert = _enc_vs_bert(port, "bfloat16")
    pairs = _fused_pairs(port, bert.config, "bfloat16")
    _copy_bert_layers(pairs, bert)
    del bert
    x = _enc_input(torch, "bfloat16", pairs[0][0].embed_dim)
    torch.cuda.empty_cache()
    with torch.no_grad():
        _run_pairs(pairs, x)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches(port)
        t0 = time.perf_counter()
        for _ in range(ENC_FORWARDS):
            out = _run_pairs(pairs, x)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / ENC_FORWARDS
        launches = _launch_counts(port)
        peak = torch.cuda.max_memory_allocated()
        _check(bool(torch.isfinite(out).all()), "encoder: non-finite output")
        L = len(pairs)
        _check(launches["ln"] == 2 * L * ENC_FORWARDS
               and launches["fwd"] == L * ENC_FORWARDS,
               f"encoder launches over {ENC_FORWARDS} forwards {launches}, "
               f"expected {2 * L} norm and {L} flash forward per forward")
        tokens = ENC_BATCH * ENC_SEQ
        print(f"[encoder] {L} post-LN pairs bf16 at {ENC_BATCH} x {ENC_SEQ}: "
              f"{1e3 * wall:.3f} ms per forward (host clock), "
              f"{tokens / wall:.1f} tokens/s; launches per forward "
              f"{ {k: v // ENC_FORWARDS for k, v in launches.items()} }; "
              f"peak device memory {peak / 2**30:.2f} GiB")
        pre = _fused_pairs(port, port["bert_base"](), "bfloat16",
                           normalize_before=True, seed=50)
        _reset_launches(port)
        _run_pairs(pre, x)
        torch.cuda.synchronize()
        pre_launches = _launch_counts(port)
        print(f"[encoder] pre-LN stack: launches {pre_launches}")
        _check(pre_launches["ln"] == 0 and pre_launches["fwd"] == L,
               f"pre-LN stack launches {pre_launches}")
    del pairs, pre, x, out
    torch.cuda.empty_cache()
    _enc_backward(port)
    torch.cuda.empty_cache()
    return launches["ln"]


# ---------------------------------------------------------------------------
# phase 18: BERT-base forward
# ---------------------------------------------------------------------------

# Google BERT's max_predictions_per_seq at seq 512, and its masked_lm_prob
BERT_MASKED, BERT_MASK_PROB = 80, 0.15
BERT_PAD_LENGTHS = (512, 384, 200, 77)
BERT_FORWARDS = 3


def _bert_batch(torch, cfg, lengths, seed):
    """ids, token types, masked positions (each row's ~15 % of its valid
    tokens past [CLS], at most BERT_MASKED, padded with position 0 and
    weight 0), MLM labels and weights, NSP labels and the 1/0 attention
    mask of rows of ``lengths``."""
    rng = np.random.RandomState(seed)
    b = len(lengths)
    ids = rng.randint(0, cfg.vocab_size, (b, ENC_SEQ))
    types = rng.randint(0, 2, (b, ENC_SEQ))
    mask = np.zeros((b, ENC_SEQ), np.int64)
    pos = np.zeros((b, BERT_MASKED), np.int64)
    weights = np.zeros((b, BERT_MASKED), np.float32)
    for i, n in enumerate(lengths):
        mask[i, :n] = 1
        k = (BERT_MASKED if n == ENC_SEQ
             else min(BERT_MASKED, max(1, round(n * BERT_MASK_PROB))))
        pos[i, :k] = np.sort(rng.choice(np.arange(1, n), k, replace=False))
        weights[i, :k] = 1.0
    labels = rng.randint(0, cfg.vocab_size, (b, BERT_MASKED))
    nsp = rng.randint(0, 2, (b,))
    to = lambda a: torch.from_numpy(a).to(DEVICE)   # noqa: E731
    return dict(ids=to(ids), types=to(types), mask=to(mask), pos=to(pos),
                weights=to(weights), labels=to(labels), nsp=to(nsp))


def _bert_forwards(port, model, d, masked, n):
    """``n`` timed forwards after one warm-up; returns (logits, loss, ms
    per forward, launches per forward)."""
    torch = port["torch"]
    kw = dict(token_type_ids=d["types"], masked_positions=d["pos"],
              attention_mask=d["mask"] if masked else None)
    with torch.no_grad():
        model(d["ids"], **kw)
        torch.cuda.synchronize()
        _reset_launches(port)
        t0 = time.perf_counter()
        for _ in range(n):
            mlm, nsp = model(d["ids"], **kw)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n
        launches = {k: v // n for k, v in _launch_counts(port).items()}
        loss = port["BertPretrainingCriterion"]()(
            mlm, nsp, d["labels"], d["nsp"], d["weights"])
    return mlm, nsp, float(loss), 1e3 * wall, launches


def phase_bert(port):
    torch = port["torch"]
    cfg = port["bert_base"]()
    model = port["BertForPretraining"](cfg, device=DEVICE, dtype="bfloat16",
                                       seed=0).eval()
    torch.cuda.reset_peak_memory_stats()
    full = _bert_batch(torch, cfg, (ENC_SEQ,) * ENC_BATCH, 130)
    lengths = [BERT_PAD_LENGTHS[i % len(BERT_PAD_LENGTHS)]
               for i in range(ENC_BATCH)]
    padded = _bert_batch(torch, cfg, lengths, 131)
    tokens = ENC_BATCH * ENC_SEQ
    for name, d, masked, want_flash in (
            ("no attention_mask", full, False, cfg.num_layers),
            (f"padding mask, lengths cycling {BERT_PAD_LENGTHS}", padded,
             True, 0)):
        mlm, nsp, loss, ms, launches = _bert_forwards(port, model, d, masked,
                                                      BERT_FORWARDS)
        finite = (bool(torch.isfinite(mlm).all())
                  and bool(torch.isfinite(nsp).all()) and np.isfinite(loss))
        print(f"[bert] bert_base bf16 {ENC_BATCH} x {ENC_SEQ}, "
              f"{BERT_MASKED} masked positions a row, {name}: {ms:.3f} ms "
              f"per forward (host clock), {tokens / (ms / 1e3):.1f} "
              f"tokens/s; mlm logits {tuple(mlm.shape)} {mlm.dtype}, "
              f"criterion {loss!r}; launches per forward {launches}")
        _check(tuple(mlm.shape) == (ENC_BATCH, BERT_MASKED, cfg.vocab_size)
               and tuple(nsp.shape) == (ENC_BATCH, 2),
               f"bert {name}: logits {tuple(mlm.shape)} {tuple(nsp.shape)}")
        _check(finite, f"bert {name}: non-finite logits or criterion")
        _check(launches["fwd"] == want_flash,
               f"bert {name}: {launches['fwd']} flash launches per forward, "
               f"expected {want_flash}")
    print(f"[bert] peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del model, full, padded, mlm, nsp
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 19: BERT and the fused stack, card vs CPU
# ---------------------------------------------------------------------------

# fp32 on both sides (TF32 off): the same arithmetic summed in another
# order (the card's flash kernel and fused norm, the CPU's plain versions)
# through two layers, by relative norm of each output
CARD_CPU_NORM = 1e-5


def phase_bert_card_vs_cpu(port):
    torch = port["torch"]
    cfg = port["bert_tiny"](hidden_size=128, num_heads=2)
    cpu = port["BertForPretraining"](cfg, device="cpu", seed=5).eval()
    card = port["BertForPretraining"](cfg, device=DEVICE, seed=5).eval()
    card.load_state_dict(cpu.state_dict())
    d = _bert_batch(torch, cfg, (128, 77), 140)
    d = {k: v[:, :128] if k in ("ids", "types", "mask") else v
         for k, v in d.items()}
    rels = {}
    _reset_launches(port)
    with torch.no_grad():
        for masked in (False, True):
            outs = []
            for m in (cpu, card):
                dev = {k: v.to(m.device) for k, v in d.items()}
                outs.append(m(dev["ids"], dev["types"],
                              attention_mask=dev["mask"] if masked else None,
                              masked_positions=dev["pos"]))
            for i, name in enumerate(("mlm", "nsp")):
                rels[f"bert {name} mask={masked}"] = _rel(
                    outs[1][i].cpu(), outs[0][i])
        pair_cpu, pair_card = (_fused_pairs(
            port, cfg, "float32", seed=60, layers=2, dropout=(0.0,) * 3,
            device=dev) for dev in ("cpu", DEVICE))
        pair_card.load_state_dict(pair_cpu.state_dict())
        x = torch.from_numpy(np.random.RandomState(141).randn(
            2, 128, 128).astype(np.float32))
        rels["fused pairs"] = _rel(_run_pairs(pair_card, x.to(DEVICE)).cpu(),
                                   _run_pairs(pair_cpu, x))
    launches = _launch_counts(port)
    print(f"[bert_card_vs_cpu] bert_tiny(hidden 128, 2 heads) and two fused "
          f"post-LN pairs, fp32, 2 x 128: relative norms "
          f"{ {k: float(f'{v:.4g}') for k, v in rels.items()} } (tol "
          f"{CARD_CPU_NORM}); card launches {launches}")
    _check(max(rels.values()) <= CARD_CPU_NORM,
           "card and CPU BERT / fused outputs differ")
    _check(launches["fwd"] > 0 and launches["ln"] > 0,
           "the card did not launch the flash and norm kernels")

# ---------------------------------------------------------------------------
# phase 20: the AdamW kernel's fp32-master form vs plain
# ---------------------------------------------------------------------------

# BERT-base's word embeddings, GPT-3 1.3B's fc1 slab, an odd tail (the
# scalar loop alone), each also with every operand off a 16-byte boundary
ADAMW_MASTER_SHAPES = ((30522, 768), (24, 2048, 8192), (3, 257))
# per element: read g 2, master 4, m1 4, m2 4; write master 4, m1 4,
# m2 4, p 2 (bf16 parameters)
ADAMW_MASTER_BYTES = 28


def _adamw_master_compare(port, shape, dtype, seed, misaligned=False):
    """Two consecutive master-form steps, the kernel and the plain version
    on copies of the same tensors (as ``_adamw_compare``: each step starts
    both from the kernel's state).  ``misaligned``: every operand is a
    view one element into its buffer, off a 16-byte boundary.  The master
    and the fp32 moments are held to ``ADAMW_TOL["float32"]``, p to the
    plain p by ``ADAMW_TOL[dtype]``, and p must be exactly the kernel's
    own new master rounded.  Returns the max abs error over master, m1,
    m2 and p."""
    torch, fw = port["torch"], port["fw"]
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    td = getattr(torch, dtype)
    n = int(np.prod(shape))
    off = 1 if misaligned else 0

    def tensor(scale, dt):
        buf = torch.empty(n + off, device=DEVICE, dtype=dt)
        t = buf[off:].view(shape)
        t.copy_(torch.randn(shape, generator=gen, device=DEVICE) * scale)
        return t

    master = tensor(1.0, torch.float32)
    kern = [master.to(td), master, tensor(0.01, torch.float32),
            tensor(0.001, torch.float32).abs_()]         # p, master, m1, m2
    if misaligned:
        kern[0] = tensor(0.0, td)
        kern[0].copy_(master)
    plain = [t.clone() for t in kern]
    b1p, b2p = np.float32(1.0), np.float32(1.0)
    err = 0.0
    for step in (1, 2):
        g = tensor(0.1, td)
        b1p, b2p = np.float32(b1p * np.float32(0.9)), np.float32(
            b2p * np.float32(0.999))
        fw.fused_adamw_update(kern[0], g, kern[2], kern[3], 1e-3, b1p, b2p,
                              master=kern[1])
        fw.fused_adamw_plain(plain[0], g, plain[2], plain[3],
                             fw.adamw_scalars(1e-3, b1p, b2p),
                             master=plain[1])
        torch.cuda.synchronize()
        _check(torch.equal(kern[0], kern[1].to(td)),
               f"adamw master {dtype} {shape}: p is not the new master "
               "rounded")
        for name, a, b, tol in zip(
                ("p", "master", "m1", "m2"), kern, plain,
                (ADAMW_TOL[dtype],) + (ADAMW_TOL["float32"],) * 3):
            e, over = _over(a, b, tol)
            _check(over <= 0, f"adamw master {name} {dtype} {shape} "
                   f"misaligned={misaligned} step {step}: kernel vs plain "
                   f"off by {e}")
            err = max(err, e)
            b.copy_(a)
    print(f"[adamw_master] {dtype} {list(shape)} misaligned={misaligned} "
          f"two steps: max_abs_err={err!r}")
    return err


def _time_adamw_master(port, params):
    """Device ms of one master-form update over ``params`` (bf16 tensors of
    a model, each with an fp32 master and fp32 moments; one launch a
    tensor): the kernel and the plain version; the bytes bound."""
    torch, fw = port["torch"], port["fw"]
    grads = [torch.randn_like(p) * 0.01 for p in params]
    masters = [p.float() for p in params]
    m1 = [torch.zeros_like(w) for w in masters]
    m2 = [torch.zeros_like(w) for w in masters]
    sc = fw.adamw_scalars(1e-4, 0.9, 0.999)

    def kernel(i):
        for p, g, w, a, b in zip(params, grads, masters, m1, m2):
            fw.fused_adamw_update(p, g, a, b, 1e-4, 0.9, 0.999, master=w)

    def plain(i):
        for p, g, w, a, b in zip(params, grads, masters, m1, m2):
            fw.fused_adamw_plain(p, g, a, b, sc, master=w)

    n = sum(p.numel() for p in params)
    t_bytes = ADAMW_MASTER_BYTES * n / HBM_BYTES_PER_S
    t_ops = 14.0 * n / PEAK_FLOPS["float32"]
    # few enough updates that the host queues every launch while the
    # sleep kernel holds the stream (BERT-base: 157 launches an update)
    iters = max(2, min(10, 320 // len(params)))
    return dict(ms=_time_ms(torch, kernel, iters)[0],
                plain_ms=_time_ms(torch, plain, 2, hold=False)[0],
                bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                tensors=len(params), elements=n)


def phase_adamw_master(port):
    torch = port["torch"]
    err = 0.0
    for i, shape in enumerate(ADAMW_MASTER_SHAPES):
        for misaligned in (False, True):
            err = max(err, _adamw_master_compare(port, shape, "bfloat16",
                                                 200 + i, misaligned))
            torch.cuda.empty_cache()
    err = max(err, _adamw_master_compare(port, (3, 257), "float16", 210))
    times = {}
    for name, build in (
            ("bert_base", lambda: port["BertForPretraining"](
                port["bert_base"](), device=DEVICE, dtype="bfloat16")),
            ("gpt_1p3b", lambda: port["GPT"](
                port["gpt_1p3b"](max_position_embeddings=1024),
                device=DEVICE, dtype="bfloat16", seed=3))):
        model = build()
        times[name] = t = _time_adamw_master(
            port, [p.detach() for p in model.parameters()])
        del model
        torch.cuda.empty_cache()
        print(f"[adamw_master] {name} ({t['tensors']} bf16 tensors, "
              f"{t['elements']} elements, fp32 masters and moments), device "
              f"ms per update: kernel {t['ms']!r}, plain {t['plain_ms']!r}, "
              f"bound {t['bound_ms']!r} ({t['bound_by']}, "
              f"{ADAMW_MASTER_BYTES} B/element; share of it "
              f"{t['bound_ms'] / t['ms']!r}); {t['tensors']} launches an "
              f"update; no single PyTorch call updates fp32 masters and a "
              f"bf16 copy")
    b, g = times["bert_base"], times["gpt_1p3b"]
    return dict(max_abs_err=err, ms=b["ms"], plain_ms=b["plain_ms"],
                bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                library_ms=None, gpt_1p3b_ms=g["ms"],
                gpt_1p3b_plain_ms=g["plain_ms"],
                gpt_1p3b_bound_ms=g["bound_ms"])


# ---------------------------------------------------------------------------
# phase 21: BERT-base pretraining, the whole recipe
# ---------------------------------------------------------------------------

# the recipe of the original BERT release's optimization.py and
# PaddleNLP's run_pretrain.py: linear warmup, then linear decay to 0;
# AdamW, weight decay 0.01 off biases and LayerNorm parameters; global-
# norm clipping at 1.0; bf16 weights on fp32 masters
RECIPE_LR, RECIPE_WD, RECIPE_CLIP = 1e-4, 0.01, 1.0
RECIPE_WARMUP, RECIPE_DECAY = 3, 20
BERT_TRAIN_STEPS = 10


def recipe_no_decay(name):
    """``apply_decay_param_fun``: decay every parameter but biases and
    LayerNorm parameters (by name)."""
    return not any(w in name for w in ("bias", "ln", "layer_norm"))


def recipe_lr(t):
    """The schedule's rate at step ``t``, computed here from its
    definition: ``LinearWarmup(PolynomialDecay(lr, RECIPE_DECAY, end_lr=0,
    power=1), RECIPE_WARMUP, 0, lr)``."""
    if t < RECIPE_WARMUP:
        return RECIPE_LR * t / RECIPE_WARMUP
    return RECIPE_LR * (1 - min(t - RECIPE_WARMUP, RECIPE_DECAY)
                        / RECIPE_DECAY)


def recipe_optimizer(port, model):
    """AdamW over ``model.named_parameters()`` with the recipe's schedule,
    clip and decay mask (fp32 masters over bf16 weights: AdamW's
    default); returns (optimizer, scheduler)."""
    lr = port["lr"]
    sched = lr.LinearWarmup(lr.PolynomialDecay(RECIPE_LR, RECIPE_DECAY,
                                               end_lr=0.0, power=1.0),
                            RECIPE_WARMUP, 0.0, RECIPE_LR)
    opt = port["AdamW"](model.named_parameters(), learning_rate=sched,
                        weight_decay=RECIPE_WD,
                        grad_clip=port["clip"].ClipGradByGlobalNorm(
                            RECIPE_CLIP),
                        apply_decay_param_fun=recipe_no_decay)
    return opt, sched


def bert_train_flops(cfg, batch, seq, masked):
    """Training FLOPs of one step, 3x the forward's products: per layer
    2 b s (4 h^2 + 2 h f) for the projections and 4 b s^2 h for the
    scores and P V; the MLM head 2 b m (h^2 + h V)."""
    h, f, L, V = (cfg.hidden_size, cfg.intermediate_size, cfg.num_layers,
                  cfg.vocab_size)
    fwd = (2 * batch * seq * L * (4 * h * h + 2 * h * f)
           + 4 * batch * L * seq * seq * h
           + 2 * batch * masked * (h * h + h * V))
    return 3 * fwd


def bert_train_setup(port, attention_dropout):
    """BERT-base (``attention_dropout`` as given, hidden dropout 0.1) cast
    to bf16 by ``amp.decorate`` O2, then the recipe's AdamW (fp32 masters)
    through ``FusedTrainStep``, and one fixed batch of 16 x 512 with 80
    masked positions a row on the card.  Returns ``(model, opt, sched,
    step, batch)``."""
    torch = port["torch"]
    cfg = port["bert_base"](attention_dropout=attention_dropout)
    model = port["BertForPretraining"](cfg, device=DEVICE, seed=0)
    port["amp"].decorate(model, level="O2", dtype="bfloat16")
    opt, sched = recipe_optimizer(port, model)
    crit = port["BertPretrainingCriterion"]()

    def loss_fn(ids, types, pos, labels, nsp, weights):
        mlm, ns = model(ids, types, masked_positions=pos)
        return crit(mlm, ns, labels, nsp, weights)

    step = port["FusedTrainStep"](loss_fn, opt)
    d = _bert_batch(torch, cfg, (ENC_SEQ,) * ENC_BATCH, 150)
    batch = tuple(d[k] for k in ("ids", "types", "pos", "labels", "nsp",
                                 "weights"))
    return model, opt, sched, step, batch


def _bert_train(port, attention_dropout):
    torch = port["torch"]
    model, opt, sched, step, batch = bert_train_setup(port,
                                                      attention_dropout)
    cfg = model.config
    n_tensors = len(list(model.parameters()))
    masters = sum(k.startswith("master_") for k in opt.state_dict())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, lrs = [], []
    _reset_launches(port)
    t0 = time.perf_counter()
    for t in range(BERT_TRAIN_STEPS):
        lrs.append(opt.get_lr())
        losses.append(step(*batch))
        sched.step()
        if t == 0:                        # the first step builds, warms up
            torch.cuda.synchronize()
            t1 = time.perf_counter()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = _launch_counts(port)
    losses = [float(x) for x in losses]
    step_s = wall / (BERT_TRAIN_STEPS - 1)
    tokens = ENC_BATCH * ENC_SEQ
    mfu = (bert_train_flops(cfg, ENC_BATCH, ENC_SEQ, BERT_MASKED) / step_s
           / PEAK_FLOPS["bfloat16"])
    peak = torch.cuda.max_memory_allocated()
    per_step = {k: v / BERT_TRAIN_STEPS for k, v in launches.items()}
    print(f"[bert_train] bert_base bf16 on fp32 masters ({masters} of "
          f"{n_tensors} tensors), hidden_dropout {cfg.hidden_dropout}, "
          f"attention_dropout {attention_dropout}, {ENC_BATCH} x {ENC_SEQ}, "
          f"{BERT_MASKED} masked positions a row, one fixed batch: losses "
          f"{losses}; lr {lrs}; mean step {1e3 * step_s:.2f} ms (host "
          f"clock, steps 2-{BERT_TRAIN_STEPS}), {tokens / step_s:.1f} "
          f"tokens/s, MFU {mfu:.4f} (3 x forward products: per layer "
          f"2bs(4h^2 + 2hf) + 4bs^2h, MLM head 2bm(h^2 + hV); over 989 "
          f"TFLOP/s); launches per step {per_step}; peak device memory "
          f"{peak / 2**30:.2f} GiB")
    _check(masters == n_tensors, f"bert_train: {masters} masters for "
           f"{n_tensors} bf16 tensors")
    _check(all(np.isfinite(losses)), f"bert_train: non-finite losses "
           f"{losses}")
    _check(losses[-1] < losses[0], f"bert_train: the loss did not fall "
           f"over {BERT_TRAIN_STEPS} steps on one batch: {losses}")
    _check(all(abs(a - recipe_lr(t)) <= 1e-12 * RECIPE_LR
               for t, a in enumerate(lrs)),
           f"bert_train: lr {lrs} is not the schedule's "
           f"{[recipe_lr(t) for t in range(BERT_TRAIN_STEPS)]}")
    flash = cfg.num_layers if attention_dropout == 0.0 else 0
    want = {"adamw": n_tensors, "fwd": flash, "dkv": flash, "dq": flash}
    _check(all(launches[k] == v * BERT_TRAIN_STEPS for k, v in want.items()),
           f"bert_train: launches {launches} over {BERT_TRAIN_STEPS} steps, "
           f"expected per step {want}")
    del model, opt, step, batch
    torch.cuda.empty_cache()
    return launches["adamw"], dict(ms_per_step=1e3 * step_s,
                                   tokens_per_s=tokens / step_s, mfu=mfu)


def phase_bert_train(port):
    """BERT-base trained by its recipe, attention dropout 0.1 (the plain
    route) and 0 (the flash kernels); returns the master-form AdamW
    launches of the run."""
    launches = 0
    for p in (0.1, 0.0):
        n, _ = _bert_train(port, p)
        launches += n
    return launches


# ---------------------------------------------------------------------------
# phase 22: GPT-3 1.3B training with dropout
# ---------------------------------------------------------------------------

TRAIN_DROPOUT_STEPS = 3


def train_dropout_setup(port, attention_dropout=0.1):
    """Phase 6's workload (GPT-3 1.3B, bf16, recompute every block, bf16
    moments, O1) with the config's dropout: hidden 0.1 and
    ``attention_dropout``.  Returns ``(model, step, batches)``."""
    torch = port["torch"]
    cfg = port["gpt_1p3b"](max_position_embeddings=1024,
                           recompute_interval=1,
                           attention_dropout=attention_dropout)
    model = port["GPT"](cfg, device=DEVICE, dtype="bfloat16", seed=0)
    opt = port["AdamW"](model.parameters(), learning_rate=1e-4,
                        weight_decay=0.01, multi_precision=False)
    step = port["FusedTrainStep"](
        lambda ids, labels: model(ids, labels=labels), opt, amp_level="O1")
    rng = np.random.RandomState(1)
    batches = [tuple(torch.from_numpy(rng.randint(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ))).to(DEVICE)
        for _ in range(2)) for _ in range(2)]
    return model, step, batches


def phase_train_dropout(port):
    """GPT-3 1.3B at bench.py rung 0's shape with the config's default
    dropout 0.1 (attention on the plain causal route), then with
    attention dropout 0 (the flash kernels, hidden dropout 0.1)."""
    torch = port["torch"]
    for name, p in (("dropout 0.1", 0.1),
                    ("hidden dropout 0.1, attention dropout 0", 0.0)):
        model, step, batches = train_dropout_setup(port, p)
        cfg = model.config
        warm, _ = train_steps(port, step, batches, 1)
        torch.cuda.reset_peak_memory_stats()
        _reset_launches(port)
        losses, wall = train_steps(port, step, batches, TRAIN_DROPOUT_STEPS,
                                   first=1)
        launches = _launch_counts(port)
        peak = torch.cuda.max_memory_allocated()
        L, n = cfg.num_layers, TRAIN_DROPOUT_STEPS
        flash = cfg.attention_dropout == 0.0
        want = {"fwd": 2 * L if flash else 0, "dkv": L if flash else 0,
                "dq": L if flash else 0,
                "adamw": len(list(model.parameters()))}
        step_s = wall / n
        print(f"[train_dropout] gpt_1p3b bf16, {name}, recompute every "
              f"block, {TRAIN_BATCH} x {TRAIN_SEQ}: losses {warm + losses}; "
              f"mean step {1e3 * step_s:.2f} ms (host clock, {n} steps after "
              f"one warm-up), {TRAIN_BATCH * TRAIN_SEQ / step_s:.1f} "
              f"tokens/s, MFU {gpt_train_mfu(cfg, step_s):.4f} (phase 6's "
              f"formula); launches per step "
              f"{ {k: v // n for k, v in launches.items()} }; peak device "
              f"memory {peak / 2**30:.2f} GiB")
        _check(all(np.isfinite(warm + losses)),
               f"train_dropout {name}: non-finite losses")
        _check(all(launches[k] == v * n for k, v in want.items()),
               f"train_dropout {name}: launches {launches} over {n} steps, "
               f"expected per step {want}")
        del model, step, batches
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 23: determinism and recompute under dropout, on the card
# ---------------------------------------------------------------------------

DET_BATCH, DET_LAYERS = 2, 2


def _det_model(port, **kw):
    cfg = port["gpt_1p3b"](num_layers=DET_LAYERS, max_position_embeddings=1024,
                           **kw)
    return port["GPT"](cfg, device=DEVICE, dtype="bfloat16", seed=7)


def phase_determinism(port):
    """GPT-3 1.3B's width at 2 layers, bf16, dropout 0.1: two runs of two
    steps from the same seeds give the same bits; recompute on and off
    give the same gradients, with attention dropout (plain route) and
    without it (flash kernels)."""
    torch = port["torch"]
    rng = np.random.RandomState(3)
    vocab = port["gpt_1p3b"]().vocab_size
    ids, labels = (torch.from_numpy(rng.randint(
        0, vocab, (DET_BATCH, TRAIN_SEQ))).to(DEVICE) for _ in range(2))
    runs = []
    for _ in range(2):
        m = _det_model(port, recompute_interval=1)
        opt = port["AdamW"](m.parameters(), learning_rate=1e-4,
                            multi_precision=False)
        step = port["FusedTrainStep"](lambda i, l: m(i, labels=l), opt,
                                      amp_level="O1")
        losses = [step(ids, labels) for _ in range(2)]
        runs.append((torch.stack(losses), [p.detach().clone()
                                           for p in m.parameters()]))
        del m, opt, step
    same_steps = (torch.equal(runs[0][0], runs[1][0])
                  and all(torch.equal(a, b)
                          for a, b in zip(runs[0][1], runs[1][1])))
    diffs = {}
    for name, kw in (("dropout 0.1", {}),
                     ("attention dropout 0", dict(attention_dropout=0.0))):
        grads = []
        for k in (0, 1):
            m = _det_model(port, recompute_interval=k, **kw)
            m(ids, labels=labels).backward()
            grads.append([p.grad for p in m.parameters()])
            del m
        diffs[name] = max((a.float() - b.float()).abs().max().item()
                          for a, b in zip(*grads))
    del runs
    torch.cuda.empty_cache()
    print(f"[determinism] gpt_1p3b width, {DET_LAYERS} layers, bf16, "
          f"{DET_BATCH} x {TRAIN_SEQ}: two runs of two steps from one seed "
          f"bit for bit: {same_steps}; recompute on vs off, max abs gradient "
          f"difference {diffs}")
    _check(same_steps, "two runs from the same seeds differ")
    _check(all(v == 0.0 for v in diffs.values()),
           f"recompute on and off give different gradients: {diffs}")


# ---------------------------------------------------------------------------
# phase 24: the recipe, card vs CPU
# ---------------------------------------------------------------------------

RECIPE_CPU_STEPS = 3


def _recipe_runs(port, build, loss_fn, batch):
    """``RECIPE_CPU_STEPS`` recipe steps of the model ``build(device)``
    makes, on the CPU and on the card from the CPU's weights; returns
    (losses, parameters) of each."""
    torch = port["torch"]
    cpu = build("cpu")
    card = build(DEVICE)
    card.load_state_dict(cpu.state_dict())
    out = []
    for m in (cpu, card):
        opt, sched = recipe_optimizer(port, m)
        step = port["FusedTrainStep"](lambda *b, m=m: loss_fn(m, *b), opt)
        dev = [t.to(m.device) for t in batch]
        losses = []
        for _ in range(RECIPE_CPU_STEPS):
            losses.append(float(step(*dev)))
            sched.step()
        out.append((losses, {n: p.detach().cpu()
                             for n, p in m.named_parameters()}))
    return out


def phase_recipe_card_vs_cpu(port):
    """gpt_tiny and bert_tiny (hidden 128, 2 heads), fp32, TF32 off,
    dropout 0: three steps of the whole recipe on the card and on the CPU
    from the same weights."""
    torch = port["torch"]
    rng = np.random.RandomState(4)
    ids = torch.from_numpy(rng.randint(0, 1024, (2, 128)))
    gcfg = port["gpt_tiny"](hidden_size=128, num_heads=2, hidden_dropout=0.0,
                            attention_dropout=0.0, recompute_interval=1)
    bcfg = port["bert_tiny"](hidden_size=128, num_heads=2, hidden_dropout=0.0,
                             attention_dropout=0.0)
    d = _bert_batch(torch, bcfg, (128, 128), 160)
    bert_batch = [d["ids"][:, :128].cpu()] + [
        d[k].cpu() for k in ("types", "pos", "labels", "nsp", "weights")]
    bert_batch[1] = bert_batch[1][:, :128]
    crit = port["BertPretrainingCriterion"]()

    def bert_loss(m, ids, types, pos, labels, nsp, weights):
        mlm, ns = m(ids, types, masked_positions=pos)
        return crit(mlm, ns, labels, nsp, weights)

    cases = (
        ("gpt_tiny", lambda dev: port["GPT"](gcfg, device=dev, seed=8),
         lambda m, i: m(i, labels=i), [ids]),
        ("bert_tiny", lambda dev: port["BertForPretraining"](
            bcfg, device=dev, seed=9), bert_loss, bert_batch))
    _reset_launches(port)
    worst = {}
    for name, build, loss_fn, batch in cases:
        (lc, pc), (lg, pg) = _recipe_runs(port, build, loss_fn, batch)
        loss_diff = max(abs(a - b) for a, b in zip(lc, lg))
        allowance = 2 * RECIPE_LR * RECIPE_CPU_STEPS
        over = max(((pg[n] - pc[n]).abs() - allowance
                    - 1e-5 * pc[n].abs()).max().item() for n in pc)
        bulk = max(torch.quantile((pg[n] - pc[n]).abs().flatten()[:2**24],
                                  0.999).item() for n in pc)
        worst[name] = (loss_diff, over, bulk)
        print(f"[recipe_card_vs_cpu] {name} fp32, {RECIPE_CPU_STEPS} recipe "
              f"steps: losses cpu {lc} card {lg}, max diff {loss_diff!r} "
              f"(tol {TRAIN_LOSS_ATOL}); parameters: max excess over "
              f"2 lr steps + 1e-5 relative {over!r} (must be <= 0), 99.9th "
              f"percentile difference {bulk!r} (tol 1e-6)")
    launches = _launch_counts(port)
    print(f"[recipe_card_vs_cpu] card launches {launches}")
    for name, (loss_diff, over, bulk) in worst.items():
        _check(loss_diff <= TRAIN_LOSS_ATOL and over <= 0 and bulk <= 1e-6,
               f"{name}: the card's recipe steps differ from the CPU's")
    _check(all(launches[k] > 0 for k in ("fwd", "dkv", "dq", "adamw")),
           "the card's recipe steps did not launch the flash and AdamW "
           "kernels")



def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    port = import_port()
    # fp32 stays fp32 wherever a kernel is compared with its plain version
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[card] {card}")
    phase_build(port)
    k = phase_kernels(port)
    launches = phase_serve(port)
    phase_card_vs_cpu(port)
    tk = phase_train_kernels(port)
    train_launches = phase_train(port)
    phase_train_card_vs_cpu(port)
    dk = phase_decode_kernels(port)
    # the flash forward's error over phase 5 and its ragged lengths here
    tk["fwd"]["max_abs_err"] = max(tk["fwd"]["max_abs_err"],
                                   dk["flash_ragged_err"])
    model, ids, out, logits, decode_launches = phase_generate(port)
    paged_launches = phase_paged(port, model, ids, out, logits)
    phase_generate_card_vs_cpu(port)
    ik = phase_int8_kernels(port)
    ragged_int8_launches = phase_serve_int8(port)
    # phase 9's model, kept for phase 14, which quantizes it
    paged_int8_launches = phase_paged_int8(port, model, ids, out, logits)
    del model, ids, out, logits
    torch.cuda.empty_cache()
    phase_int8_card_vs_cpu(port)
    nk = phase_norm_kernels(port)
    # the flash forward's error over phases 5 and 8 and BERT's shape here
    tk["fwd"]["max_abs_err"] = max(tk["fwd"]["max_abs_err"], nk["flash_err"])
    tk["fwd"].update(nk["bert_flash"])
    ln_launches = phase_encoder(port)
    phase_bert(port)
    phase_bert_card_vs_cpu(port)
    mk = phase_adamw_master(port)
    master_launches = phase_bert_train(port)
    phase_train_dropout(port)
    phase_determinism(port)
    phase_recipe_card_vs_cpu(port)
    print(f"[time] whole run {time.perf_counter() - t_start:.1f} s")
    print(card)
    csrc = "paddle_tpu_torch/ops/kernels/csrc/"
    pallas = "paddle_tpu/ops/pallas_kernels/"
    kernels = [{
        "name": "ragged_paged_attention", "route": "cuda",
        "source": csrc + "ragged_paged_attention.cu",
        "replaces": pallas + "ragged_paged_attention.py:237",
        "launches": launches, "max_abs_err": k["max_abs_err"],
        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": None,
        # the same kernel at the mixed served shape
        "mixed_ms": k["mixed_ms"], "mixed_plain_ms": k["mixed_plain_ms"],
        "mixed_bound_ms": k["mixed_bound_ms"],
        "mixed_bound_by": k["mixed_bound_by"]}]
    for key, name, source, replaces in (
            ("fwd", "flash_attention_fwd", "flash_attention.cu",
             "flash_attention.py:97"),
            ("dkv", "flash_attention_bwd_dkv", "flash_attention.cu",
             "flash_attention.py:195"),
            ("dq", "flash_attention_bwd_dq", "flash_attention.cu",
             "flash_attention.py:243"),
            ("adamw", "fused_adamw", "fused_adamw.cu", "fused_adamw.py:38")):
        kernels.append({"name": name, "route": "cuda",
                        "source": csrc + source,
                        "replaces": pallas + replaces,
                        "launches": train_launches[key], **tk[key]})
    # the fp32-master form: the same kernel library and TPU kernel, with
    # the arithmetic of the reference's composed master path; launches
    # from phase 21's BERT-base recipe steps, times at BERT-base's
    # tensors (GPT-3 1.3B's beside them)
    kernels.append({"name": "fused_adamw_master", "route": "cuda",
                    "source": csrc + "fused_adamw.cu",
                    "replaces": pallas + "fused_adamw.py:38",
                    "computes": "paddle_tpu/optimizer/optimizers.py:266",
                    "launches": master_launches, **mk})
    for key, name, replaces, launched in (
            ("decode", "decode_attention", "decode_attention.py:86",
             decode_launches),
            ("paged", "paged_attention", "paged_attention.py:83",
             paged_launches)):
        kernels.append({"name": name, "route": "cuda",
                        "source": csrc + "decode_attention.cu",
                        "replaces": pallas + replaces, "launches": launched,
                        **dk[key]})
    # the int8 variants: each TPU kernel's quantized branch; the decode
    # variant has no model path, its launches are phase 12's checks
    for key, name, source, replaces, launched in (
            ("ragged", "ragged_paged_attention_int8",
             "ragged_paged_attention.cu", "ragged_paged_attention.py:269",
             ragged_int8_launches),
            ("paged", "paged_attention_int8", "decode_attention.cu",
             "paged_attention.py:109", paged_int8_launches),
            ("decode", "decode_attention_int8", "decode_attention.cu",
             "decode_attention.py:106", ik["decode_launches"])):
        kernels.append({"name": name, "route": "cuda",
                        "source": csrc + source,
                        "replaces": pallas + replaces, "launches": launched,
                        **ik[key]})
    # the RMS variant has no model path: its launches are phase 16's
    for key, name, launched in (
            ("ln", "fused_add_layer_norm", ln_launches),
            ("rms", "fused_add_rms_norm", nk["rms_launches"])):
        kernels.append({"name": name, "route": "cuda",
                        "source": csrc + "rms_norm.cu",
                        "replaces": pallas + "rms_norm.py:69",
                        "launches": launched, **nk[key]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
