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
   of them within 1e-6; the card launched the flash and AdamW kernels;
25. ragged kernel at the new plans -- bf16, fp32 and int8 against
   ``ragged_paged_attention_plain`` and ``split_merge_plain``, rerun bit
   for bit and over a stale pool: verify runs of k + 1 = 5 rows (one
   token block each) beside prefill chunks; a tail prefill from position
   384 over three pages another slot wrote, beside a decode of that slot;
   the draft's catch-up runs over the second layer of a 2-layer pool;
   phase 3's mixed step at H/2 = 8 heads over one shard's own pool (int8
   scales ``[P, H/2]``), the shape phases 41-43 launch at mp=2;
26. prefix cache -- phase 3's engine with max_context 1024: a 384-token
   system prompt registered by one warm request, then 16 requests of it
   and a 16-200-token tail, 32 new tokens each, against the same traffic
   with the cache off: hit rate, cached tokens, TTFT p50 and tokens/s;
   24 ragged launches every fused step; the tokens under the parity rule
   (``GAP_BOUND``); with an int8 pool, the adopted pages keep their
   scales bit for bit; ``flush`` drains every page; then fp32 at 2 layers
   (TF32 off), cache on against off;
27. watchdog -- ``stall_budget_s`` 1 s, ``compile_budget_s`` 300 s, 32
   requests; one stall of 3 s, one persistent non-intact exception, one
   NaN on slot 0, one pool exhaustion: 2 recoveries, 2 rebuilds, 1 retry,
   1 quarantine, the implicated requests FAILED with their typed errors,
   the rest under the parity rule against an unfaulted run, the ledger
   exact every step, the device memory back once the zombie returns;
   bf16, then int8 (the rebuilt pool's scales finite); then five stall
   recoveries in a row on one bf16 engine, ``memory_allocated()`` read
   after each zombie returns: it must not grow by more than one pool from
   the second reading to the fifth;
28. speculative -- phase 3's traffic, greedy, k = 4, with
   ``truncated_draft(target, 2)`` and with the target as its own draft,
   against the plain engine in the same run: acceptance, verify and draft
   steps, tokens/s, target launches = verify steps x 24 and draft
   launches = draft steps x its layers; one sampled run checked by
   property; the int8-pool variant; fp32 at 2 layers: tokens equal;
29. LoRA -- 4 adapters of rank 16 on qkv, out_proj, fc1 and fc2 (bf16
   slabs), 16 requests over them and the null adapter: every adapter's
   tokens against an engine serving ``merged_state_dict`` weights without
   LoRA (the null adapter's against the base model), under the parity
   rule; evicting a seated adapter raises ``AdapterInUse``; then the same
   over ``weight_dtype="int8"``;
30. AdamW with the step's flag -- the fused AdamW kernel's three forms
   (fp32, bf16, the fp32-master form) with a device finiteness flag and
   device beta powers against ``fused_adamw_plain`` given the same flag
   and pair: a false flag writes nothing (bit for bit), a true one equals
   the host-scalar launch bit for bit and the plain version within
   ``ADAMW_TOL``; then the fp32 form's ms per update over every tensor of
   GPT-3 1.3B in fp32 (16 launches, 1.31 B elements) with and without the
   flag, beside the plain version, ``torch.optim.AdamW(fused=True)`` with
   ``found_inf`` and the bound (28 B/element over 3.35 TB/s);
31. O1 training -- GPT-3 1.3B at full width and depth with fp32 weights,
   ``auto_cast`` O1 bf16, an enabled dynamic ``GradScaler``, ``AdamW``
   and ``FusedTrainStep(scaler=)``, phase 6's shape (8 x 1024,
   recompute every block), batches through ``DevicePrefetcher``: finite
   losses; per step 48 flash forward, 24 dK/dV, 24 dQ and 16 AdamW
   launches; step time, tokens/s, MFU and peak memory beside phase 6's;
   then a forced overflow (a scale of 3e38 for one step, or, where that
   does not overflow, a hook making the word embedding's gradient
   non-finite) under ``torch.cuda.set_sync_debug_mode("error")`` (a host
   sync inside the step raises): not applied, parameters and moments
   unchanged (``torch.equal`` on a sample, a checksum of all), the beta
   powers unchanged, the scale halved; the next two steps apply;
32. O1 card vs CPU -- gpt_tiny(hidden 128, 2 heads) with fp32 weights
   under O1 bf16 with a scaler, three steps on the card and on the CPU
   from the same weights: losses within ``O1_CARD_CPU_ATOL``;
33. recompute policies -- phase 31's set-up under ``recompute_policy``
   "full" and "dots", four steps each from the same weights: losses bit
   for bit, the same flash forward launches; step time, peak memory and
   the memory a forward holds for its backward, of each;
34. crash-consistent resume -- GPT-3 1.3B's width at 2 layers, fp32
   weights, O1 + scaler: train 6 against train 3, an asynchronous save
   (~2.5 GB), 3 steps while the writer runs, a restore into a model from
   another seed and 3 steps: losses and parameters bit for bit; then a
   SIGTERM to this process under ``PreemptionHandler`` saves at the next
   step boundary and raises ``GracefulExit``, and that checkpoint is the
   newest;
35. layered generate -- the layered GPT (``GPTForPretraining``: per-layer
   modules, ``Linear`` weights, a per-layer cache) at GPT-3 1.3B's width
   and depth, random bf16 weights: phase 9's workload (``generate_setup``,
   batch 8, prompt 200, 64 new tokens, no host sync): exactly 24 flash
   forward and 24 x 63 decode launches; printed beside phase 9's stacked
   numbers; its greedy tokens under the parity rule against a stacked GPT
   carrying the same weights (``stacked_twin``: the layers' tensors
   stacked on the layer axis); then fp32 at 2 layers of full width
   (TF32 off): the twin's tokens exactly;
36. layered serve -- phase 3's engine and traffic over phase 35's model
   and over its stacked twin in turns (layered, stacked, stacked,
   layered; a fresh engine each): 24 ragged launches every fused step,
   tokens/s, TTFT and ITL p50/p99 of each run, tokens under the parity
   rule; then phase 10's
   paged step without a plan over the
   layered model against phase 35's logits (24 paged launches a step);
37. Predictor -- ``inference.Config`` over phase 35's model: the decode
   mode equals ``model.generate()`` token for token (24 flash and 24 x
   15 decode launches); a ``PredictorPool`` of 2 driven from 2 threads
   gives the serial rows; the serving mode equals
   ``ServingEngine.generate_batch`` on the same 8 rows of 120;
38. layered int8 -- phase 35's model quantized by
   ``quantize_for_serving`` (``Int8Linear``): phase 14's int8 paged step
   (24 int8 paged launches a step, logits within ``INT8_GEN_NORM`` of
   phase 35's), phase 36's serve from an int8 pool (24 int8 ragged
   launches a step, every per-layer scale finite), and the layered int8
   engine and paged path card vs CPU on gpt_tiny(hidden 128, 2 heads);
39. layered paths -- 2 layers of GPT-3 1.3B's width in fp32, the card
   against the CPU (``LAYERED_CPU_REQUESTS`` requests of
   ``LAYERED_CPU_PROMPT`` prompt tokens and ``LAYERED_CPU_NEW`` new ones;
   request states equal, tokens under the
   fp32 parity rule): LoRA over a pool in the layered layout (the
   default), speculation with ``truncated_draft(model, 1)``, the prefix
   cache over a 128-token shared head (equal hit counts), the watchdog
   (a persistent non-intact exception: one recovery and one rebuild of
   the per-layer pool; a NaN on slot 0; equal fault counts);
40. layered train -- 2 layers of GPT-3 1.3B's width, bf16, dropout 0,
   one forward and backward at 8 x 1024 through
   ``GPTPretrainingCriterion``: exactly 2 flash forward, 2 dK/dV and 2
   dQ launches, finite loss and gradients; then at batch
   ``LAYERED_TRAIN_CPU_BATCH`` the card's loss and gradients against the
   CPU's in fp32 from the same weights (``TRAIN_LOSS_REL``,
   ``TRAIN_GRAD_NORM``);
41. sharded serve -- ``ShardedServingEngine`` over GPT-3 1.3B bf16 at
   full width and ``SHARD_LAYERS`` = 4 of its 24 layers (seed 0; the
   stacked and the layered GPT) at
   (dp, mp) in ``SHARD_MESHES``, every replica and shard on ``cuda:0``
   (``devices=["cuda:0"] * dp * mp``), phase 3's engine and traffic.  Each
   request must sit on the replica least-loaded placement gives it, each
   tick launch the ragged kernel exactly 4 x mp times per replica that
   ran a fused step, each shard's pool hold ``nbytes / mp``
   (``cache_bytes_per_chip`` too), every ledger come back to zero, and
   the tokens follow the parity rule against phase 3's engine on the same
   weights.  Co-resident replicas step in order; the stacked (2, 1) also
   runs with the replicas on the cluster's thread pool (its rule
   patched), as replicas on disjoint cards step.  At mp=2 replica 0's
   weights on the card must not exceed the unsharded model's (the whole
   projections are dropped once the shards hold them).  Prints tokens/s,
   the mean tick, the launches, replica 0's weight bytes a shard's card
   would hold on distinct cards and, for the stacked GPT at (2, 2), the
   device time per fused step under ``torch.profiler``;
42. sharded int8 -- an int8 pool and int8 weights at (dp, mp) = (1, 2),
   whose tokens must be phase 13's engine's, every one (the int8 products
   reduce exact int32 accumulators), then at (2, 2) under the parity rule
   (two replicas chunk the prompts otherwise, and a page's int8 scale
   follows its writes): the scales sharded ``[L, P, H/mp]`` and finite,
   4 x 2 int8 ragged launches per replica step;
43. disaggregated -- ``DisaggServingEngine`` roles (prefill, decode) with
   bf16 pools, then int8 pools: tokens against the colocated (dp 2)
   cluster under the parity rule, ``transferred_in`` = ``transferred_out``
   = the hand-offs, both ledgers exact after every tick; pages copied and
   host ms per hand-off; then one 4-page hand-off (a 380-token prompt)
   timed alone with CUDA events between the stacked pools (4 copies) and
   the layered ones (16) beside the bytes bound;
44. cluster fp32 -- 1 layer of GPT-3 1.3B's width in fp32, the same
   script on the card and on the CPU: the elastic controller (fake clock,
   queue-driven) through scale-up, the four brownout rungs, their LIFO
   release and scale-down; a drain of replica 1 at mid-run and
   ``kill_replica(0)``; a disaggregated pair under a ``transfer_error``
   and a ``transfer_partial``; the stacked GPT sharded at (dp, mp) =
   (2, 2) and the layered one at (1, 2).  The card must give the CPU's
   action sequence, replica states, request states and replicas, page
   counts, ticks and transfer counts exactly, and its tokens under the
   fp32 parity rule;
45. mesh kernels -- the flash kernels at a pipeline microbatch's shard
   (``MESH_SHARD_FLASH``: B 2, H 8, S 1024, D 128, bf16, causal; q, k and
   v the strided views of one fused QKV output, as a shard's block hands
   them), held against their plain versions as in phase 5, and the AdamW
   kernel on one shard of the QKV slab at (pp, mp) = (2, 2)
   (``MESH_SHARD_ADAMW``), two steps against its plain version;
46. mesh train -- GPT-3 1.3B at full width and depth, phase 6's
   configuration (bf16, dropout 0, recompute every block, O1, AdamW with
   bf16 moments, batch 8 x 1024, flash), placed on a training mesh with
   every position on ``cuda:0``, at each of ``MESH_TRAIN_RUNS``: (dp, pp,
   mp) = (1, 2, 2) with ``n_micro`` 4 for 3 steps, the same with
   ``virtual_pp_degree`` 2 for 2, and (2, 2, 2) with ``n_micro`` 2 and
   ``use_tensor_parallel`` (the word embeddings and the loss over the
   vocabulary shards) for 2.
   Against phase 6's unplaced model, optimizer and batches, both on the
   card: step 1's gathered gradients within ``TRAIN_GRAD_NORM`` by
   relative norm, tensor by tensor, and every step's loss within
   ``MESH_LOSS_REL``; every step must launch the
   flash forward exactly dp x n_micro x mp x 48 times and each backward
   kernel dp x n_micro x mp x 24 times, and the AdamW kernel once a part;
   replica 0's positions must hold the unplaced model's weight bytes.
   Prints each run's step ms (host clock), device ms and busy share of
   its last step under ``torch.profiler``, peak memory and the weight
   bytes of each mesh position (``shards.weight_bytes_by_position``);
47. mesh card vs CPU -- a 2-layer fp32 GPT (hidden 256, 4 heads) at (2,
   2, 2), ``n_micro`` 2, ``use_tensor_parallel``, on the card and on the
   CPU from the same weights: step 1's gathered gradients
   (``MESH_GRAD_REL``), then 3 AdamW steps under a global-norm clip
   (losses within ``TRAIN_LOSS_ATOL``; weights: the elements whose step-1
   gradient is zero to rounding, ``MESH_ZERO_REL``, within two lr steps,
   every other within 2 ``MESH_ZERO_REL`` lr steps + 1e-5 relative and
   each tensor's 99.9th percentile within 1e-6); then on the card one
   O1 step with a ``GradScaler`` and an inf in one shard's gradient:
   every part, moment and beta power unchanged, one AdamW launch a part,
   the scale halved;
48-50. fleet -- ``BASELINE.json`` config 3 through the reference's fleet
   recipe: at TP=2 PP=2 (48); at dp 2 with recompute, virtual stages
   and the meta-optimizers (49); through ``group_sharded_parallel`` at pp
   2 x sharding 2 x mp 2, ZeRO ``os`` then ``p_g_os`` from the same
   weights (50: step 1 against the unplaced layered model, exact flash
   launches and one AdamW launch a slice, each level's parameter,
   gradient and state bytes against their arithmetic, the levels
   bit-equal, ``p_g_os``'s peak below ``os``'s); each with a 2-layer fp32
   copy on the card against the CPU (phase 50's at every level, the dp
   fallback, a skipped ``GradScaler`` step and the stacked GPT);
51. sequence parallelism -- the flash kernels at the ring's blocks
   (``SP_FLASH``: a part's 1024 rows at 16 and at 8 heads, bf16, causal
   and full) and ``RingAttention`` at sp 2 and 4 (``SP_RING_CASES``)
   against their plain versions, each block pair one launch of each
   kernel; GPT-3 1.3B bf16 (O1, dropout 0, 2048 positions) with
   ``sequence_parallel`` at batch 4 x 2048 on ``{"sp": 2}`` and ``{"sp":
   2, "mp": 2}``, every position on one card, 2 steps each: step 1's loss
   (``MESH_LOSS_REL``) and gradients (``TRAIN_GRAD_NORM``) against the
   unplaced layered model on the same weights and batch, exactly mp x 24
   x sp (sp + 1) / 2 launches of each flash kernel and one AdamW launch
   a tensor a step; a 2-layer fp32 copy (head_dim 64) at sp 2, sp 4 and
   sp 2 x mp 2 on the card against the CPU, and the axes no model reads
   (sp without ``sequence_parallel``, sep; the stacked GPT and the fleet
   recipe at sep 2) bit for bit their runs without the axis;
54. recompute across devices -- an MLP at GPT-3 1.3B width whose down
   projection is cut by rows over ``cuda:0`` and the CPU (the CPU half's
   output brought back and summed), under each of the port's
   checkpointing entries (``core.recompute.checkpoint``,
   ``pp_spmd.checkpointed`` full and "dots", ``fleet.recompute``):
   autograd runs the two halves' backward on two threads, and every
   backward must recompute once, with gradients bit-equal to the run
   without recompute;
55. auto_parallel -- the layered ``GPTModel`` at GPT-3 1.3B widths (2
   layers, bf16) over ``ProcessMesh([[0, 1], [2, 3]], ["dp", "mp"])`` on
   the one card, its weights placed by ``shard_tensor`` at Megatron
   placements, the forward captured on fake tensors and propagated (the
   Megatron specs on every product and attention node), run per position
   by ``apply_propagation``: exactly 8 flash forward launches at (4, 8,
   1024, 128), the output within ``AUTO_NORM`` of the unplaced forward, a
   2-layer fp32 copy within ``AUTO_CPU_NORM`` on the CPU and the card,
   the placed weights through ``save_distributed_checkpoint`` and
   ``load_distributed_checkpoint`` under (dp 1, mp 4) bit for bit,
   ``graph_cost``'s FLOPs the count by hand;
56. auto_parallel's Engine -- ``Engine.cost`` of GPT-3 13B (40 layers)
   over eight H100s (pure dp infeasible); the layered GPT at GPT-3 13B
   widths (hidden 5120, 40 heads of 128, vocab 50304), 2 layers, bf16,
   dropout 0, planned by ``Engine.plan`` over four positions of the one
   card (an HBM that makes pure dp infeasible: dp 2 x mp 2) and trained
   3 steps of 8 x 1024 tokens by ``Engine.fit`` through the propagation
   executor over the placed blocks (each position its own, no whole copy
   of a cut tensor), against an Engine with no plan
   (``ENGINE_LOSS_REL``, ``ENGINE_GRAD_NORM``): exactly positions x
   layers launches of each flash kernel a step at (4, 20, 1024, 128) and
   one bf16 AdamW launch a block (4 x 28), the bytes each position holds
   at rest (``state_bytes_by_position``) the count by hand; the node's
   backward against the plain version (``ENGINE_BWD_ATOL``); ``evaluate``
   and ``predict`` through the executor against the unplanned Engine's;
   the checkpoint into a fresh planned Engine bit for bit; the fp32 copy
   planned on the CPU and on the card against each other and the
   unplanned CPU run (``ENGINE_CPU_TOL``);
57e. a serving mesh over a model under ZeRO (after phase 57) -- the
   stacked GPT at GPT-3 1.3B widths (2 layers, fp32) on ``{"sharding":
   2, "mp": 2}`` under ``p_g_os`` after one training step, taken off its
   training mesh by ``ServingEngine(mesh=)`` and serving phase 29's
   traffic (16 requests x 32 tokens) beside an unplaced twin loaded with
   its ``state_dict()``: tokens under the fp32 parity rule, exactly L
   ragged launches a fused step, no part, copy or slice left with
   storage, the engine's peak within one gathered copy and one tensor,
   training afterwards refused;
58. dp replicas and ZeRO over sp copies (last) -- the fp32 flash kernels
   at a part's blocks and the fp32 AdamW kernel at the word table against
   their plain versions; the layered GPT at GPT-3 1.3B widths (2 layers,
   fp32, ``sequence_parallel``, batch 2 x 1024) under ``DataParallel`` at
   ``{"dp": 2, "sp": 2}`` and under ZeRO ``os`` and ``p_g_os`` at
   ``{"sharding": 2, "sp": 2}``, its positions ``SPR_DEVICES`` (each
   replica's sp position 1 a copy on the CPU), one step a run (two at
   ``os``, the second under the profiler), against one step of the same
   mesh all on the card: step 1's loss and gradients, every copy on its
   position's device and within ``SPR_COPY_REL`` of its source after each
   step (bit-equal under ZeRO), the flash launches of the ring's pairs on
   the card and one AdamW launch a tensor (or slice) on the card exactly;
   host ms a step, and device ms and busy share of the profiled step;
59. the Engine's plan under ZeRO -- phase 56's model and plan (seed 59)
   trained 2 steps by ``Engine.fit`` under the Strategy's sharding at
   ``os_g`` and at ``p_g_os`` over the placed blocks, against 2 steps of
   an Engine with no plan (``ENGINE_LOSS_REL``, ``ENGINE_GRAD_NORM``):
   exactly positions x layers launches of each flash kernel and one bf16
   AdamW launch a ZeRO slice a step, the bytes each position holds at
   rest the count by hand at each level, ``p_g_os``'s peak device memory
   in step 2 below ``os_g``'s; ``evaluate`` and ``predict`` under the
   plan against the unplanned Engine's; the fp32 copy at ``os``, ``os_g``
   and ``p_g_os`` planned on the card against the same on the CPU
   (``ENGINE_CPU_TOL``).

TF32 is off throughout: fp32 runs in full fp32 on the card.

Output: the card's name and power limit (nvidia-smi), one JSON line with
the kernels' numbers (the ragged rows carry their launches on each
main path, ``launches_by_path``; the flash rows also carry their ratio to SDPA,
their share of the bound, the whole backward's time against SDPA's
backward, and the forward's time at BERT's attention; the ragged row its
time, plain time and bound at the mixed served shape; the AdamW master
form's row its times at BERT-base and, beside them, at GPT-3 1.3B; the
fp32 form's row, launched by phase 31, its time with the flag and the
library's with ``found_inf``; the flash rows their launches on phases 6,
31 and 40, the forward's also on 35, 37 and 55
(``auto_parallel_dp2_mp2``), and, with the bf16 AdamW row, on phase
46's mesh runs and (fp32) phase 47's, and on phases
48-50's fleet steps (``train_fleet_*``) and phase 51's
(``train_sequence_parallel_*``), and with the fp32 AdamW row on phase
58's (``train_sp_replicas_*``); the fp32 AdamW row its launches on
phases 31, 47, 48-50 and 51's fp32 copies; the ragged row also phase
57e's (``zero_serving_fp32``); the decode and paged rows,
bf16 and int8, theirs on the stacked and the layered GPT's paths), and
as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""
from __future__ import annotations

import dataclasses
import gc
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
# phases 41-43's depth: GPT-3 1.3B's width at 4 of its layers (the
# cluster's placement, lifecycle and hand-off do not grow with depth)
SHARD_LAYERS = 4
# phases 26-29's depth: GPT-3 1.3B's width at 4 of its layers
# (the prefix cache, the watchdog, speculation and LoRA do not grow with
# depth; phase 57 serves LoRA and speculation at all 24, placed and not)
PATHS_LAYERS = 4
DEVICE = "cuda"


def import_port():
    """Everything of the port this script drives (kept in one place so a
    test can check the imports without a card)."""
    import torch
    from paddle_tpu_torch import amp, checkpoint, incubate, inference
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.models import BertForPretraining, BertModel, \
        BertPretrainingCriterion, GPTForPretraining, \
        GPTPretrainingCriterion, GPTStackedForPretraining, bert_base, \
        bert_tiny, gpt_13b, gpt_1p3b, gpt_tiny, truncated_draft
    from paddle_tpu_torch.io import DevicePrefetcher
    from paddle_tpu_torch.nn import clip
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import decode_attention as da
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import fused_adamw as fw
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rpa
    from paddle_tpu_torch.ops.kernels import rms_norm as rn
    from paddle_tpu_torch.optimizer import AdamW, FusedTrainStep, Momentum, lr
    from paddle_tpu_torch.quantization import int8 as qi8
    from paddle_tpu_torch.serving import RequestState, ServingEngine, \
        SpeculativeEngine
    from paddle_tpu_torch.serving import sharded
    from paddle_tpu_torch.distributed import DataParallel, fleet, mesh, \
        serving_mesh, shards
    from paddle_tpu_torch.distributed import sharding
    from paddle_tpu_torch.models import gpt as gpt_blocks
    from paddle_tpu_torch.nn.layers import LayerNorm, init_weights
    from paddle_tpu_torch.nn.functional import ring_attention as ring
    from paddle_tpu_torch.core import recompute
    from paddle_tpu_torch.distributed import auto_parallel, pp_spmd

    return dict(torch=torch, GPT=GPTStackedForPretraining, gpt_1p3b=gpt_1p3b,
                gpt_13b=gpt_13b, gpt_tiny=gpt_tiny, build=_build, rpa=rpa,
                fa=fa, fw=fw, da=da, pa=pa, qi8=qi8, rn=rn, F=F, incubate=incubate,
                BertModel=BertModel, BertForPretraining=BertForPretraining,
                BertPretrainingCriterion=BertPretrainingCriterion,
                bert_base=bert_base, bert_tiny=bert_tiny,
                AdamW=AdamW, FusedTrainStep=FusedTrainStep, amp=amp, lr=lr,
                clip=clip, RequestState=RequestState,
                ServingEngine=ServingEngine,
                SpeculativeEngine=SpeculativeEngine, serving=serving,
                truncated_draft=truncated_draft, checkpoint=checkpoint,
                DevicePrefetcher=DevicePrefetcher, Layered=GPTForPretraining,
                Criterion=GPTPretrainingCriterion,
                Int8Linear=qi8.Int8Linear, inference=inference,
                sharded=sharded, serving_mesh=serving_mesh, mesh=mesh,
                shards=shards, fleet=fleet, gpt_blocks=gpt_blocks,
                LayerNorm=LayerNorm, init_weights=init_weights,
                Momentum=Momentum, sharding=sharding, ring=ring,
                recompute=recompute, pp_spmd=pp_spmd,
                auto_parallel=auto_parallel, DataParallel=DataParallel)


def _check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def _kept(port, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, a kernel check, which must leave the
    calling thread's current CUDA device as it found it: every C launcher
    gives the caller's device back (``csrc/device_guard.cuh``)."""
    torch = port["torch"]
    before = torch.cuda.current_device()
    out = fn(*args, **kwargs)
    now = torch.cuda.current_device()
    _check(now == before, f"{fn.__name__} left the current device at "
           f"{now}, not {before}")
    return out


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


def serve_engine(port, kv_dtype="bfloat16", weight_dtype=None, model=None):
    """GPT-3 1.3B at full width with random bf16 weights (seed 0; or
    ``model``, another GPT-3 1.3B), a pool of ``kv_dtype`` (bf16, or int8
    with its scales), the weights quantized to int8 with
    ``weight_dtype="int8"``, 8 slots, page 128, max_context 512, warmed up
    by one request (cuBLAS handles and allocator pools).  Returns
    ``(engine, rng)``: the workload draws its prompts from ``rng``."""
    cfg = port["gpt_1p3b"]()
    _check(cfg.num_layers == SERVE_LAYERS, "gpt_1p3b has 24 layers")
    if model is None:
        model = port["GPT"](cfg, device=DEVICE, dtype="bfloat16", seed=0)
    eng = port["ServingEngine"](model, num_slots=8, page_size=128,
                                max_context=512, kv_dtype=kv_dtype,
                                weight_dtype=weight_dtype)
    rng = np.random.RandomState(0)
    eng.generate_batch([rng.randint(0, cfg.vocab_size, (64,))], 2)
    port["torch"].cuda.synchronize()
    return eng, rng


def _no_recovery(name, eng):
    """A phase that injects no fault: the engine retried, recovered,
    rebuilt and quarantined nothing."""
    m = eng.metrics()
    got = {k: m[k] for k in ("step_retries", "recoveries", "rebuilds",
                             "quarantined", "failed")}
    _check(not any(got.values()), f"{name}: faults without an injection: "
           f"{got}")


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
    _no_recovery("serve", eng)
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
    return launches, tokens / dt


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
    opt = port["AdamW"](parameters=model.parameters(), learning_rate=1e-4,
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
    return launches, dict(step_s=step_s, mfu=mfu, peak=peak)


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
        opt = port["AdamW"](parameters=m.parameters(), learning_rate=1e-4)
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


def generate_setup(port, cls="GPT"):
    """GPT-3 1.3B at full width and depth (``port[cls]``: the stacked GPT,
    or ``"Layered"``) with random bf16 weights (seed 0) and GEN_BATCH
    fixed random prompts of GEN_PROMPT tokens on the card, warmed up by
    one short ``generate`` (cuBLAS handles, the allocator, the bf16
    cache).  Returns ``(model, ids)``."""
    torch = port["torch"]
    cfg = port["gpt_1p3b"]()
    _check(cfg.num_layers == SERVE_LAYERS, "gpt_1p3b has 24 layers")
    model = port[cls](cfg, device=DEVICE, dtype="bfloat16", seed=0)
    model.eval()
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
    stats = dict(tps=GEN_BATCH * GEN_NEW / wall, prefill_ms=1e3 * prefill_s,
                 decode_ms=decode_ms)
    return model, ids, out, logits, launches["decode"], stats


# ---------------------------------------------------------------------------
# phase 10: the paged step without a plan at full width
# ---------------------------------------------------------------------------

def phase_paged(port, model, ids, out, logits, per_step_launches=None):
    """Phase 10 on ``model`` against ``logits`` (``out``'s tokens
    teacher-forced); ``per_step_launches``: the paged launches a step
    (default one a layer; mp a layer for a model placed at mp > 1)."""
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
    L = per_step_launches or cfg.num_layers
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
    opt = port["AdamW"](sched, parameters=model.named_parameters(),
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
    opt = port["AdamW"](parameters=model.parameters(), learning_rate=1e-4,
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
        opt = port["AdamW"](parameters=m.parameters(), learning_rate=1e-4,
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




# ---------------------------------------------------------------------------
# phases 25-29: the prefix cache, the watchdog, speculation and LoRA
# ---------------------------------------------------------------------------

# The parity rule of these phases.  Two engines that run the same tokens
# through different batch compositions (a verify run of k + 1 rows, a tail
# prefill that starts past 0, a draft of other rows) do not reproduce each
# other bit for bit on the card: a row's cuBLAS result can depend on how
# many rows its product has.  So where two runs' tokens part, the first
# parting is allowed only where the reference's top-2 logit gap at that
# position (a third computation: the paged step without a plan over the
# reference's own tokens) is below a bound:
# - bf16 weights (bf16 or int8 pool): 2^-2.  Phase 10 measured two bf16
#   paths of this model at a relative logit norm of 0.0148 (logits of RMS
#   ~0.9: 0.02 * sqrt(2048) through the tied head), so a logit moves by
#   ~0.013 RMS and ~0.07 at 5 sigma, and two logits' moves add: the top-2
#   order can flip only within ~0.15 of a tie;
# - int8 weights, LoRA against merged weights: 2^-1.  The oracle quantizes
#   W + BA where the engine quantizes W and adds BA in fp32: two int8
#   roundings of each weight, each moving the logits by up to phase 14's
#   0.046 relative norm (~0.04 RMS, ~0.2 at 5 sigma; two logits, 0.4);
# - fp32 with TF32 off (2 layers at full width): 2^-13.  The same fp32
#   arithmetic summed in another order moves a logit by ~1e-6 of the
#   logits' scale; the bound leaves a margin of ~100x for a near tie.
GAP_BOUND = {"bfloat16": 2.0 ** -2, "int8_weights": 2.0 ** -1,
             "float32": 2.0 ** -13}
SPEC_K = 4
PREFIX_SYSTEM, PREFIX_CONTEXT = 384, 1024
LORA_RANK, LORA_ADAPTERS = 16, 4
# the watchdog's budget: ~80x the serve step's ~12 ms (phase 3), small
# beside the injected stall of three budgets
WATCH_BUDGET = 1.0


def _engine_kw(**kw):
    """Phase 3's engine: 8 slots, page 128, max_context 512."""
    return dict(dict(num_slots=8, page_size=128, max_context=512), **kw)


def _serve_prompts(rng, vocab, n=SERVE_REQUESTS):
    return [rng.randint(0, vocab, (SERVE_PROMPT_LENS[i % 4],))
            for i in range(n)]


def _ledger_ok(a):
    return a.free_pages + a.used_pages + a.spec_pages + a.shared_pages \
        == a.capacity


def _drive(port, eng, prompts, new, adapters=None, sampling=None):
    """Submit every prompt at once and step ``eng`` to idle, holding the
    page ledger of each of its allocators at every step.  Returns
    (requests, wall seconds, steps)."""
    allocs = [eng.allocator]
    if getattr(eng, "draft", None) is not None:
        allocs.append(eng.draft.allocator)
    adapters = adapters or [None] * len(prompts)
    t0 = time.perf_counter()
    reqs = [eng.submit(p, new, adapter=a, sampling=sampling)
            for p, a in zip(prompts, adapters)]
    steps = 0
    while eng.queue.depth or eng.scheduler.active_slots:
        met = eng.step()
        steps += 1
        _check(all(_ledger_ok(a) for a in allocs),
               "free + used + spec + shared != capacity")
        _check(steps < 20000, "the engine made no progress")
        if not met["active_slots"] and not met["tokens_this_step"]:
            time.sleep(0.001)          # post-recovery backoff window
    port["torch"].cuda.synchronize()
    return reqs, time.perf_counter() - t0, steps


def _all_done(port, name, reqs, new):
    done = port["RequestState"].DONE
    _check(all(r.state == done and len(r.tokens) == new for r in reqs),
           f"{name}: requests not all DONE with {new} tokens: "
           f"{[(r.state, len(r.tokens), r.error) for r in reqs]}")


def _gap_at(port, model, ids, pos, kv_dtype):
    """The top-2 gap of ``model``'s logits for token ``pos`` of ``ids``:
    the paged step without a plan (a chunked prefill of ids[:pos] at
    position 0, plain attention over its pages) in a pool of
    ``kv_dtype``."""
    torch = port["torch"]
    pages = -(-pos // 128)
    cache = model.new_paged_kv_cache(pages + 1, 128, dtype=kv_dtype)
    tables = torch.arange(1, pages + 1, dtype=torch.int32,
                          device=DEVICE)[None]
    with torch.no_grad():
        lg = model._paged_lm_logits(
            torch.from_numpy(np.asarray(ids[:pos])[None]).to(DEVICE), cache,
            tables, torch.zeros(1, dtype=torch.int32, device=DEVICE))
    top = lg[0, -1].float().topk(2).values
    cache.release()
    return float(top[0] - top[1])


def _parity(port, name, got, want, model, bound, kv_dtype):
    """Hold ``got`` against ``want`` (output ids, prompt + tokens) under
    the parity rule (``GAP_BOUND``), the gap read from ``model`` over the
    reference's tokens; prints the agreement."""
    same, agree, total, parted = 0, 0, 0, []
    for g, w in zip(got, want):
        _check(len(g) == len(w), f"{name}: lengths {len(g)} != {len(w)}")
        diff = np.nonzero(np.asarray(g) != np.asarray(w))[0]
        total += 1
        if not len(diff):
            same += 1
            continue
        pos = int(diff[0])
        parted.append((pos, _gap_at(port, model, w, pos, kv_dtype)))
    for g, w in zip(got, want):
        diff = np.nonzero(np.asarray(g) != np.asarray(w))[0]
        agree += int(diff[0]) if len(diff) else len(w)
    print(f"[parity] {name}: {same}/{total} requests token for token, "
          f"{agree / sum(len(w) for w in want):.4f} of the ids before a "
          f"parting; partings (position, reference top-2 gap): {parted} "
          f"(gap bound {bound!r})")
    worst = max((gap for _, gap in parted), default=0.0)
    _check(worst < bound, f"{name}: tokens part where the reference's "
           f"top-2 gap is {worst} (bound {bound})")
    return same, total


def _p50_ttft(reqs):
    return float(np.median([r.t_first_token - r.t_submitted for r in reqs]))


# -- phase 25: the ragged kernel at the new plans ---------------------------

def spec_geometry(rpa, draft=False, max_pages=4):
    """The speculative engine's fused-step geometry over phase 3's engine
    (8 slots, page 128, a 128-token budget, k = 4): verify runs of k + 1
    rows a slot; the draft's shadow takes catch-up runs of up to k + 2."""
    per = SPEC_K + (2 if draft else 1)
    nb_max = 8 * -(-per // rpa.TOKEN_BLOCK) + 8 + 128 // rpa.TOKEN_BLOCK
    return dict(num_pages=8 * max_pages + 1, heads=16, page_size=128,
                head_dim=128, t_max=8 * per + 128, nb_max=nb_max,
                wl_max=nb_max * max_pages, max_pages=max_pages)


def prefix_geometry(rpa):
    """The prefix-cache engine: phase 3's with max_context 1024."""
    mp, nb_max = 8, 8 + 128 // rpa.TOKEN_BLOCK
    return dict(num_pages=8 * mp + 1, heads=16, page_size=128, head_dim=128,
                t_max=8 + 128, nb_max=nb_max, wl_max=nb_max * mp,
                max_pages=mp)


def new_plan_cases(rpa, rng, shard_heads):
    """(name, runs, geometry) of the plans phases 26-29 launch, and of the
    per-shard step of phases 41-43 (``shard_heads`` heads a shard)."""
    spec = spec_geometry(rpa)
    tb = _served_runs(rng, spec["num_pages"])
    k1 = SPEC_K + 1
    verify = [(380, k1, tb[0]), (124, k1, tb[1]), (253, k1, tb[2]),
              (300, k1, tb[3]), (64, 1, tb[4]), (507, k1, tb[5]),
              (0, 64, tb[6]), (120, 40, tb[7])]
    pre = prefix_geometry(rpa)
    perm = rng.permutation(np.arange(1, pre["num_pages"])).astype(np.int32)
    system = perm[:3]                  # pages another request wrote

    def row(own):
        return np.concatenate([system, own]).astype(np.int32)

    tail = [(PREFIX_SYSTEM, 100, row(perm[3:8])),
            (PREFIX_SYSTEM, 28, row(perm[8:13])),
            (420, 1, row(perm[13:18])),
            (700, 1, perm[18:26])]
    draft = spec_geometry(rpa, draft=True)
    td = _served_runs(rng, draft["num_pages"])
    drafts = [(200, SPEC_K + 2, td[0]), (250, SPEC_K + 2, td[1]),
              (300, 1, td[2]), (127, 1, td[3]), (0, 100, td[4]),
              (383, 3, td[5])]
    shard = dict(served_geometry(rpa), heads=shard_heads)
    ts = _served_runs(rng, shard["num_pages"])
    return (("verify_runs", verify, spec), ("tail_prefill", tail, pre),
            ("draft_pool", drafts, draft),
            (f"shard_step_{shard_heads}_heads", mixed_runs(ts), shard))


# the kernel against split_merge_plain, its own arithmetic in plain
# PyTorch: bf16 as TOL (the output rounded once, summation order); fp32
# the same sums in another order, with a relative term for int8 pages,
# which dequantize to values up to 127 x 0.035 = 4.4
SPLIT_MERGE_TOL = {"bfloat16": TOL["bfloat16"], "float32": (2e-5, 1e-5),
                   "int8": (2e-5, 1e-5)}


def _split_merge_check(port, name, c, layer):
    """The kernel against ``split_merge_plain`` (its own split-and-merge
    arithmetic in plain PyTorch, from the plan alone) under
    ``SPLIT_MERGE_TOL``."""
    torch, rpa = port["torch"], port["rpa"]
    kp, vp = c["k"][layer], c["v"][layer]
    sc = {}
    if c["dtype"] == "int8":
        sc = dict(k_scale=c["k_scale"][layer], v_scale=c["v_scale"][layer])
    got = rpa.ragged_paged_attention(c["q"], kp, vp, c["tables"],
                                     c["lengths"], c["plan"], **sc)
    d = c["q"].shape[-1]
    want = rpa.split_merge_plain(
        c["q"].to(got.dtype), kp, vp, c["plan"], 1.0 / d ** 0.5,
        rpa.keys_per_split(d, kp.dtype), sc.get("k_scale"),
        sc.get("v_scale"))
    torch.cuda.synchronize()
    real = c["stats"]["n_tokens"]
    atol, rtol = SPLIT_MERGE_TOL[c["dtype"]]
    diff = (got[:real].float() - want[:real].float()).abs()
    err = diff.max().item()
    over = (diff - atol - rtol * want[:real].float().abs()).max().item()
    print(f"[new_plans] {name} {c['dtype']} vs split_merge_plain: "
          f"max_abs_err={err!r} tol={atol}+{rtol}*|plain|")
    _check(over <= 0, f"{name} {c['dtype']}: kernel vs split_merge_plain "
           f"off by {err}")
    return err


def phase_new_plans(port):
    """Phase 25: the ragged kernel at the plans of phases 26-29 and at
    the shard shape of phases 41-43 (GPT-3 1.3B at mp=2), against both
    plain versions, rerun bit for bit and over a stale pool."""
    rpa = port["rpa"]
    errs = {"float": [], "int8": []}
    shard_heads = port["gpt_1p3b"]().num_heads // 2
    for name, runs, geo in new_plan_cases(rpa, np.random.RandomState(25),
                                          shard_heads):
        for i, dtype in enumerate(("bfloat16", "float32", "int8")):
            layers = 2 if name == "draft_pool" else 1
            c = _case(port, runs, dtype=dtype, seed=250 + i, layers=layers,
                      **geo)
            _check(c["stats"]["n_blocks"] < geo["nb_max"],
                   f"{name}: the case must leave padding blocks")
            # the draft's case holds its pool's second layer (a view of
            # the stacked [2, ...] pool, as the draft model passes it)
            lc = {**c, **{k: c[k][layers - 1:] for k in
                          ("k", "v", "k_scale", "v_scale")
                          if c[k] is not None}}
            if dtype == "int8":
                errs["int8"].append(_ragged_int8_compare(port, name, lc))
            else:
                errs["float"].append(_compare(port, name, lc))
            err = _split_merge_check(port, name, c, layers - 1)
            errs["int8" if dtype == "int8" else "float"].append(err)
            del c, lc
    port["torch"].cuda.empty_cache()
    return {k: max(v) for k, v in errs.items()}


# -- phase 26: the prefix cache ---------------------------------------------

def _prefix_traffic(rng, vocab):
    """A 384-token system prompt; a warming request and 16 requests, each
    the system prompt and a 16-200-token tail."""
    system = rng.randint(0, vocab, (PREFIX_SYSTEM,))
    prompts = [np.concatenate([system, rng.randint(
        0, vocab, (int(rng.randint(16, 201)),))]) for _ in range(17)]
    return prompts[0], prompts[1:]


def phase_prefix_cache(port, model, fp32_model):
    torch = port["torch"]
    se = port["ServingEngine"]
    vocab = model.config.vocab_size
    launches = {}
    for kv in ("bfloat16", "int8"):
        warm, prompts = _prefix_traffic(np.random.RandomState(26), vocab)
        kw = _engine_kw(max_context=PREFIX_CONTEXT, kv_dtype=kv)
        cold = se(model, **kw)
        cold.generate_batch([warm], SERVE_NEW_TOKENS)
        cfused = cold.metrics()["fused_steps"]
        creqs, cdt, _ = _drive(port, cold, prompts, SERVE_NEW_TOKENS)
        cfused = cold.metrics()["fused_steps"] - cfused
        _no_recovery(f"prefix {kv} cache off", cold)
        cold.close()
        eng = se(model, prefix_cache=True, **kw)
        eng.generate_batch([warm], SERVE_NEW_TOKENS)   # registers the pages
        nodes, sys_pages, n = eng.prefix_cache.acquire(prompts[0])
        eng.prefix_cache.release(nodes)
        _check(n == PREFIX_SYSTEM, f"the warm request cached {n} tokens")
        if kv == "int8":
            scales = [t[:, sys_pages].clone()
                      for t in (eng.cache.k_scale, eng.cache.v_scale)]
        m0 = eng.metrics()
        _reset_launches(port)
        reqs, dt, steps = _drive(port, eng, prompts, SERVE_NEW_TOKENS)
        counts = _launch_counts(port)
        n_launch = counts.pop("ragged")
        m = eng.metrics()
        fused = m["fused_steps"] - m0["fused_steps"]
        L = model.config.num_layers
        _check(n_launch == fused * L and not any(counts.values()),
               f"prefix {kv}: ragged launches {n_launch} != fused steps "
               f"{fused} x {L} (others {counts})")
        _all_done(port, f"prefix {kv}", reqs, SERVE_NEW_TOKENS)
        _no_recovery(f"prefix {kv}", eng)
        hits = {k: m[k] - m0[k] for k in ("prefix_hits",
                                           "prefix_partial_hits",
                                           "prefix_misses",
                                           "prefix_cached_tokens",
                                           "prefill_tokens")}
        looked = hits["prefix_hits"] + hits["prefix_partial_hits"] + \
            hits["prefix_misses"]
        _check(looked == len(prompts) and hits["prefix_misses"] == 0,
               f"prefix {kv}: {hits}")
        tokens = len(reqs) * SERVE_NEW_TOKENS
        print(f"[prefix] kv {kv}: hit rate "
              f"{(looked - hits['prefix_misses']) / looked:.3f} "
              f"({hits['prefix_hits']} hits, {hits['prefix_partial_hits']} "
              f"partial), cached tokens {hits['prefix_cached_tokens']} = "
              f"prefill tokens saved (prefilled "
              f"{hits['prefill_tokens']}); TTFT p50 hits "
              f"{1e3 * _p50_ttft(reqs):.1f} ms against cold misses "
              f"{1e3 * _p50_ttft(creqs):.1f} ms; {tokens / dt:.1f} tokens/s "
              f"against {tokens / cdt:.1f} cold; {fused} fused steps "
              f"against {cfused} cold, ragged launches {n_launch}")
        _parity(port, f"prefix {kv} cache on vs off",
                [r.output_ids() for r in reqs],
                [r.output_ids() for r in creqs], model,
                GAP_BOUND["bfloat16"], kv)
        if kv == "int8":
            kept = all(torch.equal(t[:, sys_pages], s) for t, s in
                       zip((eng.cache.k_scale, eng.cache.v_scale), scales))
            finite = all(bool(torch.isfinite(t).all())
                         for t in (eng.cache.k_scale, eng.cache.v_scale))
            print(f"[prefix] int8: the adopted pages {sys_pages} kept their "
                  f"per-(page, head) scales bit for bit: {kept}; scales "
                  f"finite: {finite}")
            _check(kept and finite, "prefix int8: adopted pages' scales")
        a = eng.allocator
        shared = a.shared_pages
        eng.prefix_cache.flush()
        print(f"[prefix] kv {kv}: {shared} cache-held pages flushed; pages "
              f"used {a.used_pages}, shared {a.shared_pages}, free "
              f"{a.free_pages} of {a.capacity}")
        _check(a.used_pages == 0 and a.shared_pages == 0
               and a.free_pages == a.capacity, "prefix: pages did not drain")
        launches[kv] = n_launch
        eng.close()
        del eng, cold
        torch.cuda.empty_cache()
    # fp32 with TF32 off, 2 layers at full width: cache on == cache off
    warm, prompts = _prefix_traffic(np.random.RandomState(126), vocab)
    outs = []
    for cached in (False, True):
        eng = se(fp32_model, prefix_cache=cached, **_engine_kw(
            max_context=PREFIX_CONTEXT, kv_dtype="float32"))
        eng.generate_batch([warm], 8)
        reqs, _, _ = _drive(port, eng, prompts[:8], 8)
        outs.append([r.output_ids() for r in reqs])
        eng.close()
    _parity(port, "prefix fp32 2 layers cache on vs off", outs[1], outs[0],
            fp32_model, GAP_BOUND["float32"], "float32")
    return launches


# -- phase 27: the watchdog --------------------------------------------------

def _zombie_threads(eng):
    import threading

    live = eng._worker._t if eng._worker is not None else None
    return [t for t in threading.enumerate()
            if t.name.startswith("serving-step-") and t is not live]


STALL_ROUNDS = 5


def _stall_memory(port, model):
    """Five stall recoveries in a row on one bf16 engine: each round
    injects one stall of three budgets, drives four short requests through
    the recovery and rebuild, waits for the zombie to return and reads
    ``torch.cuda.memory_allocated()``.  Fails if memory grows from the
    second reading to the fifth by more than one pool.  Returns the
    readings (bytes) and the pool's bytes."""
    torch, s = port["torch"], port["serving"]
    eng = port["ServingEngine"](model, stall_budget_s=WATCH_BUDGET,
                                compile_budget_s=300.0,
                                **_engine_kw(kv_dtype="bfloat16"))
    prompts = _serve_prompts(np.random.RandomState(270),
                             model.config.vocab_size, 4)
    eng.generate_batch([prompts[0][:64]], 2)     # every variant warm
    pool = eng.cache.nbytes
    readings, recoveries = [], []
    for _ in range(STALL_ROUNDS):
        m0 = eng.metrics()["recoveries"]
        (s.FaultInjector().inject("before_decode", at=2, kind="step_stall",
                                  duration=3 * WATCH_BUDGET).install(eng))
        _drive(port, eng, prompts, 8)
        for t in _zombie_threads(eng):
            t.join(timeout=30.0)
        torch.cuda.synchronize()
        readings.append(torch.cuda.memory_allocated())
        recoveries.append(eng.metrics()["recoveries"] - m0)
    eng.close()
    growth = readings[-1] - readings[1]
    print(f"[watchdog] {STALL_ROUNDS} stall recoveries in a row (bf16): "
          f"recoveries per round {recoveries}; device memory after each "
          f"zombie returned {readings} bytes; growth from the second to "
          f"the last {growth} bytes (pool {pool} bytes)")
    _check(recoveries == [1] * STALL_ROUNDS,
           f"watchdog: stall rounds recovered {recoveries}")
    _check(growth <= pool, f"watchdog: device memory grew {growth} bytes "
           f"over {STALL_ROUNDS - 2} stall recoveries (pool {pool})")
    return readings, pool


def phase_watchdog(port, model, fp32_model):
    torch = port["torch"]
    se = port["ServingEngine"]
    s = port["serving"]
    vocab = model.config.vocab_size
    launches = {}
    for kv in ("bfloat16", "int8"):
        prompts = _serve_prompts(np.random.RandomState(27), vocab, 32)
        ref = se(model, **_engine_kw(kv_dtype=kv))
        ref.generate_batch([prompts[0][:64]], 2)
        rreqs, _, _ = _drive(port, ref, prompts, SERVE_NEW_TOKENS)
        ref.close()
        eng = se(model, stall_budget_s=WATCH_BUDGET, compile_budget_s=300.0,
                 **_engine_kw(kv_dtype=kv))
        eng.generate_batch([prompts[0][:64]], 2)     # every variant warm
        pool_bytes = eng.cache.nbytes
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        inj = (s.FaultInjector()
               .inject("before_decode", at=4, kind="step_stall",
                       duration=3 * WATCH_BUDGET)
               .inject("before_decode", at=40, times=2,
                       kind="step_exception", state_intact=False)
               .inject("after_decode", at=70, kind="nan_logits",
                       slots=[0])
               .inject("alloc", at=12, kind="alloc_exhausted")
               .install(eng))
        m0 = eng.metrics()
        _reset_launches(port)
        reqs, dt, steps = _drive(port, eng, prompts, SERVE_NEW_TOKENS)
        counts = _launch_counts(port)
        n_launch = counts.pop("ragged")
        m = eng.metrics()
        d = {k: m[k] - m0[k] for k in ("recoveries", "rebuilds",
                                         "step_retries", "quarantined",
                                         "failed", "fused_steps")}
        fired = {k: inj.fired(k) for k in ("step_stall", "step_exception",
                                            "nan_logits", "alloc_exhausted")}
        zombies = _zombie_threads(eng)
        alive = [t.is_alive() for t in zombies]
        torch.cuda.synchronize()
        mem_run = torch.cuda.memory_allocated()
        for t in zombies:
            t.join(timeout=30.0)
        torch.cuda.synchronize()
        mem1 = torch.cuda.memory_allocated()
        by_error = {}
        for r in reqs:
            key = type(r.error).__name__ if r.error is not None else r.state
            by_error[key] = by_error.get(key, 0) + 1
        print(f"[watchdog] kv {kv}: stall budget {WATCH_BUDGET} s, compile "
              f"budget {eng.compile_budget_s} s; shots fired {fired}; "
              f"recoveries {d['recoveries']}, rebuilds {d['rebuilds']}, "
              f"retries {d['step_retries']}, quarantined "
              f"{d['quarantined']}; requests {by_error}; {steps} steps in "
              f"{dt:.2f} s; device memory {mem0} before, {mem_run} at the "
              f"end of the run (zombie threads alive then: {alive}), "
              f"{mem1} once they returned (pool {pool_bytes} bytes)")
        _check(fired == {"step_stall": 1, "step_exception": 2,
                         "nan_logits": 1, "alloc_exhausted": 1},
               f"watchdog {kv}: the plan did not fire as set: {fired}")
        # one recovery and one rebuild per stall and per persistent
        # non-intact exception; the exception's first shot is retried
        _check(d["recoveries"] == 2 and d["rebuilds"] == 2
               and d["step_retries"] == 1,
               f"watchdog {kv}: recoveries/rebuilds/retries {d}")
        _check(d["quarantined"] == by_error.get("NaNLogitsError", 0) == 1
               and by_error.get("StepStalledError", 0) >= 1
               and by_error.get("InjectedFault", 0) >= 1
               and d["failed"] == sum(v for k, v in by_error.items()
                                      if k != "DONE"),
               f"watchdog {kv}: the implicated requests {by_error}")
        L = model.config.num_layers
        _check(n_launch == d["fused_steps"] * L
               and not any(counts.values()),
               f"watchdog {kv}: launches {n_launch} != fused steps "
               f"{d['fused_steps']} x {L} ({counts})")
        _check(mem1 - mem0 < pool_bytes // 2,
               f"watchdog {kv}: device memory did not come back "
               f"({mem0} -> {mem1})")
        if kv == "int8":
            _check(all(bool(torch.isfinite(t).all()) and t.shape[1]
                       == eng.num_pages for t in (eng.cache.k_scale,
                                                  eng.cache.v_scale)),
                   "watchdog int8: the rebuilt pool's scales")
        done = [i for i, r in enumerate(reqs) if r.finished]
        _parity(port, f"watchdog {kv} survivors vs unfaulted",
                [reqs[i].output_ids() for i in done],
                [rreqs[i].output_ids() for i in done], model,
                GAP_BOUND["bfloat16"], kv)
        launches[kv] = n_launch
        eng.close()
        del eng
        torch.cuda.empty_cache()
    _stall_memory(port, model)
    torch.cuda.empty_cache()
    # fp32 with TF32 off, 2 layers at full width: the survivors of a stall
    # and a persistent exception against the unfaulted run
    fp = _serve_prompts(np.random.RandomState(127), vocab, 24)
    want = se(fp32_model, **_engine_kw(kv_dtype="float32")).generate_batch(
        fp, 16)
    eng = se(fp32_model, stall_budget_s=WATCH_BUDGET, compile_budget_s=300.0,
             **_engine_kw(kv_dtype="float32"))
    eng.generate_batch([fp[0][:64]], 2)
    (s.FaultInjector()
     .inject("before_decode", at=2, kind="step_stall",
             duration=3 * WATCH_BUDGET)
     .inject("before_decode", at=14, times=2, kind="step_exception",
             state_intact=False)
     .install(eng))
    m0 = eng.metrics()
    reqs, _, _ = _drive(port, eng, fp, 16)
    m = eng.metrics()
    rec = (m["recoveries"] - m0["recoveries"], m["rebuilds"] - m0["rebuilds"])
    done = [i for i, r in enumerate(reqs) if r.finished]
    print(f"[watchdog] fp32 2 layers: recoveries, rebuilds {rec}; "
          f"{len(done)} of {len(reqs)} requests survive")
    _check(rec == (2, 2) and 0 < len(done) < len(reqs),
           f"watchdog fp32: recoveries/rebuilds {rec}, survivors {done}")
    _parity(port, "watchdog fp32 2 layers survivors vs unfaulted",
            [reqs[i].output_ids() for i in done], [want[i] for i in done],
            fp32_model, GAP_BOUND["float32"], "float32")
    for t in _zombie_threads(eng):
        t.join(timeout=30.0)
    eng.close()
    return launches


# -- phase 28: speculative decoding -----------------------------------------

def _count_draft(port, eng, box):
    """Wrap the speculative engine's draft dispatch to add the ragged
    launches of its draft steps to ``box[0]`` (the verify step never
    passes here, so the split holds for a self-draft too)."""
    rpa = port["rpa"].ragged_paged_attention
    inner = eng._draft_dispatch

    def counted(*a, **k):
        r0 = rpa.launches
        out = inner(*a, **k)
        box[0] += rpa.launches - r0
        return out

    eng._draft_dispatch = counted


def phase_speculative(port, model, fp32_model, serve_tps):
    """Phase 28; ``serve_tps``: phase 3's tokens/s, printed beside."""
    torch = port["torch"]
    se, spe = port["ServingEngine"], port["SpeculativeEngine"]
    vocab, L = model.config.vocab_size, model.config.num_layers
    prompts = _serve_prompts(np.random.RandomState(28), vocab)
    launches = {}
    truncated = port["truncated_draft"](model, 2)
    box = [0]
    for kv in ("bfloat16", "int8"):
        plain = se(model, **_engine_kw(kv_dtype=kv))
        plain.generate_batch([prompts[0][:64]], 2)
        preqs, pdt, psteps = _drive(port, plain, prompts, SERVE_NEW_TOKENS)
        plain.close()
        tokens = len(prompts) * SERVE_NEW_TOKENS
        print(f"[speculative] kv {kv}: the plain engine {tokens / pdt:.1f} "
              f"tokens/s, {1e3 * pdt / psteps:.2f} ms a step (host clock; "
              f"phase 3: {serve_tps:.1f} tokens/s)")
        drafts = [("truncated_draft(target, 2)", truncated, 2)]
        if kv == "bfloat16":
            drafts.append(("the target itself", model, L))
            # all but the last block: a draft that agrees in part, so
            # verify runs commit partial acceptances on the card too
            drafts.append((f"truncated_draft(target, {L - 1})",
                           port["truncated_draft"](model, L - 1), L - 1))
        launches[kv] = 0
        for name, draft, dl in drafts:
            eng = spe(model, draft, spec_k=SPEC_K, **_engine_kw(kv_dtype=kv))
            eng.generate_batch([prompts[0][:64]], 8)
            _count_draft(port, eng, box)
            m0 = eng.metrics()
            _reset_launches(port)
            box[0] = 0
            reqs, dt, steps = _drive(port, eng, prompts, SERVE_NEW_TOKENS)
            counts = _launch_counts(port)
            total = counts.pop("ragged")
            m = eng.metrics()
            d = {k: m[k] - m0[k] for k in (
                "spec_verify_steps", "spec_draft_steps", "fused_steps",
                "spec_proposed_tokens", "spec_accepted_tokens",
                "spec_draft_skips")}
            acc = d["spec_accepted_tokens"] / max(d["spec_proposed_tokens"], 1)
            draft_l = box[0]
            target_l = total - draft_l
            _all_done(port, f"speculative {kv} {name}", reqs,
                      SERVE_NEW_TOKENS)
            _no_recovery(f"speculative {kv} {name}", eng)
            print(f"[speculative] kv {kv}, draft {name}, k {SPEC_K}: "
                  f"acceptance {acc:.4f} ({d['spec_accepted_tokens']} of "
                  f"{d['spec_proposed_tokens']}), verify steps "
                  f"{d['spec_verify_steps']}, draft steps "
                  f"{d['spec_draft_steps']}, draft skips "
                  f"{d['spec_draft_skips']}; {tokens / dt:.1f} tokens/s "
                  f"against the plain engine's {tokens / pdt:.1f} in this "
                  f"run; ragged launches: target {target_l}, draft "
                  f"{draft_l}")
            _check(d["spec_verify_steps"] == d["fused_steps"]
                   and target_l == d["spec_verify_steps"] * L
                   and draft_l == d["spec_draft_steps"] * dl
                   and not any(counts.values()),
                   f"speculative {kv} {name}: launches {total} (draft "
                   f"{draft_l}) against verify {d['spec_verify_steps']} x "
                   f"{L} + draft {d['spec_draft_steps']} x {dl} ({counts})")
            if draft is model:
                # the draft is the target: a proposal is rejected only
                # where the draft's bf16 argmax and the verify run's part,
                # within rounding of a tie (the parity rule's bound)
                _check(acc >= 0.95, f"speculative self-draft acceptance "
                       f"{acc}")
            _parity(port, f"speculative {kv} {name} vs plain",
                    [r.output_ids() for r in reqs],
                    [r.output_ids() for r in preqs], model,
                    GAP_BOUND["bfloat16"], kv)
            if kv == "int8":
                _check(eng.draft.cache.quantized, "the draft pool not int8")
            launches[kv] += total
            eng.close()
            del eng
            torch.cuda.empty_cache()
        drafts.clear()
    # one sampled run, checked by property
    eng = spe(model, truncated, spec_k=SPEC_K, seed=7, **_engine_kw())
    sp = port["serving"].SamplingParams(do_sample=True, temperature=0.8,
                                        top_k=50, top_p=0.95)
    m0 = eng.metrics()
    _reset_launches(port)
    reqs, dt, _ = _drive(port, eng, prompts, SERVE_NEW_TOKENS, sampling=sp)
    total = _launch_counts(port)["ragged"]
    m = eng.metrics()
    prop = m["spec_proposed_tokens"] - m0["spec_proposed_tokens"]
    acc = (m["spec_accepted_tokens"] - m0["spec_accepted_tokens"]) / \
        max(prop, 1)
    _all_done(port, "speculative sampled", reqs, SERVE_NEW_TOKENS)
    _no_recovery("speculative sampled", eng)
    in_vocab = all(0 <= t < vocab for r in reqs for t in r.tokens)
    distinct = len({tuple(r.tokens) for r in reqs})
    print(f"[speculative] sampled (temperature 0.8, top-k 50, top-p 0.95), "
          f"draft truncated_draft(target, 2): {len(reqs)} requests DONE, "
          f"tokens in the vocabulary {in_vocab}, {distinct} distinct "
          f"continuations, acceptance {acc:.4f} of {prop} proposed, "
          f"{len(reqs) * SERVE_NEW_TOKENS / dt:.1f} tokens/s, ragged "
          f"launches {total}")
    _check(in_vocab and distinct == len(reqs) and 0 < acc <= 1
           and eng.draft.allocator.spec_pages == 0,
           "speculative sampled: property")
    launches["bfloat16"] += total
    eng.close()
    del eng, truncated
    torch.cuda.empty_cache()
    # fp32 with TF32 off, 2 layers at full width: speculative == plain
    fp = _serve_prompts(np.random.RandomState(128), vocab, 8)
    want = se(fp32_model, **_engine_kw(kv_dtype="float32")).generate_batch(
        fp, 16)
    for name, draft in (("self", fp32_model),
                        ("truncated 1", port["truncated_draft"](fp32_model,
                                                                1))):
        got = spe(fp32_model, draft, spec_k=SPEC_K, **_engine_kw(
            kv_dtype="float32")).generate_batch(fp, 16)
        _parity(port, f"speculative fp32 2 layers draft {name} vs plain",
                got, want, fp32_model, GAP_BOUND["float32"], "float32")
    return launches


# -- phase 29: multi-tenant LoRA --------------------------------------------

def phase_lora(port, model, fp32_model):
    torch = port["torch"]
    s = port["serving"]
    se = port["ServingEngine"]
    cfg = model.config
    vocab = cfg.vocab_size
    pool = s.LoRAAdapterPool(cfg, num_adapter_pages=LORA_ADAPTERS,
                             rank=LORA_RANK, dtype="bfloat16", stacked=True,
                             device=DEVICE)
    names = [f"tenant{i}" for i in range(LORA_ADAPTERS)]
    t0 = time.perf_counter()
    for i, name in enumerate(names):
        pool.register(name, s.random_adapter(cfg, LORA_RANK,
                                             np.random.RandomState(290 + i)))
    print(f"[lora] {LORA_ADAPTERS} adapters of rank {LORA_RANK} on qkv, "
          f"out_proj, fc1, fc2 registered in "
          f"{time.perf_counter() - t0:.2f} s; slabs {pool.nbytes} bytes "
          f"({pool.num_pages} pages, the null page included)")
    prompts = _serve_prompts(np.random.RandomState(29), vocab)
    tenants = [names[i % 5] if i % 5 < LORA_ADAPTERS else None
               for i in range(len(prompts))]
    launches = {}
    variants = (("bfloat16", None), ("int8", "int8"))
    for tag, wd in variants:
        base = model if wd is None else port["GPT"](
            cfg, device=DEVICE, dtype="bfloat16", seed=0)
        eng = se(base, lora=pool, weight_dtype=wd, **_engine_kw())
        eng.generate_batch([prompts[0][:64]], 2, adapter=names[0])
        m0 = eng.metrics()
        _reset_launches(port)
        reqs, dt, _ = _drive(port, eng, prompts, SERVE_NEW_TOKENS, tenants)
        counts = _launch_counts(port)
        n_launch = counts.pop("ragged")
        fused = eng.metrics()["fused_steps"] - m0["fused_steps"]
        _all_done(port, f"lora {tag}", reqs, SERVE_NEW_TOKENS)
        _no_recovery(f"lora {tag}", eng)
        _check(n_launch == fused * cfg.num_layers
               and not any(counts.values()),
               f"lora {tag}: launches {n_launch} != {fused} x "
               f"{cfg.num_layers}")
        # evicting a seated tenant is refused, typed
        r = eng.submit(prompts[1][:64], 4, adapter=names[1])
        eng.step()
        try:
            pool.evict(names[1])
            refused = False
        except s.AdapterInUse:
            refused = True
        eng.run_until_idle()
        print(f"[lora] weights {tag}: {len(reqs)} requests over "
              f"{LORA_ADAPTERS} adapters and the null adapter DONE, "
              f"{len(reqs) * SERVE_NEW_TOKENS / dt:.1f} tokens/s, {fused} "
              f"fused steps, ragged launches {n_launch}; evict of a seated "
              f"adapter raised AdapterInUse: {refused}")
        _check(refused and r.finished and pool.refcount(names[1]) == 0,
               "lora: evict of a seated adapter was not refused")
        eng.close()
        # each tenant's tokens against the same engine serving its merged
        # weights without LoRA; the null adapter's against the base model,
        # which also shows that the adapters move tokens
        bound = GAP_BOUND["bfloat16" if wd is None else "int8_weights"]
        plain = se(base, weight_dtype=wd, **_engine_kw()).generate_batch(
            prompts, SERVE_NEW_TOKENS)
        moved = sum(not np.array_equal(reqs[i].output_ids(), plain[i])
                    for i, t in enumerate(tenants) if t is not None)
        print(f"[lora] weights {tag}: {moved} of "
              f"{sum(t is not None for t in tenants)} adapter requests give "
              "other tokens than the base model")
        _check(moved >= 1, f"lora {tag}: the adapters moved no token")
        for name in names + [None]:
            idx = [i for i, t in enumerate(tenants) if t == name]
            if name is None:
                oracle, want = base, [plain[i] for i in idx]
            else:
                oracle = port["GPT"](cfg, device=DEVICE, dtype="bfloat16",
                                     seed=0)
                oracle.load_state_dict(pool.merged_state_dict(model, name))
                oeng = se(oracle, weight_dtype=wd, **_engine_kw())
                want = oeng.generate_batch([prompts[i] for i in idx],
                                           SERVE_NEW_TOKENS)
                oeng.close()
            _parity(port, f"lora weights {tag} adapter {name} vs "
                    f"{'the base model' if name is None else 'merged'}",
                    [reqs[i].output_ids() for i in idx], want, oracle,
                    bound, "bfloat16")
            if oracle is not base:
                del oracle
            torch.cuda.empty_cache()
        launches[tag] = n_launch
        if base is not model:
            del base
        torch.cuda.empty_cache()
    # fp32 with TF32 off, 2 layers at full width: each tenant's tokens
    # against the engine serving its merged weights, the null adapter's
    # against the base model
    fcfg = fp32_model.config
    fpool = s.LoRAAdapterPool(fcfg, num_adapter_pages=LORA_ADAPTERS,
                              rank=LORA_RANK, dtype="float32", stacked=True,
                              device=DEVICE)
    for i, name in enumerate(names):
        fpool.register(name, s.random_adapter(
            fcfg, LORA_RANK, np.random.RandomState(390 + i)))
    fp = _serve_prompts(np.random.RandomState(129), vocab, 10)
    ften = [names[i % 5] if i % 5 < LORA_ADAPTERS else None
            for i in range(len(fp))]
    fkw = _engine_kw(kv_dtype="float32")
    eng = se(fp32_model, lora=fpool, **fkw)
    reqs, _, _ = _drive(port, eng, fp, 16, ften)
    eng.close()
    _all_done(port, "lora fp32", reqs, 16)
    plain = se(fp32_model, **fkw).generate_batch(fp, 16)
    moved = sum(not np.array_equal(reqs[i].output_ids(), plain[i])
                for i, t in enumerate(ften) if t is not None)
    print(f"[lora] fp32 2 layers: {moved} of "
          f"{sum(t is not None for t in ften)} adapter requests give other "
          "tokens than the base model")
    _check(moved >= 1, "lora fp32: the adapters moved no token")
    for name in names + [None]:
        idx = [i for i, t in enumerate(ften) if t == name]
        if name is None:
            oracle, want = fp32_model, [plain[i] for i in idx]
        else:
            oracle = port["GPT"](fcfg, device=DEVICE, dtype="float32", seed=1)
            oracle.load_state_dict(fpool.merged_state_dict(fp32_model, name))
            want = se(oracle, **fkw).generate_batch([fp[i] for i in idx], 16)
        _parity(port, f"lora fp32 2 layers adapter {name} vs "
                f"{'the base model' if name is None else 'merged'}",
                [reqs[i].output_ids() for i in idx], want, oracle,
                GAP_BOUND["float32"], "float32")
    del fpool
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phases 30-34: AMP O1 over fp32 weights with the gradient scaler, the
# recompute policies, crash-consistent training
# ---------------------------------------------------------------------------

# per element of the fp32 form: read p, g, m1, m2 (16 B), write p, m1, m2
# (12 B)
ADAMW_FP32_BYTES = 28
ADAMW_FLAG_CASES = (("float32", (4096, 8192)), ("float32", (3, 257)),
                    ("bfloat16", (4096, 8192)), ("master", (4096, 8192)),
                    ("master", (3, 257)))


def _adamw_flag_compare(port, form, shape, seed):
    """One update of ``form`` ("float32", "bfloat16", or "master": bf16 p
    and g on fp32 master and moments) with a device flag and device beta
    powers (beta^2 of each, as after two steps): with the flag false the
    kernel writes nothing (bit for bit); with it true the kernel equals
    the kernel with the same powers as host scalars bit for bit, and the
    plain version given the same flag and pair within ``ADAMW_TOL``.
    Returns the max abs error against the plain version."""
    torch, fw = port["torch"], port["fw"]
    gen = torch.Generator(device=DEVICE).manual_seed(seed)

    def randn(scale, dt=torch.float32):
        return (torch.randn(shape, generator=gen, device=DEVICE)
                * scale).to(dt)

    low = torch.bfloat16
    dtype = "bfloat16" if form == "master" else form
    td = getattr(torch, dtype)
    if form == "master":
        master = randn(1.0)
        state = [master.to(low), randn(0.01), randn(0.001).abs(), master]
    else:
        state = [randn(1.0, td), randn(0.01, td), randn(0.001, td).abs(),
                 None]
    g = randn(0.1, td)
    b1p = np.float32(np.float32(0.9) * np.float32(0.9))
    b2p = np.float32(np.float32(0.999) * np.float32(0.999))
    pows = torch.tensor([b1p, b2p], dtype=torch.float32, device=DEVICE)
    flags = {v: torch.tensor(v, device=DEVICE) for v in (False, True)}

    def run(finite=None, plain=False):
        s = [None if t is None else t.clone() for t in state]
        kw = dict(master=s[3])
        if finite is not None:
            kw.update(finite=flags[finite], pows=pows)
        if plain:
            fw.fused_adamw_plain(s[0], g, s[1], s[2],
                                 fw.adamw_scalars(1e-3, 1.0, 1.0), **kw)
        else:
            fw.fused_adamw_update(s[0], g, s[1], s[2], 1e-3,
                                  None if finite is not None else b1p,
                                  None if finite is not None else b2p, **kw)
        return [t for t in s if t is not None]

    kept = [t for t in state if t is not None]
    off = run(False)
    dev, host, plain = run(True), run(), run(True, plain=True)
    torch.cuda.synchronize()
    _check(all(torch.equal(a, b) for a, b in zip(off, kept)),
           f"adamw flag {form} {shape}: a false flag wrote")
    _check(all(torch.equal(a, b) for a, b in zip(dev, host)),
           f"adamw flag {form} {shape}: device powers differ from host "
           "scalars")
    err = 0.0
    tols = [ADAMW_TOL[dtype]] + [ADAMW_TOL["float32" if form == "master"
                                           else dtype]] * 3
    for name, a, b, tol in zip(("p", "m1", "m2", "master"), dev, plain,
                               tols):
        e, over = _over(a, b, tol)
        _check(over <= 0, f"adamw flag {form} {shape} {name}: kernel vs "
               f"plain off by {e}")
        err = max(err, e)
    print(f"[adamw_flag] {form} {list(shape)}: flag false writes nothing "
          f"(bit for bit); flag true with device powers == host scalars "
          f"bit for bit; vs plain max_abs_err={err!r}")
    return err


def _time_adamw_fp32(port):
    """Device ms of one fp32-form update over every tensor of GPT-3 1.3B
    in fp32 (16 launches): the kernel with host scalars, with a device
    flag and powers, the plain version, and torch.optim.AdamW(fused=True)
    with ``found_inf`` (the one PyTorch call for the same function); the
    bytes bound."""
    torch, fw = port["torch"], port["fw"]
    model = port["GPT"](port["gpt_1p3b"](max_position_embeddings=1024),
                        device=DEVICE, dtype="float32", seed=3)
    params = [p.detach() for p in model.parameters()]
    grads = [torch.randn_like(p) * 0.01 for p in params]
    m1 = [torch.zeros_like(p) for p in params]
    m2 = [torch.zeros_like(p) for p in params]
    flag = torch.tensor(True, device=DEVICE)
    pows = torch.tensor([0.9, 0.999], dtype=torch.float32, device=DEVICE)

    def kernel(i, **kw):
        for p, g, a, b in zip(params, grads, m1, m2):
            fw.fused_adamw_update(p, g, a, b, 1e-4, 0.9, 0.999, **kw)

    def plain(i):
        sc = fw.adamw_scalars(1e-4, 0.9, 0.999)
        for p, g, a, b in zip(params, grads, m1, m2):
            fw.fused_adamw_plain(p, g, a, b, sc)

    t = {"ms": _time_ms(torch, kernel, 10)[0],
         "flag_ms": _time_ms(torch, lambda i: kernel(i, finite=flag,
                                                     pows=pows), 10)[0],
         "plain_ms": _time_ms(torch, plain, 2, hold=False)[0]}
    del m1, m2
    lib_params = [torch.nn.Parameter(p) for p in params]
    for p, g in zip(lib_params, grads):
        p.grad = g
    lib = torch.optim.AdamW(lib_params, lr=1e-4, weight_decay=0.01,
                            fused=True)
    lib.found_inf = torch.zeros((), device=DEVICE)
    t["library_ms"] = _time_ms(torch, lambda i: lib.step(), 10,
                               hold=False)[0]
    n = sum(p.numel() for p in params)
    t_bytes = ADAMW_FP32_BYTES * n / HBM_BYTES_PER_S
    t_ops = 14.0 * n / PEAK_FLOPS["float32"]
    t["bound_ms"] = 1e3 * max(t_bytes, t_ops)
    t["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    t["tensors"], t["elements"] = len(params), n
    del model, lib, lib_params, grads, params
    return t


def phase_adamw_flag(port):
    torch = port["torch"]
    errs = {}
    for i, (form, shape) in enumerate(ADAMW_FLAG_CASES):
        errs[form] = max(errs.get(form, 0.0),
                         _adamw_flag_compare(port, form, shape, 300 + i))
    torch.cuda.empty_cache()
    t = _time_adamw_fp32(port)
    torch.cuda.empty_cache()
    print(f"[adamw_flag] fp32 form over GPT-3 1.3B ({t['tensors']} fp32 "
          f"tensors, {t['elements']} elements), device ms per update: "
          f"kernel {t['ms']!r}, with the device flag and powers "
          f"{t['flag_ms']!r} (flag cost {t['flag_ms'] - t['ms']!r}), plain "
          f"{t['plain_ms']!r}, torch.optim.AdamW(fused=True) with found_inf "
          f"{t['library_ms']!r}, bound {t['bound_ms']!r} ({t['bound_by']}, "
          f"{ADAMW_FP32_BYTES} B/element; share of it "
          f"{t['bound_ms'] / t['ms']!r})")
    # the row's error is the fp32 form's; the other forms' flag checks
    # ride beside it
    return dict(max_abs_err=errs["float32"], ms=t["ms"],
                plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                bound_by=t["bound_by"], library_ms=t["library_ms"],
                flag_ms=t["flag_ms"], flag_false_writes_nothing=True,
                flag_max_abs_err_by_form=errs)


# -- phase 31: O1 training over fp32 weights ---------------------------------

O1_INIT_SCALE = 2.0 ** 15
# the scale of the forced-overflow step, as the reference's tests force
# one; if it does not overflow this model's gradients, a hook makes the
# word embedding's gradient non-finite for one step instead
O1_FORCED_SCALE = 3e38


def o1_train_setup(port, policy=None, num_layers=None, seed=0):
    """GPT-3 1.3B (``num_layers`` cuts the depth) with random fp32
    weights from ``seed``, dropout 0, recompute every block under
    ``policy``; ``AdamW(1e-4)`` with fp32 moments, an enabled dynamic
    ``GradScaler`` and ``FusedTrainStep(scaler=, amp_level="O1")`` in
    bf16.  Returns ``(model, optimizer, scaler, step)``."""
    kw = {} if num_layers is None else dict(num_layers=num_layers)
    cfg = port["gpt_1p3b"](hidden_dropout=0.0, attention_dropout=0.0,
                           max_position_embeddings=1024,
                           recompute_interval=1, recompute_policy=policy,
                           use_flash_attention=True, **kw)
    model = port["GPT"](cfg, device=DEVICE, dtype="float32", seed=seed)
    opt = port["AdamW"](1e-4, parameters=model.parameters(),
                        weight_decay=0.01)
    scaler = port["amp"].GradScaler(enable=True,
                                    init_loss_scaling=O1_INIT_SCALE,
                                    device=DEVICE)
    step = port["FusedTrainStep"](
        lambda ids, labels: model(ids, labels=labels), opt, scaler=scaler,
        amp_level="O1", amp_dtype="bfloat16")
    return model, opt, scaler, step


def o1_host_batches(vocab, n, seed=31, batch=None):
    """``n`` (ids, labels) numpy batches of ``batch`` (default
    ``TRAIN_BATCH``) x ``TRAIN_SEQ``."""
    batch = batch or TRAIN_BATCH
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, vocab, (batch, TRAIN_SEQ)),
             rng.randint(0, vocab, (batch, TRAIN_SEQ))) for _ in range(n)]


def _state_checksum(torch, tensors):
    """One int64 over the bits of every tensor (fp32 viewed as int32),
    computed on the cards, summed on the first tensor's."""
    dev = tensors[0].device
    return torch.stack([t.detach().view(torch.int32).sum(
        dtype=torch.int64).to(dev) for t in tensors]).sum()


def _o1_forced_overflow(port, model, opt, scaler, step, batches):
    """The no-sync skip: one step under ``set_sync_debug_mode("error")``
    (any host sync inside the step raises) at scale 3e38 -- or, where that
    scale does not overflow this model's gradients, with a hook making the
    word embedding's gradient non-finite -- then the checks on the card:
    not applied, a sample of parameters ``torch.equal`` and a checksum of
    every parameter and moment unchanged, the beta powers unchanged, the
    scale halved; then two finite steps apply.  Returns what it saw."""
    torch = port["torch"]
    params = list(model.parameters())
    sample = [model.embeddings.word_embeddings.weight,
              model.decoder.qkv_w, model.final_ln.weight]
    every = params + [opt.state[p][k] for p in params
                      for k in ("moment1", "moment2")]

    def guarded(batch):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            step(*batch)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    out = {}
    for how in ("scale 3e38", "hook"):
        snap = [t.detach().clone() for t in sample]
        pows, scale = opt._pows.clone(), scaler._scale.clone()
        checksum = _state_checksum(torch, every)
        hook = None
        if how == "scale 3e38":
            scaler._scale.fill_(O1_FORCED_SCALE)
            scale = scaler._scale.clone()
        else:
            hook = model.embeddings.word_embeddings.weight.register_hook(
                lambda g: g * float("inf"))
        guarded(next(batches))
        if hook is not None:
            hook.remove()
        applied = step.last_step_applied
        out[how] = applied
        print(f"[train_o1] forced overflow by {how}: step applied "
              f"{applied} (no host sync inside the step: "
              f"set_sync_debug_mode('error') raised nothing)")
        if not applied:
            _check(all(torch.equal(a, b.detach())
                       for a, b in zip(snap, sample))
                   and bool(_state_checksum(torch, every) == checksum)
                   and torch.equal(opt._pows, pows)
                   and bool(scaler._scale == scale * 0.5),
                   f"train_o1: the skipped step ({how}) changed state, or "
                   "the scale did not halve")
            out["skipped_by"] = how
            break
        scaler._scale.fill_(O1_INIT_SCALE)
    _check("skipped_by" in out, "train_o1: no step was skipped")
    out["scale_after"] = float(scaler._scale)
    scaler._scale.fill_(O1_INIT_SCALE)
    checksum = _state_checksum(torch, every)
    applied = []
    for _ in range(2):
        step(*next(batches))
        applied.append(step.last_step_applied)
    _check(all(applied) and not bool(_state_checksum(torch, every)
                                     == checksum),
           f"train_o1: the finite steps after the skip did not apply "
           f"({applied})")
    return out


def phase_train_o1(port, o2):
    """GPT-3 1.3B, fp32 weights, O1 bf16 with an enabled dynamic scaler,
    AdamW, ``FusedTrainStep(scaler=)``, batch 8 x 1024, recompute every
    block, batches through ``DevicePrefetcher``: launches and finite
    losses, step time, tokens/s, MFU and peak memory beside phase 6's O2
    numbers (``o2``), then the forced overflow."""
    torch = port["torch"]
    t0 = time.perf_counter()
    model, opt, scaler, step = o1_train_setup(port)
    cfg = model.config
    n_tensors = len(list(model.parameters()))
    n_batches = TRAIN_WARMUP + TRAIN_STEPS + 6
    pf = port["DevicePrefetcher"](
        iter(o1_host_batches(cfg.vocab_size, n_batches)), depth=2,
        device=DEVICE)
    warm = [float(step(*next(pf))) for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    print(f"[train_o1] gpt_1p3b fp32 weights set-up and {TRAIN_WARMUP} "
          f"warm-up steps {time.perf_counter() - t0:.2f} s, losses {warm}")
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(port)
    t1 = time.perf_counter()
    losses = [step(*next(pf)) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = _launch_counts(port)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    _check(all(np.isfinite(losses)), f"non-finite O1 losses {losses}")
    L = cfg.num_layers
    want = {"fwd": 2 * L, "dkv": L, "dq": L, "adamw": n_tensors}
    _check(all(launches[k] == want[k] * TRAIN_STEPS for k in want),
           f"O1 launches over {TRAIN_STEPS} steps {launches}, expected per "
           f"step {want}")
    step_s = wall / TRAIN_STEPS
    tokens = TRAIN_BATCH * TRAIN_SEQ
    mfu = gpt_train_mfu(cfg, step_s)
    st = pf.stats()
    print(f"[train_o1] {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ}, "
          f"fp32 weights, O1 bf16, dynamic scaler: losses {losses}; mean "
          f"step {1e3 * step_s:.2f} ms (host clock), {tokens / step_s:.1f} "
          f"tokens/s, MFU {mfu:.4f}; launches per step "
          f"{ {k: v // TRAIN_STEPS for k, v in launches.items()} }; peak "
          f"device memory {peak / 2**30:.2f} GiB; prefetcher: "
          f"{st['batches']} batches, input stall "
          f"{st['stall_seconds_total']:.4f} s in all | phase 6 (bf16 weights, O2 + O1 step, no scaler), same "
          f"run: mean step {1e3 * o2['step_s']:.2f} ms, "
          f"{tokens / o2['step_s']:.1f} tokens/s, MFU {o2['mfu']:.4f}, peak "
          f"{o2['peak'] / 2**30:.2f} GiB")
    forced = _o1_forced_overflow(port, model, opt, scaler, step, pf)
    pf.close()
    del model, opt, scaler, step, pf
    torch.cuda.empty_cache()
    return launches, dict(step_s=step_s, mfu=mfu, peak=peak, **forced)


# -- phase 32: O1 card vs CPU ------------------------------------------------

# gpt_tiny(hidden 128) under O1 bf16 over fp32 weights, three steps: bf16
# products and attention rounded at other points on each side (the flash
# kernel's tiles against the plain version's rows, cuBLAS against the
# CPU's sums), each a bf16 ulp (2^-8 relative) of an activation, carried
# through 2 blocks and the loss head of ~6.9
O1_CARD_CPU_ATOL = 5e-3


def phase_o1_card_vs_cpu(port):
    torch = port["torch"]
    cfg = port["gpt_tiny"](hidden_size=128, num_heads=2, hidden_dropout=0.0,
                           attention_dropout=0.0, recompute_interval=1)
    rng = np.random.RandomState(32)
    batch = [rng.randint(0, cfg.vocab_size, (2, 128)) for _ in range(2)]
    cpu = port["GPT"](cfg, device="cpu", dtype="float32", seed=5)
    card = port["GPT"](cfg, device=DEVICE, dtype="float32", seed=5)
    card.load_state_dict(cpu.state_dict())
    _reset_launches(port)
    out = []
    for m in (cpu, card):
        opt = port["AdamW"](1e-4, parameters=m.parameters())
        scaler = port["amp"].GradScaler(init_loss_scaling=O1_INIT_SCALE,
                                        device=m.device)
        step = port["FusedTrainStep"](
            lambda ids, labels, m=m: m(ids, labels=labels), opt,
            scaler=scaler, amp_level="O1")
        dev_batch = [torch.from_numpy(x).to(m.device) for x in batch]
        out.append([float(step(*dev_batch)) for _ in range(3)])
    launches = _launch_counts(port)
    diff = max(abs(a - b) for a, b in zip(*out))
    print(f"[o1_card_vs_cpu] gpt_tiny fp32 weights, O1 bf16, scaler: losses "
          f"cpu {out[0]} card {out[1]}: max diff {diff!r} (tol "
          f"{O1_CARD_CPU_ATOL}); card launches {launches}")
    _check(diff <= O1_CARD_CPU_ATOL, "card and CPU O1 losses differ")
    _check(launches["fwd"] > 0 and launches["dq"] > 0
           and launches["adamw"] > 0,
           "the card's O1 steps did not launch the flash and AdamW kernels")


# -- phase 33: recompute policies --------------------------------------------

POLICY_STEPS = 4


def phase_recompute_policies(port):
    """GPT-3 1.3B O1 (phase 31's set-up), four steps each under
    recompute_policy "full" and "dots" from the same weights and batches:
    losses bit for bit, the same flash forward launches (the recompute
    reruns them under both); the mean step time of steps 2-4, the peak
    memory, and the memory a forward holds for its backward (allocated
    after one more O1 forward, before its backward) of each."""
    torch = port["torch"]
    vocab = port["gpt_1p3b"]().vocab_size
    batches = [tuple(torch.from_numpy(a).to(DEVICE) for a in b)
               for b in o1_host_batches(vocab, POLICY_STEPS, seed=33)]
    runs = {}
    for policy in ("full", "dots"):
        model, opt, scaler, step = o1_train_setup(port, policy)
        layers = model.config.num_layers
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches(port)
        times, losses = [], []
        for b in batches:
            t0 = time.perf_counter()
            losses.append(step(*b))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        launches = _launch_counts(port)
        peak = torch.cuda.max_memory_allocated()
        base = torch.cuda.memory_allocated()
        with port["amp"].auto_cast(level="O1"):
            loss = model(*batches[0][:1], labels=batches[0][1])
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - base
        loss.backward()
        opt.zero_grad(set_to_none=True)
        runs[policy] = dict(losses=torch.stack(losses), launches=launches,
                            peak=peak, held=held,
                            step_s=float(np.mean(times[1:])))
        del model, opt, scaler, step, loss
        torch.cuda.empty_cache()
    for policy, r in runs.items():
        print(f"[recompute] {policy}: losses {r['losses'].tolist()}; mean "
              f"step (steps 2-{POLICY_STEPS}) {1e3 * r['step_s']:.2f} ms; "
              f"peak device memory {r['peak'] / 2**30:.2f} GiB; held by a "
              f"forward for its backward {r['held'] / 2**30:.2f} GiB; flash "
              f"forward launches {r['launches']['fwd']}")
    full, dots = runs["full"], runs["dots"]
    _check(torch.equal(full["losses"], dots["losses"]),
           "recompute policies full and dots give different losses")
    _check(full["launches"]["fwd"] == dots["launches"]["fwd"]
           == 2 * layers * POLICY_STEPS,
           f"flash forward launches full {full['launches']['fwd']}, dots "
           f"{dots['launches']['fwd']}")
    return runs


# -- phase 34: crash-consistent resume --------------------------------------

RESUME_LAYERS, RESUME_BATCH = 2, 2


def phase_resume(port):
    """GPT-3 1.3B's width at 2 layers, fp32 weights, O1 bf16 with a
    scaler: six steps straight, against three steps, an asynchronous save,
    three more steps while the writer runs, and a restore into a model
    from another seed that trains the last three: losses and parameters
    bit for bit.  Then a SIGTERM to this process under
    ``PreemptionHandler``: the next step boundary saves and raises
    ``GracefulExit``, and that checkpoint is the newest."""
    import os
    import shutil
    import signal

    torch = port["torch"]
    ck = port["checkpoint"]
    directory = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "chip_smoke_ckpt")
    shutil.rmtree(directory, ignore_errors=True)
    vocab = port["gpt_1p3b"]().vocab_size
    batches = [tuple(torch.from_numpy(a).to(DEVICE) for a in b)
               for b in o1_host_batches(vocab, 7, seed=34,
                                        batch=RESUME_BATCH)]

    def build(seed):
        return o1_train_setup(port, num_layers=RESUME_LAYERS, seed=seed)

    a_model, _, _, a_step = build(0)
    ref = torch.stack([a_step(*b) for b in batches[:6]])
    b_model, b_opt, b_scaler, b_step = build(0)
    pre = [b_step(*b) for b in batches[:3]]
    mgr = ck.CheckpointManager(directory, keep_last_k=2, async_save=True)
    t0 = time.perf_counter()
    mgr.save(ck.TrainState(b_model, b_opt, b_scaler).capture(
        position={"step": 3}), step=3)
    save_s = time.perf_counter() - t0
    writer_busy = mgr._inflight is not None and mgr._inflight.is_alive()
    times, post_b = [], []
    for b in batches[3:6]:
        t1 = time.perf_counter()
        post_b.append(b_step(*b))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    mgr.wait()
    write_s = time.perf_counter() - t0
    del b_model, b_opt, b_scaler, b_step
    info = mgr.latest()
    size = info.manifest["files"]["state.pkl"]["size"]
    c_model, c_opt, c_scaler, c_step = build(1)
    t2 = time.perf_counter()
    tree, _ = mgr.restore()
    pos = ck.TrainState(c_model, c_opt, c_scaler).restore(tree)
    restore_s = time.perf_counter() - t2
    del tree
    post = torch.stack([c_step(*b) for b in batches[3:6]])
    same = (torch.equal(torch.stack(pre), ref[:3])
            and torch.equal(torch.stack(post_b), ref[3:])
            and torch.equal(post, ref[3:])
            and all(torch.equal(x, y) for x, y in
                    zip(a_model.parameters(), c_model.parameters())))
    print(f"[resume] gpt_1p3b width, {RESUME_LAYERS} layers, fp32 weights, "
          f"O1 + scaler, {RESUME_BATCH} x {TRAIN_SEQ}: train 6 "
          f"{ref.tolist()}; "
          f"train 3 + async save + restore (position {pos}) into seed 1 + "
          f"train 3: {post.tolist()}; bit for bit (losses and parameters): "
          f"{same}; checkpoint {size} bytes; save() returned in "
          f"{save_s:.3f} s (host snapshot), writer busy after it: "
          f"{writer_busy}; steps while the writer ran "
          f"{[round(1e3 * t, 2) for t in times]} ms; write committed "
          f"{write_s:.2f} s after save(); restore {restore_s:.2f} s")
    _check(same, "train 3 + save + restore + train 3 is not train 6 bit "
           "for bit")
    state = ck.TrainState(c_model, c_opt, c_scaler)
    raised = False
    with ck.PreemptionHandler() as handler:
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.time() + 5
        while not handler.requested and time.time() < deadline:
            time.sleep(0.01)
        c_step(*batches[6])
        try:
            handler.checkpoint_and_exit_if_requested(mgr, state, step=7)
        except ck.GracefulExit as e:
            raised = e.code == 0
    newest = mgr.latest()
    print(f"[resume] SIGTERM: requested {handler.requested}, GracefulExit "
          f"raised {raised}, newest checkpoint step {newest.step} "
          f"(preempted {newest.manifest['meta'].get('preempted')})")
    _check(raised and newest.step == 7
           and newest.manifest["meta"].get("preempted") is True,
           "preemption did not save the newest checkpoint and exit")
    shutil.rmtree(directory, ignore_errors=True)
    del a_model, c_model, c_opt, c_scaler, c_step, state
    torch.cuda.empty_cache()
    return dict(save_s=save_s, write_s=write_s, bytes=size,
                step_ms_while_writing=[1e3 * t for t in times])


# ---------------------------------------------------------------------------
# phases 35-40: the layered GPT (GPTForPretraining) and the Predictor
# ---------------------------------------------------------------------------

# the stacked decoder's slab of each layered parameter (layer_{i}.<key>)
STACKED_OF_LAYERED = {
    "ln1_g": "ln1.weight", "ln1_b": "ln1.bias",
    "qkv_w": "attn.qkv_proj.weight", "qkv_b": "attn.qkv_proj.bias",
    "proj_w": "attn.out_proj.weight", "proj_b": "attn.out_proj.bias",
    "ln2_g": "ln2.weight", "ln2_b": "ln2.bias",
    "fc1_w": "mlp.fc1.weight", "fc1_b": "mlp.fc1.bias",
    "fc2_w": "mlp.fc2.weight", "fc2_b": "mlp.fc2.bias"}
# phase 39 at 2 layers of GPT-3 1.3B's width, checked against the CPU:
# the requests, their prompt tokens and the new tokens each CPU run
# serves (a cut of phase 3's traffic, so the CPU halves take seconds)
LAYERED_CPU_REQUESTS, LAYERED_CPU_PROMPT, LAYERED_CPU_NEW = 4, 48, 8
# its engines' context: one page holds a request (two with the prefix
# head); the CPU's plain ragged attention gathers every page of a
# token's table, so the pool's pages set the CPU half's time
LAYERED_CPU_CONTEXT = 128
# phase 40: bf16 on the card against fp32 on the CPU, from the same bf16
# weights.  bf16 keeps 8 bits: each rounded activation, product output
# and attention probability carries up to 2^-9 relative error, of both
# signs, summed over thousands of terms; two layers and the head move the
# mean loss by ~1e-3 relative and a parameter's gradient, which also
# passes the bf16 rounding of dP/dS in the flash backward and of every
# product output, by ~1e-2 of its norm.  Held at ~10x and ~6x:
# |loss_card - loss_cpu| <= TRAIN_LOSS_REL |loss_cpu|, and for every
# parameter ||g_card - g_cpu|| <= TRAIN_GRAD_NORM ||g_cpu||
TRAIN_LOSS_REL, TRAIN_GRAD_NORM = 2.0 ** -7, 2.0 ** -4
LAYERED_TRAIN_CPU_BATCH = 1


def stacked_twin(port, layered):
    """A stacked GPT carrying ``layered``'s weights, on its device and in
    its dtype: each decoder slab is its layers' tensors stacked on the
    layer axis; the embeddings and the final LayerNorm are copied."""
    torch = port["torch"]
    cfg = layered.config
    twin = port["GPT"](cfg, device=layered.device, dtype=layered.dtype)
    sd = layered.state_dict()
    with torch.no_grad():
        for slab, key in STACKED_OF_LAYERED.items():
            getattr(twin.decoder, slab).copy_(torch.stack(
                [sd[f"gpt.layer_{i}.{key}"] for i in range(cfg.num_layers)]))
        for name, p in twin.named_parameters():
            if not name.startswith("decoder."):
                p.copy_(sd["gpt." + name])
    twin.eval()
    return twin


def _layered(port, cfg, dtype, seed, device=None):
    m = port["Layered"](cfg, device=device or DEVICE, dtype=dtype, seed=seed)
    m.eval()
    return m


def phase_layered_generate(port, stacked_gen):
    """Phase 35; ``stacked_gen``: phase 9's numbers, printed beside."""
    torch = port["torch"]
    t0 = time.perf_counter()
    model, ids = generate_setup(port, "Layered")
    cfg = model.config
    t1 = time.perf_counter()
    model.generate(ids, 1, **GEN_KW)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t1
    print(f"[layered_generate] gpt_1p3b layered bf16 set-up and warm-up "
          f"{t1 - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(port)
    t1 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, logits = model.generate(ids, GEN_NEW, return_logits=True,
                                     **GEN_KW)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = _launch_counts(port)
    peak = torch.cuda.max_memory_allocated()
    L = cfg.num_layers
    _check(tuple(out.shape) == (GEN_BATCH, GEN_PROMPT + GEN_NEW)
           and bool(torch.isfinite(logits).all()),
           "layered generate: output shape / logits not finite")
    _check(launches["fwd"] == L and launches["decode"] == L * (GEN_NEW - 1)
           and launches["paged"] == 0 and launches["ragged"] == 0,
           f"layered generate launches {launches}, expected flash forward "
           f"{L} and decode {L * (GEN_NEW - 1)}")
    decode_ms = 1e3 * (wall - prefill_s) / (GEN_NEW - 1)
    print(f"[layered_generate] batch {GEN_BATCH} prompt {GEN_PROMPT} + "
          f"{GEN_NEW} new tokens (greedy, return_logits, no host sync): "
          f"{1e3 * wall:.2f} ms, prefill {1e3 * prefill_s:.2f} ms, mean "
          f"decode {decode_ms:.3f} ms per token (host clock), "
          f"{GEN_BATCH * GEN_NEW / wall:.1f} tokens/s (stacked, phase 9: "
          f"{stacked_gen['tps']:.1f} tokens/s, prefill "
          f"{stacked_gen['prefill_ms']:.2f} ms, decode "
          f"{stacked_gen['decode_ms']:.3f} ms); launches {launches}; peak "
          f"device memory {peak / 2**30:.2f} GiB")
    # the stacked model carrying the same weights: bf16 at full depth
    # under the parity rule
    twin = stacked_twin(port, model)
    want = twin.generate(ids, GEN_NEW, **GEN_KW)
    rel = None
    with torch.no_grad():
        cache = twin.new_kv_cache(GEN_BATCH, GEN_MAX_SEQ)
        tl = twin._cached_lm_logits(out[:, :GEN_PROMPT], cache, 0)[:, -1]
        rel = ((logits[:, 0] - tl.float()).norm() / tl.float().norm()).item()
    print(f"[layered_generate] bf16 prefill logits, layered vs stacked "
          f"twin: relative norm {rel:.4g}")
    _parity(port, "layered generate bf16 vs the stacked twin",
            list(out.cpu().numpy()), list(want.cpu().numpy()), model,
            GAP_BOUND["bfloat16"], "bfloat16")
    del twin, cache
    model.clear_decode_cache()
    torch.cuda.empty_cache()
    # fp32 with TF32 off at 2 layers of full width: tokens equal exactly
    small = _layered(port, port["gpt_1p3b"](num_layers=2), "float32", 1)
    stwin = stacked_twin(port, small)
    kw = dict(max_seq_len=GEN_MAX_SEQ, cache_dtype="float32")
    got = small.generate(ids, GEN_NEW, **kw).cpu().numpy()
    want = stwin.generate(ids, GEN_NEW, **kw).cpu().numpy()
    same = np.array_equal(got, want)
    print(f"[layered_generate] fp32 2 layers: greedy tokens equal to the "
          f"stacked twin's: {same}")
    _check(same, "layered fp32 generate differs from the stacked twin")
    del small, stwin
    torch.cuda.empty_cache()
    return model, ids, out, logits, launches


def phase_layered_serve(port, model, ids, out, logits):
    """Phase 36: phase 3's engine and traffic over ``model`` (phase 35's)
    and over its stacked twin, in turns (layered, stacked, stacked,
    layered: the host-bound step is noisy, and the first run of a process
    pays for allocator growth); then phase 10's paged step without a plan
    against phase 35's logits.  Each run is a fresh engine (phase 3's,
    warmed up by one request).  Returns the layered model's ragged
    launches (first run), the paged launches and every run's numbers."""
    torch = port["torch"]
    models = {"layered": model, "stacked": stacked_twin(port, model)}
    runs = {"layered": [], "stacked": []}
    for name in ("layered", "stacked", "stacked", "layered"):
        e, r = serve_engine(port, model=models[name])
        fused0 = e.metrics()["fused_steps"]
        _reset_launches(port)
        per_step = []
        reqs, step_s, dt = serve_workload(port, e, r, per_step)
        counts = _launch_counts(port)
        m = e.metrics()
        fused = m["fused_steps"] - fused0
        tokens = sum(len(q.tokens) for q in reqs)
        slo = m["slo"]
        runs[name].append(dict(reqs=reqs, launches=counts["ragged"],
                               tps=tokens / dt))
        print(f"[layered_serve] {name} run {len(runs[name])}: "
              f"{len(reqs)} requests DONE, {tokens} tokens in {dt:.3f} s: "
              f"{tokens / dt:.1f} tokens/s; {fused} fused steps, mean step "
              f"{1e3 * float(np.mean(step_s)):.2f} ms (host clock); ttft "
              f"p50 {1e3 * slo['ttft']['p50']:.1f} p99 "
              f"{1e3 * slo['ttft']['p99']:.1f} ms, itl p50 "
              f"{1e3 * slo['itl']['p50']:.2f} p99 "
              f"{1e3 * slo['itl']['p99']:.2f} ms; ragged launches "
              f"{counts['ragged']}")
        _check(fused == len(per_step) and set(per_step) == {SERVE_LAYERS}
               and counts["ragged"] == fused * SERVE_LAYERS
               and not any(v for k, v in counts.items() if k != "ragged"),
               f"layered serve {name}: launches per step "
               f"{sorted(set(per_step))}, other kernels {counts}")
        e.close()
    for i in range(2):
        _parity(port, f"layered serve bf16 vs the stacked twin, run {i + 1}",
                [q.output_ids() for q in runs["layered"][i]["reqs"]],
                [q.output_ids() for q in runs["stacked"][i]["reqs"]], model,
                GAP_BOUND["bfloat16"], "bfloat16")
    del models
    torch.cuda.empty_cache()
    paged = phase_paged(port, model, ids, out, logits)
    return runs["layered"][0]["launches"], paged, runs


def phase_layered_int8(port, model, ids, out, logits):
    """Phase 38: phase 14's int8 paged step on ``model`` (phase 35's,
    quantized here by ``quantize_for_serving``: ``Int8Linear``), phase
    36's serve from an int8 pool over it, and the layered int8 engine and
    paged path card vs CPU at gpt_tiny(hidden 128, 2 heads) (phase 15's
    check)."""
    torch = port["torch"]
    port["qi8"].quantize_for_serving(model)
    _check(model.weight_int8 and isinstance(model.gpt.layer_0.mlp.fc1,
                                            port["Int8Linear"]),
           "layered int8: quantize_for_serving left a Linear")
    paged = phase_paged_int8(port, model, ids, out, logits)
    eng, rng = serve_engine(port, "int8", "int8", model=model)
    fused0 = eng.metrics()["fused_steps"]
    _reset_launches(port)
    per_step = []
    reqs, step_s, dt = serve_workload(port, eng, rng, per_step)
    counts = _launch_counts(port)
    fused = eng.metrics()["fused_steps"] - fused0
    scales = list(eng.cache.k_scale) + list(eng.cache.v_scale)
    tokens = sum(len(r.tokens) for r in reqs)
    print(f"[layered_int8] serve, int8 pool and Int8Linear weights: "
          f"{tokens} tokens in {dt:.3f} s: {tokens / dt:.1f} tokens/s; "
          f"{fused} fused steps, mean step "
          f"{1e3 * float(np.mean(step_s)):.2f} ms (host clock); int8 "
          f"ragged launches {counts['ragged']}; {len(scales)} per-layer "
          f"scale tensors")
    _check(set(per_step) == {SERVE_LAYERS} and fused == len(per_step)
           and not any(v for k, v in counts.items() if k != "ragged")
           and all(bool(torch.isfinite(t).all()) for t in scales),
           f"layered int8 serve: launches per step {sorted(set(per_step))}"
           f", other kernels {counts}, or non-finite scales")
    ragged = counts["ragged"]
    eng.close()
    del eng
    torch.cuda.empty_cache()
    # card vs CPU: the layered int8 engine and paged path on both
    cfg = port["gpt_tiny"](hidden_size=128, num_heads=2)
    card, cpu = _pair(port, cfg, 6)
    prompts = [np.random.RandomState(6).randint(0, cfg.vocab_size, (s,))
               for s in (4, 17, 7, 21, 11, 5)]
    kw = dict(num_slots=2, page_size=16, max_context=64, kv_dtype="int8",
              weight_dtype="int8", prefill_token_budget=6)
    _reset_launches(port)
    outs, pg = [], []
    for m in (cpu, card):
        outs.append(port["ServingEngine"](m, **kw).generate_batch(prompts, 8))
        tid = torch.from_numpy(np.stack([p[:4] for p in prompts[:2]]))
        pg.append(_paged_greedy(port, m, tid.to(m.device), 8, "int8"))
    launches = _launch_counts(port)
    same = all(np.array_equal(a, b) for a, b in zip(*outs))
    print(f"[layered_int8] gpt_tiny(128, 2 heads) fp32, int8 KV and "
          f"weights: engine tokens card == CPU {same}, paged path "
          f"{np.array_equal(*pg)}; card launches {launches}")
    _check(same and np.array_equal(*pg) and launches["ragged"] > 0
           and launches["paged"] > 0,
           "layered int8: card and CPU tokens differ or no kernel launched")
    return ragged, paged


def _pair(port, cfg, seed):
    """A layered model of ``cfg`` in fp32 on the card and its copy on the
    CPU."""
    card = _layered(port, cfg, "float32", seed)
    cpu = _layered(port, cfg, "float32", seed, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    return card, cpu


def _card_vs_cpu(port, name, models, build, prompts, adapters=None,
                 check=None):
    """Serve ``prompts`` through ``build(model)`` for the card and the CPU
    model of ``models``: the request states must agree and the tokens
    follow the parity rule (fp32 bound); ``check(card_engine,
    cpu_engine)`` holds anything else.  Returns the card's ragged
    launches."""
    card = models[0]
    runs = []
    for m in models:
        eng = build(m)
        _reset_launches(port)
        reqs, dt, _ = _drive(port, eng, prompts, LAYERED_CPU_NEW, adapters)
        runs.append((eng, reqs, dt, _launch_counts(port)))
    (ce, creqs, cdt, counts), (pe, preqs, pdt, _) = runs
    if check is not None:
        check(ce, pe)
    _check([r.state for r in creqs] == [r.state for r in preqs],
           f"layered {name}: card and CPU request states differ")
    done = [i for i, r in enumerate(preqs) if r.finished]
    _parity(port, f"layered {name} fp32 2 layers, card vs CPU",
            [creqs[i].output_ids() for i in done],
            [preqs[i].output_ids() for i in done], card,
            GAP_BOUND["float32"], "float32")
    print(f"[layered_paths] {name}: {len(done)} of {len(preqs)} requests "
          f"DONE; card {cdt:.2f} s, CPU {pdt:.2f} s; card launches {counts}")
    _check(counts["ragged"] > 0, f"layered {name}: no ragged launch")
    for e in (ce, pe):
        e.close()
    return counts["ragged"]


def phase_layered_paths(port):
    """Phase 39: LoRA, the truncated draft, the prefix cache and the
    watchdog's rebuild over the layered model at 2 layers of full width
    in fp32, each card against the CPU; returns the card's ragged launches
    by path."""
    torch = port["torch"]
    s, se = port["serving"], port["ServingEngine"]
    cfg = port["gpt_1p3b"](num_layers=2)
    models = _pair(port, cfg, 38)
    vocab = cfg.vocab_size
    prompts = [p[:LAYERED_CPU_PROMPT] for p in _serve_prompts(
        np.random.RandomState(38), vocab, LAYERED_CPU_REQUESTS)]
    kw = _engine_kw(kv_dtype="float32", max_context=LAYERED_CPU_CONTEXT)
    launches = {}
    # LoRA over the layered slabs (the default layout: page axis first)
    pools = {}
    for m in models:
        pool = s.LoRAAdapterPool(cfg, num_adapter_pages=2, rank=LORA_RANK,
                                 device=m.device)
        _check(not pool.stacked, "the LoRA pool's default layout")
        for i, n in enumerate(("a", "b")):
            pool.register(n, s.random_adapter(cfg, LORA_RANK,
                                              np.random.RandomState(380 + i)))
        pools[id(m)] = pool
    launches["lora"] = _card_vs_cpu(
        port, "lora", models, lambda m: se(m, lora=pools[id(m)], **kw),
        prompts, adapters=["a", None, "b", "a"])
    # the truncated draft (gpt.layer_0, by key)
    launches["speculative"] = _card_vs_cpu(
        port, "speculative", models,
        lambda m: port["SpeculativeEngine"](
            m, port["truncated_draft"](m, 1), spec_k=SPEC_K, **kw),
        prompts)

    # the prefix cache: a 128-token head (one page) shared by every request
    head = np.random.RandomState(381).randint(0, vocab, (128,))

    def prefix_engine(m):
        eng = se(m, prefix_cache=True,
                 **dict(kw, max_context=2 * LAYERED_CPU_CONTEXT))
        eng.generate_batch([head], 2)            # registers the head's pages
        return eng

    def prefix_check(ce, pe):
        keys = ("prefix_hits", "prefix_cached_tokens", "shared_pages")
        cm, pm = ce.metrics(), pe.metrics()
        _check({k: cm[k] for k in keys} == {k: pm[k] for k in keys}
               and cm["prefix_cached_tokens"] > 0,
               f"layered prefix cache: card {[cm[k] for k in keys]}, CPU "
               f"{[pm[k] for k in keys]}")

    launches["prefix_cache"] = _card_vs_cpu(
        port, "prefix_cache", models, prefix_engine,
        [np.concatenate([head, p[:16]]) for p in prompts],
        check=prefix_check)

    # the watchdog: a persistent non-intact exception (a recovery and a
    # rebuild of the per-layer pool) and a NaN on slot 0
    def faulted(m):
        # 2 slots: the seated pair fails, the rest are served after the
        # rebuild
        eng = se(m, **dict(kw, num_slots=2))
        (s.FaultInjector()
         .inject("before_decode", at=3, times=2, kind="step_exception",
                 state_intact=False)
         .inject("after_decode", at=6, kind="nan_logits", slots=[0])
         .install(eng))
        return eng

    def watch_check(ce, pe):
        keys = ("recoveries", "rebuilds", "quarantined", "failed")
        cm, pm = ce.metrics(), pe.metrics()
        _check({k: cm[k] for k in keys} == {k: pm[k] for k in keys}
               and cm["rebuilds"] == 1 and not ce.cache.stacked,
               f"layered watchdog: card {[cm[k] for k in keys]}, CPU "
               f"{[pm[k] for k in keys]}")

    launches["watchdog"] = _card_vs_cpu(
        port, "watchdog", models, faulted,
        [p[:LAYERED_CPU_PROMPT] for p in _serve_prompts(
            np.random.RandomState(382), vocab, 6)],
        check=watch_check)
    del models, pools
    torch.cuda.empty_cache()
    return launches


def phase_predictor(port, model, ids):
    """Phase 37: the inference Predictor over phase 35's model."""
    torch, inf = port["torch"], port["inference"]
    new = 16
    config = inf.Config().set_causal_lm_model(model)
    config.enable_causal_lm_decode(max_new_tokens=new, **GEN_KW)
    p = inf.create_predictor(config)
    p.get_input_handle("x0").copy_from_cpu(ids.cpu().numpy())
    _reset_launches(port)
    t0 = time.perf_counter()
    p.run()
    got = p.get_output_handle("out0").copy_to_cpu()
    dt = time.perf_counter() - t0
    counts = _launch_counts(port)
    want = model.generate(ids, new, **GEN_KW).cpu().numpy()
    same = np.array_equal(got, want)
    print(f"[predictor] decode mode, batch {GEN_BATCH} prompt {GEN_PROMPT} "
          f"+ {new}: {1e3 * dt:.1f} ms, equal to generate() {same}; "
          f"launches {counts}")
    _check(same and counts["fwd"] == SERVE_LAYERS
           and counts["decode"] == SERVE_LAYERS * (new - 1),
           f"predictor decode mode: equal {same}, launches {counts}")
    launched = dict(fwd=counts["fwd"], decode=counts["decode"])
    # a PredictorPool of 2 from 2 threads: the serial rows
    import threading

    pool = inf.PredictorPool(config, 2)
    results, errors = [None, None], []

    def work(i):
        try:
            with pool.predictor(timeout=120) as q:
                results[i] = q.run([ids])[0].cpu().numpy()
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    pool_ok = (not errors and not any(t.is_alive() for t in threads)
               and all(r is not None and np.array_equal(r, want)
                       for r in results))
    print(f"[predictor] PredictorPool of 2 from 2 threads: rows equal to "
          f"the serial run {pool_ok} {errors}")
    _check(pool_ok, f"predictor pool: {errors}")
    model.clear_decode_cache()
    # serving mode against ServingEngine.generate_batch on the same rows
    rows = np.random.RandomState(39).randint(0, model.config.vocab_size,
                                             (8, 120))
    sconfig = inf.Config().set_causal_lm_model(model)
    sconfig.enable_serving_mode(max_new_tokens=new, num_slots=8,
                                page_size=128, max_context=512)
    sp = inf.create_predictor(sconfig)
    _reset_launches(port)
    t0 = time.perf_counter()
    out = sp.run([rows])[0].numpy()
    dt = time.perf_counter() - t0
    counts = _launch_counts(port)
    eng = port["ServingEngine"](model, **_engine_kw())
    want = np.stack(eng.generate_batch(list(rows), new))
    eng.close()
    same = np.array_equal(out, want)
    print(f"[predictor] serving mode, 8 rows of 120 + {new}: {1e3 * dt:.1f} "
          f"ms, equal to ServingEngine.generate_batch {same}; ragged "
          f"launches {counts['ragged']}")
    _check(same and counts["ragged"] > 0 and counts["ragged"]
           % SERVE_LAYERS == 0, f"predictor serving mode: equal {same}, "
           f"launches {counts}")
    sconfig._get_serving_engine().close()
    torch.cuda.empty_cache()
    launched["ragged_serving"] = counts["ragged"]
    return launched


def phase_layered_train(port):
    """Phase 40: one forward and backward of the layered model at 2 layers
    of full width, bf16, batch 8 x 1024 (launch counts, finite), then at
    batch LAYERED_TRAIN_CPU_BATCH against the CPU in fp32 from the same
    bf16 weights."""
    torch = port["torch"]
    cfg = port["gpt_1p3b"](num_layers=2, hidden_dropout=0.0,
                           attention_dropout=0.0)
    crit = port["Criterion"]()
    model = _layered(port, cfg, "bfloat16", 40)
    model.train()
    rng = np.random.RandomState(40)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                       (TRAIN_BATCH, TRAIN_SEQ)))
    labels = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                          (TRAIN_BATCH, TRAIN_SEQ)))

    def step(m, i, l):
        m.zero_grad(set_to_none=True)
        loss = crit(m(i.to(m.device)), l.to(m.device))
        loss.backward()
        return loss

    step(model, ids[:1], labels[:1])            # warm-up
    torch.cuda.synchronize()
    _reset_launches(port)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss = step(model, ids, labels)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = _launch_counts(port)
    finite = bool(torch.isfinite(loss)) and all(
        bool(torch.isfinite(p.grad).all()) for p in model.parameters())
    print(f"[layered_train] 2 layers bf16, {TRAIN_BATCH} x {TRAIN_SEQ}: "
          f"loss {loss.item():.5f}, forward and backward {1e3 * dt:.1f} ms "
          f"(host clock), peak {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB; launches {counts}; finite {finite}")
    _check(finite and counts["fwd"] == 2 and counts["dkv"] == 2
           and counts["dq"] == 2,
           f"layered train: finite {finite}, launches {counts}")
    train_launches = counts
    b = LAYERED_TRAIN_CPU_BATCH
    card_loss = step(model, ids[:b], labels[:b]).item()
    card_g = {n: p.grad.float().cpu() for n, p in model.named_parameters()}
    cpu = _layered(port, cfg, "float32", 40, device="cpu")
    cpu.load_state_dict({k: v.float().cpu()
                         for k, v in model.state_dict().items()})
    cpu.train()
    t0 = time.perf_counter()
    cpu_loss = step(cpu, ids[:b], labels[:b]).item()
    cpu_s = time.perf_counter() - t0
    rels = {n: ((card_g[n] - p.grad).norm() / p.grad.norm()).item()
            for n, p in cpu.named_parameters()}
    worst = max(rels, key=rels.get)
    loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    print(f"[layered_train] batch {b} x {TRAIN_SEQ}, card bf16 vs CPU fp32 "
          f"({cpu_s:.1f} s): loss {card_loss:.6f} vs {cpu_loss:.6f} "
          f"(relative {loss_rel:.3g}, tol {TRAIN_LOSS_REL:.3g}); gradient "
          f"relative norm max {rels[worst]:.4g} ({worst}), median "
          f"{float(np.median(list(rels.values()))):.4g} (tol "
          f"{TRAIN_GRAD_NORM:.4g})")
    _check(loss_rel <= TRAIN_LOSS_REL and rels[worst] <= TRAIN_GRAD_NORM,
           "layered train: card and CPU loss or gradients part")
    del model, cpu
    torch.cuda.empty_cache()
    return train_launches


# ---------------------------------------------------------------------------
# phases 41-44: sharded, elastic and disaggregated serving
# ---------------------------------------------------------------------------

SHARD_MESHES = ((2, 1), (1, 2), (2, 2))


def _mesh_devices(n):
    """``n`` names of one device: every replica and shard co-resident."""
    return [f"{DEVICE}:0" if DEVICE == "cuda" else DEVICE] * n


def _cluster_ledgers_ok(eng):
    return all(_ledger_ok(r.allocator) for r in eng.replicas)


def _shard_traffic(vocab):
    """Phase 3's 16 prompts, drawn as ``serve_engine`` and
    ``serve_workload`` draw them (one warm-up prompt first)."""
    rng = np.random.RandomState(0)
    rng.randint(0, vocab, (64,))
    return _serve_prompts(rng, vocab)


def _drive_cluster(port, eng, prompts, new, per_tick=None, **kw):
    """Submit every prompt at once and tick ``eng`` (a sharded or
    disaggregated cluster) to idle, holding every replica's ledger after
    each tick.  ``per_tick`` (a list) gets, each tick, (ragged launches,
    fused steps of each replica).  Returns (requests, wall seconds, tick
    seconds)."""
    rpa = port["rpa"].ragged_paged_attention
    t0 = time.perf_counter()
    reqs = [eng.submit(p, new, **kw) for p in prompts]
    ticks = []
    while eng.placement.pending():
        l0 = rpa.launches
        f0 = [r._totals["fused_steps"] for r in eng.replicas]
        t1 = time.perf_counter()
        eng.step()
        ticks.append(time.perf_counter() - t1)
        if per_tick is not None:
            per_tick.append((rpa.launches - l0, [
                r._totals["fused_steps"] - f
                for r, f in zip(eng.replicas, f0)]))
        _check(_cluster_ledgers_ok(eng),
               "free + used + spec + shared != capacity on a replica")
        _check(len(ticks) < 20000, "the cluster made no progress")
    port["torch"].cuda.synchronize()
    return reqs, time.perf_counter() - t0, ticks


def _profiled_step_ms(port, run):
    """Device time of one ``run()`` under ``torch.profiler``: (all CUDA
    kernels' ms, the ragged kernel's ms, device busy share of the run's
    wall, the run's wall ms), or None when the profiler saw no device
    activity.  The wall is the run's and its synchronize, not the
    profiler's teardown (which sorts every event)."""
    torch = port["torch"]
    from torch.profiler import ProfilerActivity, profile

    # device activity only: the host events of a 2 s serve would take
    # the profiler longer to sort than the run itself
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
        wall = time.perf_counter() - t0
    ks = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and not e.is_user_annotation]
    if not ks:
        return None
    spans = sorted((e.time_range.start, e.time_range.end) for e in ks)
    busy, cs, ce = 0.0, None, None
    for a, b in spans:
        if ce is None or a > ce:
            if ce is not None:
                busy += ce - cs
            cs, ce = a, b
        else:
            ce = max(ce, b)
    busy += ce - cs
    total = sum(e.time_range.elapsed_us() for e in ks) / 1e3
    ragged = sum(e.time_range.elapsed_us() for e in ks
                 if "ragged_paged_attention" in e.name.lower()) / 1e3
    return total, ragged, busy / 1e6 / wall, 1e3 * wall


def _sharded_run(port, name, model, dp, mp, want, bound="bfloat16",
                 profile_it=False, threads=False, profile_short=False, **kw):
    """One sharded serve of phase 3's traffic at (dp, mp); holds the
    placement, launches, per-shard pools (an int8 pool's scales sharded
    on the head axis), ledgers and parity (``GAP_BOUND[bound]`` against
    ``want``, the single engine's output ids).  ``threads``: step the
    co-resident replicas on the cluster's thread pool, as replicas on
    disjoint cards step (its rule patched for this run).  ``profile_it``
    profiles the whole traffic again, ``profile_short`` a short drive
    (``PLACED_PROFILED``: its kernel ms a tick).  Returns the run's
    numbers."""
    torch, s, sharded = port["torch"], port["serving"], port["sharded"]
    cfg = model.config
    before = sum(port["serving_mesh"].weight_bytes_by_device(model).values())
    rule = sharded.steps_on_threads
    if threads:
        sharded.steps_on_threads = lambda meshes: True
    try:
        eng = s.ShardedServingEngine(model, dp=dp, mp=mp,
                                     devices=_mesh_devices(dp * mp),
                                     **_engine_kw(**kw))
    finally:
        sharded.steps_on_threads = rule
    _check((eng._pool is not None) == (threads and dp > 1),
           f"{name}: replicas on threads {eng._pool is not None}")
    prompts = _shard_traffic(cfg.vocab_size)
    eng.generate_batch([prompts[0][:64]] * dp, 2)        # warm-up
    torch.cuda.synchronize()
    f0 = eng.metrics()["fused_steps"]
    _reset_launches(port)
    per_tick = []
    reqs, dt, ticks = _drive_cluster(port, eng, prompts, SERVE_NEW_TOKENS,
                                     per_tick)
    counts = _launch_counts(port)
    launches = counts.pop("ragged")
    met = eng.metrics()
    fused = met["fused_steps"] - f0
    _all_done(port, name, reqs, SERVE_NEW_TOKENS)
    _check(not any(counts.values()), f"{name}: other kernels {counts}")
    L = cfg.num_layers
    bad = [(ln, fs) for ln, fs in per_tick
           if ln != sum(fs) * L * mp or any(f > 1 for f in fs)]
    _check(not bad and launches == fused * L * mp,
           f"{name}: ragged launches per tick != {L} x mp x replicas that "
           f"stepped: {bad[:4]} (total {launches}, fused {fused})")
    # all requests submitted before the first tick: least-loaded placement
    # alternates on queue depth
    _check([r.replica for r in reqs] == [i % dp for i in range(len(reqs))]
           and met["routed"] == [len(reqs) // dp + 1] * dp,
           f"{name}: replicas {[r.replica for r in reqs]}, routed "
           f"{met['routed']}")
    for rep in eng.replicas:
        c = rep.cache
        shards = c.shards if mp > 1 else [c]
        _check(c.mesh_shards == mp and all(
            sh.nbytes * mp == c.nbytes and sh.num_heads * mp
            == cfg.num_heads for sh in shards),
            f"{name}: per-shard pools {[sh.nbytes for sh in shards]} of "
            f"{c.nbytes}")
        _check(rep.allocator.used_pages == 0 and rep.allocator.spec_pages
               == 0, f"{name}: pages left on a replica")
        if c.quantized:
            for sh in shards:
                sc = (sh.k_scale, sh.v_scale)
                _check(all(tuple(x.shape) == (
                    L, rep.num_pages, cfg.num_heads // mp)
                    and bool(torch.isfinite(x).all()) for x in sc),
                    f"{name}: scales {[tuple(x.shape) for x in sc]}")
    for pm in met["per_replica"]:
        _check(pm["cache_bytes_per_chip"] * mp == pm["cache_bytes"]
               == met["cache_bytes"] // dp
               and met["cache_bytes_per_chip"] == pm["cache_bytes_per_chip"],
               f"{name}: cache_bytes_per_chip {pm['cache_bytes_per_chip']}"
               f" of a replica's {pm['cache_bytes']}")
    for rep in eng.replicas:
        _no_recovery(name, rep)
    tokens = sum(len(r.tokens) for r in reqs)
    # weight bytes of replica 0: on the card (every shard co-resident),
    # and what each shard's card would hold on distinct cards (where the
    # shards do lie on distinct cards, each holds a copy of the replicated
    # tensors, so only the shards' share is below the whole)
    srv = port["serving_mesh"]
    card_bytes = sum(srv.weight_bytes_by_device(
        eng.replicas[0].model).values())
    shard_bytes = srv.shard_weight_bytes(eng.replicas[0].model)
    co_resident = len(set(eng.meshes[0])) == 1
    _check(mp == 1 or ((card_bytes <= before or not co_resident)
                       and max(shard_bytes) < card_bytes),
           f"{name}: replica 0 holds {card_bytes} bytes of weights on the "
           f"card ({before} unsharded), {shard_bytes} a shard")
    prof = None
    if profile_it:
        def again():
            _drive_cluster(port, eng, prompts, SERVE_NEW_TOKENS)
        f1 = eng.metrics()["fused_steps"]
        prof = _profiled_step_ms(port, again)
        f2 = eng.metrics()["fused_steps"] - f1
        if prof is not None:
            prof = (prof[0] / f2, prof[1] / f2, prof[2])
    if profile_short:
        n, new = PLACED_PROFILED
        prof = _steps_profiled(port, lambda: len(_drive_cluster(
            port, eng, prompts[:n], new)[2]))
    got = [r.output_ids() for r in reqs]
    eng.close()
    # the gaps are read from the whole model (replica 0's weights)
    srv.unshard_model(model)
    same, _ = _parity(port, f"{name} vs the single engine", got, want,
                      model, GAP_BOUND[bound], kw.get("kv_dtype", "bfloat16"))
    out = dict(tps=tokens / dt, tick_ms=1e3 * float(np.mean(ticks)),
               ticks=len(ticks), fused=fused, launches=launches,
               per_chip=met["cache_bytes_per_chip"], prof=prof, same=same,
               card_bytes=card_bytes, shard_bytes=shard_bytes)
    print(f"[{name}] {len(reqs)} requests DONE, {tokens} tokens in "
          f"{dt:.3f} s: {out['tps']:.1f} tokens/s; {len(ticks)} ticks, mean "
          f"{out['tick_ms']:.2f} ms (host clock); {fused} replica fused "
          f"steps; ragged launches {launches} ({L} x {mp} a replica "
          f"step); "
          f"pools {met['cache_bytes']} bytes, {met['cache_bytes_per_chip']} "
          f"a shard; replica 0's weights {card_bytes} bytes on the card, "
          f"{shard_bytes} a shard's card on distinct cards"
          + ("" if prof is None else
             f"; device kernel time {prof[0]:.3f} ms per replica "
             f"fused step, ragged {prof[1]:.3f} ms, busy "
             f"{prof[2]:.3f} of the wall"))
    return out


def _single_outputs(port, model, **kw):
    """Phase 3's engine and traffic over ``model``: the output ids."""
    eng, rng = serve_engine(port, kw.get("kv_dtype", "bfloat16"),
                            kw.get("weight_dtype"), model=model)
    reqs, _, _ = serve_workload(port, eng, rng)
    out = [r.output_ids() for r in reqs]
    eng.close()
    return out


def phase_sharded_serve(port):
    """Phase 41: both GPT classes at every mesh of ``SHARD_MESHES``.
    Returns (ragged launches of the first run of each class's meshes, the
    runs' numbers by (class, dp, mp))."""
    torch = port["torch"]
    cfg = port["gpt_1p3b"](num_layers=SHARD_LAYERS)
    launches, runs = 0, {}
    for cls in ("GPT", "Layered"):
        model = port[cls](cfg, device=DEVICE, dtype="bfloat16", seed=0)
        model.eval()
        want = _single_outputs(port, model)
        for dp, mp in SHARD_MESHES:
            name = f"sharded_serve {cls} dp={dp} mp={mp}"
            # one profiled mesh: the profiler's teardown of a serve
            # takes ~12 s of the run's budget
            r = _sharded_run(port, name, model, dp, mp, want,
                             profile_it=cls == "GPT" and (dp, mp) == (2, 2))
            launches += r["launches"]
            runs[(cls, dp, mp)] = r
            if cls == "GPT" and dp > 1 and mp == 1:
                # the same replicas stepped from the thread pool (the
                # rule steps co-resident replicas in order)
                r = _sharded_run(port, name + " threads", model, dp, mp,
                                 want, threads=True)
                launches += r["launches"]
                runs[(cls, dp, mp, "threads")] = r
        del model
        torch.cuda.empty_cache()
    return launches, runs


def phase_sharded_int8(port):
    """Phase 42: (2, 2) with an int8 pool and int8 weights against phase
    13's engine on the same (quantized) weights.  Returns the int8 ragged
    launches."""
    torch = port["torch"]
    cfg = port["gpt_1p3b"](num_layers=SHARD_LAYERS)
    model = port["GPT"](cfg, device=DEVICE, dtype="bfloat16", seed=0)
    model.eval()
    kw = dict(kv_dtype="int8", weight_dtype="int8")
    want = _single_outputs(port, model, **kw)
    # one replica of 2 shards meets the same chunked prefills as phase 13's
    # engine, and the int8 products reduce exact int32 accumulators: the
    # same tokens, every one
    one = _sharded_run(port, "sharded_int8 dp=1 mp=2", model, 1, 2, want,
                       bound="int8_weights", **kw)
    _check(one["same"] == len(want), f"sharded int8 dp=1 mp=2: "
           f"{one['same']}/{len(want)} requests token for token")
    r = _sharded_run(port, "sharded_int8 dp=2 mp=2", model, 2, 2, want,
                     bound="int8_weights", **kw)
    del model
    torch.cuda.empty_cache()
    return one["launches"] + r["launches"], r


def _time_handoff(port, model, pages=4):
    """One hand-off of ``pages`` pages (a 380-token prompt) between two
    pools of ``model``'s, timed with CUDA events over 20 calls issued
    back to back: (ms a call, copies, bytes)."""
    torch, s = port["torch"], port["serving"]
    a = model.new_paged_kv_cache(9, 128, dtype="bfloat16")
    b = model.new_paged_kv_cache(9, 128, dtype="bfloat16")
    src, dst = list(range(1, pages + 1)), list(range(5, 5 + pages))
    copies = 2 * len(a.pool_tensors())
    nbytes = s.disagg.page_transfer_bytes(a, pages)

    def run(i=0):
        s.PageTransfer.copy_pages(a, b, src, dst)

    # not held behind a sleep kernel: each call copies its page ids to the
    # card from pageable memory, which waits for the stream
    ms, _ = _time_ms(torch, run, 20, hold=False)
    ok = all(torch.equal(d.select(ax, 5), t.select(ax, 1))
             for (t, ax), (d, _) in zip(a.pool_tensors(), b.pool_tensors()))
    _check(ok, "hand-off: a copied page differs from its source")
    a.release()
    b.release()
    return ms, copies, nbytes


def phase_disagg(port):
    """Phase 43: prefill -> decode hand-off at full width (``SHARD_LAYERS``
    layers), bf16
    then int8 pools, against the colocated cluster.  Returns the ragged
    launches by pool dtype and the numbers."""
    torch, s = port["torch"], port["serving"]
    cfg = port["gpt_1p3b"](num_layers=SHARD_LAYERS)
    model = port["GPT"](cfg, device=DEVICE, dtype="bfloat16", seed=0)
    model.eval()
    prompts = _shard_traffic(cfg.vocab_size)
    launches, nums = {}, {}
    for kv in ("bfloat16", "int8"):
        kw = _engine_kw(kv_dtype=kv)
        col = s.ShardedServingEngine(model, dp=2, mp=1,
                                     devices=_mesh_devices(2), **kw)
        creqs, _, _ = _drive_cluster(port, col, prompts, SERVE_NEW_TOKENS)
        col.close()
        dis = s.DisaggServingEngine(model, roles=("prefill", "decode"),
                                    devices=_mesh_devices(2), **kw)
        dis.generate_batch([prompts[0][:64]], 2)             # warm-up
        torch.cuda.synchronize()
        m0 = dis.metrics()
        _reset_launches(port)
        reqs, dt, ticks = _drive_cluster(port, dis, prompts,
                                         SERVE_NEW_TOKENS)
        counts = _launch_counts(port)
        m = dis.metrics()
        _all_done(port, f"disagg {kv}", reqs, SERVE_NEW_TOKENS)
        moved = m["transfers_total"] - m0["transfers_total"]
        tin = m["transferred_in"] - m0["transferred_in"]
        tout = m["transferred_out"] - m0["transferred_out"]
        handed = sum(1 for r in reqs if r.replica == 1)
        _check(moved > 0 and tin == tout == moved == handed
               and m["transfers_failed"] == 0,
               f"disagg {kv}: transfers {moved}, in {tin}, out {tout}, "
               f"requests ending on the decode replica {handed}")
        fused = m["fused_steps"] - m0["fused_steps"]
        _check(counts["ragged"] == fused * cfg.num_layers,
               f"disagg {kv}: {counts['ragged']} ragged launches for "
               f"{fused} fused steps")
        _parity(port, f"disagg {kv} vs the colocated cluster",
                [r.output_ids() for r in reqs],
                [r.output_ids() for r in creqs], model,
                GAP_BOUND["bfloat16"], kv)
        hist = dis._transfer_hist.summary()
        pages = m["transfer_pages"] - m0["transfer_pages"]
        tokens = sum(len(r.tokens) for r in reqs)
        nums[kv] = dict(tps=tokens / dt, transfers=moved, pages=pages,
                        handoff_ms=1e3 * hist["mean"],
                        handoff_groups=int(hist["count"]))
        print(f"[disagg] kv {kv}: {len(reqs)} requests DONE, {tokens} "
              f"tokens in {dt:.3f} s: {tokens / dt:.1f} tokens/s; "
              f"{len(ticks)} ticks; {moved} hand-offs moved {pages} pages "
              f"in {int(hist['count'])} batches, {1e3 * hist['mean']:.3f} ms "
              f"a batch (host clock, reserve -> copy -> commit -> release); "
              f"ragged launches {counts['ragged']}")
        launches[kv] = counts["ragged"]
        dis.close()
    layered = port["Layered"](cfg, device=DEVICE, dtype="bfloat16", seed=0)
    for name, m in (("stacked", model), ("layered", layered)):
        ms, copies, nbytes = _time_handoff(port, m)
        bound = 2 * nbytes / HBM_BYTES_PER_S * 1e3
        nums[f"copy_{name}"] = dict(ms=ms, copies=copies, bytes=nbytes,
                                    bound_ms=bound)
        print(f"[disagg] one 4-page hand-off between {name} bf16 pools: "
              f"{ms:.4f} ms a hand-off (CUDA events, 20 back to back), "
              f"{copies} copies, {nbytes} bytes read and as many written; "
              f"bound {bound:.4f} ms at 3.35 TB/s")
    del model, layered
    torch.cuda.empty_cache()
    return launches, nums


# phase 44's traffic: phase 3's prompt lengths cut by 4 (the CPU half
# runs 2 layers of full width in fp32 on the host)
CLUSTER_PROMPT_LENS = (16, 50, 30, 95)
CLUSTER_NEW = 8


def _cluster_model(port, device, cls="GPT"):
    # one layer: the script's decisions read queue depths, ledgers and a
    # fake clock, not the depth, and its CPU half is most of the phase
    cfg = port["gpt_1p3b"](num_layers=1)
    return port[cls](cfg, device=device, dtype="float32", seed=1).eval()


def _request_record(reqs):
    return [(r.state, len(r.tokens), r.rehomed) for r in reqs]


def _ledgers(eng):
    return [(a.free_pages, a.used_pages, a.spec_pages, a.shared_pages)
            for a in (r.allocator for r in eng.replicas)]


def _cluster_script(port, model, lmodel, device):
    """Phase 44's script on ``device`` (``model`` the stacked GPT,
    ``lmodel`` the layered one): every decision it makes is a function of
    queue depths, ledgers and a fake clock (the controller trusts no
    latency sample), so the card and the CPU must agree on all of it.
    Returns (record, {name: requests}, ragged launches)."""
    s = port["serving"]
    rng = np.random.RandomState(44)
    vocab = model.config.vocab_size
    prompts = [rng.randint(0, vocab, (CLUSTER_PROMPT_LENS[i % 4],))
               for i in range(16)]
    # a short context and prefill budget: the CPU half's plain attention
    # gathers every page of the step's whole (padded) token axis
    kw = dict(num_slots=2, page_size=128, max_context=256,
              prefill_token_budget=32, cache_dtype="float32",
              readmission_backoff_s=0.0)
    rec, out = {}, {}
    _reset_launches(port)
    # (a) the elastic controller over dp=3, queue-driven, fake clock
    eng = s.ShardedServingEngine(model, dp=3, mp=1,
                                 devices=[device] * 3, **kw)
    t = [0.0]
    ctl = s.ElasticServingController(eng, s.ElasticConfig(
        targets=s.SLOTargets(queue_high=1.0, queue_low=0.5),
        min_samples=10 ** 9, cooldown_s=2.0, brownout_cooldown_s=1.0,
        overload_sustain_s=1.0, underload_sustain_s=1.0,
        drain_deadline_s=0.0, brownout_max_new=3), clock=lambda: t[0])
    eng.drain_replica(2)
    reqs, refused, states = [], [], []
    for tick in range(90):
        if tick in (0, 9):
            for p in prompts[:12] if tick == 0 else prompts[12:]:
                try:
                    reqs.append(eng.submit(p, CLUSTER_NEW))
                except s.Overloaded:
                    refused.append(tick)
        t[0] += 0.5
        ctl.tick()
        eng.step()
        states.append(tuple(eng.replica_states()))
        _check(_cluster_ledgers_ok(eng), "elastic: a ledger broke")
    acts = [(type(a).__name__, getattr(a, "replica", None),
             getattr(a, "rung", None)) for a in ctl.actions]
    kinds = [k for k, _, _ in acts]
    _check(kinds[:1] == ["ScaleUp"] and "Brownout" in kinds
           and "Recover" in kinds and "ScaleDown" in kinds
           and kinds.index("ScaleDown") > max(
               i for i, k in enumerate(kinds) if k == "Recover"),
           f"elastic: actions {acts}")
    rungs = [r for k, _, r in acts if k == "Brownout"]
    released = [r for k, _, r in acts if k == "Recover"]
    _check(released == rungs[::-1], f"elastic: rungs {rungs}, released "
           f"{released} (not LIFO)")
    _check(not eng.placement.pending(), "elastic: requests still pending")
    rec["elastic"] = dict(actions=acts, states=states, refused=refused,
                          requests=_request_record(reqs),
                          max_new=[r.max_new_tokens for r in reqs],
                          ledgers=_ledgers(eng),
                          routed=eng.metrics()["routed"])
    out["elastic"] = reqs
    ctl.close()
    eng.close()
    # (b) a drain of replica 1 at mid-run, then kill_replica(0)
    eng = s.ShardedServingEngine(model, dp=3, mp=1,
                                 devices=[device] * 3, **kw)
    reqs = [eng.submit(p, CLUSTER_NEW) for p in prompts[:10]]
    for tick in range(400):
        if tick == 3:
            eng.begin_drain_replica(1, deadline_s=0.0)
        if tick == 6:
            killed = eng.kill_replica(0)
        if tick > 6 and not eng.placement.pending():
            break
        eng.step()
        _check(all(_ledger_ok(r.allocator)
                   for i, r in enumerate(eng.replicas) if i != 0),
               "drain/kill: a survivor's ledger broke")
    m = eng.metrics()
    _check(eng.replica_states() == ["dead", "parked", "active"]
           and m["rehomed"] > 0 and killed > 0,
           f"drain/kill: states {eng.replica_states()}, rehomed "
           f"{m['rehomed']}, killed {killed}")
    rec["drain_kill"] = dict(states=eng.replica_states(),
                             requests=_request_record(reqs),
                             killed=killed, rehomed=m["rehomed"],
                             ledgers=_ledgers(eng)[1:], routed=m["routed"])
    out["drain_kill"] = reqs
    eng.close()
    # (c) a disaggregated pair under a transfer_error and a transfer_partial
    dis = s.DisaggServingEngine(model, roles=("prefill", "decode"),
                                devices=[device] * 2, **kw)
    s.FaultInjector([
        s.FaultPlan(kind="transfer_error", point="page_transfer", at=0),
        s.FaultPlan(kind="transfer_partial", point="page_transfer", at=1),
    ]).install(dis)
    reqs = [dis.submit(p, CLUSTER_NEW) for p in prompts[:6]]
    while dis.placement.pending():
        dis.step()
        _check(_cluster_ledgers_ok(dis), "disagg faults: a ledger broke")
    m = dis.metrics()
    _check(m["transfers_failed"] == 2 and m["transfers_total"] > 0,
           f"disagg faults: failed {m['transfers_failed']}, total "
           f"{m['transfers_total']}")
    rec["transfer_faults"] = dict(
        requests=_request_record(reqs), ledgers=_ledgers(dis),
        transfers={k: m[k] for k in ("transfers_total", "transfers_failed",
                                     "transfer_pages", "transfer_bytes",
                                     "transferred_in", "transferred_out")})
    out["transfer_faults"] = reqs
    dis.close()
    # (d) sharded: the stacked model at (dp, mp) = (2, 2) and the layered
    # one at (1, 2), every shard's arithmetic held card against CPU
    for part, m, dp in (("sharded_2x2", model, 2),
                        ("sharded_layered_1x2", lmodel, 1)):
        eng = s.ShardedServingEngine(m, dp=dp, mp=2, devices=[device] * 4,
                                     **kw)
        reqs = [eng.submit(p, CLUSTER_NEW) for p in prompts[:8]]
        ticks = 0
        while eng.placement.pending():
            eng.step()
            ticks += 1
            _check(_cluster_ledgers_ok(eng), f"{part}: a ledger broke")
        _check(all(r.cache.mesh_shards == 2 for r in eng.replicas),
               f"{part}: the pools are not sharded")
        met = eng.metrics()
        rec[part] = dict(requests=_request_record(reqs),
                         replicas=[r.replica for r in reqs],
                         ledgers=_ledgers(eng), routed=met["routed"],
                         ticks=ticks,
                         per_chip=met["cache_bytes_per_chip"])
        out[part] = reqs
        eng.close()
        # the parity gaps are read from the whole model
        port["serving_mesh"].unshard_model(m)
    return rec, out, _launch_counts(port)["ragged"]


def phase_cluster_card_vs_cpu(port):
    """Phase 44: the cluster script on the card and on the CPU.  Returns
    the card's ragged launches."""
    torch = port["torch"]
    models = {}
    for cls in ("GPT", "Layered"):
        card = _cluster_model(port, DEVICE, cls)
        cpu = _cluster_model(port, "cpu", cls)
        cpu.load_state_dict({k: v.cpu()
                             for k, v in card.state_dict().items()})
        models[cls] = (card, cpu)
    t0 = time.perf_counter()
    crec, creqs, launches = _cluster_script(
        port, models["GPT"][0], models["Layered"][0], DEVICE)
    t1 = time.perf_counter()
    prec, preqs, _ = _cluster_script(
        port, models["GPT"][1], models["Layered"][1], "cpu")
    t2 = time.perf_counter()
    for part in crec:
        _check(crec[part] == prec[part],
               f"cluster {part}: card {crec[part]} != CPU {prec[part]}")
        done = [i for i, r in enumerate(preqs[part]) if r.finished]
        gap_model = models["Layered" if "layered" in part else "GPT"][0]
        _parity(port, f"cluster {part} fp32 1 layer, card vs CPU",
                [creqs[part][i].output_ids() for i in done],
                [preqs[part][i].output_ids() for i in done], gap_model,
                GAP_BOUND["float32"], "float32")
    _check(launches > 0, "cluster: no ragged launch on the card")
    acts = crec["elastic"]["actions"]
    print(f"[cluster] card == CPU on every record; elastic actions {acts}; "
          f"drain/kill {crec['drain_kill']['states']}, rehomed "
          f"{crec['drain_kill']['rehomed']}; transfer faults "
          f"{crec['transfer_faults']['transfers']}; sharded replicas "
          f"(2, 2) {crec['sharded_2x2']['replicas']}, ticks stacked (2, 2) "
          f"{crec['sharded_2x2']['ticks']}, layered (1, 2) "
          f"{crec['sharded_layered_1x2']['ticks']}; card {t1 - t0:.2f} s, "
          f"CPU {t2 - t1:.2f} s; card ragged launches {launches}")
    del models, card, cpu
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phases 45-47: hybrid dp x pp x mp training of the stacked GPT
# ---------------------------------------------------------------------------

# (name, (dp, pp, mp), n_micro, virtual_pp_degree, use_tensor_parallel,
# steps): GPT-3 1.3B at full width and depth, every position on cuda:0;
# the (2, 2, 2) run also cuts the word embeddings and the loss over mp
MESH_TRAIN_RUNS = (("1x2x2", (1, 2, 2), 4, 1, False, 3),
                   ("1x2x2_vpp2", (1, 2, 2), 4, 2, False, 2),
                   ("2x2x2", (2, 2, 2), 2, 1, True, 2))
# the trained models phase 52 generates and serves from (1x2x2) and
# phase 53 feeds placed batches (2x2x2)
MESH_KEEP = ("1x2x2", "2x2x2")
# phase 46's recompute: every block, as phase 6's (the math is the same
# without it)
MESH_RECOMPUTE_INTERVAL = 1
# the flash kernels' shape on those runs: a microbatch of B / (dp n_micro)
# = 2 rows at H / mp = 8 heads
MESH_SHARD_FLASH = (2, 8, 1024, 128)
# one shard of the QKV slab at (pp, mp) = (2, 2): 12 layers, 3 x 1024
# columns
MESH_SHARD_ADAMW = (12, 2048, 3072)
MESH_CPU_STEPS = 3
# phase 47's recompute (tools/port_mesh_probe.py --cards N
# --recompute-interval K sets it over distinct cards)
MESH_CPU_RECOMPUTE = 0
MESH_LR = 1e-4
# phase 47's global-norm clip: below the 2-layer model's gradient norm
# at init, so every step scales every part by one norm over all of them
MESH_CLIP = 0.5
# phase 47's step-1 gradients, card against CPU in fp32 with TF32 off:
# the same arithmetic summed in another order (~1e-6 of a tensor's
# largest gradient) and the fp32 flash kernels' gradients, within ~2e-5
# of the plain version's (FLASH_GRAD_TOL); held at 1e-4 of each gathered
# tensor's largest gradient
MESH_GRAD_REL = 1e-4
# phase 46: GPT-3 1.3B bf16 on a mesh against the unplaced model, both on
# the card.  Each step's loss within MESH_LOSS_REL of the unplaced one's
# (the two differ only where the mp partials round: 2e-6 at step 1, 3e-5
# over 6 steps); step 1's gathered gradients per tensor by relative norm
# within TRAIN_GRAD_NORM, phase 40's bf16 rule (a misplaced cut or a
# dropped partial parts them by O(1))
MESH_LOSS_REL = 1e-4
# phase 47's weights after the AdamW steps.  An element whose step-1
# gradient, card and CPU, parts by more than MESH_ZERO_REL of the CPU's is
# zero to rounding there (the key third of qkv_b is zero in exact
# arithmetic: softmax ignores a shift of a row's scores); AdamW divides
# by the gradient's own size, so such an element may move by any share
# of a step either way, and it is held only to two steps of the rate.
# Every other element's update differs by at most ~MESH_ZERO_REL of a
# step a step; it is held to twice that, plus 1e-5 relative, and each
# tensor's 99.9th percentile to 1e-6 (phase 24's rule).  At most
# MESH_ZERO_SHARE of the model may be zero to rounding.
MESH_ZERO_REL = 1e-3
MESH_ZERO_SHARE = 1e-2


def _set_mesh(port, axes):
    """The port's global mesh over ``axes``, every position on cuda:0 (or
    on the CPU); None clears it."""
    dm = port["mesh"]
    if axes is None:
        dm.set_mesh(None)
        return
    dm.set_mesh(dm.build_mesh(dict(zip(("dp", "pp", "mp"), axes)),
                              _mesh_devices(int(np.prod(axes)))))


def phase_mesh_kernels(port):
    """Phase 45: the flash kernels at a shard's microbatch (bf16, causal,
    q/k/v the strided views of a fused QKV output, as the block hands
    them) and the AdamW kernel on one shard of a GPT-3 1.3B slab, each
    against its plain version at its rows' tolerances."""
    fwd, dkv, dq = _flash_compare(port, "bfloat16", MESH_SHARD_FLASH, True,
                                  450)
    adamw = _adamw_compare(port, MESH_SHARD_ADAMW, "bfloat16", 451)
    return dict(fwd=fwd, dkv=dkv, dq=dq, adamw=adamw)


def mesh_train_setup(port, axes, n_micro, vpp, tp):
    """Phase 6's model, optimizer and step (GPT-3 1.3B bf16, seed 0,
    recompute every ``MESH_RECOMPUTE_INTERVAL`` blocks, O1), placed on the
    mesh ``axes``."""
    cfg = port["gpt_1p3b"](hidden_dropout=0.0, attention_dropout=0.0,
                           max_position_embeddings=1024,
                           recompute_interval=MESH_RECOMPUTE_INTERVAL,
                           use_flash_attention=True,
                           virtual_pp_degree=vpp, use_tensor_parallel=tp)
    _set_mesh(port, axes)
    model = port["GPT"](cfg, n_micro, dtype="bfloat16", seed=0)
    opt = port["AdamW"](parameters=model.parameters(), learning_rate=1e-4,
                        weight_decay=0.01, multi_precision=False)
    step = port["FusedTrainStep"](
        lambda ids, labels: model(ids, labels=labels), opt, amp_level="O1")
    return model, step


def _o1_grads(port, model, ids, labels):
    """One O1 forward and backward of ``model`` (no step): its loss and
    gathered gradients (the parameters' own without a mesh), by name."""
    with port["amp"].auto_cast(enable=True, level="O1", dtype="bfloat16"):
        loss = model(ids, labels=labels)
    loss.backward()
    loss = loss.detach()
    sharded = port["shards"].sharded_parameters(model)
    grads = ({k: sp.gather([p.grad for p in sp]) for k, sp in sharded.items()}
             if sharded else {k: p.grad for k, p in model.named_parameters()})
    model.zero_grad(set_to_none=True)
    return float(loss), grads


def _grad_rel_norms(grads, ref):
    # as Python floats: the two norms may lie on different cards
    return {k: (g.float() - ref[k].to(g.device).float()).norm().item()
            / ref[k].float().norm().item() for k, g in grads.items()}


def _mesh_run(port, name, axes, n_micro, vpp, tp, steps, batches, ref,
              keep=None):
    """One mesh run of phase 46: step 1's gathered gradients against the
    unplaced model's, then ``steps`` steps, each loss against the unplaced
    model's on the same batch, step 1's launches against the unplaced
    step's times dp x n_micro x mp; later steps timed on the host clock,
    the last under ``torch.profiler``.  ``keep`` (a dict): the trained
    model is kept there under ``name`` (its optimizer is dropped)."""
    torch = port["torch"]
    dp, pp, mp = axes
    t0 = time.perf_counter()
    model, step = mesh_train_setup(port, axes, n_micro, vpp, tp)
    n_tensors = len(list(model.parameters()))
    positions = port["shards"].weight_bytes_by_position(model)
    build_s = time.perf_counter() - t0
    _, grads = _o1_grads(port, model, *batches[0])
    _check(set(grads) == set(ref["grads"]),
           f"{name}: gathered {sorted(grads)}, unplaced "
           f"{sorted(ref['grads'])}")
    rels = _grad_rel_norms(grads, ref["grads"])
    del grads
    worst = max(rels, key=rels.get)
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(port)
    first, first_s = train_steps(port, step, batches, 1)
    launches = _launch_counts(port)
    want = {k: dp * n_micro * mp * ref["per_step"][k]
            for k in ("fwd", "dkv", "dq")}
    want["adamw"] = n_tensors
    losses, wall = train_steps(port, step, batches, steps - 2, first=1) \
        if steps > 2 else ([], 0.0)
    prof = _profiled_step_ms(
        port, lambda: losses.append(float(step(*batches[(steps - 1)
                                                        % len(batches)]))))
    _check(prof is not None, f"{name}: the profiler saw no device activity")
    step_ms = 1e3 * wall / (steps - 2) if steps > 2 else prof[3]
    total = _launch_counts(port)
    peak = torch.cuda.max_memory_allocated()
    replica0 = sum(v for k, v in positions.items() if k[0] == 0)
    got = first + losses
    loss_rels = [abs(a - b) / abs(b) for a, b in zip(got, ref["losses"])]
    print(f"[mesh_train] {name}: (dp, pp, mp) = {axes}, n_micro {n_micro}, "
          f"virtual_pp_degree {vpp}, use_tensor_parallel {tp}, {steps} "
          f"steps of {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}; set-up {build_s:.2f} s; step 1 gradients against "
          f"the unplaced model's, relative norm max {rels[worst]:.4g} "
          f"({worst}), median {float(np.median(list(rels.values()))):.4g} "
          f"(tol {TRAIN_GRAD_NORM:.4g}); losses {got} against the unplaced "
          f"model's {ref['losses'][:steps]} (relative {loss_rels}, tol "
          f"{MESH_LOSS_REL:.3g}); step 1 {1e3 * first_s:.1f} ms with "
          f"warm-up; launches step 1 {launches} (want {want}); "
          f"step {step_ms:.2f} ms (host clock"
          f"{'' if steps > 2 else ', under the profiler'}); last step "
          f"under the profiler {prof[3]:.2f} ms, device {prof[0]:.2f} ms, "
          f"busy {prof[2]:.3f} of it; "
          f"peak {peak / 2**30:.2f} GiB; weight bytes by (r, s, i) "
          f"{positions} (replica 0: {replica0})")
    _check(all(np.isfinite(got)), f"{name}: non-finite losses")
    _check(rels[worst] <= TRAIN_GRAD_NORM, f"{name}: step 1's gradient of "
           f"{worst} is off the unplaced model's ({rels[worst]:.4g})")
    _check(len(got) == steps and max(loss_rels) <= MESH_LOSS_REL,
           f"{name}: losses {got} are off the unplaced model's "
           f"{ref['losses'][:steps]}")
    _check(all(launches[k] == want[k] for k in want),
           f"{name}: launches {launches}, expected {want}")
    _check(all(total[k] == steps * want[k] for k in want),
           f"{name}: launches over {steps} steps {total}")
    out = dict(launches=total, step_ms=step_ms, device_ms=prof[0],
               busy=prof[2], profiled_ms=prof[3], peak=peak,
               positions=positions, replica0=replica0)
    if keep is not None:
        keep[name] = model
    del model, step
    _set_mesh(port, None)
    torch.cuda.empty_cache()
    return out


def phase_mesh_train(port, runs=MESH_TRAIN_RUNS, keep=None):
    """Phase 46: GPT-3 1.3B through ``FusedTrainStep`` on each mesh of
    ``runs``, against phase 6's unplaced model, optimizer and batches
    (``train_setup``): its step 1 gradients and the losses of as many
    steps as the longest run takes.  ``keep`` (a dict): the trained
    models of the runs it names (``MESH_KEEP``) and the batches, for
    phases 52-53."""
    torch = port["torch"]
    model, step, batches = train_setup(port)
    whole = sum(t.numel() * t.element_size() for t in model.parameters())
    ref_loss, grads = _o1_grads(port, model, *batches[0])
    ref = dict(grads=grads)
    ref["losses"], _ = train_steps(port, step, batches,
                                   max(r[-1] for r in runs))
    del model, step
    torch.cuda.empty_cache()
    L = port["gpt_1p3b"]().num_layers
    # a recomputed block runs its flash forward twice
    ref["per_step"] = {"fwd": (1 + bool(MESH_RECOMPUTE_INTERVAL)) * L,
                       "dkv": L, "dq": L}
    print(f"[mesh_train] unplaced GPT-3 1.3B bf16: step 1 loss "
          f"{ref_loss!r} (no step), losses {ref['losses']}, {whole} weight "
          f"bytes; per step {ref['per_step']}")
    out = {}
    for name, axes, n_micro, vpp, tp, steps in runs:
        out[name] = _mesh_run(
            port, name, axes, n_micro, vpp, tp, steps, batches, ref,
            keep if keep is not None and name in MESH_KEEP else None)
        _check(out[name]["replica0"] == whole,
               f"{name}: replica 0's positions hold "
               f"{out[name]['replica0']} bytes, the model {whole}")
    if keep is not None:
        keep["batches"] = batches
    return out


def _gathered_grads(port, model):
    return {k: sp.gather([p.grad for p in sp]).float().cpu()
            for k, sp in port["shards"].sharded_parameters(model).items()}


def _mesh_weights_rule(torch, gc, gg, pc, pg, step_dw):
    """Phase 47's rule on the weights after the steps, card (``pg``)
    against CPU (``pc``), from step 1's gradients (``gg``, ``gc``), all
    whole tensors by name; ``step_dw`` the rate times the steps.  Returns
    (elements zero to rounding, all elements, their largest excess over
    two steps of the rate + 1e-5 relative, the others' largest excess
    over 2 MESH_ZERO_REL steps + 1e-5 relative, the others' largest 99.9th
    percentile difference in a tensor)."""
    n_zero = n_all = 0
    over_kept = over_zero = bulk = -float("inf")
    for n, w in pc.items():
        d = (pg[n] - w).abs()
        zero = (gg[n] - gc[n]).abs() > MESH_ZERO_REL * gc[n].abs()
        n_zero += int(zero.sum())
        n_all += zero.numel()
        if zero.any():
            over_zero = max(over_zero, (d - 2 * step_dw
                                        - 1e-5 * w.abs())[zero].max().item())
        kept = d[~zero]
        over_kept = max(over_kept, (kept - 2 * MESH_ZERO_REL * step_dw
                                    - 1e-5 * w.abs()[~zero]).max().item())
        bulk = max(bulk, torch.quantile(kept[:2**24], 0.999).item())
    return n_zero, n_all, over_zero, over_kept, bulk


def phase_mesh_card_vs_cpu(port, devices=None):
    """Phase 47: a 2-layer fp32 GPT (hidden 256, 4 heads: head_dim 64, 2
    heads a shard) at (2, 2, 2), ``n_micro`` 2, ``use_tensor_parallel``,
    TF32 off, the same weights on the CPU and on the card (its eight
    positions on ``devices``, default all on one card): step 1's gathered
    gradients, then ``MESH_CPU_STEPS`` AdamW steps under a global-norm
    clip (``MESH_CLIP``): losses, then the weights by the rule at
    ``MESH_ZERO_REL``; then one O1 step with a ``GradScaler`` on the card
    with an inf put into one shard's gradient: every part, moment and
    beta power must stay as it was, and the scale halve, as an unplaced
    model's does."""
    torch = port["torch"]
    devices = _mesh_devices(8) if devices is None else list(devices)
    cfg = port["gpt_tiny"](hidden_size=256, num_heads=4, num_layers=2,
                           hidden_dropout=0.0, attention_dropout=0.0,
                           use_tensor_parallel=True,
                           recompute_interval=MESH_CPU_RECOMPUTE)
    rng = np.random.RandomState(47)
    batches = [(rng.randint(0, cfg.vocab_size, (4, 128)),
                rng.randint(0, cfg.vocab_size, (4, 128)))
               for _ in range(MESH_CPU_STEPS)]
    models = {}
    for dev in ("cpu", DEVICE):
        port["mesh"].set_mesh(port["mesh"].build_mesh(
            {"dp": 2, "pp": 2, "mp": 2},
            ["cpu"] * 8 if dev == "cpu" else devices))
        models[dev] = port["GPT"](cfg, 2, dtype="float32", seed=47)
    _set_mesh(port, None)
    models[DEVICE].load_state_dict(models["cpu"].state_dict())
    _reset_launches(port)
    grads, losses, weights = {}, {}, {}
    t0 = time.perf_counter()
    for dev, m in models.items():
        ids, labels = (torch.from_numpy(x).to(m.device) for x in batches[0])
        m(ids, labels=labels).backward()
        grads[dev] = _gathered_grads(port, m)
        m.zero_grad(set_to_none=True)
        step = port["FusedTrainStep"](
            lambda i, l, m=m: m(i, labels=l),
            port["AdamW"](MESH_LR, parameters=m.parameters(),
                          grad_clip=port["clip"].ClipGradByGlobalNorm(
                              MESH_CLIP)))
        losses[dev] = [float(step(*(torch.from_numpy(x).to(m.device)
                                    for x in b))) for b in batches]
        weights[dev] = {k: v.float().cpu() for k, v in m.state_dict().items()}
    both_s = time.perf_counter() - t0
    launches = _launch_counts(port)
    gc, gg = grads["cpu"], grads[DEVICE]
    _check(set(gc) == set(weights["cpu"]),
           f"mesh card vs CPU: gradients of {sorted(gc)}, weights of "
           f"{sorted(weights['cpu'])}")
    gnorm = float(sum(g.double().pow(2).sum() for g in gc.values()) ** 0.5)
    gerr = max(((gg[k] - g).abs().max() / g.abs().max()).item()
               for k, g in gc.items())
    loss_diff = max(abs(a - b) for a, b in zip(losses["cpu"],
                                               losses[DEVICE]))
    n_zero, n_all, over_zero, over_kept, bulk = _mesh_weights_rule(
        torch, gc, gg, weights["cpu"], weights[DEVICE],
        MESH_LR * MESH_CPU_STEPS)
    print(f"[mesh_card_vs_cpu] 2 layers fp32 at (2, 2, 2), n_micro 2, "
          f"vocab-parallel, positions on {sorted(set(map(str, devices)))} "
          f"({both_s:.1f} s both): step 1 gradient norm {gnorm:.4f} (the "
          f"clip {MESH_CLIP} scales it); step 1 gradients max "
          f"|card - cpu| / max |cpu| {gerr!r} (tol {MESH_GRAD_REL}); losses "
          f"cpu {losses['cpu']} card {losses[DEVICE]}, max diff "
          f"{loss_diff!r} (tol {TRAIN_LOSS_ATOL}); weights: {n_zero} of "
          f"{n_all} elements zero to rounding at step 1 (at most "
          f"{MESH_ZERO_SHARE} of them), their excess over 2 lr steps + 1e-5 "
          f"relative {over_zero!r}; the others' excess over "
          f"{2 * MESH_ZERO_REL} lr steps + 1e-5 relative {over_kept!r} "
          f"(both must be <= 0), their largest 99.9th percentile "
          f"difference in a tensor {bulk!r} (tol 1e-6); card launches "
          f"{launches}")
    _check(gnorm > MESH_CLIP, "mesh card vs CPU: the clip does not engage")
    _check(gerr <= MESH_GRAD_REL and loss_diff <= TRAIN_LOSS_ATOL,
           "mesh card vs CPU: gradients or losses part")
    _check(n_zero <= MESH_ZERO_SHARE * n_all and over_zero <= 0
           and over_kept <= 0 and bulk <= 1e-6,
           "mesh card vs CPU: weights part")
    _check(all(launches[k] > 0 for k in ("fwd", "dkv", "dq", "adamw")),
           "mesh card vs CPU: the card did not launch the flash and AdamW "
           "kernels")
    fp32_launches = launches["adamw"]
    flash = {k: launches[k] for k in ("fwd", "dkv", "dq")}
    # one O1 step with a scaler on the card, an inf in one shard's
    # gradient (replica 1, stage 1, shard 1's fc1 columns)
    m = models[DEVICE]
    opt = port["AdamW"](MESH_LR, parameters=m.parameters())
    scaler = port["amp"].GradScaler(enable=True,
                                    init_loss_scaling=O1_INIT_SCALE,
                                    device=DEVICE)
    step = port["FusedTrainStep"](lambda i, l: m(i, labels=l), opt,
                                  scaler=scaler, amp_level="O1",
                                  amp_dtype="bfloat16")
    dev_batch = [torch.from_numpy(x).to(m.device) for x in batches[0]]
    step(*dev_batch)
    _check(step.last_step_applied, "mesh O1: the first step was skipped")
    parts = list(m.parameters())
    # every part, its moments and every device's pair of beta powers
    every = parts + [t for p in parts for t in opt.state[p].values()] \
        + list(opt._pairs.values())
    before = _state_checksum(torch, every)
    scale = float(scaler._scale)
    target = port["shards"].sharded_parameters(m)["decoder.fc1_w"].at(
        (1, 1, 1))
    hook = target.register_hook(lambda g: torch.full_like(g, float("inf")))
    _reset_launches(port)
    step(*dev_batch)
    hook.remove()
    skip_launches = _launch_counts(port)["adamw"]
    after = _state_checksum(torch, every)
    applied = step.last_step_applied
    print(f"[mesh_card_vs_cpu] O1 + GradScaler, inf in one shard's "
          f"gradient: applied {applied}, every part, moment and beta power "
          f"unchanged {bool(before == after)}, scale {scale} -> "
          f"{float(scaler._scale)}; AdamW launches {skip_launches} (one a "
          f"part: {len(parts)})")
    _check(not applied and bool(before == after)
           and float(scaler._scale) == scale * 0.5
           and skip_launches == len(parts),
           "mesh O1: the overflow did not skip every shard")
    del models, m, opt, step
    torch.cuda.empty_cache()
    return dict(flash=flash, adamw_fp32=fp32_launches,
                adamw_fp32_skip=skip_launches)


# ---------------------------------------------------------------------------
# phase 48: the fleet API over the layered GPT at TP=2 PP=2
# ---------------------------------------------------------------------------

# BASELINE.json config 3 ("GPT-3 1.3B Fleet hybrid-parallel TP=2 PP=2") by
# the reference's recipe (tests/test_pipeline.py,
# test_fleet_api_gpt_tp2_pp2_trains), its four positions on one device
FLEET_HYBRID = {"dp_degree": 1, "pp_degree": 2, "mp_degree": 2}
FLEET_PIPE = {"accumulate_steps": 4, "micro_batch_size": 2}
FLEET_STEPS = 2
FLEET_LR = 1e-4
# the flash kernels' shape there: a microbatch of 2 rows at H / mp = 8
# heads
FLEET_SHARD_FLASH = (2, 8, 1024, 128)


def fleet_part_count(cfg, mp):
    """The tensors a fleet pipeline of the layered GPT holds at ``mp`` >
    1 (one AdamW launch each a step): the word table in mp parts, the
    position table, per layer 6 whole (the two LayerNorms' gains and
    shifts, the out and fc2 biases) and 6 cut in mp parts (the QKV and
    fc1 weights and biases, the out and fc2 weights), and the final
    LayerNorm's 2."""
    return mp + 1 + cfg.num_layers * (6 + 6 * mp) + 2


def fleet_pipeline(port, cfg, devices, dtype, seed, grad_clip=None,
                   hybrid=FLEET_HYBRID, pipe=FLEET_PIPE, recompute_interval=0,
                   virtual=None, flags=None, make_opt=None):
    """The reference's recipe on ``devices`` (dp x pp x sharding x mp
    names): the global mesh (dp, pp, sharding, mp of ``hybrid``) over
    them, ``fleet.init`` at
    ``hybrid`` and ``pipe`` (and the strategy ``flags``), a
    ``PipelineLayer`` of [GPTEmbeddings, L x GPTDecoderLayer, LayerNorm,
    the tied GPTLMHead] in two stages (``recompute_interval``,
    ``virtual`` stages) with ``GPTPretrainingCriterion`` as its loss,
    weights drawn from ``seed`` (``init_weights``: the unplaced layered
    model's of that seed, on the same device), then ``distributed_model``
    and ``distributed_optimizer`` of ``make_opt(parameters)`` (default
    ``AdamW``).  Returns (the ``PipelineParallel``, its ``PipelineLayer``,
    the optimizer)."""
    torch, fleet, G = port["torch"], port["fleet"], port["gpt_blocks"]
    dm = port["mesh"]
    dm.set_mesh(dm.build_mesh({a: hybrid.get(f"{a}_degree", 1)
                               for a in ("dp", "pp", "sharding", "sep",
                                         "mp")}, devices))
    st = fleet.DistributedStrategy()
    st.hybrid_configs = dict(hybrid)
    st.pipeline_configs = dict(pipe)
    for k, v in (flags or {}).items():
        setattr(st, k, v)
    fleet.init(is_collective=True, strategy=st)
    dt = getattr(torch, dtype)
    emb = G.GPTEmbeddings(cfg, dtype=dt)
    layers = [emb] + [G.GPTDecoderLayer(cfg, dtype=dt)
                      for _ in range(cfg.num_layers)]
    layers += [port["LayerNorm"](cfg.hidden_size, cfg.layer_norm_eps,
                                 dtype=dt), G.GPTLMHead(emb)]
    pl = fleet.meta_parallel.PipelineLayer(
        layers, num_stages=2, loss_fn=port["Criterion"](cfg),
        recompute_interval=recompute_interval,
        num_virtual_pipeline_stages=virtual)
    port["init_weights"](pl, seed, cfg.initializer_range)
    model = fleet.distributed_model(pl)
    if make_opt is None:
        opt = port["AdamW"](FLEET_LR, parameters=pl.parameters(),
                            multi_precision=False, grad_clip=grad_clip)
    else:
        opt = make_opt(pl.parameters())
    return model, pl, fleet.distributed_optimizer(opt)


def _fleet_key(name, num_layers):
    """The ``PipelineLayer``'s state-dict key of the unplaced layered
    model's ``name``."""
    if name.startswith("gpt.embeddings."):
        return "run_function.0." + name[len("gpt.embeddings."):]
    if name.startswith("gpt.final_ln."):
        return (f"run_function.{num_layers + 1}."
                + name[len("gpt.final_ln."):])
    i, rest = name[len("gpt.layer_"):].split(".", 1)
    return f"run_function.{int(i) + 1}.{rest}"


def _fleet_grads(port, pl):
    """Every gradient of ``pl``, whole (a cut tensor's gathered, under ZeRO
    from the slices), by state-dict key."""
    return port["sharding"].gathered_grads(pl)


class _GradCapture:
    """The optimizer of a ``train_batch`` that keeps the gradients its
    ``step`` sees (gathered by key) before stepping."""

    def __init__(self, port, opt, pl):
        self.port, self.opt, self.pl, self.grads = port, opt, pl, None

    def step(self):
        self.grads = _fleet_grads(self.port, self.pl)
        self.opt.step()

    def clear_grad(self, *args):
        self.opt.clear_grad(*args)


def _o1(port):
    return port["amp"].auto_cast(enable=True, level="O1", dtype="bfloat16")


def phase_fleet_train(port, devices=None):
    """Phase 48: the flash kernels at the head shard's microbatch and the
    AdamW kernel on the largest part tensor against their plain versions;
    then GPT-3 1.3B bf16 (dropout 0, no recompute, O1 as phase 6) through
    the fleet recipe at TP=2 PP=2, its four positions on ``devices``
    (default: all on one card), batch
    TRAIN_BATCH x TRAIN_SEQ in 4 microbatches of 2, FLEET_STEPS steps.
    Step 1 is held against the unplaced layered model carrying the same
    weights with the same batch accumulated over the same microbatches
    (the loss to MESH_LOSS_REL, each gathered gradient by relative norm
    to TRAIN_GRAD_NORM), which is then freed; the flash launches of a
    step are exactly n_micro x mp x L of each kernel and the AdamW
    launches the part tensors; step 2 runs under the profiler.  Then
    :func:`_fleet_card_vs_cpu`."""
    torch = port["torch"]
    t_phase = time.perf_counter()
    devices = _mesh_devices(4) if devices is None else list(devices)
    cards = sorted(set(devices))
    errs = dict(zip(("fwd", "dkv", "dq"), _kept(
        port, _flash_compare, port, "bfloat16", FLEET_SHARD_FLASH, True,
        480)))
    cfg = port["gpt_1p3b"](hidden_dropout=0.0, attention_dropout=0.0,
                           max_position_embeddings=1024,
                           use_tensor_parallel=True, use_flash_attention=True)
    mp = FLEET_HYBRID["mp_degree"]
    errs["adamw"] = _kept(port, _adamw_compare, port,
                          (cfg.vocab_size // mp, cfg.hidden_size),
                          "bfloat16", 481)
    n_micro = FLEET_PIPE["accumulate_steps"]
    L = cfg.num_layers
    rng = np.random.RandomState(48)
    ids, labels = (torch.from_numpy(rng.randint(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ))).to(DEVICE)
        for _ in range(2))
    # the unplaced layered model: the batch over the same microbatches
    _set_mesh(port, None)
    ref = port["Layered"](cfg, device=DEVICE, dtype="bfloat16", seed=0)
    crit = port["Criterion"](cfg)
    ref_loss = 0.0
    rows = TRAIN_BATCH // n_micro
    for x, y in zip(ids.split(rows), labels.split(rows)):
        with _o1(port):
            loss = crit(ref(x), y) * (1.0 / n_micro)
        loss.backward()
        ref_loss += float(loss.detach())
    ref_grads = {k: p.grad for k, p in ref.named_parameters()}
    whole = sum(t.numel() * t.element_size() for t in ref.parameters())
    ref_s = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    model, pl, opt = fleet_pipeline(port, cfg, devices, "bfloat16", 0)
    build_s = time.perf_counter() - t0
    got = pl.state_dict()
    same = all(torch.equal(got[_fleet_key(k, L)].to(v.device), v)
               for k, v in ref.state_dict().items())
    del got
    n_parts = fleet_part_count(cfg, mp)
    positions = port["shards"].weight_bytes_by_position(pl)
    _check(same and len(ref_grads) == len(pl.state_dict()),
           "fleet: the pipeline's weights are not the unplaced model's")
    _check(len(list(pl.parameters())) == n_parts
           and sum(positions.values()) == whole,
           f"fleet: {len(list(pl.parameters()))} tensors of "
           f"{sum(positions.values())} bytes, expected {n_parts} of {whole}")
    torch.cuda.synchronize()
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)
    _reset_launches(port)
    cap = _GradCapture(port, opt, pl)
    t0 = time.perf_counter()
    with _o1(port):
        losses = [float(model.train_batch((ids, labels), cap))]
    for d in cards:
        torch.cuda.synchronize(d)
    step1_s = time.perf_counter() - t0
    first = _launch_counts(port)
    peak_inflight = model.last_peak_inflight
    rels = {k: ((cap.grads[_fleet_key(k, L)].to(g.device).float()
                 - g.float()).norm() / g.float().norm()).item()
            for k, g in ref_grads.items()}
    worst = max(rels, key=rels.get)
    loss_rel = abs(losses[0] - ref_loss) / abs(ref_loss)
    del ref, ref_grads, cap
    torch.cuda.empty_cache()

    def step():
        with _o1(port):
            losses.append(float(model.train_batch((ids, labels), opt)))

    prof = _profiled_step_ms(port, step)
    _check(prof is not None, "fleet: the profiler saw no device activity")
    total = _launch_counts(port)
    peak = max(torch.cuda.max_memory_allocated(d) for d in cards)
    want = {k: n_micro * mp * L for k in ("fwd", "dkv", "dq")}
    want["adamw"] = n_parts
    print(f"[fleet_train] GPT-3 1.3B bf16 (O1) through fleet.init, "
          f"PipelineLayer (segments {pl.segment_bounds}), distributed_model "
          f"and distributed_optimizer at {FLEET_HYBRID}, {FLEET_PIPE}, "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}, positions on "
          f"{[str(d) for d in devices]}: kernel checks and the unplaced model "
          f"{ref_s:.2f} s, set-up {build_s:.2f} s; step 1 loss "
          f"{losses[0]!r} against the unplaced model's {ref_loss!r} "
          f"(relative {loss_rel:.3g}, tol {MESH_LOSS_REL:.3g}); step 1 "
          f"gradients relative norm max {rels[worst]:.4g} ({worst}), median "
          f"{float(np.median(list(rels.values()))):.4g} (tol "
          f"{TRAIN_GRAD_NORM:.4g}); last_peak_inflight {peak_inflight}; "
          f"launches step 1 {first} (want {want}), over {FLEET_STEPS} steps "
          f"{total}; step 1 {1e3 * step1_s:.1f} ms host clock (with warm-up "
          f"and the gradient capture); step 2 under the profiler "
          f"{prof[3]:.2f} ms host clock, device {prof[0]:.2f} ms, busy "
          f"{prof[2]:.3f} of it; losses {losses}; peak "
          f"{peak / 2**30:.2f} GiB (the most of one card); weight bytes by "
          f"(r, s, i) {positions} "
          f"(sum {sum(positions.values())}, the model {whole})")
    _check(all(np.isfinite(losses)), f"fleet: non-finite losses {losses}")
    _check(loss_rel <= MESH_LOSS_REL, "fleet: step 1's loss is off the "
           "unplaced model's")
    _check(rels[worst] <= TRAIN_GRAD_NORM, f"fleet: step 1's gradient of "
           f"{worst} is off the unplaced model's ({rels[worst]:.4g})")
    _check(peak_inflight == 2, f"fleet: last_peak_inflight {peak_inflight}")
    _check(all(first[k] == want[k] and total[k] == FLEET_STEPS * want[k]
               for k in want), f"fleet: launches {first} / {total}, "
           f"expected {want} a step")
    del model, pl, opt
    _set_mesh(port, None)
    port["fleet"].set_hybrid_communicate_group(None)
    torch.cuda.empty_cache()
    cpu = _fleet_card_vs_cpu(port, devices)
    print(f"[time] phase 48 {time.perf_counter() - t_phase:.1f} s")
    return dict(errs=errs, launches=total, cpu_launches=cpu)


def _fleet_tiny(port):
    """Phases 48 and 49's 2-layer fp32 copy of GPT-3 1.3B's recipe (hidden
    256, 4 heads: head_dim 64, 2 heads a shard)."""
    return port["gpt_tiny"](hidden_size=256, num_heads=4, num_layers=2,
                            hidden_dropout=0.0, attention_dropout=0.0,
                            use_tensor_parallel=True)


def _first_applied(port, opt, pl):
    """A dict that the innermost optimizer under ``opt`` (below the hybrid
    wrapper and a meta-optimizer's ``_inner``) fills, at its first
    ``step``, with the gradients that step applies, gathered by key: step
    1's, or under ``gradient_merge`` the merged ones."""
    inner = opt._inner_opt
    while hasattr(inner, "_inner"):
        inner = inner._inner
    seen, step = {}, inner.step

    def capturing(*args, **kwargs):
        if not seen:
            seen.update(_fleet_grads(port, pl))
        return step(*args, **kwargs)

    inner.step = capturing
    return seen


def _fleet_both(port, cfg, devices, batches, seed, **kw):
    """The recipe (``fleet_pipeline(**kw)``, fp32) on the CPU and on
    ``devices``, the same weights (the CPU's, drawn from ``seed``) and
    ``batches``, one ``train_batch`` each: per device, the step-1
    gradients, the gradients the first update applies
    (:func:`_first_applied`), the losses, the weights before and after;
    and the card's launches."""
    grads, applied, losses, weights, state = {}, {}, {}, {}, None
    for dev in ("cpu", DEVICE):
        model, pl, opt = fleet_pipeline(
            port, cfg, ["cpu"] * len(devices) if dev == "cpu" else devices,
            "float32", seed, **kw)
        if state is None:
            # copies: a whole parameter's entry shares its storage, and
            # the CPU run trains it in place
            state = {k: v.clone() for k, v in pl.state_dict().items()}
        else:
            pl.set_state_dict(state)
            _reset_launches(port)
        cap = _GradCapture(port, opt, pl)
        first = _first_applied(port, opt, pl)
        losses[dev] = [float(model.train_batch(b, cap if i == 0 else opt))
                       for i, b in enumerate(batches)]
        grads[dev] = {k: g.float().cpu() for k, g in cap.grads.items()}
        applied[dev] = {k: g.float().cpu() for k, g in first.items()}
        weights[dev] = {k: v.float().cpu() for k, v in pl.state_dict().items()}
        if dev != "cpu" and pl.num_replicas > 1:
            _check(_replicas_equal(port, pl), "fleet card vs CPU: the "
                   "replicas part")
        del model, pl, opt, cap
    launches = _launch_counts(port)
    _set_mesh(port, None)
    port["fleet"].set_hybrid_communicate_group(None)
    return grads, applied, losses, state, weights, launches


def _fleet_compare(port, grads, applied, losses, weights, step_dw):
    """Card against CPU: (the step-1 gradient norm, the gradients' largest
    |card - cpu| / max |cpu|, the losses' largest difference, and phase
    47's weight rule with ``step_dw``, an element zero to rounding where
    the gradients the first update applies part)."""
    torch = port["torch"]
    gc, gg = grads["cpu"], grads[DEVICE]
    gnorm = float(sum(g.double().pow(2).sum() for g in gc.values()) ** 0.5)
    gerr = max(((gg[k] - g).abs().max() / g.abs().max()).item()
               for k, g in gc.items())
    loss_diff = max(abs(a - b) for a, b in zip(losses["cpu"],
                                               losses[DEVICE]))
    rule = _mesh_weights_rule(torch, applied["cpu"], applied[DEVICE],
                              weights["cpu"], weights[DEVICE], step_dw)
    return gnorm, gerr, loss_diff, rule


def _fleet_card_vs_cpu(port, devices):
    """Phase 48's 2-layer fp32 copy (:func:`_fleet_tiny`) at TP=2 PP=2,
    TF32 off, the same weights on the CPU (``["cpu"] * 4``) and on
    ``devices``: step 1's gathered gradients, then MESH_CPU_STEPS
    ``train_batch`` steps of AdamW under a global-norm clip (MESH_CLIP):
    losses, then the weights by phase 47's rule."""
    torch = port["torch"]
    cfg = _fleet_tiny(port)
    rng = np.random.RandomState(148)
    batches = [tuple(torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                                  (8, 128)))
                     for _ in range(2)) for _ in range(MESH_CPU_STEPS)]
    t0 = time.perf_counter()
    grads, applied, losses, _, weights, launches = _fleet_both(
        port, cfg, devices, batches, 48,
        grad_clip=port["clip"].ClipGradByGlobalNorm(MESH_CLIP))
    both_s = time.perf_counter() - t0
    gnorm, gerr, loss_diff, (n_zero, n_all, over_zero, over_kept, bulk) = \
        _fleet_compare(port, grads, applied, losses, weights,
                       FLEET_LR * MESH_CPU_STEPS)
    per_step = 4 * 2 * cfg.num_layers
    want = {"fwd": per_step, "dkv": per_step, "dq": per_step}
    want = {k: MESH_CPU_STEPS * v for k, v in want.items()}
    want["adamw"] = MESH_CPU_STEPS * fleet_part_count(cfg, 2)
    print(f"[fleet_card_vs_cpu] 2 layers fp32 at TP=2 PP=2 ({both_s:.1f} s "
          f"both): step 1 gradient norm {gnorm:.4f} (the clip {MESH_CLIP} "
          f"scales it); step 1 gradients max |card - cpu| / max |cpu| "
          f"{gerr!r} (tol {MESH_GRAD_REL}); losses cpu {losses['cpu']} card "
          f"{losses[DEVICE]}, max diff {loss_diff!r} (tol "
          f"{TRAIN_LOSS_ATOL}); weights: {n_zero} of {n_all} elements zero "
          f"to rounding at step 1 (at most {MESH_ZERO_SHARE} of them), their "
          f"excess over 2 lr steps + 1e-5 relative {over_zero!r}; the "
          f"others' excess over {2 * MESH_ZERO_REL} lr steps + 1e-5 relative "
          f"{over_kept!r} (both must be <= 0), their largest 99.9th "
          f"percentile difference in a tensor {bulk!r} (tol 1e-6); card "
          f"launches {launches} (want {want})")
    _check(gnorm > MESH_CLIP, "fleet card vs CPU: the clip does not engage")
    _check(gerr <= MESH_GRAD_REL and loss_diff <= TRAIN_LOSS_ATOL,
           "fleet card vs CPU: gradients or losses part")
    _check(n_zero <= MESH_ZERO_SHARE * n_all and over_zero <= 0
           and over_kept <= 0 and bulk <= 1e-6,
           "fleet card vs CPU: weights part")
    _check(all(launches[k] == v for k, v in want.items()),
           f"fleet card vs CPU: launches {launches}, expected {want}")
    torch.cuda.empty_cache()
    return {k: launches[k] for k in want}


# ---------------------------------------------------------------------------
# phase 49: the rest of the fleet API at dp 2 x pp 2 x mp 2
# ---------------------------------------------------------------------------

# BASELINE.json config 3 through the fleet recipe with its users' other
# calls: two data-parallel replicas of the pipeline, recompute of every
# layer item and two virtual stages a card (Paddle's interleaved 1F1B);
# 16 rows in 4 microbatches of 4, each split 2 + 2 over the replicas, so
# flash runs at phase 48's head shard (2, 8, 1024, 128)
FLEET_DP_HYBRID = {"dp_degree": 2, "pp_degree": 2, "mp_degree": 2}
FLEET_DP_PIPE = {"accumulate_steps": 4, "micro_batch_size": 4}
FLEET_DP_BATCH = 16
FLEET_DP_RECOMPUTE, FLEET_DP_VIRTUAL = 1, 2
FLEET_DP_STEPS = 2
# the 2-layer fp32 meta-optimizer runs, card against CPU, each
# MESH_CPU_STEPS steps: (name, inner optimizer, strategy flags)
FLEET_META_RUNS = (
    ("gradient_merge", "AdamW", dict(
        gradient_merge=True,
        gradient_merge_configs={"k_steps": 2, "avg": True})),
    ("localsgd", "AdamW", dict(localsgd=True,
                               localsgd_configs={"k_steps": 2})),
    ("lars", "Momentum", dict(lars=True)),
    ("dgc", "Momentum", dict(dgc=True, dgc_configs={
        "rampup_begin_step": 1, "sparsity": [0.999]})))
FLEET_META_MOMENTUM_LR = 0.05


def _replicas_equal(port, pl):
    """Every dp replica copy of ``pl`` holds its replica-0 source's bits
    (and there is one)."""
    torch, shards = port["torch"], port["shards"]
    copies = [(p, shards.replica_of(p)) for p in pl.parameters()
              if shards.replica_of(p) is not None]
    return bool(copies) and all(torch.equal(p, s.to(p.device))
                                for p, s in copies)


def phase_fleet_dp(port, devices=None):
    """Phase 49: GPT-3 1.3B bf16 (dropout 0, O1 as phase 6) through the
    fleet recipe at FLEET_DP_HYBRID, every layer item under
    ``fleet.recompute`` (FLEET_DP_RECOMPUTE) and FLEET_DP_VIRTUAL virtual
    stages, its dp x 4 positions on ``devices`` (default: all on one
    card), FLEET_DP_BATCH x TRAIN_SEQ in 4 microbatches, FLEET_DP_STEPS
    steps.  Step 1 is held
    against the unplaced layered model carrying the same weights with the
    same rows over the same microbatches (the loss to MESH_LOSS_REL, each
    gathered gradient by relative norm to TRAIN_GRAD_NORM); the flash
    launches of a step are exactly dp x n_micro x mp x L x 2 forward (the
    recompute runs each forward twice; x 1 without it) and dp x n_micro x
    mp x L of each backward kernel, the AdamW launches one a part tensor
    of every replica; after step 2 the replicas hold the same bits; step 2 runs
    under the profiler.  Phase 48's kernel checks cover these shapes.
    Then :func:`_fleet_meta_card_vs_cpu`."""
    torch = port["torch"]
    t_phase = time.perf_counter()
    dp, mp = FLEET_DP_HYBRID["dp_degree"], FLEET_DP_HYBRID["mp_degree"]
    n_micro = FLEET_DP_PIPE["accumulate_steps"]
    devices = _mesh_devices(4 * dp) if devices is None else list(devices)
    cards = sorted(set(devices))
    cfg = port["gpt_1p3b"](hidden_dropout=0.0, attention_dropout=0.0,
                           max_position_embeddings=1024,
                           use_tensor_parallel=True, use_flash_attention=True)
    L = cfg.num_layers
    rng = np.random.RandomState(49)
    ids, labels = (torch.from_numpy(rng.randint(
        0, cfg.vocab_size, (FLEET_DP_BATCH, TRAIN_SEQ))).to(DEVICE)
        for _ in range(2))
    _set_mesh(port, None)
    ref = port["Layered"](cfg, device=DEVICE, dtype="bfloat16", seed=0)
    crit = port["Criterion"](cfg)
    ref_loss = 0.0
    rows = FLEET_DP_BATCH // n_micro
    for x, y in zip(ids.split(rows), labels.split(rows)):
        with _o1(port):
            loss = crit(ref(x), y) * (1.0 / n_micro)
        loss.backward()
        ref_loss += float(loss.detach())
    ref_grads = {k: p.grad for k, p in ref.named_parameters()}
    whole = sum(t.numel() * t.element_size() for t in ref.parameters())
    ref_s = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    model, pl, opt = fleet_pipeline(
        port, cfg, devices, "bfloat16", 0, hybrid=FLEET_DP_HYBRID,
        pipe=FLEET_DP_PIPE, recompute_interval=FLEET_DP_RECOMPUTE,
        virtual=FLEET_DP_VIRTUAL)
    build_s = time.perf_counter() - t0
    got = pl.state_dict()
    same = all(torch.equal(got[_fleet_key(k, L)].to(v.device), v)
               for k, v in ref.state_dict().items())
    del got
    # stated before the run: one AdamW launch a part tensor of each
    # replica, every whole parameter copied once a replica
    n_parts = dp * fleet_part_count(cfg, mp)
    positions = port["shards"].weight_bytes_by_position(pl)
    _check(same and len(ref_grads) == len(pl.state_dict())
           and _replicas_equal(port, pl),
           "fleet dp: the pipeline's weights are not the unplaced model's")
    _check(len(list(pl.parameters())) == n_parts
           and sum(positions.values()) == dp * whole
           and len(positions) == dp * 2 * mp,
           f"fleet dp: {len(list(pl.parameters()))} tensors of "
           f"{sum(positions.values())} bytes at {len(positions)} positions, "
           f"expected {n_parts} of {dp * whole} at {dp * 2 * mp}")
    torch.cuda.synchronize()
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)
    _reset_launches(port)
    cap = _GradCapture(port, opt, pl)
    t0 = time.perf_counter()
    with _o1(port):
        losses = [float(model.train_batch((ids, labels), cap))]
    for d in cards:
        torch.cuda.synchronize(d)
    step1_s = time.perf_counter() - t0
    first = _launch_counts(port)
    peak_inflight = model.last_peak_inflight
    rels = {k: ((cap.grads[_fleet_key(k, L)].to(g.device).float()
                 - g.float()).norm() / g.float().norm()).item()
            for k, g in ref_grads.items()}
    worst = max(rels, key=rels.get)
    loss_rel = abs(losses[0] - ref_loss) / abs(ref_loss)
    del ref, ref_grads, cap
    torch.cuda.empty_cache()

    def step():
        with _o1(port):
            losses.append(float(model.train_batch((ids, labels), opt)))

    prof = _profiled_step_ms(port, step)
    _check(prof is not None, "fleet dp: the profiler saw no device activity")
    total = _launch_counts(port)
    peak = max(torch.cuda.max_memory_allocated(d) for d in cards)
    equal = _replicas_equal(port, pl)
    per = dp * n_micro * mp * L
    want = {"fwd": (2 if FLEET_DP_RECOMPUTE else 1) * per, "dkv": per,
            "dq": per, "adamw": n_parts}
    S, V = FLEET_DP_HYBRID["pp_degree"], FLEET_DP_VIRTUAL or 1
    # Paddle's warm-up forwards, then one more before the first backward
    inflight_bound = min((S - 1 if V == 1 else 2 * (S - 1) + (V - 1) * S)
                         + 1, n_micro * V)
    print(f"[fleet_dp] GPT-3 1.3B bf16 (O1) through the fleet recipe at "
          f"{FLEET_DP_HYBRID}, {FLEET_DP_PIPE}, recompute_interval "
          f"{FLEET_DP_RECOMPUTE}, {FLEET_DP_VIRTUAL} virtual stages "
          f"(chunks {pl.segment_bounds}), {FLEET_DP_BATCH} x {TRAIN_SEQ}, "
          f"positions on {[str(d) for d in devices]}: the unplaced model "
          f"{ref_s:.2f} s, set-up {build_s:.2f} s; step 1 loss "
          f"{losses[0]!r} against the unplaced model's {ref_loss!r} "
          f"(relative {loss_rel:.3g}, tol {MESH_LOSS_REL:.3g}); step 1 "
          f"gradients relative norm max {rels[worst]:.4g} ({worst}), median "
          f"{float(np.median(list(rels.values()))):.4g} (tol "
          f"{TRAIN_GRAD_NORM:.4g}); last_peak_inflight {peak_inflight} "
          f"(Paddle's interleaved bound {inflight_bound}); launches step 1 "
          f"{first} (want {want}), over {FLEET_DP_STEPS} steps {total}; "
          f"step 1 {1e3 * step1_s:.1f} ms host clock (with warm-up and the "
          f"gradient capture); step 2 under the profiler {prof[3]:.2f} ms "
          f"host clock, device {prof[0]:.2f} ms, busy {prof[2]:.3f} of it; "
          f"losses {losses}; replicas bit-equal after step 2: {equal}; peak "
          f"{peak / 2**30:.2f} GiB (the most of one card); weight bytes by "
          f"(r, s, i) {positions} (sum {sum(positions.values())}, dp x the "
          f"model {dp * whole})")
    _check(all(np.isfinite(losses)), f"fleet dp: non-finite losses {losses}")
    _check(loss_rel <= MESH_LOSS_REL, "fleet dp: step 1's loss is off the "
           "unplaced model's")
    _check(rels[worst] <= TRAIN_GRAD_NORM, f"fleet dp: step 1's gradient of "
           f"{worst} is off the unplaced model's ({rels[worst]:.4g})")
    _check(peak_inflight == inflight_bound,
           f"fleet dp: last_peak_inflight {peak_inflight}")
    _check(equal, "fleet dp: the replicas part after step 2")
    _check(all(first[k] == want[k] and total[k] == FLEET_DP_STEPS * want[k]
               for k in want), f"fleet dp: launches {first} / {total}, "
           f"expected {want} a step")
    del model, pl, opt
    _set_mesh(port, None)
    port["fleet"].set_hybrid_communicate_group(None)
    torch.cuda.empty_cache()
    cpu = _fleet_meta_card_vs_cpu(port, devices)
    print(f"[time] phase 49 {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=total, cpu_launches=cpu)


def _fleet_meta_card_vs_cpu(port, devices):
    """Phase 49's 2-layer fp32 copy (:func:`_fleet_tiny`) at
    FLEET_DP_HYBRID, TF32 off, once a meta-optimizer of FLEET_META_RUNS
    (``gradient_merge`` and ``localsgd`` over ``AdamW``, ``lars`` and
    ``dgc`` over ``Momentum``), the same weights on the CPU (``["cpu"] *
    8``) and on ``devices``, MESH_CPU_STEPS steps: step 1's gathered
    gradients and the losses to phase 48's tolerances, the weights by
    phase 47's rule with the CPU run's largest weight change as the step
    scale (an element zero to rounding where the gradients the first
    update applies part: the merged ones under ``gradient_merge``), the
    replicas bit-equal, and the exact launches (flash each
    step; the fp32 AdamW kernel once a part of both replicas on each
    step the inner AdamW takes: every step under ``localsgd``, every
    second under ``gradient_merge``; none under LARS and DGC, which the
    JAX package computes outside any Pallas kernel).  Returns the launches
    by run."""
    torch = port["torch"]
    cfg = _fleet_tiny(port)
    dp = FLEET_DP_HYBRID["dp_degree"]
    rng = np.random.RandomState(149)
    batches = [tuple(torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                                  (8, 128)))
                     for _ in range(2)) for _ in range(MESH_CPU_STEPS)]
    out = {}
    for name, inner, flags in FLEET_META_RUNS:
        t0 = time.perf_counter()
        if inner == "AdamW":
            def make(params):
                return port["AdamW"](FLEET_LR, parameters=params,
                                     multi_precision=False)
        else:
            def make(params):
                return port["Momentum"](FLEET_META_MOMENTUM_LR, 0.9,
                                        parameters=params)
        grads, applied, losses, state, weights, launches = _fleet_both(
            port, cfg, devices, batches, 49, hybrid=FLEET_DP_HYBRID,
            flags=flags, make_opt=make)
        both_s = time.perf_counter() - t0
        moved = max((weights["cpu"][k] - v.float().cpu()).abs().max().item()
                    for k, v in state.items())
        gnorm, gerr, loss_diff, (n_zero, n_all, over_zero, over_kept,
                                 bulk) = _fleet_compare(
            port, grads, applied, losses, weights, moved)
        per_step = dp * FLEET_PIPE["accumulate_steps"] * 2 * cfg.num_layers
        steps_taken = {"gradient_merge": MESH_CPU_STEPS // 2,
                       "localsgd": MESH_CPU_STEPS}.get(name, 0)
        want = {k: MESH_CPU_STEPS * per_step for k in ("fwd", "dkv", "dq")}
        want["adamw"] = steps_taken * dp * fleet_part_count(cfg, 2)
        print(f"[fleet_meta] {name} over {inner}, 2 layers fp32 at "
              f"{FLEET_DP_HYBRID} ({both_s:.1f} s both): step 1 gradient "
              f"norm {gnorm:.4f}, max |card - cpu| / max |cpu| {gerr!r} "
              f"(tol {MESH_GRAD_REL}); losses cpu {losses['cpu']} card "
              f"{losses[DEVICE]}, max diff {loss_diff!r} (tol "
              f"{TRAIN_LOSS_ATOL}); largest weight change {moved!r}; "
              f"weights: {n_zero} of {n_all} elements zero to rounding (at "
              f"most {MESH_ZERO_SHARE} of them), their excess {over_zero!r}, "
              f"the others' {over_kept!r} (both <= 0), 99.9th percentile "
              f"{bulk!r} (tol 1e-6); card launches {launches} (want {want})")
        _check(gerr <= MESH_GRAD_REL and loss_diff <= TRAIN_LOSS_ATOL,
               f"fleet {name}: gradients or losses part")
        _check(n_zero <= MESH_ZERO_SHARE * n_all and over_zero <= 0
               and over_kept <= 0 and bulk <= 1e-6,
               f"fleet {name}: weights part")
        _check(all(launches[k] == v for k, v in want.items()),
               f"fleet {name}: launches {launches}, expected {want}")
        out[name] = {k: launches[k] for k in want}
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 50: ZeRO (group_sharded_parallel) at pp 2 x sharding 2 x mp 2
# ---------------------------------------------------------------------------

# BASELINE.json config 3 through phase 48's recipe, then
# group_sharded_parallel over a sharding axis of 2 (its users' answer to
# replicas whose optimizer state does not fit): 16 rows in 4 microbatches
# of 4, each split 2 + 2 over the two sharding replicas, so flash runs at
# phase 48's head shard (2, 8, 1024, 128); FLEET_ZERO_STEPS steps at each
# of FLEET_ZERO_LEVELS from the same weights and batches
FLEET_ZERO_HYBRID = {"dp_degree": 1, "pp_degree": 2, "sharding_degree": 2,
                     "mp_degree": 2}
FLEET_ZERO_PIPE = {"accumulate_steps": 4, "micro_batch_size": 4}
FLEET_ZERO_BATCH = 16
FLEET_ZERO_STEPS = 2
FLEET_ZERO_LEVELS = ("os", "p_g_os")
# the dp fallback's layout (no sharding axis: ZeRO cuts over dp)
FLEET_ZERO_DP_HYBRID = {"dp_degree": 2, "pp_degree": 2, "mp_degree": 2}


def zero_slice_count(cfg, mp, n=2):
    """The AdamW launches of one ZeRO step over one ZeRO group, stated
    before the run: one a slice, every one of a replica's
    ``fleet_part_count`` part tensors cut into ``n`` (each holds at least
    n x 16 bytes at GPT-3 1.3B and at the 2-layer copy)."""
    return n * fleet_part_count(cfg, mp)


def zero_bytes_want(level, W, replicas=2):
    """(parameter, gradient, optimizer-state) bytes over every position of
    the fleet recipe with ``replicas`` replicas in one ZeRO group, ``W``
    one replica's weight bytes and moments in the weights' dtype: whole
    copies until p_g_os, whole gradients until os_g, the two moments per
    replica without ZeRO and once with it."""
    R = replicas
    return {None: (R * W, R * W, 2 * R * W), "os": (R * W, R * W, 2 * W),
            "os_g": (R * W, W, 2 * W), "p_g_os": (W, W, 2 * W)}[level]


def _byte_totals(by_position):
    return tuple(sum(r[k] for r in by_position.values())
                 for k in ("params", "grads", "state"))


class _ZeroCapture:
    """The optimizer of a ``train_batch`` that keeps, before stepping, the
    gradients its ``step`` sees (gathered whole by key, from the slices
    under ZeRO) and ``state_bytes_by_position`` then."""

    def __init__(self, port, opt, model):
        self.port, self.opt, self.model = port, opt, model
        self.grads = self.bytes = None

    def step(self):
        self.grads = _fleet_grads(self.port, self.model)
        self.bytes = self.port["shards"].state_bytes_by_position(
            self.model, self.opt)
        self.opt.step()

    def clear_grad(self, *args):
        self.opt.clear_grad(*args)


def _to_host(sd):
    import torch

    return {k: v.cpu() if isinstance(v, torch.Tensor) else v
            for k, v in sd.items()}


def _same_bits(a, b):
    """The keys of ``a`` and ``b`` and, under each, the same bits."""
    import torch

    if set(a) != set(b):
        return False
    for k, v in a.items():
        w = b[k]
        if isinstance(v, dict):
            if not _same_bits(v, w):
                return False
        elif isinstance(v, torch.Tensor):
            if not torch.equal(v, w.to(v.device)):
                return False
        elif v != w:
            return False
    return True


def phase_fleet_zero(port, devices=None):
    """Phase 50: the AdamW kernel at the largest ZeRO slice against its
    plain version; then GPT-3 1.3B bf16 (dropout 0, O1 as phase 6) through
    phase 48's recipe at FLEET_ZERO_HYBRID and ``group_sharded_parallel``,
    its 8 positions on ``devices`` (default: all on one card),
    FLEET_ZERO_BATCH x TRAIN_SEQ in 4 microbatches, FLEET_ZERO_STEPS steps
    at each of FLEET_ZERO_LEVELS from the same weights.  Step 1 is held
    against the unplaced layered model carrying the same weights with the
    same rows over the same microbatches (the loss to MESH_LOSS_REL, each
    gathered gradient by relative norm to TRAIN_GRAD_NORM); the flash
    launches of a step are exactly replicas x n_micro x mp x L, the AdamW
    launches one a slice (``zero_slice_count``); the parameter, gradient
    and state bytes summed over the positions are exactly
    ``zero_bytes_want``; after the last step the levels' gathered weights
    and optimizer state are bit-equal, and ``p_g_os``'s peak memory is
    below ``os``'s; step 2 runs under the profiler.  Then
    :func:`_fleet_zero_card_vs_cpu`."""
    torch, sh = port["torch"], port["sharding"]
    t_phase = time.perf_counter()
    mp = FLEET_ZERO_HYBRID["mp_degree"]
    R = FLEET_ZERO_HYBRID["dp_degree"] * FLEET_ZERO_HYBRID["sharding_degree"]
    n_micro = FLEET_ZERO_PIPE["accumulate_steps"]
    devices = _mesh_devices(4 * R) if devices is None else list(devices)
    cards = sorted(set(devices))
    cfg = port["gpt_1p3b"](hidden_dropout=0.0, attention_dropout=0.0,
                           max_position_embeddings=1024,
                           use_tensor_parallel=True, use_flash_attention=True)
    L = cfg.num_layers
    # the largest slice: half of a word-table part, flat
    errs = {"adamw": _kept(port, _adamw_compare, port,
                           (cfg.vocab_size // mp * cfg.hidden_size // 2,),
                           "bfloat16", 500)}
    rng = np.random.RandomState(50)
    ids, labels = (torch.from_numpy(rng.randint(
        0, cfg.vocab_size, (FLEET_ZERO_BATCH, TRAIN_SEQ))).to(DEVICE)
        for _ in range(2))
    _set_mesh(port, None)
    ref = port["Layered"](cfg, device=DEVICE, dtype="bfloat16", seed=0)
    crit = port["Criterion"](cfg)
    ref_loss = 0.0
    rows = FLEET_ZERO_BATCH // n_micro
    for x, y in zip(ids.split(rows), labels.split(rows)):
        with _o1(port):
            loss = crit(ref(x), y) * (1.0 / n_micro)
        loss.backward()
        ref_loss += float(loss.detach())
    ref_grads = {k: p.grad for k, p in ref.named_parameters()}
    W = sum(t.numel() * t.element_size() for t in ref.parameters())
    # the pieces, slices and ties of a ZeRO model refer to each other (as
    # a ShardedParameter's parts do): a level's memory comes back at a
    # collection, which each level's base and peak wait for
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t_phase
    per = R * n_micro * mp * L
    n_slices = zero_slice_count(cfg, mp,
                                n=FLEET_ZERO_HYBRID["sharding_degree"])
    want = {"fwd": per, "dkv": per, "dq": per, "adamw": n_slices}
    runs = {}
    for level in FLEET_ZERO_LEVELS:
        # what the card holds for others (the unplaced model's gradients,
        # the earlier levels' state dicts): a level's own peak is above it
        outside = max(torch.cuda.memory_allocated(d) for d in cards)
        t0 = time.perf_counter()
        model, pl, opt = fleet_pipeline(
            port, cfg, devices, "bfloat16", 0, hybrid=FLEET_ZERO_HYBRID,
            pipe=FLEET_ZERO_PIPE)
        torch.cuda.synchronize()
        pipe_s = time.perf_counter() - t0
        model, opt, _ = sh.group_sharded_parallel(model, opt, level)
        held = sum(len(g["params"]) for g in opt.param_groups)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        for d in cards:
            torch.cuda.reset_peak_memory_stats(d)
        base = max(torch.cuda.memory_allocated(d) for d in cards)
        _reset_launches(port)
        cap = _ZeroCapture(port, opt, model)
        t0 = time.perf_counter()
        with _o1(port):
            losses = [float(model.train_batch((ids, labels), cap))]
        for d in cards:
            torch.cuda.synchronize(d)
        step1_s = time.perf_counter() - t0
        first = _launch_counts(port)
        rels = {k: ((cap.grads[_fleet_key(k, L)].to(g.device).float()
                     - g.float()).norm() / g.float().norm()).item()
                for k, g in ref_grads.items()}
        by_pos = cap.bytes
        cap.grads = None

        def step():
            with _o1(port):
                losses.append(float(model.train_batch((ids, labels), opt)))

        for _ in range(FLEET_ZERO_STEPS - 2):
            step()
        prof = _profiled_step_ms(port, step)
        _check(prof is not None,
               f"fleet zero {level}: the profiler saw no device activity")
        total = _launch_counts(port)
        peak = max(torch.cuda.max_memory_allocated(d) for d in cards) \
            - outside
        # whole copies on the card, for the levels' comparison
        after = {k: v.detach().clone() for k, v in pl.state_dict().items()}
        after_opt = {k: v.detach().clone() if isinstance(v, torch.Tensor)
                     else v for k, v in opt.state_dict().items()}
        worst = max(rels, key=rels.get)
        runs[level] = dict(losses=losses, first=first, total=total,
                           prof=prof, peak=peak, base=base - outside,
                           rels=rels, worst=worst, by_pos=by_pos,
                           after=after, after_opt=after_opt, held=held)
        loss_rel = abs(losses[0] - ref_loss) / abs(ref_loss)
        runs[level]["loss_rel"] = loss_rel
        print(f"[fleet_zero] GPT-3 1.3B bf16 (O1) through phase 48's recipe "
              f"and group_sharded_parallel(level={level!r}) at "
              f"{FLEET_ZERO_HYBRID}, {FLEET_ZERO_PIPE}, {FLEET_ZERO_BATCH} x "
              f"{TRAIN_SEQ}, positions on {[str(d) for d in devices]}: set-up "
              f"{build_s:.2f} s (the recipe {pipe_s:.2f} s, then "
              f"{held} slices in the optimizer); step 1 "
              f"loss {losses[0]!r} against the unplaced model's "
              f"{ref_loss!r} (relative {loss_rel:.3g}, tol "
              f"{MESH_LOSS_REL:.3g}); step 1 gradients relative norm max "
              f"{rels[worst]:.4g} ({worst}), median "
              f"{float(np.median(list(rels.values()))):.4g} (tol "
              f"{TRAIN_GRAD_NORM:.4g}); launches step 1 {first} (want "
              f"{want}), over {FLEET_ZERO_STEPS} steps {total}; step 1 "
              f"{1e3 * step1_s:.1f} ms host clock (with warm-up and the "
              f"gradient capture); step {FLEET_ZERO_STEPS} under the "
              f"profiler {prof[3]:.2f} ms host clock, device {prof[0]:.2f} "
              f"ms, busy {prof[2]:.3f} of it; losses {losses}; peak "
              f"{peak / 2**30:.3f} GiB ({peak} bytes above the {outside} "
              f"held for others; {base - outside} of it allocated when "
              f"step 1 began); state bytes by (r, s, i) at step 1 {by_pos}, "
              f"summed (params, grads, state) {_byte_totals(by_pos)} (want "
              f"{zero_bytes_want(level, W, R)}, W = {W})")
        del model, pl, opt, cap, step
        _set_mesh(port, None)
        port["fleet"].set_hybrid_communicate_group(None)
        gc.collect()
        torch.cuda.empty_cache()
    del ref_grads
    # the levels against the first (one level alone: tools/port_mesh_probe.py)
    a = runs[FLEET_ZERO_LEVELS[0]]
    same = all(b["losses"] == a["losses"]
               and _same_bits(a["after"], b["after"])
               and _same_bits(a["after_opt"], b["after_opt"])
               for b in runs.values())
    for run in runs.values():
        del run["after"], run["after_opt"]
    torch.cuda.empty_cache()
    print(f"[fleet_zero] after {FLEET_ZERO_STEPS} steps {FLEET_ZERO_LEVELS} "
          f"bit-equal (losses, gathered weights, optimizer state): {same}; "
          f"peaks {[r['peak'] for r in runs.values()]} bytes")
    for level, run in runs.items():
        _check(all(np.isfinite(run["losses"])),
               f"fleet zero {level}: non-finite losses {run['losses']}")
        _check(run["loss_rel"] <= MESH_LOSS_REL,
               f"fleet zero {level}: step 1's loss is off the unplaced "
               "model's")
        _check(run["rels"][run["worst"]] <= TRAIN_GRAD_NORM,
               f"fleet zero {level}: step 1's gradient of {run['worst']} is "
               f"off the unplaced model's")
        _check(all(run["first"][k] == want[k]
                   and run["total"][k] == FLEET_ZERO_STEPS * want[k]
                   for k in want) and run["held"] == n_slices,
               f"fleet zero {level}: launches {run['first']} / "
               f"{run['total']}, expected {want} a step")
        _check(_byte_totals(run["by_pos"]) == zero_bytes_want(level, W, R)
               and len(run["by_pos"]) == 4 * R,
               f"fleet zero {level}: state bytes {run['by_pos']}")
    _check(same, f"fleet zero: {FLEET_ZERO_LEVELS} part after "
           f"{FLEET_ZERO_STEPS} steps")
    if "os" in runs and "p_g_os" in runs:
        _check(runs["p_g_os"]["peak"] < runs["os"]["peak"],
               "fleet zero: p_g_os's peak is not below os's")
    cpu = _fleet_zero_card_vs_cpu(port, devices)
    print(f"[time] phase 50 {time.perf_counter() - t_phase:.1f} s "
          f"(the unplaced model {ref_s:.1f} s)")
    return dict(errs=errs, launches={lv: runs[lv]["total"]
                                     for lv in FLEET_ZERO_LEVELS},
                cpu_launches=cpu)


def _zero_run(port, cfg, devices, hybrid, level, batches, state,
              scaler=None, inject=None):
    """The 2-layer fp32 recipe (``fleet_pipeline``, seed 50) at ``hybrid``
    on ``devices`` with ZeRO at ``level`` (None: without), the weights
    ``state`` when given, one ``train_batch`` a batch (with ``scaler``;
    ``inject(opt)`` runs before the scaler unscales): the weights before
    (``init``), the step-1 gradients gathered, the losses, the weights and
    optimizer state after, the state bytes at step 1, the optimizer's
    tensor count and the card's launches."""
    torch, sh = port["torch"], port["sharding"]
    model, pl, opt = fleet_pipeline(port, cfg, devices, "float32", 50,
                                    hybrid=hybrid)
    if state is not None:
        pl.set_state_dict(state)
    # copies: a whole parameter's entry shares its storage
    init = {k: v.clone() for k, v in pl.state_dict().items()}
    if level is not None:
        model, opt, _ = sh.group_sharded_parallel(model, opt, level)
    if inject is not None:
        unscale = scaler.unscale_

        def unscale_(o):
            inject(opt)
            unscale(o)

        scaler.unscale_ = unscale_
    _reset_launches(port)
    cap = _ZeroCapture(port, opt, model)
    # the scaler steps the optimizer itself: no capture
    losses = [float(model.train_batch(
        b, opt if i or scaler is not None else cap, scaler=scaler))
        for i, b in enumerate(batches)]
    out = dict(
        grads={k: g.float().cpu() for k, g in (cap.grads or {}).items()},
        losses=losses, bytes=cap.bytes,
        weights={k: v.float().cpu() for k, v in pl.state_dict().items()},
        opt=_to_host(opt.state_dict()), launches=_launch_counts(port),
        held=sum(len(g["params"]) for g in opt.param_groups), init=init)
    del model, pl, opt, cap
    _set_mesh(port, None)
    port["fleet"].set_hybrid_communicate_group(None)
    return out


def _zero_stacked(port, cfg, devices, axes, batches, state):
    """The stacked GPT (``cfg``, fp32) on ``devices`` at mesh ``axes`` at
    ``p_g_os``, the weights ``state`` (numpy, by key) when given: the
    weights before (``init``), step 1's gathered gradients, then one
    ``FusedTrainStep`` a batch: the losses, the weights after, whether
    every copy is freed, the optimizer's slice count and the card's
    launches."""
    torch, sh = port["torch"], port["sharding"]
    dm = port["mesh"]
    dm.set_mesh(dm.build_mesh(axes, devices))
    model = port["GPT"](cfg, 1, dtype="float32", seed=50)
    if state is not None:
        model.load_jax_state(state)
    init = {k: v.cpu().numpy().copy() for k, v in model.state_dict().items()}
    opt = port["AdamW"](FLEET_LR, parameters=model.parameters(),
                        multi_precision=False)
    sh.group_sharded_parallel(model, opt, "p_g_os")
    _reset_launches(port)
    batches = [(i.to(devices[0]), t.to(devices[0])) for i, t in batches]
    ids, labels = batches[0]
    model(ids, labels=labels).backward()
    grads = {k: g.float().cpu() for k, g in sh.gathered_grads(model).items()}
    opt.clear_grad()
    step = port["FusedTrainStep"](lambda i, l: model(i, labels=l), opt)
    losses = [float(step(i, l)) for i, l in batches]
    out = dict(grads=grads, losses=losses,
               weights={k: v.float().cpu()
                        for k, v in model.state_dict().items()},
               launches=_launch_counts(port),
               held=sum(len(g["params"]) for g in opt.param_groups),
               freed=all(p.untyped_storage().nbytes() == 0
                         for p in model.parameters()), init=init)
    del model, opt, step
    dm.set_mesh(None)
    return out


def _fleet_zero_card_vs_cpu(port, devices):
    """Phase 50's 2-layer fp32 copy (:func:`_fleet_tiny`), TF32 off,
    MESH_CPU_STEPS ``train_batch`` steps a run: at FLEET_ZERO_HYBRID the
    CPU (``["cpu"] * 8``, without ZeRO) against the card without ZeRO
    (phase 48's tolerances and phase 47's weight rule), and the card at
    os, os_g and p_g_os bit-equal to the card without ZeRO (losses, step-1
    gradients, weights, optimizer state) with the state bytes of each
    level exactly ``zero_bytes_want``; the dp fallback
    (FLEET_ZERO_DP_HYBRID at p_g_os on the card against the CPU without
    ZeRO); ``GradScaler`` at os_g with an inf written into one slice's
    gradient: every position bit-unchanged, no AdamW launch; the stacked
    GPT at ``{"sharding": 2, "mp": 2}`` at p_g_os, card against CPU.
    Returns the card's launches by run."""
    torch = port["torch"]
    cfg = _fleet_tiny(port)
    rng = np.random.RandomState(150)
    batches = [tuple(torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                                  (8, 128)))
                     for _ in range(2)) for _ in range(MESH_CPU_STEPS)]
    t0 = time.perf_counter()
    cpu = _zero_run(port, cfg, ["cpu"] * 8, FLEET_ZERO_HYBRID, None, batches,
                    None)
    state = cpu["init"]
    card, out = {}, {}
    for level in (None, "os", "os_g", "p_g_os"):
        card[level] = _zero_run(port, cfg, devices, FLEET_ZERO_HYBRID, level,
                                batches, state)
    W = sum(v.numel() * v.element_size() for v in state.values())

    def compare(c, g):
        return _fleet_compare(
            port, {"cpu": c["grads"], DEVICE: g["grads"]},
            {"cpu": c["grads"], DEVICE: g["grads"]},
            {"cpu": c["losses"], DEVICE: g["losses"]},
            {"cpu": c["weights"], DEVICE: g["weights"]},
            FLEET_LR * MESH_CPU_STEPS)

    gnorm, gerr, loss_diff, (n_zero, n_all, over_zero, over_kept, bulk) = \
        compare(cpu, card[None])
    per_run = 2 * FLEET_PIPE["accumulate_steps"] * 2 * cfg.num_layers \
        * MESH_CPU_STEPS
    slices = zero_slice_count(cfg, 2)
    bits = {}
    for level, run in card.items():
        bits[level] = (run["losses"] == card[None]["losses"]
                       and _same_bits(run["grads"], card[None]["grads"])
                       and _same_bits(run["weights"], card[None]["weights"])
                       and _same_bits(run["opt"], card[None]["opt"]))
        out[f"zero_{level or 'none'}"] = run["launches"]
        _check(_byte_totals(run["bytes"]) == zero_bytes_want(level, W),
               f"fleet zero fp32 {level}: state bytes {run['bytes']}")
        _check(all(run["launches"][k] == per_run
                   for k in ("fwd", "dkv", "dq"))
               and run["launches"]["adamw"] == MESH_CPU_STEPS * slices
               and (level is None or run["held"] == slices),
               f"fleet zero fp32 {level}: launches {run['launches']}")
    # the dp fallback: ZeRO over dp
    dp_cpu = _zero_run(port, cfg, ["cpu"] * 8, FLEET_ZERO_DP_HYBRID, None,
                       batches, state)
    dp_card = _zero_run(port, cfg, devices, FLEET_ZERO_DP_HYBRID, "p_g_os",
                        batches, state)
    _, dgerr, dloss, drule = compare(dp_cpu, dp_card)
    out["zero_dp_fallback_p_g_os"] = dp_card["launches"]
    # GradScaler at os_g: an inf in one slice's gradient skips every
    # position
    scaler = port["amp"].GradScaler(init_loss_scaling=2.0 ** 8,
                                    device=DEVICE)
    seen = {}

    def inject(opt):
        held = [p for g in opt.param_groups for p in g["params"]]
        seen["before"] = [t.detach().clone() for t in held]
        seen["held"] = held
        held[len(held) // 2].grad.view(-1)[0] = float("inf")

    skip = _zero_run(port, cfg, devices, FLEET_ZERO_HYBRID, "os_g",
                     batches[:1], state, scaler=scaler, inject=inject)
    unchanged = all(torch.equal(skip["weights"][k], v.float().cpu())
                    for k, v in state.items()) and all(
        torch.equal(a, b) for a, b in zip(seen["before"], seen["held"]))
    out["zero_scaler_skip"] = skip["launches"]
    # the stacked GPT at {"sharding": 2, "mp": 2}
    axes = {"sharding": 2, "mp": 2}
    st_cpu = _zero_stacked(port, cfg, ["cpu"] * 4, axes, batches, None)
    st_card = _zero_stacked(port, cfg, devices[:4], axes, batches,
                            st_cpu["init"])
    _, sgerr, sloss, srule = compare(st_cpu, st_card)
    out["zero_stacked_p_g_os"] = st_card["launches"]
    both_s = time.perf_counter() - t0
    print(f"[fleet_zero_card_vs_cpu] 2 layers fp32 at {FLEET_ZERO_HYBRID} "
          f"({both_s:.1f} s all runs): card without ZeRO against the CPU: "
          f"step 1 gradient norm {gnorm:.4f}, max |card - cpu| / max |cpu| "
          f"{gerr!r} (tol {MESH_GRAD_REL}); losses cpu {cpu['losses']} card "
          f"{card[None]['losses']}, max diff {loss_diff!r} (tol "
          f"{TRAIN_LOSS_ATOL}); weights: {n_zero} of {n_all} elements zero "
          f"to rounding, their excess {over_zero!r}, the others' "
          f"{over_kept!r} (both <= 0), 99.9th percentile {bulk!r} (tol "
          f"1e-6); card levels bit-equal to the card without ZeRO {bits}; "
          f"state bytes summed {[_byte_totals(card[lv]['bytes']) for lv in card]}"
          f" (W = {W}); launches {[card[lv]['launches'] for lv in card]} "
          f"(want {per_run} flash, {MESH_CPU_STEPS * slices} adamw a run); "
          f"dp fallback at p_g_os against the CPU: gradients {dgerr!r}, "
          f"losses {dloss!r}, weights {drule}, launches {dp_card['launches']}"
          f"; the scaler's skipped step: weights unchanged {unchanged}, "
          f"launches {skip['launches']}, scale {scaler.get_loss_scaling()}; "
          f"stacked GPT at {axes} p_g_os against the CPU: gradients "
          f"{sgerr!r}, losses {sloss!r}, weights {srule}, copies freed "
          f"{st_card['freed']}, launches {st_card['launches']}")
    _check(gerr <= MESH_GRAD_REL and loss_diff <= TRAIN_LOSS_ATOL,
           "fleet zero card vs CPU: gradients or losses part")
    _check(n_zero <= MESH_ZERO_SHARE * n_all and over_zero <= 0
           and over_kept <= 0 and bulk <= 1e-6,
           "fleet zero card vs CPU: weights part")
    _check(all(bits.values()), f"fleet zero fp32: levels part {bits}")
    for name, (e, ld, rule) in {"dp fallback": (dgerr, dloss, drule),
                                "stacked": (sgerr, sloss, srule)}.items():
        nz, na, oz, ok, bk = rule
        _check(e <= MESH_GRAD_REL and ld <= TRAIN_LOSS_ATOL
               and nz <= MESH_ZERO_SHARE * na and oz <= 0 and ok <= 0
               and bk <= 1e-6, f"fleet zero {name}: card and CPU part")
    _check(unchanged and skip["launches"]["adamw"] == 0
           and scaler.get_loss_scaling() == 2.0 ** 7,
           "fleet zero: the scaler's skipped step moved a position")
    # the stacked model's flash: 2 replicas x 2 shards x L, over the
    # gradient pass and the steps
    st_flash = (MESH_CPU_STEPS + 1) * 2 * 2 * cfg.num_layers
    _check(st_card["freed"] and st_card["launches"]["adamw"]
           == MESH_CPU_STEPS * st_card["held"]
           and all(st_card["launches"][k] == st_flash
                   for k in ("fwd", "dkv", "dq")), "fleet zero stacked: "
           f"copies kept or launches {st_card['launches']}")
    _check(all(dp_card["launches"][k] == per_run
               for k in ("fwd", "dkv", "dq"))
           and dp_card["launches"]["adamw"] == MESH_CPU_STEPS * slices,
           f"fleet zero dp fallback: launches {dp_card['launches']}")
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 51: sequence parallelism with ring attention, the layered GPT
# ---------------------------------------------------------------------------

# GPT-3 1.3B at its published 2048 positions, batch SP_BATCH x SP_SEQ, with
# sequence_parallel on each mesh of SP_RUNS (name, axes), every position
# on one card; SP_STEPS steps each
SP_BATCH, SP_SEQ = 4, 2048
SP_RUNS = (("sp2", {"sp": 2}), ("sp2_mp2", {"sp": 2, "mp": 2}))
SP_STEPS = 2
SP_LR = 1e-4
# the flash kernels' blocks on that path: a part's S / sp = 1024 rows at
# the 16 heads, and at a head shard's 8 (bf16, causal and full)
SP_FLASH = ((SP_BATCH, 16, SP_SEQ // 2, 128), (SP_BATCH, 8, SP_SEQ // 2, 128))
# RingAttention against ring_attention_plain on the card: (sp, [B, S, N,
# D] of the whole sequence), bf16 operands, the plain version in fp32 on
# the same values
SP_RING_CASES = ((2, (SP_BATCH, SP_SEQ, 16, 128)),
                 (4, (SP_BATCH, 2 * SP_SEQ, 8, 128)))
# the Function against the plain ring, by relative norm over each
# output: O and the gradients round every block's partial to bf16 before
# the fp32 merge (~2^-9 of the norm, as one flash kernel's O against its
# plain version: FLASH_O_NORM); lse is fp32 on both sides.  A dropped,
# repeated or misplaced block parts them by O(1)
SP_RING_NORM = {"O": 2.0 ** -8, "lse": 1e-6, "dq": 2.0 ** -7,
                "dk": 2.0 ** -7, "dv": 2.0 ** -7}
# phase 51's 2-layer fp32 copy against the CPU: (name, axes), head_dim
# 64, every part a 128-multiple at batch 2 x SP_CPU_SEQ
SP_CPU_RUNS = (("sp2", {"sp": 2}), ("sp4", {"sp": 4}),
               ("sp2_mp2", {"sp": 2, "mp": 2}))
SP_CPU_SEQ = 512


def _sp_mesh(port, axes, devices=None):
    """The global mesh over ``axes`` (a dict), every position on one card
    (or on ``devices``); None clears it."""
    dm = port["mesh"]
    if axes is None:
        dm.set_mesh(None)
        return
    n = int(np.prod(list(axes.values())))
    dm.set_mesh(dm.build_mesh(dict(axes), _mesh_devices(n) if devices is None
                              else devices))


def _ring_compare(port, sp, shape, seed, devices=None):
    """``RingAttention`` on bf16 shards against ``ring_attention_plain`` in
    fp32 on the same values (O, lse, dQ, dK, dV by relative norm,
    SP_RING_NORM); each block pair counted once a kernel; shard ``r`` on
    ``devices[r]`` (default: all on the card).  Returns (max abs errors:
    forward, dK/dV, dQ; ms of the ring's forward and of the flash forward
    over the whole sequence, causal)."""
    torch, R, fa = port["torch"], port["ring"], port["fa"]
    b, s, n, d = shape
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=gen, device=DEVICE)
                   .to(torch.bfloat16) for _ in range(4))
    loc = s // sp
    devs = devices or [DEVICE] * sp

    def shards(t, dtype):
        return [x.to(dev, dtype).detach().requires_grad_(True)
                for x, dev in zip(t.split(loc, 1), devs)]

    def cut(t, dtype):
        return [x.to(dev, dtype) for x, dev in zip(t.split(loc, 1), devs)]

    pairs = sp * (sp + 1) // 2
    kq, kk, kv = (shards(t, torch.bfloat16) for t in (q, k, v))
    _reset_launches(port)
    res = R.RingAttention.apply(True, *kq, *kk, *kv)
    outs, lses = res[:sp], res[sp:]
    torch.autograd.backward(outs, cut(do, torch.bfloat16))
    for dev in set(devs):
        torch.cuda.synchronize(dev)
    counts = _launch_counts(port)
    pq, pk, pv = (shards(t, torch.float32) for t in (q, k, v))
    pouts, plses = R.ring_attention_plain(pq, pk, pv, True)
    torch.autograd.backward(pouts, cut(do, torch.float32))
    got = {"O": outs, "lse": lses, "dq": [t.grad for t in kq],
           "dk": [t.grad for t in kk], "dv": [t.grad for t in kv]}
    want = {"O": pouts, "lse": plses, "dq": [t.grad for t in pq],
            "dk": [t.grad for t in pk], "dv": [t.grad for t in pv]}
    errs, rels = {}, {}
    for name in got:
        a = torch.cat([x.detach().float().reshape(-1).to(DEVICE)
                       for x in got[name]])
        w = torch.cat([x.detach().float().reshape(-1).to(DEVICE)
                       for x in want[name]])
        _check(bool(torch.isfinite(a).all()), f"ring sp={sp}: {name} not "
               "finite")
        errs[name] = (a - w).abs().max().item()
        rels[name] = ((a - w).norm() / w.norm()).item()
    scale = 1.0 / d ** 0.5
    def ring_fwd(i):
        return R.RingAttention.apply(
            True, *[x.detach() for x in kq], *[x.detach() for x in kk],
            *[x.detach() for x in kv])

    if devices is None:
        ring_ms, _ = _time_ms(torch, ring_fwd, 10)
        clock = "device"
    else:
        # shards on several cards: the host clock over 10 calls, every
        # card synchronised at both ends
        ring_fwd(0)
        for dev in set(devs):
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for i in range(10):
            ring_fwd(i)
        for dev in set(devs):
            torch.cuda.synchronize(dev)
        ring_ms = 1e3 * (time.perf_counter() - t0) / 10
        clock = "host clock, the cards synchronised"
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    whole_ms, _ = _time_ms(torch, lambda i: fa.flash_attention_fwd(
        qh, kh, vh, True, scale), 10)
    where = "one card" if devices is None else f"shards on {devs}"
    print(f"[sequence_parallel] RingAttention sp={sp} {shape} bf16 causal "
          f"({where}) against ring_attention_plain (fp32): max abs "
          f"{ {k: round(v, 8) for k, v in errs.items()} }, relative norm "
          f"{ {k: float(f'{v:.4g}') for k, v in rels.items()} } (tol "
          f"{SP_RING_NORM}); launches {counts} (want {pairs} of each flash "
          f"kernel); forward {ring_ms:.4f} ms {clock} against the flash "
          f"forward over the whole sequence {whole_ms:.4f} ms")
    _check(all(counts[k] == pairs for k in ("fwd", "dkv", "dq")),
           f"ring sp={sp}: launches {counts}, expected {pairs} each")
    for name, rel in rels.items():
        _check(rel <= SP_RING_NORM[name], f"ring sp={sp}: {name} relative "
               f"norm {rel:.4g} over {SP_RING_NORM[name]}")
    return (max(errs["O"], errs["lse"]), max(errs["dk"], errs["dv"]),
            errs["dq"], ring_ms, whole_ms)


def _sp_run(port, name, axes, cfg, ids, labels, ref, devices=None):
    """One mesh of phase 51: GPT-3 1.3B bf16 with ``sequence_parallel`` on
    ``axes`` (``use_tensor_parallel`` at mp > 1), seed 0, AdamW through
    ``FusedTrainStep`` under O1 (as phases 48-50: the loss in fp32),
    SP_STEPS steps on one batch, every position on the card (or the mesh
    over ``devices``: the sp positions' cards of their own, each from 1
    on holding a tied copy).  Step 1's loss and gradients (captured
    before its update) against the unplaced model's (``ref``); exact
    launches a step; step 2 under the profiler; the copies equal their
    sources after the steps."""
    torch = port["torch"]
    sp, mp = axes["sp"], axes.get("mp", 1)
    cards = sorted({str(d) for d in devices or [DEVICE]})
    t0 = time.perf_counter()
    _sp_mesh(port, axes, devices)
    run_cfg = dataclasses.replace(cfg, use_tensor_parallel=mp > 1)
    model = port["Layered"](run_cfg, dtype="bfloat16", seed=0, **(
        {} if mp > 1 else {"device": devices[0] if devices else DEVICE}))
    _check(model.gpt.sequence_parts == sp, f"{name}: sequence parts "
           f"{model.gpt.sequence_parts}")
    n_copies = len(model.gpt.sequence_copies)
    _check(n_copies == (sp - 1 if devices else 0), f"{name}: {n_copies} "
           "sp copies")
    got = model.state_dict()
    same = set(got) == set(ref["state"]) and all(
        torch.equal(got[k], v) for k, v in ref["state"].items())
    del got
    _check(same, f"{name}: the weights are not the unplaced model's")
    opt = port["AdamW"](SP_LR, parameters=model.parameters(),
                        multi_precision=False)
    crit = port["Criterion"](run_cfg)
    step = port["FusedTrainStep"](lambda x, y: crit(model(x), y), opt,
                                  amp_level="O1")
    captured, apply = {}, opt.step

    def capturing(*args, **kwargs):
        if not captured:
            captured.update(port["sharding"].gathered_grads(model))
        return apply(*args, **kwargs)

    opt.step = capturing
    n_tensors = len(list(model.parameters()))
    build_s = time.perf_counter() - t0
    for d in cards:
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)
    _reset_launches(port)
    t0 = time.perf_counter()
    losses = [float(step(ids, labels))]
    for d in cards:
        torch.cuda.synchronize(d)
    step1_s = time.perf_counter() - t0
    first = _launch_counts(port)
    rels = _grad_rel_norms(captured, ref["grads"])
    worst = max(rels, key=rels.get)
    loss_rel = abs(losses[0] - ref["loss"]) / abs(ref["loss"])
    captured.clear()
    prof = _profiled_step_ms(port, lambda: losses.append(
        float(step(ids, labels))))
    _check(prof is not None, f"{name}: the profiler saw no device activity")
    total = _launch_counts(port)
    peaks = {d: torch.cuda.max_memory_allocated(d) / 2**30 for d in cards}
    peak = max(peaks.values()) * 2**30
    copies_equal = all(torch.equal(p, p.replica_of.to(p.device))
                       for p in model.parameters()
                       if getattr(p, "replica_of", None) is not None)
    L = cfg.num_layers
    want = {k: mp * L * sp * (sp + 1) // 2 for k in ("fwd", "dkv", "dq")}
    want["adamw"] = n_tensors
    print(f"[sequence_parallel] {name}: GPT-3 1.3B bf16 (O1), "
          f"sequence_parallel "
          f"on {axes} (use_tensor_parallel {mp > 1}), positions on "
          f"{devices or DEVICE} ({n_copies} tied sp copies), {SP_BATCH} x "
          f"{SP_SEQ}, {SP_STEPS} steps: set-up "
          f"{build_s:.2f} s; step 1 loss {losses[0]!r} against the unplaced "
          f"model's {ref['loss']!r} (relative {loss_rel:.3g}, tol "
          f"{MESH_LOSS_REL:.3g}); step 1 gradients relative norm max "
          f"{rels[worst]:.4g} ({worst}), median "
          f"{float(np.median(list(rels.values()))):.4g} (tol "
          f"{TRAIN_GRAD_NORM:.4g}); launches step 1 {first} (want {want}), "
          f"over {SP_STEPS} steps {total}; step 1 {1e3 * step1_s:.1f} ms "
          f"host clock (with warm-up and the gradient capture); step 2 "
          f"under the profiler {prof[3]:.2f} ms host clock, device "
          f"{prof[0]:.2f} ms, busy {prof[2]:.3f} of it; losses {losses}; "
          f"peak GiB by card "
          f"{ {d: round(v, 2) for d, v in peaks.items()} }; {n_tensors} "
          f"tensors; copies equal their sources after the steps "
          f"{copies_equal}")
    _check(all(np.isfinite(losses)), f"{name}: non-finite losses {losses}")
    _check(copies_equal, f"{name}: an sp copy parted from its source")
    _check(loss_rel <= MESH_LOSS_REL, f"{name}: step 1's loss is off the "
           "unplaced model's")
    _check(rels[worst] <= TRAIN_GRAD_NORM, f"{name}: step 1's gradient of "
           f"{worst} is off the unplaced model's ({rels[worst]:.4g})")
    _check(all(first[k] == want[k] and total[k] == SP_STEPS * want[k]
               for k in want), f"{name}: launches {first} / {total}, "
           f"expected {want} a step")
    del model, opt, step, crit
    _sp_mesh(port, None)
    torch.cuda.empty_cache()
    return dict(launches=total, host_ms=prof[3], device_ms=prof[0],
                busy=prof[2], peak=peak, loss_rel=loss_rel,
                grad_rel=rels[worst], step1_ms=1e3 * step1_s)


def phase_sequence_parallel(port, cards=None):
    """Phase 51: (a) the flash kernels at the ring's block shapes
    (SP_FLASH, causal and full) and ``RingAttention`` at SP_RING_CASES
    against their plain versions; (b) GPT-3 1.3B bf16 (dropout 0, 2048
    positions) with ``sequence_parallel`` at each mesh of SP_RUNS, held
    to the unplaced layered model on the same weights and batch
    (:func:`_sp_run`); (c) :func:`_sp_card_vs_cpu`.  With ``cards`` (a
    device a mesh position, in mesh order) the ring's shards and the
    meshes' positions lie on those cards, the sp positions on cards of
    their own."""
    torch = port["torch"]
    t_phase = time.perf_counter()
    errs = {"fwd": 0.0, "dkv": 0.0, "dq": 0.0}
    for i, (shape, causal) in enumerate(
            (s, c) for s in SP_FLASH for c in (True, False)):
        e = _kept(port, _flash_compare, port, "bfloat16", shape, causal,
                  510 + i)
        errs = {k: max(errs[k], x) for k, x in zip(errs, e)}
    # the Function's errors are against the fp32 ring, not a kernel's own
    # plain version: kept apart from the kernels' rows
    ring = {sp: _kept(port, _ring_compare, port, sp, shape, 520 + sp,
                      cards and cards[:sp])
            for sp, shape in SP_RING_CASES}
    kernels_s = time.perf_counter() - t_phase
    cfg = port["gpt_1p3b"](hidden_dropout=0.0, attention_dropout=0.0,
                           max_position_embeddings=2048,
                           sequence_parallel=True)
    rng = np.random.RandomState(51)
    ids, labels = (torch.from_numpy(rng.randint(
        0, cfg.vocab_size, (SP_BATCH, SP_SEQ))).to(DEVICE) for _ in range(2))
    t0 = time.perf_counter()
    _sp_mesh(port, None)
    model = port["Layered"](cfg, device=DEVICE, dtype="bfloat16", seed=0)
    _reset_launches(port)
    with _o1(port):
        loss = port["Criterion"](cfg)(model(ids), labels)
    loss.backward()
    base = _launch_counts(port)
    ref = dict(loss=loss.item(), state=model.state_dict(),
               grads={k: p.grad for k, p in model.named_parameters()})
    del model, loss
    torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t0
    print(f"[sequence_parallel] unplaced layered GPT-3 1.3B bf16 (O1) at "
          f"{SP_BATCH} x {SP_SEQ}: loss {ref['loss']!r}, launches of its "
          f"forward and backward {base} ({ref_s:.2f} s with the build; "
          f"kernel checks {kernels_s:.2f} s)")
    runs = {name: _sp_run(port, name, axes, cfg, ids, labels, ref,
                          cards and cards[:int(np.prod(list(axes.values())))])
            for name, axes in SP_RUNS}
    del ref
    torch.cuda.empty_cache()
    cpu = _sp_card_vs_cpu(port, cards)
    print(f"[time] phase 51 {time.perf_counter() - t_phase:.1f} s")
    return dict(errs=errs, runs=runs, cpu_launches=cpu, ring=ring)


def _sp_tiny(port, tp=False, **kw):
    """Phase 51's 2-layer fp32 copy (hidden 256, 4 heads: head_dim 64)."""
    return port["gpt_tiny"](hidden_size=256, num_heads=4, num_layers=2,
                            max_position_embeddings=SP_CPU_SEQ,
                            hidden_dropout=0.0, attention_dropout=0.0,
                            use_tensor_parallel=tp, **kw)


def _sp_tiny_run(port, cfg, axes, device, state, batches, cards=None):
    """The layered 2-layer copy with ``cfg`` on ``axes`` over ``device``
    positions (or over ``cards``, one a position; no mesh: None),
    ``state`` loaded: step 1's loss and gathered gradients, then an
    AdamW step and the next batch's loss."""
    torch = port["torch"]
    if axes is None:
        _sp_mesh(port, None)
    else:
        n = int(np.prod(list(axes.values())))
        _sp_mesh(port, axes, cards[:n] if cards else
                 [device if device == "cpu" else f"{device}:0"] * n)
    placed = axes is not None and cfg.use_tensor_parallel
    model = port["Layered"](cfg, **({} if placed else {
        "device": cards[0] if cards else device}))
    model.load_state_dict({k: v.to(model.device) for k, v in state.items()})
    crit = port["Criterion"](cfg)
    opt = port["AdamW"](SP_LR, parameters=model.parameters())
    (x, y), (x2, y2) = ((a.to(model.device), b.to(model.device))
                        for a, b in batches)
    loss = crit(model(x), y)
    loss.backward()
    grads = {k: g.float().cpu()
             for k, g in port["sharding"].gathered_grads(model).items()}
    opt.step()
    opt.clear_grad()
    with torch.no_grad():
        loss2 = crit(model(x2), y2)
    _sp_mesh(port, None)
    return loss.item(), loss2.item(), grads


def _sp_card_vs_cpu(port, cards=None):
    """Phase 51's 2-layer fp32 copy on the card (or with its mesh
    positions on ``cards``, one a position) against the CPU at each mesh
    of SP_CPU_RUNS (TF32 off): step 1's loss and gradients (within
    MESH_GRAD_REL of each tensor's largest), the loss after one AdamW
    step (TRAIN_LOSS_ATOL); the card's flash launches exactly mp x L x
    sp (sp + 1) / 2 of each kernel a forward and backward, and as many
    forward launches again for the second loss.  Then, on one card, the
    axes no model reads: sp without ``sequence_parallel`` and sep for the
    layered model, sep for the stacked GPT at pp 2 and for the fleet
    recipe at pp 2 x mp 2, each bit for bit its run without the axis.
    Returns the card's launches by run."""
    torch = port["torch"]
    t0 = time.perf_counter()
    rng = np.random.RandomState(151)
    batches = [tuple(torch.from_numpy(rng.randint(0, 1024, (2, SP_CPU_SEQ)))
                     for _ in range(2)) for _ in range(2)]
    base = port["Layered"](_sp_tiny(port), device="cpu", seed=5)
    state = {k: v.clone() for k, v in base.state_dict().items()}
    del base
    out, lines = {}, []
    for name, axes in SP_CPU_RUNS:
        mp = axes.get("mp", 1)
        cfg = _sp_tiny(port, mp > 1, sequence_parallel=True)
        cl, cl2, cg = _sp_tiny_run(port, cfg, axes, "cpu", state, batches)
        _reset_launches(port)
        gl, gl2, gg = _sp_tiny_run(port, cfg, axes, DEVICE, state, batches,
                                   cards)
        counts = _launch_counts(port)
        sp = axes["sp"]
        per = mp * cfg.num_layers * sp * (sp + 1) // 2
        # a forward and backward, then the next batch's forward
        want = {"fwd": 2 * per, "dkv": per, "dq": per}
        gerr = max(((gg[k] - g).abs().max() / g.abs().max()).item()
                   for k, g in cg.items())
        ldiff = max(abs(cl - gl), abs(cl2 - gl2))
        used = cards and cards[:int(np.prod(list(axes.values())))]
        lines.append(f"{name}{' on cards ' + str(used) if cards else ''}"
                     f": losses cpu {[cl, cl2]} card {[gl, gl2]} (max "
                     f"diff {ldiff!r}), gradients max |card - cpu| / max "
                     f"|cpu| {gerr!r}, launches {counts} (want {want})")
        _check(set(gg) == set(cg) and gerr <= MESH_GRAD_REL
               and ldiff <= TRAIN_LOSS_ATOL,
               f"sequence parallel card vs CPU {name}: gradients or losses "
               "part")
        _check(all(counts[k] == v for k, v in want.items()),
               f"sequence parallel card vs CPU {name}: launches {counts}")
        out[name] = {k: counts[k] for k in ("fwd", "dkv", "dq", "adamw")}
    if cards:
        print(f"[sequence_parallel_card_vs_cpu] 2 layers fp32, batch 2 x "
              f"{SP_CPU_SEQ} ({time.perf_counter() - t0:.1f} s): "
              + "; ".join(lines))
        torch.cuda.empty_cache()
        return out
    # axes no model reads, on the card: the run without the axis bit for
    # bit
    bits = {}
    for name, cfg, axes, without in (
            ("layered sp without sequence_parallel", _sp_tiny(port),
             {"sp": 2}, None),
            ("layered sep at mp 2", _sp_tiny(port, True),
             {"sep": 2, "mp": 2}, {"mp": 2})):
        a = _sp_tiny_run(port, cfg, axes, DEVICE, state, batches)
        b = _sp_tiny_run(port, cfg, without, DEVICE, state, batches)
        bits[name] = a[:2] == b[:2] and all(torch.equal(a[2][k], b[2][k])
                                            for k in b[2])
    cfg = _sp_tiny(port)
    stacked = []
    for axes in ({"pp": 2, "sep": 2}, {"pp": 2}):
        _sp_mesh(port, axes)
        m = port["GPT"](cfg, 2, device=_mesh_devices(1)[0], seed=5)
        x, y = (t.to(DEVICE) for t in batches[0])
        loss = m(x, labels=y)
        loss.backward()
        stacked.append((loss.detach(), [p.grad for p in m.parameters()]))
        del m
    _sp_mesh(port, None)
    bits["stacked sep at pp 2"] = torch.equal(stacked[0][0], stacked[1][0]) \
        and all(torch.equal(a, b) for a, b in zip(stacked[0][1],
                                                  stacked[1][1]))
    fleet = []
    fleet_batch = tuple(torch.from_numpy(rng.randint(0, 1024, (8, 128)))
                        .to(DEVICE) for _ in range(2))
    for hybrid in (dict(FLEET_HYBRID, sep_degree=2), FLEET_HYBRID):
        n = int(np.prod(list(hybrid.values())))
        model, pl, opt = fleet_pipeline(
            port, _fleet_tiny(port), _mesh_devices(n), "float32", 48,
            hybrid=hybrid)
        cap = _GradCapture(port, opt, pl)
        loss = model.train_batch(fleet_batch, cap)
        fleet.append((float(loss), cap.grads))
        del model, pl, opt, cap
        _sp_mesh(port, None)
        port["fleet"].set_hybrid_communicate_group(None)
    bits["fleet sep at pp 2 x mp 2"] = fleet[0][0] == fleet[1][0] and all(
        torch.equal(fleet[0][1][k], v) for k, v in fleet[1][1].items())
    print(f"[sequence_parallel_card_vs_cpu] 2 layers fp32, batch 2 x "
          f"{SP_CPU_SEQ} ({time.perf_counter() - t0:.1f} s): "
          + "; ".join(lines) + f"; the run without the axis bit for bit: "
          f"{bits}")
    _check(all(bits.values()), f"axes no model reads: {bits}")
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 52: generation and serving from phase 46's trained (1, 2, 2) model
# ---------------------------------------------------------------------------

# the kernels at the per-shard generation shapes (H / mp = 8 heads): the
# prefill's flash forward at the prompt's length, the decode kernel over
# the cache
MESH_GEN_FLASH = (GEN_BATCH, 8, GEN_PROMPT, 128)
MESH_GEN_DECODE = (GEN_BATCH, 8, GEN_MAX_SEQ, 128)
# the 2-layer fp32 copy, card against CPU, at these (dp, pp, mp); int8
# weights at the mp = 1 one
MESH_GEN_CPU_MESHES = ((1, 2, 2), (2, 2, 2), (1, 2, 1))
MESH_GEN_CPU_BATCH, MESH_GEN_CPU_PROMPT, MESH_GEN_CPU_NEW = 2, 40, 8
# the layered GPT's placement (phase 35's weights, use_tensor_parallel)
MESH_GEN_LAYERED_MP = 2
# the generate run under the profiler: a quarter of GEN_NEW (the
# profiler's teardown grows with its events, and the run has a budget)
MESH_GEN_PROFILED_NEW = GEN_NEW // 4
# the 2-layer copies' engine: one page a request (CLUSTER_PROMPT_LENS
# plus CLUSTER_NEW fit in 128) and prefill chunks of 32 tokens (the CPU
# half's plain ragged attention gathers every page of each token's table)
MESH_GEN_CPU_ENGINE = dict(num_slots=4, page_size=128, max_context=128,
                           prefill_token_budget=32)


def _gen_prompts(torch, vocab):
    """Phase 9's prompts (``generate_setup``'s draw)."""
    rng = np.random.RandomState(9)
    return torch.from_numpy(rng.randint(0, vocab, (GEN_BATCH, GEN_PROMPT))
                            ).to(DEVICE)


def _placed_generate(port, name, model, ref, ids, per_layer):
    """``generate()`` of the placed ``model`` against ``ref`` (the
    unplaced model carrying its weights) at phase 9's shape: exact flash
    and decode launches (``per_layer`` a layer: mp x L), tokens under the
    parity rule, logits by norm before any parting; timed on the host
    clock, then ``MESH_GEN_PROFILED_NEW`` tokens under the profiler.
    Returns (the reference's tokens and logits, the numbers)."""
    torch = port["torch"]
    cfg = model.config
    t0 = time.perf_counter()
    model.generate(ids, 1, **GEN_KW)                 # the prefill alone
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(port)
    t0 = time.perf_counter()
    out, logits = model.generate(ids, GEN_NEW, return_logits=True, **GEN_KW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launch_counts(port)
    peak = torch.cuda.max_memory_allocated()
    prof = _profiled_step_ms(port, lambda: model.generate(
        ids, MESH_GEN_PROFILED_NEW, **GEN_KW))
    model.clear_decode_cache()
    want, wlogits = ref.generate(ids, GEN_NEW, return_logits=True, **GEN_KW)
    ref.clear_decode_cache()
    L = per_layer * cfg.num_layers
    same, total = _parity(port, f"{name} generate vs the unplaced model",
                          list(out.cpu().numpy()), list(want.cpu().numpy()),
                          ref, GAP_BOUND["bfloat16"], "bfloat16")
    rel = ((logits[:, 0] - wlogits[:, 0]).norm()
           / wlogits[:, 0].norm()).item()
    err = (logits[:, 0] - wlogits[:, 0]).abs().max().item()
    decode_ms = 1e3 * (wall - prefill_s) / (GEN_NEW - 1)
    nums = dict(decode_ms=decode_ms, prefill_ms=1e3 * prefill_s,
                tps=GEN_BATCH * GEN_NEW / wall, peak=peak,
                device_ms=None if prof is None
                else prof[0] / MESH_GEN_PROFILED_NEW,
                busy=None if prof is None else prof[2], rel=rel, err=err,
                same=same, launches=launches)
    print(f"[mesh_generate] {name}: batch {GEN_BATCH} prompt {GEN_PROMPT} + "
          f"{GEN_NEW} new tokens: {1e3 * wall:.2f} ms, prefill "
          f"{1e3 * prefill_s:.2f} ms, mean decode {decode_ms:.3f} ms a token "
          f"(host clock), {nums['tps']:.1f} tokens/s; under the profiler "
          + ("no device activity" if prof is None else
             f"{prof[0] / MESH_GEN_PROFILED_NEW:.3f} ms of kernels a "
             f"generated token over {MESH_GEN_PROFILED_NEW} (prefill "
             f"included), busy {prof[2]:.3f} of {prof[3]:.2f} ms")
          + f"; launches {launches} (want flash {L}, decode "
          f"{L * (GEN_NEW - 1)}); prefill logits against the unplaced "
          f"model's: relative norm {rel:.4g}, max {err:.4g} (tol "
          f"{GEN_NORM:.4g}, {GEN_ATOL}); peak {peak / 2**30:.2f} GiB")
    _check(tuple(out.shape) == (GEN_BATCH, GEN_PROMPT + GEN_NEW)
           and bool(torch.isfinite(logits).all()),
           f"{name}: generate output shape / logits not finite")
    _check(launches["fwd"] == L and launches["decode"] == L * (GEN_NEW - 1)
           and not any(launches[k] for k in launches
                       if k not in ("fwd", "decode")),
           f"{name}: generate launches {launches}, expected flash forward "
           f"{L} and decode {L * (GEN_NEW - 1)}")
    _check(rel <= GEN_NORM and err <= GEN_ATOL,
           f"{name}: prefill logits off the unplaced model's ({rel}, {err})")
    _check(prof is not None, f"{name}: the profiler saw no device activity")
    return want, wlogits, nums


def _placed_serve(port, name, model, ref, kv_dtype, per_layer):
    """Phase 3's engine and traffic over the placed ``model``: every
    fused step launches the ragged kernel ``per_layer`` times a layer,
    every page comes back, the ids are the unplaced ``ref`` engine's
    under the parity rule.  Returns the numbers."""
    want = _single_outputs(port, ref, kv_dtype=kv_dtype)
    eng, rng = serve_engine(port, kv_dtype, model=model)
    f0 = eng.metrics()["fused_steps"]
    _reset_launches(port)
    per_step = []
    reqs, step_s, dt = serve_workload(port, eng, rng, per_step)
    counts = _launch_counts(port)
    m = eng.metrics()
    fused = m["fused_steps"] - f0
    tokens = sum(len(q.tokens) for q in reqs)
    L = per_layer * SERVE_LAYERS
    placed = eng.cache.groups is not None
    got = [q.output_ids() for q in reqs]
    free = eng.allocator.free_pages == eng.allocator.capacity
    eng.close()
    same, _ = _parity(port, f"{name} serve {kv_dtype} vs the unplaced "
                      "engine", got, want, ref, GAP_BOUND["bfloat16"],
                      kv_dtype)
    print(f"[mesh_serve] {name} {kv_dtype} pool: {len(reqs)} requests DONE, "
          f"{tokens} tokens in {dt:.3f} s: {tokens / dt:.1f} tokens/s; "
          f"{fused} fused steps, mean {1e3 * float(np.mean(step_s)):.2f} ms "
          f"(host clock); ragged launches {counts['ragged']} ({L} a step: "
          f"{sorted(set(per_step))}); pool {m['cache_bytes']} bytes placed "
          f"{placed}; ledger free {free}")
    _check(placed and free and fused == len(per_step)
           and set(per_step) == {L} and counts["ragged"] == fused * L
           and not any(v for k, v in counts.items() if k != "ragged"),
           f"{name} serve {kv_dtype}: launches a step {sorted(set(per_step))}"
           f" (want {L}), other kernels {counts}, placed {placed}, ledger "
           f"free {free}")
    return dict(tps=tokens / dt, step_ms=1e3 * float(np.mean(step_s)),
                fused=fused, launches=counts["ragged"], same=same, want=want)


def _mesh_gen_cpu(port):
    """The 2-layer fp32 copy (GPT-3 1.3B's width, TF32 off) placed on the
    card and on the CPU at each mesh of ``MESH_GEN_CPU_MESHES`` from the
    same weights: greedy generate and a serve of four prompts, tokens
    under the fp32 parity rule; at mp = 1 again with int8 weights and an
    int8 pool.  Returns the card's (flash, decode, ragged, int8 ragged)
    launches."""
    torch, dm = port["torch"], port["mesh"]
    cfg = port["gpt_1p3b"](num_layers=2, hidden_dropout=0.0,
                           attention_dropout=0.0, max_position_embeddings=512)
    rng = np.random.RandomState(52)
    ids = rng.randint(0, cfg.vocab_size,
                      (MESH_GEN_CPU_BATCH, MESH_GEN_CPU_PROMPT))
    prompts = [rng.randint(0, cfg.vocab_size, (n,))
               for n in CLUSTER_PROMPT_LENS]
    kw = MESH_GEN_CPU_ENGINE
    counts = dict(fwd=0, decode=0, ragged=0, ragged_int8=0)
    for axes in MESH_GEN_CPU_MESHES:
        n = int(np.prod(axes))
        models = {}
        for dev in ("cpu", DEVICE):
            names = ["cpu"] * n if dev == "cpu" else _mesh_devices(n)
            dm.set_mesh(dm.build_mesh(dict(zip(("dp", "pp", "mp"), axes)),
                                      names))
            models[dev] = port["GPT"](cfg, dtype="float32", seed=5).eval()
            dm.set_mesh(None)
        card, cpu = models[DEVICE], models["cpu"]
        card.load_state_dict(cpu.state_dict())
        runs = [("float32", None)] + ([("int8", "int8")] if axes[2] == 1
                                      else [])
        for kv, weights in runs:
            res = {}
            for dev, m in models.items():
                if weights:
                    port["qi8"].quantize_for_serving(m)
                _reset_launches(port)
                gen = m.generate(torch.from_numpy(ids).to(m.device),
                                 MESH_GEN_CPU_NEW, max_seq_len=128,
                                 cache_dtype="float32") if not weights \
                    else None
                eng = port["ServingEngine"](m, kv_dtype=kv, **kw)
                reqs, _, _ = _drive(port, eng, prompts, CLUSTER_NEW)
                eng.close()
                _all_done(port, f"mesh generate fp32 {axes} {dev}", reqs,
                          CLUSTER_NEW)
                res[dev] = (gen, [r.output_ids() for r in reqs])
                if dev == DEVICE:
                    c = _launch_counts(port)
                    counts["fwd"] += c["fwd"]
                    counts["decode"] += c["decode"]
                    counts["ragged_int8" if weights else "ragged"] += \
                        c["ragged"]
            bound = GAP_BOUND["int8_weights" if weights else "float32"]
            if not weights:
                _parity(port, f"mesh generate 2 layers fp32 {axes}, card vs "
                        "CPU", list(res[DEVICE][0].cpu().numpy()),
                        list(res["cpu"][0].numpy()), card, bound, "float32")
            _parity(port, f"mesh serve 2 layers {kv} pool "
                    f"{'int8 weights ' if weights else ''}{axes}, card vs "
                    "CPU", res[DEVICE][1], res["cpu"][1], card, bound, kv)
        del models, card, cpu
        torch.cuda.empty_cache()
    return counts


def _same_grads(torch, a, b):
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


def phase_mesh_generate(port, kept, cpu=True):
    """Phase 52: phase 46's trained (1, 2, 2) GPT-3 1.3B (``kept``) held
    against the unplaced model loaded with its ``state_dict()``:
    ``generate()`` (exactly mp x L flash and mp x L x (new - 1) decode
    launches), phase 10's paged step without a plan, phase 3's serve from
    a bf16 and an int8 pool (mp x L ragged launches a fused step); a
    training step after all of it gives the loss and gradients it gave
    before; then the layered GPT-3 1.3B at {"mp": 2} with
    ``use_tensor_parallel`` loaded from phase 35's model the same way; the
    2-layer fp32 copy against the CPU; the kernels at the per-shard
    shapes.  ``cpu=False`` leaves the 2-layer copy out.  Keeps in
    ``kept`` for phase 57 the unplaced twin (``"ref"``) and the layered
    models with the unplaced one's bf16 serve (``"layered"``).  Returns
    the numbers and the launches by path."""
    torch = port["torch"]
    t_phase = time.perf_counter()
    laps = [t_phase]

    def lap(what):
        """The seconds of each part of the phase, for the run's budget."""
        now = time.perf_counter()
        print(f"[time] phase 52 {what} {now - laps[-1]:.1f} s")
        laps.append(now)

    errs = dict(
        fwd=_flash_ragged_case(port, "bfloat16", MESH_GEN_FLASH, True, 520),
        decode=_decode_case(port, "bfloat16", MESH_GEN_DECODE,
                            (1, GEN_PROMPT, GEN_PROMPT + 1,
                             GEN_PROMPT + GEN_NEW), 521))
    model, batches = kept["1x2x2"], kept["batches"]
    tm = model._train_mesh
    cfg = model.config
    _set_mesh(port, None)
    ref = port["GPT"](cfg, device=DEVICE, dtype="bfloat16", seed=1).eval()
    ref.load_state_dict(model.state_dict())
    before = _o1_grads(port, model, *batches[0])
    lap("kernel checks, the unplaced twin, a training step")
    ids = _gen_prompts(torch, cfg.vocab_size)
    out = {"stacked": {}, "layered": {}}
    launches = dict(fwd=0, decode=0, paged=0, ragged=0, ragged_int8=0)
    want, wlogits, out["stacked"]["generate"] = _placed_generate(
        port, "stacked (1, 2, 2)", model, ref, ids, tm.mp)
    launches["fwd"] += out["stacked"]["generate"]["launches"]["fwd"]
    launches["decode"] += out["stacked"]["generate"]["launches"]["decode"]
    launches["paged"] += phase_paged(port, model, ids, want, wlogits,
                                     per_step_launches=tm.mp * SERVE_LAYERS)
    lap("stacked generate and paged step")
    for kv in ("bfloat16", "int8"):
        r = out["stacked"][kv] = _placed_serve(
            port, "stacked (1, 2, 2)", model, ref, kv, tm.mp)
        launches["ragged" if kv == "bfloat16" else "ragged_int8"] += \
            r["launches"]
    lap("stacked serves")
    after = _o1_grads(port, model, *batches[0])
    same_grads = _same_grads(torch, after[1], before[1])
    print(f"[mesh_generate] training after generation and serving: "
          f"loss {after[0]!r} (before {before[0]!r}), gradients "
          f"bit-equal {same_grads}")
    _check(after[0] == before[0] and same_grads,
           "a training step after generation differs from one before it")
    del after
    del before, want, wlogits
    kept["ref"] = ref
    torch.cuda.empty_cache()
    # the layered GPT: phase 35's weights (its seed), placed at mp 2
    lcfg = port["gpt_1p3b"]()
    lref = port["Layered"](lcfg, device=DEVICE, dtype="bfloat16",
                           seed=0).eval()
    _sp_mesh(port, {"mp": MESH_GEN_LAYERED_MP})
    lmodel = port["Layered"](port["gpt_1p3b"](use_tensor_parallel=True),
                             dtype="bfloat16", seed=1).eval()
    _sp_mesh(port, None)
    lmodel.load_state_dict(lref.state_dict())
    lap("training after generation, the layered models")
    _, _, out["layered"]["generate"] = _placed_generate(
        port, "layered mp 2", lmodel, lref, ids, MESH_GEN_LAYERED_MP)
    launches["fwd"] += out["layered"]["generate"]["launches"]["fwd"]
    launches["decode"] += out["layered"]["generate"]["launches"]["decode"]
    for kv in ("bfloat16", "int8"):
        r = out["layered"][kv] = _placed_serve(
            port, "layered mp 2", lmodel, lref, kv, MESH_GEN_LAYERED_MP)
        launches["ragged" if kv == "bfloat16" else "ragged_int8"] += \
            r["launches"]
    kept["layered"] = (lmodel, lref, out["layered"]["bfloat16"].pop("want"))
    lap("layered generate and serves")
    cpu = _mesh_gen_cpu(port) if cpu else {}
    lap("2-layer copies, card and CPU")
    print(f"[time] phase 52 {time.perf_counter() - t_phase:.1f} s "
          f"(kernel errors {errs}; card launches {launches}, 2-layer card vs "
          f"CPU {cpu})")
    return dict(errs=errs, launches=launches, cpu_launches=cpu, runs=out)


# ---------------------------------------------------------------------------
# phase 53: batches placed over the mesh (io.DevicePrefetcher(sharding=))
# ---------------------------------------------------------------------------

# the sequence-parallel layered GPT fed (None, "sp") blocks: 2 layers of
# GPT-3 1.3B's width, bf16, at {"sp": 2}, a batch of 2 x 1024
PLACED_SP_LAYERS, PLACED_SP_BATCH, PLACED_SP_SEQ = 2, 2, 1024


def _placed_bytes(port, host, axis):
    """The bytes a prefetcher copies for the arrays ``host`` cut over
    ``axis`` of the global mesh: each block once on each distinct device
    of the positions that hold it (the batch once on one card)."""
    mesh = port["mesh"].get_mesh()
    k = mesh.axis_names.index(axis)
    n = mesh.devices.shape[k]
    held = sum(len({str(d) for d in
                    np.take(mesh.devices, [r], axis=k).flat})
               for r in range(n))
    return sum(a.nbytes // n * held for a in host)


def phase_placed_batches(port, kept):
    """Phase 53: phase 46's trained (2, 2, 2) model's O1 step fed phase
    6's batch whole and through ``DevicePrefetcher(sharding=("dp",))``:
    the loss and gathered gradients bit-equal, the bytes copied to the
    card the batch's once; then the sequence-parallel layered GPT at
    {"sp": 2} fed ``(None, "sp")`` blocks the same way.  Returns the
    flash launches of the placed-batch runs."""
    torch = port["torch"]
    t_phase = time.perf_counter()
    model, batches = kept["2x2x2"], kept["batches"]
    host = tuple(t.cpu().numpy() for t in batches[0])
    _set_mesh(port, (2, 2, 2))
    whole = _o1_grads(port, model, *batches[0])
    _reset_launches(port)
    with port["DevicePrefetcher"](iter([host]), sharding=("dp",)) as pf:
        ids, labels = next(pf)
        placed = _o1_grads(port, model, ids, labels)
        copied = pf.bytes_copied
    launches = _launch_counts(port)
    want_bytes = _placed_bytes(port, host, "dp")
    _set_mesh(port, None)
    blocks = sorted((idx, str(d)) for idx, d in ids.blocks)
    same = whole[0] == placed[0] and _same_grads(torch, whole[1], placed[1])
    print(f"[placed_batches] (2, 2, 2) O1 step fed ('dp',) blocks {blocks}: "
          f"loss {placed[0]!r} (whole batch {whole[0]!r}), gradients "
          f"bit-equal {same}; bytes copied {copied} (the batch "
          f"{sum(a.nbytes for a in host)}, each block once a device that "
          f"holds it: {want_bytes})")
    _check(same, "the placed batch's loss or gradients differ from the "
           "whole batch's")
    _check(copied == want_bytes, f"placed batch: {copied} bytes copied, "
           f"expected {want_bytes}")
    del whole, placed
    torch.cuda.empty_cache()
    cfg = port["gpt_1p3b"](num_layers=PLACED_SP_LAYERS,
                           sequence_parallel=True, hidden_dropout=0.0,
                           attention_dropout=0.0,
                           max_position_embeddings=PLACED_SP_SEQ)
    _sp_mesh(port, {"sp": 2})
    sp_model = port["Layered"](cfg, device=DEVICE, dtype="bfloat16", seed=4)
    crit = port["Criterion"](cfg)
    rng = np.random.RandomState(53)
    host = tuple(rng.randint(0, cfg.vocab_size,
                             (PLACED_SP_BATCH, PLACED_SP_SEQ))
                 for _ in range(2))

    def grads(i, lab):
        loss = crit(sp_model(i), lab)
        loss.backward()
        g = {k: p.grad.clone() for k, p in sp_model.named_parameters()}
        sp_model.zero_grad(set_to_none=True)
        return float(loss.detach()), g

    whole = grads(*(torch.from_numpy(a).to(DEVICE) for a in host))
    with port["DevicePrefetcher"](iter([host]), sharding=(None, "sp")) as pf:
        placed = grads(*next(pf))
        copied = pf.bytes_copied
    want_bytes = _placed_bytes(port, host, "sp")
    _sp_mesh(port, None)
    same = whole[0] == placed[0] and _same_grads(torch, whole[1], placed[1])
    print(f"[placed_batches] sp 2 layered, {PLACED_SP_LAYERS} layers, fed "
          f"(None, 'sp') blocks: loss {placed[0]!r} (whole {whole[0]!r}), "
          f"gradients bit-equal {same}; bytes copied {copied} (the batch "
          f"{sum(a.nbytes for a in host)}, each block once a device that "
          f"holds it: {want_bytes})")
    _check(same and copied == want_bytes, "sp 2 placed batch differs from "
           "the whole batch")
    del sp_model, whole, placed
    torch.cuda.empty_cache()
    print(f"[time] phase 53 {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 57: fault 11 on one card, then serving from the placed models with
# per-request LoRA, a speculative draft and the sharded engine
# ---------------------------------------------------------------------------

# fault 11's run: phase 50's 2-layer recipe at dp 2 x pp 2, replica 0's
# stages on the card and replica 1's on the CPU (the CPU half ~1 s)
SCALER_HYBRID = {"dp_degree": 2, "pp_degree": 2}
SCALER_DEVICES = (f"{DEVICE}:0", f"{DEVICE}:0", "cpu", "cpu")
# a profiled drive: this many of a path's prompts, this many new tokens
# (the profiler's teardown grows with its events)
PLACED_PROFILED = (4, 8)
# the agreeing drafts' drive (all but the target's last two layers, and
# its whole depth): this many of phase 28's prompts, this many new tokens
PLACED_AGREEING = (4, 16)


def phase_scaler_across_devices(port):
    """Phase 57a, fault 11: the recipe (``_zero_run``, no ZeRO) at
    ``SCALER_HYBRID`` over ``SCALER_DEVICES`` with a ``GradScaler`` on the
    card; replica 1's losses lie on its last stage's device (the CPU).  A
    step whose gradient there holds an inf (phase 50's skipped-step
    check) leaves every position of both replicas bit-unchanged, launches
    no AdamW and halves the scale; the scale's copy on each other device a
    loss lies on is the master's bits after it; a finite step then gives
    the all-card run's loss (``TRAIN_LOSS_ATOL``).  At the parent the
    scaler raised on the first loss off the card."""
    torch = port["torch"]
    t0 = time.perf_counter()
    cfg = _fleet_tiny(port)
    rng = np.random.RandomState(157)
    batches = [tuple(torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                                  (8, 128)))
                     for _ in range(2)) for _ in range(2)]
    devices = list(SCALER_DEVICES)
    # each replica's last stage: where its losses lie
    last = [torch.device(devices[1]), torch.device(devices[3])]
    scaler = port["amp"].GradScaler(init_loss_scaling=2.0 ** 8,
                                    device=DEVICE)
    seen = {}

    def inject(opt):
        held = [p for g in opt.param_groups for p in g["params"]]
        seen["before"] = [t.detach().clone() for t in held]
        seen["held"] = held
        there = [p for p in held if p.device == last[1]]
        seen["there"] = len(there)
        there[len(there) // 2].grad.view(-1)[0] = float("inf")

    skip = _zero_run(port, cfg, devices, SCALER_HYBRID, None, batches[:1],
                     None, scaler=scaler, inject=inject)
    state = skip["init"]
    unchanged = all(torch.equal(skip["weights"][k], v.float().cpu())
                    for k, v in state.items()) and all(
        torch.equal(a, b) for a, b in zip(seen["before"], seen["held"]))
    master = scaler._scale
    copies = {str(d): torch.equal(c.cpu(), master.cpu())
              for d, c in scaler._copies.items()}
    want_copies = sorted({str(d) for d in last if d != master.device})
    skipped_scale = scaler.get_loss_scaling()
    runs = {}
    for name, devs in (("mixed", devices), ("card", _mesh_devices(4))):
        sc = port["amp"].GradScaler(init_loss_scaling=2.0 ** 8,
                                    device=DEVICE)
        runs[name] = _zero_run(port, cfg, devs, SCALER_HYBRID, None,
                               batches[1:], state, scaler=sc)
        runs[name]["scale"] = sc.get_loss_scaling()
    diff = abs(runs["mixed"]["losses"][0] - runs["card"]["losses"][0])
    print(f"[scaler_across_devices] fault 11: {cfg.num_layers}-layer recipe "
          f"at {SCALER_HYBRID} over {devices} ({time.perf_counter() - t0:.1f}"
          f" s): the step with an inf in one of replica 1's {seen['there']} "
          f"gradients on {last[1]}: weights unchanged {unchanged}, launches "
          f"{skip['launches']}, scale {skipped_scale} (from {2.0 ** 8}); the "
          f"scale's copies bit-equal to the master {copies}; a finite step "
          f"mixed {runs['mixed']['losses']} against the card "
          f"{runs['card']['losses']} (diff {diff!r}, tol {TRAIN_LOSS_ATOL}), "
          f"scales {runs['mixed']['scale']} and {runs['card']['scale']}")
    _check(unchanged and skip["launches"]["adamw"] == 0
           and skipped_scale == 2.0 ** 7 and seen["there"] > 0,
           "fault 11: the scaler's skipped step moved a position")
    _check(sorted(copies) == want_copies and all(copies.values()),
           f"fault 11: the scale's copies {copies}, want {want_copies}")
    _check(diff <= TRAIN_LOSS_ATOL
           and runs["mixed"]["scale"] == runs["card"]["scale"] == 2.0 ** 8,
           "fault 11: the mixed step parts from the card's")
    return skip["launches"]


def _steps_profiled(port, drive):
    """``drive()`` (returning its engine steps) under the profiler: (all
    kernels' ms a step, the ragged kernel's ms a step, busy share, steps),
    or None when the profiler saw no device activity."""
    box = {}
    prof = _profiled_step_ms(port, lambda: box.setdefault("n", drive()))
    if prof is None:
        return None
    n = box["n"]
    return prof[0] / n, prof[1] / n, prof[2], n


def _profiled_serve(port, eng, prompts, adapters=None):
    """A short drive of ``eng`` (``PLACED_PROFILED``) under the profiler
    (:func:`_steps_profiled`)."""
    n, new = PLACED_PROFILED
    return _steps_profiled(port, lambda: _drive(
        port, eng, prompts[:n], new, adapters and adapters[:n])[2])


def _placed_path(port, name, eng, prompts, adapters=None, draft=None,
                 new=SERVE_NEW_TOKENS, profile=True):
    """Phase 3's drive of ``eng`` (``prompts``, ``new`` tokens each, a
    warm-up first): the output ids, tokens/s, host ms a step, the
    engine's step counts and ragged launches (``draft``: the draft's
    apart, :func:`_count_draft`), and with ``profile`` a profiled short
    drive."""
    torch = port["torch"]
    eng.generate_batch([prompts[0][:64]], 2,
                       **({"adapter": adapters[0]} if adapters else {}))
    box = [0]
    if draft:
        _count_draft(port, eng, box)
    m0 = eng.metrics()
    _reset_launches(port)
    box[0] = 0
    reqs, dt, steps = _drive(port, eng, prompts, new, adapters)
    counts = _launch_counts(port)
    m = eng.metrics()
    d = {k: m[k] - m0[k] for k in ("fused_steps", "spec_verify_steps",
                                    "spec_draft_steps",
                                    "spec_proposed_tokens",
                                    "spec_accepted_tokens") if k in m}
    _all_done(port, name, reqs, new)
    _no_recovery(name, eng)
    tokens = len(reqs) * new
    out = dict(got=[r.output_ids() for r in reqs], tps=tokens / dt,
               step_ms=1e3 * dt / steps, steps=steps, draft=box[0],
               ragged=counts.pop("ragged"), other=counts, **d)
    prof = out["prof"] = (_profiled_serve(port, eng, prompts, adapters)
                          if profile else None)
    eng.close()
    torch.cuda.empty_cache()
    print(f"[placed_serving] {name}: {len(reqs)} requests DONE, "
          f"{out['tps']:.1f} tokens/s, {steps} steps, {out['step_ms']:.2f} "
          f"ms a step (host clock); {d}; ragged launches {out['ragged']}"
          + (f" (draft {out['draft']})" if draft else "")
          + ("" if not profile else
             "; the profiler saw no device activity" if prof is None else
             f"; a profiled drive of {PLACED_PROFILED[0]} requests x "
             f"{PLACED_PROFILED[1]} tokens: {prof[0]:.3f} ms of kernels a "
             f"step (ragged {prof[1]:.3f}), busy {prof[2]:.3f}, {prof[3]} "
             "steps"))
    return out


def _lora_parity(port, name, got, want, tenants, pool, base):
    """Each tenant's tokens of ``got`` against ``want`` under the parity
    rule; where a tenant's request parts, the gap is read from ``base``
    with the tenant's merged weights (the null adapter's from ``base``)."""
    for t in sorted(set(tenants), key=str):
        idx = [i for i, x in enumerate(tenants) if x == t]
        g, w = [got[i] for i in idx], [want[i] for i in idx]
        oracle = base
        if t is not None and any(not np.array_equal(a, b)
                                 for a, b in zip(g, w)):
            oracle = port["GPT"](base.config, device=DEVICE,
                                 dtype="bfloat16", seed=0)
            oracle.load_state_dict(pool.merged_state_dict(base, t))
        _parity(port, f"{name} adapter {t}", g, w, oracle,
                GAP_BOUND["bfloat16"], "bfloat16")


def _spec_held(port, name, runs, ref, mp, layers, depth):
    """The placed and unplaced speculative runs of :func:`_placed_path`
    (``runs``): each verify step ``mp x layers`` ragged launches placed
    (``layers`` unplaced), each draft step ``mp x depth`` (``depth``),
    nothing else launched, proposals made; the placed tokens against the
    unplaced ones under the parity rule (the gap read from ``ref``)."""
    want, got = runs["unplaced"], runs["placed (1, 2, 2)"]
    for g, per_layer in ((want, 1), (got, mp)):
        _check(g["spec_verify_steps"] == g["fused_steps"]
               and g["ragged"] - g["draft"] == g["fused_steps"] * per_layer
               * layers
               and g["draft"] == g["spec_draft_steps"] * per_layer * depth
               and not any(g["other"].values()) and g["spec_proposed_tokens"],
               f"{name}: launches {g['ragged']} (draft {g['draft']}) "
               f"against verify {g['spec_verify_steps']} and draft "
               f"{g['spec_draft_steps']} steps at {per_layer} x "
               f"({layers}, {depth})")
    _parity(port, f"{name} vs unplaced", got["got"], want["got"], ref,
            GAP_BOUND["bfloat16"], "bfloat16")


def phase_placed_serving(port, kept):
    """Phase 57b-d: phase 46's trained (1, 2, 2) GPT-3 1.3B (``kept``,
    placed) against its unplaced twin (phase 52's ``kept["ref"]``, loaded
    from its ``state_dict()``), each serving: phase 29's four adapters and
    traffic (every fused step mp x L ragged launches placed, L unplaced);
    phase 28's traffic speculatively with ``truncated_draft(model, 2)``
    (placed over the same mesh: a verify step mp x L launches, a draft
    step mp x 2), and short drives of it with drafts of L - 2 and L
    layers, which agree with the target often enough that verify steps
    commit accepted proposals (mp x depth a draft step; the whole depth
    must have some accepted); then the layered GPT-3 1.3B placed at mp 2 (phase 52's)
    through a ``ShardedServingEngine`` at (dp 1, mp 2) over the card twice
    against the same engine over the unplaced layered model (mp x L a
    replica step), after which the model has left its training mesh and
    refuses training.  Tokens under the parity rule against the unplaced
    runs.  Returns the ragged launches by path."""
    torch, s = port["torch"], port["serving"]
    se, spe = port["ServingEngine"], port["SpeculativeEngine"]
    t_phase = time.perf_counter()
    laps = [t_phase]

    def lap(what):
        now = time.perf_counter()
        print(f"[time] phase 57 {what} {now - laps[-1]:.1f} s")
        laps.append(now)

    model, ref = kept["1x2x2"], kept["ref"]
    tm, cfg = model._train_mesh, model.config
    L, vocab = cfg.num_layers, cfg.vocab_size
    launches = {}
    # 57b: per-request LoRA, phase 29's adapters and traffic
    pool = s.LoRAAdapterPool(cfg, num_adapter_pages=LORA_ADAPTERS,
                             rank=LORA_RANK, dtype="bfloat16", stacked=True,
                             device=DEVICE)
    names = [f"tenant{i}" for i in range(LORA_ADAPTERS)]
    for i, name in enumerate(names):
        pool.register(name, s.random_adapter(cfg, LORA_RANK,
                                             np.random.RandomState(290 + i)))
    prompts = _serve_prompts(np.random.RandomState(29), vocab)
    tenants = [names[i % 5] if i % 5 < LORA_ADAPTERS else None
               for i in range(len(prompts))]
    lora = {which: _placed_path(port, f"lora {which}", se(
        m, lora=pool, **_engine_kw()), prompts, tenants)
        for which, m in (("unplaced", ref), ("placed (1, 2, 2)", model))}
    want, got = lora["unplaced"], lora["placed (1, 2, 2)"]
    _check(want["ragged"] == want["fused_steps"] * L
           and got["ragged"] == got["fused_steps"] * tm.mp * L
           and not any(got["other"].values()),
           f"placed lora: launches {got['ragged']} for "
           f"{got['fused_steps']} fused steps (want {tm.mp} x {L} a step), "
           f"{got['other']}")
    _lora_parity(port, "placed lora vs unplaced", got["got"], want["got"],
                 tenants, pool, ref)
    launches["placed_lora"] = got["ragged"]
    del pool
    lap("LoRA")
    # 57c: speculative decoding, phase 28's traffic, drafts of 2 layers
    prompts = _serve_prompts(np.random.RandomState(28), vocab)
    _set_mesh(port, (tm.dp, tm.pp, tm.mp))
    draft = port["truncated_draft"](model, 2)
    _set_mesh(port, None)
    dm = draft._train_mesh
    _check(dm is not None and (dm.pp, dm.mp) == (tm.pp, tm.mp),
           f"the placed model's draft is placed at {dm}")
    spec = {which: _placed_path(port, f"speculative k {SPEC_K} {which}", spe(
        target, d, spec_k=SPEC_K, **_engine_kw()), prompts, draft=True)
        for which, target, d in (
            ("unplaced", ref, port["truncated_draft"](ref, 2)),
            ("placed (1, 2, 2)", model, draft))}
    _spec_held(port, "placed speculative", spec, ref, tm.mp, L, 2)
    launches["placed_speculative"] = spec["placed (1, 2, 2)"]["ragged"]
    del draft
    torch.cuda.empty_cache()
    # drafts that agree with the target: the verify step commits accepted
    # proposals (and rolls the others back); the whole depth must
    n, new = PLACED_AGREEING
    agree = {}
    for deep in (L - 2, L):
        _set_mesh(port, (tm.dp, tm.pp, tm.mp))
        draft = port["truncated_draft"](model, deep)
        _set_mesh(port, None)
        runs = agree[deep] = {which: _placed_path(
            port, f"speculative k {SPEC_K} draft of {deep} layers {which}",
            spe(target, d, spec_k=SPEC_K, **_engine_kw()), prompts[:n],
            draft=True, new=new, profile=False)
            for which, target, d in (
                ("unplaced", ref, port["truncated_draft"](ref, deep)),
                ("placed (1, 2, 2)", model, draft))}
        _spec_held(port, f"placed speculative, draft of {deep}", runs, ref,
                   tm.mp, L, deep)
        launches[f"placed_speculative_draft_{deep}"] = \
            runs["placed (1, 2, 2)"]["ragged"]
        del draft
        torch.cuda.empty_cache()
    for which, g in agree[L].items():
        _check(g["spec_accepted_tokens"] > 0,
               f"speculative {which}: the whole-depth draft's "
               f"{g['spec_proposed_tokens']} proposals, none accepted")
    torch.cuda.empty_cache()
    lap("speculative")
    # 57d: the sharded engine over the placed layered model
    lmodel, lref, lwant = kept.pop("layered")
    parts = list(lmodel.parameters())
    runs = {which: _sharded_run(port, f"placed_serving sharded {which}", m,
                                1, MESH_GEN_LAYERED_MP, lwant,
                                profile_short=True)
            for which, m in (("unplaced layered", lref),
                             ("placed layered mp 2", lmodel))}
    freed = all(p.untyped_storage().nbytes() == 0 for p in parts)
    ids = torch.from_numpy(np.random.RandomState(57).randint(
        0, vocab, (1, 16))).to(DEVICE)
    try:
        lmodel(ids)
        refused = False
    except NotImplementedError as e:
        refused = "queue 1, item 9" in str(e)
    print(f"[placed_serving] the sharded engine took the layered model off "
          f"its training mesh: placement {lmodel._train_mesh}, its "
          f"{len(parts)} parts freed {freed}; training it again refused "
          f"naming item 9: {refused}")
    _check(lmodel._train_mesh is None and freed and refused,
           "placed sharded: the training placement stayed or training ran")
    launches["placed_sharded"] = runs["placed layered mp 2"]["launches"]
    del lmodel, lref, parts
    torch.cuda.empty_cache()
    lap("sharded")
    nums = {"lora": lora, "speculative": spec, "agreeing draft": agree,
            "sharded": runs}
    print(f"[time] phase 57 {time.perf_counter() - t_phase:.1f} s "
          f"(launches {launches})")
    return launches, nums


# ---------------------------------------------------------------------------
# phase 54: a recompute whose backward spans the card and the CPU
# ---------------------------------------------------------------------------

# GPT-3 1.3B's MLP widths over a few tokens; the down projection cut by
# rows over cuda:0 and the CPU, as a tensor-parallel row split over two
# devices, so autograd runs the two halves' backward on its card thread
# and the CPU thread at once
RECOMPUTE_HIDDEN, RECOMPUTE_FFN, RECOMPUTE_TOKENS = 2048, 8192, 512
RECOMPUTE_TRIALS = 3


def recompute_cases(port):
    """(name, checkpoint(fn, *args)) of each of the port's checkpointing
    entries phase 54 drives."""
    ckpt = port["recompute"].checkpoint
    checkpointed = port["pp_spmd"].checkpointed
    recompute = port["fleet"].recompute
    return (("checkpoint", ckpt),
            ("pp_spmd.checkpointed full",
             lambda fn, *a: checkpointed(fn, None)(*a)),
            ("pp_spmd.checkpointed dots",
             lambda fn, *a: checkpointed(fn, "dots")(*a)),
            ("fleet.recompute", recompute))


def phase_recompute_across_devices(torch, cases, strict=True):
    """Phase 54: an MLP at GPT-3 1.3B width, its up projection on the card
    and its down projection cut by rows between ``cuda:0`` and the CPU,
    the CPU half's output brought back to the card and summed, under each
    checkpoint of ``cases``; ``RECOMPUTE_TRIALS`` backward passes each.
    A counter inside the function counts its calls: each backward must
    recompute once, and every gradient must equal the run without
    recompute.  ``strict=False`` records how each case ended instead of
    raising (a tree whose checkpoint is not guarded).  Returns {case:
    outcome}."""
    t_phase = time.perf_counter()
    H, F, T = RECOMPUTE_HIDDEN, RECOMPUTE_FFN, RECOMPUTE_TOKENS
    gen = torch.Generator().manual_seed(54)
    card = torch.device(DEVICE, 0) if DEVICE == "cuda" else DEVICE

    def param(shape, device, scale):
        return (torch.randn(shape, generator=gen) * scale).to(device) \
            .requires_grad_()

    x = param((T, H), card, 1.0)
    w1 = param((H, F), card, H ** -0.5)
    w2a = param((F // 2, H), card, F ** -0.5)
    w2b = param((F // 2, H), "cpu", F ** -0.5)
    g_out = torch.randn((T, H), generator=gen).to(card)
    calls = [0]

    def mlp(x):
        calls[0] += 1
        h = torch.nn.functional.gelu(x @ w1)
        a = h[:, :F // 2] @ w2a
        b = torch.tanh(h[:, F // 2:].to("cpu") @ w2b)
        return a + b.to(x.device)

    leaves = (x, w1, w2a, w2b)

    def run(ckpt):
        for t in leaves:
            t.grad = None
        calls[0] = 0
        y = mlp(x) if ckpt is None else ckpt(mlp, x)
        (y * g_out).sum().backward()
        torch.cuda.synchronize()
        return calls[0], [t.grad.clone() for t in leaves]

    _, ref = run(None)
    out = {}
    for name, ckpt in cases:
        record = []
        for trial in range(RECOMPUTE_TRIALS):
            t0 = time.perf_counter()
            try:
                n, grads = run(ckpt)
            except Exception as e:  # noqa: BLE001 (strict=False records it)
                if strict:
                    raise
                record.append(f"stopped: {type(e).__name__}: "
                              f"{str(e).splitlines()[0][:160]}")
                continue
            ms = (time.perf_counter() - t0) * 1e3
            bitwise = all(torch.equal(a, b) for a, b in zip(grads, ref))
            rel = max(_rel(a, b) for a, b in zip(grads, ref))
            record.append(f"recomputes {n - 1}, gradients bit-equal "
                          f"{bitwise} (max relative norm {rel:.3g}), "
                          f"{ms:.1f} ms")
            print(f"[recompute] {name} trial {trial}: {record[-1]}")
            if strict:
                _check(n - 1 == 1, f"{name}: {n - 1} recomputes in one "
                       "backward, expected 1")
                _check(bitwise, f"{name}: gradients differ from the run "
                       f"without recompute (relative norm {rel:.3g})")
        out[name] = record
        if not strict:
            print(f"[recompute] {name}: {record}")
    print(f"[recompute] torch {torch.__version__}, MLP {T} x {H} -> {F} "
          f"-> {H}, down projection rows {F // 2} on {card} and {F // 2} on "
          f"the CPU, {RECOMPUTE_TRIALS} backward passes a case")
    print(f"[time] phase 54 {time.perf_counter() - t_phase:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 55: auto_parallel's annotations through a captured graph
# ---------------------------------------------------------------------------

AUTO_LAYERS = 2
AUTO_BATCH, AUTO_SEQ = TRAIN_BATCH, TRAIN_SEQ
AUTO_MESH = ((0, 1), (2, 3))                     # dp 2 x mp 2, one card
AUTO_LOAD_MESH = ((0, 1, 2, 3),)                 # dp 1 x mp 4
# the placed forward against the unplaced one on the card, relative
# Frobenius norm: bf16 products of half width summed in another order
# (the row-parallel partials), through two layers
AUTO_NORM = 2e-2
# the fp32 copy (hidden 256, 4 heads of 64, batch 4 x 128), placed against
# unplaced on the CPU and placed on the card against placed on the CPU
AUTO_CPU_NORM = 1e-5
AUTO_CPU_CFG = dict(hidden_size=256, num_heads=4, num_layers=AUTO_LAYERS,
                    max_position_embeddings=128)
AUTO_CPU_BATCH, AUTO_CPU_SEQ = 4, 128
AUTO_CKPT = "chip_smoke_ckpt/auto_parallel"


def megatron_placements(port, name):
    """The placement list over (dp, mp) of a layered GPT weight named
    ``name`` (``[in, out]`` layout): QKV and FFN-up column-parallel, out
    and FFN-down row-parallel, the rest replicated."""
    ap = port["auto_parallel"]
    if name.endswith(("qkv_proj.weight", "fc1.weight")):
        return [ap.Replicate(), ap.Shard(1)]
    if name.endswith(("qkv_proj.bias", "fc1.bias", "out_proj.weight",
                      "fc2.weight")):
        return [ap.Replicate(), ap.Shard(0)]
    return [ap.Replicate(), ap.Replicate()]


def _op_shapes(op):
    """A dispatch mode that records the first operand's shape of every
    call of ``op`` on real tensors (so it sees the executed graph's
    attention node, and not a capture's calls on fake tensors)."""
    from torch._subclasses.fake_tensor import is_fake
    from torch.utils._python_dispatch import TorchDispatchMode

    class OpShapes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.shapes = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is op and not is_fake(args[0]):
                self.shapes.append(tuple(args[0].shape))
            return func(*args, **(kwargs or {}))
    return OpShapes()


def _auto_run(port, body, mesh, ids, fake):
    """(run, placed weights, in specs) of ``body`` over ``mesh``: the
    weights placed by ``shard_tensor`` at Megatron placements, the ids on
    dp, the forward captured on fake tensors (no weights copied)."""
    torch, ap = port["torch"], port["auto_parallel"]
    fn, names, tensors = ap.parameters_as_inputs(body)
    placed = [ap.shard_tensor(t, mesh, megatron_placements(port, n))
              for n, t in zip(names, tensors)]
    pids = ap.shard_tensor(ids, mesh, [ap.Shard(0), ap.Replicate()])
    specs = [ap.DistSpec(tuple(p.sharding.spec)) for p in placed + [pids]]
    if fake:
        from torch._subclasses.fake_tensor import FakeTensorMode

        mode = FakeTensorMode()
        example = [mode.from_tensor(t) for t in tensors + [ids]]
    else:
        example = tensors + [ids]
    run = ap.apply_propagation(fn, mesh, specs, *example)
    return run, dict(zip(names, placed)), placed + [pids], fn, tensors


def _auto_products(port, run):
    """Each layer's [qkv, out, fc1, fc2] products' specs and the attention
    nodes' specs, in graph order."""
    prop = run.propagation
    prods, attn = [], []
    for n in prop.graph.graph.nodes:
        if n.op != "call_function":
            continue
        name = getattr(getattr(n.target, "_overloadpacket", None),
                       "__name__", "")
        if name in ("mm", "addmm"):
            prods.append(prop.var_specs[n])
        elif name == "flash_attention":
            attn.append(prop.var_specs[n][0])           # O of (O, lse)
    return prods, attn


def phase_auto_parallel(port):
    """Phase 55: the layered ``GPTModel`` at GPT-3 1.3B widths (2 layers,
    bf16, dropout 0) over ``ProcessMesh([[0, 1], [2, 3]], ["dp", "mp"])``,
    its four positions on the one card: the weights placed by
    ``shard_tensor`` at Megatron placements, the forward captured on fake
    tensors on the card and propagated; every product and attention node
    must carry the Megatron specs (QKV and FFN-up (dp, mp), out and
    FFN-down (dp, -) with an mp partial, attention (dp, mp, -, -));
    ``apply_propagation`` runs the graph per position and must launch the
    flash forward exactly positions x layers = 8 times, each at the local
    (4, 8, 1024, 128), and give the unplaced forward's output within
    ``AUTO_NORM``; a 2-layer fp32 copy placed on the CPU and on the card
    against the unplaced CPU forward within ``AUTO_CPU_NORM``; the placed
    weights saved by ``save_distributed_checkpoint`` and loaded under (dp
    1, mp 4) bit for bit; ``graph_cost``'s FLOPs the count by hand.
    Returns the flash forward's launches."""
    torch, ap, fa = port["torch"], port["auto_parallel"], port["fa"]
    t_phase = time.perf_counter()
    cfg = port["gpt_1p3b"](num_layers=AUTO_LAYERS, hidden_dropout=0.0,
                           attention_dropout=0.0)
    body = port["Layered"](cfg, device=DEVICE, dtype="bfloat16",
                           seed=55).gpt.eval()
    # process ids to visible cards, as the reference maps them to devices
    on = None if DEVICE == "cuda" else DEVICE
    mesh = ap.ProcessMesh(np.array(AUTO_MESH), ["dp", "mp"], device=on)
    n_pos = mesh.mesh.devices.size
    ids = torch.from_numpy(np.random.RandomState(55).randint(
        0, cfg.vocab_size, (AUTO_BATCH, AUTO_SEQ))).to(DEVICE)
    t0 = time.perf_counter()
    run, weights, args, fn, tensors = _auto_run(port, body, mesh, ids, True)
    t_capture = time.perf_counter() - t0
    prods, attn = _auto_products(port, run)
    # the CPU Megatron test's checks: the dims of every product, an mp
    # partial on the row-parallel ones (the pass lets partials flow on,
    # as the reference's does; the executor sums them where it must)
    want = [("dp", "mp"), ("dp", None)] * 2 * AUTO_LAYERS
    got = [tuple(p.dims) for p in prods]
    print(f"[auto_parallel] gpt_1p3b {AUTO_LAYERS} layers bf16 over "
          f"{mesh} on {DEVICE}: captured on fake tensors in {t_capture:.2f} "
          f"s ({len(run.propagation.graph.graph.nodes)} nodes, "
          f"{len(run.propagation.reshards)} reshards); products {prods}; "
          f"attention {[tuple(a.dims) for a in attn]}")
    _check(got == want and all("mp" in p.partial for p in prods[1::2]),
           f"auto_parallel: product specs {prods}, expected dims {want} and "
           "an mp partial on every row-parallel product")
    _check([tuple(a.dims) for a in attn] == [("dp", "mp", None, None)]
           * AUTO_LAYERS, f"auto_parallel: attention specs {attn}")
    torch.cuda.synchronize()
    _reset_launches(port)
    shapes = _op_shapes(fa.flash_attention_node)
    t0 = time.perf_counter()
    with shapes:
        out = run(*args)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches = _launch_counts(port)
    local = (AUTO_BATCH // 2, cfg.num_heads // 2, AUTO_SEQ, cfg.head_dim)
    with torch.no_grad():
        ref = body(ids)
    rel = _rel(out.gather(), ref)
    print(f"[auto_parallel] executed in {t_run:.2f} s (host clock): flash "
          f"forward launches {launches['fwd']} (positions x layers = "
          f"{n_pos * AUTO_LAYERS}) at {sorted(set(shapes.shapes))}; output "
          f"{tuple(out.shape)} spec {out.sharding.spec} against the "
          f"unplaced forward: relative norm {rel:.3g} (bound {AUTO_NORM})")
    _check(launches["fwd"] == n_pos * AUTO_LAYERS, f"auto_parallel: "
           f"{launches['fwd']} flash launches, expected {n_pos * AUTO_LAYERS}")
    _check(shapes.shapes == [local] * (n_pos * AUTO_LAYERS),
           f"auto_parallel: attention at {shapes.shapes}, expected {local}")
    _check(all(v == 0 for k, v in launches.items() if k != "fwd"),
           f"auto_parallel: other launches {launches}")
    _check(rel <= AUTO_NORM, f"auto_parallel: relative norm {rel} against "
           "the unplaced forward")
    T, H = AUTO_BATCH * AUTO_SEQ, cfg.hidden_size
    flops = AUTO_LAYERS * (2 * T * H * (3 * H + H + 2 * cfg.ffn_size)
                           + 4 * AUTO_BATCH * AUTO_SEQ ** 2 * H)
    cost = ap.graph_cost(run.propagation.graph)
    print(f"[auto_parallel] graph_cost FLOPs {cost['flops']:.6g} (by hand "
          f"{flops:.6g}), bytes {cost['bytes']:.6g}")
    _check(cost["flops"] == flops, f"auto_parallel: graph_cost FLOPs "
           f"{cost['flops']}, by hand {flops}")
    del out, ref
    # the checkpoint: saved at (dp 2, mp 2), loaded under (dp 1, mp 4)
    t0 = time.perf_counter()
    ap.save_distributed_checkpoint(weights, AUTO_CKPT)
    prev = port["mesh"]._global_mesh
    try:
        ap.ProcessMesh(np.array(AUTO_LOAD_MESH), ["dp", "mp"],
                       device=on).activate()
        loaded = ap.load_distributed_checkpoint(AUTO_CKPT)
    finally:
        port["mesh"].set_mesh(prev)
        import shutil
        shutil.rmtree(AUTO_CKPT, ignore_errors=True)
    same = all(torch.equal(loaded[k].gather().to(t.device), t)
               for k, t in zip(weights, tensors))
    specs4 = {tuple(loaded[k].sharding.spec) for k in loaded}
    print(f"[auto_parallel] {len(weights)} placed weights saved at (dp 2, "
          f"mp 2) and loaded under (dp 1, mp 4) in "
          f"{time.perf_counter() - t0:.2f} s: bit-equal {same}, specs "
          f"{sorted(specs4)}")
    _check(same, "auto_parallel: the converter's round trip differs")
    del loaded, weights, args, run, body
    torch.cuda.empty_cache()
    # the fp32 copy: placed on the CPU and on the card against unplaced
    cpu_rel, card_rel = _auto_card_vs_cpu(port)
    print(f"[auto_parallel] fp32 copy {AUTO_CPU_CFG} at {AUTO_CPU_BATCH} x "
          f"{AUTO_CPU_SEQ}: placed on the CPU against unplaced {cpu_rel:.3g}, "
          f"placed on the card against placed on the CPU {card_rel:.3g} "
          f"(bound {AUTO_CPU_NORM})")
    _check(cpu_rel <= AUTO_CPU_NORM and card_rel <= AUTO_CPU_NORM,
           "auto_parallel: the fp32 copy differs")
    print(f"[time] phase 55 {time.perf_counter() - t_phase:.1f} s")
    return launches["fwd"]


def _auto_card_vs_cpu(port):
    torch, ap = port["torch"], port["auto_parallel"]
    cfg = port["gpt_tiny"](hidden_dropout=0.0, attention_dropout=0.0,
                           **AUTO_CPU_CFG)
    ids = torch.from_numpy(np.random.RandomState(56).randint(
        0, cfg.vocab_size, (AUTO_CPU_BATCH, AUTO_CPU_SEQ)))
    outs, state = {}, None
    for device in ("cpu", DEVICE):
        body = port["Layered"](cfg, device=device, dtype="float32",
                               seed=56).gpt.eval()
        if state is None:
            state = body.state_dict()
        else:
            body.load_state_dict(state)
        mesh = ap.ProcessMesh(np.array(AUTO_MESH), ["dp", "mp"],
                              device=device)
        run, _, args, fn, tensors = _auto_run(port, body, mesh,
                                              ids.to(device), False)
        outs[device] = run(*args).gather().cpu()
        if device == "cpu":
            with torch.no_grad():
                ref = body(ids)
    return _rel(outs["cpu"], ref), _rel(outs[DEVICE], outs["cpu"])


# ---------------------------------------------------------------------------
# phase 56: auto_parallel's Engine at config 4's widths
# ---------------------------------------------------------------------------

ENGINE_LAYERS = 2
ENGINE_BATCH, ENGINE_SEQ = 8, 1024
ENGINE_STEPS = 3
ENGINE_LR = 1e-4
# four mesh positions on the one card: the explicit one-card layout
ENGINE_DEVICES = ("cuda:0",) * 4
# the planned fit against an unplanned Engine on the same weights and
# batches: step 1's loss, then steps 2-3 (relative); every gradient after
# step 1 by relative norm (phase 46's bf16 mesh gradients were 0.0195 of
# the unplaced model's)
ENGINE_LOSS_REL = (5e-3, 2e-2)
ENGINE_GRAD_NORM = 2e-2
# the attention node's backward kernels (dK/dV, dQ) at the local shape
# against their plain versions on the node's lse and delta: max abs
# error, the bounds of phase 51's flash checks at a part's shapes; and
# the node's gradients against autograd of the plain forward (bf16)
# elementwise by FLASH_GRAD_TOL, phase 5's rule
ENGINE_BWD_ATOL = {"dk": 0.015625, "dv": 0.015625, "dq": 0.00391}
# the fp32 copy (AUTO_CPU_CFG, 4 x 128 tokens) planned on the CPU and on
# the card against each other and the unplanned CPU run: losses
# (relative) and gradients (relative norm)
ENGINE_CPU_TOL = 1e-5
# the copy's cluster: compute dominates its cost, as it does the 13B
# widths' on the H100 (a 1 TFLOP/s rate), so the planner picks the same
# (dp 2, mp 2) for the small model
ENGINE_CPU_FLOPS = 1e12
ENGINE_CKPT = "chip_smoke_ckpt/engine"


class _ConfigOnly:
    """A model the planner reads only the config of (the full 40-layer
    GPT-3 13B, which one card cannot hold)."""

    def __init__(self, cfg):
        self.config = cfg

    def parameters(self):
        return iter(())


def _first_grads(model, opt, eng=None):
    """Wrap ``opt.step`` so that its first call keeps a copy of every
    gradient of ``model`` (what step 1 applies), whole: under ``eng``'s
    plan gathered from the blocks or ZeRO slices where they landed;
    returns that dict."""
    kept, step = {}, opt.step
    named = list(model.named_parameters())

    def first(*a, **k):
        if not kept:
            placed = getattr(eng, "placement", None)
            if placed is not None:
                from paddle_tpu_torch.distributed.sharding import \
                    gathered_grads
                kept.update({n: g.detach().clone() for n, g in
                             gathered_grads(placed).items()
                             if g is not None})
            else:
                kept.update({n: p.grad.detach().clone() for n, p in named
                             if p.grad is not None})
        return step(*a, **k)
    opt.step = first
    return kept


def _engine_blocks_by_hand(eng, param_bytes, state_bytes, level=None):
    """The bytes each mesh position holds at rest under ``eng``'s plan,
    counted from the specs: each tensor's block (its elements over the
    cuts of its spec) at ``param_bytes`` and ``state_bytes`` an element,
    the state a ZeRO group's share at every level, the block too at
    ``p_g_os`` (every block here splits evenly over dp)."""
    placed = eng.placement
    mesh = placed.mesh
    dp = mesh.shape.get("dp", 1)
    params = state = 0
    for e in placed.entries.values():
        n = e.tensor.numel() // int(np.prod(e.sharding.cuts(e.tensor.shape)))
        params += param_bytes * n
        state += state_bytes * n
    if level is not None:
        state //= dp
    if level == "p_g_os":
        params //= dp
    return {tuple(int(x) for x in pos): {"params": params, "grads": 0,
                                         "state": state}
            for pos in sorted({p.position for e in placed.entries.values()
                               for p in e.blocks.parts})}


def _rel_norm(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def _engine_batches(torch, vocab, batch, seq, n, device, seed):
    """``n`` (inputs, next-token labels) batches of random ids."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = torch.from_numpy(rng.randint(0, vocab, (batch, seq + 1)))
        out.append((ids[:, :-1].contiguous().to(device),
                    ids[:, 1:].contiguous().to(device)))
    return out


def _engine(port, cfg, dtype, device, seed, devices=None, bf16_adamw=True,
            level=None):
    """(Engine, model, optimizer) over a fresh layered GPT of ``cfg``;
    ``level``: the Strategy's ZeRO stage of that name."""
    ap = port["auto_parallel"]
    model = port["Layered"](cfg, device=device, dtype=dtype, seed=seed)
    opt = port["AdamW"](learning_rate=ENGINE_LR,
                        parameters=model.parameters(),
                        multi_precision=not bf16_adamw)
    stage = {"os": 1, "os_g": 2, "p_g_os": 3}.get(level)
    strategy = ap.Strategy({"sharding": {"enable": True, "stage": stage}}
                           if stage else {})
    eng = ap.Engine(model=model, loss=port["Criterion"](cfg), optimizer=opt,
                    strategy=strategy, device=device, devices=devices)
    return eng, model, opt


def _engine_node_compare(port, shape):
    """The attention node's forward and backward on bf16 q, k, v at the
    local ``shape``: (max abs errors of O and of the dK, dV and dQ kernels
    against their plain versions on the node's lse and delta; how far the
    node's gradients exceed FLASH_GRAD_TOL against autograd of the plain
    forward on the same bf16 values, the worst of the three)."""
    torch, fa = port["torch"], port["fa"]
    (q, k, v), do = _qkv(torch, shape, "bfloat16", 56)
    b, n, s, _ = shape
    scale = 1.0 / shape[-1] ** 0.5
    kq, kk, kv = (t.detach().requires_grad_(True) for t in (q, k, v))
    out, lse = fa.flash_attention_node(kq, kk, kv, True, scale)
    out.backward(do)
    args = (q, k, v, do, lse.detach().view(b * n, s),
            fa.backward_delta(do, out.detach()), True, scale)
    pdk, pdv = fa.flash_attention_bwd_dkv_plain(*args)
    pdq = fa.flash_attention_bwd_dq_plain(*args)
    want = fa.flash_attention_plain(q, k, v, True, scale)[0]
    pq, pk, pv = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    fa.flash_attention_plain(pq, pk, pv, True, scale)[0].backward(do)
    torch.cuda.synchronize()
    errs = {n: (a.float() - b.float()).abs().max().item()
            for n, a, b in (("O", out, want), ("dk", kk.grad, pdk),
                            ("dv", kv.grad, pdv), ("dq", kq.grad, pdq))}
    _check(all(np.isfinite(list(errs.values()))), f"engine node: {errs}")
    over = max(_over(a, b, FLASH_GRAD_TOL["bfloat16"][:2])[1]
               for a, b in ((kq.grad, pq.grad), (kk.grad, pk.grad),
                            (kv.grad, pv.grad)))
    return errs, over


def _engine_ckpt_round_trip(port, eng, model, opt, fresh):
    """``eng``'s blocking ``save_checkpoint`` after its fit, loaded into
    ``fresh()`` (a new (Engine, model, optimizer), planned as ``eng`` is:
    the load cuts into its blocks): the position, the weights, both
    moments and the beta powers must come back bit for bit, read whole
    through the state dicts.  Returns the save's and the load's
    seconds."""
    torch = port["torch"]
    try:
        t0 = time.perf_counter()
        eng.save_checkpoint(ENGINE_CKPT, step=ENGINE_STEPS, blocking=True)
        t_save = time.perf_counter() - t0
        _, fmodel, fopt = feng = fresh()
        pos = feng[0].load_checkpoint(ENGINE_CKPT)
        t_load = time.perf_counter() - t0 - t_save
        sa, sb = model.state_dict(), fmodel.state_dict()
        same_w = sa.keys() == sb.keys() and all(
            torch.equal(sa[k], sb[k]) for k in sa)
        oa, ob = opt.state_dict(), fopt.state_dict()
        same_m = oa.keys() == ob.keys() and any(
            k.startswith("moment") for k in oa) and all(
            torch.equal(oa[k], ob[k]) for k in oa
            if k.startswith("moment")) and \
            (opt.beta1_pow, opt.beta2_pow) == (fopt.beta1_pow,
                                               fopt.beta2_pow)
    finally:
        import shutil
        shutil.rmtree(ENGINE_CKPT, ignore_errors=True)
    print(f"[engine] save_checkpoint (blocking) {t_save:.2f} s, "
          f"load_checkpoint into a fresh Engine {t_load:.2f} s: position "
          f"{pos}, weights bit-equal {same_w}, moments and beta powers "
          f"bit-equal {same_m}")
    _check(pos == {"epoch": 0, "step": ENGINE_STEPS} and same_w and same_m,
           "engine: the checkpoint round trip differs")
    return t_save, t_load


def _engine_plan_copy(port, eng, model, plan_mesh):
    """Plan the fp32 copy's ``eng`` over its four positions: the mesh
    must be ``plan_mesh``, the bf16 run's."""
    n = sum(p.numel() for p in model.parameters())
    best = eng.plan(batch=AUTO_CPU_BATCH, cluster=port["auto_parallel"]
                    .ClusterSpec(n_devices=4, hbm_bytes=8.0 * n,
                                 flops=ENGINE_CPU_FLOPS))
    _check(best.mesh == plan_mesh, f"engine fp32 copy: plan {best.mesh}, "
           f"the bf16 run's {plan_mesh}")


def _engine_fp32_copy(port, plan_mesh, devices, level=None):
    """The fp32 copy (at ZeRO ``level``, or without ZeRO): an unplanned
    Engine on the CPU (without ZeRO only), then the same plan's fit on
    ``["cpu"] * 4`` and on the card's ``devices`` from the same weights
    and batches, and without ZeRO the card's checkpoint round trip into a
    fresh planned Engine (:func:`_engine_ckpt_round_trip`).  Returns
    (worst loss and gradient differences, the card run's launches, the
    runs' losses)."""
    torch = port["torch"]
    cfg = port["gpt_tiny"](hidden_dropout=0.0, attention_dropout=0.0,
                           **AUTO_CPU_CFG)
    batches = {}
    runs, state = {}, None
    order = (("cpu", "cpu", ["cpu"] * 4), ("card", DEVICE, list(devices)))
    if level is None:
        order = (("unplanned", "cpu", None),) + order
    for name, device, devs in order:
        eng, model, opt = _engine(port, cfg, "float32", device, 56, devs,
                                  bf16_adamw=False, level=level)
        if state is None:
            state = {k: v.detach().clone() for k, v in
                     model.state_dict().items()}
        else:
            model.load_state_dict(state)
        if devs is not None:
            _engine_plan_copy(port, eng, model, plan_mesh)
        grads = _first_grads(model, opt, eng)
        batches.setdefault(device, _engine_batches(
            torch, cfg.vocab_size, AUTO_CPU_BATCH, AUTO_CPU_SEQ,
            ENGINE_STEPS, device, 57))
        _reset_launches(port)
        hist = eng.fit(batches[device], verbose=0)
        if device != "cpu":
            torch.cuda.synchronize()
        runs[name] = (hist["loss"], {k: g.cpu() for k, g in grads.items()},
                      _launch_counts(port))
        if name == "card" and level is None:
            def fresh():
                f = _engine(port, cfg, "float32", DEVICE, 57, devs,
                            bf16_adamw=False)
                _engine_plan_copy(port, f[0], f[1], plan_mesh)
                return f
            _engine_ckpt_round_trip(port, eng, model, opt, fresh)
        port["mesh"].set_mesh(None)
    worst = 0.0
    pairs = (("card", "cpu"),) if level else (
        ("cpu", "unplanned"), ("card", "unplanned"), ("card", "cpu"))
    for a, b in pairs:
        la, ga, _ = runs[a]
        lb, gb, _ = runs[b]
        worst = max([worst] + [abs(x - y) / abs(y) for x, y in zip(la, lb)]
                    + list(_grad_rel_norms(ga, gb).values()))
    return worst, runs["card"][2], {k: v[0] for k, v in runs.items()}


def phase_engine(port, devices=None):
    """Phase 56: auto_parallel's ``Engine`` at ``BASELINE.json`` config
    4's widths (GPT-3 13B: hidden 5120, 40 heads of 128, vocab 50304) at 2
    layers, bf16, dropout 0, seed 56.  ``Engine.cost`` ranks the full
    40-layer model over eight H100s (pure dp must be infeasible);
    ``Engine.plan`` over four positions (``devices``, default
    ``ENGINE_DEVICES``: the one card four times) with an HBM that makes
    pure dp infeasible must choose mp x pp > 1; ``Engine.fit`` trains 3
    steps of 8 x 1024 tokens through the propagation executor, against an
    Engine with no plan on the same weights and batches
    (``ENGINE_LOSS_REL``, ``ENGINE_GRAD_NORM``), with exactly positions x
    layers launches of each flash kernel a step at the local (8/dp, 40/mp,
    1024, 128); the node's backward kernels against the plain version
    (``ENGINE_BWD_ATOL``); the plan places the model (each position its
    own blocks, no whole copy of a cut tensor, one bf16 AdamW launch a
    block, the bytes a position holds at rest the count by hand); ``evaluate`` and ``predict``
    through the executor against the unplanned Engine's; the fp32 copy
    planned on the CPU and on the card (``ENGINE_CPU_TOL``), and the
    card's ``save_checkpoint``/``load_checkpoint`` into a fresh planned
    Engine bit for bit (at the copy's widths: the bf16 model's 5.4 GB
    took ~45 s).  Returns the launches and errors."""
    torch, ap, fa = port["torch"], port["auto_parallel"], port["fa"]
    t_phase = time.perf_counter()
    devices = list(devices or ENGINE_DEVICES)
    full = port["gpt_13b"]()
    cost = ap.Engine(model=_ConfigOnly(full), device=DEVICE).cost(
        batch=ENGINE_BATCH, cluster=ap.ClusterSpec(n_devices=8))
    ranking = [(c["mesh"], round(1e3 * c["step_time"], 3),
                round(c["mem_bytes"] / 1e9, 2), c["feasible"])
               for c in cost["candidates"]]
    pure = next(c for c in cost["candidates"]
                if c["mesh"] == {"dp": 8, "mp": 1, "pp": 1})
    print(f"[engine] Engine.cost of GPT-3 13B (40 layers, batch "
          f"{ENGINE_BATCH} x {full.max_position_embeddings}) over 8 H100s "
          f"(ClusterSpec defaults): best {cost['best']}; ranking (mesh, "
          f"step ms, GB a card, feasible) {ranking}")
    _check(not pure["feasible"] and cost["candidates"][0]["feasible"]
           and cost["best"]["mp"] * cost["best"]["pp"] > 1,
           f"engine: pure dp of GPT-3 13B {pure}, best {cost['best']}")
    cfg = port["gpt_13b"](num_layers=ENGINE_LAYERS, hidden_dropout=0.0,
                          attention_dropout=0.0)
    batches = _engine_batches(torch, cfg.vocab_size, ENGINE_BATCH,
                              ENGINE_SEQ, ENGINE_STEPS, DEVICE, 56)
    # the reference: an Engine with no plan, eager on the card
    ref, ref_model, ref_opt = _engine(port, cfg, "bfloat16", DEVICE, 56)
    ref_grads = _first_grads(ref_model, ref_opt)
    ref_ms = []
    for batch in batches:
        t0 = time.perf_counter()
        ref_hist = ref.fit([batch], verbose=0)
        torch.cuda.synchronize()
        ref_ms.append(1e3 * (time.perf_counter() - t0))
    ref_ev = ref.evaluate([batches[0]], verbose=0)["eval_loss"]
    ref_logits = ref.predict([batches[0][0]])[0]
    del ref, ref_model, ref_opt
    torch.cuda.empty_cache()
    eng, model, opt = _engine(port, cfg, "bfloat16", DEVICE, 56, devices)
    n_params = sum(p.numel() for p in model.parameters())
    n_tensors = len(list(model.parameters()))
    prev = port["mesh"]._global_mesh
    try:
        best = eng.plan(batch=ENGINE_BATCH, cluster=ap.ClusterSpec(
            n_devices=4, hbm_bytes=8.0 * n_params))
        mesh = dict(best.mesh)
        positions = int(np.prod(list(mesh.values())))
        print(f"[engine] Engine.plan of the {ENGINE_LAYERS}-layer model "
              f"({n_params} parameters in {n_tensors} tensors) over "
              f"{devices} with hbm {8.0 * n_params:.6g} bytes: {mesh} "
              f"({eng._planned[1]} parameters placed), step "
              f"{1e3 * best.step_time:.3f} ms, {best.mem_bytes / 1e9:.3f} GB "
              f"a card (cost model)")
        _check(mesh["mp"] * mesh["pp"] > 1 and positions == len(devices),
               f"engine: plan {mesh}")
        # each position holds its blocks; no whole copy of a cut tensor
        n_blocks = sum(len(e.blocks) for e in eng.placement.entries.values())
        _check(n_blocks == positions * n_tensors
               and not eng.placement.whole_copies()
               and all(p.untyped_storage().nbytes() == 0
                       for p in model.parameters()),
               f"engine: {n_blocks} blocks, whole copies "
               f"{eng.placement.whole_copies()}")
        grads = _first_grads(model, opt, eng)
        local = (ENGINE_BATCH // mesh["dp"], cfg.num_heads // mesh["mp"],
                 ENGINE_SEQ, cfg.head_dim)
        want = positions * ENGINE_LAYERS
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        host_ms, per_step, prof = [], [], None
        for i, batch in enumerate(batches):
            _reset_launches(port)
            shapes = _op_shapes(fa.flash_attention_node)
            t0 = time.perf_counter()
            if i == 0:
                with shapes:
                    eng.fit([batch], verbose=0)
            elif i == len(batches) - 1:
                prof = _profiled_step_ms(
                    port, lambda: eng.fit([batch], verbose=0))
            else:
                eng.fit([batch], verbose=0)
            torch.cuda.synchronize()
            host_ms.append(1e3 * (time.perf_counter() - t0))
            per_step.append(_launch_counts(port))
            if i == 0:
                _check(shapes.shapes == [local] * want, f"engine: attention "
                       f"at {shapes.shapes}, expected {want} x {local}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        run = eng._execs["train"][1]
        reshards = run.propagation.reshards
        for i, c in enumerate(per_step):
            _check(all(c[k] == want for k in ("fwd", "dkv", "dq"))
                   and c["adamw"] == n_blocks
                   and not any(v for k, v in c.items()
                               if k not in ("fwd", "dkv", "dq", "adamw")),
                   f"engine: step {i + 1} launches {c}, expected {want} of "
                   f"each flash kernel and {n_blocks} AdamW")
        # bf16 blocks and two bf16 moments (multi_precision off)
        held = eng.placement.state_bytes(opt)
        by_hand = _engine_blocks_by_hand(eng, 2, 4)
        print(f"[engine] state_bytes_by_position at rest: {held}; by hand "
              f"{by_hand[next(iter(by_hand))]} at each position")
        _check(held == by_hand, "engine: the bytes a position holds differ "
               "from the count by hand")
        losses = eng.history["loss"]
        loss_rel = [abs(a - b) / abs(b) for a, b in zip(losses,
                                                        ref_hist["loss"])]
        grad_rel = _grad_rel_norms(grads, ref_grads)
        worst_grad = max(grad_rel.items(), key=lambda kv: kv[1])
        print(f"[engine] fit {ENGINE_STEPS} steps of {ENGINE_BATCH} x "
              f"{ENGINE_SEQ} over {mesh}: losses {losses} against the "
              f"unplanned Engine's {ref_hist['loss']} (relative "
              f"{[float(f'{x:.3g}') for x in loss_rel]}, bounds "
              f"{ENGINE_LOSS_REL}); step 1's gradients against the "
              f"unplanned: worst {worst_grad[0]} {worst_grad[1]:.4g} (bound "
              f"{ENGINE_GRAD_NORM}); the unplanned Engine's host ms a step "
              f"{[round(x, 2) for x in ref_ms]}; launches a step "
              f"{per_step[0]} (flash "
              f"{want} = positions x layers, each at {local}; AdamW "
              f"{n_blocks}, one a block); host ms a step {[round(x, 2) for x in host_ms]}"
              f" (step 1 with the capture and a dispatch-mode shape check, "
              f"step 3 under the profiler); capture and pass "
              f"{run.capture_seconds:.2f} s ({len(run.propagation.graph.graph.nodes)}"
              f" nodes, {len(reshards)} reshards, "
              f"{sum(r.bytes for r in reshards):.6g} bytes); peak "
              f"{peak:.2f} GiB"
              + ("" if prof is None else
                 f"; step 3 device kernel time {prof[0]:.3f} ms, busy "
                 f"{prof[2]:.3f} of its {prof[3]:.2f} ms wall"))
        _check(loss_rel[0] <= ENGINE_LOSS_REL[0]
               and max(loss_rel[1:]) <= ENGINE_LOSS_REL[1],
               f"engine: losses {losses} against {ref_hist['loss']}")
        _check(worst_grad[1] <= ENGINE_GRAD_NORM,
               f"engine: gradient {worst_grad}")
        del grads, ref_grads
        errs, over = _engine_node_compare(port, local)
        print(f"[engine] the attention node at {local} bf16 causal: its "
              f"kernels against their plain versions, max abs {errs} "
              f"(bounds {ENGINE_BWD_ATOL}); its gradients against autograd "
              f"of the plain forward, worst excess over FLASH_GRAD_TOL "
              f"{over:.3g} (<= 0 holds)")
        _check(all(errs[k] <= b for k, b in ENGINE_BWD_ATOL.items())
               and over <= 0, f"engine: node backward {errs}, {over}")
        ev = eng.evaluate([batches[0]], verbose=0)
        logits = eng.predict([batches[0][0]])[0]
        ev_rel = abs(ev["eval_loss"] - ref_ev) / abs(ref_ev)
        logits_rel = _rel_norm(logits, ref_logits)
        print(f"[engine] evaluate {ev} and predict {tuple(logits.shape)} "
              f"{logits.dtype} through the executor "
              f"({sorted(eng._execs)}): against the unplanned Engine's "
              f"{ref_ev}, relative {ev_rel:.3g} (bound "
              f"{ENGINE_LOSS_REL[1]}); logits by relative norm "
              f"{logits_rel:.3g} (bound {ENGINE_GRAD_NORM})")
        _check({"eval", "predict"} <= set(eng._execs)
               and ev_rel <= ENGINE_LOSS_REL[1]
               and logits_rel <= ENGINE_GRAD_NORM
               and tuple(logits.shape) == (ENGINE_BATCH, ENGINE_SEQ,
                                           cfg.vocab_size),
               f"engine: evaluate {ev}, predict {tuple(logits.shape)}")
        del logits, ref_logits
    finally:
        port["mesh"].set_mesh(prev)
    del eng, model, opt
    gc.collect()
    torch.cuda.empty_cache()
    worst, cpu_launches, cpu_losses = _engine_fp32_copy(port, mesh,
                                                        devices)
    print(f"[engine] fp32 copy {AUTO_CPU_CFG} at {AUTO_CPU_BATCH} x "
          f"{AUTO_CPU_SEQ}, {ENGINE_STEPS} steps over {mesh}: losses "
          f"{cpu_losses}; worst loss or gradient difference among the "
          f"planned CPU, planned card and unplanned CPU runs {worst:.3g} "
          f"(bound {ENGINE_CPU_TOL}); card launches {cpu_launches}")
    _check(worst <= ENGINE_CPU_TOL, "engine: the fp32 copy differs")
    print(f"[time] phase 56 {time.perf_counter() - t_phase:.1f} s")
    total = {k: sum(c[k] for c in per_step)
             for k in ("fwd", "dkv", "dq", "adamw")}
    return dict(launches=total, cpu_launches=cpu_launches,
                errs={"dkv": max(errs["dk"], errs["dv"]), "dq": errs["dq"],
                      "fwd": errs["O"]},
                host_ms=host_ms, ref_ms=ref_ms, prof=prof, peak=peak,
                mesh=mesh,
                losses=losses)


# ---------------------------------------------------------------------------
# phase 59: the Engine's plan under ZeRO at config 4's widths
# ---------------------------------------------------------------------------

ENGINE_ZERO_STEPS = 2
# os_g first: p_g_os's step-2 peak must fall below it
ENGINE_ZERO_LEVELS = ("os_g", "p_g_os")
ENGINE_ZERO_CPU_LEVELS = ("os", "os_g", "p_g_os")


def _engine_zero_run(port, cfg, level, devices, train, ref_hist, ref_grads,
                     n_tensors, layers):
    """One planned ``Engine.fit`` under ZeRO ``level`` for phase 59:
    (the engine, its optimizer, the step-2 peak bytes, host ms a step,
    launches a step); every check but the peak's made here."""
    torch, ap = port["torch"], port["auto_parallel"]
    before = torch.cuda.memory_allocated()
    eng, model, opt = _engine(port, cfg, "bfloat16", DEVICE, 59, devices,
                              level=level)
    n_params = sum(p.numel() for p in model.parameters())
    best = eng.plan(batch=ENGINE_BATCH, cluster=ap.ClusterSpec(
        n_devices=len(devices), hbm_bytes=8.0 * n_params))
    mesh = dict(best.mesh)
    positions = int(np.prod(list(mesh.values())))
    grads = _first_grads(model, opt, eng)
    want = positions * layers
    cards = sorted({torch.device(d).index or 0 for d in devices})
    peaks, host_ms, per_step = [], [], []
    for batch in train:
        for i in cards:
            torch.cuda.synchronize(i)
            torch.cuda.reset_peak_memory_stats(i)
        _reset_launches(port)
        t0 = time.perf_counter()
        eng.fit([batch], verbose=0)
        for i in cards:
            torch.cuda.synchronize(i)
        host_ms.append(1e3 * (time.perf_counter() - t0))
        # each card's peak of the step
        peaks.append([torch.cuda.max_memory_allocated(i) for i in cards])
        per_step.append(_launch_counts(port))
    rest = torch.cuda.memory_allocated()
    plan = eng.placement._zero_plan
    n_slices = sum(len(g) for rec in plan.pieces for g in rec.slices)
    held = eng.placement.state_bytes(opt)
    by_hand = _engine_blocks_by_hand(eng, 2, 4, level)
    losses = eng.history["loss"]
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref_hist)]
    grad_rel = _grad_rel_norms(grads, ref_grads)
    worst = max(grad_rel.items(), key=lambda kv: kv[1])
    print(f"[engine_zero] {level} over {mesh} on {devices}: losses {losses} "
          f"against the unplanned Engine's {ref_hist} (relative "
          f"{[float(f'{x:.3g}') for x in loss_rel]}, bounds "
          f"{ENGINE_LOSS_REL}); step 1's gradients worst {worst[0]} "
          f"{worst[1]:.4g} (bound {ENGINE_GRAD_NORM}); launches a step "
          f"{per_step} (flash {want}, AdamW one a slice: {n_slices}); host "
          f"ms a step {[round(x, 2) for x in host_ms]} (step 1 with the "
          f"capture and the slicing); each card's peak a step "
          f"{[[round(x / 2 ** 30, 3) for x in p] for p in peaks]} GiB "
          f"(cards {cards}); card 0 holds {before / 2 ** 30:.3f} GiB "
          f"before the Engine and {rest / 2 ** 30:.3f} at rest after "
          f"step 2; bytes at rest "
          f"{held}, by hand {by_hand[next(iter(by_hand))]} a position")
    _check(mesh == {"dp": 2, "mp": 2, "pp": 1} and plan.level == level,
           f"engine_zero: plan {mesh}, level {plan.level}")
    for i, c in enumerate(per_step):
        _check(all(c[k] == want for k in ("fwd", "dkv", "dq"))
               and c["adamw"] == n_slices == positions * n_tensors
               and not any(v for k, v in c.items()
                           if k not in ("fwd", "dkv", "dq", "adamw")),
               f"engine_zero: {level} step {i + 1} launches {c}, expected "
               f"{want} of each flash kernel and {n_slices} AdamW")
    _check(loss_rel[0] <= ENGINE_LOSS_REL[0]
           and max(loss_rel[1:]) <= ENGINE_LOSS_REL[1]
           and worst[1] <= ENGINE_GRAD_NORM,
           f"engine_zero: {level} losses {losses}, gradient {worst}")
    _check(held == by_hand, f"engine_zero: {level} bytes {held}, by hand "
           f"{by_hand}")
    _check(not eng.placement.whole_copies(), "engine_zero: a whole copy")
    return eng, opt, peaks[-1], host_ms, per_step


def phase_engine_zero(port, devices=None, layers=ENGINE_LAYERS,
                      levels=ENGINE_ZERO_LEVELS, cpu_levels=
                      ENGINE_ZERO_CPU_LEVELS):
    """Phase 59: phase 56's layered GPT (GPT-3 13B widths, ``layers``
    layers, bf16, dropout 0, seed 59) planned over four positions
    (``devices``, default ``ENGINE_DEVICES``) and trained 2 steps of 8 x
    1024 tokens by ``Engine.fit`` under the Strategy's sharding at each of
    ``levels`` over the placed blocks, against an Engine with no plan on
    the same weights and batches (:func:`_engine_zero_run`); at
    ``p_g_os`` the step-2 peak device memory must fall below ``os_g``'s,
    and ``evaluate`` and ``predict`` under the plan are held to the
    unplanned Engine's; then the fp32 copy at each of ``cpu_levels`` on
    the card against the CPU.  Returns the launches by level, errors
    and times."""
    torch = port["torch"]
    t_phase = time.perf_counter()
    devices = list(devices or ENGINE_DEVICES)
    cfg = port["gpt_13b"](num_layers=layers, hidden_dropout=0.0,
                          attention_dropout=0.0)
    batches = _engine_batches(torch, cfg.vocab_size, ENGINE_BATCH,
                              ENGINE_SEQ, ENGINE_ZERO_STEPS + 1, DEVICE, 59)
    train, held_out = batches[:-1], batches[-1]
    ref, ref_model, ref_opt = _engine(port, cfg, "bfloat16", DEVICE, 59)
    n_tensors = len(list(ref_model.parameters()))
    ref_grads = _first_grads(ref_model, ref_opt)
    ref_hist = list(ref.fit(train, verbose=0)["loss"])
    ref_ev = ref.evaluate([held_out], verbose=0)["eval_loss"]
    ref_logits = ref.predict([held_out[0]])[0]
    del ref, ref_model, ref_opt
    gc.collect()
    torch.cuda.empty_cache()
    peaks, launches, host = {}, {}, {}
    prev = port["mesh"]._global_mesh
    try:
        for level in levels:
            eng, opt, peaks[level], host[level], per_step = \
                _engine_zero_run(port, cfg, level, devices, train, ref_hist,
                                 ref_grads, n_tensors, layers)
            launches[level] = {k: sum(c[k] for c in per_step)
                               for k in ("fwd", "dkv", "dq", "adamw")}
            if level == "p_g_os":
                ev = eng.evaluate([held_out], verbose=0)["eval_loss"]
                logits = eng.predict([held_out[0]])[0]
                ev_rel = abs(ev - ref_ev) / abs(ref_ev)
                logits_rel = _rel_norm(logits, ref_logits)
                print(f"[engine_zero] p_g_os evaluate {ev} and predict "
                      f"through the executor: against the unplanned "
                      f"Engine's {ref_ev}, relative {ev_rel:.3g} (bound "
                      f"{ENGINE_LOSS_REL[1]}); logits by relative norm "
                      f"{logits_rel:.3g} (bound {ENGINE_GRAD_NORM})")
                _check({"eval", "predict"} <= set(eng._execs)
                       and ev_rel <= ENGINE_LOSS_REL[1]
                       and logits_rel <= ENGINE_GRAD_NORM,
                       f"engine_zero: evaluate {ev}, logits {logits_rel}")
                del logits
            port["mesh"].set_mesh(None)
            del eng, opt
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        port["mesh"].set_mesh(prev)
    del ref_logits, ref_grads
    gc.collect()
    torch.cuda.empty_cache()
    if "os_g" in peaks and "p_g_os" in peaks:
        print(f"[engine_zero] step-2 peak a card: p_g_os "
              f"{[round(x / 2 ** 30, 3) for x in peaks['p_g_os']]} GiB "
              f"against os_g's "
              f"{[round(x / 2 ** 30, 3) for x in peaks['os_g']]} GiB")
        _check(all(a < b for a, b in zip(peaks["p_g_os"], peaks["os_g"])),
               f"engine_zero: p_g_os peaks {peaks['p_g_os']} not below "
               f"os_g's {peaks['os_g']}")
    cpu_launches = {}
    for level in cpu_levels:
        worst, cpu_launches[level], cpu_losses = _engine_fp32_copy(
            port, {"dp": 2, "mp": 2, "pp": 1}, devices, level)
        print(f"[engine_zero] fp32 copy at {level}: losses {cpu_losses}; "
              f"card against CPU worst {worst:.3g} (bound "
              f"{ENGINE_CPU_TOL}); card launches {cpu_launches[level]}")
        _check(worst <= ENGINE_CPU_TOL,
               f"engine_zero: the fp32 copy at {level} differs")
    print(f"[time] phase 59 {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=launches, cpu_launches=cpu_launches, peaks=peaks,
                host_ms=host, ref_hist=ref_hist)


# ---------------------------------------------------------------------------
# phase 57e: a serving mesh over a stacked GPT under ZeRO
# ---------------------------------------------------------------------------

# GPT-3 1.3B widths at ZS_LAYERS layers, fp32 (TF32 off), dropout 0, the
# stacked GPT on ZS_AXES (every position on the card) under ZeRO
# ``p_g_os``, one AdamW step on a ZS_BATCH batch; then phase 29's traffic
ZS_LAYERS = 2
ZS_AXES = {"sharding": 2, "mp": 2}
ZS_BATCH = (2, 512)
ZS_LR = 1e-4


def phase_zero_serving(port):
    """Phase 57e: the stacked GPT at GPT-3 1.3B widths (ZS_LAYERS layers,
    fp32) placed on ZS_AXES, under ZeRO at ``p_g_os`` after one
    ``FusedTrainStep``, taken off its training mesh by
    ``ServingEngine(mesh=)`` (``leave_training_mesh``: the plan dissolved
    piece by piece into replica 0's copies, their whole weights gathered,
    every part, copy and slice freed), then phase 29's traffic
    (SERVE_REQUESTS x SERVE_NEW_TOKENS, phase 3's prompt lengths) against
    an unplaced twin loaded with the same ``state_dict()``, under the
    parity rule (fp32 cache, ``GAP_BOUND``): exactly L ragged launches a
    fused step on both, no storage left in the placement, the engine's
    peak above what the card held before it within one gathered copy
    (the twin's weight bytes) and one tensor's temporary (its largest;
    the pool, allocated after the placement is freed, is smaller than a
    copy), and a training forward afterwards raising naming ROADMAP.md
    queue 1, item 9.  Returns the ragged launches of both drives."""
    torch, dm = port["torch"], port["mesh"]
    t0 = time.perf_counter()
    cfg = port["gpt_1p3b"](num_layers=ZS_LAYERS, hidden_dropout=0.0,
                           attention_dropout=0.0)
    dm.set_mesh(dm.build_mesh(ZS_AXES, [DEVICE] * 4))
    try:
        model = port["GPT"](cfg, 1, dtype="float32", seed=57)
        opt = port["AdamW"](ZS_LR, parameters=model.parameters(),
                            multi_precision=False)
        port["sharding"].group_sharded_parallel(model, opt, "p_g_os")
        rng = np.random.RandomState(57)
        ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, ZS_BATCH)
                               ).to(DEVICE)
        step = port["FusedTrainStep"](lambda i, l: model(i, labels=l), opt)
        loss = float(step(ids, ids))
    finally:
        dm.set_mesh(None)
    plan = model._zero_plan
    _check(plan is not None and plan.level == "p_g_os" and np.isfinite(loss),
           f"zero serving: the model under ZeRO p_g_os (loss {loss})")
    placement = [p for g in opt.param_groups for p in g["params"]] + list(
        model.parameters()) + [c for rec in plan.pieces for c in rec.copies]
    twin = port["GPT"](cfg, device=DEVICE, dtype="float32", seed=58)
    twin.load_state_dict(model.state_dict())
    twin.eval()
    sizes = [v.numel() * v.element_size() for v in twin.state_dict().values()]
    whole = sum(sizes)
    prompts = _serve_prompts(np.random.RandomState(29), cfg.vocab_size)
    kw = _engine_kw(cache_dtype="float32")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    eng = port["ServingEngine"](model, mesh=(DEVICE,), **kw)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    pool = eng.cache.nbytes
    left = model._train_mesh is None and getattr(model, "_zero_plan",
                                                  None) is None
    freed = all(t.untyped_storage().nbytes() == 0 for t in placement)
    got = _placed_path(port, "zero serving p_g_os", eng, prompts,
                       profile=False)
    want = _placed_path(port, "zero serving unplaced twin",
                        port["ServingEngine"](twin, **kw), prompts,
                        profile=False)
    same, total = _parity(port, "zero serving", got["got"], want["got"], twin,
                          GAP_BOUND["float32"], "float32")
    L = cfg.num_layers
    model.train()
    try:
        model(ids[:1, :8], labels=ids[:1, :8])
        refused = False
    except NotImplementedError as e:
        refused = "queue 1, item 9" in str(e)
    model.eval()
    print(f"[zero_serving] the stacked GPT at GPT-3 1.3B widths, {L} "
          f"layers fp32, on {ZS_AXES} under ZeRO p_g_os, step loss "
          f"{loss!r}, left its training mesh through ServingEngine(mesh=) "
          f"({time.perf_counter() - t0:.1f} s): placement gone {left}, "
          f"{len(placement)} parts, copies and slices freed {freed}; peak "
          f"{peak} bytes above the {before} held before (one gathered copy "
          f"{whole}, its largest tensor {max(sizes)}, the pool {pool}: "
          f"{peak / whole:.3f} copies); "
          f"{same}/{total} requests token for token against the unplaced "
          f"twin; ragged launches {got['ragged']} over {got['fused_steps']} "
          f"fused steps (twin {want['ragged']} over {want['fused_steps']}; "
          f"want {L} a step); training afterwards refused {refused}")
    _check(left and freed, "zero serving: the placement or a slice stayed")
    _check(peak <= whole + max(sizes) and pool <= whole,
           f"zero serving: peak {peak} above one copy {whole} and its "
           f"largest tensor {max(sizes)} (the pool {pool})")
    _check(got["ragged"] == got["fused_steps"] * L
           and want["ragged"] == want["fused_steps"] * L
           and got["ragged"] > 0 and not any(got["other"].values()),
           f"zero serving: ragged launches {got['ragged']} / "
           f"{want['ragged']}")
    _check(refused, "zero serving: training after the serving mesh ran")
    del model, opt, step, twin, eng, placement
    torch.cuda.empty_cache()
    return got["ragged"] + want["ragged"]


# ---------------------------------------------------------------------------
# phase 58: dp replicas and ZeRO over a layered GPT whose sp positions hold
# copies of their own
# ---------------------------------------------------------------------------

# GPT-3 1.3B widths at SPR_LAYERS layers, fp32, dropout 0, a batch of
# SPR_BATCH x SPR_SEQ: one row a replica at dp 2, SPR_SEQ / 2 positions a
# part.  The mesh positions in dp-major order (dp r, sp s) -> SPR_DEVICES[2
# r + s]: each replica's sp position 1 a copy on the CPU beside the card's
# sp position 0 (which holds the joined head)
SPR_LAYERS = 2
SPR_BATCH, SPR_SEQ = 2, 1024
SPR_DEVICES = (f"{DEVICE}:0", "cpu", f"{DEVICE}:0", "cpu")
# (name, mesh axes, ZeRO level or None for DataParallel, steps).  The CPU
# position's fp32 work is most of the phase (a DataParallel step ~9 s, a
# ZeRO step ~3 s, on an 8-core host), so only the os run takes a second
# step, which the profiler reads; tools/port_mesh_probe.py --sp runs every
# run for 2 steps
SPR_RUNS = (("dp2_sp2", {"dp": 2, "sp": 2}, None, 1),
            ("sharding2_sp2_os", {"sharding": 2, "sp": 2}, "os", 2),
            ("sharding2_sp2_p_g_os", {"sharding": 2, "sp": 2}, "p_g_os", 1))
SPR_LR = 1e-4
# a copy on the CPU is stepped by the plain AdamW and its source on the
# card by the fused kernel, so without ZeRO they may part by rounding:
# held to SPR_COPY_REL of each tensor's largest value after each step.
# Under ZeRO every copy is gathered from the same slices: bit-equal
SPR_COPY_REL = 1e-6


def _spr_pairs(rows, on_card):
    """The flash launches of one layer's causal ring over one replica's sp
    positions ``rows`` (a device each): the forward and dQ on the query
    part's device, dK/dV on the key part's (``RingAttention``)."""
    n = {"fwd": 0, "dkv": 0, "dq": 0}
    for i in range(len(rows)):
        for j in range(i + 1):
            n["fwd"] += on_card(rows[i])
            n["dq"] += on_card(rows[i])
            n["dkv"] += on_card(rows[j])
    return n


def _spr_run(port, axes, level, devices, state, batch, steps):
    """One run of phase 58: the layered model of ``state`` with
    ``sequence_parallel`` on ``axes`` over ``devices`` (one a mesh
    position), under ``DataParallel`` (``level`` None) or
    ``group_sharded_parallel`` at ``level``, ``steps`` AdamW steps on
    ``batch``: the losses, step 1's gathered gradients, the copies'
    placement and distance from their sources after each step, each
    step's host ms (step 1's without the gathering of its gradients),
    the last step's device ms and busy share under the profiler where
    there are 2 steps or more, and the card's launches a step."""
    torch, dm, sh = port["torch"], port["mesh"], port["shards"]
    dm.set_mesh(dm.build_mesh(axes, list(devices)))
    cfg = port["gpt_1p3b"](num_layers=SPR_LAYERS, hidden_dropout=0.0,
                           attention_dropout=0.0,
                           max_position_embeddings=SPR_SEQ,
                           sequence_parallel=True)
    m = port["Layered"](cfg, device=devices[0], dtype="float32")
    m.load_state_dict(state)
    crit = port["Criterion"](cfg)
    model = port["DataParallel"](m) if level is None else m
    opt = port["AdamW"](SPR_LR, parameters=model.parameters(),
                        multi_precision=False)
    if level is not None:
        port["sharding"].group_sharded_parallel(model, opt, level)
    ids, labels = (t.to(devices[0]) for t in batch)
    copies = [p for p in model.parameters() if sh.replica_of(p) is not None]
    placed = {}
    for p in copies:
        key = sh.copy_key(sh.position_of(p))
        placed.setdefault(key, set()).add(p.device.type)
    cards = sorted({str(torch.device(d)) for d in devices
                    if torch.device(d).type != "cpu"})

    def sync():
        for d in cards:
            torch.cuda.synchronize(d)

    out = dict(losses=[], host_ms=[], copy_rel=[], launches=[],
               sp_copies=len(m.gpt.sequence_copies), placed=placed,
               n_copies=len(copies), prof=None,
               held=sum(len(g["params"]) for g in opt.param_groups))

    def step(capture):
        loss = crit(model(ids), labels)
        loss.backward()
        spent = 0.0
        if capture:
            sync()
            t0 = time.perf_counter()
            out["grads"] = {k: g.float().cpu() for k, g in
                            port["sharding"].gathered_grads(m).items()}
            spent = time.perf_counter() - t0
        opt.step()
        opt.clear_grad()
        out["losses"].append(loss.item())
        return spent

    for i in range(steps):
        _reset_launches(port)
        t0 = time.perf_counter()
        if i and i == steps - 1:
            out["prof"] = _profiled_step_ms(port, lambda: step(False))
            spent = 0.0
        else:
            spent = step(i == 0)
        sync()
        out["host_ms"].append(1e3 * (time.perf_counter() - t0 - spent))
        out["launches"].append(_launch_counts(port))
        rel = 0.0
        for p in copies:
            if not p.untyped_storage().nbytes():
                continue
            src = sh.replica_of(p)
            diff = (p.detach() - src.detach().to(p.device)).abs().max()
            rel = max(rel, diff.item() / src.detach().abs().max().item())
        out["copy_rel"].append(rel)
    del model, m, opt, copies
    dm.set_mesh(None)
    torch.cuda.empty_cache()
    return out


def phase_sp_replicas(port, devices=SPR_DEVICES, steps=None):
    """Phase 58: the flash kernels in fp32 at a part's blocks (SPR_BATCH
    rows at SPR_SEQ / 2 positions and 16 heads, causal and full) and the
    fp32 AdamW kernel at the word table's [50304, 2048] against their
    plain versions; then the layered GPT at GPT-3 1.3B widths
    (SPR_LAYERS layers, fp32, dropout 0, ``sequence_parallel``) on each
    mesh of SPR_RUNS (its steps, or ``steps`` for every run), its
    positions on ``devices`` (dp major: each replica's sp position 1 a
    copy on its own device), and for one step on the card alone (no
    copies), from the same weights and batch, TF32 off: step 1's loss
    (TRAIN_LOSS_ATOL) and gathered gradients (MESH_GRAD_REL of each
    tensor's largest) against the card-only step (one for both ZeRO
    levels, which phase 50 holds bit-equal on the card); every sp copy
    on its position's device; each copy within SPR_COPY_REL of its
    source after each step (bit-equal under ZeRO); the card's flash
    launches exactly what the ring's block pairs on the card give
    (``_spr_pairs``) for each layer and replica, and one AdamW launch for
    each tensor on the card a step (one a slice under ZeRO).  Prints
    host ms a step, and device ms and busy share of each run's last step
    where it has two.  Returns the kernels' max errors and the mixed
    runs' launches over their steps."""
    torch = port["torch"]
    t_phase = time.perf_counter()
    cfg = port["gpt_1p3b"](num_layers=SPR_LAYERS, hidden_dropout=0.0,
                           attention_dropout=0.0,
                           max_position_embeddings=SPR_SEQ)
    errs = {"fwd": 0.0, "dkv": 0.0, "dq": 0.0}
    for i, causal in enumerate((True, False)):
        shape = (SPR_BATCH, cfg.num_heads, SPR_SEQ // 2, cfg.head_dim)
        e = _kept(port, _flash_compare, port, "float32", shape, causal,
                  580 + i)
        errs = {k: max(errs[k], x) for k, x in zip(errs, e)}
    errs["adamw"] = _kept(port, _adamw_compare, port,
                          (cfg.vocab_size, cfg.hidden_size), "float32", 584)
    torch.cuda.empty_cache()
    base = port["Layered"](cfg, device=DEVICE, dtype="float32", seed=58)
    state = {k: v.clone() for k, v in base.state_dict().items()}
    n_body = len(list(base.parameters()))
    del base
    rng = np.random.RandomState(58)
    batch = tuple(torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                               (SPR_BATCH, SPR_SEQ)))
                  for _ in range(2))
    card = f"{DEVICE}:0"

    def on_card(d):
        return int(torch.device(d).type != "cpu")

    out, lines, refs = {}, [], {}
    for name, axes, level, n_steps in SPR_RUNS:
        n_steps = steps or n_steps
        R = axes.get("dp", 1) if level is None else 1
        key = (tuple(axes.items()), level is None)
        if key not in refs:
            refs[key] = _spr_run(port, axes, level, [card] * 4, state,
                                 batch, 1)
        ref = refs[key]
        got = _spr_run(port, axes, level, devices, state, batch, n_steps)
        gerr = max(((got["grads"][k] - g).abs().max() / g.abs().max())
                   .item() for k, g in ref["grads"].items())
        ldiff = abs(got["losses"][0] - ref["losses"][0])
        want = {k: 0 for k in ("fwd", "dkv", "dq")}
        for r in range(R):
            rows = devices[2 * r:2 * r + 2]
            for k, v in _spr_pairs(rows, on_card).items():
                want[k] += SPR_LAYERS * v
        # the card's tensors: each body or copy on a card, or the slices
        want["adamw"] = got["held"] if level is not None else sum(
            on_card(d) for d in devices[:2 * R]) * n_body
        firsts = got["launches"]
        sp_on = {key: types for key, types in got["placed"].items()
                 if key[1]}
        placed_ok = got["sp_copies"] == 1 and sp_on and all(
            types == {torch.device(devices[2 * key[0] + key[1]]).type}
            for key, types in sp_on.items()) and ref["sp_copies"] == 0
        # bit-equal under ZeRO, or where every copy's device is a card
        tol = 0.0 if level is not None or all(map(on_card, devices)) \
            else SPR_COPY_REL
        prof = got["prof"]
        lines.append(
            f"{name}: losses {got['losses']} against the card alone "
            f"{ref['losses']} (step 1 diff {ldiff!r}, tol "
            f"{TRAIN_LOSS_ATOL}); gradients max |mixed - card| / max |card| "
            f"{gerr!r} (tol {MESH_GRAD_REL}); {got['sp_copies']} sp copy a "
            f"replica, {got['n_copies']} copy tensors, sp positions by "
            f"(replica, sp) {sorted(sp_on)} on "
            f"{sorted({t for v in sp_on.values() for t in v})}; copies' "
            f"largest distance from their sources after each step "
            f"{got['copy_rel']} (tol {tol}); launches a step {firsts} "
            f"(want {want}); host ms a step {got['host_ms']} (card alone, "
            f"step 1: {ref['host_ms']})"
            + ("" if n_steps < 2 else
               f"; step {n_steps} under the profiler: "
               + ("no device activity" if prof is None else
                  f"device {prof[0]:.2f} ms, busy {prof[2]:.3f}, host "
                  f"{prof[3]:.1f} ms")))
        _check(all(np.isfinite(got["losses"])),
               f"sp replicas {name}: non-finite losses {got['losses']}")
        _check(gerr <= MESH_GRAD_REL and ldiff <= TRAIN_LOSS_ATOL,
               f"sp replicas {name}: gradients or losses part from the "
               "card alone")
        _check(placed_ok, f"sp replicas {name}: copies {got['placed']}")
        _check(all(r <= tol for r in got["copy_rel"]),
               f"sp replicas {name}: a copy parted from its source "
               f"{got['copy_rel']}")
        _check(all(c[k] == v for c in firsts for k, v in want.items()),
               f"sp replicas {name}: launches {firsts}, want {want} a step")
        _check(n_steps < 2 or prof is not None,
               f"sp replicas {name}: the profiler saw no device activity")
        out[name] = {k: sum(c[k] for c in firsts)
                     for k in ("fwd", "dkv", "dq", "adamw")}
    print(f"[sp_replicas] the layered GPT at GPT-3 1.3B widths, "
          f"{SPR_LAYERS} layers fp32, sequence_parallel, batch {SPR_BATCH} "
          f"x {SPR_SEQ}, positions {list(devices)} (dp major): "
          + "; ".join(lines))
    print(f"[time] phase 58 {time.perf_counter() - t_phase:.1f} s")
    return dict(errs=errs, launches=out)


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
    marks = [t_start]

    def mark(phases):
        """The seconds of a group of phases, for the run's budget."""
        now = time.perf_counter()
        print(f"[time] phases {phases} {now - marks[-1]:.1f} s "
              f"({now - t_start:.1f} s since the start)")
        marks.append(now)

    def timed(phase, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"[time] phase {phase} {time.perf_counter() - t0:.1f} s")
        return out

    phase_build(port)
    k = _kept(port, phase_kernels, port)
    launches, serve_tps = phase_serve(port)
    phase_card_vs_cpu(port)
    tk = _kept(port, phase_train_kernels, port)
    train_launches, train_o2 = phase_train(port)
    phase_train_card_vs_cpu(port)
    dk = _kept(port, phase_decode_kernels, port)
    # the flash forward's error over phase 5 and its ragged lengths here
    tk["fwd"]["max_abs_err"] = max(tk["fwd"]["max_abs_err"],
                                   dk["flash_ragged_err"])
    model, ids, out, logits, decode_launches, gen_stats = phase_generate(
        port)
    paged_launches = phase_paged(port, model, ids, out, logits)
    phase_generate_card_vs_cpu(port)
    ik = _kept(port, phase_int8_kernels, port)
    ragged_int8_launches = phase_serve_int8(port)
    # phase 9's model, kept for phase 14, which quantizes it
    paged_int8_launches = phase_paged_int8(port, model, ids, out, logits)
    del model, ids, out, logits
    torch.cuda.empty_cache()
    phase_int8_card_vs_cpu(port)
    nk = _kept(port, phase_norm_kernels, port)
    # the flash forward's error over phases 5 and 8 and BERT's shape here
    tk["fwd"]["max_abs_err"] = max(tk["fwd"]["max_abs_err"], nk["flash_err"])
    tk["fwd"].update(nk["bert_flash"])
    ln_launches = phase_encoder(port)
    phase_bert(port)
    phase_bert_card_vs_cpu(port)
    mk = _kept(port, phase_adamw_master, port)
    master_launches = phase_bert_train(port)
    phase_train_dropout(port)
    phase_determinism(port)
    phase_recipe_card_vs_cpu(port)
    mark("1-24")
    npk = _kept(port, phase_new_plans, port)
    k["max_abs_err"] = max(k["max_abs_err"], npk["float"])
    ik["ragged"]["max_abs_err"] = max(ik["ragged"]["max_abs_err"],
                                      npk["int8"])
    # phases 26-29 share GPT-3 1.3B bf16 (seed 0) at PATHS_LAYERS of its
    # layers, and a 2-layer fp32 copy of its width for the exact checks
    model = port["GPT"](port["gpt_1p3b"](num_layers=PATHS_LAYERS),
                        device=DEVICE, dtype="bfloat16", seed=0)
    fp32_model = port["GPT"](port["gpt_1p3b"](num_layers=2), device=DEVICE,
                             dtype="float32", seed=1)
    by_path = {"serve": {"bfloat16": launches,
                         "int8": ragged_int8_launches}}
    by_path["prefix_cache"] = phase_prefix_cache(port, model, fp32_model)
    by_path["watchdog"] = phase_watchdog(port, model, fp32_model)
    by_path["speculative"] = phase_speculative(port, model, fp32_model,
                                               serve_tps)
    by_path["lora"] = {"bfloat16": sum(phase_lora(port, model,
                                                  fp32_model).values())}
    del model, fp32_model
    torch.cuda.empty_cache()
    mark("25-29")
    fk = phase_adamw_flag(port)
    o1_launches, o1 = phase_train_o1(port, train_o2)
    phase_o1_card_vs_cpu(port)
    phase_recompute_policies(port)
    phase_resume(port)
    mark("30-34")
    # phases 35-40: the layered GPT, phase 35's model through 38
    lmodel, lids, lout, llogits, lgen = phase_layered_generate(port,
                                                               gen_stats)
    lserve, lpaged, _ = phase_layered_serve(port, lmodel, lids, lout,
                                            llogits)
    pred = phase_predictor(port, lmodel, lids)
    lint8, lpaged_int8 = phase_layered_int8(port, lmodel, lids, lout,
                                            llogits)
    del lmodel, lids, lout, llogits
    torch.cuda.empty_cache()
    # the fp32 launches of phase 39 ride the fp32/bf16 kernel's row
    by_path["serve_layered"] = {"bfloat16": lserve, "int8": lint8}
    by_path["predictor_serving"] = {"bfloat16": pred["ragged_serving"]}
    by_path["layered_paths_fp32"] = {
        "bfloat16": sum(phase_layered_paths(port).values())}
    ltrain = phase_layered_train(port)
    mark("35-40")
    # phases 41-44: sharded, elastic and disaggregated serving
    by_path["sharded_serve"] = {"bfloat16": timed(
        41, phase_sharded_serve, port)[0]}
    by_path["sharded_int8"] = {"int8": timed(42, phase_sharded_int8,
                                             port)[0]}
    by_path["disagg"] = timed(43, phase_disagg, port)[0]
    # the fp32 launches ride the fp32/bf16 kernel's row
    by_path["cluster_fp32"] = {"bfloat16": timed(
        44, phase_cluster_card_vs_cpu, port)}
    mark("41-44")
    # phases 45-47: hybrid dp x pp x mp training of the stacked GPT
    mk45 = _kept(port, phase_mesh_kernels, port)
    for key in ("fwd", "dkv", "dq"):
        tk[key]["max_abs_err"] = max(tk[key]["max_abs_err"], mk45[key])
    tk["adamw"]["max_abs_err"] = max(tk["adamw"]["max_abs_err"],
                                     mk45["adamw"])
    mesh_kept = {}
    mesh_runs = phase_mesh_train(port, keep=mesh_kept)
    mesh_cpu = phase_mesh_card_vs_cpu(port)
    mark("45-47")
    # phases 52-53: generation and serving from phase 46's trained (1, 2,
    # 2) model, and batches placed over the mesh fed to its (2, 2, 2) one
    mg = _kept(port, phase_mesh_generate, port, mesh_kept)
    tk["fwd"]["max_abs_err"] = max(tk["fwd"]["max_abs_err"], mg["errs"]["fwd"])
    dk["decode"]["max_abs_err"] = max(dk["decode"]["max_abs_err"],
                                      mg["errs"]["decode"])
    by_path["generate_mesh"] = {"bfloat16": mg["launches"]["ragged"],
                                "int8": mg["launches"]["ragged_int8"]}
    by_path["generate_mesh_fp32_card_vs_cpu"] = {
        "bfloat16": mg["cpu_launches"]["ragged"],
        "int8": mg["cpu_launches"]["ragged_int8"]}
    placed_launches = timed(53, phase_placed_batches, port, mesh_kept)
    mark("52-53")
    # phase 57: fault 11 (a GradScaler over replicas' losses on the card
    # and the CPU), then serving from phase 46's placed (1, 2, 2) model
    # and phase 52's placed layered one with LoRA, a speculative draft and
    # the sharded engine
    f11 = timed("57a", phase_scaler_across_devices, port)
    placed_serving, _ = _kept(port, phase_placed_serving, port, mesh_kept)
    by_path.update({p: {"bfloat16": n} for p, n in placed_serving.items()})
    del mesh_kept
    torch.cuda.empty_cache()
    # phase 57e: a serving mesh over a stacked GPT under ZeRO p_g_os (fp32
    # launches ride the fp32/bf16 kernel's row)
    by_path["zero_serving_fp32"] = {"bfloat16": timed(
        "57e", phase_zero_serving, port)}
    mark("57, 57e")
    # phase 48: the fleet API over the layered GPT at TP=2 PP=2
    fl = phase_fleet_train(port)
    for key in ("fwd", "dkv", "dq", "adamw"):
        tk[key]["max_abs_err"] = max(tk[key]["max_abs_err"], fl["errs"][key])
    # phase 49: dp replicas, recompute, virtual stages, meta-optimizers
    fdp = phase_fleet_dp(port)
    # phase 50: ZeRO at pp 2 x sharding 2 x mp 2
    fz = phase_fleet_zero(port)
    tk["adamw"]["max_abs_err"] = max(tk["adamw"]["max_abs_err"],
                                     fz["errs"]["adamw"])
    mark("48-50")
    # phase 51: sequence parallelism with ring attention on the flash
    # kernels, the layered GPT at sp 2 and sp 2 x mp 2
    fsp = phase_sequence_parallel(port)
    for key in ("fwd", "dkv", "dq"):
        tk[key]["max_abs_err"] = max(tk[key]["max_abs_err"],
                                     fsp["errs"][key])
    mark("51")
    # phase 54: a recompute whose backward spans the card and the CPU,
    # through each of the port's checkpointing entries
    phase_recompute_across_devices(torch, recompute_cases(port))
    # phase 55: auto_parallel's annotations, propagated over the captured
    # layered GPT and run per mesh position through the flash kernel
    auto_launches = _kept(port, phase_auto_parallel, port)
    mark("54-55")
    # phase 56: auto_parallel's Engine at GPT-3 13B widths (2 layers),
    # planned over four positions of the card and trained through the
    # propagation executor on the flash forward and backward kernels
    fe = _kept(port, phase_engine, port)
    for key in ("fwd", "dkv", "dq"):
        tk[key]["max_abs_err"] = max(tk[key]["max_abs_err"], fe["errs"][key])
    mark("56")
    # phase 58: dp replicas and ZeRO over the layered GPT whose sp
    # positions hold copies of their own, a copy on the CPU beside the card
    spr = phase_sp_replicas(port)
    for key in ("fwd", "dkv", "dq"):
        tk[key]["max_abs_err"] = max(tk[key]["max_abs_err"],
                                     spr["errs"][key])
    fk["max_abs_err"] = max(fk["max_abs_err"], spr["errs"]["adamw"])
    mark("58")
    # phase 59: the Engine's plan under ZeRO (os_g, p_g_os) at config 4's
    # widths, the p_g_os blocks gathered around the executor's reads
    fz59 = phase_engine_zero(port)
    mark("59")
    ragged_launches = {
        kv: sum(p.get(kv, 0) for p in by_path.values())
        for kv in ("bfloat16", "int8")}
    print(f"[time] whole run {time.perf_counter() - t_start:.1f} s")
    print(card)
    csrc = "paddle_tpu_torch/ops/kernels/csrc/"
    pallas = "paddle_tpu/ops/pallas_kernels/"
    kernels = [{
        "name": "ragged_paged_attention", "route": "cuda",
        "source": csrc + "ragged_paged_attention.cu",
        "replaces": pallas + "ragged_paged_attention.py:237",
        "launches": ragged_launches["bfloat16"],
        "launches_by_path": {p: v.get("bfloat16", 0)
                             for p, v in by_path.items()},
        "max_abs_err": k["max_abs_err"],
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
        # phase 46's mesh runs, each over all its steps
        mesh_paths = {"train_mesh_" + name: run["launches"][key]
                      for name, run in mesh_runs.items()}
        # phase 48's fleet steps at TP=2 PP=2; phase 49's at dp 2 x pp 2 x
        # mp 2 with recompute and virtual stages
        mesh_paths["train_fleet_tp2_pp2"] = fl["launches"][key]
        mesh_paths["train_fleet_dp_recompute"] = fdp["launches"][key]
        # phase 50's ZeRO steps at pp 2 x sharding 2 x mp 2
        mesh_paths.update({f"train_fleet_zero_{level}": run[key]
                           for level, run in fz["launches"].items()})
        # phase 51's steps with sequence_parallel at sp 2, sp 2 x mp 2
        mesh_paths.update({f"train_sequence_parallel_{name}":
                           run["launches"][key]
                           for name, run in fsp["runs"].items()})
        # phase 53's O1 step fed a batch placed over dp (no update)
        mesh_paths["train_placed_batch_2x2x2"] = placed_launches[key]
        # phase 57a's skipped scaler step, replica 0 on the card
        mesh_paths["train_fleet_scaler_card_and_cpu"] = f11[key]
        # phase 56's Engine.fit over its plan, each over all its steps
        mesh_paths["auto_parallel_fit"] = fe["launches"][key]
        # phase 59's Engine.fit over its plan under ZeRO, by level
        mesh_paths.update({f"auto_parallel_fit_zero_{level}": run[key]
                           for level, run in fz59["launches"].items()})
        if key != "adamw":
            # phase 6's bf16-weight step, phase 31's O1 step and phase
            # 40's layered step; the forward also phase 35's layered
            # prefill and phase 37's Predictor; phase 47's fp32 mesh
            kernels[-1]["launches_by_path"] = {
                "train_bf16": train_launches[key],
                "train_o1_fp32_weights": o1_launches[key],
                "train_layered": ltrain[key], **mesh_paths,
                "train_mesh_fp32_card_vs_cpu": mesh_cpu["flash"][key],
                "train_fleet_fp32_card_vs_cpu": fl["cpu_launches"][key],
                **{f"train_fleet_{name}_fp32_card_vs_cpu": run[key]
                   for name, run in fdp["cpu_launches"].items()},
                **{f"train_fleet_{name}_fp32_card_vs_cpu": run[key]
                   for name, run in fz["cpu_launches"].items()},
                **{f"train_sequence_parallel_{name}_fp32_card_vs_cpu":
                   run[key] for name, run in fsp["cpu_launches"].items()},
                "auto_parallel_fit_fp32_card_vs_cpu":
                    fe["cpu_launches"][key],
                **{f"auto_parallel_fit_zero_{level}_fp32_card_vs_cpu":
                   run[key] for level, run in fz59["cpu_launches"].items()},
                # phase 58's fp32 steps, a copy on the CPU beside the card
                **{f"train_sp_replicas_{name}_fp32": run[key]
                   for name, run in spr["launches"].items()}}
            if key == "fwd":
                # phase 52's prefills from the placed models, per shard
                kernels[-1]["launches_by_path"].update(
                    auto_parallel_dp2_mp2=auto_launches,
                    generate_layered=lgen["fwd"],
                    predictor_decode=pred["fwd"],
                    generate_mesh=mg["launches"]["fwd"],
                    generate_mesh_fp32_card_vs_cpu=mg["cpu_launches"]["fwd"])
        else:
            kernels[-1]["launches_by_path"] = {
                "train_bf16": train_launches[key], **mesh_paths}
    # the fp32 form (fp32 p, g and moments) with phase 31's device flag
    # and beta powers: launches from phase 31's O1 steps
    kernels.append({"name": "fused_adamw_fp32", "route": "cuda",
                    "source": csrc + "fused_adamw.cu",
                    "replaces": pallas + "fused_adamw.py:38",
                    "launches": o1_launches["adamw"],
                    "launches_by_path": {
                        "train_o1_fp32_weights": o1_launches["adamw"],
                        "train_mesh_fp32_card_vs_cpu": mesh_cpu["adamw_fp32"],
                        "train_mesh_o1_overflow": mesh_cpu["adamw_fp32_skip"],
                        "train_fleet_fp32_card_vs_cpu":
                            fl["cpu_launches"]["adamw"],
                        **{f"train_fleet_{name}_fp32_card_vs_cpu":
                           fdp["cpu_launches"][name]["adamw"]
                           for name in ("gradient_merge", "localsgd")},
                        **{f"train_fleet_{name}_fp32_card_vs_cpu":
                           run["adamw"]
                           for name, run in fz["cpu_launches"].items()},
                        **{f"train_sequence_parallel_{name}_fp32_card_vs_cpu":
                           run["adamw"]
                           for name, run in fsp["cpu_launches"].items()},
                        "auto_parallel_fit_fp32_card_vs_cpu":
                            fe["cpu_launches"]["adamw"],
                        **{f"auto_parallel_fit_zero_{level}_fp32_card_vs_cpu":
                           run["adamw"] for level, run
                           in fz59["cpu_launches"].items()},
                        **{f"train_sp_replicas_{name}_fp32": run["adamw"]
                           for name, run in spr["launches"].items()}},
                    **fk})
    # the fp32-master form: the same kernel library and TPU kernel, with
    # the arithmetic of the reference's composed master path; launches
    # from phase 21's BERT-base recipe steps, times at BERT-base's
    # tensors (GPT-3 1.3B's beside them)
    kernels.append({"name": "fused_adamw_master", "route": "cuda",
                    "source": csrc + "fused_adamw.cu",
                    "replaces": pallas + "fused_adamw.py:38",
                    "computes": "paddle_tpu/optimizer/optimizers.py:266",
                    "launches": master_launches, **mk})
    for key, name, replaces, launched, by in (
            ("decode", "decode_attention", "decode_attention.py:86",
             decode_launches, {"generate": decode_launches,
                               "generate_layered": lgen["decode"],
                               "predictor_decode": pred["decode"],
                               "generate_mesh": mg["launches"]["decode"],
                               "generate_mesh_fp32_card_vs_cpu":
                                   mg["cpu_launches"]["decode"]}),
            ("paged", "paged_attention", "paged_attention.py:83",
             paged_launches, {"paged": paged_launches,
                              "paged_layered": lpaged,
                              "paged_mesh": mg["launches"]["paged"]})):
        kernels.append({"name": name, "route": "cuda",
                        "source": csrc + "decode_attention.cu",
                        "replaces": pallas + replaces, "launches": launched,
                        "launches_by_path": by, **dk[key]})
    # the int8 variants: each TPU kernel's quantized branch; the decode
    # variant has no model path, its launches are phase 12's checks
    for key, name, source, replaces, launched in (
            ("ragged", "ragged_paged_attention_int8",
             "ragged_paged_attention.cu", "ragged_paged_attention.py:269",
             ragged_launches["int8"]),
            ("paged", "paged_attention_int8", "decode_attention.cu",
             "paged_attention.py:109", paged_int8_launches),
            ("decode", "decode_attention_int8", "decode_attention.cu",
             "decode_attention.py:106", ik["decode_launches"])):
        kernels.append({"name": name, "route": "cuda",
                        "source": csrc + source,
                        "replaces": pallas + replaces, "launches": launched,
                        **ik[key]})
        if key == "ragged":
            kernels[-1]["launches_by_path"] = {
                p: v.get("int8", 0) for p, v in by_path.items()}
        elif key == "paged":
            kernels[-1]["launches_by_path"] = {
                "paged_int8": paged_int8_launches,
                "paged_int8_layered": lpaged_int8}
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
