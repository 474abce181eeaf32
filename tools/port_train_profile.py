#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's training step, on the card.

Trains one or more of ``chip_smoke.py``'s train workloads: warm-up steps,
then timed steps without the profiler (host clock, tokens/s), then steps
under ``torch.profiler`` for device time by kernel.  Prints the card's
name and power limit, the step times, the device busy share and the
kernels ranked by device time, grouped into the port's flash-attention
and AdamW kernels, matrix products, softmax, the dropout masks' random
draws and the rest.  Workloads (``--workload``, repeatable):

- ``gpt``: phase 6, GPT-3 1.3B at full width and depth with random bf16
  weights, batch 8 x seq 1024, recompute every block, AdamW with bf16
  moments, dropout 0 (the default);
- ``gpt_o1``: phase 31, the same model and shape with fp32 weights under
  ``auto_cast`` O1 bf16, an enabled dynamic ``GradScaler`` and fp32
  AdamW moments (``FusedTrainStep(scaler=, amp_level="O1")``);
- ``gpt_dropout``: phase 22, the same with the config's dropout 0.1
  (attention on the plain causal route); ``gpt_dropout_flash``: hidden
  dropout 0.1, attention dropout 0 (the flash kernels);
- ``bert``: phase 21, BERT-base bf16 on fp32 masters by its recipe,
  16 x 512, dropout 0.1 (attention on the plain masked route);
  ``bert_flash``: attention dropout 0 (the flash kernels).

Run from the repository root:

    python3 tools/port_train_profile.py [--workload gpt] [--steps 6]
        [--trace TRACE.json]
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402  (the train workloads, defined once there)
from port_serve_profile import report  # noqa: E402


def _group(name: str) -> str:
    n = name.lower()
    if "flash_fwd" in n:
        return "flash forward (port kernel)"
    if "flash_bwd" in n:
        return "flash backward dK/dV + dQ (port kernels)"
    if "adamw" in n:
        return "AdamW (port kernel)"
    if any(k in n for k in ("gemm", "xmma", "cutlass", "nvjet", "gemv")):
        return "matrix products (cuBLAS)"
    if "softmax" in n:
        return "softmax"
    if any(k in n for k in ("philox", "uniform", "distribution")):
        return "random draws (dropout masks)"
    return "elementwise, norms, reductions, copies"


def _workload(port, name):
    """``(step, batches, tokens per step)`` of workload ``name``."""
    cs = chip_smoke
    gpt_tokens = cs.TRAIN_BATCH * cs.TRAIN_SEQ
    if name == "gpt":
        _, step, batches = cs.train_setup(port)
        return step, batches, gpt_tokens
    if name == "gpt_o1":
        import torch

        _, _, _, step = cs.o1_train_setup(port)
        vocab = port["gpt_1p3b"]().vocab_size
        batches = [tuple(torch.from_numpy(a).to(cs.DEVICE) for a in b)
                   for b in cs.o1_host_batches(vocab, 4)]
        return step, batches, gpt_tokens
    if name in ("gpt_dropout", "gpt_dropout_flash"):
        p = 0.0 if name.endswith("flash") else 0.1
        _, step, batches = cs.train_dropout_setup(port, p)
        return step, batches, gpt_tokens
    p = 0.0 if name.endswith("flash") else 0.1
    _, _, _, step, batch = cs.bert_train_setup(port, p)
    return step, [batch], cs.ENC_BATCH * cs.ENC_SEQ


WORKLOADS = ("gpt", "gpt_o1", "gpt_dropout", "gpt_dropout_flash", "bert",
             "bert_flash")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", action="append", choices=WORKLOADS,
                    help="workload to profile (repeatable; default gpt)")
    ap.add_argument("--steps", type=int, default=chip_smoke.TRAIN_STEPS,
                    help="timed steps, and profiled steps (half as many)")
    ap.add_argument("--trace", help="write the Chrome trace here (with "
                    "several workloads, the name gets the workload's)")
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("port_train_profile: no CUDA device", file=sys.stderr)
        return 2
    port = chip_smoke.import_port()
    print(f"card: {chip_smoke.card_line()}")
    names = args.workload or ["gpt"]
    for name in names:
        print(f"== workload {name}")
        step, batches, tokens_per_step = _workload(port, name)
        chip_smoke.train_steps(port, step, batches, chip_smoke.TRAIN_WARMUP)
        losses, wall = chip_smoke.train_steps(port, step, batches,
                                              args.steps)
        tokens = tokens_per_step * args.steps
        print(f"unprofiled: {args.steps} steps in {wall:.4f} s, mean step "
              f"{1e3 * wall / args.steps:.2f} ms, {tokens / wall:.1f} "
              f"tokens/s; losses {losses}")
        n = max(1, args.steps // 2)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, pwall = chip_smoke.train_steps(port, step, batches, n)
        if not report(prof, n, pwall, _group, "train step"):
            return 1
        if args.trace:
            path = args.trace
            if len(names) > 1:
                root, ext = os.path.splitext(path)
                path = f"{root}.{name}{ext}"
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
            prof.export_chrome_trace(path)
            print(f"trace written to {path}")
        del step, batches, prof
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
