#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's training step, on the card.

Trains ``chip_smoke.py``'s train workload (``train_setup`` and
``train_steps``: GPT-3 1.3B at full width and depth with random bf16
weights, batch 8 x seq 1024, recompute every block, AdamW with bf16
moments): warm-up steps, then timed steps without the profiler (host
clock, tokens/s), then steps under ``torch.profiler`` for device time by
kernel.  Prints the card's name and power limit, the step times, the
device busy share and the kernels ranked by device time, grouped into
the port's flash-attention and AdamW kernels, matrix products and the
rest.  Run from the repository root:

    python3 tools/port_train_profile.py [--steps 6] [--trace TRACE.json]
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402  (the train workload, defined once there)
from port_serve_profile import report  # noqa: E402


def _group(name: str) -> str:
    n = name.lower()
    if "flash_fwd" in n:
        return "flash forward (port kernel)"
    if "flash_bwd" in n:
        return "flash backward dK/dV + dQ (port kernels)"
    if "adamw_kernel" in n:
        return "AdamW (port kernel)"
    if any(k in n for k in ("gemm", "xmma", "cutlass", "nvjet", "gemv")):
        return "matrix products (cuBLAS)"
    return "elementwise, norms, reductions, copies"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=chip_smoke.TRAIN_STEPS,
                    help="timed steps, and profiled steps (half as many)")
    ap.add_argument("--trace", help="write the Chrome trace here")
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("port_train_profile: no CUDA device", file=sys.stderr)
        return 2
    port = chip_smoke.import_port()
    print(f"card: {chip_smoke.card_line()}")
    model, step, batches = chip_smoke.train_setup(port)
    chip_smoke.train_steps(port, step, batches, chip_smoke.TRAIN_WARMUP)
    losses, wall = chip_smoke.train_steps(port, step, batches, args.steps)
    tokens = chip_smoke.TRAIN_BATCH * chip_smoke.TRAIN_SEQ * args.steps
    print(f"unprofiled: {args.steps} steps in {wall:.4f} s, mean step "
          f"{1e3 * wall / args.steps:.2f} ms, {tokens / wall:.1f} tokens/s; "
          f"losses {losses}")
    n = max(1, args.steps // 2)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, pwall = chip_smoke.train_steps(port, step, batches, n)
    if not report(prof, n, pwall, _group, "train step"):
        return 1
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)),
                    exist_ok=True)
        prof.export_chrome_trace(args.trace)
        print(f"trace written to {args.trace}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
