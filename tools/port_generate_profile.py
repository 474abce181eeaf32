#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's ``generate()``, on the card.

Runs ``chip_smoke.py``'s generate workload (``generate_setup``: GPT-3 1.3B
at full width and depth with random bf16 weights, batch 8, prompt 200,
bf16 cache of 1024 positions): the prefill alone and a whole greedy
``generate`` of 64 new tokens without the profiler (host clock), then the
same ``generate`` under ``torch.profiler`` for device time by kernel.
Prints the card's name and power limit, the times, the device busy share
and the kernels ranked by device time, grouped into the port's flash
forward and decode-attention kernels, matrix products, cache writes and
the rest, per generated token.  ``--layered`` runs the layered GPT
(``GPTForPretraining``, phase 35) in place of the stacked one.  Run from
the repository root:

    python3 tools/port_generate_profile.py [--layered] [--trace TRACE.json]
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402  (the generate workload, defined once there)
from port_serve_profile import report  # noqa: E402


def _group(name: str) -> str:
    n = name.lower()
    if "flash_fwd" in n:
        return "flash forward (port kernel, prefill)"
    if "decode_split_kernel" in n:
        return "decode attention (port kernel)"
    if any(k in n for k in ("gemm", "xmma", "cutlass", "nvjet", "gemv")):
        return "matrix products (cuBLAS)"
    if "index_copy" in n or "indexing" in n:
        return "cache writes"
    return "elementwise, norms, reductions, sampling, copies"


def _timed(torch, model, ids, new):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.generate(ids, new, **chip_smoke.GEN_KW)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layered", action="store_true",
                    help="the layered GPT (GPTForPretraining)")
    ap.add_argument("--trace", help="write the Chrome trace here")
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("port_generate_profile: no CUDA device", file=sys.stderr)
        return 2
    port = chip_smoke.import_port()
    print(f"card: {chip_smoke.card_line()}")
    model, ids = chip_smoke.generate_setup(
        port, "Layered" if args.layered else "GPT")
    print(f"model {type(model).__name__}")
    new = chip_smoke.GEN_NEW
    prefill = _timed(torch, model, ids, 1)
    wall = _timed(torch, model, ids, new)
    b = ids.shape[0]
    print(f"unprofiled: prefill {1e3 * prefill:.3f} ms; generate of {new} "
          f"tokens {1e3 * wall:.3f} ms, mean decode "
          f"{1e3 * (wall - prefill) / (new - 1):.3f} ms per token, "
          f"{b * new / wall:.1f} tokens/s")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pwall = _timed(torch, model, ids, new)
    if not report(prof, new, pwall, _group, "generated token"):
        return 1
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)),
                    exist_ok=True)
        prof.export_chrome_trace(args.trace)
        print(f"trace written to {args.trace}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
