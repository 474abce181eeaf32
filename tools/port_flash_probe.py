#!/usr/bin/env python3
"""A short first look at the port's flash-attention kernels on the card,
for the first call after a change to ``csrc/flash_attention.cu``: build
that one library, print ptxas's report for the bf16 kernels, hold each
kernel against its plain version at a few shapes (``chip_smoke.py``'s own
phase-5 and phase-8 checks), and with ``--time`` print the kernels' times
at the trained shape and at BERT's attention beside SDPA (phases 5 and
16's timing).  Run from the repository root:

    python3 tools/port_flash_probe.py [--time]

It exits nonzero when a case fails or there is no card.
"""
from __future__ import annotations

import argparse
import os
import re
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402  (the checks and timings, defined once there)

# (kind, shape, causal): "all" holds the forward and both backward kernels
# (phase 5's check, seq a multiple of 128), "fwd" the forward alone at any
# seq (phase 8's check)
CASES = (("fwd", (1, 2, 256, 128), True), ("fwd", (1, 2, 256, 128), False),
         ("all", (2, 4, 256, 128), True), ("all", (2, 4, 256, 128), False),
         ("all", (1, 2, 384, 64), True), ("all", (2, 3, 512, 64), False),
         ("fwd", (2, 3, 77, 64), True), ("fwd", (2, 3, 200, 128), True),
         ("fwd", (1, 2, 1, 128), True), ("fwd", (1, 2, 1000, 128), False),
         ("fwd", (1, 2, 200, 192), True), ("fwd", (1, 2, 200, 256), False),
         ("all", cs.TRAIN_SHAPE, True), ("all", cs.BERT_ATTN_SHAPE, False))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--time", action="store_true",
                    help="also time the kernels beside SDPA")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("port_flash_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    port = cs.import_port()
    print(f"card: {cs.card_line()}", flush=True)
    t0 = time.perf_counter()
    port["build"].build(["flash_attention"])
    print(f"build {time.perf_counter() - t0:.1f} s")
    log = port["build"].build_logs().get("flash_attention", "")
    for entry, r in cs._ptxas_entries(log).items():
        if re.search(r"flash_\w+_bf16", entry):
            print(f"[ptxas] {entry}: {r}")
    for line in log.splitlines():
        if "warning" in line.lower():
            print(f"[nvcc] {line.strip()}")
    fails = 0
    for kind, shape, causal in CASES:
        try:
            if kind == "all":
                err = cs._flash_compare(port, "bfloat16", shape, causal, seed=5)
            else:
                err = cs._flash_ragged_case(port, "bfloat16", shape, causal, 6)
            print(f"OK {kind} {shape} causal={causal}: max abs errors {err}",
                  flush=True)
        except Exception as exc:  # noqa: BLE001  (report every case)
            fails += 1
            print(f"FAIL {kind} {shape} causal={causal}: {exc!r}", flush=True)
            if "CUDA" in repr(exc) or "launch" in repr(exc):
                traceback.print_exc()
                break     # the context is gone; later cases cannot run
    if args.time and not fails:
        t = cs._time_flash(port)
        print(f"trained shape {cs.TRAIN_SHAPE} causal, device ms: "
              f"{ {k: round(v, 4) for k, v in t.items()} }; forward / SDPA "
              f"{t['fwd'] / t['sdpa_fwd']:.3f}, whole backward / SDPA "
              f"{t['bwd'] / t['sdpa_bwd']:.3f}")
        b = cs._time_bert_flash(port)
        print(f"BERT's attention {cs.BERT_ATTN_SHAPE} full, device ms: "
              f"forward {b['fwd']:.4f}, SDPA {b['sdpa']:.4f} (ratio "
              f"{b['fwd'] / b['sdpa']:.3f}), plain {b['plain']:.4f}")
    print(f"failed cases: {fails}")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
