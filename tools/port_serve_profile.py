#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's serving step, on the card.

Serves ``chip_smoke.py``'s serve workload (``serve_engine`` and
``serve_workload``: GPT-3 1.3B at full width with random bf16 weights,
16 requests of 32 new tokens each) twice on one engine: first without the
profiler (host-clock step times, tokens/s), then under ``torch.profiler``
for device time by kernel.  ``--kv-dtype int8`` serves from an int8 pool
and ``--weight-dtype int8`` on int8 weights (phase 13's two runs).  Prints the card's name and power limit, the
step times, the device busy share (union of CUDA kernel intervals over
the profiled wall time) and the kernels ranked by device time, grouped
into attention (the port's kernel), matrix products and the rest.  Run
from the repository root:

    python3 tools/port_serve_profile.py [--kv-dtype int8] \
        [--weight-dtype int8] [--trace chiprun_out/serve.json]
"""
from __future__ import annotations

import argparse
import os
import sys
from collections import defaultdict

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402  (the serve workload, defined once there)


def _group(name: str) -> str:
    n = name.lower()
    if "ragged_paged_attention" in n:
        return "ragged_paged_attention (port kernel)"
    if "gemm_s8" in n or "imma" in n:
        return "int8 matrix products (cuBLASLt, torch._int_mm)"
    if any(k in n for k in ("gemm", "xmma", "cutlass", "nvjet", "gemv")):
        return "matrix products (cuBLAS)"
    if "scatter" in n:
        return "KV quantizer scatters (scales)"
    if "index_put" in n or "indexing" in n:
        return "pool writes / gathers"
    return "elementwise, norms, reductions, copies"


def report(prof, steps: int, wall: float, group, unit: str) -> bool:
    """Print the profiled window's kernel launches, the device busy share
    (union of CUDA kernel intervals over ``wall`` seconds) and kernel time
    by ``group(name)`` and by name, per ``unit`` (``steps`` of them).
    False when the profiler recorded no device activity."""
    import torch

    # device events, without the spans record_function also draws on the
    # device timeline (their time is their kernels')
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    if not kernels:
        print("profiler recorded no device activity; no breakdown")
        return False
    by_name, by_group = defaultdict(float), defaultdict(float)
    spans = []
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_name[e.name] += us
        by_group[group(e.name)] += us
        spans.append((e.time_range.start, e.time_range.end))
    spans.sort()
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    total = sum(by_name.values())
    print(f"profiled: wall {wall:.4f} s, {steps} {unit}s, "
          f"{len(kernels)} kernel launches ({len(kernels) / steps:.1f} per "
          f"{unit}); device busy {busy / 1e6:.4f} s = "
          f"{busy / 1e6 / wall:.3f} of wall; kernel time per {unit} "
          f"{total / steps / 1e3:.3f} ms")
    for g, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"  group {g}: {us / 1e3:.3f} ms total, "
              f"{us / steps / 1e3:.4f} ms per {unit}, {us / total:.3f} of "
              "kernel time")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  kernel {us / 1e3:9.3f} ms  {name[:110]}")
    return True


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kv-dtype", default="bfloat16",
                    choices=("bfloat16", "int8"), help="the pool's dtype")
    ap.add_argument("--weight-dtype", default=None, choices=("int8",),
                    help="quantize the weights to int8")
    ap.add_argument("--trace", help="write the Chrome trace here")
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("port_serve_profile: no CUDA device", file=sys.stderr)
        return 2
    port = chip_smoke.import_port()
    print(f"card: {chip_smoke.card_line()}")
    eng, rng = chip_smoke.serve_engine(port, args.kv_dtype,
                                       args.weight_dtype)
    print(f"kv {args.kv_dtype}, weights {args.weight_dtype or 'bfloat16'}")

    f0 = eng.metrics()["fused_steps"]
    reqs, steps, wall = chip_smoke.serve_workload(port, eng, rng)
    toks = sum(len(r.tokens) for r in reqs)
    fused = eng.metrics()["fused_steps"] - f0
    print(f"unprofiled: {toks} tokens in {wall:.4f} s = "
          f"{toks / wall:.1f} tokens/s; {fused} fused steps; step host "
          f"time mean {1e3 * np.mean(steps):.3f} ms, p50 "
          f"{1e3 * np.median(steps):.3f} ms, max {1e3 * np.max(steps):.3f}"
          " ms")

    f0 = eng.metrics()["fused_steps"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, pwall = chip_smoke.serve_workload(port, eng, rng)
    fused = eng.metrics()["fused_steps"] - f0
    if not report(prof, fused, pwall, _group, "fused step"):
        return 1
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)),
                    exist_ok=True)
        prof.export_chrome_trace(args.trace)
        print(f"trace written to {args.trace}")
    eng.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
