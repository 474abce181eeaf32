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
into attention (the port's kernel), matrix products and the rest.
``--lora`` serves the same requests through phase 29's adapter pool (4
adapters of rank 16 on all four targets, the requests spread over them
and the null adapter); ``--spec-draft N`` through phase 28's speculative
engine (k 4) with ``truncated_draft(model, N)`` as its draft.  Run from
the repository root:

    python3 tools/port_serve_profile.py [--kv-dtype int8] \
        [--weight-dtype int8] [--lora | --spec-draft N] \
        [--trace serve_trace.json]
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


def _engine(port, args):
    """Phase 3's engine (``serve_engine``), or with ``--lora`` /
    ``--spec-draft`` the same model and geometry through phase 29's LoRA
    pool or phase 28's speculative engine.  Returns ``(engine, rng,
    adapters)``: ``adapters(n)`` names the adapter of each of n
    requests."""
    cs = chip_smoke
    if not args.lora and args.spec_draft is None:
        eng, rng = cs.serve_engine(port, args.kv_dtype, args.weight_dtype)
        return eng, rng, lambda n: [None] * n
    cfg = port["gpt_1p3b"]()
    model = port["GPT"](cfg, device=cs.DEVICE, dtype="bfloat16", seed=0)
    kw = cs._engine_kw(kv_dtype=args.kv_dtype, weight_dtype=args.weight_dtype)
    names = [f"tenant{i}" for i in range(cs.LORA_ADAPTERS)]
    if args.lora:
        s = port["serving"]
        pool = s.LoRAAdapterPool(cfg, num_adapter_pages=cs.LORA_ADAPTERS,
                                 rank=cs.LORA_RANK, dtype="bfloat16",
                                 device=cs.DEVICE)
        for i, name in enumerate(names):
            pool.register(name, s.random_adapter(
                cfg, cs.LORA_RANK, np.random.RandomState(290 + i)))
        eng = port["ServingEngine"](model, lora=pool, **kw)
        adapters = lambda n: [names[i % 5] if i % 5 < len(names)  # noqa
                              else None for i in range(n)]
    else:
        eng = port["SpeculativeEngine"](
            model, port["truncated_draft"](model, args.spec_draft),
            spec_k=cs.SPEC_K, **kw)
        adapters = lambda n: [None] * n  # noqa: E731
    rng = np.random.RandomState(0)
    eng.generate_batch([rng.randint(0, cfg.vocab_size, (64,))], 8,
                       adapter=adapters(1)[0])
    port["torch"].cuda.synchronize()
    return eng, rng, adapters


def _workload(port, eng, rng, adapters):
    """The serve workload's 16 requests, each with its adapter."""
    prompts = chip_smoke._serve_prompts(rng, eng.model.config.vocab_size)
    reqs, wall, steps = chip_smoke._drive(
        port, eng, prompts, chip_smoke.SERVE_NEW_TOKENS,
        adapters(len(prompts)))
    chip_smoke._all_done(port, "profile", reqs, chip_smoke.SERVE_NEW_TOKENS)
    return reqs, steps, wall


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kv-dtype", default="bfloat16",
                    choices=("bfloat16", "int8"), help="the pool's dtype")
    ap.add_argument("--weight-dtype", default=None, choices=("int8",),
                    help="quantize the weights to int8")
    ap.add_argument("--lora", action="store_true",
                    help="serve through phase 29's LoRA adapter pool")
    ap.add_argument("--spec-draft", type=int, default=None, metavar="N",
                    help="speculate with truncated_draft(model, N), k 4")
    ap.add_argument("--trace", help="write the Chrome trace here")
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("port_serve_profile: no CUDA device", file=sys.stderr)
        return 2
    port = chip_smoke.import_port()
    print(f"card: {chip_smoke.card_line()}")
    eng, rng, adapters = _engine(port, args)
    print(f"kv {args.kv_dtype}, weights {args.weight_dtype or 'bfloat16'}, "
          f"lora {args.lora}, speculative draft layers {args.spec_draft}")
    if args.lora or args.spec_draft is not None:
        def workload():
            return _workload(port, eng, rng, adapters)
    else:
        def workload():
            return chip_smoke.serve_workload(port, eng, rng)

    f0 = eng.metrics()["fused_steps"]
    reqs, steps, wall = workload()
    toks = sum(len(r.tokens) for r in reqs)
    fused = eng.metrics()["fused_steps"] - f0
    if np.ndim(steps):
        per_step = (f"step host time mean {1e3 * np.mean(steps):.3f} ms, "
                    f"p50 {1e3 * np.median(steps):.3f} ms, max "
                    f"{1e3 * np.max(steps):.3f} ms")
    else:
        per_step = f"{1e3 * wall / steps:.3f} ms a step (wall / steps)"
    print(f"unprofiled: {toks} tokens in {wall:.4f} s = "
          f"{toks / wall:.1f} tokens/s; {fused} fused steps; {per_step}")

    f0 = eng.metrics()["fused_steps"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, pwall = workload()
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
