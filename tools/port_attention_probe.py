#!/usr/bin/env python3
"""A short first look at the port's decode, paged and ragged attention
kernels on the card, for the first call after a change to
``csrc/decode_attention.cu`` or ``csrc/ragged_paged_attention.cu``: build
those two libraries alone, print ptxas's report and the runtime's view
(shared memory, registers, CTAs per SM, spills) of the split decode
kernel's contiguous and paged launches and of the ragged kernel, and run
``chip_smoke.py``'s own checks of them: phase 2's ragged cases (bf16 and
fp32), phase 8's decode cases with the split boundaries and paged cases
with per-slot lengths at the split boundaries, and phase 12's int8 cases.
With ``--time`` it prints their times beside the bound and SDPA (phases
2, 8 and 12's timing: the contiguous decode kernel beside the paged one at
the same shape), and with ``--parent DIR`` also those of the ragged,
decode and paged kernels of an earlier tree's ``ops/kernels`` package
unpacked under ``DIR`` (its own wrappers, built from its own sources),
and phase 10's paged step with each paged kernel, in turns on the same
card (earlier, current, current, earlier).  Run from the repository
root:

    git archive <commit> paddle_tpu_torch/ops/kernels | tar -x -C _cmp/parent
    python3 tools/port_attention_probe.py [--time] [--parent _cmp/parent]

It exits nonzero when a case fails or there is no card.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import os
import re
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402  (the checks and timings, defined once there)

LIBS = ("decode_attention", "ragged_paged_attention")
KERNELS = re.compile(r"decode_split_kernel|ragged_paged_attention_kernel")


def checks(port):
    """Every check, each case reported; returns the number that failed."""
    cases = [("ragged bf16/fp32", lambda: cs.ragged_checks(port))]
    for i, (dtype, shape) in enumerate(cs.DECODE_SPLIT_CASES):
        cases.append((f"decode split {dtype} {shape}",
                      lambda i=i, dt=dtype, sh=shape:
                      cs.decode_split_case(port, dt, sh, 45 + i)))
    cases.append(("decode (phase 8 lengths)", lambda: cs._decode_case(
        port, "bfloat16", (cs.GEN_BATCH, 16, cs.GEN_MAX_SEQ, 128),
        (1, 200, 201, 1024), 40)))
    cases.append(("paged (phase 8)", lambda: cs.paged_checks(port)))
    cases.append(("int8 ragged, paged, decode",
                  lambda: cs.int8_attention_checks(port)))
    fails = 0
    for name, fn in cases:
        try:
            print(f"OK {name}: {fn()}", flush=True)
        except Exception as exc:  # noqa: BLE001  (report every case)
            fails += 1
            print(f"FAIL {name}: {exc!r}", flush=True)
            if "CUDA" in repr(exc) or "launch" in repr(exc):
                traceback.print_exc()
                break     # the context is gone; later cases cannot run
    return fails


def parent_kernels(root):
    """The decode, paged and ragged wrappers of the tree unpacked at
    ``root`` (its ``paddle_tpu_torch/ops/kernels`` package, loaded beside
    the current one as ``parent_kernels`` and built from its own sources
    into its own ``build/``), for timing in turns with the current ones:
    ``{"decode": fn, "paged": fn, "ragged": fn}``."""
    path = os.path.join(root, "paddle_tpu_torch", "ops", "kernels")
    spec = importlib.util.spec_from_file_location(
        "parent_kernels", os.path.join(path, "__init__.py"),
        submodule_search_locations=[path])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules["parent_kernels"] = pkg
    spec.loader.exec_module(pkg)
    mods = {name: importlib.import_module(f"parent_kernels.{name}")
            for name in ("_build",) + LIBS + ("paged_attention",)}
    mods["_build"].build(list(LIBS))
    return {"decode": mods["decode_attention"].decode_attention,
            "paged": mods["paged_attention"].paged_attention,
            "ragged": mods["ragged_paged_attention"].ragged_paged_attention}


def time_decode(port, n, launch):
    """Device ms per launch at (B 8, H 16, D 128, bf16) over ``n`` valid
    positions of a 1024-position cache, one cache per layer (L2 cold)."""
    torch = port["torch"]
    b, h, d, L = cs.GEN_BATCH, 16, 128, cs.SERVE_LAYERS
    gen = torch.Generator(device=cs.DEVICE).manual_seed(30 + n)
    q = cs._randn(torch, (b, h, d), "bfloat16", gen)
    cache = [cs._randn(torch, (L, b, h, cs.GEN_MAX_SEQ, d), "bfloat16", gen)
             for _ in range(2)]
    length = torch.tensor(n, dtype=torch.int32, device=cs.DEVICE)
    ms, _ = cs._time_ms(torch, lambda i: launch(
        q, cache[0][i % L], cache[1][i % L], length), 240)
    del cache
    torch.cuda.empty_cache()
    return ms


def time_paged(port, n, dtype, launch):
    """(device ms, host ms) per launch at 8 slots x H 16, D 128, over
    ``n`` valid positions of 8 shuffled pages of 128 each (phases 8 and
    12's timed shape), one pool per layer (L2 cold): a bf16 pool, or
    (``dtype`` "int8") an int8 pool with its scales and fp32 q."""
    torch = port["torch"]
    b, h, d, L = cs.GEN_BATCH, 16, 128, cs.SERVE_LAYERS
    max_pages = cs.GEN_MAX_SEQ // cs.GEN_PAGE
    num_pages = b * max_pages + 1
    tables = torch.from_numpy(cs._paged_tables(
        np.random.RandomState(n), b, max_pages, num_pages)).to(cs.DEVICE)
    lens = torch.full((b,), n, dtype=torch.int32, device=cs.DEVICE)
    gen = torch.Generator(device=cs.DEVICE).manual_seed(30 + n)
    shape = (L, num_pages, h, cs.GEN_PAGE, d)
    if dtype == "int8":
        q = cs._randn(torch, (b, h, d), "float32", gen)
        (kp, ks), (vp, vs) = (cs._int8_pages(torch, shape, gen)
                              for _ in range(2))

        def scales(i):
            return dict(k_scale=ks[i % L], v_scale=vs[i % L])
    else:
        q = cs._randn(torch, (b, h, d), "bfloat16", gen)
        kp, vp = (cs._randn(torch, shape, "bfloat16", gen) for _ in range(2))

        def scales(i):
            return {}
    ms = cs._time_ms(torch, lambda i: launch(
        q, kp[i % L], vp[i % L], tables, lens, **scales(i)), 240)
    del kp, vp
    torch.cuda.empty_cache()
    return ms


def time_paged_step(port, parent_paged, steps=16):
    """Phase 10's paged step without a plan, end to end: GPT-3 1.3B bf16
    over 8 slots of page 128, the prompts' 200 positions written by the
    chunked prefill, then ``steps`` decode steps at positions 200 onward.
    The model's paged kernel is ``parent_paged`` and the current one in
    turns (earlier, current, current, earlier).  Each turn: the mean ms a
    step on the host clock to a synchronize, then the same steps under
    ``torch.profiler``: kernel time a step, all kernels and the paged
    kernel's.  Returns one ``(wall, kernels, paged)`` a turn."""
    import paddle_tpu_torch.models.gpt as gpt
    from torch.profiler import ProfilerActivity, profile

    torch = port["torch"]
    model, ids = cs.generate_setup(port)
    b = cs.GEN_BATCH
    max_pages = -(-(cs.GEN_PROMPT + steps) // cs.GEN_PAGE) + 1
    num_pages = b * max_pages + 1
    cache = model.new_paged_kv_cache(num_pages, cs.GEN_PAGE,
                                     dtype="bfloat16")
    tables = torch.from_numpy(cs._paged_tables(
        np.random.RandomState(11), b, max_pages, num_pages)).to(cs.DEVICE)

    def step(tok, pos):
        with torch.no_grad():
            return model._paged_lm_logits(
                tok, cache, tables,
                torch.full((b,), pos, dtype=torch.int32, device=cs.DEVICE))

    def run():
        for j in range(steps):
            step(tok, cs.GEN_PROMPT + j)
            torch.cuda.synchronize()

    for lo in range(0, cs.GEN_PROMPT, cs.GEN_CHUNK):
        step(ids[:, lo:lo + cs.GEN_CHUNK], lo)
    tok = ids[:, -1:]
    current = gpt.paged_attention
    turns = []
    for fn in (parent_paged, current, current, parent_paged):
        gpt.paged_attention = fn
        try:
            step(tok, cs.GEN_PROMPT)            # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            wall = 1e3 * (time.perf_counter() - t0) / steps
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                run()
        finally:
            gpt.paged_attention = current
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation]
        us = sum(e.time_range.elapsed_us() for e in kernels)
        paged_us = sum(e.time_range.elapsed_us() for e in kernels
                       if "decode_split_kernel" in e.name
                       or "decode_kernel" in e.name)
        turns.append((wall, us / 1e3 / steps, paged_us / 1e3 / steps))
    del model, cache
    torch.cuda.empty_cache()
    return turns


def timing(port, parent):
    """The kernels' times; with ``parent`` also the earlier build's decode
    and paged kernels, in the order earlier, current, current, earlier."""
    torch = port["torch"]
    P = cs.served_geometry(port["rpa"])["num_pages"]
    rng = np.random.RandomState(1)
    shapes = (("decode_heavy", cs.decode_runs(cs._served_runs(rng, P))),
              ("mixed", cs.mixed_runs(cs._served_runs(rng, P))))
    for name, runs in shapes:
        for dtype in ("bfloat16", "int8"):
            t = cs.time_ragged(port, runs, dtype, plain=False)
            bound = t["bound"][0]
            ms = min(t["ms"], t["ms_again"])
            line = (f"ragged {name} {dtype}: kernel {t['ms']!r} then "
                    f"{t['ms_again']!r} ms, bound {bound!r} "
                    f"({t['bound'][1]}), share {bound / ms:.3f}")
            if parent:
                before = cs.time_ragged(port, runs, dtype, plain=False,
                                        launch=parent["ragged"])
                line += (f"; earlier build {before['ms']!r}, "
                         f"{before['ms_again']!r} ms")
            print(line, flush=True)
    for n in cs.DECODE_TIMED_LENGTHS:
        t = cs._time_decode_kernels(port, n)
        i = cs._time_int8_attention(port, n)
        dec = min(t["decode"], t["decode_again"])
        pag = min(t["paged"], t["paged_again"])
        print(f"bf16 (B 8, H 16, D 128) length {n}: decode kernel "
              f"{t['decode']!r} then {t['decode_again']!r} ms, SDPA on the "
              f"sliced cache {t['sdpa']!r} (ratio {dec / t['sdpa']:.3f}); "
              f"paged kernel {t['paged']!r} then {t['paged_again']!r} ms; "
              f"bound {t['bound'][0]!r} ({t['bound'][1]}), share decode "
              f"{t['bound'][0] / dec:.3f}, paged {t['bound'][0] / pag:.3f}",
              flush=True)
        print(f"int8 length {n}: decode {i['decode']!r} ms (bound "
              f"{i['decode_bound'][0]!r}, share "
              f"{i['decode_bound'][0] / i['decode']:.3f}), paged "
              f"{i['paged']!r} ms (bound {i['paged_bound'][0]!r}, share "
              f"{i['paged_bound'][0] / i['paged']:.3f})", flush=True)
        if not parent:
            continue
        decode = port["da"].decode_attention
        order = [time_decode(port, n, f)
                 for f in (parent["decode"], decode, decode, parent["decode"])]
        print(f"decode bf16 length {n}, earlier, current, current, earlier: "
              f"{order!r} ms", flush=True)
        paged = port["pa"].paged_attention
        for dtype in ("bfloat16", "int8"):
            order = [time_paged(port, n, dtype, f)
                     for f in (parent["paged"], paged, paged,
                               parent["paged"])]
            print(f"paged {dtype} length {n}, earlier, current, current, "
                  f"earlier: device {[t[0] for t in order]!r} ms, host "
                  f"{[t[1] for t in order]!r} ms a call", flush=True)
    if parent:
        turns = time_paged_step(port, parent["paged"])
        print("paged step (phase 10's, GPT-3 1.3B bf16, 8 slots at positions "
              "200-215), earlier, current, current, earlier, ms a step: host "
              f"clock to a synchronize {[t[0] for t in turns]!r}; profiled "
              f"kernel time {[t[1] for t in turns]!r}, of it the paged "
              f"kernel {[t[2] for t in turns]!r}", flush=True)
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--time", action="store_true",
                    help="also time the kernels beside the bound and SDPA")
    ap.add_argument("--parent", metavar="DIR",
                    help="with --time: also time the kernels built from "
                    "the sources of the tree unpacked at DIR")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("port_attention_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    port = cs.import_port()
    print(f"card: {cs.card_line()}", flush=True)
    t0 = time.perf_counter()
    port["build"].build(list(LIBS))
    print(f"build {time.perf_counter() - t0:.1f} s")
    spills = []
    for name in LIBS:
        log = port["build"].build_logs().get(name, "")
        for entry, r in cs._ptxas_entries(log).items():
            if KERNELS.search(entry):
                print(f"[ptxas] {entry}: {r}")
                if cs.NO_SPILL.search(entry) and (
                        r.get("spill_stores", 1) or r.get("spill_loads", 1)):
                    spills.append(entry)
        for line in log.splitlines():
            if "warning" in line.lower():
                print(f"[nvcc] {line.strip()}")
    cs.attention_kernel_info(port)
    fails = checks(port)
    if args.time and not fails:
        parent = (parent_kernels(os.path.abspath(args.parent))
                  if args.parent else None)
        timing(port, parent)
    if spills:
        fails += 1
        print(f"FAIL spills: {spills}")
    print(f"failed cases: {fails}")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
