#!/usr/bin/env python3
"""A short first look at the port's decode, paged and ragged attention
kernels on the card, for the first call after a change to
``csrc/decode_attention.cu`` or ``csrc/ragged_paged_attention.cu``: build
those two libraries alone, print ptxas's report and the runtime's view
(shared memory, registers, CTAs per SM) of the split decode and ragged
kernels, and run ``chip_smoke.py``'s own checks of them: phase 2's ragged
cases (bf16 and fp32), phase 8's decode and paged cases with the split
boundaries, and phase 12's int8 cases.  With ``--time`` it prints their
times beside the bound and SDPA (phases 2, 8 and 12's timing), and with
``--parent DIR`` also those of the kernels built from the sources under
``DIR`` (an unpacked earlier tree of the repository, e.g. ``git archive``
of the parent commit), in turns on the same card.  Run from the
repository root:

    python3 tools/port_attention_probe.py [--time] [--parent DIR]

It exits nonzero when a case fails or there is no card.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402  (the checks and timings, defined once there)

LIBS = ("decode_attention", "ragged_paged_attention")
KERNELS = re.compile(r"decode_split_kernel|decode_kernel|"
                     r"ragged_paged_attention_kernel")


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
    cases.append(("paged", lambda: cs._paged_case(
        port, "bfloat16", 8, 16, 128, 128, (0, 1, 128, 129, 512, 264, 300,
                                            64), 50)))
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


def parent_kernels(root, port):
    """Wrappers with the current wrappers' arguments around the decode and
    ragged kernels built from ``root``'s sources (their C interface before
    the split: no workspace), for timing in turns with the current ones."""
    torch, da, rpa = port["torch"], port["da"], port["rpa"]
    csrc = os.path.join(root, "paddle_tpu_torch", "ops", "kernels", "csrc")
    out = os.path.join(root, "build")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name in LIBS:
        so = os.path.join(out, f"lib{name}.so")
        procs[name] = (so, subprocess.Popen(
            [port["build"]._nvcc(), *port["build"].NVCC_FLAGS, "-o", so,
             os.path.join(csrc, name + ".cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"parent {name} build failed:\n{log}")
        libs[name] = ctypes.CDLL(so)
    i32, i64, ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    dfn = libs["decode_attention"].decode_attention_forward
    dfn.argtypes = [i32, i32, i32, ptr, i64, i64, ptr, ptr, ptr, ptr, i64,
                    i64, i64, ptr, ptr, i32, i32, i32, ctypes.c_float, ptr]
    rfn = libs["ragged_paged_attention"].rpa_forward
    rfn.argtypes = [i32, i32] + [ptr] * 15 + [i64] + [i32] * 7 + [
        ctypes.c_float, ptr]

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def decode(q, k, v, length):
        b, h, s, d = k.shape
        out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
        lengths = da.device_lengths(length, 1, k.device)
        err = dfn(k.device.index, da.KERNEL_DTYPES[k.dtype], d, q.data_ptr(),
                  q.stride(0), q.stride(1), k.data_ptr(), v.data_ptr(), 0, 0,
                  *k.stride()[:3], out.data_ptr(), lengths.data_ptr(), b, h,
                  s, 1.0 / d ** 0.5, stream())
        assert err == 0, f"parent decode launch: cudaError {err}"
        return out

    def ragged(q, kp, vp, tables, lengths, plan, k_scale=None,
               v_scale=None):
        t, h, d = q.shape
        ks, vs = da.scale_pointers(k_scale, v_scale)
        out = torch.empty((t, h, d), dtype=q.dtype, device=q.device)
        err = rfn(kp.device.index, rpa.KERNEL_DTYPES[kp.dtype], q.data_ptr(),
                  kp.data_ptr(), vp.data_ptr(), ks, vs, out.data_ptr(),
                  *(a.data_ptr() for a in plan), q.stride(0), t, h, d,
                  kp.shape[2], rpa.TOKEN_BLOCK, plan[0].shape[0],
                  plan[5].shape[0], 1.0 / d ** 0.5, stream())
        assert err == 0, f"parent ragged launch: cudaError {err}"
        return out

    return decode, ragged


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


def timing(port, parent):
    """The kernels' times; with ``parent`` also the earlier build's, in the
    order earlier, current, current, earlier."""
    torch = port["torch"]
    P = cs.served_geometry(port["rpa"])["num_pages"]
    rng = np.random.RandomState(1)
    shapes = (("decode_heavy", cs.decode_runs(cs._served_runs(rng, P))),
              ("mixed", cs.mixed_runs(cs._served_runs(rng, P))))
    for name, runs in shapes:
        for dtype in ("bfloat16", "int8"):
            if parent:
                before = cs.time_ragged(port, runs, dtype, plain=False,
                                        launch=parent[1])
            t = cs.time_ragged(port, runs, dtype, plain=False)
            if parent:
                after = cs.time_ragged(port, runs, dtype, plain=False,
                                       launch=parent[1])
            bound = t["bound"][0]
            ms = min(t["ms"], t["ms_again"])
            line = (f"ragged {name} {dtype}: kernel {t['ms']!r} then "
                    f"{t['ms_again']!r} ms, bound {bound!r} "
                    f"({t['bound'][1]}), share {bound / ms:.3f}")
            if parent:
                line += (f"; earlier build {before['ms']!r}, "
                         f"{before['ms_again']!r}, {after['ms']!r}, "
                         f"{after['ms_again']!r} ms")
            print(line, flush=True)
    for n in cs.DECODE_TIMED_LENGTHS:
        t = cs._time_decode_kernels(port, n)
        line = (f"decode bf16 (B 8, H 16, D 128) length {n}: kernel "
                f"{t['decode']!r} then {t['decode_again']!r} ms, SDPA on the "
                f"sliced cache {t['sdpa']!r} (ratio "
                f"{min(t['decode'], t['decode_again']) / t['sdpa']:.3f}), "
                f"bound {t['bound'][0]!r} ({t['bound'][1]}); paged "
                f"{t['paged']!r} then {t['paged_again']!r} ms")
        if parent:
            decode = port["da"].decode_attention
            order = [time_decode(port, n, parent[0]),
                     time_decode(port, n, decode),
                     time_decode(port, n, decode),
                     time_decode(port, n, parent[0])]
            line += f"; earlier, current, current, earlier: {order!r} ms"
        print(line, flush=True)
        i = cs._time_int8_attention(port, n)
        print(f"int8 length {n}: decode {i['decode']!r} ms (bound "
              f"{i['decode_bound'][0]!r}), paged {i['paged']!r} ms (bound "
              f"{i['paged_bound'][0]!r})", flush=True)
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
        parent = (parent_kernels(os.path.abspath(args.parent), port)
                  if args.parent else None)
        timing(port, parent)
    if spills:
        fails += 1
        print(f"FAIL spills: {spills}")
    print(f"failed cases: {fails}")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
