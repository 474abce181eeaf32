#!/usr/bin/env python3
"""Where the time of the split decode (contiguous and paged) and ragged
kernels goes, on the card.

Builds variants of ``csrc/decode_attention.cu`` and
``csrc/ragged_paged_attention.cu``, each cut short at one stage (its
output is then wrong: only its time is read), and times each beside the
kernel itself at ``chip_smoke.py``'s shapes (ragged: the decode-heavy and
the mixed served steps, bf16 and int8; decode: bf16 over 264 and 1024 of
1024 positions; paged: bf16 and int8 over 264 and 1024 positions of 8
pages of 128), one pool or cache per layer so every launch finds its
bytes cold in L2.  The stages, cumulative:

- ``prologue``: every CTA exits once it knows its keys (the launch, the
  grid and the reads of the length, the page table or the plan);
- ``loads``: ... once its K and V have landed in shared memory;
- ``compute``: ... once its scores, softmax and P V are done (ragged);
- ``ticket``: ... once it has written its partial and taken the ticket,
  so no merge runs;
- ``kernel``: the kernel as it is.

and, for the ragged kernel's FMA path (fp32, int8), 32 and 128 keys a
split in place of its 64, and for the paged int8 launch 64 keys a split
in place of its 128 (``int8_keys_64``).  Prints the card's name and power
limit and one line of device ms per launch for each shape.  Run from the
repository root:

    python3 tools/port_attention_variants.py
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402  (the shapes and timing, defined once there)
import port_attention_probe as probe  # noqa: E402

_KS = ("  static constexpr int KS = MMA && RAW >= 128 ? 128 : RAW >= 64 ? 64 : "
       "RAW >= 32 ? 32 : 16;")

# each variant: (source edits, keys a split of the FMA path or None)
RAGGED = {
    "prologue": ([(
        "  const int nsplit = (max_pos / page_size) * a.spp + (max_pos % page_size) / KS + 1;\n",
        "  const int nsplit = (max_pos / page_size) * a.spp + (max_pos % page_size) / KS + 1;\n"
        "  if (nk > 0) return;\n")], None),
    "loads": ([("  __syncthreads();   // K and q in place",
                "  cp_async_wait<0>();\n  __syncthreads();\n  return;")], None),
    "compute": ([("  __syncthreads();   // O, m and l of every row in place",
                  "  __syncthreads();\n  return;")], None),
    "ticket": ([("  if (!*flag) return;", "  return;")], None),
    "kernel": ([], None),
    "fma_keys_32": ([(_KS, _KS.replace("RAW >= 64 ? 64", "!MMA ? 32 : RAW >= 64 ? 64"))],
                    32),
    "fma_keys_128": ([(_KS, _KS.replace("MMA && RAW >= 128", "RAW >= 128 || !MMA"))],
                     128),
}
_SPLIT_KS = ("  static constexpr int KS = RAW >= 128 ? 128 : RAW >= 64 ? 64 : "
             "RAW >= 32 ? 32 : 16;")
# the split decode kernel serves the contiguous and the paged launches:
# each variant cuts both; (source edits, int8 keys a split or None)
DECODE = {
    "prologue": ([(
        "  // 2. all of the split's K, then all of its V, in flight before any\n",
        "  if (nk > 0) return;\n"
        "  // 2. all of the split's K, then all of its V, in flight before any\n")],
        None),
    "loads": ([("  __syncthreads();                     // K and q in place",
                "  cp_async_wait<0>();\n  __syncthreads();\n  return;")], None),
    "ticket": ([("  if (!last) return;", "  return;")], None),
    "kernel": ([], None),
    "int8_keys_64": ([(_SPLIT_KS, _SPLIT_KS.replace(
        "RAW >= 128 ? 128", "RAW >= 128 && (sizeof(KV) > 1 || D != 128) ? 128"))],
        64),
}


def build(port, out_dir):
    """Every variant's library, one nvcc each, all started together:
    ``{(kernel, variant): ctypes.CDLL}``."""
    bld = port["build"]
    csrc = os.path.join(os.path.dirname(bld.BUILD_DIR), "csrc")
    procs = []
    for kind, variants in (("ragged_paged_attention", RAGGED),
                           ("decode_attention", DECODE)):
        text = open(os.path.join(csrc, kind + ".cu")).read()
        for name, (edits, _) in variants.items():
            src = text
            for old, new in edits:
                if old not in src:
                    raise RuntimeError(f"{kind} {name}: the source changed; "
                                       f"no {old[:60]!r}")
                src = src.replace(old, new)
            d = os.path.join(out_dir, f"{kind}-{name}")
            os.makedirs(d, exist_ok=True)
            for f, body in ((kind + ".cu", src), ("vec16.cuh", open(
                    os.path.join(csrc, "vec16.cuh")).read())):
                with open(os.path.join(d, f), "w") as fh:
                    fh.write(body)
            so = os.path.join(d, "lib.so")
            procs.append((kind, name, so, subprocess.Popen(
                [bld._nvcc(), *bld.NVCC_FLAGS, "-o", so,
                 os.path.join(d, kind + ".cu")], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for kind, name, so, p in procs:
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"{kind} {name}: nvcc failed\n{log[-4000:]}")
        libs[(kind, name)] = ctypes.CDLL(so)
    return libs


def ragged_launch(port, lib, fma_keys):
    """A launch of variant ``lib`` with the wrapper's arguments."""
    torch, da, rpa = port["torch"], port["da"], port["rpa"]
    i32, ptr = ctypes.c_int, ctypes.c_void_p
    fn = lib.rpa_forward
    fn.argtypes = [i32, i32] + [ptr] * 15 + [ctypes.c_longlong] + [i32] * 7 + [
        ctypes.c_float, i32, i32, ptr, ptr, ptr]
    ws = {}

    def launch(q, kp, vp, tables, lengths, plan, k_scale=None, v_scale=None):
        t, h, d = q.shape
        page = kp.shape[2]
        keys = (fma_keys if fma_keys and kp.dtype != torch.bfloat16
                else rpa.keys_per_split(d, kp.dtype))
        spp = -(-page // keys)
        nb, wl = plan[0].shape[0], plan[5].shape[0]
        if not ws:
            ws["p"] = torch.empty(wl * spp * h * 16 * (d + 2),
                                  dtype=torch.float32, device=q.device)
            ws["t"] = torch.zeros(nb * h, dtype=torch.int32, device=q.device)
        out = torch.empty((t, h, d), dtype=q.dtype, device=q.device)
        err = fn(q.device.index, rpa.KERNEL_DTYPES[kp.dtype], q.data_ptr(),
                 kp.data_ptr(), vp.data_ptr(),
                 *da.scale_pointers(k_scale, v_scale), out.data_ptr(),
                 *(a.data_ptr() for a in plan), q.stride(0), t, h, d, page,
                 rpa.TOKEN_BLOCK, nb, wl, 1.0 / d ** 0.5, keys, spp,
                 ws["p"].data_ptr(), ws["t"].data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"launch: cudaError {err}"
        return out
    return launch


def decode_launch(port, lib):
    """A bf16 launch of variant ``lib``'s contiguous kernel with the
    wrapper's arguments."""
    torch, da = port["torch"], port["da"]
    i32, i64, ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    fn = lib.decode_attention_forward
    fn.argtypes = [i32, i32, i32, ptr, i64, i64, ptr, ptr, ptr, ptr, i64, i64,
                   i64, ptr, ptr, i32, i32, i32, ctypes.c_float, i32, i32, ptr,
                   ptr, ptr]
    ws = {}

    def launch(q, k, v, length):
        b, h, s, d = k.shape
        keys = da.keys_per_split(d, k.dtype)
        splits = da.num_splits(s, d, k.dtype)
        if not ws:
            ws["p"] = torch.empty(b * h * splits * (d + 2),
                                  dtype=torch.float32, device=q.device)
            ws["t"] = torch.zeros(b * h, dtype=torch.int32, device=q.device)
        lengths = da.device_lengths(length, 1, k.device)
        out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
        err = fn(k.device.index, da.KERNEL_DTYPES[k.dtype], d, q.data_ptr(),
                 q.stride(0), q.stride(1), k.data_ptr(), v.data_ptr(), 0, 0,
                 *k.stride()[:3], out.data_ptr(), lengths.data_ptr(), b, h, s,
                 1.0 / d ** 0.5, keys, splits, ws["p"].data_ptr(),
                 ws["t"].data_ptr(), torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"launch: cudaError {err}"
        return out
    return launch


def paged_launch(port, lib, int8_keys=None):
    """A launch of variant ``lib``'s paged kernel with the wrapper's
    arguments; an int8 pool takes ``int8_keys`` keys a split when given."""
    torch, da, pa = port["torch"], port["da"], port["pa"]
    i32, i64, ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    fn = lib.paged_attention_forward
    fn.argtypes = [i32, i32, i32, ptr, i64, i64, ptr, ptr, ptr, ptr, ptr,
                   ptr, ptr, i32, i32, i32, i32, ctypes.c_float, i32, i32,
                   ptr, ptr, ptr]
    ws = {}

    def launch(q, kp, vp, tables, lengths, k_scale=None, v_scale=None):
        s, h, d = q.shape
        page, max_pages = kp.shape[2], tables.shape[1]
        keys = (int8_keys if int8_keys and kp.dtype == torch.int8
                else pa.keys_per_split(d, kp.dtype))
        splits = -(-max_pages * page // keys)
        if not ws:
            ws["p"] = torch.empty(s * h * splits * (d + 2),
                                  dtype=torch.float32, device=q.device)
            ws["t"] = torch.zeros(s * h, dtype=torch.int32, device=q.device)
        out = torch.empty((s, h, d), dtype=q.dtype, device=q.device)
        err = fn(q.device.index, da.KERNEL_DTYPES[kp.dtype], d, q.data_ptr(),
                 q.stride(0), q.stride(1), kp.data_ptr(), vp.data_ptr(),
                 *da.scale_pointers(k_scale, v_scale), tables.data_ptr(),
                 lengths.data_ptr(), out.data_ptr(), s, h, page, max_pages,
                 1.0 / d ** 0.5, keys, splits, ws["p"].data_ptr(),
                 ws["t"].data_ptr(), torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"launch: cudaError {err}"
        return out
    return launch


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("port_attention_variants: no CUDA device", file=sys.stderr)
        return 2
    port = cs.import_port()
    print(f"card: {cs.card_line()}", flush=True)
    libs = build(port, os.path.join(port["build"].BUILD_DIR, "variants"))
    P = cs.served_geometry(port["rpa"])["num_pages"]
    rng = np.random.RandomState(1)
    for shape, runs in (("decode_heavy", cs.decode_runs(cs._served_runs(rng, P))),
                        ("mixed", cs.mixed_runs(cs._served_runs(rng, P)))):
        for dtype in ("bfloat16", "int8"):
            ms = {}
            for name, (_, fma_keys) in RAGGED.items():
                if fma_keys and dtype == "bfloat16":
                    continue
                t = cs.time_ragged(port, runs, dtype, plain=False,
                                   launch=ragged_launch(
                                       port, libs[("ragged_paged_attention", name)],
                                       fma_keys))
                ms[name] = min(t["ms"], t["ms_again"])
            print(f"ragged {shape} {dtype} device ms: {ms}", flush=True)
    for n in cs.DECODE_TIMED_LENGTHS:
        ms = {name: probe.time_decode(port, n, decode_launch(
            port, libs[("decode_attention", name)]))
            for name, (_, keys) in DECODE.items() if keys is None}
        print(f"decode bf16 length {n} device ms: {ms}", flush=True)
        for dtype in ("bfloat16", "int8"):
            ms = {name: probe.time_paged(port, n, dtype, paged_launch(
                port, libs[("decode_attention", name)], keys))
                for name, (_, keys) in DECODE.items()
                if keys is None or dtype == "int8"}
            print(f"paged {dtype} length {n} device ms: {ms}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
