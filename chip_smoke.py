#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on
one NVIDIA Hopper card.  Run it from the root of the repository:

    python3 chip_smoke.py

Phases, in order; any failure ends the script with a nonzero exit and no
result line:

1. build -- compile every kernel library from ``paddle_tpu_torch/ops/
   kernels/csrc`` with nvcc (sm_90a) and print the build seconds and
   ptxas's register/shared-memory report;
2. kernel vs plain -- the hand-written ragged-paged-attention kernel
   against its plain PyTorch version on the card, at the served shape
   (16 heads, head_dim 128, page 128) in bf16 and fp32 and at the tiny
   shape (head_dim 16, page 16): a decode at position 0, blocks
   straddling a page edge, shuffled pool pages, padding blocks and a
   repeated work-list tail; then the kernel's and the plain version's
   times at the decode-heavy served shape beside the bytes bound;
3. serve -- GPT-3 1.3B at full width (hidden 2048, 24 layers, 16 heads,
   vocab 50304) with random bf16 weights from a fixed seed, a bf16 pool,
   8 slots, page 128, max_context 512: 16 requests with prompt lengths
   cycling (64, 200, 120, 380) and 32 new tokens each.  Every request
   must end DONE with 32 tokens, every page must come back, and the
   kernel must have launched once per layer of every fused step;
4. card vs CPU -- gpt_tiny in fp32 served on the card and on the CPU
   from the same weights must give the same greedy tokens.

TF32 is off throughout: fp32 runs in full fp32 on the card.

Output: the card's name and power limit (nvidia-smi), one JSON line with
the kernel's numbers, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""
from __future__ import annotations

import json
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
SERVE_LAYERS = 24
DEVICE = "cuda"


def import_port():
    """Everything of the port this script drives (kept in one place so a
    test can check the imports without a card)."""
    import torch
    from paddle_tpu_torch.models import GPTStackedForPretraining, gpt_1p3b, \
        gpt_tiny
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rpa
    from paddle_tpu_torch.serving import RequestState, ServingEngine

    return dict(torch=torch, GPT=GPTStackedForPretraining, gpt_1p3b=gpt_1p3b,
                gpt_tiny=gpt_tiny, build=_build, rpa=rpa,
                RequestState=RequestState, ServingEngine=ServingEngine)


def _check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------

def phase_build(port):
    t0 = time.perf_counter()
    secs = port["build"].build()
    total = time.perf_counter() - t0
    for name, s in secs.items():
        print(f"[build] {name}: {s:.2f} s")
    for name, log in port["build"].build_logs().items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas] {name}: {line.strip()}")
    print(f"[build] all kernels: {total:.2f} s")
    return total


# ---------------------------------------------------------------------------
# phase 2: kernel vs plain
# ---------------------------------------------------------------------------

def _case(port, runs, *, num_pages, heads, page_size, head_dim, t_max,
          nb_max, wl_max, max_pages, dtype, seed, layers=1, qkv_view=True):
    """Device tensors for one ragged case.  ``layers`` > 1 gives that many
    separate pools (as the model's layers have), for L2-cold timing;
    ``qkv_view`` makes q a view into a fused [T, 3, H, D] QKV buffer, as
    the model passes it, instead of a contiguous tensor."""
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
    td = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(td)

    pool_shape = (layers, num_pages, heads, page_size, head_dim)
    q = (randn(t_max, 3, heads, head_dim)[:, 0] if qkv_view
         else randn(t_max, heads, head_dim))
    return dict(
        q=q, k=randn(*pool_shape),
        v=randn(*pool_shape), tables=torch.from_numpy(tables).to(dev),
        lengths=torch.from_numpy(lengths).to(dev),
        plan=tuple(torch.from_numpy(plan_np[k]).to(dev)
                   for k in rpa.RAGGED_PLAN_FIELDS),
        stats=stats, plan_np=plan_np, dtype=dtype, runs=runs)


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
    the peak rate of the pool dtype.  Returns (ms, "bytes" |
    "operations")."""
    plan = c["plan_np"]
    keys = sum(base + count for base, count, _ in c["runs"])
    kv = keys * heads * head_dim * itemsize * 2
    rows = c["stats"]["n_tokens"] + c["q"].shape[0]     # q read, out written
    qo = rows * heads * head_dim * itemsize
    plan_bytes = sum(a.nbytes for a in plan.values())
    lengths = c["lengths"].cpu().numpy()
    flops = 4.0 * heads * head_dim * float(lengths.sum())
    t_bytes = (kv + qo + plan_bytes) / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[c["dtype"]]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _time_ms(torch, fn, iters):
    """(device ms per call, host ms per call).  A sleep kernel holds the
    stream while the host queues every call, so the events time the
    card's work back to back, not the rate at which Python launches."""
    fn(0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)        # ~0.1 s of device clock cycles
    start.record()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i)
    host = (time.perf_counter() - t0) / iters
    queued_ahead = not start.query()      # the sleep still held the stream
    stop.record()
    torch.cuda.synchronize()
    _check(queued_ahead, "the host did not queue the timed calls within "
           "the sleep kernel; the device timing would be the launch rate")
    return start.elapsed_time(stop) / iters, 1e3 * host


def phase_kernels(port):
    torch, rpa = port["torch"], port["rpa"]
    H, D, PS, MP = 16, 128, 128, 4
    # the served engine's geometry: 8 slots + a 128-token prefill budget
    T_MAX, NB_MAX = 8 + 128, 8 + 128 // rpa.TOKEN_BLOCK
    WL_MAX, P = NB_MAX * MP, 8 * MP + 1
    rng = np.random.RandomState(0)
    errs = []
    served = dict(num_pages=P, heads=H, page_size=PS, head_dim=D,
                  t_max=T_MAX, nb_max=NB_MAX, wl_max=WL_MAX, max_pages=MP)
    for dtype in ("bfloat16", "float32"):
        tb = _served_runs(rng, P)
        mixed = [(0, 1, tb[0]),                  # decode at position 0
                 (400, 1, tb[1]),                # decode over 4 pages
                 (120, 40, tb[2]),               # prefill across a page edge
                 (0, 16, tb[3]),                 # prefill from position 0
                 (255, 1, tb[4]),                # decode at a page's end
                 (127, 2, tb[5])]                # 2-token run over the edge
        decode = [(380 + 3 * i, 1, tb[i]) for i in range(8)]
        for name, runs in (("mixed", mixed), ("decode_heavy", decode)):
            c = _case(port, runs, dtype=dtype, seed=len(errs), **served)
            _check(c["stats"]["n_blocks"] < NB_MAX
                   and c["stats"]["n_items"] < WL_MAX,
                   "cases must leave padding blocks and a repeated tail")
            errs.append(_compare(port, name, c))
        tiny_tb = [np.array(t, np.int32) for t in
                   ([5, 3, 1, 7], [2, 0, 0, 0], [4, 6, 8, 9])]
        tiny = _case(port, [(30, 20, tiny_tb[0]), (0, 1, tiny_tb[1]),
                            (47, 1, tiny_tb[2])],
                     num_pages=10, heads=4, page_size=16, head_dim=16,
                     t_max=28, nb_max=6, wl_max=24, max_pages=4,
                     dtype=dtype, seed=len(errs), qkv_view=False)
        errs.append(_compare(port, "tiny", tiny))

    # timing at the decode-heavy served shape, bf16, one pool per layer
    # (24 x 35 MiB) so each launch finds its pages cold in the 50 MB L2
    tb = _served_runs(rng, P)
    c = _case(port, [(380 + 3 * i, 1, tb[i]) for i in range(8)],
              dtype="bfloat16", seed=99, layers=SERVE_LAYERS, **served)
    args = (c["tables"], c["lengths"])

    def kernel(i):
        rpa.ragged_paged_attention(c["q"], c["k"][i % SERVE_LAYERS],
                                   c["v"][i % SERVE_LAYERS], *args,
                                   c["plan"])

    def plain(i):
        rpa.ragged_paged_attention_plain(c["q"], c["k"][i % SERVE_LAYERS],
                                         c["v"][i % SERVE_LAYERS], *args,
                                         1.0 / D ** 0.5)

    (ms, host), (plain_ms, _) = (_time_ms(torch, kernel, 240),
                                 _time_ms(torch, plain, 24))
    ms2, _ = _time_ms(torch, kernel, 240)
    bound_ms, bound_by = _bound(c, H, D, 2)
    print(f"[kernel] decode_heavy bf16 timing: kernel {ms!r} ms then "
          f"{ms2!r} ms per launch on the device (wrapper host time "
          f"{host!r} ms per call), plain {plain_ms!r} ms, bound "
          f"{bound_ms!r} ms ({bound_by})")
    return dict(max_abs_err=max(errs), ms=min(ms, ms2), plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


# ---------------------------------------------------------------------------
# phase 3: serve GPT-3 1.3B at full width
# ---------------------------------------------------------------------------

# the serve workload, defined once here; tools/port_serve_profile.py
# profiles the same one
SERVE_PROMPT_LENS = (64, 200, 120, 380)
SERVE_REQUESTS = 16
SERVE_NEW_TOKENS = 32


def serve_engine(port):
    """GPT-3 1.3B at full width with random bf16 weights (seed 0), a bf16
    pool, 8 slots, page 128, max_context 512, warmed up by one request
    (cuBLAS handles and allocator pools).  Returns ``(engine, rng)``: the
    workload draws its prompts from ``rng``."""
    cfg = port["gpt_1p3b"]()
    _check(cfg.num_layers == SERVE_LAYERS, "gpt_1p3b has 24 layers")
    model = port["GPT"](cfg, device=DEVICE, dtype="bfloat16", seed=0)
    eng = port["ServingEngine"](model, num_slots=8, page_size=128,
                                max_context=512, cache_dtype="bfloat16")
    rng = np.random.RandomState(0)
    eng.generate_batch([rng.randint(0, cfg.vocab_size, (64,))], 2)
    port["torch"].cuda.synchronize()
    return eng, rng


def serve_workload(port, eng, rng):
    """Submit the 16 requests at once and step ``eng`` until it is idle;
    every request must end DONE with its 32 tokens and every page come
    back.  Returns ``(requests, host seconds per step, wall seconds)``."""
    vocab = eng.model.config.vocab_size
    prompts = [rng.randint(0, vocab, (SERVE_PROMPT_LENS[i % 4],))
               for i in range(SERVE_REQUESTS)]
    t0 = time.perf_counter()
    reqs = [eng.submit(p, SERVE_NEW_TOKENS) for p in prompts]
    step_s = []
    while eng.queue.depth or eng.scheduler.active_slots:
        step_s.append(eng.step()["step_seconds"])
    port["torch"].cuda.synchronize()
    wall = time.perf_counter() - t0
    done = port["RequestState"].DONE
    _check(all(r.state == done and len(r.tokens) == SERVE_NEW_TOKENS
               for r in reqs),
           f"requests not all DONE with {SERVE_NEW_TOKENS} tokens: "
           f"{[(r.state, len(r.tokens)) for r in reqs]}")
    used = eng.metrics()["pages_used"]
    _check(used == 0, f"{used} pages leaked")
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
    return launches


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
    port = import_port()
    # fp32 stays fp32 wherever a kernel is compared with its plain version
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[card] {card}")
    phase_build(port)
    k = phase_kernels(port)
    launches = phase_serve(port)
    phase_card_vs_cpu(port)
    print(card)
    print(json.dumps({"kernels": [{
        "name": "ragged_paged_attention", "route": "cuda",
        "source": "paddle_tpu_torch/ops/kernels/csrc/"
                  "ragged_paged_attention.cu",
        "replaces": "paddle_tpu/ops/pallas_kernels/"
                    "ragged_paged_attention.py:237",
        "launches": launches, "max_abs_err": k["max_abs_err"],
        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
