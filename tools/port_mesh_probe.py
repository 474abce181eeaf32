#!/usr/bin/env python3
"""Mesh training on the card alone: ``chip_smoke.py``'s phases 45-47 (the
kernels at a shard's shapes, GPT-3 1.3B on each mesh of
``MESH_TRAIN_RUNS``, a 2-layer fp32 model at (2, 2, 2) against the CPU)
in a fresh process, without the 44 phases before them.  ``--steps N``
runs N steps of each mesh (at least 3: the first checks the loss and
the launches, the middle ones are timed on the host clock, the last runs
under ``torch.profiler``).  ``--cards N`` runs phase 47 alone with its
eight mesh positions over N distinct cards (round-robin, replica 1's
shifted by one card, so each part's replicas, stages and shards sit on
different cards): the transfers, the per-device beta powers, flags and
clip sums that one card never exercises.  ``--parent DIR`` first times
phase 6 (GPT-3 1.3B without a mesh) in turns from another tree unpacked
at DIR and from this one (parent, this, this, parent; each in its own
process, which builds its tree's kernels), so the two compare within one
call.  ``--fleet`` runs phase 48 alone (the fleet recipe over the
layered GPT at TP=2 PP=2, and its 2-layer copy against the CPU); with
``--cards 4`` its four positions are four distinct cards, one a
position, as config 3 lays them out.  ``--fleet`` with ``--dp N``,
``--recompute-interval K`` or ``--virtual V`` runs phase 49 alone at
that layout instead (dp N x pp 2 x mp 2, 8 N rows; phase 49's own is
``--dp 2 --recompute-interval 1 --virtual 2``), its meta-optimizer runs
at the same dp; with ``--cards 4`` its 4 N positions take the four cards
in mesh order, N of them a card (a (shard 0, shard 1) pair a card at N
= 2).  ``--fleet --sharding N`` runs phase 50 alone instead (ZeRO
through ``group_sharded_parallel`` at pp 2 x sharding N x mp 2, 8 N rows,
at ``--level`` os, os_g or p_g_os, or at phase 50's os and p_g_os
without it), printing the parameter, gradient and optimizer-state bytes
of each mesh position and the peak memory; with ``--cards 4`` its 4 N
positions take the four cards in mesh order, N of them a card (a
(shard 0, shard 1) pair a card at N = 2).  ``--zero-serving`` runs
phase 57e alone (a serving mesh over a stacked GPT under ZeRO
``p_g_os``).  ``--sp`` runs phase 51 alone (the flash kernels at the ring's block shapes and ``RingAttention``
against their plain versions, GPT-3 1.3B with ``sequence_parallel`` at
sp 2 and sp 2 x mp 2 against the unplaced layered model, the 2-layer
copy against the CPU and the axes no model reads); with ``--cards 4``
its mesh positions take the four cards in mesh order, so each sp
position holds a tied copy on a card of its own, and the ring's shards
lie on cards of their own.  ``--sp --dp 2`` runs phase 58's
``DataParallel`` run alone (dp replicas of the layered GPT whose sp
positions hold copies of their own, each replica's sp position 1 a copy
on the CPU beside the card), ``--sp --sharding 2`` its two
``group_sharded_parallel`` runs (``--level`` one of them, or os_g), each
for 2 steps, the second under the profiler; with ``--cards 4`` every
replica's every sp position is a card of its own, so the copies must
equal their sources bit for bit.  ``--generate`` runs phase 46's (1, 2, 2) and
(2, 2, 2) runs, then phases 52-53 (generation and serving from the
trained (1, 2, 2) model against the unplaced one, the layered GPT at mp
2, the 2-layer copy against the CPU; batches placed over the mesh); with
``--cards 4`` the same with every mesh position on its own card
(round-robin) and without the CPU copy, phase 46 with its recompute and
the (2, 2, 2) run's ``use_tensor_parallel`` head, whose checkpoints'
backward spans distinct cards.  With
``--parent DIR`` as well, it first runs phase 46's (1, 2, 2) run with
recompute over four cards from the tree unpacked at DIR, in a process of
its own, and prints how it ended.  ``--cards N --recompute-interval K``
runs phase 47 with recompute every K blocks.  ``--recompute`` runs phase
54 alone (a recompute whose backward spans the card and the CPU, through
each of the port's checkpointing entries); with ``--parent DIR`` it
first runs the same MLP through the tree at DIR's ``pp_spmd.checkpointed``
and ``fleet.recompute`` (and ``torch.utils.checkpoint`` itself), in a
process of its own, and prints how each ended.  ``--auto-parallel`` runs
phase 55 alone (auto_parallel's annotations over the captured layered
GPT, run per mesh position through the flash kernel).  ``--engine`` runs
phase 56 alone (auto_parallel's ``Engine`` at GPT-3 13B widths, 2 layers:
``cost``, ``plan`` over four positions of the card, ``fit`` through the
propagation executor over the placed blocks against an unplanned
Engine, the checkpoint and the fp32 copy); with ``--cards 4`` the plan's
four positions, and the fp32 copy's, are four distinct cards.  ``--engine
--level os|os_g|p_g_os`` runs phase 59 alone at that ZeRO level (at
``p_g_os`` beside ``os_g``, whose step-2 peak it must undercut), each
card's peak and host ms a step; with ``--parent DIR`` it first runs the
tree at DIR's phase 56 over the same cards in a process of its own and
prints each card's peak over it.  ``--layers N[,M...]`` then trains
this tree's Engine at GPT-3 13B widths and N layers (then M, ... until
one trains), the model built on the CPU and planned over the cards under
``--level``, 2 steps, each card's peak and host ms a step; with
``--parent DIR`` the tree at DIR's Engine at that depth, its model on
card 0, in a process of its own, and how it ended.  ``--serve-cluster`` times phases 41-44
(sharded, int8, disaggregated and elastic serving) in a process of its
own after the kernels are built; with ``--parent DIR`` in turns from the
tree unpacked at DIR and from this one (parent, this, this, parent), so
the two compare on one machine.  ``--placed-serving`` runs phase 57
after what it reads (phase 46's (1, 2, 2) run and phase 52 without its
CPU copy): fault 11's recipe with replica 1 on the CPU, then LoRA, a
speculative draft and the sharded engine over the placed models against
the unplaced ones; with ``--cards 4`` every mesh position on its own card
(round-robin) and fault 11's replicas on cards of their own (replica 0's
stages on cards 0 and 1, replica 1's on 2 and 3).
Run from the repository root:

    python3 tools/port_mesh_probe.py [--steps N] [--parent DIR]
    python3 tools/port_mesh_probe.py --cards 4
    python3 tools/port_mesh_probe.py --fleet [--cards 4]
    python3 tools/port_mesh_probe.py --fleet --dp 2 --recompute-interval 1 \
        --virtual 2 [--cards 4]
    python3 tools/port_mesh_probe.py --fleet --sharding 2 \
        [--level os|os_g|p_g_os] [--cards 4]
    python3 tools/port_mesh_probe.py --sp [--cards 4]
    python3 tools/port_mesh_probe.py --sp --dp 2 [--cards 4]
    python3 tools/port_mesh_probe.py --sp --sharding 2 \
        [--level os|os_g|p_g_os] [--cards 4]
    python3 tools/port_mesh_probe.py --zero-serving
    python3 tools/port_mesh_probe.py --generate [--cards 4 [--parent DIR]]
    python3 tools/port_mesh_probe.py --cards 4 --recompute-interval 1
    python3 tools/port_mesh_probe.py --recompute [--parent DIR]
    python3 tools/port_mesh_probe.py --auto-parallel
    python3 tools/port_mesh_probe.py --engine [--cards 4]
    python3 tools/port_mesh_probe.py --engine --level os|os_g|p_g_os \
        [--cards 4] [--parent DIR] [--layers 40[,32,...]]
    python3 tools/port_mesh_probe.py --serve-cluster [--parent DIR]
    python3 tools/port_mesh_probe.py --placed-serving [--cards 4]

It exits nonzero when a check fails or there is no card.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (the phases, defined once there)

PHASE6 = """
import sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
cs.phase_train(cs.import_port())
"""


def _phase6_in_turns(parent: str):
    for tree in (parent, ROOT, ROOT, parent):
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-c", PHASE6], cwd=tree,
                             capture_output=True, text=True, timeout=900)
        lines = [x for x in run.stdout.splitlines() if x.startswith("[train]")]
        print(f"[mesh_probe] phase 6 from {tree}: rc {run.returncode}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        print("\n".join(lines) or run.stderr[-3000:], flush=True)
        if run.returncode:
            raise RuntimeError(f"phase 6 failed in {tree}")


RECOMPUTE_OVER_CARDS = """
import sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
cs._mesh_devices = lambda n: [f"cuda:{j % 4}" for j in range(n)]
torch.backends.cuda.matmul.allow_tf32 = False
cs.phase_mesh_train(cs.import_port(),
                    tuple(r for r in cs.MESH_TRAIN_RUNS if r[0] == "1x2x2"))
"""


def _recompute_over_cards(tree: str):
    """Phase 46's (1, 2, 2) run with recompute, its positions on four
    cards, from ``tree`` in a process of its own: how it ended."""
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-c", RECOMPUTE_OVER_CARDS],
                         cwd=tree, capture_output=True, text=True,
                         timeout=900)
    errs = [x for x in run.stderr.splitlines() if "Error" in x]
    print(f"[mesh_probe] phase 46 (1, 2, 2) with recompute over four cards "
          f"from {tree}: rc {run.returncode}, "
          f"{time.perf_counter() - t0:.1f} s; last error: "
          f"{errs[-1] if errs else None}", flush=True)
    print("\n".join(x for x in run.stdout.splitlines()
                    if x.startswith("[mesh_train]")), flush=True)


RECOMPUTE_AT_PARENT = """
import importlib.util, sys, torch
sys.path.insert(0, ".")
spec = importlib.util.spec_from_file_location("cs", {smoke!r})
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
torch.backends.cuda.matmul.allow_tf32 = False
from torch.utils.checkpoint import checkpoint
from paddle_tpu_torch.distributed import fleet, pp_spmd
cases = (("torch.utils.checkpoint",
          lambda fn, *a: checkpoint(fn, *a, use_reentrant=False)),
         ("pp_spmd.checkpointed full",
          lambda fn, *a: pp_spmd.checkpointed(fn, None)(*a)),
         ("pp_spmd.checkpointed dots",
          lambda fn, *a: pp_spmd.checkpointed(fn, "dots")(*a)),
         ("fleet.recompute", fleet.recompute))
cs.phase_recompute_across_devices(torch, cases, strict=False)
"""


def _recompute_at(tree: str):
    """Phase 54's MLP through the checkpoints of the tree at ``tree`` (and
    ``torch.utils.checkpoint``), in a process of its own: how each case
    ended, recorded rather than raised."""
    code = RECOMPUTE_AT_PARENT.format(
        smoke=os.path.join(ROOT, "chip_smoke.py"))
    run = subprocess.run([sys.executable, "-c", code], cwd=tree,
                         capture_output=True, text=True, timeout=600)
    print(f"[mesh_probe] phase 54's MLP through the checkpoints of {tree}: "
          f"rc {run.returncode}", flush=True)
    print(run.stdout[-6000:] or run.stderr[-3000:], flush=True)


SERVE_CLUSTER = """
import sys, time, torch
sys.path.insert(0, ".")
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
port = cs.import_port()
port["build"].build()
for n, fn in ((41, cs.phase_sharded_serve), (42, cs.phase_sharded_int8),
              (43, cs.phase_disagg), (44, cs.phase_cluster_card_vs_cpu)):
    t0 = time.perf_counter()
    fn(port)
    print(f"[time] phase {n} {time.perf_counter() - t0:.1f} s", flush=True)
"""


def _serve_cluster(trees):
    """Phases 41-44 from each tree in ``trees``, each in a process of its
    own (which builds its tree's kernels first, untimed): their times."""
    for tree in trees:
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-c", SERVE_CLUSTER], cwd=tree,
                             capture_output=True, text=True, timeout=1200)
        lines = [x for x in run.stdout.splitlines() if x.startswith("[time]")]
        print(f"[mesh_probe] phases 41-44 from {tree}: rc {run.returncode}, "
              f"{time.perf_counter() - t0:.1f} s with the build; "
              + "; ".join(lines), flush=True)
        if run.returncode:
            print(run.stderr[-3000:], flush=True)
            raise RuntimeError(f"phases 41-44 failed in {tree}")


ENGINE_AT_PARENT = """
import sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
cards = {cards!r}
cs.phase_engine(cs.import_port(), cards)
print("[mesh_probe] the parent's phase 56: each card's peak GiB",
      [round(torch.cuda.max_memory_allocated(i) / 2 ** 30, 3)
       for i in range(torch.cuda.device_count())], "(card 0 since its "
      "fit's reset, the "
      "others over the process)", flush=True)
"""

ENGINE_DEPTH_AT_PARENT = """
import sys, time, torch
sys.path.insert(0, ".")
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
port = cs.import_port()
cfg = port["gpt_13b"](num_layers={layers}, hidden_dropout=0.0,
                      attention_dropout=0.0)
cards = {cards!r}
end = "trained"
try:
    eng, model, opt = cs._engine(port, cfg, "bfloat16", "cuda:0", 59, cards)
    n = sum(p.numel() for p in model.parameters())
    eng.plan(batch=cs.ENGINE_BATCH, cluster=port["auto_parallel"]
             .ClusterSpec(n_devices=len(cards), hbm_bytes=8.0 * n))
    for b in cs._engine_batches(torch, cfg.vocab_size, cs.ENGINE_BATCH,
                                cs.ENGINE_SEQ, 2, "cuda:0", 59):
        eng.fit([b], verbose=0)
    end += f" {{eng.history['loss']}}"
except torch.OutOfMemoryError as e:
    end = "out of memory: " + str(e).splitlines()[0]
print("[mesh_probe] the parent's Engine at {layers} layers:", end,
      "; each card's peak GiB",
      [round(torch.cuda.max_memory_allocated(i) / 2 ** 30, 3)
       for i in range(torch.cuda.device_count())], flush=True)
"""


def _in_tree(tree: str, code: str, what: str):
    """``code`` run from ``tree`` in a process of its own: its
    ``[mesh_probe]``, ``[engine]`` and ``[time]`` lines, and how it
    ended."""
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-c", code], cwd=tree,
                         capture_output=True, text=True, timeout=1800)
    print(f"[mesh_probe] {what} from {tree}: rc {run.returncode}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print("\n".join(x for x in run.stdout.splitlines()
                    if x.startswith(("[mesh_probe]", "[engine]", "[time]"))),
          flush=True)
    if run.returncode:
        print(run.stderr[-3000:], flush=True)


def _engine_depth(port, layers: int, level: str, cards) -> bool:
    """This tree's Engine at GPT-3 13B widths and ``layers`` layers: the
    model built on the CPU (whole, with the optimizer's state) and
    planned over ``cards``, 2 steps under ZeRO ``level``; prints each
    card's peak and host ms a step and the bytes a position holds, and
    returns whether both steps ran (a step out of memory is recorded)."""
    torch, ap = port["torch"], port["auto_parallel"]
    cfg = port["gpt_13b"](num_layers=layers, hidden_dropout=0.0,
                          attention_dropout=0.0)
    t0 = time.perf_counter()
    eng, model, opt = cs._engine(port, cfg, "bfloat16", "cpu", 59, cards,
                                 level=level)
    n = sum(p.numel() for p in model.parameters())
    t_build = time.perf_counter() - t0
    best = eng.plan(batch=cs.ENGINE_BATCH, cluster=ap.ClusterSpec(
        n_devices=len(cards), hbm_bytes=8.0 * n))
    t_plan = time.perf_counter() - t0 - t_build
    batches = cs._engine_batches(torch, cfg.vocab_size, cs.ENGINE_BATCH,
                                 cs.ENGINE_SEQ, 2, "cpu", 59)
    idx = sorted({torch.device(d).index or 0 for d in cards})
    host, peaks, end = [], [], "trained"
    try:
        for b in batches:
            for i in idx:
                torch.cuda.synchronize(i)
                torch.cuda.reset_peak_memory_stats(i)
            t1 = time.perf_counter()
            eng.fit([b], verbose=0)
            for i in idx:
                torch.cuda.synchronize(i)
            host.append(round(1e3 * (time.perf_counter() - t1), 1))
            peaks.append([round(torch.cuda.max_memory_allocated(i) / 2 ** 30,
                                3) for i in idx])
    except torch.OutOfMemoryError as e:
        end = "out of memory: " + str(e).splitlines()[0]
    held = eng.placement.state_bytes(opt)
    print(f"[mesh_probe] this tree's Engine at {layers} layers ({n} "
          f"parameters), {level} over {dict(best.mesh)} on {cards}: {end}; "
          f"losses {eng.history['loss']}; host ms a step {host} (step 1 "
          f"with the capture and the slicing); each card's peak a step "
          f"{peaks} GiB; built on the CPU in {t_build:.1f} s, planned in "
          f"{t_plan:.1f} s; bytes at rest by position {held}", flush=True)
    ok = end == "trained"
    del eng, model, opt
    cs.gc.collect()
    torch.cuda.empty_cache()
    port["mesh"].set_mesh(None)
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=0,
                    help="steps of each mesh run (default: MESH_TRAIN_RUNS')")
    ap.add_argument("--parent", default=None,
                    help="a tree to time phase 6 against, in turns")
    ap.add_argument("--cards", type=int, default=0,
                    help="phase 47 alone over this many distinct cards")
    ap.add_argument("--fleet", action="store_true",
                    help="phase 48 alone (phase 49 with --dp, "
                    "--recompute-interval or --virtual)")
    ap.add_argument("--dp", type=int, default=0,
                    help="phase 49's replicas (with --fleet); 2 with --sp: "
                    "phase 58's DataParallel run")
    ap.add_argument("--recompute-interval", type=int, default=None,
                    help="phase 49's recompute_interval (with --fleet)")
    ap.add_argument("--virtual", type=int, default=None,
                    help="phase 49's virtual stages (with --fleet)")
    ap.add_argument("--sharding", type=int, default=0,
                    help="phase 50's sharding degree (with --fleet); 2 "
                    "with --sp: phase 58's ZeRO runs")
    ap.add_argument("--level", choices=("os", "os_g", "p_g_os"),
                    default=None,
                    help="phase 50's one ZeRO level (with --sharding); "
                    "with --engine, phase 59 at that level")
    ap.add_argument("--layers", default=None,
                    help="with --engine --level: depths to train at GPT-3 "
                    "13B widths, tried in turn until one trains")
    ap.add_argument("--sp", action="store_true",
                    help="phase 51 alone (sequence parallelism)")
    ap.add_argument("--generate", action="store_true",
                    help="phases 52-53 after phase 46's kept runs")
    ap.add_argument("--recompute", action="store_true",
                    help="phase 54 alone (a recompute across devices)")
    ap.add_argument("--auto-parallel", action="store_true",
                    help="phase 55 alone (auto_parallel)")
    ap.add_argument("--engine", action="store_true",
                    help="phase 56 alone (auto_parallel's Engine)")
    ap.add_argument("--placed-serving", action="store_true",
                    help="phase 57 after phases 46 (1, 2, 2) and 52")
    ap.add_argument("--zero-serving", action="store_true",
                    help="phase 57e alone (a serving mesh over a stacked "
                    "GPT under ZeRO)")
    ap.add_argument("--serve-cluster", action="store_true",
                    help="phases 41-44's times (with --parent, in turns)")
    args = ap.parse_args()
    dp_run = bool(args.dp) or (args.recompute_interval is not None
                               and not args.cards) \
        or args.virtual is not None
    if args.cards and args.recompute_interval is not None \
            and not args.fleet:
        cs.MESH_CPU_RECOMPUTE = args.recompute_interval
        dp_run = bool(args.dp) or args.virtual is not None
    sp_replicas = args.sp and (args.dp or args.sharding)
    if sp_replicas and (args.dp or args.sharding) != 2:
        ap.error("--sp takes --dp 2 or --sharding 2 (phase 58's meshes)")
    if (dp_run or args.sharding) and not (args.fleet or sp_replicas):
        ap.error("--dp, --recompute-interval (without --cards), --virtual "
                 "and --sharding go with --fleet (--dp 2 and --sharding 2 "
                 "also with --sp)")
    if args.level and not (args.sharding or args.engine):
        ap.error("--level goes with --sharding or --engine")
    if args.layers and not (args.engine and args.level):
        ap.error("--layers goes with --engine --level")
    if dp_run and args.sharding:
        ap.error("--sharding runs phase 50: no --dp, --recompute-interval "
                 "or --virtual")
    import torch

    if not torch.cuda.is_available():
        print("port_mesh_probe: no CUDA device", file=sys.stderr)
        return 2
    if args.steps and args.steps < 3:
        ap.error("--steps must be at least 3")
    if args.cards > torch.cuda.device_count():
        ap.error(f"--cards {args.cards}: {torch.cuda.device_count()} visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {cs.card_line()}", flush=True)
    if args.serve_cluster:
        _serve_cluster([os.path.abspath(args.parent), ROOT, ROOT,
                        os.path.abspath(args.parent)] if args.parent
                       else [ROOT])
        return 0
    if args.parent and args.recompute:
        _recompute_at(os.path.abspath(args.parent))
    elif args.parent and args.generate and args.cards >= 4:
        _recompute_over_cards(os.path.abspath(args.parent))
    elif args.parent and args.engine:
        n = args.cards if args.cards >= 4 else 0
        cards = [f"cuda:{j}" for j in range(n)] or None
        _in_tree(os.path.abspath(args.parent),
                 ENGINE_AT_PARENT.format(cards=cards), "phase 56")
    elif args.parent:
        _phase6_in_turns(os.path.abspath(args.parent))
    runs = tuple(r[:-1] + (args.steps or r[-1],)
                 for r in cs.MESH_TRAIN_RUNS)
    devices = None
    port = cs.import_port()
    phases = (("45", cs.phase_mesh_kernels),
              ("46", lambda p: cs.phase_mesh_train(p, runs)),
              ("47", lambda p: cs.phase_mesh_card_vs_cpu(p, devices)))
    if args.generate:
        kept = {}
        keep_runs = tuple(r for r in runs if r[0] in cs.MESH_KEEP)
        phases = (("46", lambda p: cs.phase_mesh_train(p, keep_runs, kept)),
                  ("52", lambda p: cs.phase_mesh_generate(p, kept)),
                  ("53", lambda p: cs.phase_placed_batches(p, kept)))
        if args.cards >= 4:
            # every mesh position on its own card, round-robin
            cs._mesh_devices = lambda n: [f"cuda:{j % 4}" for j in range(n)]
            phases = (("46", lambda p: cs.phase_mesh_train(p, keep_runs,
                                                           kept)),
                      ("52", lambda p: cs.phase_mesh_generate(p, kept,
                                                              cpu=False)),
                      phases[2])
    elif args.placed_serving:
        kept = {}
        keep_runs = tuple(r for r in runs if r[0] == "1x2x2")
        if args.cards >= 4:
            cs._mesh_devices = lambda n: [f"cuda:{j % 4}" for j in range(n)]
            cs.SCALER_DEVICES = tuple(f"cuda:{j}" for j in range(4))
        phases = (("46", lambda p: cs.phase_mesh_train(p, keep_runs, kept)),
                  ("52", lambda p: cs.phase_mesh_generate(p, kept,
                                                          cpu=False)),
                  ("57a", cs.phase_scaler_across_devices),
                  ("57", lambda p: cs.phase_placed_serving(p, kept)))
    elif args.recompute:
        phases = (("54", lambda p: cs.phase_recompute_across_devices(
            p["torch"], cs.recompute_cases(p))),)
    elif args.auto_parallel:
        phases = (("55", cs.phase_auto_parallel),)
    elif args.engine and args.level:
        cards = ([f"cuda:{j}" for j in range(4)] if args.cards >= 4
                 else None)
        levels = ("os_g", "p_g_os") if args.level == "p_g_os" \
            else (args.level,)
        phases = (("59", lambda p: cs.phase_engine_zero(
            p, cards, levels=levels, cpu_levels=(args.level,))),)
        if args.layers:
            depth_cards = cards or ["cuda:0"] * 4

            def deepest(p):
                for n in (int(x) for x in args.layers.split(",")):
                    if _engine_depth(p, n, args.level, depth_cards):
                        break
                if args.parent:
                    _in_tree(os.path.abspath(args.parent),
                             ENGINE_DEPTH_AT_PARENT.format(
                                 layers=n, cards=depth_cards),
                             f"the Engine at {n} layers")
            phases += (("59 depth", deepest),)
    elif args.engine:
        cards = ([f"cuda:{j}" for j in range(4)] if args.cards >= 4
                 else None)
        phases = (("56", lambda p: cs.phase_engine(p, cards)),)
    elif sp_replicas:
        axis = "dp" if args.dp else "sharding"
        cs.SPR_RUNS = tuple(r for r in cs.SPR_RUNS if axis in r[1] and (
            args.level is None or r[2] in (None, args.level)))
        if args.level and not cs.SPR_RUNS:
            cs.SPR_RUNS = ((f"sharding2_sp2_{args.level}",
                            {"sharding": 2, "sp": 2}, args.level, 2),)
        cards = (tuple(f"cuda:{j}" for j in range(4)) if args.cards >= 4
                 else cs.SPR_DEVICES)
        phases = (("58", lambda p: cs.phase_sp_replicas(p, cards, 2)),)
    elif args.zero_serving:
        phases = (("57e", cs.phase_zero_serving),)
    elif args.sp:
        cards = ([f"cuda:{j}" for j in range(4)] if args.cards >= 4
                 else None)
        phases = (("51", lambda p: cs.phase_sequence_parallel(p, cards)),)
    elif args.fleet and args.sharding:
        n = args.sharding
        cs.FLEET_ZERO_HYBRID = dict(cs.FLEET_ZERO_HYBRID, sharding_degree=n)
        cs.FLEET_ZERO_BATCH = 8 * n
        if args.level:
            cs.FLEET_ZERO_LEVELS = (args.level,)
        cards = ([f"cuda:{j // n}" for j in range(4 * n)]
                 if args.cards >= 4 else None)
        phases = (("50", lambda p: cs.phase_fleet_zero(p, cards)),)
    elif args.fleet and dp_run:
        dp = args.dp or cs.FLEET_DP_HYBRID["dp_degree"]
        cs.FLEET_DP_HYBRID = dict(cs.FLEET_DP_HYBRID, dp_degree=dp)
        cs.FLEET_DP_BATCH = 8 * dp
        if args.recompute_interval is not None:
            cs.FLEET_DP_RECOMPUTE = args.recompute_interval
        if args.virtual is not None:
            cs.FLEET_DP_VIRTUAL = args.virtual
        cards = ([f"cuda:{j // dp}" for j in range(4 * dp)]
                 if args.cards >= 4 else None)
        phases = (("49", lambda p: cs.phase_fleet_dp(p, cards)),)
    elif args.fleet:
        cards = ([f"cuda:{j}" for j in range(4)] if args.cards >= 4
                 else None)
        phases = (("48", lambda p: cs.phase_fleet_train(p, cards)),)
    elif args.cards:
        n = args.cards
        devices = [f"cuda:{(j + j // n) % n}" for j in range(8)]
        phases = phases[2:]
    for name, phase in phases:
        t0 = time.perf_counter()
        phase(port)
        print(f"[mesh_probe] phase {name} {time.perf_counter() - t0:.1f} s",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
