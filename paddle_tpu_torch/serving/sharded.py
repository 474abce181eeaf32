"""Sharded serving: ``dp`` replica engines x ``mp`` head shards behind
ONE placement scheduler (port of ``paddle_tpu/serving/sharded.py``).

``ShardedServingEngine`` is the cluster front end:

- it builds one ``mp``-device mesh per ``dp`` replica
  (``distributed/serving_mesh.replica_meshes``: the first ``dp*mp`` visible
  cards by default, or ``devices``, where naming a device more than once
  puts replicas or shards on it together), gives each replica its OWN
  model copy split over its mesh (``shard_model_for_serving``) and its own
  :class:`ServingEngine` -- pool, slots, admission and fault containment
  all per replica;
- each replica's pool is sharded per head (``[P, H/mp, page, D]`` a
  shard, on the shard's device); the ragged kernel runs per shard at
  ``H/mp`` heads, and the row-parallel partials of the attention output
  projection and of fc2 meet in one reduce each;
- ``submit`` goes through the placement layer
  (``serving/placement.py``): least-loaded replica wins, queue-depth
  backpressure is the signal, and a typed ``Overloaded`` shed happens
  only when EVERY replica backpressures.

Replicas on disjoint devices step on a ``ThreadPoolExecutor`` (one
thread a replica), as the reference's do: each engine's step holds only
its own lock and drives only its own model and pool, so one replica's
host work overlaps another's device work.  A replica thread launches on
its current stream, which is its device's default stream unless the
caller set another, and the kernels' per-(device, stream) workspaces are
shared safely (``ops/kernels/decode_attention.workspace`` grows them
under a lock; the launch counters count under a lock).  Replicas that
share a device (``devices`` naming it more than once) step one after
another on the calling thread (:func:`steps_on_threads` decides): their
device work runs in the card's stream order either way, and two threads
dispatching PyTorch ops hand the GIL back and forth at every op (PyTorch
releases it around each one), which made a co-resident dp=2 tick about
twice as slow on an H100 as stepping in order (PERF.md, PR 13).  An
engine built with ``stall_budget_s`` supervises its step on its own
watchdog thread from inside the pool thread: the watchdog needs nothing
of the thread that calls ``step()``.

Elasticity: each replica is active, draining (admission stopped, seated
work finishing), parked (drained, not stepping) or dead (killed; its live
requests re-homed through placement).  The brownout actuators
(``set_max_new_cap``, ``set_speculation``, ``shrink_prefill_budget``,
``restore_prefill_budget``, ``set_shedding``) are driven by
``serving/elastic.py``.
"""
from __future__ import annotations

import itertools
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional

import numpy as np

from ..distributed import serving_mesh as _srv_mesh
from ..telemetry import metrics as _tmetrics
from .engine import (
    Overloaded,
    Request,
    RequestState,
    ServingEngine,
    ServingError,
)
from .placement import LeastLoadedPlacement, PlacementScheduler

__all__ = ["ShardedServingEngine"]

_CLUSTER_SEQ = itertools.count()


def steps_on_threads(meshes) -> bool:
    """Whether replicas over ``meshes`` step on a thread pool: when no
    device serves two replicas (module docstring)."""
    seen = [d for mesh in meshes for d in set(mesh)]
    return len(seen) == len(set(seen))


class ShardedServingEngine:
    """``dp`` x ``mp`` sharded serving behind one submit/step interface.

    ``model`` becomes replica 0 (moved to replica 0's first device and
    split over its mesh, its whole projections dropped at mp > 1: the
    engine takes ownership of its placement; ``serving_mesh.
    unshard_model`` gives them back; a model placed on a training mesh
    leaves it first, its ``leave_training_mesh``);
    further replicas are copies with its exact weights
    (``serving_mesh.clone_model``; ``model_factory`` builds the fresh
    instance for classes whose ``__init__`` needs more than the config).
    ``devices``: ``dp*mp`` devices, replica after replica (default: the
    first ``dp*mp`` visible cards; fewer raise).  Engine knobs
    (``num_slots``, ``page_size``, pool sizing, fault containment, ...)
    pass through to every replica unchanged -- they are per-replica
    quantities, so aggregate capacity is ``dp`` times each.
    ``engine_factory(model, mesh, index, **engine_kw)`` builds a replica's
    engine instead (a speculative or LoRA-pooled replica).  The replicas
    step on a thread pool when :func:`steps_on_threads` says so."""

    def __init__(self, model, *, dp: int = 1, mp: int = 1,
                 devices=None, model_factory: Optional[Callable] = None,
                 placement=None, engine_factory: Optional[Callable] = None,
                 **engine_kw):
        dp, mp = int(dp), int(mp)
        if mp > 1:
            # hard shard precondition, typed at construction (GL002
            # wording), not an error deep in the first step
            _srv_mesh.validate_head_sharding(model.config.num_heads, mp)
        self.dp, self.mp = dp, mp
        self.meshes = _srv_mesh.replica_meshes(dp, mp, devices)
        self.replicas: List[ServingEngine] = []
        # every copy is made before replica 0 is sharded (a sharded
        # model's weights would be gathered back for each), and after it
        # left a training mesh (each copy would hold the placement)
        model.leave_training_mesh()
        models = [model] + [_srv_mesh.clone_model(model, model_factory)
                            for _ in range(dp - 1)]
        for i, (rm, mesh) in enumerate(zip(models, self.meshes)):
            _srv_mesh.shard_model_for_serving(rm, mesh)
            if engine_factory is not None:
                # replica-level composition hook: a speculative replica
                # (SpeculativeEngine + its own draft model) or a
                # LoRA-pooled replica (per-replica slabs).  Signature:
                # (model, mesh, index, **engine_kw).
                eng = engine_factory(rm, mesh, i, **engine_kw)
            else:
                eng = ServingEngine(rm, mesh=mesh, **engine_kw)
            self.replicas.append(eng)
        self.placement = PlacementScheduler(
            self.replicas, policy=placement or LeastLoadedPlacement())
        # per-tick replica stepping on one thread per replica (module
        # docstring)
        self._pool = (ThreadPoolExecutor(
            max_workers=dp, thread_name_prefix="sharded-serving-step")
            if dp > 1 and steps_on_threads(self.meshes) else None)
        # -- elastic lifecycle -----------------------------------------
        # Each replica index is in exactly one state:
        #   active   — stepping, accepting new admissions
        #   draining — stepping (seated work must finish) but admission
        #              stopped; queued work already re-homed
        #   parked   — drained and NOT stepping (scale-down complete;
        #              its chips cost nothing until activate_replica)
        #   dead     — killed/closed; never comes back
        self._parked: set = set()
        self._dead: set = set()
        self._drain_deadline: Dict[int, Optional[float]] = {}
        # chip accounting for the elasticity win: one unit per replica
        # actually stepped per tick — chip-seconds ∝ replica_steps * mp
        self._replica_steps = 0
        # cluster-level fault hook (faults.py `replica_kill` fires at the
        # per-tick "cluster_step" point)
        self._fault_hook = None
        # brownout actuators (driven by serving/elastic.py, LIFO order)
        self.max_new_cap: Optional[int] = None   # rung 1: clamp admissions
        self.shedding = False                    # rung 4: refuse work
        self._orig_prefill_budget = [e.prefill_token_budget
                                     for e in self.replicas]
        label = {"cluster": str(next(_CLUSTER_SEQ))}
        self._cluster_label = label
        reg = _tmetrics.registry()
        self._rehomed_counter = reg.counter(
            "serving_rehomed_requests_total",
            "requests re-homed onto a survivor after a drain or replica "
            "loss").labels(**label)
        self._rehomed_synced = 0
        self._brownout_shed = reg.counter(
            "serving_brownout_shed_total",
            "requests refused at the brownout ladder's shed rung",
        ).labels(**label)

    # -- submission (placement layer) --------------------------------------
    def submit(self, prompt, max_new_tokens: int = 32, **kwargs) -> Request:
        """Place the request on the least-loaded replica and queue it
        there.  Typed ``Overloaded`` only when ALL replicas shed; the
        seated replica's index rides on ``request.replica``.

        Brownout rungs act here (elastic.py): rung 1 clamps ``max_new``
        for NEW admissions (seated requests keep their grant), the shed
        rung refuses work outright — both typed, both counted."""
        if self.shedding:
            self._brownout_shed.inc()
            raise Overloaded(
                "cluster browned out to shedding: offered load exceeds "
                "maximum degraded capacity — back off and retry")
        if self.max_new_cap is not None:
            max_new_tokens = min(int(max_new_tokens), self.max_new_cap)
        return self.placement.submit(prompt, max_new_tokens, **kwargs)

    # -- the serving loop --------------------------------------------------
    _IDLE_ROW = {"active_slots": 0, "queue_depth": 0, "pages_used": 0,
                 "pages_capacity": 0, "occupancy": 0.0,
                 "tokens_this_step": 0}

    def step(self) -> dict:
        """One cluster tick: every live replica runs its own fused step
        (its own admission, pool and fault containment), concurrently
        across replicas when dp > 1.  Returns aggregate step metrics plus
        the per-replica list (replica order preserved; parked/dead
        replicas contribute an all-zero placeholder row).

        Elastic upkeep rides the tick boundary: the ``cluster_step``
        fault hook may kill replicas first (their live work re-homes),
        drains whose replica emptied — or whose deadline passed — are
        finalized, and the placement layer's held re-home queue is swept
        (terminal requests reaped) and retried against freed capacity.
        """
        hook = self._fault_hook
        if hook is not None:
            ctx: dict = {"kill": []}
            hook("cluster_step", ctx)
            for i in ctx["kill"]:
                self.kill_replica(i)
        self._check_drains()
        return self._pooled_step()

    def _replica_step(self, i: int) -> dict:
        """One replica's work for this cluster tick — the subclass seam
        serving/disagg.py uses to run decode-role replicas for several
        sub-steps INSIDE the pooled barrier (their dispatches overlap
        the prefill replicas' longer steps instead of serializing after
        them)."""
        return self.replicas[i].step()

    def _pooled_step(self) -> dict:
        live = [i for i in range(len(self.replicas)) if self._stepping(i)]
        if self._pool is not None and len(live) > 1:
            stepped = dict(zip(live, self._pool.map(self._replica_step,
                                                    live)))
        else:
            stepped = {i: self._replica_step(i) for i in live}
        self._replica_steps += len(live)
        per = [stepped.get(i, dict(self._IDLE_ROW))
               for i in range(len(self.replicas))]
        self.placement.sweep()
        if self.placement.held:
            self.placement.flush_held()
        self._sync_rehomed()
        pages_used = sum(m["pages_used"] for m in per)
        pages_cap = sum(m["pages_capacity"] for m in per)
        agg = {
            "active_slots": sum(m["active_slots"] for m in per),
            "queue_depth": sum(m["queue_depth"] for m in per),
            "pages_used": pages_used,
            "pages_capacity": pages_cap,
            "occupancy": pages_used / pages_cap if pages_cap else 0.0,
            "replica_occupancy": [m["occupancy"] for m in per],
            "tokens_this_step": sum(m["tokens_this_step"] for m in per),
            "replicas": per,
        }
        return agg

    def run_until_idle(self, max_steps: Optional[int] = None) -> dict:
        """Step until every replica's queue and slots drain."""
        steps = 0
        while self.placement.pending():
            met = self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
            if (not met["active_slots"] and not met["tokens_this_step"]
                    and self.placement.pending()):
                time.sleep(0.001)       # post-recovery backoff, any replica
        return self.metrics()

    def generate_batch(self, prompts, max_new_tokens: int = 32, *,
                       raise_on_failure: bool = True,
                       **kwargs) -> List[np.ndarray]:
        """Submit every prompt through placement, drain the cluster,
        return prompt+generated ids in submission order (the single-engine
        ``generate_batch`` contract, including the typed error on non-DONE
        terminals)."""
        reqs = [self.submit(p, max_new_tokens, **kwargs) for p in prompts]
        self.run_until_idle()
        bad = [r for r in reqs if r.state != RequestState.DONE]
        if bad and raise_on_failure:
            detail = ", ".join(f"request {r.id}: {r.state}" for r in bad)
            raise ServingError(
                f"generate_batch: {len(bad)}/{len(reqs)} request(s) did "
                f"not complete ({detail})") from bad[0].error
        return [r.output_ids() for r in reqs]

    # -- elastic replica lifecycle -----------------------------------------
    def _stepping(self, i: int) -> bool:
        """Does replica ``i`` burn a replica-step this tick?  Active and
        draining replicas do (seated work must run to completion);
        parked and dead ones don't — that difference IS the chip-seconds
        saving the chaos trace measures."""
        return i not in self._dead and i not in self._parked

    @property
    def active_dp(self) -> int:
        """Replicas currently stepping (active + draining)."""
        return sum(1 for i in range(len(self.replicas))
                   if self._stepping(i))

    def replica_states(self) -> List[str]:
        out = []
        for i, e in enumerate(self.replicas):
            if i in self._dead:
                out.append("dead")
            elif i in self._parked:
                out.append("parked")
            elif getattr(e, "draining", False):
                out.append("draining")
            else:
                out.append("active")
        return out

    def _rehome(self, reqs: List[Request]) -> int:
        """Re-seat harvested live requests on survivors via the placement
        walk; the unseatable remainder parks in ``placement.held`` (still
        live) and is retried every tick.  Returns requests seated now."""
        seated = sum(1 for r in reqs if self.placement.resubmit(r))
        self.placement.sweep()
        self._sync_rehomed()
        return seated

    def _sync_rehomed(self):
        cur = self.placement.rehomed_total
        if cur > self._rehomed_synced:
            self._rehomed_counter.inc(cur - self._rehomed_synced)
            self._rehomed_synced = cur

    def begin_drain_replica(self, i: int,
                            deadline_s: Optional[float] = None) -> int:
        """Start draining replica ``i``: admission stops immediately, its
        queued requests re-home via placement NOW, and its seated
        requests keep running.  With a ``deadline_s``, seated work still
        unfinished when it expires is checkpointed (token-prefix + RNG
        state folded into the request) and re-homed too; without one the
        drain completes whenever the last seated request finishes.
        Returns the number of queued requests harvested."""
        if i in self._dead:
            raise ServingError(f"replica {i} is dead; cannot drain")
        queued = self.replicas[i].begin_drain()
        self._drain_deadline[i] = (None if deadline_s is None
                                   else time.monotonic() + deadline_s)
        self._rehome(queued)
        return len(queued)

    def _check_drains(self, now: Optional[float] = None):
        for i in list(self._drain_deadline):
            e = self.replicas[i]
            deadline = self._drain_deadline[i]
            if e.drained:
                self.finish_drain_replica(i)
            elif deadline is not None and (
                    now if now is not None else time.monotonic()
            ) >= deadline:
                # deadline: fold the stragglers and re-home them — the
                # drained replica parks THIS tick, not eventually
                self._rehome(e.checkpoint_seated())
                self.finish_drain_replica(i)

    def finish_drain_replica(self, i: int):
        """Park a drained replica: it stops stepping (chip-seconds stop
        accruing) but keeps its pool — ``activate_replica`` brings it
        back without a weight reload."""
        self._drain_deadline.pop(i, None)
        self._parked.add(i)

    def drain_replica(self, i: int, *,
                      deadline_s: Optional[float] = None,
                      max_steps: int = 500) -> int:
        """Synchronous convenience: begin the drain and step the cluster
        until replica ``i`` parks (tests and the smoke case).  Seated
        work elsewhere advances normally during the wait."""
        harvested = self.begin_drain_replica(i, deadline_s=deadline_s)
        steps = 0
        while i not in self._parked:
            self.step()
            steps += 1
            if steps >= max_steps:
                raise ServingError(
                    f"replica {i} failed to drain within {max_steps} "
                    "cluster steps")
        return harvested

    def activate_replica(self, i: int):
        """Scale-up: bring a parked (or mid-drain) replica back to
        active.  Its pool, program and weights never left, so the only
        cost is the placement layer seeing it eligible again."""
        if i in self._dead:
            raise ServingError(f"replica {i} is dead; cannot activate")
        self._parked.discard(i)
        self._drain_deadline.pop(i, None)
        self.replicas[i].resume_admission()

    def kill_replica(self, i: int) -> int:
        """Replica loss (fault path, `replica_kill`): close replica ``i``
        NOW and re-home its live work onto survivors — queued requests
        re-route directly, seated ones are checkpointed off the host
        mirrors (tokens emitted so far live host-side, so a chip loss
        does not lose them).  Requests no survivor can seat park in the
        held queue; they only go FAILED when no eligible replica remains
        (placement.sweep).  Returns the number of live requests
        harvested."""
        if i in self._dead:
            return 0
        e = self.replicas[i]
        self._dead.add(i)
        self._parked.discard(i)
        self._drain_deadline.pop(i, None)
        live = e.begin_drain()          # stops admission + harvests queue
        live += e.checkpoint_seated()
        e.close()
        self._rehome(live)
        return len(live)

    # -- brownout actuators (elastic.py drives these, LIFO on recovery) ----
    def set_max_new_cap(self, cap: Optional[int]):
        """Rung 1: clamp ``max_new_tokens`` for NEW admissions (None
        restores).  Seated requests keep their original grant."""
        self.max_new_cap = None if cap is None else max(1, int(cap))

    def set_speculation(self, enabled: bool) -> int:
        """Rung 2: toggle speculative decoding on every replica that has
        it (SpeculativeEngine.speculation_enabled).  Returns how many
        replicas were toggled — 0 means the rung is a no-op here."""
        n = 0
        for idx, e in enumerate(self.replicas):
            if idx in self._dead:
                continue
            if hasattr(e, "speculation_enabled"):
                e.speculation_enabled = bool(enabled)
                n += 1
        return n

    def shrink_prefill_budget(self, frac: float = 0.5):
        """Rung 3: shrink every replica's per-step prefill token budget.
        Shrinking keeps the plans within the engine's fixed ``t_max``
        geometry; growing past the construction-time budget would overflow
        it, so restore only ever returns to the original."""
        if not 0.0 < frac <= 1.0:
            raise ValueError(f"frac={frac} must be in (0, 1]")
        for idx, e in enumerate(self.replicas):
            if idx in self._dead:
                continue
            e.prefill_token_budget = max(
                1, int(self._orig_prefill_budget[idx] * frac))

    def restore_prefill_budget(self):
        for idx, e in enumerate(self.replicas):
            if idx in self._dead:
                continue
            e.prefill_token_budget = self._orig_prefill_budget[idx]

    def set_shedding(self, on: bool):
        """Rung 4 (last resort): refuse new work with typed Overloaded."""
        self.shedding = bool(on)

    # -- observability -----------------------------------------------------
    def metrics(self) -> dict:
        """Cluster metrics: summed counters/capacities (aggregate slots
        and page HBM scale linearly with ``dp`` — the acceptance
        criterion), per-chip pool bytes (shrink ~1/mp), and the full
        per-replica metrics list."""
        per = [eng.metrics() for eng in self.replicas]
        sum_keys = ("steps", "tokens", "admitted", "completed",
                    "fused_steps", "prefill_tokens", "failed", "cancelled",
                    "timed_out", "shed", "quarantined", "recoveries",
                    "rebuilds", "pages_used", "pages_capacity",
                    "active_slots", "queue_depth", "cache_bytes",
                    "work_items", "work_capacity", "block_rows",
                    "block_row_capacity", "padded_rows", "padded_flops",
                    # per-replica prefix caches: hits/misses sum exactly;
                    # the hit RATE is re-derived from the sums below
                    "prefix_hits", "prefix_partial_hits", "prefix_misses",
                    "prefix_evictions", "prefix_cached_tokens",
                    "prefix_cache_pages", "prefix_cache_nodes",
                    "shared_pages",
                    # disaggregated hand-off (serving/disagg.py): both
                    # sides of every committed PageTransfer — equal sums
                    # cluster-wide when every transfer commits
                    "transferred_out", "transferred_in")
        out = {k: sum(int(m.get(k, 0)) for m in per) for k in sum_keys}
        looked = (out["prefix_hits"] + out["prefix_partial_hits"]
                  + out["prefix_misses"])
        out["prefix_hit_rate"] = ((out["prefix_hits"]
                                   + out["prefix_partial_hits"]) / looked
                                  if looked else 0.0)
        # cluster-level sheds (all replicas backpressured) on top of the
        # replicas' own shed counters (queue-wait shedding etc.) — the
        # placement layer skips full replicas instead of probing their
        # submit, so one rejected request counts exactly once
        out["shed"] += self.placement.shed_total
        out["placement_shed"] = self.placement.shed_total
        out["dp"] = self.dp
        out["mp"] = self.mp
        out["slot_capacity"] = sum(e.num_slots for e in self.replicas)
        out["cache_bytes_per_chip"] = (per[0]["cache_bytes_per_chip"]
                                       if per else 0)
        out["routed"] = list(self.placement.routed)
        # elastic lifecycle observability
        out["replica_states"] = self.replica_states()
        out["active_dp"] = self.active_dp
        out["replica_steps"] = self._replica_steps
        # chip-seconds proxy: every stepped replica burns its mp chips
        # for one tick — the quantity the chaos trace minimizes
        out["replica_step_chip_ticks"] = self._replica_steps * self.mp
        out["rehomed"] = self.placement.rehomed_total
        out["held"] = len(self.placement.held)
        out["brownout_shed"] = int(self._brownout_shed.value)
        out["shed"] += out["brownout_shed"]
        out["per_replica"] = per
        return out

    def close(self):
        for eng in self.replicas:
            eng.close()
        if self._pool is not None:
            self._pool.shutdown(wait=False)
        # same hygiene as the engine: recycled clusters must not grow
        # the Prometheus exposition forever (handles keep working)
        _tmetrics.registry().drop_labels(**self._cluster_label)
