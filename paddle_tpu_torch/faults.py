"""Shared fault-injection harness (port of ``paddle_tpu/faults.py``,
copied whole: host code, numpy and ``time`` only).

Shared by ``serving/faults.py`` (which re-exports it) and, in the
reference, the distributed fault-tolerance layer, which drives the SAME
occurrence-keyed injector: components call a test-only
``_fault_hook(point, ctx)`` at named points of their pipeline; an
installed :class:`FaultInjector` acts there — raising, stalling, or
mutating ``ctx`` — to force, deterministically and at chosen
occurrences, exactly the failures production would hit stochastically.

Serving points (see serving/engine.py):

======================  =====================  ==============================
kind                    hook point             effect
======================  =====================  ==============================
``step_exception``      before_decode          raise :class:`InjectedFault`
                                               (``state_intact=True`` — the
                                               fault fires before dispatch)
``step_stall``          before_decode          ``time.sleep(duration)`` so
                                               the watchdog trips; the thunk
                                               then honors ``cancelled()``
``nan_logits``          after_decode           flip ``ctx["finite"]`` for
                                               the chosen slots (simulating
                                               NaN-poisoned logits)
``alloc_exhausted``     alloc                  ``ctx["force_none"] = True``
                                               (pool reports no free pages)
``callback_error``      callback               raise inside the engine's
                                               ``on_token`` invocation
======================  =====================  ==============================

Disaggregated hand-off points (serving/disagg.py):

======================  =====================  ==============================
``transfer_stall``      page_transfer          ``time.sleep(duration)`` in
                                               the middle of a page hand-off
``transfer_error``      page_transfer          raise :class:`InjectedFault`
                                               mid-transfer — the destination
                                               reservation must roll back and
                                               the source retain ownership
``transfer_partial``    page_transfer          ``ctx["partial"] = True`` —
                                               only part of the page set
                                               lands; the transfer layer
                                               treats it as failed (rollback
                                               + source keeps the request)
======================  =====================  ==============================

Distributed points (docs/distributed_faults.md):

======================  =====================  ==============================
``store_error``         store_op               raise inside a TCPStore op —
                                               absorbed by the bounded retry
                                               when transient, escalating to
                                               ``StoreUnavailableError`` when
                                               persistent
``beat_skip``           heartbeat              ``ctx["skip"] = True`` — the
                                               ElasticManager misses beats so
                                               peers see this rank as dead
``exchange_stall``      exchange               ``time.sleep(duration)`` before
                                               a store-backed collective
                                               posts its payload
``exchange_error``      exchange               raise inside the collective
======================  =====================  ==============================

Injection points are keyed on the Nth OCCURRENCE of the point (per-point
call counters), so a schedule is reproducible independent of wall clock.
``FaultInjector.log`` records every shot actually fired — tests assert the
schedule really executed instead of silently passing on a dead plan.

``random_schedule`` builds a randomized multi-fault serving plan and
``random_store_schedule`` a randomized store-outage storm, both from a
seeded RNG, for the property tests and the CI gates
(tools/serving_fault_gate.py, tools/dist_fault_gate.py).
"""
from __future__ import annotations

import time
from collections import Counter
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

__all__ = ["InjectedFault", "FaultPlan", "FaultInjector", "random_schedule",
           "random_store_schedule", "random_transfer_schedule",
           "KINDS", "KIND_POINTS"]

KIND_POINTS = {
    # serving (engine/allocator hook points)
    "step_exception": ("before_decode",),
    "step_stall": ("before_decode",),
    "nan_logits": ("after_decode",),
    "alloc_exhausted": ("alloc",),
    "callback_error": ("callback",),
    # distributed (store / elastic / collective hook points)
    "store_error": ("store_op",),
    "beat_skip": ("heartbeat",),
    "exchange_stall": ("exchange",),
    "exchange_error": ("exchange",),
    # cluster (sharded serving / traffic-driver hook points):
    # ``replica_kill`` fires at ShardedServingEngine's per-tick
    # ``cluster_step`` point and appends ``plan.slots`` (replica indices,
    # default [0]) to ``ctx["kill"]``; the cluster closes those replicas
    # and re-homes their live requests.  ``load_spike`` fires at a
    # traffic driver's ``traffic`` point and multiplies
    # ``ctx["multiplier"]`` by ``plan.duration`` (the spike factor) —
    # the driver submits that many times its baseline arrivals.
    "replica_kill": ("cluster_step",),
    "load_spike": ("traffic",),
    # disaggregated hand-off (serving/disagg.py): all three fire
    # at the PageTransfer's ``page_transfer`` point, between the
    # destination-side reservation and the commit, so every schedule
    # exercises the mid-transfer ownership protocol.  Plans naming any
    # other point are rejected by FaultPlan validation (the
    # retired-point discipline).
    "transfer_stall": ("page_transfer",),
    "transfer_error": ("page_transfer",),
    "transfer_partial": ("page_transfer",),
}

KINDS = tuple(KIND_POINTS)


class InjectedFault(RuntimeError):
    """A deterministically injected fault.

    ``state_intact=True`` (the default) tells the serving engine the
    fault fired BEFORE any device dispatch — pool state is untouched, so
    containment can stay surgical (fail one request / retry without a
    rebuild).  Schedules that model a mid-dispatch crash set it False to
    force the conservative rebuild path.  (The distributed layer treats
    any InjectedFault from a store op as a transport failure.)"""

    def __init__(self, msg: str, state_intact: bool = True):
        super().__init__(msg)
        self.state_intact = state_intact


@dataclass
class FaultPlan:
    """One injection: fire ``kind`` at occurrences [at, at+times) of
    ``point``."""

    point: str                     # hook point name
    at: int                        # 0-based occurrence index of the point
    kind: str                      # one of KINDS
    times: int = 1                 # consecutive occurrences to fire on
    duration: float = 0.0          # step_stall/exchange_stall: sleep
    #                                seconds; load_spike: spike multiplier
    slots: Optional[Sequence[int]] = None   # nan_logits: slot indices (None
    #                                         = every active slot);
    #                                         replica_kill: replica indices
    #                                         (None = replica 0)
    state_intact: bool = True      # step_exception: pre-dispatch fault?

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {KINDS}")
        if self.point not in KIND_POINTS[self.kind]:
            raise ValueError(
                f"kind {self.kind!r} cannot fire at point {self.point!r} "
                f"(valid: {KIND_POINTS[self.kind]})")
        if self.times < 1:
            raise ValueError("times must be >= 1")


@dataclass
class _Shot:
    """One fault that actually fired (FaultInjector.log entry)."""

    point: str
    occurrence: int
    kind: str


class FaultInjector:
    """Deterministic fault scheduler implementing the shared
    ``_fault_hook(point, ctx)`` protocol.

    Usage::

        inj = FaultInjector()
        inj.inject("before_decode", at=3, kind="step_exception")  # transient
        inj.inject("store_op", at=10, kind="store_error", times=2)
        inj.install(engine_or_store_or_manager)
        ... drive it; assert inj.log shows the shots fired ...
    """

    def __init__(self, plans: Optional[List[FaultPlan]] = None):
        self.plans: List[FaultPlan] = list(plans or [])
        self.log: List[_Shot] = []
        self._calls: Counter = Counter()

    def inject(self, point: str, at: int, kind: str, **kw) -> "FaultInjector":
        self.plans.append(FaultPlan(point=point, at=at, kind=kind, **kw))
        return self

    def install(self, target) -> "FaultInjector":
        """Attach to any component exposing ``_fault_hook`` (ServingEngine
        + its allocator, TCPStore, ElasticManager, ...)."""
        target._fault_hook = self.hook
        allocator = getattr(target, "allocator", None)
        if allocator is not None:
            allocator._fault_hook = self.hook
        return self

    # -- the hook ----------------------------------------------------------
    def hook(self, point: str, ctx: Optional[dict] = None):
        n = self._calls[point]
        self._calls[point] += 1
        for plan in self.plans:
            if plan.point != point or not plan.at <= n < plan.at + plan.times:
                continue
            self.log.append(_Shot(point, n, plan.kind))
            self._fire(plan, n, ctx)

    def _fire(self, plan: FaultPlan, n: int, ctx: Optional[dict]):
        if plan.kind == "step_exception":
            raise InjectedFault(
                f"injected step exception at {plan.point}#{n}",
                state_intact=plan.state_intact)
        if plan.kind in ("step_stall", "exchange_stall", "transfer_stall"):
            time.sleep(plan.duration)
            return
        if plan.kind == "nan_logits":
            fin = ctx["finite"] if ctx else None
            if fin is not None:
                if plan.slots is None:
                    fin[:] = False
                else:
                    for s in plan.slots:
                        if s < len(fin):
                            fin[s] = False
            return
        if plan.kind == "alloc_exhausted":
            if ctx is not None:
                ctx["force_none"] = True
            return
        if plan.kind == "callback_error":
            raise InjectedFault(
                f"injected callback error at {plan.point}#{n}")
        if plan.kind == "store_error":
            op = (ctx or {}).get("op", "?")
            raise InjectedFault(
                f"injected store fault at {plan.point}#{n} (op={op})")
        if plan.kind == "beat_skip":
            if ctx is not None:
                ctx["skip"] = True
            return
        if plan.kind == "exchange_error":
            raise InjectedFault(
                f"injected collective fault at {plan.point}#{n}")
        if plan.kind == "replica_kill":
            if ctx is not None:
                ctx.setdefault("kill", []).extend(
                    plan.slots if plan.slots is not None else [0])
            return
        if plan.kind == "load_spike":
            if ctx is not None:
                ctx["multiplier"] = (ctx.get("multiplier", 1.0)
                                     * max(plan.duration, 1.0))
            return
        if plan.kind == "transfer_error":
            raise InjectedFault(
                f"injected transfer fault at {plan.point}#{n}")
        if plan.kind == "transfer_partial":
            if ctx is not None:
                ctx["partial"] = True
            return

    # -- introspection -----------------------------------------------------
    def fired(self, kind: Optional[str] = None) -> int:
        """How many shots fired (optionally of one kind)."""
        return sum(1 for s in self.log if kind is None or s.kind == kind)

    def occurrences(self, point: str) -> int:
        """How many times the component reached ``point``."""
        return self._calls[point]


def random_schedule(rng: np.random.RandomState, *, horizon: int = 40,
                    n_faults: int = 4, num_slots: int = 4,
                    include_stalls: bool = False,
                    stall_duration: float = 0.3) -> FaultInjector:
    """Build a randomized serving fault schedule over roughly ``horizon``
    decode steps: the property tests and the CI gate drive engines under
    many seeds and assert the accounting/containment invariants hold for
    ALL of them.  Stalls are opt-in (they cost wall clock per shot and
    need a watchdog-enabled engine)."""
    kinds = ["step_exception", "nan_logits", "alloc_exhausted",
             "callback_error"]
    if include_stalls:
        kinds.append("step_stall")
    inj = FaultInjector()
    for _ in range(n_faults):
        kind = kinds[rng.randint(len(kinds))]
        at = int(rng.randint(1, horizon))
        if kind == "step_exception":
            # times=1 exercises retry-once; times>=2 forces recovery
            inj.inject("before_decode", at=at, kind=kind,
                       times=int(rng.randint(1, 4)))
        elif kind == "step_stall":
            inj.inject("before_decode", at=at, kind=kind,
                       duration=stall_duration)
        elif kind == "nan_logits":
            inj.inject("after_decode", at=at, kind=kind,
                       slots=[int(rng.randint(num_slots))])
        elif kind == "alloc_exhausted":
            inj.inject("alloc", at=at, kind=kind,
                       times=int(rng.randint(1, 6)))
        else:
            inj.inject("callback", at=at, kind=kind)
    return inj


def random_transfer_schedule(rng: np.random.RandomState, *,
                             horizon: int = 12, n_faults: int = 3,
                             include_stalls: bool = False,
                             stall_duration: float = 0.05) -> FaultInjector:
    """Randomized mid-transfer fault schedule for the disaggregated
    hand-off (serving/disagg.py): ``transfer_error`` / ``transfer_partial``
    shots at random occurrences of the ``page_transfer`` point.  The
    property tests assert that under ANY seed both pools' 4-term page
    accounting stays exact and every request still reaches a typed
    terminal state — transfers may fail, ownership may not leak."""
    kinds = ["transfer_error", "transfer_partial"]
    if include_stalls:
        kinds.append("transfer_stall")
    inj = FaultInjector()
    for _ in range(n_faults):
        kind = kinds[rng.randint(len(kinds))]
        at = int(rng.randint(0, max(horizon, 1)))
        if kind == "transfer_stall":
            inj.inject("page_transfer", at=at, kind=kind,
                       duration=stall_duration)
        else:
            inj.inject("page_transfer", at=at, kind=kind,
                       times=int(rng.randint(1, 3)))
    return inj


def random_store_schedule(rng: np.random.RandomState, *, horizon: int = 200,
                          n_faults: int = 5,
                          max_burst: int = 3) -> FaultInjector:
    """Randomized store-outage storm: bursts of transient ``store_error``
    at random occurrences of the ``store_op`` point.  Bursts are kept
    non-overlapping and no longer than the default retry budget
    (PADDLE_STORE_RETRIES=3 → 4 attempts), so under ANY seed the storm
    must be fully absorbed by retry — the invariant the dist fault gate
    asserts."""
    ats = sorted(int(rng.randint(1, horizon)) for _ in range(n_faults))
    inj = FaultInjector()
    prev_end = -1
    for at in ats:
        if at <= prev_end + 1:  # keep bursts from fusing past the budget
            continue
        times = int(rng.randint(1, max_burst + 1))
        inj.inject("store_op", at=at, kind="store_error", times=times)
        prev_end = at + times
    return inj
