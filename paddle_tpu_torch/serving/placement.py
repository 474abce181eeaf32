"""Placement layer: which ``dp`` replica seats a request (port of
``paddle_tpu/serving/placement.py``, host code, kept line for line).

The cluster-level half of the scheduler split (the per-replica half --
pages, slots, queues -- is ``serving/admission.py``).  The placement
scheduler never touches pages or slots itself: it ranks replicas by load
and forwards ``submit`` to the chosen replica's own admission path, so
every per-replica invariant (all-or-nothing page reservation, bounded
queues, exact accounting under faults) holds unchanged per replica.

Backpressure composes upward: a replica sheds (typed ``Overloaded``) when
its own bounded queue is full; the placement layer sheds only when EVERY
replica does -- one busy replica never rejects work another could absorb.

The default policy is least-loaded with queue depth as the primary
signal: queue depth is the only metric that keeps growing after a replica
saturates (occupancy and active slots clip at capacity), so it is the
gradient that actually spreads a hot spot.  Ties break toward fewer
reserved pages, then fewer active slots, then replica index
(deterministic).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import List, Optional, Sequence, Tuple

from .engine import (
    DeadlineExceeded,
    Overloaded,
    Request,
    RequestCancelled,
    RequestState,
)

__all__ = ["LeastLoadedPlacement", "PrefixLocalityPlacement",
           "PlacementScheduler", "replica_load", "replica_role",
           "replica_signals"]


def replica_role(engine) -> str:
    """The replica's disaggregation role ("prefill" | "decode" |
    "colocated" -- serving/disagg.py).  Engines built outside a
    :class:`~.disagg.DisaggServingEngine` read as "colocated": they both
    prefill and decode, so every policy treats them as admittable."""
    return getattr(engine, "role", "colocated")


def replica_load(engine) -> Tuple[int, float, int]:
    """One replica's load signal for placement ranking:
    ``(queue_depth, pages_reserved_fraction, active_slots)`` — ordered by
    how discriminating each is past saturation."""
    alloc = engine.allocator
    cap = max(alloc.capacity, 1)
    return (engine.queue.depth, alloc.used_pages / cap,
            engine.scheduler.active_slots)


def replica_signals(engine, adapter: Optional[str] = None
                    ) -> Tuple[bool, float]:
    """The per-replica placement signals beyond raw load:
    ``(adapter_resident, spec_acceptance_rate)``.

    - *adapter residency*: whether this replica's LoRA pool already holds
      the tenant's slab.  Adapters register per replica pool, so routing
      a tenant to a non-resident replica FAILS the request at admission
      (typed ``UnknownAdapter``) — residency is close to mandatory, not
      just an affinity win.
    - *speculative acceptance rate*: accepted/proposed draft tokens
      (serving/speculative.py); a replica whose drafts keep being
      accepted produces more tokens per verify dispatch, i.e. has more
      throughput headroom at equal queue depth.  Non-speculative
      replicas read as the neutral 1.0.
    """
    resident = False
    pool = getattr(engine, "lora", None)
    if adapter is not None and pool is not None:
        resident = adapter in pool.adapters()
    totals = getattr(engine, "_spec_totals", None)
    accept = 1.0
    if totals is not None:
        proposed = totals["proposed_tokens"]
        accept = totals["accepted_tokens"] / proposed if proposed else 1.0
    return resident, accept


class LeastLoadedPlacement:
    """Rank replicas least-loaded first (see :func:`replica_load`).

    With the request in hand (``rank_for``), the rank tuple gains the
    per-replica signals of :func:`replica_signals`: a tenant routes to
    the replica where its adapter slab is already seated (residency
    outranks load — a miss is an admission failure, not a slow path),
    and among equally loaded replicas the higher speculative acceptance
    rate wins (more tokens per dispatch).  Without a prompt in hand
    (``rank``) the historical load-only tuple is unchanged."""

    def rank(self, engines: Sequence) -> List[int]:
        return sorted(range(len(engines)),
                      key=lambda i: (replica_load(engines[i]), i))

    def rank_for(self, engines: Sequence, prompt,
                 adapter: Optional[str] = None) -> List[int]:
        def key(i):
            resident, accept = replica_signals(engines[i], adapter)
            depth, frac, active = replica_load(engines[i])
            return (0 if resident else 1, depth, frac, active, -accept, i)

        return sorted(range(len(engines)), key=key)


class PrefixLocalityPlacement(LeastLoadedPlacement):
    """Prefix-locality signal hook: prefer the replica whose prefix cache
    already holds the longest prefix of THIS prompt (per-replica caches
    never share pages, so routing siblings of a prompt family to the same
    replica is what makes their prefixes hit), break ties least-loaded.

    Deliberately a stub-grade heuristic (the prefix cache's own lookup):
    the lookup is the cache's read-only ``match_len`` walk, load is only
    a tiebreak — a saturated replica with a warm cache still wins over an
    idle cold one.  Production policies would blend match length against
    load; the ``rank_for`` hook is the seam they implement.  Adapter
    residency still outranks the prefix match (a non-resident replica
    cannot serve the tenant at all)."""

    def rank_for(self, engines: Sequence, prompt,
                 adapter: Optional[str] = None) -> List[int]:
        def match(e) -> int:
            cache = getattr(e, "prefix_cache", None)
            return cache.match_len(prompt) if cache is not None else 0

        def key(i):
            resident, accept = replica_signals(engines[i], adapter)
            return (0 if resident else 1, -match(engines[i]),
                    replica_load(engines[i]), -accept, i)

        return sorted(range(len(engines)), key=key)


class PlacementScheduler:
    """Cluster-level request placement over ``dp`` replica engines.

    ``submit`` walks the policy's ranking and seats the request on the
    first replica that accepts it; per-replica ``Overloaded`` (bounded
    queue full) moves on to the next candidate.  Only when EVERY replica
    sheds does the placement layer raise ``Overloaded`` itself — the
    cluster is genuinely out of capacity, not just one replica.

    Validation errors (oversized prompt, bad arguments) are raised by the
    first replica verbatim: they would fail identically everywhere, and
    retrying them across the fleet would just turn one clear error into
    ``dp`` of them.
    """

    def __init__(self, engines: Sequence, policy=None):
        if not engines:
            raise ValueError("PlacementScheduler needs at least one replica")
        self.engines = list(engines)
        self.policy = policy or LeastLoadedPlacement()
        # requests routed per replica (placement observability; the
        # sharded bench prints these as per-replica occupancy companions)
        self.routed = [0] * len(self.engines)
        # cluster-level sheds (every replica backpressured).  Separate
        # from the replicas' own ``shed`` counters so one rejected
        # request is counted ONCE here, not dp times below.
        self.shed_total = 0
        # counter lock: submit() is documented as callable from any
        # thread, and a bare `+=` is the interleaved read-modify-write
        # the engine's counters avoid
        self._lock = threading.Lock()
        # re-home parking lot: requests harvested from a draining or dead
        # replica that no survivor could seat RIGHT NOW.  They stay live
        # here (not FAILED) until capacity frees — flush_held() retries
        # them each cluster step, sweep() reaps the ones that cancel or
        # expire while parked (the cross-replica cancel fix: a request
        # held HERE is on no replica's queue, so no replica reaps it).
        self.held: "deque[Request]" = deque()
        self.rehomed_total = 0

    @staticmethod
    def _has_queue_room(engine) -> bool:
        q = engine.queue
        return q.max_depth is None or q.depth < q.max_depth

    @staticmethod
    def _eligible(engine) -> bool:
        """A replica that can accept NEW work: open and not draining."""
        return not (getattr(engine, "draining", False)
                    or getattr(engine, "_closed", False))

    def submit(self, prompt, max_new_tokens: int = 32, **kwargs) -> Request:
        """Place and queue one request; returns the replica's Request.
        Raises typed ``Overloaded`` only when all replicas shed.

        Full replicas are skipped by a queue-room check BEFORE calling
        their ``submit`` — probing a full replica's submit would bump its
        own ``shed`` counter for a request another replica then serves.
        The check races concurrent submitters, so a replica-level
        ``Overloaded`` can still surface; it is caught and the walk moves
        on (that replica's counter recorded a genuine full-queue event).
        """
        last: Optional[Overloaded] = None
        for i in self._order(prompt, kwargs.get("adapter")):
            if not (self._eligible(self.engines[i])
                    and self._has_queue_room(self.engines[i])):
                continue
            try:
                req = self.engines[i].submit(prompt, max_new_tokens,
                                             **kwargs)
            except Overloaded as e:
                last = e
                continue
            with self._lock:
                self.routed[i] += 1
            req.replica = i
            return req
        with self._lock:
            self.shed_total += 1
        raise Overloaded(
            f"all {len(self.engines)} replicas backpressured: "
            "cluster out of queue capacity — back off and retry") from last

    def _order(self, prompt, adapter: Optional[str] = None) -> List[int]:
        # prefix-locality / signals hook: a policy exposing rank_for ranks
        # with the PROMPT (and tenant adapter) in hand; plain policies
        # keep the load-only rank() signature.  Older policies take
        # rank_for(engines, prompt) only — fall back for them.
        ranker = getattr(self.policy, "rank_for", None)
        if ranker is None:
            return self.policy.rank(self.engines)
        try:
            return ranker(self.engines, prompt, adapter=adapter)
        except TypeError:
            return ranker(self.engines, prompt)

    # -- re-homing (drain / replica loss) ------------------------------

    def resubmit(self, req: Request) -> bool:
        """Re-home one live request harvested off a draining/dead replica.

        Walks the same policy ranking as ``submit`` but seats via
        ``engine.requeue`` — the SAME Request object keeps its id, stream
        callback, ``_done`` event and deadline, which is what makes
        re-homed streams exactly-once.  Returns True when seated; when no
        survivor has room the request parks in ``held`` (still live) and
        False is returned.  Terminal requests (cancelled/expired while in
        flight) are dropped without a walk — sweep() already typed them.
        """
        if req.state not in (RequestState.SUBMITTED,):
            return False
        for i in self._order(req.prompt, req.adapter):
            e = self.engines[i]
            if not (self._eligible(e) and self._has_queue_room(e)):
                continue
            try:
                e.requeue(req)
            except Overloaded:
                continue
            with self._lock:
                self.routed[i] += 1
                self.rehomed_total += 1
            req.replica = i
            req.rehomed += 1
            return True
        with self._lock:
            self.held.append(req)
        return False

    def flush_held(self) -> int:
        """Retry every parked request once, FIFO.  Returns seats found."""
        with self._lock:
            batch = list(self.held)
            self.held.clear()
        seated = 0
        for req in batch:
            if self.resubmit(req):           # re-parks itself on failure
                seated += 1
        return seated

    def sweep(self, now: Optional[float] = None) -> int:
        """Reap held requests that went terminal while parked.

        This is the cross-replica ``cancel()`` fix: a request cancelled
        (or deadline-expired) while held at the placement layer sits on
        no replica's queue, so no replica's ``_reap`` ever observes it —
        without this sweep it would hang its waiter forever.  When NO
        eligible replica remains at all, every held request fails typed
        (capacity is gone for good, not just momentarily).  Returns the
        number of requests reaped.
        """
        now = time.monotonic() if now is None else now
        no_capacity = not any(self._eligible(e) for e in self.engines)
        reaped = 0
        with self._lock:
            keep: "deque[Request]" = deque()
            batch = list(self.held)
            self.held.clear()
        for r in batch:
            if r.cancelled:
                self._terminalize_held(
                    r, RequestState.CANCELLED, RequestCancelled(
                        f"request {r.id} cancelled while held "
                        "for re-homing"))
            elif r.deadline is not None and now >= r.deadline:
                self._terminalize_held(
                    r, RequestState.TIMED_OUT, DeadlineExceeded(
                        f"request {r.id}: deadline_s={r.deadline_s} "
                        "passed while held for re-homing"))
            elif no_capacity:
                self._terminalize_held(
                    r, RequestState.FAILED, Overloaded(
                        f"request {r.id} lost its replica and no "
                        "eligible replica remains to re-home it"))
            else:
                keep.append(r)
                continue
            reaped += 1
        with self._lock:
            self.held.extendleft(reversed(keep))
        return reaped

    @staticmethod
    def _terminalize_held(req: Request, state: str,
                          error: BaseException):
        """Placement-local terminal transition for a held request —
        mirrors the engine's ``_terminalize`` (error, state, terminal
        timestamp, waiter wake-up) without bumping any ONE replica's
        counters for a request that sat on no replica's queue."""
        req.error = error
        req.state = state
        req.t_terminal = time.monotonic()
        req._done.set()

    def pending(self) -> int:
        """Queued + seated requests across every replica, plus requests
        parked in the re-home queue (still live: run_until_idle must not
        declare the cluster idle while they wait for a seat)."""
        return (sum(e.queue.depth + e.scheduler.active_slots
                    for e in self.engines if not getattr(e, "_closed",
                                                         False))
                + len(self.held))

    def loads(self) -> List[Tuple[int, float, int]]:
        return [replica_load(e) for e in self.engines]
