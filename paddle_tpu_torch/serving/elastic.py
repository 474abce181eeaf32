"""Closed-loop elastic serving: SLO-driven autoscaling over dp replicas
(port of ``paddle_tpu/serving/elastic.py``, host code, kept line for
line).

``ElasticServingController`` closes the loop over a
:class:`~paddle_tpu_torch.serving.sharded.ShardedServingEngine`:

- **sense** -- windowed p50/p99 TTFT & ITL read from the telemetry
  registry's histograms (``serving_ttft_seconds``,
  ``serving_itl_seconds``; bucket deltas between ring-buffered snapshots),
  plus queue depth and page occupancy;
- **decide** -- a fully deterministic policy: hysteresis bands around the
  SLO targets with cooldowns on every actuation.  Scale-ups and
  scale-downs both gate on, and both arm, ONE shared cooldown clock, so
  any two scale actions are at least ``cooldown_s`` apart for EVERY input
  signal sequence.  Decisions are typed actions (:class:`ScaleUp`,
  :class:`ScaleDown`, :class:`Brownout`, :class:`Recover`);
- **act** -- scale-down drains a replica (admission stops, queued work
  re-routes via placement, seated work finishes under the drain deadline
  or is checkpointed and re-admitted on a survivor); sustained overload
  past the last replica walks the ordered brownout ladder
  (:data:`BROWNOUT_RUNGS`; its second rung switches
  ``SpeculativeEngine.speculation_enabled`` off), released LIFO on
  recovery.

The controller can run **headless** (``cluster=None``): ``tick`` then
consumes injected :class:`ClusterSignals` and only emits actions.  All
time comes through an injectable monotonic ``clock``.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple, Union

from ..telemetry import metrics as _tmetrics

__all__ = [
    "BROWNOUT_RUNGS", "Brownout", "ClusterSignals", "ElasticConfig",
    "ElasticServingController", "Recover", "SLOTargets", "ScaleDown",
    "ScaleUp",
]

_CTRL_SEQ = itertools.count()

#: the ordered degradation ladder: each rung sheds cost the previous one
#: did not, and recovery releases them strictly LIFO (the cheapest
#: degradation is the last to engage and the first to lift is the most
#: expensive one still held)
BROWNOUT_RUNGS = ("shrink_max_new", "disable_speculation",
                  "shrink_prefill_budget", "shed")


# ---------------------------------------------------------------------------
# typed actions
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ScaleUp:
    """Activate parked replica ``replica``."""

    replica: int
    reason: str = ""


@dataclass(frozen=True)
class ScaleDown:
    """Gracefully drain replica ``replica`` (then park it)."""

    replica: int
    reason: str = ""


@dataclass(frozen=True)
class Brownout:
    """Engage ladder rung ``rung``; ``level`` rungs now held."""

    rung: str
    level: int
    reason: str = ""


@dataclass(frozen=True)
class Recover:
    """Release ladder rung ``rung`` (LIFO); ``level`` rungs remain."""

    rung: str
    level: int
    reason: str = ""


Action = Union[ScaleUp, ScaleDown, Brownout, Recover]


# ---------------------------------------------------------------------------
# sensing
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SLOTargets:
    """The bands the policy regulates around.

    ``ttft_p99_s`` is the promise; overload is p99 TTFT above it OR
    queue depth per active replica above ``queue_high``.  Underload
    needs BOTH queue depth below ``queue_low`` AND p99 TTFT below
    ``recover_frac`` of the target — the gap between the overload and
    underload bands is the hysteresis dead zone that keeps a borderline
    signal from oscillating the controller."""

    ttft_p99_s: float = 0.5
    itl_p99_s: float = 0.2        # decode-pool target (signal="itl")
    queue_high: float = 4.0       # queued requests per ACTIVE replica
    queue_low: float = 0.5
    recover_frac: float = 0.5     # underload: p99 < recover_frac * target


@dataclass(frozen=True)
class ClusterSignals:
    """One tick's sensed state — everything ``decide`` may look at.

    Built by ``sense()`` from the live cluster, or constructed directly
    by tests driving a headless controller."""

    now: float                    # monotonic (controller clock)
    ttft_p99: float               # windowed, seconds (0.0: no samples)
    itl_p99: float                # windowed, seconds
    window_count: int             # TTFT samples inside the window
    queue_per_replica: float      # queued requests / active_dp
    occupancy: float              # mean page occupancy of stepping replicas
    active_dp: int                # stepping replicas (active + draining)
    parked: Tuple[int, ...]       # replica indices available to scale up
    scalable: Tuple[int, ...]     # active non-draining indices (may drain)
    itl_window_count: int = 0     # ITL samples inside the window (the
    #                               primary count when signal="itl")


def _bucket_quantile(bounds: Sequence[float], counts: Sequence[float],
                     count: float, q: float) -> float:
    """Quantile over summed bucket-delta counts: the registry child's
    geometric interpolation (telemetry/metrics.py) re-stated for counts
    that no single child owns (summed across replicas, windowed by
    snapshot subtraction), where observed min/max are unavailable."""
    target = q * count
    seen = 0.0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        if seen + c >= target:
            frac = min(max((target - seen) / c, 0.0), 1.0)
            if i >= len(bounds):          # overflow bucket
                return float(bounds[-1])
            lo = bounds[i - 1] if i else max(bounds[0] / 10.0, 1e-12)
            hi = bounds[i]
            return float(lo * (hi / lo) ** frac)
        seen += c
    return float(bounds[-1]) if count else 0.0


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

@dataclass
class ElasticConfig:
    """Policy knobs.  Defaults suit the tiny test models; callers running
    in fake or compressed time override the time constants."""

    targets: SLOTargets = field(default_factory=SLOTargets)
    window_s: float = 5.0            # SLO sensing window
    min_samples: int = 8             # TTFT samples before p99 is trusted
    cooldown_s: float = 2.0          # shared scale-action spacing (anti-flap)
    brownout_cooldown_s: float = 1.0  # rung-to-rung spacing
    overload_sustain_s: float = 1.0  # overload age before brownout engages
    underload_sustain_s: float = 1.0  # underload age before release/down
    drain_deadline_s: float = 5.0    # scale-down drain deadline
    min_dp: int = 1                  # never drain below this many active
    brownout_max_new: int = 8        # rung 1: max_new clamp
    brownout_prefill_frac: float = 0.5  # rung 3: prefill budget factor
    # disaggregated role pools (serving/disagg.py): which latency SLO
    # this controller regulates — "ttft" (the prefill/colocated promise)
    # or "itl" (the decode-pool promise).  A pool whose actuators are
    # owned by ANOTHER controller disables its brownout ladder so two
    # controllers never duel over the shared cluster-wide rungs.
    signal: str = "ttft"
    brownout_enabled: bool = True

    def __post_init__(self):
        if self.signal not in ("ttft", "itl"):
            raise ValueError(
                f"signal={self.signal!r}: expected 'ttft' or 'itl'")


# ---------------------------------------------------------------------------
# the controller
# ---------------------------------------------------------------------------

class ElasticServingController:
    """Sense -> decide -> act, one ``tick()`` per cluster step (or per
    scheduling interval — the policy only sees time through ``clock``).

    The policy state machine is tiny and explicit: a shared scale
    cooldown (``_cooldown_until``), a brownout rung cooldown, and two
    sustain timers (``_overload_since`` / ``_underload_since``) that
    must age past the configured sustain before the ladder moves.  All
    transitions are pure functions of (state, signals) — ``decide``
    performs no I/O and never touches the cluster, which is what makes
    the anti-flap property testable by exhaustion."""

    def __init__(self, cluster=None, config: Optional[ElasticConfig] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.cluster = cluster
        self.config = config or ElasticConfig()
        self.clock = clock
        # policy state
        self.brownout_level = 0          # rungs currently engaged (0..4)
        self._cooldown_until = -float("inf")
        self._rung_cooldown_until = -float("inf")
        self._overload_since: Optional[float] = None
        self._underload_since: Optional[float] = None
        # sensing window: ring of (t, summed_counts, summed_count)
        self._ttft_ring: List[tuple] = []
        self._itl_ring: List[tuple] = []
        self.actions: List[Action] = []  # full history
        # telemetry (the registry; exposition asserted in tests)
        self._label = {"controller": str(next(_CTRL_SEQ))}
        reg = _tmetrics.registry()
        self._actions_total = reg.counter(
            "serving_controller_actions_total",
            "elastic serving controller actions by type")
        self._brownout_gauge = reg.gauge(
            "serving_brownout_level",
            "brownout ladder rungs currently engaged (0 = none)",
        ).labels(**self._label)
        self._brownout_gauge.set(0)

    # -- sense -------------------------------------------------------------
    def _sum_hist(self, name: str) -> tuple:
        """Sum one SLO histogram's cumulative (counts, count) across the
        cluster's stepping replicas -- children are read via snapshot()
        so each replica's contribution is internally consistent."""
        n_buckets = len(_tmetrics.LATENCY_BUCKETS) + 1
        total = [0] * n_buckets
        count = 0
        fam = _tmetrics.registry().get(name)
        if fam is None or self.cluster is None:
            return total, count
        for i, e in enumerate(self.cluster.replicas):
            if not self.cluster._stepping(i):
                continue
            ch = fam.labels(**e._engine_label)
            counts, _s, c, _mn, _mx = ch.snapshot()
            total = [a + b for a, b in zip(total, counts)]
            count += c
        return total, count

    def _windowed_p99(self, ring: List[tuple], name: str,
                      now: float) -> Tuple[float, int]:
        counts, count = self._sum_hist(name)
        ring.append((now, counts, count))
        # keep exactly one snapshot at/before the window start as the
        # subtraction baseline
        cutoff = now - self.config.window_s
        while len(ring) > 1 and ring[1][0] <= cutoff:
            ring.pop(0)
        base_counts, base_count = ring[0][1], ring[0][2]
        d_count = count - base_count
        if d_count <= 0:
            return 0.0, 0
        d_counts = [a - b for a, b in zip(counts, base_counts)]
        return _bucket_quantile(_tmetrics.LATENCY_BUCKETS, d_counts,
                                d_count, 0.99), d_count

    def sense(self) -> ClusterSignals:
        """Read the cluster into one :class:`ClusterSignals` snapshot."""
        now = self.clock()
        ttft_p99, n = self._windowed_p99(
            self._ttft_ring, "serving_ttft_seconds", now)
        itl_p99, n_itl = self._windowed_p99(
            self._itl_ring, "serving_itl_seconds", now)
        cl = self.cluster
        queue = occ = 0.0
        active = 0
        parked: List[int] = []
        scalable: List[int] = []
        if cl is not None:
            stepping = [i for i in range(len(cl.replicas))
                        if cl._stepping(i)]
            active = len(stepping)
            queue = sum(cl.replicas[i].queue.depth for i in stepping)
            occs = [cl.replicas[i].scheduler.occupancy for i in stepping]
            occ = sum(occs) / len(occs) if occs else 0.0
            parked = sorted(cl._parked)
            scalable = [i for i in stepping
                        if not cl.replicas[i].draining]
        return ClusterSignals(
            now=now, ttft_p99=ttft_p99, itl_p99=itl_p99, window_count=n,
            queue_per_replica=queue / max(active, 1), occupancy=occ,
            active_dp=active, parked=tuple(parked),
            scalable=tuple(scalable), itl_window_count=n_itl)

    # -- decide ------------------------------------------------------------
    def _primary(self, sig: ClusterSignals) -> Tuple[float, int, float]:
        """(windowed p99, sample count, target) of the configured SLO
        signal — TTFT for prefill/colocated pools, ITL for a decode pool
        (serving/disagg.py runs one controller per role pool)."""
        t = self.config.targets
        if self.config.signal == "itl":
            return sig.itl_p99, sig.itl_window_count, t.itl_p99_s
        return sig.ttft_p99, sig.window_count, t.ttft_p99_s

    def _overloaded(self, sig: ClusterSignals) -> bool:
        p99, n, target = self._primary(sig)
        slo_breach = n >= self.config.min_samples and p99 > target
        return slo_breach or sig.queue_per_replica > \
            self.config.targets.queue_high

    def _underloaded(self, sig: ClusterSignals) -> bool:
        t = self.config.targets
        p99, n, target = self._primary(sig)
        slo_ok = n < self.config.min_samples or p99 < t.recover_frac * target
        return sig.queue_per_replica < t.queue_low and slo_ok

    def decide(self, sig: ClusterSignals) -> List[Action]:
        """The pure policy core: state + signals -> typed actions.

        Priority under overload: scale up while parked capacity exists;
        only with every replica already active does the brownout ladder
        engage, one rung per ``brownout_cooldown_s``, after the
        overload has sustained.  Under underload the reverse, LIFO:
        release rungs first, and only at level 0 drain a replica (never
        below ``min_dp``).  Both scale directions share one cooldown —
        an up at t forbids ANY scale action before t + cooldown_s."""
        cfg, out = self.config, []
        if self._overloaded(sig):
            over_age = (sig.now - self._overload_since
                        if self._overload_since is not None else 0.0)
            if sig.parked and sig.now >= self._cooldown_until:
                out.append(ScaleUp(
                    replica=sig.parked[0],
                    reason=f"overload: ttft_p99={sig.ttft_p99:.3f}s "
                           f"queue/replica={sig.queue_per_replica:.1f}"))
            elif (not sig.parked
                  and cfg.brownout_enabled
                  and over_age >= cfg.overload_sustain_s
                  and self.brownout_level < len(BROWNOUT_RUNGS)
                  and sig.now >= self._rung_cooldown_until):
                rung = BROWNOUT_RUNGS[self.brownout_level]
                out.append(Brownout(
                    rung=rung, level=self.brownout_level + 1,
                    reason=f"sustained overload {over_age:.2f}s at "
                           f"max dp={sig.active_dp}"))
        elif self._underloaded(sig):
            under_age = (sig.now - self._underload_since
                         if self._underload_since is not None else 0.0)
            if (self.brownout_level > 0
                    and under_age >= cfg.underload_sustain_s
                    and sig.now >= self._rung_cooldown_until):
                rung = BROWNOUT_RUNGS[self.brownout_level - 1]
                out.append(Recover(
                    rung=rung, level=self.brownout_level - 1,
                    reason=f"underload {under_age:.2f}s: releasing "
                           "ladder LIFO"))
            elif (self.brownout_level == 0
                    and len(sig.scalable) > cfg.min_dp
                    and under_age >= cfg.underload_sustain_s
                    and sig.now >= self._cooldown_until):
                out.append(ScaleDown(
                    replica=sig.scalable[-1],
                    reason=f"underload {under_age:.2f}s: "
                           f"queue/replica={sig.queue_per_replica:.2f}"))
        return out

    # -- act ---------------------------------------------------------------
    def _actuate(self, a: Action):
        cl, cfg = self.cluster, self.config
        if isinstance(a, ScaleUp) and cl is not None:
            cl.activate_replica(a.replica)
        elif isinstance(a, ScaleDown) and cl is not None:
            cl.begin_drain_replica(a.replica,
                                   deadline_s=cfg.drain_deadline_s)
        elif isinstance(a, Brownout) and cl is not None:
            if a.rung == "shrink_max_new":
                cl.set_max_new_cap(cfg.brownout_max_new)
            elif a.rung == "disable_speculation":
                cl.set_speculation(False)
            elif a.rung == "shrink_prefill_budget":
                cl.shrink_prefill_budget(cfg.brownout_prefill_frac)
            elif a.rung == "shed":
                cl.set_shedding(True)
        elif isinstance(a, Recover) and cl is not None:
            if a.rung == "shed":
                cl.set_shedding(False)
            elif a.rung == "shrink_prefill_budget":
                cl.restore_prefill_budget()
            elif a.rung == "disable_speculation":
                cl.set_speculation(True)
            elif a.rung == "shrink_max_new":
                cl.set_max_new_cap(None)

    def _apply(self, a: Action, now: float):
        """State transition + actuation + telemetry for one action."""
        cfg = self.config
        if isinstance(a, (ScaleUp, ScaleDown)):
            self._cooldown_until = now + cfg.cooldown_s
            kind = "scale_up" if isinstance(a, ScaleUp) else "scale_down"
        elif isinstance(a, Brownout):
            self.brownout_level = a.level
            self._rung_cooldown_until = now + cfg.brownout_cooldown_s
            self._brownout_gauge.set(self.brownout_level)
            kind = "brownout"
        else:
            self.brownout_level = a.level
            self._rung_cooldown_until = now + cfg.brownout_cooldown_s
            self._brownout_gauge.set(self.brownout_level)
            kind = "recover"
        self._actuate(a)
        self._actions_total.inc(1, action=kind, **self._label)
        self.actions.append(a)

    # -- the loop ----------------------------------------------------------
    def tick(self, signals: Optional[ClusterSignals] = None
             ) -> List[Action]:
        """One sense->decide->act iteration.  Pass ``signals`` to run the
        policy headless (no cluster reads, no actuation beyond state)."""
        sig = signals if signals is not None else self.sense()
        # sustain timers: age while the band holds, reset on leaving it
        if self._overloaded(sig):
            if self._overload_since is None:
                self._overload_since = sig.now
            self._underload_since = None
        elif self._underloaded(sig):
            if self._underload_since is None:
                self._underload_since = sig.now
            self._overload_since = None
        else:
            self._overload_since = None
            self._underload_since = None
        actions = self.decide(sig)
        for a in actions:
            self._apply(a, sig.now)
        return actions

    def close(self):
        _tmetrics.registry().drop_labels(**self._label)
