"""Disaggregated serving: dedicated prefill and decode replica roles with
page-granular KV hand-off (port of ``paddle_tpu/serving/disagg.py``).

Long prompts and steady decode streams want opposite step shapes: a
colocated replica's fused step mixes both.  Disaggregation splits the dp
replicas into roles:

- **PREFILL** replicas admit prompts (prefix-locality routed), run
  prefill-heavy steps, and sample each request's FIRST token;
- **DECODE** replicas never admit -- requests ARRIVE via
  :class:`PageTransfer` with their KV pages already filled, and every step
  is decode-only (``prefill_token_budget=1``); they may run several
  sub-steps per cluster tick (``decode_steps_per_tick``);
- **COLOCATED** replicas do both (an all-colocated role vector makes
  :class:`DisaggServingEngine` a plain ``ShardedServingEngine``).

**The hand-off.**  The fused step reads KV through per-slot page tables
only, so moving a request is moving PAGES: at the start of every cluster
tick the engine scans prefill replicas for seated requests whose prompt
completed and hands each to a decode replica chosen by load, LoRA
residency and speculative acceptance.  The copy gathers the source's
pages with ``index_select``, moves them to the destination's device and
writes them with ``index_copy_``, per pool tensor and per shard, the int8
scales included (``PagedKVCache.gather_pages``/``scatter_pages``), one
batch per destination and tick.

**Ownership protocol** (on both ``BlockAllocator`` ledgers, so
free+used+spec+shared == capacity holds on BOTH pools at every step
boundary, mid-transfer faults included):

1. the destination reserves the request's FULL page grant into its spec
   ledger (``reserve_spec``) BEFORE any copy;
2. the filled pages copy (a fault here -- ``transfer_stall`` /
   ``transfer_error`` / ``transfer_partial`` at the ``page_transfer`` hook
   point -- aborts the transfer: the destination reservation rolls back
   via ``rollback_spec`` and the source, still seated, keeps decoding);
3. the copy commits (``commit_spec``: spec -> allocated) and the
   destination seats the request (``ServingEngine.adopt_transferred``: the
   slot at the source's position, the last sampled token in the step-input
   mirror, so the next decode step is the one the source would have run);
4. only after commit does the source release
   (``ServingEngine.release_transferred``: pages, prefix-cache and LoRA
   references drop; no terminal transition).

**Elasticity.**  :class:`DisaggElasticController` runs one controller per
role pool over restricted views of the same cluster: the prefill pool
regulates TTFT (and owns the brownout ladder), the decode pool regulates
ITL with ``brownout_enabled=False``.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence, Tuple

from ..telemetry import metrics as _tmetrics
from .elastic import ElasticConfig, ElasticServingController
from .engine import Request, RequestState, ServingEngine
from .paged_cache import pages_for_tokens
from .placement import (
    PrefixLocalityPlacement,
    replica_load,
    replica_role,
    replica_signals,
)
from .sharded import ShardedServingEngine

__all__ = [
    "ROLE_PREFILL", "ROLE_DECODE", "ROLE_COLOCATED", "ROLES",
    "RolePlacement", "PageTransfer", "PageTransferAborted",
    "DisaggServingEngine", "DisaggElasticController", "page_transfer_bytes",
]

ROLE_PREFILL = "prefill"
ROLE_DECODE = "decode"
ROLE_COLOCATED = "colocated"
ROLES = (ROLE_PREFILL, ROLE_DECODE, ROLE_COLOCATED)


class PageTransferAborted(RuntimeError):
    """A hand-off that did not commit: the destination reservation was
    rolled back and the source retains ownership (the request keeps
    decoding where it is and may re-route next tick)."""


class RolePlacement(PrefixLocalityPlacement):
    """Role-aware admission routing: fresh submissions — and re-homed
    checkpoints, which need re-prefilling — go to prefill/colocated
    replicas, ranked prefix-locality first among them (siblings of a
    prompt family keep hitting the same warm cache).  Decode replicas
    are ranked LAST rather than excluded: if every admitting replica is
    dead or draining, a decode replica re-prefilling (degraded but
    correct — its budget-1 geometry still makes progress) beats shedding
    the request."""

    def rank_for(self, engines: Sequence, prompt,
                 adapter: Optional[str] = None) -> List[int]:
        order = super().rank_for(engines, prompt, adapter=adapter)
        admitting = [i for i in order
                     if replica_role(engines[i]) != ROLE_DECODE]
        return admitting + [i for i in order if i not in admitting]


# ---------------------------------------------------------------------------
# the hand-off
# ---------------------------------------------------------------------------

def page_transfer_bytes(cache, num_pages: int) -> int:
    """Bytes a hand-off of ``num_pages`` filled pages moves out of
    ``cache``: K and V of every layer (and shard), plus an int8 pool's
    fp32 scales (a dequantizable page is its bytes AND its scales)."""
    return cache.nbytes // cache.num_pages * int(num_pages)


class PageTransfer:
    """Moves seated requests' filled pool pages between two replicas'
    pools, ownership-exact (module docstring, "Ownership protocol").  The copy is
    one gather (``index_select``) and one scatter (``index_copy_``) per
    pool tensor and shard, across devices when the pools' differ."""

    def __init__(self, fault_hook: Optional[Callable] = None):
        self._fault_hook = fault_hook

    # -- copy mechanics ----------------------------------------------------
    @staticmethod
    def copy_pages(src_cache, dst_cache, src_pages: Sequence[int],
                   dst_pages: Sequence[int]):
        """Copy ``src_pages`` of ``src_cache`` onto ``dst_pages`` of
        ``dst_cache`` (equal counts; pools of one geometry)."""
        if len(src_pages) != len(dst_pages):
            raise ValueError(f"page count mismatch: {len(src_pages)} "
                             f"!= {len(dst_pages)}")
        if not len(src_pages):
            return
        dst_cache.scatter_pages(dst_pages, src_cache.gather_pages(src_pages))

    # -- the protocol ------------------------------------------------------
    def transfer_many(self, src: ServingEngine, src_idxs: Sequence[int],
                      dst: ServingEngine, *, src_replica: int = -1,
                      dst_replica: int = -1) -> Tuple[int, int, int]:
        """Batched hand-off of several requests from ``src`` to ``dst``.
        The ownership protocol stays PER REQUEST — each request gets its
        own destination reservation and fault-hook firing, and a faulted
        request rolls back alone while the rest of the batch proceeds —
        but every surviving request's pages land in ONE fused
        gather/scatter per pool tensor, so a hand-off tick pays the copy
        dispatch overhead once, not per request (the hand-off gap stays
        out of the transferred requests' ITL tail).  Returns
        ``(committed, pages_copied, failed)``; both pools' 4-term
        invariant holds on every return."""
        staged = []           # (src_idx, slot, req, d_pages, filled)
        failed = 0
        for src_idx in src_idxs:
            slot = src.scheduler.slots[src_idx]
            if slot is None or not slot.request.tokens:
                continue
            if dst._draining or \
                    len(dst.scheduler.free_slot_indices()) <= len(staged):
                break
            req = slot.request
            filled = pages_for_tokens(slot.pos, src.page_size)
            # 1. per-request destination reservation BEFORE any copy
            d_pages = dst.allocator.reserve_spec(len(slot.pages))
            if d_pages is None:
                break         # destination pool backpressure
            try:
                ctx = {"src": src_replica, "dst": dst_replica,
                       "request": req.id, "pages": filled, "partial": False}
                if self._fault_hook is not None:
                    self._fault_hook("page_transfer", ctx)
                if ctx["partial"]:
                    self.copy_pages(src.cache, dst.cache,
                                    slot.pages[:filled // 2],
                                    d_pages[:filled // 2])
                    raise PageTransferAborted(
                        f"partial transfer of request {req.id}: "
                        f"{filled // 2}/{filled} pages landed")
            except BaseException:
                # this request's fault is its own: roll back ITS
                # reservation, keep it on the source, continue the batch
                dst.allocator.rollback_spec(d_pages)
                failed += 1
                continue
            staged.append((src_idx, slot, req, d_pages, filled))
        if not staged:
            return 0, 0, failed
        # 2. ONE copy for the whole batch (filled pages only)
        s_all: List[int] = []
        d_all: List[int] = []
        for _, slot, _, d_pages, filled in staged:
            s_all.extend(slot.pages[:filled])
            d_all.extend(d_pages[:filled])
        try:
            self.copy_pages(src.cache, dst.cache, s_all, d_all)
        except BaseException:
            # a real copy failure takes down the whole batch: every
            # reservation rolls back, the source retains every request
            for _, _, _, d_pages, _ in staged:
                dst.allocator.rollback_spec(d_pages)
            raise
        # 3+4. per-request commit / adopt / release
        committed = pages = 0
        for src_idx, slot, req, d_pages, filled in staged:
            dst.allocator.commit_spec(d_pages)
            idx = dst.adopt_transferred(req, d_pages, slot.pos,
                                        int(req.tokens[-1]))
            if idx is None:
                dst.allocator.free(d_pages)
                continue
            src.release_transferred(src_idx)
            req.replica = dst_replica if dst_replica >= 0 else req.replica
            committed += 1
            pages += filled
        return committed, pages, failed


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

class DisaggServingEngine(ShardedServingEngine):
    """A :class:`~.sharded.ShardedServingEngine` whose dp replicas carry
    roles (module docstring).  ``roles`` fixes both dp (its length) and
    each replica's job; ``prefill_kw`` / ``decode_kw`` overlay
    role-specific engine knobs on top of the shared ``engine_kw``
    (prefill replicas usually get a large ``prefill_token_budget``;
    decode replicas default to the minimal budget-1 geometry).  Every
    replica engine is constructed with its ``role`` — the per-role
    ``role`` label on the SLO histograms and the role-aware placement
    both key on it."""

    def __init__(self, model, *, roles: Sequence[str] = (ROLE_PREFILL,
                                                         ROLE_DECODE),
                 mp: int = 1, devices=None, model_factory=None,
                 placement=None, engine_factory=None,
                 prefill_kw: Optional[dict] = None,
                 decode_kw: Optional[dict] = None,
                 decode_steps_per_tick: int = 1,
                 **engine_kw):
        roles = tuple(str(r) for r in roles)
        for r in roles:
            if r not in ROLES:
                raise ValueError(f"unknown replica role {r!r}; "
                                 f"expected one of {ROLES}")
        if not roles:
            raise ValueError("roles must name at least one replica")
        if all(r == ROLE_DECODE for r in roles):
            raise ValueError(
                "every replica is decode-role: nothing can admit — at "
                "least one prefill or colocated replica is required")
        self.roles = roles
        self.decode_steps_per_tick = max(int(decode_steps_per_tick), 1)
        p_kw = dict(prefill_kw or {})
        d_kw = dict(decode_kw or {})
        # decode-only steps: the smallest legal prefill budget keeps the
        # step's token axis at num_slots+1 -- undiluted decode occupancy.
        # (Still CORRECT for the re-route fallback that prefills here one
        # token per step.)
        d_kw.setdefault("prefill_token_budget", 1)
        inner = engine_factory

        def factory(rm, mesh, i, **kw):
            role = roles[i]
            kw = dict(kw)
            if role == ROLE_PREFILL:
                kw.update(p_kw)
            elif role == ROLE_DECODE:
                kw.update(d_kw)
            kw.setdefault("role", role)
            if inner is not None:
                return inner(rm, mesh, i, **kw)
            return ServingEngine(rm, mesh=mesh, **kw)

        super().__init__(model, dp=len(roles), mp=mp, devices=devices,
                         model_factory=model_factory,
                         placement=placement or RolePlacement(),
                         engine_factory=factory, **engine_kw)
        self._page_transfer = PageTransfer(
            fault_hook=lambda p, c: self._transfer_hook(p, c))
        # transfer telemetry, cluster-labeled: a transfer belongs to the
        # hand-off, not to either replica
        self._transfer_totals = _tmetrics.CounterSet(
            "serving_transfer", {"pages": 0, "bytes": 0, "total": 0,
                                 "failed": 0},
            labels=self._cluster_label)
        self._transfer_hist = _tmetrics.registry().histogram(
            "serving_transfer_seconds",
            "wall seconds per committed page hand-off (reserve -> "
            "commit -> source release)",
        ).labels(**self._cluster_label)

    def _transfer_hook(self, point: str, ctx: dict):
        """The ``page_transfer`` fault point rides the cluster's injector
        (``FaultInjector.install(cluster)``), same as ``cluster_step``."""
        if self._fault_hook is not None:
            self._fault_hook(point, ctx)

    # -- role queries ------------------------------------------------------
    def role_indices(self, role: str) -> List[int]:
        return [i for i, r in enumerate(self.roles) if r == role]

    def _decode_destinations(self, src_i: int, req: Request) -> List[int]:
        """Decode replicas ranked for THIS request: LoRA residency is
        mandatory (a non-resident replica fails the tenant at adoption),
        then load, then speculative acceptance — the ROADMAP-named
        decode-side placement signals."""
        cands = []
        for i in self.role_indices(ROLE_DECODE):
            if i == src_i or not self._stepping(i):
                continue
            e = self.replicas[i]
            if e.draining or not e.scheduler.free_slot_indices():
                continue
            resident, accept = replica_signals(e, req.adapter)
            if req.adapter is not None and not resident:
                continue
            cands.append(((0 if resident else 1), replica_load(e),
                          -accept, i))
        return [c[-1] for c in sorted(cands)]

    # -- the hand-off scan -------------------------------------------------
    def run_handoffs(self) -> int:
        """Scan prefill replicas for requests whose prompt completed and
        hand each to a decode replica; returns transfers committed.  Runs
        at the START of every cluster tick (before any replica steps), so
        a copy never races the pools' own step dispatches.  A request no
        destination can take right now simply keeps decoding where it is
        — colocated fallback, never a stall."""
        moved = 0
        for si in self.role_indices(ROLE_PREFILL):
            if not self._stepping(si):
                continue
            src = self.replicas[si]
            # plan: route each ready request to its best destination,
            # spilling to the next-ranked one when a pool's free slots
            # fill up, then move each destination's group in ONE batched
            # copy (transfer_many) — the per-request ownership protocol
            # is preserved inside the batch
            plan: dict = {}
            for idx, slot in src.scheduler.seated():
                req = slot.request
                if req.state != RequestState.DECODE:
                    continue
                if slot.pending is not None and len(slot.pending):
                    continue
                for di in self._decode_destinations(si, req):
                    taken = plan.setdefault(di, [])
                    if len(taken) < len(
                            self.replicas[di].scheduler.free_slot_indices()):
                        taken.append(idx)
                        break
            for di, idxs in plan.items():
                moved += self._transfer_group(si, src, idxs, di)
        return moved

    def _transfer_group(self, si: int, src: ServingEngine,
                        idxs: List[int], di: int) -> int:
        t0 = time.monotonic()
        try:
            committed, pages, failed = self._page_transfer.transfer_many(
                src, idxs, self.replicas[di],
                src_replica=si, dst_replica=di)
        except Exception:  # noqa: BLE001 — whole-batch copy failure
            self._transfer_totals.inc("failed", len(idxs))
            return 0
        if failed:
            self._transfer_totals.inc("failed", failed)
        if not committed:
            return 0
        self._transfer_totals.inc("pages", pages)
        self._transfer_totals.inc("bytes",
                                  page_transfer_bytes(src.cache, pages))
        self._transfer_totals.inc("total", committed)
        self._transfer_hist.observe(time.monotonic() - t0)
        return committed

    # -- the serving loop --------------------------------------------------
    def _replica_step(self, i: int) -> dict:
        """Decode-role replicas run ``decode_steps_per_tick`` sub-steps
        INSIDE the pooled barrier — their cheap decode-only dispatches
        overlap the prefill replicas' longer steps instead of gating on
        them: decode cadence decoupled from prompt length."""
        if self.roles[i] != ROLE_DECODE or self.decode_steps_per_tick == 1:
            return super()._replica_step(i)
        eng = self.replicas[i]
        met = eng.step()
        tokens = met["tokens_this_step"]
        for _ in range(self.decode_steps_per_tick - 1):
            met = eng.step()
            tokens += met["tokens_this_step"]
        met = dict(met)
        met["tokens_this_step"] = tokens
        return met

    def step(self) -> dict:
        """One cluster tick: hand-offs first (tick-start, before any
        replica steps, so a copy never races a pool's own dispatch),
        then the inherited tick with decode sub-stepping inside the
        barrier (``_replica_step``)."""
        transfers = self.run_handoffs()
        agg = super().step()
        agg["transfers_this_step"] = transfers
        return agg

    # -- observability -----------------------------------------------------
    def metrics(self) -> dict:
        out = super().metrics()
        out["roles"] = list(self.roles)
        t = dict(self._transfer_totals)
        out["transfer_pages"] = t["pages"]
        out["transfer_bytes"] = t["bytes"]
        out["transfers_total"] = t["total"]
        out["transfers_failed"] = t["failed"]
        return out


# ---------------------------------------------------------------------------
# per-role elasticity
# ---------------------------------------------------------------------------

class _RolePoolView:
    """One role pool of a :class:`DisaggServingEngine`, shaped like the
    cluster surface :class:`~.elastic.ElasticServingController` senses
    and actuates — replica indices are LOCAL to the pool (``indices``
    maps them back).  Unknown attributes (the brownout actuators,
    ``set_shedding``, ...) delegate to the real cluster: the rungs are
    cluster-wide, which is exactly why only ONE pool's controller may
    own them."""

    def __init__(self, cluster, indices: Sequence[int]):
        self._cluster = cluster
        self.indices = list(indices)

    @property
    def replicas(self):
        return [self._cluster.replicas[i] for i in self.indices]

    def _stepping(self, i: int) -> bool:
        return self._cluster._stepping(self.indices[i])

    @property
    def _parked(self):
        return {j for j, g in enumerate(self.indices)
                if g in self._cluster._parked}

    def activate_replica(self, i: int):
        self._cluster.activate_replica(self.indices[i])

    def begin_drain_replica(self, i: int, deadline_s: float = 5.0):
        self._cluster.begin_drain_replica(self.indices[i],
                                          deadline_s=deadline_s)

    def __getattr__(self, name):
        return getattr(self._cluster, name)


class DisaggElasticController:
    """Two elastic controllers over one disaggregated cluster: the prefill
    pool (prefill + colocated replicas) regulates TTFT and owns the
    brownout ladder; the decode pool regulates ITL
    (``ElasticConfig(signal="itl")``) with its ladder disabled.  Each
    pool scales up/down only among ITS replicas, from ITS SLO signal —
    independent role scaling, while drain/re-home (``begin_drain_replica``
    checkpoints re-prefill on the admitting pool via
    :class:`RolePlacement`) and the ladder compose unchanged.

    Action ``replica`` indices are pool-local; ``prefill_pool.indices``
    / ``decode_pool.indices`` translate to cluster indices."""

    def __init__(self, cluster, prefill_config: Optional[ElasticConfig]
                 = None, decode_config: Optional[ElasticConfig] = None,
                 clock: Callable[[], float] = time.monotonic):
        roles = (list(getattr(cluster, "roles", ()))
                 or [replica_role(e) for e in cluster.replicas])
        self.cluster = cluster
        self.prefill_pool = _RolePoolView(
            cluster, [i for i, r in enumerate(roles) if r != ROLE_DECODE])
        self.decode_pool = _RolePoolView(
            cluster, [i for i, r in enumerate(roles) if r == ROLE_DECODE])
        if decode_config is None:
            decode_config = ElasticConfig(signal="itl",
                                          brownout_enabled=False)
        self.prefill = ElasticServingController(
            self.prefill_pool, prefill_config, clock=clock)
        self.decode = ElasticServingController(
            self.decode_pool, decode_config, clock=clock)

    def tick(self) -> list:
        return self.prefill.tick() + self.decode.tick()

    @property
    def actions(self) -> list:
        return list(self.prefill.actions) + list(self.decode.actions)

    def close(self):
        self.prefill.close()
        self.decode.close()
