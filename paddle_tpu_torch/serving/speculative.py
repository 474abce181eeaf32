"""Speculative serving: draft-model propose, ONE fused verify dispatch
(port of ``paddle_tpu/serving/speculative.py``).

A cheap DRAFT model proposes up to ``k`` tokens per seated decode slot,
and the target model verifies all ``k + 1`` positions of every slot in ONE
launch of the existing fused ragged step: each slot's
:class:`~paddle_tpu_torch.serving.admission.StepWork` is simply a
``k+1``-token run (``kind='verify'``), planned by the same
``AdmissionScheduler.plan_step`` budget math and attended by the same
ragged kernel.  No new kernel: prefill runs, plain decode slots and
verification runs mix in the same launch.

Accept/reject happens ON THE DEVICE, vectorized over slots and positions
(one copy of the outcome to the host per step, no read per position):

- **greedy** -- the emitted tokens are the target's own argmax chain up to
  and including the first position where the draft's proposal mismatches:
  the plain engine's tokens, by construction.
- **sampling** -- leftover-distribution resampling: proposal ``d_{j+1}``
  (drawn from the draft's post-filter distribution ``q_j``) is accepted
  with probability ``min(1, p_j(d)/q_j(d))`` against the target's
  post-filter ``p_j``; the first rejection resamples from
  ``norm(max(p_j - q_j, 0))``, and full acceptance draws the bonus token
  from ``p_k``.  The emitted distribution is exactly the target's.  The
  uniforms and Gumbel noise come from the engine's ``torch.Generator``.

Commit protocol: each slot's accepted prefix is committed with
``advance(idx, n_accepted + 1)``; K/V the target wrote for REJECTED
positions sits beyond the committed position and is never read, so the
next verify run overwrites it.  The draft's own pool follows the
allocator's speculative reservations: pages are reserved ``reserve_spec``
as propose runs pass the slot's committed pages, promoted ``commit_spec``
for accepted positions and rolled back ``rollback_spec`` on rejection,
faults and retirement -- free + used + spec + shared == capacity on both
pools at every step.

Degradation, never corruption: a draft that cannot run (draft pool
exhausted, catch-up backlog) proposes nothing -- the slot decodes one
token through the verify step, and the missed tokens queue on the shadow's
per-slot pending list to be ingested later.  ``speculation_enabled =
False`` skips the draft phase altogether (verify runs carry no proposals).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.kernels.ragged_paged_attention import (
    RAGGED_PLAN_FIELDS, build_ragged_plan,
)
from ..telemetry import metrics as _tmetrics
from ..telemetry import trace as _ttrace
from .admission import StepWork
from .engine import (
    _NEG, NaNLogitsError, RequestState, ServingEngine, StepStalledError,
    _filter_logits, _gumbel, _PackLayout, _plan_fields, _state_intact,
    _uncontainable,
)
from .paged_cache import NULL_PAGE, BlockAllocator, pages_for_tokens

__all__ = ["SpeculativeEngine"]


def _sample_with_probs(rows, temperature, top_p, top_k, do_sample,
                       generator):
    """Per-slot sampling over fp32 [S, V] logits returning BOTH the drawn
    token [S] and the post-filter distribution q [S, V] it was drawn
    from -- the draft side of leftover resampling needs q.  Greedy rows
    return their argmax."""
    greedy = rows.argmax(-1)
    filt = _filter_logits(rows / temperature.clamp(min=1e-6)[:, None],
                          top_p, top_k)
    q = torch.softmax(filt, dim=-1)
    sampled = (filt + _gumbel(filt.shape, generator, filt.device)).argmax(-1)
    return torch.where(do_sample, sampled, greedy), q


def _filtered_probs(lg, temperature, top_p, top_k):
    """[S, R, V] logits -> the temperature/top-k/top-p filtered softmax
    per (slot, row): the target distribution p of leftover resampling.
    The same filter as the draft side's (:func:`_sample_with_probs`)."""
    scaled = lg / temperature.clamp(min=1e-6)[:, None, None]
    return torch.softmax(_filter_logits(scaled, top_p, top_k), dim=-1)


def _verify_tokens(rows_lg, drafts, n_draft, temp=None, top_p=None,
                   top_k=None, do_sample=None, qprobs=None, generator=None):
    """Accept/reject over the gathered verify rows, on their device.

    rows_lg: [S, k+1, V] logits (row j = the target's distribution after
    the slot's j-th verify input); drafts: [S, k] proposals; n_draft: [S]
    valid proposals per slot (0 = plain decode / prefill completion);
    qprobs: k [S, V] draft post-filter distributions (sampling only, with
    the per-slot ``temp``/``top_p``/``top_k``/``do_sample`` and
    ``generator``).  Returns (out_tokens [S, k+1] int64, n_acc [S],
    finite [S] bool): the host emits ``out_tokens[s, :n_acc[s] + 1]``."""
    s, k1, v = rows_lg.shape
    kk = k1 - 1
    dev = rows_lg.device
    lg = rows_lg.float()
    nd = n_draft.long()
    vp = torch.arange(kk, device=dev)[None, :]
    vp1 = torch.arange(k1, device=dev)[None, :]
    live = vp < nd[:, None]                              # [S, k]
    # per-slot finiteness over the slot's OWN rows only (rows past
    # n_draft may be another slot's clamped rows)
    row_live = vp1 <= nd[:, None]                        # [S, k+1]
    fin = (torch.isfinite(lg) | ~row_live[..., None]).flatten(1).all(1)
    g = lg.argmax(-1)                                    # [S, k+1]
    d64 = drafts.long()
    acc_g = (d64 == g[:, :kk]) & live
    n_acc_g = torch.cumprod(acc_g.long(), dim=1).sum(1)
    if qprobs is None:
        return g, n_acc_g, fin
    q = torch.stack(list(qprobs), dim=1).float()         # [S, k, V]
    # mask each slot's q rows at/past its OWN n_draft: a propose
    # iteration this slot never joined holds another slot's row -- zero
    # makes the residual at a dead position the pure target row
    q = torch.where((vp < nd[:, None])[..., None], q, torch.zeros_like(q))
    pt = _filtered_probs(lg, temp, top_p, top_k)         # [S, k+1, V]
    dc = d64.clamp(0, v - 1)[..., None]
    pd = torch.gather(pt[:, :kk], 2, dc)[..., 0]         # [S, k]
    qd = torch.gather(q, 2, dc)[..., 0]
    u = torch.rand((s, kk), generator=generator, device=dev)
    # accept d with probability min(1, pd/qd): u*qd < pd (qd > 0 for any
    # token the draft actually sampled)
    acc_s = (u * qd.clamp(min=1e-30) < pd) & live
    n_acc_s = torch.cumprod(acc_s.long(), dim=1).sum(1)
    # residual at the first rejected position (the q row past k is 0, so
    # full acceptance draws the bonus from the pure target row)
    q_ext = torch.cat([q, torch.zeros((s, 1, v), device=dev)], dim=1)
    rows = torch.arange(s, device=dev)
    p_at = pt[rows, n_acc_s]
    q_at = q_ext[rows, n_acc_s]
    r = (p_at - q_at).clamp(min=0.0)
    # numerical guard: an (impossible in exact math) all-zero residual
    # falls back to the target row
    r = torch.where(r.sum(-1, keepdim=True) > 0, r, p_at)
    logr = torch.where(r > 0, torch.log(r.clamp(min=1e-38)),
                       torch.full_like(r, _NEG))
    res = (logr + _gumbel((s, v), generator, dev)).argmax(-1)
    d_pad = torch.cat([d64, torch.zeros((s, 1), dtype=torch.long,
                                        device=dev)], dim=1)
    out_s = torch.where(vp1 < n_acc_s[:, None], d_pad, res[:, None])
    return (torch.where(do_sample[:, None], out_s, g),
            torch.where(do_sample, n_acc_s, n_acc_g), fin)


class _DraftShadow:
    """The draft model's serving state, slot-aligned with the target
    engine: its OWN page pool and allocator (speculative-reservation
    discipline), host mirrors and packed transport."""

    def __init__(self, engine: "SpeculativeEngine", draft_model):
        self.engine = engine
        self.model = draft_model
        cfg = draft_model.config
        e = engine
        if cfg.vocab_size != e.model.config.vocab_size:
            raise ValueError(
                f"draft vocab {cfg.vocab_size} != target vocab "
                f"{e.model.config.vocab_size}")
        if draft_model.device != e.device:
            raise ValueError(f"the draft model is on {draft_model.device}, "
                             f"the target on {e.device}")
        self.page_size = e.page_size
        self.max_pages_per_slot = e.max_context // e.page_size
        self.num_pages = e.draft_num_pages
        S, k = e.num_slots, e.spec_k
        # geometry: iteration 1 may carry per slot a catch-up run of up
        # to k+1 deferred tokens plus the live input, alongside the full
        # prefill budget; iterations 2..k are one token per slot
        self.t_max = S * (k + 2) + e.prefill_token_budget
        qb = e.token_block
        self.nb_max = (S * (-(-(k + 2) // qb)) + S
                       + e.prefill_token_budget // qb)
        self.wl_max = self.nb_max * self.max_pages_per_slot
        # host mirrors (the target scheduler's discipline, shadow copies)
        self.tables = np.full((S, self.max_pages_per_slot), NULL_PAGE,
                              np.int32)
        self.pos = np.zeros((S,), np.int64)       # committed draft tokens
        self.committed: List[List[int]] = [[] for _ in range(S)]
        self.spec: List[List[int]] = [[] for _ in range(S)]
        self.pending: List[List[int]] = [[] for _ in range(S)]
        self.allocator = BlockAllocator(self.num_pages)
        self.pack = _PackLayout(
            [("ids", (self.t_max,)),
             ("tables", (self.t_max, self.max_pages_per_slot)),
             ("positions", (self.t_max,)), ("out_rows", (S,))]
            + _plan_fields(self.t_max, self.nb_max, self.wl_max, qb))
        self.cache = self._new_pool()

    def _new_pool(self):
        return self.model.new_paged_kv_cache(
            self.num_pages, self.page_size, dtype=self.engine.cache_dtype)

    # -- slot lifecycle -----------------------------------------------------
    def seat(self, idx: int):
        self.tables[idx] = NULL_PAGE
        self.pos[idx] = 0
        self.committed[idx] = []
        self.spec[idx] = []
        self.pending[idx] = []

    def retire(self, idx: int):
        """Slot retired on the target: committed pages free, speculative
        reservations roll back."""
        if self.committed[idx]:
            self.allocator.free(self.committed[idx])
        if self.spec[idx]:
            self.allocator.rollback_spec(self.spec[idx])
        self.seat(idx)

    def reset(self, release_old: bool = True):
        """Recovery: every slot was retired by the engine; a fresh pool
        (the old one released at once, or by the zombie's cleanup after a
        stall) and the drained-allocator invariant re-asserted."""
        assert self.allocator.used_pages == 0, \
            f"draft rebuild leaked {self.allocator.used_pages} pages"
        assert self.allocator.spec_pages == 0, \
            f"draft rebuild leaked {self.allocator.spec_pages} spec pages"
        old, self.cache = self.cache, self._new_pool()
        if release_old:
            old.release()

    # -- paging -------------------------------------------------------------
    def ensure_pages(self, idx: int, total_tokens: int) -> bool:
        """Speculatively reserve whatever pages positions
        ``[0, total_tokens)`` need beyond the slot's current reservation.
        False (nothing changed) when the draft pool cannot serve them --
        the caller degrades instead of corrupting state."""
        need = pages_for_tokens(total_tokens, self.page_size)
        have = len(self.committed[idx]) + len(self.spec[idx])
        if need <= have:
            return True
        got = self.allocator.reserve_spec(need - have)
        if got is None:
            return False
        self.tables[idx][have:need] = got
        self.spec[idx].extend(got)
        return True

    def commit(self, idx: int, new_pos: int):
        """Promote the speculative reservation covering the committed
        position, roll back the rest (rejected speculative pages return to
        the free list NOW)."""
        need = pages_for_tokens(new_pos, self.page_size)
        n_commit = max(need - len(self.committed[idx]), 0)
        sp = self.spec[idx]
        keep, drop = sp[:n_commit], sp[n_commit:]
        if keep:
            self.allocator.commit_spec(keep)
            self.committed[idx].extend(keep)
        if drop:
            self.allocator.rollback_spec(drop)
        self.spec[idx] = []
        self.tables[idx][len(self.committed[idx]):] = NULL_PAGE
        self.pos[idx] = int(new_pos)

    # -- packed transport ---------------------------------------------------
    def build_inputs(self, runs: List[Tuple[int, np.ndarray, int]]
                     ) -> np.ndarray:
        """runs: (slot, token ids, base position) per slot, at most one
        run per slot -> the draft step's packed input.  Every run samples
        from its last row (out_rows)."""
        pack = self.pack
        packed = pack.new()
        ids = pack.view(packed, "ids")
        tables = pack.view(packed, "tables")
        positions = pack.view(packed, "positions")
        out_rows = pack.view(packed, "out_rows")
        plan_runs = []
        t = 0
        for slot, toks, base in runs:
            c = len(toks)
            ids[t:t + c] = toks
            row = self.tables[slot]
            tables[t:t + c] = row
            positions[t:t + c] = base + np.arange(c, dtype=np.int32)
            out_rows[slot] = t + c - 1
            plan_runs.append((base, c, row))
            t += c
        plan, _stats = build_ragged_plan(
            plan_runs, token_block=self.engine.token_block,
            page_size=self.page_size, t_max=self.t_max,
            nb_max=self.nb_max, wl_max=self.wl_max)
        for kf in RAGGED_PLAN_FIELDS:
            pack.view(packed, kf)[...] = plan[kf]
        return packed


class SpeculativeEngine(ServingEngine):
    """:class:`ServingEngine` with draft-model speculative decoding.

    ``draft_model`` may be ANY model implementing the paged-cache
    contract with the same vocabulary on the same device -- a small
    model, a truncated weight-sharing prefix (``models.truncated_draft``),
    or the target itself (every proposal accepted).  ``spec_k`` proposals
    are drafted per decode slot per tick (clamped per slot so speculation
    never overruns ``max_new_tokens``); ``draft_num_pages`` sizes the
    draft pool (default: full capacity).  The draft pool takes the
    target's ``kv_dtype``.

    Composes with per-request LoRA (``lora=``): adapters apply to the
    TARGET's verify step; the draft proposes adapter-less (acceptance
    drops for heavily adapted tenants, correctness never does)."""

    def __init__(self, model, draft_model, *, spec_k: int = 4,
                 draft_num_pages: Optional[int] = None, **kw):
        if spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        self.spec_k = int(spec_k)
        # False skips the draft phase entirely: verify runs carry zero
        # proposals (plain decode, greedy output unchanged) and the
        # shadow's skipped tokens join its catch-up backlog
        self.speculation_enabled = True
        self._draft_num_pages_arg = draft_num_pages
        self._spec_last: Dict[int, dict] = {}
        self._zero_q = None
        super().__init__(model, **kw)
        self.draft = _DraftShadow(self, draft_model)
        reg = _tmetrics.registry()
        self._spec_totals = _tmetrics.CounterSet(
            "serving_spec",
            {"proposed_tokens": 0, "accepted_tokens": 0, "verify_steps": 0,
             "draft_steps": 0, "draft_skips": 0},
            labels=self._engine_label)
        # per-verify-step accepted-count histogram: the acceptance SHAPE
        self._spec_hist = reg.histogram(
            "serving_spec_accepted_per_step",
            "draft tokens accepted per slot per verify step",
        ).labels(**self._engine_label)

    # -- geometry -----------------------------------------------------------
    def _step_geometry(self):
        # every decode slot may run a (k+1)-token verify run while prefill
        # runs share the budget
        k1 = self.spec_k + 1
        qb = self.token_block
        t_max = self.num_slots * k1 + self.prefill_token_budget
        nb_max = (self.num_slots * (-(-k1 // qb)) + self.num_slots
                  + self.prefill_token_budget // qb)
        return t_max, nb_max

    def _extra_pack_fields(self):
        return [("drafts", (self.num_slots, self.spec_k)),
                ("n_draft", (self.num_slots,))]

    @property
    def draft_num_pages(self) -> int:
        if self._draft_num_pages_arg is not None:
            return int(self._draft_num_pages_arg)
        return self.num_slots * (self.max_context // self.page_size) + 1

    # -- lifecycle hooks ----------------------------------------------------
    def _admit(self, now):
        before = {i for i, _s in self.scheduler.seated()}
        super()._admit(now)
        for i, slot in self.scheduler.seated():
            if i not in before:
                self.draft.seat(i)
                if slot.pos:
                    # prefix-cache hit on the TARGET: the draft's pool
                    # holds none of those positions, so the skipped prompt
                    # tokens join its catch-up backlog
                    self.draft.pending[i] = [
                        int(t) for t in slot.request.prompt[:slot.pos]]

    def _clear_slot_mirrors(self, idx: int):
        super()._clear_slot_mirrors(idx)
        self.draft.retire(idx)

    def _rebuild(self, release_old: bool = True):
        super()._rebuild(release_old=release_old)
        self.draft.reset(release_old=release_old)

    def _zombie_cleanup(self):
        target, draft = self.cache, self.draft.cache

        def cleanup():
            target.release()
            draft.release()

        return cleanup

    def metrics(self) -> dict:
        out = super().metrics()
        out.update({f"spec_{k}": v for k, v in self._spec_totals.items()})
        prop = self._spec_totals["proposed_tokens"]
        out["spec_acceptance_rate"] = (
            self._spec_totals["accepted_tokens"] / prop if prop else 0.0)
        out["spec_k"] = self.spec_k
        out["spec_accepted_per_step"] = self._spec_hist.summary()
        out["draft_pages_used"] = self.draft.allocator.used_pages
        out["draft_spec_pages"] = self.draft.allocator.spec_pages
        return out

    def close(self):
        with self._lock:
            if not self._closed:
                self.draft.cache.release()
        super().close()

    # -- the speculative tick ----------------------------------------------
    def _dispatch_step(self, work):
        """Draft propose phase (up to k draft dispatches) -> ONE fused
        verify dispatch -> accept/commit harvest.  Containment matches the
        base engine: any containable exception in either phase implicates
        every seated request, draft speculative pages roll back through
        slot retirement, and recovery rebuilds BOTH pools."""
        try:
            with _ttrace.span("serve.propose"):
                vwork, qprobs = self._propose(work)
            with _ttrace.span("serve.pack"):
                packed, stats = self._build_step_inputs(vwork)
            with _ttrace.span("serve.dispatch"):
                out = self._run_verify(packed, qprobs)
        except StepStalledError as e:
            self._recover(e, rebuild=True, stalled=True)
            return
        except Exception as e:  # noqa: BLE001 — containment boundary
            if _uncontainable(e):
                raise
            self._recover(e, rebuild=not _state_intact(e))
            return
        self._totals["fused_steps"] += 1
        self._spec_totals.inc("verify_steps")
        with _ttrace.span("serve.harvest"):
            self._harvest_verify(vwork, stats, *out)
        self._backoff_s = self.readmission_backoff_s

    def _propose(self, work):
        """Run the draft phase for one tick's plan: per decode slot,
        drain any catch-up backlog, then propose up to ``spec_k`` tokens
        (clamped to the request's remaining budget and the draft pool's
        pages).  Returns the verify work list (decode entries widened to
        ``kind='verify'`` runs carrying their proposals) and the draft
        q-rows (left on the device) for the sampling variant."""
        sched = self.scheduler
        sampling = bool(self._do_sample.any())
        k = self.spec_k
        spec_on = self.speculation_enabled
        it1: List[Tuple[int, np.ndarray, int]] = []
        decode: List[Tuple[StepWork, int]] = []      # (work, k_s)
        live = set()
        for w in work:
            slot = sched.slots[w.slot]
            if not spec_on:
                # no draft dispatch at all; the committed token joins the
                # shadow's backlog at harvest
                if w.kind == "prefill":
                    self._spec_totals.inc("draft_skips")
                    self._spec_last[w.slot] = {"prefill_ran": False}
                else:
                    self._spec_last[w.slot] = {"consumed": 0,
                                               "wrote_input": False,
                                               "n_draft": 0}
                    decode.append((w, 0))
                continue
            dpos = int(self.draft.pos[w.slot])
            if w.kind == "prefill":
                # the shadow runs the same prefill run only while it is
                # exactly in step (no backlog); otherwise the chunk joins
                # the backlog and drains through decode catch-up runs
                ran = (not self.draft.pending[w.slot] and dpos == slot.pos
                       and self.draft.ensure_pages(w.slot,
                                                   dpos + w.count))
                if ran:
                    it1.append((w.slot,
                                np.asarray(slot.pending[:w.count],
                                           np.int64), dpos))
                else:
                    self._spec_totals.inc("draft_skips")
                self._spec_last[w.slot] = {"prefill_ran": ran}
                continue
            req = slot.request
            k_s = max(0, min(k, req.max_new_tokens - len(req.tokens) - 1))
            catch = list(self.draft.pending[w.slot])
            meta = {"consumed": 0, "wrote_input": False, "n_draft": 0}
            if len(catch) > k + 1:
                # deep backlog: drain only, no proposals this tick
                run = catch[:k + 1]
                k_s = 0
                if self.draft.ensure_pages(w.slot, dpos + len(run)):
                    it1.append((w.slot, np.asarray(run, np.int64), dpos))
                    meta["consumed"] = len(run)
                else:
                    self._spec_totals.inc("draft_skips")
            else:
                run = catch + [int(self._tokens[w.slot])]
                # iteration 1 writes catch+input through position
                # slot.pos; iterations 2..k_s write proposals through
                # slot.pos + k_s - 1
                ok = self.draft.ensure_pages(w.slot,
                                             slot.pos + max(k_s, 1))
                if not ok:
                    # draft pool exhausted: degrade to the pages held
                    have = (len(self.draft.committed[w.slot])
                            + len(self.draft.spec[w.slot]))
                    room = have * self.page_size - slot.pos
                    k_s = max(0, min(k_s, int(room)))
                    ok = room >= 1
                if ok:
                    it1.append((w.slot, np.asarray(run, np.int64), dpos))
                    meta.update(consumed=len(catch), wrote_input=True)
                    if k_s >= 1:
                        live.add(w.slot)
                else:
                    self._spec_totals.inc("draft_skips")
                    k_s = 0
            self._spec_last[w.slot] = meta
            decode.append((w, k_s))
        drafts: Dict[int, List[int]] = {w.slot: [] for w, _ in decode}
        qrows: List = []
        max_k = max((ks for w, ks in decode if w.slot in live), default=0)
        if it1:
            toks, q = self._draft_dispatch(it1, sampling)
            for s in live:
                drafts[s].append(int(toks[s]))
            if sampling:
                qrows.append(q)
        # iterations 2..k: one proposal per still-speculating slot
        for j in range(2, max_k + 1):
            runs = [(w.slot,
                     np.asarray([drafts[w.slot][-1]], np.int64),
                     sched.slots[w.slot].pos + j - 1)
                    for w, ks in decode if w.slot in live and ks >= j]
            if not runs:
                break
            toks, q = self._draft_dispatch(runs, sampling)
            for s, _t, _b in runs:
                drafts[s].append(int(toks[s]))
            if sampling:
                qrows.append(q)
        # assemble the verify work list (plan order preserved)
        vwork: List[StepWork] = []
        for w in work:
            if w.kind == "prefill":
                vwork.append(w)
                continue
            props = drafts.get(w.slot, []) if w.slot in live else []
            if props:
                self._spec_totals.inc("proposed_tokens", len(props))
            self._spec_last[w.slot]["n_draft"] = len(props)
            vwork.append(StepWork(w.slot, "verify", 1 + len(props),
                                  w.base, False,
                                  drafts=np.asarray(props, np.int64)))
        return vwork, (self._stack_qrows(qrows) if sampling else ())

    def _build_step_inputs(self, work):
        """Base packing (verify runs already write [t0, d1..dk] token
        ids) plus the accept/reject inputs: per-slot draft tokens and
        counts ride the same packed transport."""
        packed, stats = super()._build_step_inputs(work)
        dv = self._pack.view(packed, "drafts")
        nv = self._pack.view(packed, "n_draft")
        for w in work:
            if w.kind == "verify" and w.drafts is not None:
                n = len(w.drafts)
                if n:
                    dv[w.slot, :n] = w.drafts
                nv[w.slot] = n
        return packed, stats

    def _stack_qrows(self, qrows):
        """Pad the per-iteration draft q-rows to exactly ``spec_k``
        (missing iterations ride a cached zero row)."""
        if self._zero_q is None:
            self._zero_q = torch.zeros(
                (self.num_slots, self.model.config.vocab_size),
                dtype=torch.float32, device=self.device)
        out = list(qrows[:self.spec_k])
        out += [self._zero_q] * (self.spec_k - len(out))
        return tuple(out)

    def _draft_dispatch(self, runs, sampling):
        """One supervised draft-step dispatch over ``runs``; returns the
        sampled tokens (host) and, under sampling, the post-filter q rows
        (LEFT ON THE DEVICE -- they feed the verify step directly)."""
        packed = self.draft.build_inputs(runs)
        shadow = self.draft
        cache = shadow.cache

        def thunk(cancelled):
            with torch.no_grad(), _ttrace.span("serve.draft_step"):
                if cancelled():
                    return None
                samp, built = (self._sampling_inputs() if sampling
                               else (None, None))
                f = shadow.pack.unpack(
                    torch.from_numpy(packed).to(self.device))
                logits = shadow.model._paged_lm_logits(
                    f["ids"][:, None], cache, f["tables"], f["positions"],
                    ragged_plan=tuple(f[kf] for kf in RAGGED_PLAN_FIELDS),
                    out_rows=f["out_rows"])
                rows = logits[:, -1, :].float()
                if sampling:
                    tok, q = _sample_with_probs(rows, *samp,
                                                generator=self._generator)
                else:
                    tok, q = rows.argmax(-1), None
                return tok.cpu().numpy(), q, built

        tok, q = self._supervised_call(thunk, [("draft", sampling)],
                                       retry=False)
        self._spec_totals.inc("draft_steps")
        return tok, q

    def _run_verify(self, packed, qprobs):
        """The verify dispatch: the base ``_run_fused`` contract (watchdog
        + one retry) with the draft q-rows for the sampling variant."""
        sampling = bool(self._do_sample.any())
        cache = self.cache

        def thunk(cancelled):
            return self._verify_thunk(packed, cache, sampling, qprobs,
                                      cancelled)

        toks, n_acc, fin = self._supervised_call(thunk,
                                                 [("verify", sampling)])
        return toks, n_acc, fin

    def _verify_thunk(self, packed, cache, sampling, qprobs, cancelled):
        """The verify step's device work: the fused step gathers ``k+1``
        rows per slot (a slot's verify run ends at its output row), the LM
        head projects only those, accept/reject runs on the device, and
        one copy brings (tokens, accepted counts, finiteness) back."""
        k, t_max = self.spec_k, self._t_max
        with torch.no_grad(), _ttrace.span("serve.device_step"):
            self._hook("before_decode")
            if cancelled():
                return None
            samp, built = (self._sampling_inputs() if sampling
                           else (None, None))
            f = self._upload(packed)
            nd = f["n_draft"].long()
            vrows = (f["out_rows"].long()[:, None] - nd[:, None]
                     + torch.arange(k + 1, device=nd.device)[None, :])
            vrows = vrows.clamp(0, t_max - 1).reshape(-1)
            rows = self._logit_rows(f, cache, vrows)
            lg = rows.view(self.num_slots, k + 1, rows.shape[-1])
            if sampling:
                out_tok, n_acc, fin = _verify_tokens(
                    lg, f["drafts"], nd, *samp, qprobs=qprobs,
                    generator=self._generator)
            else:
                out_tok, n_acc, fin = _verify_tokens(lg, f["drafts"], nd)
            out = torch.cat([out_tok, n_acc[:, None], fin[:, None].long()],
                            dim=1).cpu().numpy()
            return out[:, :k + 1], out[:, k + 1], out[:, k + 2].astype(bool), \
                built

    def _harvest_verify(self, work, stats, toks_np, n_acc_np, fin_np):
        """Commit one verify step: per slot, emit the accepted prefix +
        bonus (eos may truncate it), ``advance`` by what was emitted,
        and square the draft shadow's position/pages/pending against the
        commit -- rejected draft pages roll back here."""
        ctx = {"tokens": toks_np, "finite": fin_np, "n_acc": n_acc_np}
        self._hook("after_decode", ctx)
        sched = self.scheduler
        self._fold_plan_stats(work, stats)
        step_now = time.monotonic()
        for w in work:
            slot = sched.slots[w.slot]
            if slot is None:
                continue
            if w.kind == "prefill":
                consumed = slot.pending[:w.count]
                slot.pending = slot.pending[w.count:]
                meta = self._spec_last.pop(w.slot, {})
                if meta.get("prefill_ran"):
                    self.draft.commit(w.slot,
                                      int(self.draft.pos[w.slot]) + w.count)
                else:
                    # shadow skipped this chunk: it joins the backlog and
                    # drains through decode catch-up runs
                    self.draft.pending[w.slot].extend(
                        int(t) for t in consumed)
                if w.completes and not ctx["finite"][w.slot]:
                    self._totals["quarantined"] += 1
                    self._fail_slot(w.slot, _nan_err(slot, w))
                    continue
                sched.advance(w.slot, w.count)
                self._register_shared(w.slot)
                if not w.completes:
                    continue
                req = slot.request
                tok = int(ctx["tokens"][w.slot][0])
                req.state = RequestState.DECODE
                self._tokens[w.slot] = tok
                self._emit(req, tok, now=step_now)
                if self._is_finished(req, tok):
                    self._finish(w.slot)
                continue
            # verify runs
            meta = self._spec_last.pop(w.slot, {"consumed": 0,
                                                "wrote_input": False,
                                                "n_draft": 0})
            nd = int(meta.get("n_draft", 0))
            if not ctx["finite"][w.slot]:
                self._totals["quarantined"] += 1
                self._fail_slot(w.slot, _nan_err(slot, w))
                continue
            n_acc = min(int(ctx["n_acc"][w.slot]), nd)
            self._spec_totals.inc("accepted_tokens", n_acc)
            self._spec_hist.observe(float(n_acc))
            cand = [int(t) for t in ctx["tokens"][w.slot][:n_acc + 1]]
            req = slot.request
            n_emit = 0
            finished = False
            for tok in cand:
                self._emit(req, tok, now=step_now)
                n_emit += 1
                if self._is_finished(req, tok):
                    finished = True
                    break
            sched.advance(w.slot, n_emit)
            # pages the commit just completed become shareable -- verify
            # writes only ever land at positions >= the committed pos
            self._register_shared(w.slot)
            # draft shadow bookkeeping: which of the committed inputs
            # ([t0, d1..d_{n_emit-1}]) did the draft write this tick?
            seq = ([int(self._tokens[w.slot])]
                   + [int(d) for d in w.drafts[:n_emit - 1]])
            have = min(n_emit, max(nd, 1)) if meta["wrote_input"] else 0
            consumed = meta["consumed"]
            new_dpos = int(self.draft.pos[w.slot]) + consumed + have
            self.draft.pending[w.slot] = \
                self.draft.pending[w.slot][consumed:] + seq[have:]
            self.draft.commit(w.slot, new_dpos)
            self._tokens[w.slot] = cand[n_emit - 1]
            if finished:
                self._finish(w.slot)


def _nan_err(slot, w):
    return NaNLogitsError(
        f"request {slot.request.id}: non-finite logits in verify run "
        f"(slot {w.slot} quarantined)")
