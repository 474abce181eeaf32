"""ServingEngine: continuous batching over the paged KV cache with ONE
fused mixed prefill/decode step per tick (port of the core of
``paddle_tpu/serving/engine.py``).

Every tick runs a single fused step serving ALL seated decode slots AND a
budgeted number of prefill tokens from admitting requests
(``prefill_token_budget``), at token granularity: the step's inputs are a
flat token list (decode tokens and prefill-chunk tokens mixed), per-token
positions and page-table rows, and the host-built ragged work list that
``ops/kernels/ragged_paged_attention.py`` iterates.  Every token's K/V is
written into the pool at its absolute position before attention, so a
prefill chunk's tokens see each other within the same launch.  A slot
whose prompt completes this step samples its first generated token from
its last prompt row.  Padding tokens ride with null-page tables and
position 0, so their writes sink into page 0.

All int32 step inputs -- token ids, tables, positions, output rows and
the nine plan arrays -- travel as ONE packed vector: one host-to-device
copy per step.  The step returns the sampled tokens and the per-slot
finiteness flags in one device-to-host copy.  PyTorch runs the step
eagerly: there is no compiled program to count.

The step has a greedy variant (argmax) and a sampling variant (per-slot
temperature, top-k and top-p, then Gumbel-argmax drawn from the engine's
own ``torch.Generator``; greedy rows inside a mixed batch stay exact).

Request lifecycle: SUBMITTED (queued; admission backpressures on free
slots AND free pages) -> PREFILL -> DECODE -> one terminal state:
``DONE`` (max_new_tokens or eos), ``CANCELLED`` (``Request.cancel()``,
honoured at the next step boundary), ``TIMED_OUT`` (``deadline_s``
passed, or the request overstayed ``max_queue_wait_s``), ``FAILED`` (the
finiteness sentry caught non-finite logits: ``NaNLogitsError``).  Page
accounting stays exact through every one of them.

Quantized serving: ``kv_dtype="int8"`` (or ``cache_dtype="int8"``) keeps
the pool as int8 pages with per-(page, head) fp32 scales, quantized as the
fused step writes them and dequantized inside the ragged kernel;
``weight_dtype="int8"`` quantizes the model's projections and LM head in
place (``quantization.quantize_for_serving``) before the first step.

The model's other cache paths -- ``generate()`` over a contiguous cache
and the paged step without a plan -- are ported too (``models/gpt.py``);
the engine itself always passes a plan.  Not ported yet (each raises
``NotImplementedError`` naming its ROADMAP.md item): the prefix cache,
LoRA, mesh-sharded and disaggregated replicas, the watchdog, and
retry/rebuild.  Without
retry a step that raises propagates to the caller with the host mirrors
untouched (they advance only on success), so calling ``step()`` again
re-runs the same idempotent step.
"""
from __future__ import annotations

import itertools
import threading
import time
import warnings
from collections import deque
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..core import dtype_name, to_torch_dtype
from ..ops.kernels.ragged_paged_attention import (
    RAGGED_PLAN_FIELDS, TOKEN_BLOCK, build_ragged_plan,
)
from ..quantization.int8 import quantize_for_serving
from ..telemetry import metrics as _tmetrics
from ..telemetry import trace as _ttrace
from .admission import AdmissionScheduler
from .paged_cache import BlockAllocator

__all__ = [
    "RequestState", "SamplingParams", "Request", "RequestQueue",
    "ServingEngine", "ServingError", "Overloaded", "DeadlineExceeded",
    "RequestCancelled", "NaNLogitsError", "ragged_padding_waste",
]

_NEG = -1e30


# ---------------------------------------------------------------------------
# typed serving errors
# ---------------------------------------------------------------------------

class ServingError(RuntimeError):
    """Base of every typed serving fault."""


class Overloaded(ServingError):
    """Load shed: the bounded queue is full (raised at ``submit``) or the
    request overstayed ``max_queue_wait_s`` (attached to a TIMED_OUT
    request).  Clients should back off and retry."""


class DeadlineExceeded(ServingError):
    """The request's ``deadline_s`` passed before it completed."""


class RequestCancelled(ServingError):
    """The request was cancelled via ``Request.cancel()``."""


class NaNLogitsError(ServingError):
    """The finiteness sentry caught non-finite logits for this slot."""


class RequestState:
    SUBMITTED = "SUBMITTED"
    PREFILL = "PREFILL"
    DECODE = "DECODE"
    DONE = "DONE"
    CANCELLED = "CANCELLED"
    TIMED_OUT = "TIMED_OUT"
    FAILED = "FAILED"

    TERMINAL = frozenset({DONE, CANCELLED, TIMED_OUT, FAILED})


@dataclass
class SamplingParams:
    """Per-request sampling; every field rides as a per-slot vector of
    the fused step.  Greedy (``do_sample=False``) ignores the rest."""

    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0          # 0 = off
    top_p: float = 1.0      # 1.0 = off

    def __post_init__(self):
        if self.do_sample and not self.temperature > 0.0:
            raise ValueError("temperature must be > 0 when do_sample=True")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")


class Request:
    """One generation request moving through the engine."""

    _ids = itertools.count()

    def __init__(self, prompt: np.ndarray, max_new_tokens: int,
                 sampling: Optional[SamplingParams] = None,
                 eos_token_id: Optional[int] = None,
                 on_token: Optional[Callable] = None,
                 deadline_s: Optional[float] = None):
        self.id = next(Request._ids)
        self.prompt = np.asarray(prompt, np.int64).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.sampling = sampling or SamplingParams()
        self.eos_token_id = eos_token_id
        self.on_token = on_token
        self.state = RequestState.SUBMITTED
        self.tokens: List[int] = []      # generated ids, in order
        self.deadline_s = None if deadline_s is None else float(deadline_s)
        self.deadline: Optional[float] = None   # absolute monotonic; at submit
        self.submit_t: Optional[float] = None   # monotonic queue-entry time
        # SLO timestamps (time.monotonic): every terminal request carries
        # the stages it reached -- t_submitted <= t_admitted <=
        # t_first_token <= t_terminal, the middle two None for requests
        # that never seated / never produced a token
        self.t_submitted: Optional[float] = None
        self.t_admitted: Optional[float] = None
        self.t_first_token: Optional[float] = None
        self.t_terminal: Optional[float] = None
        self._t_last_token: Optional[float] = None   # ITL bookkeeping
        self.error: Optional[BaseException] = None
        self.callback_error: Optional[BaseException] = None
        self._cancelled = False
        self._cb_warned = False
        self._done = threading.Event()

    @property
    def finished(self) -> bool:
        return self.state == RequestState.DONE

    @property
    def terminal(self) -> bool:
        return self.state in RequestState.TERMINAL

    @property
    def cancelled(self) -> bool:
        return self._cancelled

    def cancel(self) -> bool:
        """Request cancellation, honoured at the engine's next step
        boundary (the slot is retired and its pages returned); safe from
        any thread.  False when the request is already terminal."""
        if self.terminal:
            return False
        self._cancelled = True
        return True

    def wait(self, timeout: Optional[float] = None,
             raise_on_failure: bool = False) -> bool:
        """Block until the request reaches a TERMINAL state.  True when
        terminal, False when the WAIT timed out.  With
        ``raise_on_failure`` a non-DONE terminal re-raises its error."""
        reached = self._done.wait(timeout)
        if raise_on_failure and reached and self.state != RequestState.DONE:
            raise self.error or ServingError(
                f"request {self.id} ended {self.state}")
        return reached

    def output_ids(self) -> np.ndarray:
        """prompt + generated ids (the ``generate()`` convention)."""
        return np.concatenate([self.prompt,
                               np.asarray(self.tokens, np.int64)])

    def timestamps(self) -> dict:
        """The per-request SLO timestamps (monotonic seconds; None means
        the request never reached that stage)."""
        return {"submitted": self.t_submitted, "admitted": self.t_admitted,
                "first_token": self.t_first_token,
                "terminal": self.t_terminal}


class RequestQueue:
    """Thread-safe FIFO; ``submit`` may be called from any thread.
    ``max_depth`` bounds it: an over-limit ``submit`` raises the typed
    ``Overloaded`` error at once."""

    def __init__(self, max_depth: Optional[int] = None):
        self._q: deque = deque()
        self._lock = threading.Lock()
        self.max_depth = None if max_depth is None else int(max_depth)

    def submit(self, request: Request) -> Request:
        with self._lock:
            if self.max_depth is not None and len(self._q) >= self.max_depth:
                raise Overloaded(
                    f"queue full ({len(self._q)}/{self.max_depth}): "
                    "request shed — back off and retry")
            self._q.append(request)
        return request

    def pop(self) -> Optional[Request]:
        with self._lock:
            return self._q.popleft() if self._q else None

    def push_front(self, request: Request):
        with self._lock:
            self._q.appendleft(request)

    def remove_where(self, pred: Callable[[Request], bool]) -> List[Request]:
        """Remove and return every queued request matching ``pred``
        (FIFO order of the survivors is kept)."""
        with self._lock:
            kept, dropped = deque(), []
            for r in self._q:
                (dropped if pred(r) else kept).append(r)
            self._q = kept
            return dropped

    @property
    def depth(self) -> int:
        with self._lock:
            return len(self._q)


# registry label for each engine's counters/histograms
_ENGINE_SEQ = itertools.count()


def ragged_padding_waste(n_tokens: int, n_blocks: int, n_items: int,
                         token_block: int, page_size: int, head_dim: int,
                         itemsize: int = 2) -> dict:
    """The ragged fused step's host-packed padding cost (copied from
    ``paddle_tpu/analysis/cost_model.py``): block rows that carried no real
    token, the multiply-add work a full-block launch would spend on them
    (``4 * head_dim * page_size`` flops per row and item) and their q-row
    bytes.  The port's kernel skips padding rows, so ``wasted_flops`` is
    the work the plan's layout implies, not work the card does."""
    padded_rows = n_blocks * int(token_block) - int(n_tokens)
    if padded_rows < 0:
        raise ValueError(f"n_tokens={n_tokens} exceeds "
                         f"{n_blocks} x {token_block} block rows")
    rows_frac = padded_rows / max(n_blocks * int(token_block), 1)
    item_flops = 4 * int(head_dim) * int(page_size) * int(token_block)
    return {
        "padded_rows": padded_rows,
        "wasted_flops": int(round(n_items * item_flops * rows_frac)),
        "wasted_q_bytes": padded_rows * int(head_dim) * int(itemsize),
    }


def _sample_per_slot(rows: torch.Tensor, temperature: torch.Tensor,
                     top_p: torch.Tensor, top_k: torch.Tensor,
                     do_sample: torch.Tensor,
                     generator: torch.Generator) -> torch.Tensor:
    """Next-token selection over fp32 [S, V] logits with PER-SLOT params
    -> int64 [S].  Greedy rows take the raw argmax; sampling rows apply
    temperature, then top-k (k-th sorted value as threshold; k <= 0 =
    off) and top-p (smallest probability-sorted prefix reaching mass p;
    1.0 = off), then draw by Gumbel-argmax with noise from
    ``generator``."""
    greedy = rows.argmax(-1)
    v = rows.shape[-1]
    scaled = rows / temperature.clamp(min=1e-6)[:, None]
    srt = torch.sort(scaled, dim=-1, descending=True).values
    kk = torch.where(top_k > 0, top_k, torch.full_like(top_k, v))
    kk = kk.clamp(1, v).long()
    kth = torch.gather(srt, 1, (kk - 1)[:, None])
    probs = torch.softmax(srt, dim=-1)
    prev_mass = torch.cumsum(probs, dim=-1) - probs
    keep = prev_mass < top_p[:, None]
    pth = torch.where(keep, srt, torch.full_like(srt, float("inf"))
                      ).min(dim=-1, keepdim=True).values
    filt = torch.where(scaled < torch.maximum(kth, pth),
                       torch.full_like(scaled, _NEG), scaled)
    u = torch.rand(filt.shape, generator=generator, device=filt.device)
    gumbel = -torch.log(-torch.log(u.clamp(min=torch.finfo(u.dtype).tiny)))
    sampled = (filt + gumbel).argmax(-1)
    return torch.where(do_sample, sampled, greedy)


class ServingEngine:
    """Continuous-batching front end over a model exposing the paged-cache
    contract (``new_paged_kv_cache`` + ``_paged_lm_logits``).  The engine
    follows the model's device.

    ``num_pages`` defaults to full capacity (every slot can hold
    ``max_context`` tokens, plus the null page); size it DOWN to
    oversubscribe device memory -- admission then backpressures on pool
    occupancy, not just on free slots.  ``max_queue_depth`` /
    ``max_queue_wait_s`` bound the queue (typed ``Overloaded``);
    ``seed`` seeds the engine's sampling generator.  ``kv_dtype`` names
    the pool dtype and wins over ``cache_dtype``; "int8" makes a quantized
    pool.  ``weight_dtype="int8"`` quantizes ``model`` in place for
    serving (any other value raises ``ValueError``).  ``prefill_chunk``
    is the reference's alias of ``prefill_token_budget``, which wins when
    both are given."""

    def __init__(self, model, *, num_slots: int = 4,
                 page_size: int = 128, max_context: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 cache_dtype: str = "bfloat16",
                 prefill_token_budget: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 max_queue_depth: Optional[int] = None,
                 max_queue_wait_s: Optional[float] = None,
                 seed: int = 0,
                 stall_budget_s: Optional[float] = None,
                 compile_budget_s: Optional[float] = None,
                 readmission_backoff_s: Optional[float] = None,
                 backoff_max_s: Optional[float] = None,
                 mesh=None, lora=None, prefix_cache: bool = False,
                 kv_dtype: Optional[str] = None,
                 weight_dtype: Optional[str] = None,
                 role: Optional[str] = None):
        # knobs of the JAX engine that wait for later slices, each with
        # the ROADMAP.md queue-1 item that brings it
        for knob, asked, item in (
                ("prefix_cache", bool(prefix_cache), "6, prefix cache"),
                ("stall_budget_s", stall_budget_s is not None,
                 "7, watchdog and retry/rebuild"),
                ("compile_budget_s", compile_budget_s is not None,
                 "7, watchdog and retry/rebuild"),
                ("readmission_backoff_s", readmission_backoff_s is not None,
                 "7, watchdog and retry/rebuild"),
                ("backoff_max_s", backoff_max_s is not None,
                 "7, watchdog and retry/rebuild"),
                ("lora", lora is not None, "8, speculative decoding and LoRA"),
                ("mesh", mesh is not None,
                 "9, sharded, elastic and disaggregated serving"),
                ("role", role is not None,
                 "9, sharded, elastic and disaggregated serving")):
            if asked:
                raise NotImplementedError(
                    f"ServingEngine({knob}) is not ported yet: ROADMAP.md "
                    f"queue 1, item {item}")
        if kv_dtype is not None:
            cache_dtype = kv_dtype
        if weight_dtype is not None:
            if str(weight_dtype) != "int8":
                raise ValueError(
                    f"weight_dtype={weight_dtype!r}: only 'int8' (or None "
                    "for the model's own weights) is supported")
            quantize_for_serving(model)
        cfg = model.config
        max_context = int(max_context or cfg.max_position_embeddings)
        if max_context > cfg.max_position_embeddings:
            raise ValueError(
                f"max_context={max_context} exceeds max_position_embeddings="
                f"{cfg.max_position_embeddings}")
        if max_context % page_size:
            raise ValueError(
                f"max_context={max_context} must be a multiple of "
                f"page_size={page_size}")
        # prefill_chunk: the reference's alias, read only when
        # prefill_token_budget is not given
        if prefill_token_budget is None:
            prefill_token_budget = prefill_chunk
        prefill_token_budget = int(prefill_token_budget
                                   or min(page_size, max_context))
        if prefill_token_budget < 1:
            raise ValueError(
                f"prefill_token_budget={prefill_token_budget} must be >= 1")
        max_pages_per_slot = max_context // page_size
        if num_pages is None:
            num_pages = num_slots * max_pages_per_slot + 1  # + null page
        self.model = model
        self.device = model.device
        self.num_slots = int(num_slots)
        self.page_size = int(page_size)
        self.max_context = max_context
        self.prefill_token_budget = prefill_token_budget
        self.cache_dtype = dtype_name(cache_dtype)
        self.num_pages = int(num_pages)
        self.cache = model.new_paged_kv_cache(self.num_pages, self.page_size,
                                              dtype=self.cache_dtype)
        self.allocator = BlockAllocator(self.num_pages)
        self.scheduler = AdmissionScheduler(num_slots, max_pages_per_slot,
                                            page_size, self.allocator)
        self.queue = RequestQueue(max_depth=max_queue_depth)
        self.max_queue_wait_s = (None if max_queue_wait_s is None
                                 else float(max_queue_wait_s))
        self._lock = threading.RLock()
        self._closed = False
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(int(seed))

        # fixed fused-step geometry.  A slot contributes ONE run per step
        # -- a decode token (one block) or a prefill run of c tokens
        # (1 + (c-1)//qb blocks); with P prefill runs sharing the budget,
        # total blocks <= num_slots + budget//qb.
        self.head_dim = int(cfg.head_dim)
        self.token_block = TOKEN_BLOCK
        self._t_max = self.num_slots + self.prefill_token_budget
        self._nb_max = (self.num_slots
                        + self.prefill_token_budget // self.token_block)
        self._wl_max = self._nb_max * max_pages_per_slot

        # host mirrors of the per-slot state
        self._tokens = np.zeros((num_slots,), np.int64)
        self._temp = np.ones((num_slots,), np.float32)
        self._top_p = np.ones((num_slots,), np.float32)
        self._top_k = np.zeros((num_slots,), np.int32)
        self._do_sample = np.zeros((num_slots,), bool)
        # every int32 step input in ONE packed vector (one host->device
        # copy per step); the step slices it back apart by fixed offsets
        self._pack_layout = [
            ("ids", (self._t_max,)),
            ("tables", (self._t_max, max_pages_per_slot)),
            ("positions", (self._t_max,)),
            ("out_rows", (self.num_slots,)),
            ("blk_tok", (self._nb_max, self.token_block)),
            ("tok_blk", (self._t_max,)),
            ("tok_row", (self._t_max,)),
            ("blk_base", (self._nb_max,)),
            ("blk_rows", (self._nb_max,)),
            ("wl_blk", (self._wl_max,)),
            ("wl_page", (self._wl_max,)),
            ("wl_pageslot", (self._wl_max,)),
            ("n_items", (1,)),
        ]
        self._pack_slices = {}
        off = 0
        for name, shp in self._pack_layout:
            n = int(np.prod(shp))
            self._pack_slices[name] = (off, off + n, shp)
            off += n
        self._pack_total = off
        # the sampling vectors change only at admission/retirement: their
        # device copies are cached and re-uploaded when a mirror changes
        self._sampling_cache = None

        # cumulative totals on the process-wide telemetry registry: each
        # key is the ``serving_<key>`` counter labeled with this engine
        self._engine_label = {"engine": str(next(_ENGINE_SEQ))}
        self._totals = _tmetrics.CounterSet(
            "serving", {"steps": 0, "tokens": 0, "admitted": 0,
                        "completed": 0,
                        # fused-step accounting: dispatched steps, prefill
                        # tokens that piggybacked, and the ragged
                        # occupancy numerators/denominators (metrics())
                        "fused_steps": 0, "prefill_tokens": 0,
                        "work_items": 0, "work_capacity": 0,
                        "block_rows": 0, "block_row_capacity": 0,
                        "padded_rows": 0, "padded_flops": 0,
                        "failed": 0, "cancelled": 0, "timed_out": 0,
                        "shed": 0, "quarantined": 0},
            labels=self._engine_label)
        # per-request SLO histograms (seconds, log-bucketed): TTFT and e2e
        # are measured FROM SUBMISSION (queue time included), queue_wait
        # is submission->seating, ITL the gap between consecutive tokens
        reg = _tmetrics.registry()
        self._slo = {
            "ttft": reg.histogram(
                "serving_ttft_seconds",
                "submission -> first generated token (queue included)"),
            "itl": reg.histogram(
                "serving_itl_seconds",
                "inter-token latency between consecutive emitted tokens"),
            "queue_wait": reg.histogram(
                "serving_queue_wait_seconds",
                "submission -> seated in a decode slot"),
            "e2e": reg.histogram(
                "serving_e2e_seconds",
                "submission -> terminal state (all terminals)"),
        }
        self._slo = {k: h.labels(**self._engine_label)
                     for k, h in self._slo.items()}
        self._step_emitted = 0
        self._last_metrics: dict = {}
        self._last_occupancy = (0.0, 0.0)   # (grid, q-row) of the last step

    # -- submission --------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 32, *,
               sampling: Optional[SamplingParams] = None,
               eos_token_id: Optional[int] = None,
               on_token: Optional[Callable] = None,
               deadline_s: Optional[float] = None) -> Request:
        """Queue a request; returns immediately.  Validation happens here
        so the step loop never meets an unseatable request.  A full
        bounded queue raises the typed ``Overloaded`` error (load shed);
        ``deadline_s`` bounds the request's total lifetime."""
        self._check_open()
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must hold at least one token")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        total = prompt.size + int(max_new_tokens)
        if total > self.max_context:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds max_context {self.max_context}")
        if self.scheduler.pages_needed(total) > self.allocator.capacity:
            raise ValueError(
                f"request needs {self.scheduler.pages_needed(total)} pages "
                f"but the pool holds only {self.allocator.capacity}")
        req = Request(prompt, max_new_tokens, sampling=sampling,
                      eos_token_id=eos_token_id, on_token=on_token,
                      deadline_s=deadline_s)
        now = time.monotonic()
        req.submit_t = now
        req.t_submitted = now
        if req.deadline_s is not None:
            req.deadline = now + req.deadline_s
        try:
            return self.queue.submit(req)
        except Overloaded:
            # submit() runs on any client thread, outside the step lock
            self._totals.inc("shed")
            raise

    # -- the serving loop --------------------------------------------------
    def step(self) -> dict:
        """One scheduler tick: reap cancelled/expired requests, admit what
        fits (admission only reserves pages and seats), run ONE fused
        mixed prefill/decode step over every seated slot's work, retire
        finished requests (their pages free at once).  Returns this
        step's metrics."""
        with self._lock, _ttrace.span("serve.step"):
            self._check_open()
            t0 = time.perf_counter()
            self._step_emitted = 0
            with _ttrace.span("serve.plan"):
                now = time.monotonic()
                self._reap(now)
                self._admit(now)
                work = self.scheduler.plan_step(self.prefill_token_budget)
            if work:
                with _ttrace.span("serve.pack"):
                    packed, stats = self._build_step_inputs(work)
                with _ttrace.span("serve.dispatch"):
                    toks, fin = self._run_fused(packed)
                self._totals["fused_steps"] += 1
                with _ttrace.span("serve.harvest"):
                    self._harvest_fused(work, stats, toks, fin)
            with _ttrace.span("serve.commit"):
                return self._commit_step_metrics(t0)

    def _commit_step_metrics(self, t0: float) -> dict:
        dt = time.perf_counter() - t0
        emitted = self._step_emitted
        self._totals["steps"] += 1
        self._totals["tokens"] += emitted
        grid_occ, row_occ = self._last_occupancy
        sched = self.scheduler
        self._last_metrics = {
            "active_slots": sched.active_slots,
            "queue_depth": self.queue.depth,
            "pages_used": self.allocator.used_pages,
            "pages_capacity": self.allocator.capacity,
            "occupancy": sched.occupancy,
            "tokens_this_step": emitted,
            "tokens_per_sec": emitted / dt if dt > 0 else 0.0,
            "step_seconds": dt,
            # ragged-launch occupancy of the last dispatched step: real
            # work items / work-list length, real rows / packed block rows
            "grid_occupancy": grid_occ,
            "q_row_occupancy": row_occ,
            "failed": self._totals["failed"],
            "cancelled": self._totals["cancelled"],
            "timed_out": self._totals["timed_out"],
            "shed": self._totals["shed"],
        }
        return dict(self._last_metrics)

    def _build_step_inputs(self, work) -> Tuple[np.ndarray, dict]:
        """Flatten one tick's plan into the packed int32 step input: the
        flat token list (decode tokens from the last-sampled mirrors,
        prefill tokens from each slot's pending prompt), per-token
        positions and page-table rows, each slot's output row, and the
        ragged plan arrays.  Padding tokens carry id 0, position 0 and the
        null-page table row."""
        sched = self.scheduler
        packed = np.zeros((self._pack_total,), np.int32)

        def view(name):
            a, b, shp = self._pack_slices[name]
            return packed[a:b].reshape(shp)

        ids = view("ids")
        tables = view("tables")
        positions = view("positions")
        out_rows = view("out_rows")
        runs = []
        t = 0
        for w in work:
            slot = sched.slots[w.slot]
            if w.kind == "prefill":
                ids[t:t + w.count] = slot.pending[:w.count]
            else:
                ids[t] = self._tokens[w.slot]
            row = sched.tables[w.slot]
            tables[t:t + w.count] = row
            positions[t:t + w.count] = w.base + np.arange(w.count,
                                                          dtype=np.int32)
            if w.has_output:
                out_rows[w.slot] = t + w.count - 1
            runs.append((w.base, w.count, row))
            t += w.count
        plan, stats = build_ragged_plan(
            runs, token_block=self.token_block, page_size=self.page_size,
            t_max=self._t_max, nb_max=self._nb_max, wl_max=self._wl_max)
        for k in RAGGED_PLAN_FIELDS:
            view(k)[...] = plan[k]
        return packed, stats

    def _sampling_tensors(self):
        if self._sampling_cache is None:
            dev = self.device
            self._sampling_cache = (
                torch.from_numpy(self._temp.copy()).to(dev),
                torch.from_numpy(self._top_p.copy()).to(dev),
                torch.from_numpy(self._top_k.copy()).to(dev),
                torch.from_numpy(self._do_sample.copy()).to(dev))
        return self._sampling_cache

    def _run_fused(self, packed: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """The fused step on the device: one packed input copy in, the
        model's fused step, argmax or per-slot sampling, the finiteness
        sentry, one copy of (tokens, flags) out."""
        with torch.no_grad(), _ttrace.span("serve.device_step"):
            dev = torch.from_numpy(packed).to(self.device)
            f = {name: dev[a:b].view(shp)
                 for name, (a, b, shp) in self._pack_slices.items()}
            plan = tuple(f[k] for k in RAGGED_PLAN_FIELDS)
            logits = self.model._paged_lm_logits(
                f["ids"][:, None], self.cache, f["tables"], f["positions"],
                ragged_plan=plan, out_rows=f["out_rows"])
            rows = logits[:, -1, :].float()
            # per-slot finiteness flags ride the same transfer as the
            # tokens: the sentry costs no extra host sync
            fin = torch.isfinite(rows).all(dim=-1)
            if self._do_sample.any():
                tok = _sample_per_slot(rows, *self._sampling_tensors(),
                                       generator=self._generator)
            else:
                tok = rows.argmax(dim=-1)
            out = torch.stack([tok, fin.long()]).cpu().numpy()
        return out[0], out[1].astype(bool)

    def _harvest_fused(self, work, stats, toks_np: np.ndarray,
                       fin_np: np.ndarray):
        """Fold one fused step's results back into the request states:
        consume prefill runs, quarantine NaN-poisoned output slots,
        advance/emit the rest.  Mirrors and pending prompts only move
        here."""
        sched = self.scheduler
        self._fold_plan_stats(work, stats)
        for w in work:
            slot = sched.slots[w.slot]
            if slot is None:
                continue
            if w.kind == "prefill":
                slot.pending = slot.pending[w.count:]
            if w.has_output and not fin_np[w.slot]:
                # finiteness sentry: quarantine the poisoned slot instead
                # of streaming garbage; every other slot proceeds
                self._totals["quarantined"] += 1
                self._retire_slot(w.slot, RequestState.FAILED, NaNLogitsError(
                    f"request {slot.request.id}: non-finite logits at "
                    f"position {slot.pos + w.count - 1} "
                    f"(slot {w.slot} quarantined)"))
                continue
            # the step wrote this run's K/V at positions base..base+count-1
            sched.advance(w.slot, w.count)
            if not w.has_output:
                continue                 # mid-prefill: nothing sampled yet
            req = slot.request
            tok = int(toks_np[w.slot])
            if w.kind == "prefill":
                req.state = RequestState.DECODE
            self._tokens[w.slot] = tok
            self._emit(req, tok)
            if self._is_finished(req, tok):
                self._finish(w.slot)

    def _fold_plan_stats(self, work, stats):
        self._totals["prefill_tokens"] += sum(
            w.count for w in work if w.kind == "prefill")
        self._totals["work_items"] += stats["n_items"]
        self._totals["work_capacity"] += stats["wl_capacity"]
        self._totals["block_rows"] += stats["n_tokens"]
        self._totals["block_row_capacity"] += stats["row_capacity"]
        waste = ragged_padding_waste(
            stats["n_tokens"], stats["n_blocks"], stats["n_items"],
            self.token_block, self.page_size, self.head_dim,
            itemsize=to_torch_dtype(self.cache_dtype, storage=True).itemsize)
        self._totals["padded_rows"] += waste["padded_rows"]
        self._totals["padded_flops"] += waste["wasted_flops"]
        self._last_occupancy = (
            stats["n_items"] / stats["wl_capacity"],
            stats["n_tokens"] / max(stats["row_capacity"], 1))

    def run_until_idle(self, max_steps: Optional[int] = None) -> dict:
        """Step until queue and slots drain; returns cumulative metrics."""
        steps = 0
        while self.queue.depth or self.scheduler.active_slots:
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return self.metrics()

    def generate_batch(self, prompts, max_new_tokens: int = 32, *,
                       raise_on_failure: bool = True,
                       **kwargs) -> List[np.ndarray]:
        """Submit every prompt, drain, return each request's
        prompt+generated ids in submission order.  A request that ends in
        a non-DONE terminal state raises, unless ``raise_on_failure`` is
        False."""
        reqs = [self.submit(p, max_new_tokens, **kwargs) for p in prompts]
        self.run_until_idle()
        bad = [r for r in reqs if r.state != RequestState.DONE]
        if bad and raise_on_failure:
            detail = ", ".join(f"request {r.id}: {r.state}" for r in bad)
            raise ServingError(
                f"generate_batch: {len(bad)}/{len(reqs)} request(s) did "
                f"not complete ({detail})") from bad[0].error
        return [r.output_ids() for r in reqs]

    # -- reaping: deadlines, cancellation, queue-wait shedding -------------
    def _reap(self, now: float):
        """Step-boundary retirement of cancelled/expired requests, queued
        and seated.  Pages return to the pool before admission runs, so
        freed capacity is reusable in the same step."""
        max_wait = self.max_queue_wait_s

        def expired(r: Request) -> bool:
            return (r.cancelled
                    or (r.deadline is not None and now >= r.deadline)
                    or (max_wait is not None and r.submit_t is not None
                        and now - r.submit_t >= max_wait))

        for r in self.queue.remove_where(expired):
            if r.cancelled:
                self._terminalize(r, RequestState.CANCELLED,
                                  RequestCancelled(f"request {r.id} "
                                                   "cancelled while queued"))
            elif r.deadline is not None and now >= r.deadline:
                self._terminalize(r, RequestState.TIMED_OUT,
                                  DeadlineExceeded(
                                      f"request {r.id}: deadline_s="
                                      f"{r.deadline_s} passed while queued"))
            else:
                # atomic inc: submit() also counts "shed", outside the lock
                self._totals.inc("shed")
                self._terminalize(r, RequestState.TIMED_OUT, Overloaded(
                    f"request {r.id}: queued longer than "
                    f"max_queue_wait_s={max_wait}"))
        for i, slot in self.scheduler.seated():
            r = slot.request
            if r.cancelled:
                self._retire_slot(i, RequestState.CANCELLED,
                                  RequestCancelled(
                                      f"request {r.id} cancelled"))
            elif r.deadline is not None and now >= r.deadline:
                self._retire_slot(i, RequestState.TIMED_OUT,
                                  DeadlineExceeded(
                                      f"request {r.id}: deadline_s="
                                      f"{r.deadline_s} passed mid-decode"))

    # -- admission ---------------------------------------------------------
    def _admit(self, now: float):
        """Seat queued requests while slots AND pages allow: pages are
        reserved all-or-nothing and the prompt is parked on
        ``Slot.pending``; the same tick's fused step starts consuming it
        under the token budget."""
        sched = self.scheduler
        while sched.free_slot_indices():
            req = self.queue.pop()
            if req is None:
                return
            total = req.prompt.size + req.max_new_tokens
            idx = sched.try_admit(req, total)
            if idx is None:
                # pool backpressure: requeue and stop admitting (FIFO --
                # later smaller requests must not starve this one)
                self.queue.push_front(req)
                return
            self._totals["admitted"] += 1
            req.t_admitted = now
            if req.t_submitted is not None:
                self._slo["queue_wait"].observe(now - req.t_submitted)
            sp = req.sampling
            self._temp[idx] = np.float32(sp.temperature)
            self._top_p[idx] = np.float32(sp.top_p)
            self._top_k[idx] = np.int32(sp.top_k)
            self._do_sample[idx] = bool(sp.do_sample)
            self._sampling_cache = None
            sched.slots[idx].pending = np.asarray(req.prompt, np.int64)
            req.state = RequestState.PREFILL

    # -- terminal transitions ----------------------------------------------
    def _clear_slot_mirrors(self, idx: int):
        self._tokens[idx] = 0
        self._temp[idx] = 1.0
        self._top_p[idx] = 1.0
        self._top_k[idx] = 0
        self._do_sample[idx] = False
        self._sampling_cache = None

    def _terminalize(self, req: Request, state: str,
                     error: Optional[BaseException]):
        """Finish a request in a non-DONE terminal state."""
        req.error = error
        req.state = state
        self._observe_terminal(req)
        if state == RequestState.CANCELLED:
            self._totals["cancelled"] += 1
        elif state == RequestState.TIMED_OUT:
            self._totals["timed_out"] += 1
        elif state == RequestState.FAILED:
            self._totals["failed"] += 1
        req._done.set()

    def _observe_terminal(self, req: Request):
        now = time.monotonic()
        req.t_terminal = now
        if req.t_submitted is not None:
            self._slo["e2e"].observe(now - req.t_submitted)

    def _retire_slot(self, idx: int, state: str,
                     error: Optional[BaseException]):
        """Retire a SEATED request into a non-DONE terminal state; its
        pages return to the pool at once."""
        req = self.scheduler.slots[idx].request
        self.scheduler.retire(idx)
        self._clear_slot_mirrors(idx)
        self._terminalize(req, state, error)

    def _emit(self, req: Request, tok: int):
        req.tokens.append(tok)
        self._step_emitted += 1
        now = time.monotonic()
        if req.t_first_token is None:
            req.t_first_token = now
            if req.t_submitted is not None:
                self._slo["ttft"].observe(now - req.t_submitted)
        elif req._t_last_token is not None:
            self._slo["itl"].observe(now - req._t_last_token)
        req._t_last_token = now
        if req.on_token is not None:
            try:
                req.on_token(req, tok)
            except Exception as e:  # noqa: BLE001 — must not kill serving
                # record the FIRST callback error on the request and warn
                # once per request -- never silently swallowed
                if req.callback_error is None:
                    req.callback_error = e
                if not req._cb_warned:
                    req._cb_warned = True
                    warnings.warn(
                        f"on_token callback for request {req.id} raised "
                        f"{type(e).__name__}: {e} (recorded on "
                        "request.callback_error; further errors for this "
                        "request are suppressed)", RuntimeWarning,
                        stacklevel=2)

    @staticmethod
    def _is_finished(req: Request, tok: int) -> bool:
        if len(req.tokens) >= req.max_new_tokens:
            return True
        return req.eos_token_id is not None and tok == req.eos_token_id

    def _finish(self, idx: int):
        req = self.scheduler.slots[idx].request
        self.scheduler.retire(idx)         # pages free immediately
        self._clear_slot_mirrors(idx)
        self._totals["completed"] += 1
        req.state = RequestState.DONE
        self._observe_terminal(req)
        req._done.set()

    def _check_open(self):
        if self._closed:
            raise RuntimeError("ServingEngine is closed (cache released)")

    # -- observability -----------------------------------------------------
    def metrics(self) -> dict:
        """Cumulative totals + the last step's gauges, the ragged-launch
        occupancy means, and the per-request SLO digests (seconds)."""
        out = dict(self._totals)
        out.update(self._last_metrics)
        out["queue_depth"] = self.queue.depth
        out["active_slots"] = self.scheduler.active_slots
        out["pages_used"] = self.allocator.used_pages
        out["pages_capacity"] = self.allocator.capacity
        out["occupancy"] = self.scheduler.occupancy
        out["cache_bytes"] = self.cache.nbytes
        wc = self._totals["work_capacity"]
        rc = self._totals["block_row_capacity"]
        out["mean_grid_occupancy"] = (self._totals["work_items"] / wc
                                      if wc else 0.0)
        out["mean_q_row_occupancy"] = (self._totals["block_rows"] / rc
                                       if rc else 0.0)
        out["slo"] = {k: h.summary() for k, h in self._slo.items()}
        return out

    def close(self):
        """Release the page pool's device memory.  Pending/active requests
        are NOT drained -- call ``run_until_idle`` first if they matter.
        Serialises on the step lock, so an in-flight step finishes first
        and later steps fail the open check."""
        with self._lock:
            if not self._closed:
                self._closed = True
                self.cache.release()
                # drop this engine's children from the process registry
                _tmetrics.registry().drop_labels(**self._engine_label)
