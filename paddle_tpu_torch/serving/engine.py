"""ServingEngine: continuous batching over the paged KV cache with ONE
fused mixed prefill/decode step per tick (port of
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

All int32 step inputs -- token ids, tables, positions, output rows, the
nine plan arrays, and the per-token adapter pages of a LoRA engine --
travel as ONE packed vector: one host-to-device copy per step.  The step
returns the sampled tokens and the per-slot finiteness flags in one
device-to-host copy.  PyTorch runs the step eagerly: there is no compiled
program to count.

The step has a greedy variant (argmax) and a sampling variant (per-slot
temperature, top-k and top-p, then Gumbel-argmax drawn from the engine's
own ``torch.Generator``; greedy rows inside a mixed batch stay exact).

Request lifecycle: SUBMITTED (queued; admission backpressures on free
slots AND free pages) -> PREFILL -> DECODE -> one terminal state:
``DONE`` (max_new_tokens or eos), ``CANCELLED`` (``Request.cancel()``,
honoured at the next step boundary), ``TIMED_OUT`` (``deadline_s``
passed, or the request overstayed ``max_queue_wait_s``), ``FAILED`` (the
request was implicated in a crashed, stalled or NaN step; the typed error
rides on ``Request.error``).  Page accounting stays exact through every
one of them: ``free + used + spec + shared == capacity``.

Fault containment (the reference's "Failure model"):

- **watchdog** -- with ``stall_budget_s`` set, the step's device work
  (upload, model, sampling, and the copy of the tokens back to the host)
  runs on a supervised worker thread.  A step that overruns its budget is
  abandoned; the seated requests end FAILED (``StepStalledError``) and the
  engine rebuilds its pool and keeps serving.  A CUDA launch cannot be
  cancelled, so the abandoned worker (the zombie) runs on: it keeps the
  old pool alive until it returns, then releases it, and the rebuilt pool
  is never touched by it.  The first dispatch of each step variant gets
  ``compile_budget_s`` instead: the kernels build with nvcc at first use.
- **retry + backoff** -- a step exception is retried once (the step's
  inputs are a pure function of the host mirrors, which move only on
  success); a second failure recovers the engine, and re-admission backs
  off exponentially (``readmission_backoff_s`` doubling up to
  ``backoff_max_s``, reset by a clean step).
- **not contained** -- a kernel refusing its inputs (``ValueError``: the
  same inputs fail the same way after any rebuild), a kernel that cannot
  be built, loaded or launched (``KernelError``: a failed nvcc build, or a
  launch refused for its configuration, its resources or a missing kernel
  image, fails again on every retry) and a CUDA error that
  leaves the context unusable (an illegal address, a launch failure, a
  misaligned address, an illegal instruction, a device-side assert, a
  hardware stack error, an invalid program counter, an uncorrectable ECC
  error, a launch timeout: every later call on the device fails) propagate
  out of ``step()``.
- **finiteness sentry** -- per-slot finiteness flags ride the token copy;
  a NaN-poisoned slot is quarantined (FAILED, ``NaNLogitsError``).

The prefix cache (``prefix_cache=True``, ``serving/prefix_cache.py``)
splices the longest cached run of full pages into an admission's page
table (reader references taken at admission, dropped at retirement) and
registers every slot's completed full pages at harvest; a rebuild flushes
it.  LoRA (``lora=LoRAAdapterPool``, ``submit(adapter=)``) pins the
tenant's adapter page for the seated life of the request; the prefix
cache bypasses LoRA requests (their K/V depend on the adapter).

Quantized serving: ``kv_dtype="int8"`` (or ``cache_dtype="int8"``) keeps
the pool as int8 pages with per-(page, head) fp32 scales, quantized as the
fused step writes them and dequantized inside the ragged kernel;
``weight_dtype="int8"`` quantizes the model's projections and LM head in
place (``quantization.quantize_for_serving``) before the first step.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP.md
item): mesh-sharded and disaggregated replicas (``mesh=``, ``role=``).
"""
from __future__ import annotations

import itertools
import queue as _queue
import threading
import time
import warnings
from collections import deque
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..core import dtype_name, to_torch_dtype
from ..ops.kernels._build import KernelError
from ..ops.kernels.ragged_paged_attention import (
    RAGGED_PLAN_FIELDS, TOKEN_BLOCK, build_ragged_plan,
)
from ..quantization.int8 import quantize_for_serving
from ..telemetry import metrics as _tmetrics
from ..telemetry import trace as _ttrace
from .admission import AdmissionScheduler
from .paged_cache import BlockAllocator
from .prefix_cache import PrefixCache

__all__ = [
    "RequestState", "SamplingParams", "Request", "RequestQueue",
    "ServingEngine", "ServingError", "Overloaded", "DeadlineExceeded",
    "RequestCancelled", "StepStalledError", "NaNLogitsError",
    "ragged_padding_waste",
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


class StepStalledError(ServingError):
    """A supervised step exceeded the watchdog's stall budget."""


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
        self.adapter: Optional[str] = None   # LoRA tenant (serving/lora.py)
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


def _filter_logits(scaled: torch.Tensor, top_p: torch.Tensor,
                   top_k: torch.Tensor) -> torch.Tensor:
    """Temperature-scaled fp32 logits ``[..., V]`` with the per-slot
    ``top_k``/``top_p`` ``[S]`` filters (the leading axis is the slot)
    applied: top-k keeps values at or above the k-th sorted one (k <= 0 =
    off), top-p the smallest probability-sorted prefix reaching mass p
    (1.0 = off); the rest become ``_NEG``."""
    v = scaled.shape[-1]
    extra = (1,) * (scaled.dim() - 1)
    srt = torch.sort(scaled, dim=-1, descending=True).values
    kk = torch.where(top_k > 0, top_k, torch.full_like(top_k, v))
    kk = (kk.clamp(1, v).long() - 1).view(-1, *extra)
    kth = torch.gather(srt, -1, kk.expand(*srt.shape[:-1], 1))
    probs = torch.softmax(srt, dim=-1)
    prev_mass = torch.cumsum(probs, dim=-1) - probs
    keep = prev_mass < top_p.view(-1, *extra)
    pth = torch.where(keep, srt, torch.full_like(srt, float("inf"))
                      ).min(dim=-1, keepdim=True).values
    return torch.where(scaled < torch.maximum(kth, pth),
                       torch.full_like(scaled, _NEG), scaled)


def _gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp(min=torch.finfo(u.dtype).tiny)))


def _sample_per_slot(rows: torch.Tensor, temperature: torch.Tensor,
                     top_p: torch.Tensor, top_k: torch.Tensor,
                     do_sample: torch.Tensor,
                     generator: torch.Generator) -> torch.Tensor:
    """Next-token selection over fp32 [S, V] logits with PER-SLOT params
    -> int64 [S].  Greedy rows take the raw argmax; sampling rows apply
    temperature, then top-k and top-p (:func:`_filter_logits`), then draw
    by Gumbel-argmax with noise from ``generator``."""
    greedy = rows.argmax(-1)
    filt = _filter_logits(rows / temperature.clamp(min=1e-6)[:, None],
                          top_p, top_k)
    sampled = (filt + _gumbel(filt.shape, generator, filt.device)).argmax(-1)
    return torch.where(do_sample, sampled, greedy)


class _StepBox:
    """One supervised unit of work (see ``_StepWorker``)."""

    __slots__ = ("fn", "result", "error", "done", "abandoned", "cleanup",
                 "lock")

    def __init__(self, fn):
        self.fn = fn
        self.result = None
        self.error: Optional[BaseException] = None
        self.done = threading.Event()
        self.abandoned = False
        self.cleanup: Optional[Callable[[], None]] = None
        self.lock = threading.Lock()


class _StepWorker:
    """Watchdog executor: runs step thunks on one daemon thread so the
    caller can bound how long it waits.  A thunk that overruns the stall
    budget is ABANDONED -- a wedged CUDA launch cannot be cancelled, so
    the thread is left to finish (or never finish) on its own, the worker
    is marked dead (the engine spawns a fresh one), and the abandoned
    box's ``cleanup`` releases the orphaned device state once the zombie
    does return.  Thunks receive a ``cancelled()`` callable and must skip
    device work once it reports True (fault-injected stalls exercise
    exactly this path).

    The worker launches on its thread's current stream, which for one
    device is the same default stream the engine's thread uses, so the
    zombie's launches and the rebuilt engine's stay in stream order and
    share the kernels' per-(device, stream) workspaces safely."""

    def __init__(self, name: str):
        self._q: _queue.Queue = _queue.Queue()
        self.dead = False
        self._t = threading.Thread(target=self._loop, daemon=True, name=name)
        self._t.start()

    def _loop(self):
        while True:
            box = self._q.get()
            if box is None:
                return
            try:
                box.result = box.fn(lambda: box.abandoned)
            except BaseException as e:  # noqa: BLE001 — surfaced to caller
                box.error = e
            with box.lock:
                box.done.set()
            if box.abandoned and box.cleanup is not None:
                try:
                    box.cleanup()
                except Exception:  # noqa: BLE001 — zombie cleanup best-effort
                    pass

    def shutdown(self):
        self._q.put(None)

    def run(self, fn, timeout: float,
            cleanup: Optional[Callable[[], None]] = None):
        box = _StepBox(fn)
        self._q.put(box)
        if not box.done.wait(timeout):
            with box.lock:
                if not box.done.is_set():
                    # genuine overrun: abandon the thunk.  The lock makes
                    # abandon-vs-finish atomic: either the worker published
                    # its result first (harvested below) or it will see
                    # abandoned=True and run the cleanup when it returns.
                    box.abandoned = True
                    box.cleanup = cleanup
                    self.dead = True
                    raise StepStalledError(
                        f"supervised step exceeded the stall budget "
                        f"({timeout:.3f}s); worker abandoned")
        if box.error is not None:
            raise box.error
        return box.result


class _PackLayout:
    """Named int32 fields of one packed step input: ``fields`` is a list
    of ``(name, shape)``; each field is a slice of one flat vector, so a
    step's inputs cross to the device in one copy."""

    def __init__(self, fields):
        self.fields = list(fields)
        self.slices = {}
        off = 0
        for name, shp in self.fields:
            n = int(np.prod(shp))
            self.slices[name] = (off, off + n, tuple(shp))
            off += n
        self.total = off

    def new(self) -> np.ndarray:
        """A fresh zeroed host vector (never reused: an abandoned zombie
        may still be reading the previous step's)."""
        return np.zeros((self.total,), np.int32)

    def view(self, packed: np.ndarray, name: str) -> np.ndarray:
        a, b, shp = self.slices[name]
        return packed[a:b].reshape(shp)

    def unpack(self, dev: torch.Tensor) -> dict:
        """The fields of a packed device tensor, as views."""
        return {name: dev[a:b].view(shp)
                for name, (a, b, shp) in self.slices.items()}


def _plan_fields(t_max: int, nb_max: int, wl_max: int, token_block: int):
    """The pack fields of the ragged plan (``RAGGED_PLAN_FIELDS`` order)."""
    return [("blk_tok", (nb_max, token_block)), ("tok_blk", (t_max,)),
            ("tok_row", (t_max,)), ("blk_base", (nb_max,)),
            ("blk_rows", (nb_max,)), ("wl_blk", (wl_max,)),
            ("wl_page", (wl_max,)), ("wl_pageslot", (wl_max,)),
            ("n_items", (1,))]


# the words of the CUDA errors after which the context is unusable (the
# "sticky" errors of the CUDA runtime): every later call on the device
# fails, so no retry or rebuild can recover and the step must not contain
# them.  torch's own messages and the kernel wrappers' (which quote
# cudaGetErrorString) both carry these strings.
_STICKY_CUDA_ERRORS = (
    "illegal memory access", "unspecified launch failure",
    "misaligned address", "illegal instruction", "device-side assert",
    "hardware stack error", "invalid program counter",
    "uncorrectable ECC error", "the launch timed out",
)


def _uncontainable(e: BaseException) -> bool:
    """True for a fault the step must not contain (module docstring): a
    kernel refusing its inputs, a kernel that cannot be built or launched,
    or a sticky CUDA error."""
    if isinstance(e, (ValueError, KernelError)):
        return True
    msg = str(e)
    return any(w in msg for w in _STICKY_CUDA_ERRORS)


def _state_intact(e: BaseException) -> bool:
    """True when the exception provably fired BEFORE any device work (an
    injected fault flagged ``state_intact``): the pool is untouched, so
    containment can stay surgical.  Real device errors report False and
    recovery rebuilds."""
    return bool(getattr(e, "state_intact", False))


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
    both are given.

    Fault-containment knobs (module docstring), with the reference's
    defaults: ``stall_budget_s`` (None: dispatch inline, no watchdog),
    ``compile_budget_s`` (the budget of each step variant's first
    dispatch, 300 s), ``readmission_backoff_s`` (0.05 s) and
    ``backoff_max_s`` (5 s).  ``prefix_cache=True`` turns the prefix
    cache on; ``lora`` takes a ``LoRAAdapterPool`` on the model's device."""

    def __init__(self, model, *, num_slots: int = 4,
                 page_size: int = 128, max_context: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 cache_dtype: str = "bfloat16",
                 prefill_token_budget: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 stall_budget_s: Optional[float] = None,
                 compile_budget_s: float = 300.0,
                 max_queue_depth: Optional[int] = None,
                 max_queue_wait_s: Optional[float] = None,
                 readmission_backoff_s: float = 0.05,
                 backoff_max_s: float = 5.0,
                 seed: int = 0,
                 mesh=None, lora=None, prefix_cache: bool = False,
                 kv_dtype: Optional[str] = None,
                 weight_dtype: Optional[str] = None,
                 role: Optional[str] = None):
        # knobs of the JAX engine that wait for a later slice, each with
        # the ROADMAP.md queue-1 item that brings it
        for knob, asked in (("mesh", mesh is not None),
                            ("role", role is not None)):
            if asked:
                raise NotImplementedError(
                    f"ServingEngine({knob}) is not ported yet: ROADMAP.md "
                    "queue 1, item 9, sharded, elastic and disaggregated "
                    "serving")
        if kv_dtype is not None:
            cache_dtype = kv_dtype
        if weight_dtype is not None:
            if str(weight_dtype) != "int8":
                raise ValueError(
                    f"weight_dtype={weight_dtype!r}: only 'int8' (or None "
                    "for the model's own weights) is supported")
            quantize_for_serving(model)
        cfg = model.config
        if lora is not None and lora.device != model.device:
            raise ValueError(f"the LoRA pool is on {lora.device}, the model "
                             f"on {model.device}")
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
        self.lora = lora
        self.num_slots = int(num_slots)
        self.page_size = int(page_size)
        self.max_context = max_context
        self.prefill_token_budget = prefill_token_budget
        self.cache_dtype = dtype_name(cache_dtype)
        self.num_pages = int(num_pages)
        self.cache = self._new_pool()
        self.allocator = BlockAllocator(self.num_pages)
        self.scheduler = AdmissionScheduler(num_slots, max_pages_per_slot,
                                            page_size, self.allocator)
        # global prefix cache (opt-in): completed full pages are
        # radix-indexed by their token-id chunks so a later admission
        # splices the longest cached prefix into its page table and
        # prefills only the uncached tail.  It also installs the
        # allocator's pressure reclaimer (LRU eviction of refcount-0
        # cache pages BEFORE admission backpressures).
        self.prefix_cache = None
        if prefix_cache:
            self.prefix_cache = PrefixCache(self.allocator, self.page_size)
            self.scheduler.prefix_cache = self.prefix_cache
        self.queue = RequestQueue(max_depth=max_queue_depth)
        self._lock = threading.RLock()
        self._closed = False
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(int(seed))

        # fixed fused-step geometry.  A slot contributes ONE run per step
        # -- a decode token (one block) or a prefill run of c tokens
        # (1 + (c-1)//qb blocks); with P prefill runs sharing the budget,
        # total blocks <= num_slots + budget//qb.  The speculative engine
        # overrides _step_geometry (its decode slots run k+1-token verify
        # runs).
        self.head_dim = int(cfg.head_dim)
        self.token_block = TOKEN_BLOCK
        self._t_max, self._nb_max = self._step_geometry()
        self._wl_max = self._nb_max * max_pages_per_slot

        # fault-containment state
        self.stall_budget_s = (None if stall_budget_s is None
                               else float(stall_budget_s))
        # the first dispatch of a step variant builds the kernels (nvcc
        # at first use): the watchdog must not misread it as a stall
        self.compile_budget_s = max(float(compile_budget_s),
                                    self.stall_budget_s or 0.0)
        self.max_queue_wait_s = (None if max_queue_wait_s is None
                                 else float(max_queue_wait_s))
        self.readmission_backoff_s = float(readmission_backoff_s)
        self.backoff_max_s = float(backoff_max_s)
        self._backoff_s = self.readmission_backoff_s
        self._admit_after = 0.0          # monotonic; re-admission gate
        self._worker: Optional[_StepWorker] = None
        self._warm: set = set()          # step variants dispatched once
        # test-only fault injection: fn(point, ctx) may raise, stall, or
        # mutate ctx to simulate a fault at that point of the step pipeline
        # (serving/faults.py)
        self._fault_hook: Optional[Callable] = None

        # host mirrors of the per-slot state
        self._tokens = np.zeros((num_slots,), np.int64)
        # per-slot adapter page (0 = null adapter) + the seated adapter
        # NAME pinning the page's refcount until retirement
        self._adapter = np.zeros((num_slots,), np.int32)
        self._adapter_name: List[Optional[str]] = [None] * num_slots
        self._temp = np.ones((num_slots,), np.float32)
        self._top_p = np.ones((num_slots,), np.float32)
        self._top_k = np.zeros((num_slots,), np.int32)
        self._do_sample = np.zeros((num_slots,), bool)
        # every int32 step input in ONE packed vector (one host->device
        # copy per step); the step slices it back apart by fixed offsets
        fields = [("ids", (self._t_max,)),
                  ("tables", (self._t_max, max_pages_per_slot)),
                  ("positions", (self._t_max,)),
                  ("out_rows", (self.num_slots,))]
        fields += _plan_fields(self._t_max, self._nb_max, self._wl_max,
                               self.token_block)
        if self.lora is not None:
            # per-token adapter-page ids (0 = null adapter)
            fields.append(("adapters", (self._t_max,)))
        fields += self._extra_pack_fields()
        self._pack = _PackLayout(fields)
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
                        "shed": 0, "quarantined": 0, "step_retries": 0,
                        "recoveries": 0, "rebuilds": 0},
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
        # prefix-cache counters: hit / partial hit / miss per admission,
        # evictions synced from the cache's own ledger (they fire inside
        # the allocator's reclaimer).  Created with the cache off too, so
        # the metrics() keys are always there.
        self._prefix_totals = _tmetrics.CounterSet(
            "serving_prefix", {"hits_total": 0, "misses_total": 0,
                               "partial_hits_total": 0,
                               "evictions_total": 0},
            labels=self._engine_label)
        self._prefix_hist = reg.histogram(
            "serving_prefix_cached_tokens",
            "prompt tokens served from the prefix cache per admission",
        ).labels(**self._engine_label)
        self._step_emitted = 0
        self._last_metrics: dict = {}
        self._last_occupancy = (0.0, 0.0)   # (grid, q-row) of the last step

    def _step_geometry(self) -> Tuple[int, int]:
        """(t_max, nb_max): the fixed flat-token-axis length and block
        count of the fused step."""
        return (self.num_slots + self.prefill_token_budget,
                self.num_slots
                + self.prefill_token_budget // self.token_block)

    def _extra_pack_fields(self) -> list:
        """Extra (name, shape) int32 fields appended to the packed step
        input (subclass hook; the speculative engine adds the draft
        tokens and per-slot draft counts)."""
        return []

    def _new_pool(self):
        """A fresh page pool (at init and in ``_rebuild``)."""
        return self.model.new_paged_kv_cache(self.num_pages, self.page_size,
                                             dtype=self.cache_dtype)

    # -- submission --------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 32, *,
               sampling: Optional[SamplingParams] = None,
               eos_token_id: Optional[int] = None,
               on_token: Optional[Callable] = None,
               deadline_s: Optional[float] = None,
               adapter: Optional[str] = None) -> Request:
        """Queue a request; returns immediately.  Validation happens here
        so the step loop never meets an unseatable request.  A full
        bounded queue raises the typed ``Overloaded`` error (load shed);
        ``deadline_s`` bounds the request's total lifetime; ``adapter``
        names a tenant of the engine's LoRA pool."""
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
        if adapter is not None and self.lora is None:
            raise ValueError(
                f"request names adapter {adapter!r} but the engine has no "
                "LoRA pool (pass lora=LoRAAdapterPool(...) at construction)")
        req = Request(prompt, max_new_tokens, sampling=sampling,
                      eos_token_id=eos_token_id, on_token=on_token,
                      deadline_s=deadline_s)
        req.adapter = adapter
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
        mixed prefill/decode step over every seated slot's work
        (supervised, retried once, finiteness-checked), retire finished
        requests (their pages free at once).  A crashed or stalled step
        fails the implicated requests and the engine recovers.  Returns
        this step's metrics."""
        with self._lock, torch.no_grad(), _ttrace.span("serve.step"):
            self._check_open()
            t0 = time.perf_counter()
            self._step_emitted = 0
            with _ttrace.span("serve.plan"):
                now = time.monotonic()
                self._reap(now)
                self._admit(now)
                work = self.scheduler.plan_step(self.prefill_token_budget)
            if work:
                self._dispatch_step(work)
            with _ttrace.span("serve.commit"):
                return self._commit_step_metrics(t0)

    def _dispatch_step(self, work):
        """Pack -> dispatch (supervised, retried once) -> harvest for one
        tick's plan.  Overridden by the speculative engine (draft propose
        phase + verify dispatch); the containment here is the contract
        both share."""
        with _ttrace.span("serve.pack"):
            packed, stats = self._build_step_inputs(work)
        try:
            with _ttrace.span("serve.dispatch"):
                out = self._run_fused(packed)
        except StepStalledError as e:
            self._recover(e, rebuild=True, stalled=True)
            return
        except Exception as e:  # noqa: BLE001 — containment boundary
            if _uncontainable(e):
                raise
            self._recover(e, rebuild=not _state_intact(e))
            return
        self._totals["fused_steps"] += 1
        with _ttrace.span("serve.harvest"):
            self._harvest_fused(work, stats, *out)
        self._backoff_s = self.readmission_backoff_s

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
            "recoveries": self._totals["recoveries"],
        }
        self._sync_prefix_counters()
        return dict(self._last_metrics)

    def _build_step_inputs(self, work) -> Tuple[np.ndarray, dict]:
        """Flatten one tick's plan into the packed int32 step input: the
        flat token list (decode tokens from the last-sampled mirrors,
        prefill tokens from each slot's pending prompt, a verify run's
        last sampled token then its drafts), per-token positions,
        page-table rows and adapter pages, each slot's output row, and the
        ragged plan arrays.  Padding tokens carry id 0, position 0 and the
        null-page table row."""
        sched, pack = self.scheduler, self._pack
        packed = pack.new()
        ids = pack.view(packed, "ids")
        tables = pack.view(packed, "tables")
        positions = pack.view(packed, "positions")
        out_rows = pack.view(packed, "out_rows")
        adapters = (pack.view(packed, "adapters") if self.lora is not None
                    else None)
        runs = []
        t = 0
        for w in work:
            slot = sched.slots[w.slot]
            if w.kind == "prefill":
                ids[t:t + w.count] = slot.pending[:w.count]
            else:
                ids[t] = self._tokens[w.slot]
                if w.kind == "verify":
                    ids[t + 1:t + w.count] = w.drafts[:w.count - 1]
            row = sched.tables[w.slot]
            tables[t:t + w.count] = row
            positions[t:t + w.count] = w.base + np.arange(w.count,
                                                          dtype=np.int32)
            if adapters is not None:
                adapters[t:t + w.count] = self._adapter[w.slot]
            if w.has_output:
                out_rows[w.slot] = t + w.count - 1
            runs.append((w.base, w.count, row))
            t += w.count
        plan, stats = build_ragged_plan(
            runs, token_block=self.token_block, page_size=self.page_size,
            t_max=self._t_max, nb_max=self._nb_max, wl_max=self._wl_max)
        for k in RAGGED_PLAN_FIELDS:
            pack.view(packed, k)[...] = plan[k]
        return packed, stats

    def _sampling_inputs(self):
        """(the per-slot sampling tensors on the device, the build to
        commit): the cached tensors, or fresh copies of the mirrors, which
        the dispatching thread commits only when the supervised run
        finished in budget -- an abandoned zombie never writes live
        state."""
        if self._sampling_cache is not None:
            return self._sampling_cache, None
        dev = self.device
        built = tuple(torch.from_numpy(a.copy()).to(dev) for a in (
            self._temp, self._top_p, self._top_k, self._do_sample))
        return built, built

    def _upload(self, packed: np.ndarray) -> dict:
        """The packed input on the device, unpacked into its fields."""
        return self._pack.unpack(torch.from_numpy(packed).to(self.device))

    def _logit_rows(self, f: dict, cache, out_rows) -> torch.Tensor:
        """The model's fused step over the unpacked inputs ``f`` and
        ``cache``: fp32 logits of the ``out_rows`` rows, ``[R, V]``."""
        plan = tuple(f[k] for k in RAGGED_PLAN_FIELDS)
        lora = (self.lora, f["adapters"]) if self.lora is not None else None
        logits = self.model._paged_lm_logits(
            f["ids"][:, None], cache, f["tables"], f["positions"],
            ragged_plan=plan, out_rows=out_rows, lora=lora)
        return logits[:, -1, :].float()

    def _run_fused(self, packed: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """Dispatch the fused step under the watchdog, retried once on a
        (transient) exception.  A stall is never retried -- the worker is
        already wedged."""
        sampling = bool(self._do_sample.any())
        cache = self.cache

        def thunk(cancelled):
            return self._fused_thunk(packed, cache, sampling, cancelled)

        return self._supervised_call(thunk, [("fused", sampling)])

    def _fused_thunk(self, packed, cache, sampling, cancelled):
        """The device work of one fused step: one packed input copy in,
        the model's fused step over ``cache`` (the pool captured at
        dispatch: a rebuild never hands the zombie the fresh one), argmax
        or per-slot sampling, the finiteness sentry, one copy of (tokens,
        flags) out.  Runs on the watchdog's worker when it supervises."""
        # grad mode is per thread: the worker's must be off too
        with torch.no_grad(), _ttrace.span("serve.device_step"):
            self._hook("before_decode")
            if cancelled():      # abandoned while the fault hook stalled:
                return None      # the result is discarded; skip dispatch
            samp, built = (self._sampling_inputs() if sampling
                           else (None, None))
            f = self._upload(packed)
            rows = self._logit_rows(f, cache, f["out_rows"])
            # per-slot finiteness flags ride the same transfer as the
            # tokens: the sentry costs no extra host sync
            fin = torch.isfinite(rows).all(dim=-1)
            if sampling:
                tok = _sample_per_slot(rows, *samp, generator=self._generator)
            else:
                tok = rows.argmax(dim=-1)
            out = torch.stack([tok, fin.long()]).cpu().numpy()
            return out[0], out[1].astype(bool), built

    def _supervised_call(self, thunk, variants, retry: bool = True):
        """Run ``thunk(cancelled)`` (which returns its results then the
        sampling build) under the watchdog with the budget of
        ``variants``; one immediate retry on a containable exception when
        ``retry``.  Commits the sampling build on THIS thread and marks the
        variants dispatched.  Returns the thunk's results."""
        budget = self._budget_for(variants)
        try:
            out = self._supervised(thunk, budget)
        except StepStalledError:
            raise
        except Exception as e:  # noqa: BLE001 — transient errors retry once
            if not retry or _uncontainable(e):
                raise
            self._totals["step_retries"] += 1
            out = self._supervised(thunk, budget)
        self._warm.update(variants)
        if out[-1] is not None:
            self._sampling_cache = out[-1]
        return out[:-1]

    def _budget_for(self, variants) -> Optional[float]:
        """Watchdog budget for one supervised dispatch: the stall budget,
        or the much larger compile budget when a variant has not been
        dispatched yet (its first call builds the kernels)."""
        if self.stall_budget_s is None:
            return None
        if any(v not in self._warm for v in variants):
            return self.compile_budget_s
        return self.stall_budget_s

    def _harvest_fused(self, work, stats, toks_np: np.ndarray,
                       fin_np: np.ndarray):
        """Fold one fused step's results back into the request states:
        consume prefill runs, quarantine NaN-poisoned output slots,
        advance/emit the rest, register completed pages in the prefix
        cache.  Mirrors and pending prompts only move HERE -- a failed
        dispatch leaves them untouched for the retry."""
        ctx = {"tokens": toks_np, "finite": fin_np}
        self._hook("after_decode", ctx)
        sched = self.scheduler
        self._fold_plan_stats(work, stats)
        for w in work:
            slot = sched.slots[w.slot]
            if slot is None:
                continue
            if w.kind == "prefill":
                slot.pending = slot.pending[w.count:]
            if w.has_output and not ctx["finite"][w.slot]:
                # finiteness sentry: quarantine the poisoned slot instead
                # of streaming garbage; every other slot proceeds
                self._totals["quarantined"] += 1
                self._fail_slot(w.slot, NaNLogitsError(
                    f"request {slot.request.id}: non-finite logits at "
                    f"position {slot.pos + w.count - 1} "
                    f"(slot {w.slot} quarantined)"))
                continue
            # the step wrote this run's K/V at positions base..base+count-1
            sched.advance(w.slot, w.count)
            self._register_shared(w.slot)
            if not w.has_output:
                continue                 # mid-prefill: nothing sampled yet
            req = slot.request
            tok = int(ctx["tokens"][w.slot])
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

    def _register_shared(self, idx: int):
        """Register slot ``idx``'s newly COMPLETED full pages in the
        prefix cache (at harvest, right after ``advance`` commits the
        step's writes).  A page is complete once ``pos`` has advanced past
        its last position -- from then on the slot only writes strictly
        later pages (COW by construction), so the page is immutable and
        safe to share.  When another slot already registered an identical
        chunk, the existing node's page is ADOPTED: it replaces the slot's
        own page in its table row (identical token prefixes give identical
        pages, an int8 page's scales included) and the private duplicate
        goes straight back to the pool."""
        cache = self.prefix_cache
        if cache is None:
            return
        sched = self.scheduler
        slot = sched.slots[idx]
        req = slot.request
        if req.adapter is not None:
            # LoRA'd K/V depends on the adapter, not just the token ids:
            # a cross-tenant hit would splice in the WRONG values
            return
        ps = self.page_size
        full = slot.pos // ps
        if full <= slot.shared:
            return
        # written token ids at positions [0, pos): the prompt plus the
        # emitted continuation (writes trail emissions by one token)
        seq = np.concatenate(
            [np.asarray(req.prompt, np.int64),
             np.asarray(req.tokens, np.int64)])[:slot.pos]
        while slot.shared < full:
            i = slot.shared
            parent = slot.nodes[-1] if slot.nodes else None
            node, owned = cache.extend(parent, seq[i * ps:(i + 1) * ps],
                                       slot.pages[i])
            if not owned:
                self.allocator.free([slot.pages[i]])
                slot.pages[i] = node.page
                sched.tables[idx, i] = node.page
            slot.nodes.append(node)
            slot.shared += 1

    def run_until_idle(self, max_steps: Optional[int] = None) -> dict:
        """Step until queue and slots drain; returns cumulative metrics."""
        steps = 0
        while self.queue.depth or self.scheduler.active_slots:
            met = self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
            if (not met["active_slots"] and not met["tokens_this_step"]
                    and self.queue.depth):
                # admission gated by post-recovery backoff: don't spin hot
                time.sleep(0.001)
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

    # -- internals ---------------------------------------------------------
    def _hook(self, point: str, ctx: Optional[dict] = None):
        if self._fault_hook is not None:
            self._fault_hook(point, ctx)

    def _supervised(self, fn, budget: Optional[float]):
        """Run ``fn(cancelled)`` under the watchdog when a budget is
        given; inline otherwise."""
        if budget is None:
            return fn(lambda: False)
        if self._worker is None or self._worker.dead:
            if self._worker is not None:
                # let the replaced worker's thread exit once its zombie
                # thunk returns (else one blocked thread leaks per stall)
                self._worker.shutdown()
            self._worker = _StepWorker(f"serving-step-{id(self):x}")
        return self._worker.run(fn, budget, cleanup=self._zombie_cleanup())

    def _zombie_cleanup(self) -> Callable[[], None]:
        """What an abandoned (stalled) step runs when it finally returns:
        its writes landed in the pool it captured, which the rebuild
        orphaned -- release that pool's device memory.  The speculative
        engine widens this to its draft pool."""
        cache = self.cache

        def cleanup():
            cache.release()

        return cleanup

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
        """Seat queued requests while slots AND pages allow: the tenant's
        adapter pinned, the longest cached prefix spliced in (reader
        references taken), pages for the rest reserved all-or-nothing, and
        the uncached tail of the prompt parked on ``Slot.pending``; the
        same tick's fused step starts consuming it under the token
        budget."""
        if now < self._admit_after:
            return                        # re-admission backoff after recovery
        sched = self.scheduler
        while sched.free_slot_indices():
            req = self.queue.pop()
            if req is None:
                return
            page = 0
            if req.adapter is not None:
                try:
                    # pin the tenant's adapter page for the seated life of
                    # the request (evicting it now raises AdapterInUse)
                    page = self.lora.acquire(req.adapter)
                except ServingError as e:
                    # evicted while queued: fail THIS request, typed -- a
                    # silent null-adapter decode would be a wrong answer
                    self._terminalize(req, RequestState.FAILED, e)
                    continue
            total = req.prompt.size + req.max_new_tokens
            # longest cached prefix: reader references taken NOW so the
            # tail-only reservation below can never evict the hit pages
            c_nodes, c_pages, n_cached = (), (), 0
            if self.prefix_cache is not None and req.adapter is None:
                c_nodes, c_pages, n_cached = \
                    self.prefix_cache.acquire(req.prompt)
            idx = sched.try_admit(req, total, cached_pages=c_pages,
                                  cached_nodes=c_nodes, n_cached=n_cached)
            if idx is None:
                # pool backpressure: requeue and stop admitting (FIFO --
                # later smaller requests must not starve this one)
                if c_nodes:
                    self.prefix_cache.release(c_nodes)
                if req.adapter is not None:
                    self.lora.release(req.adapter)
                self.queue.push_front(req)
                return
            self._adapter[idx] = page
            self._adapter_name[idx] = req.adapter
            self._totals["admitted"] += 1
            if self.prefix_cache is not None and req.adapter is None:
                cacheable = self.prefix_cache._cacheable_chunks(
                    req.prompt.size) * self.page_size
                if n_cached and n_cached >= cacheable:
                    self._prefix_totals["hits_total"] += 1
                elif n_cached:
                    self._prefix_totals["partial_hits_total"] += 1
                else:
                    self._prefix_totals["misses_total"] += 1
                self._prefix_hist.observe(float(n_cached))
            req.t_admitted = now
            if req.t_submitted is not None:
                self._slo["queue_wait"].observe(now - req.t_submitted)
            sp = req.sampling
            self._temp[idx] = np.float32(sp.temperature)
            self._top_p[idx] = np.float32(sp.top_p)
            self._top_k[idx] = np.int32(sp.top_k)
            self._do_sample[idx] = bool(sp.do_sample)
            self._sampling_cache = None
            # only the uncached tail still needs prefilling: the slot is
            # seated at position n_cached and its first run starts there
            sched.slots[idx].pending = np.asarray(req.prompt[n_cached:],
                                                  np.int64)
            req.state = RequestState.PREFILL

    # -- recovery ----------------------------------------------------------
    def _recover(self, error: BaseException, *, rebuild: bool,
                 stalled: bool = False):
        """Contain a crashed or stalled step: every seated request is
        implicated (the pool they share may be half-written) and ends
        FAILED with ``error`` attached; queued requests survive untouched.
        With ``rebuild`` the device pool is reconstructed.  Re-admission
        backs off exponentially (reset by a clean step)."""
        with _ttrace.span("serve.recover", error=type(error).__name__,
                          rebuild=rebuild):
            self._totals["recoveries"] += 1
            for i, _slot in self.scheduler.seated():
                self._fail_slot(i, error)
            if rebuild:
                self._rebuild(release_old=not stalled)
            now = time.monotonic()
            self._admit_after = now + self._backoff_s
            self._backoff_s = min(self._backoff_s * 2.0, self.backoff_max_s)

    def _rebuild(self, release_old: bool = True):
        """Reconstruct the engine's DEVICE state after a catastrophic step
        failure: a fresh, zeroed page pool (an int8 pool with fresh
        scales).  Host state (allocator, queue, counters) is authoritative
        and survives as-is.  The old pool is released at once unless a
        zombie worker may still touch it (a stall) -- then the abandoned
        box's cleanup releases it when the zombie returns, so both pools
        are alive until then."""
        assert self.scheduler.active_slots == 0, \
            "rebuild with seated requests would strand their K/V"
        if self.prefix_cache is not None:
            # the fresh pool is zeroed: every cached page is invalid.  All
            # readers retired above (refcounts 0), so the flush reclaims
            # the whole shared ledger back to the free list.
            self.prefix_cache.flush()
        assert self.allocator.used_pages == 0, \
            f"rebuild leaked {self.allocator.used_pages} pages"
        assert self.allocator.shared_pages == 0, \
            f"rebuild leaked {self.allocator.shared_pages} shared pages"
        with _ttrace.span("serve.rebuild"):
            old = self.cache
            self.cache = self._new_pool()
            self.scheduler.reset_mirrors()
            self._sampling_cache = None
            if release_old:
                old.release()
            self._totals["rebuilds"] += 1

    # -- terminal transitions ----------------------------------------------
    def _clear_slot_mirrors(self, idx: int):
        self._tokens[idx] = 0
        self._temp[idx] = 1.0
        self._top_p[idx] = 1.0
        self._top_k[idx] = 0
        self._do_sample[idx] = False
        if self._adapter_name[idx] is not None:
            self.lora.release(self._adapter_name[idx])
        self._adapter[idx] = 0
        self._adapter_name[idx] = None
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

    def _fail_slot(self, idx: int, error: BaseException):
        self._retire_slot(idx, RequestState.FAILED, error)

    def _emit(self, req: Request, tok: int, now: Optional[float] = None):
        """Emit one generated token.  ``now`` lets a multi-token step
        (speculative acceptance) stamp every token it emits with the one
        step timestamp: the step's first token observes the true
        inter-arrival gap, the rest observe 0."""
        req.tokens.append(tok)
        self._step_emitted += 1
        if now is None:
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
                self._hook("callback")
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
        occupancy means, the per-request SLO digests (seconds), the prefix
        cache's accounting (zeros with the cache off) and, with a LoRA
        pool, its adapters and slab bytes."""
        out = dict(self._totals)
        out.update(self._last_metrics)
        out["queue_depth"] = self.queue.depth
        out["active_slots"] = self.scheduler.active_slots
        out["pages_used"] = self.allocator.used_pages
        out["pages_capacity"] = self.allocator.capacity
        out["occupancy"] = self.scheduler.occupancy
        out["cache_bytes"] = self.cache.nbytes if not self._closed else 0
        wc = self._totals["work_capacity"]
        rc = self._totals["block_row_capacity"]
        out["mean_grid_occupancy"] = (self._totals["work_items"] / wc
                                      if wc else 0.0)
        out["mean_q_row_occupancy"] = (self._totals["block_rows"] / rc
                                       if rc else 0.0)
        out["slo"] = {k: h.summary() for k, h in self._slo.items()}
        self._sync_prefix_counters()
        hits = self._prefix_totals["hits_total"]
        partial = self._prefix_totals["partial_hits_total"]
        misses = self._prefix_totals["misses_total"]
        cached = int(self._prefix_hist.summary()["sum"])
        out["prefix_hits"] = hits
        out["prefix_partial_hits"] = partial
        out["prefix_misses"] = misses
        out["prefix_evictions"] = self._prefix_totals["evictions_total"]
        out["prefix_cached_tokens"] = cached
        looked = hits + partial + misses
        out["prefix_hit_rate"] = (hits + partial) / looked if looked else 0.0
        written = cached + self._totals["prefill_tokens"]
        out["cached_tokens_share"] = cached / written if written else 0.0
        out["prefix_cache_pages"] = (self.prefix_cache.pages
                                     if self.prefix_cache else 0)
        out["prefix_cache_nodes"] = (self.prefix_cache.nodes
                                     if self.prefix_cache else 0)
        out["shared_pages"] = self.allocator.shared_pages
        if self.lora is not None:
            out["lora_adapters"] = len(self.lora.adapters())
            out["lora_pages_used"] = self.lora.allocator.used_pages
            out["lora_slab_bytes"] = self.lora.nbytes
        return out

    def _sync_prefix_counters(self):
        """Mirror the cache's eviction tally onto the registry counter --
        evictions fire inside the allocator's pressure reclaimer (mid
        ``alloc``), where no engine code runs."""
        if self.prefix_cache is None:
            return
        ev = self.prefix_cache.stats["evictions"]
        if ev > self._prefix_totals["evictions_total"]:
            self._prefix_totals["evictions_total"] = ev

    def close(self):
        """Release the page pool's device memory.  Pending/active requests
        are NOT drained -- call ``run_until_idle`` first if they matter.
        Serialises on the step lock, so an in-flight step finishes first
        and later steps fail the open check."""
        with self._lock:
            if not self._closed:
                self._closed = True
                self.cache.release()
                if self._worker is not None:
                    self._worker.shutdown()
                # drop this engine's children from the process registry
                _tmetrics.registry().drop_labels(**self._engine_label)
