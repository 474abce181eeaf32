"""Activation checkpointing of the port: :func:`checkpoint`, which every
recomputed region of the package calls (``distributed.pp_spmd.checkpointed``,
the layered GPT's ``recompute_interval`` loop, ``fleet.recompute`` and the
chunked loss heads of ``nn.functional.loss``).

The design is PyTorch's non-reentrant checkpoint: the forward runs under
saved-tensor hooks that keep a small holder in place of each tensor the
autograd graph saves, and the first unpack of a backward pass runs the
function again (the recompute, a forward only), whose saved tensors fill
the holders in the order the forward saved them.  The graph is the
forward's own, so tensors the function reads without taking them as
arguments (a module's parameters) get their gradients.

What it adds is a guard.  Autograd runs each device's backward nodes on
a thread of its own (the CPU's on the thread that called ``backward``),
so a function whose forward spans devices -- a block whose shards lie on
distinct cards, a loss over vocabulary shards, a region that reaches the
CPU -- has its saved tensors unpacked from several threads in one
backward pass.  ``torch.utils.checkpoint`` checks "recomputed?",
recomputes and then marks its frame with no lock, so two threads can
recompute one frame at once, and the two recomputations' saved tensors
clash ("target_frame.early_stop is set", "a different number of tensors
was saved").  Here each frame holds one lock around check, recompute and
mark, so the recompute runs once a frame and backward pass, however many
threads unpack the frame.  The recompute is a forward: it waits on no
other autograd thread while it holds the lock.

As in PyTorch's, the recompute stops as soon as it has saved as many
tensors as the forward did; runs with the forward's RNG states (the
CPU's and those of the cards of the tensor arguments) unless
``preserve_rng_state=False``, and under the forward's ``torch.autocast``
state; and ``context_fn`` gives the (forward, recompute) context pair of
a selective checkpoint (``create_selective_checkpoint_contexts``).
Without grad mode the call is a plain call.
"""
from __future__ import annotations

import contextlib
import threading
import uuid
import weakref
from typing import Callable, ContextManager, Optional, Tuple

import torch

__all__ = ["checkpoint", "CheckpointError"]


class CheckpointError(RuntimeError):
    """The recompute saved other tensors than the forward did."""


class _Holder:
    """Stands in the graph for one saved tensor: ``values[task]`` is the
    recomputed tensor of a backward pass until it is unpacked."""

    __slots__ = ("values", "__weakref__")

    def __init__(self):
        self.values = {}


class _Stop(Exception):
    """Raised from the recompute's pack hook once every holder is filled."""


def _task_id() -> int:
    """The running backward pass (the same on every autograd thread of
    one pass); outside a backward, a new id each unpack."""
    task = torch._C._current_graph_task_id()
    return task if task != -1 else uuid.uuid4().int


def _autocast_state():
    """The forward's ``torch.autocast`` state, per device type."""
    return [(dev, torch.is_autocast_enabled(dev),
             torch.get_autocast_dtype(dev))
            for dev in ("cuda", "cpu")
            if torch.amp.is_autocast_available(dev)]


class _Frame:
    """One checkpointed call: its function and inputs, the holders of
    the tensors its forward saved, and the lock that makes its recompute
    run once a backward pass."""

    def __init__(self, fn, args, kwargs, recompute_ctx, preserve_rng_state):
        self.fn, self.args, self.kwargs = fn, args, kwargs
        self.recompute_ctx = recompute_ctx
        self.lock = threading.Lock()
        self.holders = []             # weak references, in pack order
        self.recomputed = set()       # task ids
        self.autocast = _autocast_state()
        self.rng = None
        if preserve_rng_state:
            cards = sorted({a.device.index for a in args
                            if isinstance(a, torch.Tensor)
                            and a.device.type == "cuda"})
            self.rng = (torch.get_rng_state(), cards,
                        [torch.cuda.get_rng_state(d) for d in cards])

    def pack(self, x):
        holder = _Holder()
        self.holders.append(weakref.ref(holder))
        return holder

    def unpack(self, holder):
        task = _task_id()
        with self.lock:
            if task not in self.recomputed:
                self._recompute(task)
                self.recomputed.add(task)
        try:
            return holder.values.pop(task)
        except KeyError:
            raise CheckpointError(
                "checkpoint: a saved tensor was unpacked twice in one "
                "backward pass, or the recompute did not save it") from None

    def _recompute(self, task):
        n = len(self.holders)
        count = [0]

        def pack(x):
            # detached: a node that saves its own output would otherwise
            # hold itself through the saved tensor, and the recompute's
            # graph, its hooks, this frame and its inputs would never be
            # freed
            x = x.detach() if x.requires_grad else x
            i = count[0]
            count[0] += 1
            if i >= n:
                raise CheckpointError(
                    f"checkpoint: the recompute saved more than the {n} "
                    "tensors the forward saved")
            holder = self.holders[i]()
            if holder is not None:        # its node may be gone already
                holder.values[task] = x
            if count[0] == n:
                raise _Stop
            return x

        rng = self.rng
        cards = rng[1] if rng is not None else []
        with contextlib.ExitStack() as stack:
            stack.enter_context(torch.random.fork_rng(
                devices=cards, enabled=rng is not None))
            if rng is not None:
                torch.set_rng_state(rng[0])
                for d, s in zip(cards, rng[2]):
                    torch.cuda.set_rng_state(s, d)
            for dev, enabled, dtype in self.autocast:
                stack.enter_context(torch.autocast(dev, dtype=dtype,
                                                   enabled=enabled))
            stack.enter_context(self.recompute_ctx)
            stack.enter_context(torch.enable_grad())
            stack.enter_context(torch.autograd.graph.saved_tensors_hooks(
                pack, lambda x: x))
            try:
                self.fn(*self.args, **self.kwargs)
            except _Stop:
                pass
        if count[0] != n:
            raise CheckpointError(
                f"checkpoint: the forward saved {n} tensors and the "
                f"recompute {count[0]}; the function must save the same "
                "tensors when it runs again")


def _no_contexts() -> Tuple[ContextManager, ContextManager]:
    return contextlib.nullcontext(), contextlib.nullcontext()


def checkpoint(fn: Callable, *args, preserve_rng_state: bool = True,
               context_fn: Optional[Callable[[], Tuple[ContextManager,
                                                       ContextManager]]]
               = None, **kwargs):
    """``fn(*args, **kwargs)``, its saved activations dropped and computed
    again in the backward, once a backward pass (module docstring).
    ``context_fn()`` gives the contexts the forward and the recompute run
    in (a selective checkpoint's pair)."""
    if not torch.is_grad_enabled():
        return fn(*args, **kwargs)
    fwd_ctx, rec_ctx = (context_fn or _no_contexts)()
    frame = _Frame(fn, args, kwargs, rec_ctx, preserve_rng_state)
    with torch.autograd.graph.saved_tensors_hooks(frame.pack, frame.unpack), \
            fwd_ctx:
        return fn(*args, **kwargs)
