"""Asynchronous host -> device input pipeline (port of
``paddle_tpu/io/device_prefetch.py``).

A synchronous copy at the top of the loop puts each batch's transfer
into every step.  :class:`DevicePrefetcher` overlaps it: a producer
thread pulls host batches from the source, copies each numpy leaf into
pinned host memory and from there to the card with ``non_blocking=True``
on a side CUDA stream, up to ``depth`` batches ahead, and records an
event after the copies.  The consumer's ``next()`` makes its current
stream wait on that event (a wait on the card, not on the host) and
marks the batch's tensors as used by that stream, so the caching
allocator keeps them until the step that reads them is done.

Observability: every ``next()`` records how long the consumer waited
into the telemetry histogram ``train_input_stall_seconds`` and into
``stats()``.

On the CPU (``device="cpu"``) numpy leaves become CPU tensors, copied, on
the same thread discipline, with no stream.

``sharding=`` places each batch over a mesh (the reference's
``jax.device_put(leaf, NamedSharding(...))``): a
:class:`~paddle_tpu_torch.distributed.mesh.NamedSharding`, or its spec
alone over the global mesh.  Each leaf becomes a
:class:`~paddle_tpu_torch.distributed.mesh.PlacedTensor`: one copy of
each distinct (block, device) pair of the mesh's positions, made on a
side stream of that device, one event a device for the batch.  The bytes
copied are counted in ``bytes_copied``.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Iterable, Iterator

import numpy as np
import torch

from ..core import resolve_device
from ..distributed.mesh import NamedSharding, PlacedTensor

__all__ = ["DevicePrefetcher"]


def _histogram():
    from ..telemetry import registry

    return registry().histogram(
        "train_input_stall_seconds",
        help="time the training loop blocked waiting for the next "
             "device-resident batch (0 when the prefetch pipeline is ahead)",
        unit="seconds")


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _tensors(o)
    elif isinstance(obj, PlacedTensor):
        yield from obj.blocks.values()


class DevicePrefetcher:
    """Iterate device-resident batches ``depth`` ahead of the consumer.

    ``source`` is any iterable of batch trees (tuples, lists, dicts) with
    numpy or tensor leaves.  numpy arrays are copied to ``device``
    (``None``: the card) as tensors; CPU tensors are copied the same way;
    tensors already on the device and other leaves (numpy scalars, ints)
    pass through.  ``wrap_tensors`` is accepted, as the reference takes
    it: the port's batches are torch tensors either way.  ``sharding``: a
    ``NamedSharding``, or a spec over the global mesh (``("dp",)``,
    ``(("dp", "sharding"),)``, ``(None, "sp")``, ``()``): every numpy or
    tensor leaf becomes a ``PlacedTensor`` (module docstring), and
    ``device`` is not read.  A malformed spec raises ``TypeError`` or
    ``ValueError``; a leaf whose dimension the spec's axes do not divide,
    ``ValueError`` in the consumer.

    Errors in the source or the copies re-raise in the consumer;
    ``close()`` (also on ``with`` exit) retires the thread without
    draining the source."""

    def __init__(self, source: Iterable, depth: int = 2, sharding=None,
                 wrap_tensors: bool = True, *, device=None):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        if sharding is not None and not isinstance(sharding,
                                                   NamedSharding):
            sharding = NamedSharding(None, sharding)
        self.depth = int(depth)
        self._sharding = sharding
        self.device = None if sharding is not None else resolve_device(
            device)
        self._wrap = wrap_tensors
        self._streams = {}               # one side stream a card
        self._used = set()               # cards the current batch went to
        self.bytes_copied = 0
        self._q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        self._sentinel = object()
        self._err: list = []
        self._stop = threading.Event()
        self._stall_total = 0.0
        self._batches = 0
        self._hist = _histogram()
        self._thread = threading.Thread(
            target=self._producer, args=(iter(source),), daemon=True,
            name="device-prefetch")
        self._thread.start()

    # -- producer ----------------------------------------------------------
    def _copy(self, t: torch.Tensor, device) -> torch.Tensor:
        """``t`` copied to ``device``: from pinned memory on the card's side
        stream, a plain copy elsewhere."""
        self.bytes_copied += t.numel() * t.element_size()
        if device.type != "cuda":
            return t.to(device, copy=True)
        if device not in self._streams:
            self._streams[device] = torch.cuda.Stream(device)
        self._used.add(device)
        src = t.contiguous() if t.device.type != "cpu" else \
            t.contiguous().pin_memory()
        with torch.cuda.stream(self._streams[device]):
            return src.to(device, non_blocking=True)

    def _place(self, t: torch.Tensor) -> PlacedTensor:
        """One copy of each distinct (block, device) pair of the mesh's
        positions."""
        sh = self._sharding
        cuts = sh.cuts(t.shape)
        blocks = {}
        for coords, device in sh.positions():
            idx = sh.block_of(coords)
            if (idx, device) not in blocks:
                part = t
                for k, (i, n) in enumerate(zip(idx, cuts)):
                    size = t.shape[k] // n
                    part = part.narrow(k, i * size, size)
                blocks[(idx, device)] = self._copy(part, device)
        return PlacedTensor(sh, t.shape, t.dtype, blocks)

    def _put(self, obj):
        """Host tree -> device tree (on the side streams when on the
        card), or each leaf placed over the mesh with ``sharding``."""
        if isinstance(obj, np.ndarray):
            obj = torch.from_numpy(obj)
        if isinstance(obj, torch.Tensor):
            if self._sharding is not None:
                return self._place(obj)
            if obj.device == self.device:
                return obj
            return self._copy(obj, self.device)
        if isinstance(obj, (list, tuple)):
            return type(obj)(self._put(o) for o in obj)
        if isinstance(obj, dict):
            return {k: self._put(v) for k, v in obj.items()}
        return obj

    def _producer(self, it: Iterator):
        try:
            for batch in it:
                self._used = set()
                dev = self._put(batch)
                events = {}
                for d in self._used:
                    events[d] = torch.cuda.Event()
                    events[d].record(self._streams[d])
                while not self._stop.is_set():
                    try:
                        self._q.put((dev, events), timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
        except BaseException as e:  # noqa: BLE001 -- re-raised in consumer
            self._err.append(e)
        finally:
            # wait for space on the normal path (never displace a real
            # batch); force-place on shutdown so nothing ever blocks
            placed = False
            while not self._stop.is_set():
                try:
                    self._q.put(self._sentinel, timeout=0.1)
                    placed = True
                    break
                except queue.Full:
                    continue
            while not placed:
                try:
                    self._q.put_nowait(self._sentinel)
                    placed = True
                except queue.Full:
                    try:
                        self._q.get_nowait()
                    except queue.Empty:
                        pass

    # -- consumer ----------------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        t0 = time.perf_counter()
        item = self._q.get()
        stall = time.perf_counter() - t0
        if item is self._sentinel:
            self.close()
            if self._err:
                raise self._err[0]
            raise StopIteration
        batch, events = item
        for d, event in events.items():
            cur = torch.cuda.current_stream(d)
            cur.wait_event(event)
            for t in _tensors(batch):
                if t.device == d:
                    t.record_stream(cur)
        self._stall_total += stall
        self._batches += 1
        self._hist.observe(stall)
        return batch

    def stats(self) -> dict:
        """``{"batches", "stall_seconds_total", "stall_seconds_mean"}`` for
        the batches consumed so far."""
        n = self._batches
        return {
            "batches": n,
            "stall_seconds_total": self._stall_total,
            "stall_seconds_mean": (self._stall_total / n) if n else 0.0,
        }

    def close(self):
        """Retire the producer thread; safe to call more than once."""
        self._stop.set()
        while True:  # drain so a blocked put releases immediately
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=0.5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass
