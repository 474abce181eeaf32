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
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Iterable, Iterator

import numpy as np
import torch

from ..core import resolve_device

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


class DevicePrefetcher:
    """Iterate device-resident batches ``depth`` ahead of the consumer.

    ``source`` is any iterable of batch trees (tuples, lists, dicts) with
    numpy or tensor leaves.  numpy arrays are copied to ``device``
    (``None``: the card) as tensors; CPU tensors are copied the same way;
    tensors already on the device and other leaves (numpy scalars, ints)
    pass through.  ``wrap_tensors`` is accepted, as the reference takes
    it: the port's batches are torch tensors either way.  ``sharding``
    (a mesh placement) is not ported.

    Errors in the source or the copies re-raise in the consumer;
    ``close()`` (also on ``with`` exit) retires the thread without
    draining the source."""

    def __init__(self, source: Iterable, depth: int = 2, sharding=None,
                 wrap_tensors: bool = True, *, device=None):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        if sharding is not None:
            raise NotImplementedError(
                "DevicePrefetcher(sharding=): batches placed over a mesh "
                "are ROADMAP.md queue 1, item 9, step 4")
        self.depth = int(depth)
        self.device = resolve_device(device)
        self._wrap = wrap_tensors
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
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
    def _put(self, obj):
        """Host tree -> device tree (on the side stream when on the
        card)."""
        if isinstance(obj, np.ndarray):
            obj = torch.from_numpy(obj)
        if isinstance(obj, torch.Tensor):
            if obj.device == self.device:
                return obj
            if self._stream is None:
                return obj.to(self.device, copy=True)
            return obj.pin_memory().to(self.device, non_blocking=True)
        if isinstance(obj, (list, tuple)):
            return type(obj)(self._put(o) for o in obj)
        if isinstance(obj, dict):
            return {k: self._put(v) for k, v in obj.items()}
        return obj

    def _producer(self, it: Iterator):
        try:
            for batch in it:
                event = None
                if self._stream is None:
                    dev = self._put(batch)
                else:
                    with torch.cuda.stream(self._stream):
                        dev = self._put(batch)
                        event = torch.cuda.Event()
                        event.record(self._stream)
                while not self._stop.is_set():
                    try:
                        self._q.put((dev, event), timeout=0.1)
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
        batch, event = item
        if event is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(event)
            for t in _tensors(batch):
                if t.device == self.device:
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
