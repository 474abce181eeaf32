"""Preemption-safe exit: SIGTERM/SIGINT -> checkpoint at the next step
boundary, then clean exit (a copy of ``paddle_tpu/checkpoint/
preemption.py``: host code only).

Reference: fleet elastic's restart contract — the launcher SIGTERMs
workers on membership change and relaunches them; a worker that dies
mid-step loses everything since its last save.  On shared clusters
preemption is routine (maintenance events deliver SIGTERM with a grace
window), so the handler converts the signal into a *request flag* the
training loop polls at step boundaries: the step in flight completes,
the state is saved crash-consistently, and the process exits 0 so the
launcher restarts it into ``resume``.

Also plugs into ElasticManager: ``handler.as_elastic_on_change()`` is an
``on_change`` callback (membership shrank -> checkpoint-then-exit, the
restart side of the manager's contract).
"""
from __future__ import annotations

import signal
import threading
from typing import Any, Callable, Dict, Optional

__all__ = ["PreemptionHandler", "GracefulExit"]

_DEFAULT_SIGNALS = (signal.SIGTERM, signal.SIGINT)


class GracefulExit(SystemExit):
    """Raised (with code 0) by checkpoint_and_exit once the state is on
    disk — a clean exit the launcher treats as restartable."""

    def __init__(self):
        super().__init__(0)


class PreemptionHandler:
    def __init__(self, signals=_DEFAULT_SIGNALS):
        self._signals = tuple(signals)
        self._requested = threading.Event()
        self._prev: Dict[int, Any] = {}
        self._installed = False

    # -- lifecycle -------------------------------------------------------
    def install(self):
        """Install signal handlers (main thread only — Python's signal
        contract).  Idempotent; pairs with uninstall()."""
        if self._installed:
            return self
        for s in self._signals:
            self._prev[s] = signal.signal(s, self._on_signal)
        self._installed = True
        return self

    def uninstall(self):
        if not self._installed:
            return
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()
        self._installed = False

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False

    def _on_signal(self, signum, frame):
        self._requested.set()

    # -- request surface -------------------------------------------------
    @property
    def requested(self) -> bool:
        return self._requested.is_set()

    def request(self, *_args, **_kw):
        """Programmatic preemption request (same path the signals take).
        Accepts and ignores arguments so it can sit directly behind
        callback contracts."""
        self._requested.set()

    def clear(self):
        self._requested.clear()

    def as_elastic_on_change(self) -> Callable:
        """An ElasticManager ``on_change`` callback: any membership change
        requests checkpoint-then-clean-exit at the next step boundary (the
        relaunch brings this worker back with the rescaled spec)."""
        return self.request

    # -- step-boundary service ------------------------------------------
    def checkpoint_and_exit_if_requested(self, manager, train_state,
                                         step: int, epoch: int = 0,
                                         position: Optional[dict] = None):
        """Poll at a step boundary: when a preemption was requested, save
        synchronously (the process is about to die — async gains nothing)
        and raise GracefulExit(0).  No-op otherwise."""
        if not self.requested:
            return
        pos = dict(position or {})
        pos.setdefault("epoch", epoch)
        pos.setdefault("step", step)
        manager.save(train_state.capture(position=pos), step=step,
                     epoch=epoch, meta={"preempted": True}, blocking=True)
        raise GracefulExit()
