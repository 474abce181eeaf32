"""Host-side span tracer with Chrome-trace/Perfetto export.

A copy of ``paddle_tpu/telemetry/trace.py``.  Host spans are recorded in
a ring buffer, and each span *nests a* ``torch.profiler.record_function``
range where the JAX copy nests ``jax.profiler.TraceAnnotation`` -- so
under an active ``torch.profiler`` capture the same named ranges appear
beside the CUDA kernels on the trace timeline (``annotate=False`` turns
the nesting off).

Contract (docs/observability.md):

- **near-zero disabled path** — ``span()`` reads ONE module global; when
  no tracer is active it returns a shared no-op context manager, so the
  serving step's phase spans cost one global read when tracing is off.
- **thread-aware** — spans record the OS thread id + thread name at
  exit, so spans from several threads interleave correctly in the
  exported trace (one Chrome-trace row per thread).
- **ring-buffered** — a bounded deque (default 65536 spans); overflow
  drops the OLDEST spans and counts them in ``Tracer.dropped`` (the
  newest spans are the ones a post-mortem export wants).
- **metadata** — ``span(name, **args)`` attaches JSON-safe args.

Export: ``export_chrome_trace(path)`` writes the standard
``{"traceEvents": [...]}`` JSON (``ph="X"`` complete events in
microseconds + ``ph="M"`` thread-name metadata) that chrome://tracing
and https://ui.perfetto.dev open directly.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

__all__ = [
    "Span", "Tracer", "enable", "disable", "active", "span", "traced",
    "export_chrome_trace", "summarize", "format_summary",
]


class Span:
    """One completed host range."""

    __slots__ = ("name", "t0_ns", "dur_ns", "tid", "thread_name", "args")

    def __init__(self, name: str, t0_ns: int, dur_ns: int, tid: int,
                 thread_name: str, args: Optional[Dict[str, Any]]):
        self.name = name
        self.t0_ns = t0_ns
        self.dur_ns = dur_ns
        self.tid = tid
        self.thread_name = thread_name
        self.args = args

    def __repr__(self):
        return (f"Span({self.name!r}, {self.dur_ns / 1e6:.3f} ms, "
                f"tid={self.tid})")


class _NullSpan:
    """Shared disabled-path context manager (no per-call allocation
    beyond the kwargs dict python builds for ``span(**args)``)."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _NullSpan()

#: the active tracer, or None — ONE global read is the disabled fast path
_tracer: Optional["Tracer"] = None

#: tid -> thread name, filled on first span per thread —
#: ``threading.get_ident()`` is ~5x cheaper than ``current_thread()``
#: and the enabled record path runs per span.  A rename after the first
#: span keeps the old label; the trace cares about identity, not names.
_thread_names: Dict[int, str] = {}


def _thread_info() -> tuple:
    tid = threading.get_ident()
    name = _thread_names.get(tid)
    if name is None:
        name = threading.current_thread().name
        _thread_names[tid] = name
    return tid, name


class Tracer:
    def __init__(self, capacity: int = 65536, annotate: bool = True):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self._buf: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self.dropped = 0
        self.annotate = bool(annotate)
        self._ann_cls = None
        if self.annotate:
            import torch

            self._ann_cls = torch.profiler.record_function

    def record(self, s: Span):
        # lock-free: deque.append with maxlen is atomic under the GIL
        # and auto-evicts the oldest span; the dropped counter is
        # best-effort under concurrent writers (the record path runs
        # once per span on every instrumented hot loop)
        buf = self._buf
        if len(buf) == self.capacity:
            self.dropped += 1
        buf.append(s)

    def spans(self) -> List[Span]:
        return list(self._buf)

    def clear(self):
        with self._lock:
            self._buf.clear()
            self.dropped = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)


class _SpanCtx:
    __slots__ = ("_tracer", "_name", "_args", "_t0", "_ann")

    def __init__(self, tracer: Tracer, name: str,
                 args: Optional[Dict[str, Any]]):
        self._tracer = tracer
        self._name = name
        self._args = args or None

    def __enter__(self):
        ann_cls = self._tracer._ann_cls
        if ann_cls is not None:
            self._ann = ann_cls(self._name)
            self._ann.__enter__()
        else:
            self._ann = None
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter_ns() - self._t0
        if self._ann is not None:
            self._ann.__exit__(None, None, None)
        tid, tname = _thread_info()
        self._tracer.record(Span(self._name, self._t0, dur,
                                 tid, tname, self._args))
        return False


def enable(capacity: int = 65536, annotate: bool = True) -> Tracer:
    """Install a process-wide tracer (idempotent: an already-active
    tracer is returned unchanged so nested enables compose)."""
    global _tracer
    if _tracer is None:
        _tracer = Tracer(capacity=capacity, annotate=annotate)
    return _tracer


def disable() -> Optional[Tracer]:
    """Deactivate tracing.  Returns the detached tracer — its buffered
    spans stay readable/exportable after deactivation."""
    global _tracer
    t, _tracer = _tracer, None
    return t


def active() -> Optional[Tracer]:
    return _tracer


def span(name: str, **args):
    """Context manager recording a host span named ``name`` with
    JSON-safe ``args`` metadata.  Near-zero no-op when disabled."""
    t = _tracer
    if t is None:
        return _NOOP
    return _SpanCtx(t, name, args)


def traced(name: Optional[str] = None) -> Callable:
    """Decorator form of :func:`span`.

    ``@traced()`` uses the function's qualified name; ``@traced("x")``
    overrides it.  The disabled path adds one global read + one ``if``.
    """

    def deco(fn):
        label = name or getattr(fn, "__qualname__",
                                getattr(fn, "__name__", "fn"))

        def wrapper(*a, **kw):
            t = _tracer
            if t is None:
                return fn(*a, **kw)
            with _SpanCtx(t, label, None):
                return fn(*a, **kw)

        wrapper.__name__ = getattr(fn, "__name__", "wrapper")
        wrapper.__qualname__ = getattr(fn, "__qualname__", wrapper.__name__)
        wrapper.__doc__ = fn.__doc__
        wrapper.__wrapped__ = fn
        return wrapper

    return deco


# ---------------------------------------------------------------------------
# export + aggregation
# ---------------------------------------------------------------------------

def export_chrome_trace(path: Optional[str] = None,
                        tracer: Optional[Tracer] = None) -> Dict[str, Any]:
    """Build (and optionally write) the Chrome-trace JSON document for
    ``tracer`` (default: the active one).  The document opens directly in
    chrome://tracing and https://ui.perfetto.dev; nesting is positional
    (``ph="X"`` complete events on the same pid/tid nest by interval
    containment)."""
    tr = tracer if tracer is not None else _tracer
    spans = tr.spans() if tr is not None else []
    pid = os.getpid()
    events: List[Dict[str, Any]] = []
    threads_seen: Dict[int, str] = {}
    for s in spans:
        if s.tid not in threads_seen:
            threads_seen[s.tid] = s.thread_name
    for tid, tname in sorted(threads_seen.items()):
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": tid, "args": {"name": tname}})
    for s in spans:
        ev: Dict[str, Any] = {
            "name": s.name, "ph": "X", "cat": "host", "pid": pid,
            "tid": s.tid, "ts": s.t0_ns / 1000.0, "dur": s.dur_ns / 1000.0,
        }
        if s.args:
            ev["args"] = s.args
        events.append(ev)
    doc = {"traceEvents": events, "displayTimeUnit": "ms",
           "otherData": {"dropped_spans": tr.dropped if tr else 0}}
    if path:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
    return doc


def summarize(spans: Optional[List[Span]] = None,
              tracer: Optional[Tracer] = None) -> Dict[str, Dict[str, float]]:
    """Per-name aggregation over ``spans`` (default: the given/active
    tracer's buffer): count, total/mean/p50/p99/max milliseconds.

    Exact (sorted durations), not bucketed — the ring buffer bounds the
    working set."""
    if spans is None:
        tr = tracer if tracer is not None else _tracer
        spans = tr.spans() if tr is not None else []
    by_name: Dict[str, List[int]] = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s.dur_ns)
    out: Dict[str, Dict[str, float]] = {}
    for name, durs in sorted(by_name.items()):
        durs.sort()
        n = len(durs)

        def pct(q):
            return durs[min(int(q * n), n - 1)] / 1e6

        out[name] = {
            "count": n,
            "total_ms": sum(durs) / 1e6,
            "mean_ms": sum(durs) / n / 1e6,
            "p50_ms": pct(0.50),
            "p99_ms": pct(0.99),
            "max_ms": durs[-1] / 1e6,
        }
    return out


def format_summary(stats: Dict[str, Dict[str, float]]) -> str:
    """Human-readable table of :func:`summarize` output."""
    if not stats:
        return "no spans recorded"
    rows = [("name", "count", "total ms", "mean ms", "p50 ms", "p99 ms")]
    for name, st in sorted(stats.items(), key=lambda kv: -kv[1]["total_ms"]):
        rows.append((name, str(st["count"]), f"{st['total_ms']:.3f}",
                     f"{st['mean_ms']:.3f}", f"{st['p50_ms']:.3f}",
                     f"{st['p99_ms']:.3f}"))
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    lines = []
    for i, r in enumerate(rows):
        lines.append("  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip())
        if i == 0:
            lines.append("  ".join("-" * w for w in widths))
    return "\n".join(lines)
