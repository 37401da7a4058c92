"""Span traces, standard library only, shared by the serving app's
request traces (``telemetry/serve.py``) and the training loop's step
traces (``telemetry/compute.py``): the active trace rides a thread-local,
so spans opened anywhere below attach without a context argument;
finished traces land in a bounded ring buffer (``/debug/traces`` serves a
service's); a trace slower than the caller's threshold is logged as one
JSON line.  The port's copy of ``kubeflow_tpu/telemetry/trace.py``.

A tracer is the sampling profiler's attribution seam
(``telemetry/profiler.py``): while a trace is active, samples of its
thread fold under the tracer's component (the serving model, ``train``);
a slow trace's dump names the profile window that covered it
(``profile_window``).  A trace's ``links`` are merged into its dict: a
request that came with a ``traceparent`` carries ``causal_trace_id`` and
``causal_span_id`` (``telemetry/serve.py``), a reconcile the context of
the watch event that caused it (``platform/runtime/controller.py``).
A tracer's ``keys`` name the two identity fields of its dicts:
``("controller", "request")`` for the control plane's reconcile traces
(``platform/runtime/trace.py``), ``("component", "request")`` elsewhere.
"""
from __future__ import annotations

import collections
import json
import logging
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

from kubeflow_tpu_torch.telemetry import causal, profiler


class Span:
    __slots__ = ("name", "offset_s", "duration_s", "attrs")

    def __init__(self, name: str, offset_s: float, attrs: Dict):
        self.name = name
        self.offset_s = offset_s
        self.duration_s = 0.0
        self.attrs = attrs

    def to_dict(self) -> dict:
        d = {"name": self.name,
             "offset_ms": round(self.offset_s * 1e3, 3),
             "duration_ms": round(self.duration_s * 1e3, 3)}
        d.update(self.attrs)
        return d


class Trace:
    def __init__(self, component: str, name: str,
                 keys: Tuple[str, str] = ("component", "request")):
        self.trace_id = causal.new_trace_id()
        self.component = component
        self.name = name
        self.keys = keys
        self.start_ts = time.time()
        self.t0 = time.perf_counter()
        self.spans: List[Span] = []
        self.result = ""
        self.links: Dict[str, str] = {}

    def add_span(self, name: str, *, duration_s: float,
                 offset_s: float = 0.0, **attrs) -> Span:
        """Record a span measured before the trace began (a queue wait)."""
        sp = Span(name, offset_s, attrs)
        sp.duration_s = duration_s
        self.spans.append(sp)
        return sp

    def to_dict(self) -> dict:
        d = {
            "trace_id": self.trace_id,
            self.keys[0]: self.component,
            self.keys[1]: self.name,
            "start_ts": round(self.start_ts, 3),
            "duration_ms": round((time.perf_counter() - self.t0) * 1e3, 3),
            "result": self.result,
            "spans": [s.to_dict() for s in self.spans],
        }
        d.update(self.links)
        return d


class Tracer:
    """Thread-carried traces with a bounded ring buffer of the finished
    ones; traces slower than a threshold are logged as one JSON line,
    ``slow_message: {...}``."""

    def __init__(self, component: str, *, buffer_size: int = 64,
                 keys: Tuple[str, str] = ("component", "request"),
                 logger: str = "kubeflow_tpu_torch.trace",
                 slow_message: str = "slow trace"):
        self.component = component
        self.keys = keys
        self.slow_message = slow_message
        self.log = logging.getLogger(logger)
        self._local = threading.local()
        self._lock = threading.Lock()
        self._recent: collections.deque = collections.deque(
            maxlen=buffer_size)

    def begin(self, name: str, *, enabled: bool = True,
              component: Optional[str] = None) -> Optional[Trace]:
        """Start a trace on this thread, dropping any stale one (None when
        not ``enabled``: spans are then no-ops), and point the thread's
        profile samples at the component (``component``, else the
        tracer's)."""
        component = component or self.component
        tr = Trace(component, name, self.keys) if enabled else None
        self._local.trace = tr
        if tr is None:
            profiler.clear_active_role()
        else:
            profiler.set_active_role(component)
        return tr

    def current(self) -> Optional[Trace]:
        return getattr(self._local, "trace", None)

    def adopt(self, tr: Optional[Trace]) -> None:
        """Install an existing trace as this thread's (a fan-out slot's
        spans land in the submitting reconcile's trace), its component
        as the thread's profile role."""
        self._local.trace = tr
        profiler.set_active_role(tr.component if tr is not None else None)

    @contextmanager
    def span(self, name: str, **attrs):
        tr = getattr(self._local, "trace", None)
        if tr is None:
            yield None
            return
        t0 = time.perf_counter()
        sp = Span(name, t0 - tr.t0, attrs)
        try:
            yield sp
        finally:
            sp.duration_s = time.perf_counter() - t0
            tr.spans.append(sp)

    def finish(self, result: str, *,
               slow_seconds: Optional[float] = None) -> Optional[dict]:
        tr = getattr(self._local, "trace", None)
        if tr is None:
            return None
        self._local.trace = None
        profiler.clear_active_role()
        tr.result = result
        d = tr.to_dict()
        slow = (slow_seconds is not None
                and d["duration_ms"] >= slow_seconds * 1e3)
        if slow:
            wid = profiler.covering_window_id()
            if wid is not None:
                d["profile_window"] = wid
        with self._lock:
            self._recent.append(d)
        if slow:
            self.log.warning("%s: %s", self.slow_message,
                             json.dumps(d, sort_keys=True))
        return d

    def recent(self, n: Optional[int] = None) -> List[dict]:
        """Finished traces, newest last; ``n`` keeps the newest n (n <= 0
        returns nothing)."""
        with self._lock:
            out = list(self._recent)
        if n is None:
            return out
        return out[-n:] if n > 0 else []

    def clear(self) -> None:
        with self._lock:
            self._recent.clear()
