"""Serve-path telemetry for the generation service (models/serve.py):
per-request spans and the serving series, standard library only.

The request lifecycle maps to spans

    admit (validate + right-pad) -> queue (service-lock wait) ->
    prefill (prompt pass, ends when the FIRST token is on the host) ->
    decode (the loop + device->host fetch)

kept in a bounded ring buffer that ``/debug/traces`` serves.  TTFT is
observed when the prefill span closes (arrival -> first token on the
host); per-token latency is decode seconds per token past the first.
The series keep the reference's names and help text
(``kubeflow_tpu/telemetry/serve.py``).  Under the continuous-batching
scheduler (``models/scheduler.py``) queue depth counts prompt rows not
yet holding a decode slot, the fill ratio is occupied slots over the
pool once a quantum, and admitted == evicted + active slots at every
instant; on the lock path queue depth counts lock waiters and the fill
ratio is request rows over ``max_batch_rows``.
"""
from __future__ import annotations

import collections
import itertools
import json
import logging
import os
import threading
import time
from contextlib import contextmanager, nullcontext
from typing import Dict, List, Optional

from kubeflow_tpu_torch import config
from kubeflow_tpu_torch.telemetry.metrics import Counter, Gauge, Histogram

# Requests at or above this wall time dump their span tree as one JSON log
# line (kubeflow_tpu_torch.serve.trace logger).
SLOW_REQUEST_SECONDS = config.env_float("SERVE_SLOW_REQUEST_SECONDS", 30.0)

_LATENCY_BUCKETS = (0.01, 0.05, 0.2, 1.0, 5.0, 20.0, 60.0, 180.0)
_TOKEN_BUCKETS = (0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0)

_request_ids = itertools.count(1)
_trace_prefix = os.urandom(8).hex()
_trace_ids = itertools.count(1)


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
    def __init__(self, component: str, name: str):
        self.trace_id = f"{_trace_prefix}{next(_trace_ids):016x}"
        self.component = component
        self.name = name
        self.start_ts = time.time()
        self.t0 = time.perf_counter()
        self.spans: List[Span] = []
        self.result = ""

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "component": self.component,
            "request": self.name,
            "start_ts": round(self.start_ts, 3),
            "duration_ms": round((time.perf_counter() - self.t0) * 1e3, 3),
            "result": self.result,
            "spans": [s.to_dict() for s in self.spans],
        }


class Tracer:
    """Thread-carried request traces with a bounded ring buffer of the
    finished ones; traces slower than a threshold are logged as one JSON
    line."""

    def __init__(self, component: str, *, buffer_size: int = 64,
                 logger: str = "kubeflow_tpu_torch.serve.trace"):
        self.component = component
        self.log = logging.getLogger(logger)
        self._local = threading.local()
        self._lock = threading.Lock()
        self._recent: collections.deque = collections.deque(
            maxlen=buffer_size)

    def begin(self, name: str) -> Trace:
        tr = Trace(self.component, name)
        self._local.trace = tr
        return tr

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
        tr.result = result
        d = tr.to_dict()
        with self._lock:
            self._recent.append(d)
        if slow_seconds is not None and d["duration_ms"] >= slow_seconds * 1e3:
            self.log.warning("slow serve request trace: %s",
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


class ServeTelemetry:
    """Instruments + tracer for one serving app, registered in the app's
    own registry.  Safe to call from concurrent request threads."""

    def __init__(self, registry, *, component: str = "model-serve"):
        self.component = component
        self.tracer = Tracer(
            component,
            buffer_size=config.env_int("SERVE_TRACE_BUFFER_SIZE", 64))
        self.queue_depth = Gauge(
            "serve_queue_depth",
            "Prompt rows pending in the continuous-batching scheduler "
            "queue (not yet holding a decode slot); on the lock-"
            "serialized fallback path, requests waiting on the "
            "generation lock", registry=registry)
        self.batch_rows = Histogram(
            "serve_batch_rows", "Rows admitted per generation request",
            registry=registry, buckets=(1, 2, 4, 8, 16, 32, 64, 128))
        self.batch_fill_ratio = Histogram(
            "serve_batch_fill_ratio",
            "Per-decode-step slot occupancy under the scheduler (active "
            "slots over the pool size, observed once per decode "
            "quantum); on the lock path, request rows over "
            "max_batch_rows", registry=registry,
            buckets=(0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0))
        self.scheduler_admitted = Counter(
            "serve_scheduler_admitted_rows_total",
            "Prompt rows admitted into the decode slot pool (prefilled "
            "and scheduled for decoding)", registry=registry)
        self.scheduler_evicted = Counter(
            "serve_scheduler_evicted_rows_total",
            "Rows evicted from the slot pool (EOS or budget exhausted); "
            "admitted == evicted + serve_decode_slots_active at all "
            "times", registry=registry)
        self.slots_active = Gauge(
            "serve_decode_slots_active",
            "Decode slots currently occupied by in-flight rows",
            registry=registry)
        self.slots_total = Gauge(
            "serve_decode_slots", "Decode slot pool size (KFT_SERVE_SLOTS)",
            registry=registry)
        self.ttft = Histogram(
            "serve_time_to_first_token_seconds",
            "Request arrival to the first generated token host-visible "
            "(admit + queue wait + prefill)", registry=registry,
            buckets=_LATENCY_BUCKETS)
        self.per_token = Histogram(
            "serve_per_token_seconds",
            "Decode seconds per generated token past the first (one "
            "observation per request)", registry=registry,
            buckets=_TOKEN_BUCKETS)
        self.input_tokens = Counter(
            "serve_input_tokens_total", "Prompt tokens received",
            registry=registry)
        self.output_tokens = Counter(
            "serve_output_tokens_total",
            "Tokens generated (counted through the first EOS per row, "
            "excluding post-EOS padding)", registry=registry)

    def begin_request(self) -> Trace:
        return self.tracer.begin(f"req-{next(_request_ids)}")

    def span(self, name: str, **attrs):
        return self.tracer.span(name, **attrs)

    def finish_request(self, result: str) -> Optional[dict]:
        return self.tracer.finish(result, slow_seconds=SLOW_REQUEST_SECONDS)


def span_or_null(tel: Optional[ServeTelemetry], name: str, **attrs):
    """A telemetry span, or a no-op for an un-instrumented service."""
    return tel.span(name, **attrs) if tel is not None else nullcontext()


def filter_traces(traces: List[dict], *, n: Optional[int] = None,
                  trace_id: Optional[str] = None) -> List[dict]:
    """The ``/debug/traces`` query: ``trace_id`` matches exactly, then
    ``n`` keeps the newest n matches (n <= 0 returns nothing)."""
    if trace_id:
        traces = [t for t in traces if t.get("trace_id") == trace_id]
    if n is not None:
        traces = traces[-n:] if n > 0 else []
    return traces
