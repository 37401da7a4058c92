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
ratio is request rows over ``max_batch_rows``.  Under the paged engine
(``models/paged.py``) pages are counted by state, and the prefix cache's
hits and misses and the speculative proposals and acceptances are
counted too.
"""
from __future__ import annotations

import itertools
from contextlib import nullcontext
from typing import Dict, List, Optional

from kubeflow_tpu_torch.platform import config
from kubeflow_tpu_torch.telemetry import causal
from kubeflow_tpu_torch.telemetry.metrics import Counter, Gauge, Histogram
from kubeflow_tpu_torch.telemetry.trace import Trace, Tracer

# Requests at or above this wall time dump their span tree as one JSON log
# line (kubeflow_tpu_torch.serve.trace logger).
SLOW_REQUEST_SECONDS = config.env_float("SERVE_SLOW_REQUEST_SECONDS", 30.0)

_LATENCY_BUCKETS = (0.01, 0.05, 0.2, 1.0, 5.0, 20.0, 60.0, 180.0)
_TOKEN_BUCKETS = (0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0)

_request_ids = itertools.count(1)


class ServeTelemetry:
    """Instruments + tracer for one serving app, registered in the app's
    own registry.  Safe to call from concurrent request threads."""

    def __init__(self, registry, *, component: str = "model-serve"):
        self.component = component
        self.tracer = Tracer(
            component,
            buffer_size=config.env_int("SERVE_TRACE_BUFFER_SIZE", 64),
            logger="kubeflow_tpu_torch.serve.trace",
            slow_message="slow serve request trace")
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
        # The paged engine (models/paged.py).  Balance: free + active +
        # shared == pages_total - 1 (the null page is in no state) at all
        # times, active returns to 0 when the pool drains, and accepted
        # <= proposed.
        self.kv_pages = Gauge(
            "serve_kv_pages",
            "Physical KV pages by state under the paged pool: free (in "
            "the allocator), active (held by live/pending rows only), "
            "shared (resident in the prefix cache); the reserved null "
            "page is counted in none of them", ["state"], registry=registry)
        self.kv_page_fragmentation = Gauge(
            "serve_kv_page_fragmentation_ratio",
            "Reserved-but-unwritten fraction of live rows' paged-KV "
            "capacity (0 = every reserved page position holds a real "
            "token; the fixed-slot pool's longest-bucket tax made "
            "visible)", registry=registry)
        self.prefix_cache_hits = Counter(
            "serve_prefix_cache_hits_total",
            "Prompt pages served read-only from the prefix cache "
            "instead of prefilling", registry=registry)
        self.prefix_cache_misses = Counter(
            "serve_prefix_cache_misses_total",
            "Lookup-eligible prompt pages that had to prefill (no "
            "cached prefix page matched)", registry=registry)
        self.spec_proposed = Counter(
            "serve_spec_decode_proposed_tokens_total",
            "Draft-model tokens proposed across speculative-decoding "
            "steps", registry=registry)
        self.spec_accepted = Counter(
            "serve_spec_decode_accepted_tokens_total",
            "Proposed draft tokens accepted by target-model "
            "verification (accepted <= proposed; the bonus token per "
            "step is not counted)", registry=registry)
        self.page_pool_shards = Gauge(
            "serve_page_pool_shards",
            "Shards the paged-KV pool axis splits into over the serving "
            "mesh's data axes (1 = unsharded/replicated pool; set when "
            "the pool is built)", registry=registry)
        self.dispatch_overlap = Gauge(
            "serve_dispatch_overlap_ratio",
            "Fraction of each decode dispatch->harvest cycle the "
            "scheduler host thread was NOT blocked on device results "
            "(cumulative since start; the synchronous loop spends the "
            "whole quantum blocked, pipelined dispatch hides the wait "
            "behind bookkeeping)", registry=registry)
        self.paged_fallback = Counter(
            "serve_paged_fallback_total",
            "Times the service routed to the fixed-slot scheduler "
            "instead of the paged engine, by structured reason "
            "(env-disabled = KFT_SERVE_PAGED=0, spec-decode-mesh = "
            "draft model under a mesh); /debug/serve carries the "
            "human-readable detail", ["reason"], registry=registry)

    def begin_request(self) -> Trace:
        """Start the request's trace; a caller's context (the app installs
        a ``traceparent`` header as the thread's current context) is
        linked as ``causal_trace_id``/``causal_span_id``."""
        tr = self.tracer.begin(f"req-{next(_request_ids)}")
        ctx = causal.current()
        if tr is not None and ctx is not None:
            tr.links["causal_trace_id"] = ctx.trace_id
            tr.links["causal_span_id"] = ctx.span_id
        return tr

    def span(self, name: str, **attrs):
        return self.tracer.span(name, **attrs)

    def finish_request(self, result: str) -> Optional[dict]:
        return self.tracer.finish(result, slow_seconds=SLOW_REQUEST_SECONDS)


def span_or_null(tel: Optional[ServeTelemetry], name: str, **attrs):
    """A telemetry span, or a no-op for an un-instrumented service."""
    return tel.span(name, **attrs) if tel is not None else nullcontext()


def filter_traces(traces: List[dict], *, n: Optional[int] = None,
                  trace_id: Optional[str] = None,
                  **fields: Optional[str]) -> List[dict]:
    """The ``/debug/traces`` query of a replica and of the controllers'
    health port: ``trace_id`` matches a trace's own id or its
    ``causal_trace_id`` link, extra ``fields`` (``controller=``) match
    exactly, then ``n`` keeps the newest n matches (n <= 0 returns
    nothing)."""
    if trace_id:
        traces = [t for t in traces if t.get("trace_id") == trace_id
                  or t.get("causal_trace_id") == trace_id]
    for key, want in fields.items():
        if want:
            traces = [t for t in traces if t.get(key) == want]
    if n is not None:
        traces = traces[-n:] if n > 0 else []
    return traces
