"""Causal trace context: W3C traceparent parsing, the thread's current
context, the context an object carries, and the span store of journeys.
Standard library only.

The port's copy of ``kubeflow_tpu/telemetry/causal.py``.  A serving
replica parses a caller's
``traceparent`` header (``models/serve.py``), installs it as the
request thread's current context with ``use`` and links it into the
request trace as ``causal_trace_id``/``causal_span_id``
(``telemetry/serve.py``).  The control plane rides the context on the
objects: a platform CR is stamped at first admission
(``mint_on_admission``, the ``kubeflow.org/traceparent`` and
``kubeflow.org/tracestate`` annotations), the children a reconciler
writes through ``platform/runtime/apply.py`` get a child context of
the reconcile's (``stamp_child``), and each child write's round trip
is a ``write_rtt`` span in the process's store (``record_write``,
``journey``).  The controller runtime (``platform/runtime/
controller.py``) measures each stamp's first watch delivery as a
``watch_lag`` span (``first_lag_observation``, bounded by
``WATCH_LAG_MAX_S``) and arms a reconcile without a delivered context
with a lazy factory (``set_lazy``), resolved only when the reconcile
writes.  ``merge_journeys`` joins the journeys of several replicas (a
sharded fleet's) into one timeline.

Ids are a per-process random block plus a counter: one ``secrets`` read a
process, ids unique within it by the counter and across processes by the
random block.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import re
import secrets
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

from kubeflow_tpu_torch.platform import config

TRACEPARENT_ANNOTATION = "kubeflow.org/traceparent"
TRACESTATE_ANNOTATION = "kubeflow.org/tracestate"
TRACEPARENT_HEADER = "traceparent"

# A context-free object of the platform's own API group (a Notebook) is
# a journey's root, minted at first admission; core kinds are stamped by
# ``platform/runtime/apply.py`` from their parent's context.
MINT_API_GROUP = "kubeflow.org"

# The span store's size (spans, one ring a process) and its off switch.
JOURNEY_BUFFER_SIZE = config.knob(
    "JOURNEY_BUFFER_SIZE", 8192, int,
    doc="causal span store size (spans, process-wide ring)")
# A watch_lag longer than this is a replay of an object stamped long
# before (a handler's ADDED replay, a relist), not a lag: no span.
WATCH_LAG_MAX_S = config.knob(
    "JOURNEY_WATCH_LAG_MAX_SECONDS", 60.0, float,
    doc="watch_lag spans longer than this are dropped as replays")
ENABLED = not config.env_bool("JOURNEY_DISABLE", False)

_TRACEPARENT_RE = re.compile(
    r"^[0-9a-f]{2}-([0-9a-f]{32})-([0-9a-f]{16})-[0-9a-f]{2}$")
_TS_RE = re.compile(r"kft=ts:([0-9.]+)")

_rand = secrets.token_bytes(24)
_trace_base = int.from_bytes(_rand[:16], "big")
_span_base = int.from_bytes(_rand[16:], "big")
_counter = itertools.count()


def new_trace_id() -> str:
    """A 128-bit trace id, 32 hex digits."""
    return f"{(_trace_base + next(_counter)) & ((1 << 128) - 1):032x}"


def new_span_id() -> str:
    """A 64-bit span id, 16 hex digits."""
    return f"{(_span_base + next(_counter)) & ((1 << 64) - 1):016x}"


@dataclasses.dataclass(frozen=True)
class TraceContext:
    trace_id: str
    span_id: str
    # When the context was stamped onto an object (the reference's
    # tracestate); None for a context from a header.
    stamped_ts: Optional[float] = None

    def to_traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-01"


def mint() -> TraceContext:
    return TraceContext(new_trace_id(), new_span_id())


def child(ctx: TraceContext) -> TraceContext:
    """The same trace with a fresh span id."""
    return TraceContext(ctx.trace_id, new_span_id())


def parse_traceparent(value: Optional[str]) -> Optional[TraceContext]:
    """A ``traceparent`` header's context; None for a missing or malformed
    header (surrounding whitespace and upper-case hex are accepted)."""
    if not value:
        return None
    m = _TRACEPARENT_RE.match(value.strip().lower())
    if m is None:
        return None
    return TraceContext(m.group(1), m.group(2))


_local = threading.local()


def current() -> Optional[TraceContext]:
    """The thread's current context (None when none is installed).  A
    lazy factory (``set_lazy``) resolves here, once, on first use."""
    ctx = getattr(_local, "ctx", None)
    if ctx is not None:
        return ctx
    factory = getattr(_local, "ctx_factory", None)
    if factory is not None:
        _local.ctx_factory = None  # one shot, even when it answers None
        ctx = factory()
        _local.ctx = ctx
    return ctx


def current_resolved() -> Optional[TraceContext]:
    """The current context only if already resolved: never runs a lazy
    factory (did the reconcile use its context?)."""
    return getattr(_local, "ctx", None)


def set_current(ctx: Optional[TraceContext]) -> None:
    _local.ctx = ctx
    _local.ctx_factory = None


def set_lazy(factory) -> None:
    """Install a zero-argument context factory that ``current`` resolves
    on its first call, so a reconcile that writes nothing derives no
    context."""
    _local.ctx = None
    _local.ctx_factory = factory


def current_traceparent() -> Optional[str]:
    ctx = current()
    return ctx.to_traceparent() if ctx is not None else None


@contextmanager
def use(ctx: Optional[TraceContext]):
    """Install ``ctx`` as the current context for the block, restoring the
    previous one after it (a no-op on None, so callers wrap
    unconditionally)."""
    if ctx is None:
        yield None
        return
    prev = current()
    set_current(ctx)
    try:
        yield ctx
    finally:
        set_current(prev)


# -- the object annotation contract ------------------------------------------


def _annotations(obj) -> Dict:
    md = obj.get("metadata") if hasattr(obj, "get") else None
    if md is None:
        return {}
    return md.get("annotations") or {}


def from_object(obj) -> Optional[TraceContext]:
    """The context an object carries, with its stamp time; reads only, so
    a frozen cache view will do."""
    ann = _annotations(obj)
    ctx = parse_traceparent(ann.get(TRACEPARENT_ANNOTATION))
    if ctx is None:
        return None
    m = _TS_RE.search(ann.get(TRACESTATE_ANNOTATION) or "")
    if m is not None:
        try:
            return dataclasses.replace(ctx, stamped_ts=float(m.group(1)))
        except ValueError:
            pass
    return ctx


def stamp(obj, ctx: Optional[TraceContext] = None) -> Optional[TraceContext]:
    """Write ``ctx`` (default: a fresh mint) into the object's annotations
    with the stamp's wall time.  Returns the stamped context; None when
    the object is immutable (a frozen view)."""
    if ctx is None:
        ctx = mint()
    ctx = dataclasses.replace(ctx, stamped_ts=round(time.time(), 6))
    try:
        ann = obj.setdefault("metadata", {}).setdefault("annotations", {})
        ann[TRACEPARENT_ANNOTATION] = ctx.to_traceparent()
        ann[TRACESTATE_ANNOTATION] = f"kft=ts:{ctx.stamped_ts}"
    except (TypeError, AttributeError):
        return None
    return ctx


def stamp_child(obj) -> Optional[TraceContext]:
    """Stamp an object a reconciler writes: a child of the current
    (reconcile) context when one is installed, else the first-admission
    rule."""
    cur = current()
    if cur is not None:
        return stamp(obj, child(cur))
    return mint_on_admission(obj)


def mint_on_admission(obj) -> Optional[TraceContext]:
    """First-admission minting, as the API server's create path runs it:
    an object that carries a context keeps it; a context-free object of
    ``MINT_API_GROUP`` is stamped from the current context or a fresh
    mint; other groups pass untouched."""
    existing = from_object(obj)
    if existing is not None:
        return existing
    api = obj.get("apiVersion", "") if hasattr(obj, "get") else ""
    if not str(api).startswith(MINT_API_GROUP + "/"):
        return None
    cur = current()
    return stamp(obj, child(cur) if cur is not None else mint())


def stamped_copy_on_admission(obj):
    """``mint_on_admission`` for a caller that must not mutate its input
    (the REST client serializing a caller's dict or a frozen view): the
    object itself when no mint applies, else a shallow copy with copied
    metadata and annotations carrying the stamp."""
    if from_object(obj) is not None:
        return obj
    api = obj.get("apiVersion", "") if hasattr(obj, "get") else ""
    if not str(api).startswith(MINT_API_GROUP + "/"):
        return obj
    out = dict(obj)
    md = dict(out.get("metadata") or {})
    md["annotations"] = dict(md.get("annotations") or {})
    out["metadata"] = md
    cur = current()
    stamp(out, child(cur) if cur is not None else mint())
    return out


def annotations_of(obj) -> Dict[str, str]:
    """The two causal annotations an object carries (for patches that
    restamp beside a generated-hash annotation)."""
    ann = _annotations(obj)
    return {k: ann[k] for k in (TRACEPARENT_ANNOTATION,
                                TRACESTATE_ANNOTATION) if k in ann}


# -- the span store -----------------------------------------------------------


class SpanStore:
    """A bounded store of causal spans; a journey is a scan of the ring by
    trace id."""

    def __init__(self, maxlen: int = JOURNEY_BUFFER_SIZE):
        self._lock = threading.Lock()
        self._spans: collections.deque = collections.deque(
            maxlen=max(int(maxlen), 16))

    def record(self, name: str, *, trace_id: str,
               span_id: Optional[str] = None,
               parent_span_id: Optional[str] = None,
               segment: Optional[str] = None,
               start_ts: float, end_ts: float, **attrs) -> dict:
        span = {
            "name": name,
            "trace_id": trace_id,
            "span_id": span_id or new_span_id(),
            "start_ts": round(start_ts, 6),
            "end_ts": round(end_ts, 6),
            "duration_ms": round(max(end_ts - start_ts, 0.0) * 1e3, 3),
        }
        if parent_span_id:
            span["parent_span_id"] = parent_span_id
        if segment:
            span["segment"] = segment
        if attrs:
            span.update(attrs)
        with self._lock:
            self._spans.append(span)
        return span

    def journey(self, trace_id: str) -> List[dict]:
        with self._lock:
            spans = [dict(s) for s in self._spans
                     if s["trace_id"] == trace_id]
        spans.sort(key=lambda s: (s["start_ts"], s["end_ts"]))
        return spans

    def recent(self, *, start: float = float("-inf"),
               end: float = float("inf")) -> List[dict]:
        """Copies of every stored span whose end lands in ``[start,
        end]``, time-ordered: the incident recorder's worst-journey
        scan."""
        with self._lock:
            spans = [dict(s) for s in self._spans
                     if start <= s["end_ts"] <= end]
        spans.sort(key=lambda s: (s["start_ts"], s["end_ts"]))
        return spans

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)



STORE = SpanStore()

# Stamps whose watch_lag was already recorded in this process (an object
# is delivered to every controller and on every status bump; only the
# first delivery measures the lag).  Bounded: half is evicted when full.
_lag_seen: set = set()
_lag_lock = threading.Lock()


def first_lag_observation(trace_id: str, span_id: str) -> bool:
    """True once a stamp a process: the watch_lag recording gate."""
    key = (trace_id, span_id)
    with _lag_lock:
        if key in _lag_seen:
            return False
        if len(_lag_seen) > 8192:
            for _ in range(4096):
                _lag_seen.pop()
        _lag_seen.add(key)
        return True


def record(name: str, *, trace_id: str, **kwargs) -> Optional[dict]:
    """Record one span into the process's store (nothing when
    ``JOURNEY_DISABLE`` is set), and mark the thread as acting
    (``consume_mark``)."""
    if not ENABLED:
        return None
    _local.mark = True
    return STORE.record(name, trace_id=trace_id, **kwargs)


def mark_thread() -> None:
    """Set the acting mark on this thread (a fan-out carries a pool
    thread's mark back to the thread that submitted it)."""
    _local.mark = True


def consume_mark() -> bool:
    """True when this thread recorded a span since the last call."""
    marked = getattr(_local, "mark", False)
    _local.mark = False
    return marked


def journey(trace_id: str) -> List[dict]:
    return STORE.journey(trace_id)


def record_write(verb: str, kind: str, name: str, start_ts: float, *,
                 ok: bool = True, **attrs) -> None:
    """A child write's round trip against the current context: segment
    ``write_rtt``, parented on the reconcile's span."""
    ctx = current()
    if ctx is None:
        return
    record(f"k8s.{verb}", trace_id=ctx.trace_id,
           parent_span_id=ctx.span_id, segment="write_rtt",
           start_ts=start_ts, end_ts=time.time(), kind=kind, object=name,
           ok=ok, **attrs)


def merge_journeys(*span_lists: List[dict]) -> List[dict]:
    """Join per-replica journey exports (a sharded fleet's) into one
    timeline: deduplicated by span_id (a span is recorded by exactly one
    replica, and the same export read twice must not double segments),
    sorted by time."""
    seen = set()
    merged: List[dict] = []
    for spans in span_lists:
        for s in spans or []:
            key = s.get("span_id")
            if key in seen:
                continue
            seen.add(key)
            merged.append(s)
    merged.sort(key=lambda s: (s.get("start_ts", 0.0),
                               s.get("end_ts", 0.0)))
    return merged
