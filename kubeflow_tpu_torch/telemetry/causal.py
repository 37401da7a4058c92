"""Causal trace context of a replica: W3C traceparent parsing and the
thread's current context, standard library only.

The port's copy of the part of ``kubeflow_tpu/telemetry/causal.py`` that a
serving replica uses (``:62-205``): a caller's ``traceparent`` header is
parsed by the app (``models/serve.py``), installed as the request
thread's current context with ``use``, and linked into the request trace
as ``causal_trace_id``/``causal_span_id`` (``telemetry/serve.py``).  The
object annotations, admission minting, span store and journeys of the
reference are control-plane work and are not ported.

Ids are a per-process random block plus a counter: one ``secrets`` read a
process, ids unique within it by the counter and across processes by the
random block.
"""
from __future__ import annotations

import dataclasses
import itertools
import re
import secrets
import threading
from contextlib import contextmanager
from typing import Optional

TRACEPARENT_HEADER = "traceparent"

_TRACEPARENT_RE = re.compile(
    r"^[0-9a-f]{2}-([0-9a-f]{32})-([0-9a-f]{16})-[0-9a-f]{2}$")

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
    """The thread's current context (None when none is installed)."""
    return getattr(_local, "ctx", None)


def set_current(ctx: Optional[TraceContext]) -> None:
    _local.ctx = ctx


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
