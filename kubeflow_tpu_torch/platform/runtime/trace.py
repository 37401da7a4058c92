"""Per-reconcile tracing for the control plane: the port's copy of
``kubeflow_tpu/platform/runtime/trace.py`` over the port's own tracer
(``telemetry/trace.py``).

Every dequeued Request gets a trace; the worker thread carries it
thread-locally, so spans opened anywhere below (the reconcile body,
informer cache reads) attach without a context argument.  Finished
traces land in a bounded ring (``recent``, the reference's
``/debug/traces`` body); a reconcile slower than
``SLOW_RECONCILE_SECONDS`` also logs its span tree as one JSON line.
Trace dicts carry ``controller`` and ``request``.

The knobs are module attributes read at call time, so a test may patch
``trace.SLOW_RECONCILE_SECONDS`` or ``trace.ENABLED``.
"""
from __future__ import annotations

from typing import List, Optional

from kubeflow_tpu_torch.platform import config
from kubeflow_tpu_torch.telemetry.trace import Span, Trace, Tracer  # noqa: F401

# A reconcile at or above this wall time logs its span tree.
SLOW_RECONCILE_SECONDS = config.env_float("TRACE_SLOW_RECONCILE_SECONDS", 1.0)
# TRACE_DISABLE=1 turns reconcile tracing off (begin returns None and
# every span is a no-op).
ENABLED = not config.env_bool("TRACE_DISABLE", False)
# The ring of finished traces.
TRACE_BUFFER_SIZE = config.env_int("TRACE_BUFFER_SIZE", 64)

_tracer = Tracer(
    "ctrlplane", keys=("controller", "request"),
    buffer_size=TRACE_BUFFER_SIZE,
    logger="kubeflow_tpu_torch.runtime.trace",
    slow_message="slow reconcile trace")
log = _tracer.log


def begin(controller: str, request: str) -> Optional[Trace]:
    """Start a trace for a dequeued Request on this thread (None when
    tracing is disabled); a stale trace of an earlier reconcile is
    dropped."""
    return _tracer.begin(request, component=controller, enabled=ENABLED)


def current() -> Optional[Trace]:
    return _tracer.current()


def adopt(tr: Optional[Trace]) -> None:
    """Install an existing trace as this thread's (the fan-out carry)."""
    _tracer.adopt(tr)


def span(name: str, **attrs):
    """A child span of this thread's trace; a no-op (yields None) when no
    trace is active."""
    return _tracer.span(name, **attrs)


def finish(result: str = "") -> Optional[dict]:
    """Close this thread's trace into the ring, logging it when slow;
    its dict, or None when no trace was active."""
    return _tracer.finish(result, slow_seconds=SLOW_RECONCILE_SECONDS)


def recent(n: Optional[int] = None) -> List[dict]:
    """The newest finished traces, newest last (n <= 0 gives none)."""
    return _tracer.recent(n)


def clear() -> None:
    _tracer.clear()
