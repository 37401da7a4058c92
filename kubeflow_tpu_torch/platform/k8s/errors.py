"""Kubernetes API error taxonomy (maps HTTP status ↔ typed exceptions):
the port's copy of ``kubeflow_tpu/platform/k8s/errors.py``."""
from __future__ import annotations

from typing import Optional


class ApiError(Exception):
    status: int = 500
    reason: str = "InternalError"

    def __init__(self, message: str = "", *, status: Optional[int] = None,
                 reason: Optional[str] = None, body: Optional[dict] = None,
                 retry_after: Optional[float] = None):
        super().__init__(message or self.reason)
        if status is not None:
            self.status = status
        if reason is not None:
            self.reason = reason
        self.body = body or {}
        # Seconds the server asked us to wait (HTTP Retry-After on 429/503).
        # None when the server didn't say; the client's retry policy and the
        # web apps' 503 responses both honor it.
        self.retry_after = retry_after

    def to_status(self) -> dict:
        """Render as a k8s Status object (what a real API server returns)."""
        return {
            "kind": "Status",
            "apiVersion": "v1",
            "status": "Failure",
            "message": str(self),
            "reason": self.reason,
            "code": self.status,
        }


class NotFound(ApiError):
    status = 404
    reason = "NotFound"


class Conflict(ApiError):
    status = 409
    reason = "Conflict"


class AlreadyExists(Conflict):
    reason = "AlreadyExists"


class Forbidden(ApiError):
    status = 403
    reason = "Forbidden"


class BadRequest(ApiError):
    status = 400
    reason = "BadRequest"


class Invalid(ApiError):
    status = 422
    reason = "Invalid"


class Gone(ApiError):
    """410: the resourceVersion a watch/list tried to resume from was
    compacted away (apiserver reason "Expired")."""
    status = 410
    reason = "Expired"


class TooManyRequests(ApiError):
    """429: apiserver (or priority-and-fairness) throttling.  Carries the
    server's Retry-After when it sent one."""
    status = 429
    reason = "TooManyRequests"


class InternalError(ApiError):
    status = 500
    reason = "InternalError"


class ServiceUnavailable(ApiError):
    status = 503
    reason = "ServiceUnavailable"


class TransportError(ServiceUnavailable):
    """The request never produced an HTTP response: connect/read timeout,
    refused connection, mid-stream disconnect, or an open circuit breaker.
    Modeled as a 503 (the caller-visible semantics are identical: the
    control plane is unreachable, try again later), so web handlers map it
    to 503 + Retry-After without a special case."""
    reason = "TransportError"


def is_transient(exc: BaseException) -> bool:
    """Would a retry plausibly succeed without any state change?  True for
    transport failures, throttling, and 5xx — the classes the client's
    retry policy, the circuit breaker, and the web apps' degraded-read
    fallback all treat as "the apiserver is having a moment", as opposed
    to 4xx semantics (NotFound/Conflict/Forbidden) that retrying cannot
    fix."""
    return isinstance(exc, ApiError) and (
        isinstance(exc, TransportError)
        or exc.status in (429, 500, 502, 503, 504)
    )


def error_for_status(status: int, message: str = "", body: Optional[dict] = None,
                     *, retry_after: Optional[float] = None) -> ApiError:
    # The Status body's reason is MORE specific than the HTTP code (e.g.
    # both Conflict and AlreadyExists are 409); honoring it keeps typed
    # handlers (`except AlreadyExists`) behaving identically in-memory and
    # over the wire.
    reason = (body or {}).get("reason", "")
    classes = (NotFound, AlreadyExists, Conflict, Forbidden, BadRequest,
               Invalid, Gone, TooManyRequests, ServiceUnavailable)
    for cls in classes:
        if cls.reason == reason:
            return cls(message, body=body, retry_after=retry_after)
    # Status-code fallback: only base classes.  AlreadyExists inherits 409
    # from Conflict; a reason-less 409 is an optimistic-concurrency conflict,
    # not a create collision, so it must map to the generic Conflict.
    for cls in (NotFound, Conflict, Forbidden, BadRequest, Invalid, Gone,
                TooManyRequests, InternalError, ServiceUnavailable):
        if cls.status == status:
            return cls(message, body=body, retry_after=retry_after)
    return ApiError(message, status=status, body=body, retry_after=retry_after)
