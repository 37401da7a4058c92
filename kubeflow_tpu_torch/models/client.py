"""Wire client for the /v1/generate contract — counterpart of
``kubeflow_tpu/models/client.py``.

The server (``models/serve.py``) speaks plain HTTP with a small QoS
vocabulary in headers — tenant, priority class, deadline — and
structured failure envelopes (``{"success": false, "status", "log"}``)
with Retry-After on backpressure (503 while a replica warms) and a 504
when a request's deadline passed.  This module is the one client-side
reading of that contract, so a wire change shows up as one diff.

Standard library only (urllib, json): importing it pulls in no torch.
"""
from __future__ import annotations

import json
import random
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from typing import Dict, List, Optional

HEADER_TENANT = "X-KFT-Tenant"
HEADER_PRIORITY = "X-KFT-Priority"
HEADER_DEADLINE = "X-KFT-Deadline-Seconds"


def full_jitter_backoff(attempt: int, *, base: float, cap: float,
                        rng: Optional[random.Random] = None) -> float:
    """Full-jitter exponential backoff: uniform in
    [0, min(cap, base * 2^attempt)].  Full jitter, so that requests held
    together and retried together do not arrive together at the one
    replica that just warmed."""
    rng = rng if rng is not None else random
    return rng.uniform(0.0, min(cap, base * (2.0 ** max(attempt, 0))))


@dataclass
class GenerateResult:
    """One wire outcome.  ``ok`` iff HTTP 200; otherwise ``status`` and
    ``log`` carry the failure envelope, and ``retry_after`` the server's
    Retry-After seconds when it sent one."""

    status: int
    tokens: Optional[List[List[int]]] = None
    log: str = ""
    retry_after: Optional[float] = None
    headers: Dict[str, str] = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return self.status == 200

    @property
    def retryable(self) -> bool:
        """Whether a replay can succeed: backpressure (429, 503) after
        Retry-After; a 504 means the request's own deadline passed."""
        return self.status in (429, 503)


class GenerateClient:
    """A /v1/generate caller with the QoS headers attached.  ``base_url``
    is a replica's root (``http://host:port``) or a front door's service
    prefix: the path past it is the same."""

    def __init__(self, base_url: str, *, tenant: Optional[str] = None,
                 priority: Optional[str] = None,
                 timeout: float = 30.0, opener=None):
        self.base_url = base_url.rstrip("/")
        self.tenant = tenant
        self.priority = priority
        self.timeout = timeout
        # opener(request, timeout) -> a response with .status, .headers
        # and .read(), for hermetic tests.
        self._opener = opener or (
            lambda req, timeout: urllib.request.urlopen(req, timeout=timeout))

    def headers(self, *, deadline_seconds: Optional[float] = None,
                traceparent: Optional[str] = None) -> Dict[str, str]:
        out = {"Content-Type": "application/json"}
        if self.tenant:
            out[HEADER_TENANT] = self.tenant
        if self.priority:
            out[HEADER_PRIORITY] = self.priority
        if deadline_seconds is not None:
            out[HEADER_DEADLINE] = f"{deadline_seconds:.3f}"
        if traceparent:
            out["traceparent"] = traceparent
        return out

    def generate(self, tokens: List[List[int]], *,
                 max_new_tokens: Optional[int] = None,
                 temperature: float = 0.0, seed: int = 0,
                 deadline_seconds: Optional[float] = None,
                 traceparent: Optional[str] = None) -> GenerateResult:
        body: dict = {"tokens": tokens, "temperature": temperature,
                      "seed": seed}
        if max_new_tokens is not None:
            body["max_new_tokens"] = max_new_tokens
        req = urllib.request.Request(
            self.base_url + "/v1/generate",
            data=json.dumps(body).encode(),
            headers=self.headers(deadline_seconds=deadline_seconds,
                                 traceparent=traceparent),
            method="POST")
        try:
            with self._opener(req, self.timeout) as resp:
                return _parse(resp.status, dict(resp.headers), resp.read())
        except urllib.error.HTTPError as e:
            return _parse(e.code, dict(e.headers or {}), e.read())
        except (urllib.error.URLError, OSError, TimeoutError) as e:
            # A transport failure reads as a retryable 503, so a caller's
            # retry loop has one path.
            return GenerateResult(status=503, log=f"transport: {e}")


def _parse(status: int, headers: Dict[str, str], raw: bytes
           ) -> GenerateResult:
    headers = {k.lower(): v for k, v in headers.items()}
    retry_after = None
    if headers.get("retry-after"):
        try:
            retry_after = float(headers["retry-after"])
        except ValueError:
            retry_after = None
    try:
        body = json.loads(raw.decode("utf-8", "replace")) or {}
    except ValueError:
        body = {}
    return GenerateResult(
        status=status,
        tokens=body.get("tokens") if status == 200 else None,
        log=str(body.get("log", "")),
        retry_after=retry_after,
        headers=headers,
    )
