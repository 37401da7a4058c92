"""The API client's rate limiter: the port's copy of ``TokenBucket`` of
``kubeflow_tpu/platform/k8s/client.py``.  The REST client itself, its
retries and its circuit breaker, is not ported yet; the in-memory
``testing/fake.py`` ``FakeKube`` is the port's client.
"""
from __future__ import annotations

import threading
import time


class TokenBucket:
    """QPS/burst rate limiter for API-server traffic (the reference
    exposes the same pair as manager flags, notebook-controller
    main.go:64-76).  Thread-safe; ``acquire`` blocks until a token is
    available."""

    def __init__(self, qps: float, burst: int):
        self.qps = float(qps)
        self.burst = float(max(burst, 1))
        self._tokens = self.burst
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def acquire(self) -> None:
        while True:
            with self._lock:
                now = time.monotonic()
                self._tokens = min(
                    self.burst, self._tokens + (now - self._last) * self.qps)
                self._last = now
                if self._tokens >= 1.0:
                    self._tokens -= 1.0
                    return
                wait = (1.0 - self._tokens) / self.qps
            time.sleep(wait)
