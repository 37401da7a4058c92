"""The Kubernetes API client: ``RestKubeClient`` on the standard library.
The port's copy of ``kubeflow_tpu/platform/k8s/client.py``, built on
``http.client`` (``ssl`` for HTTPS) where the reference's rides
``requests``: JSON over HTTP(S), optimistic concurrency through
resourceVersion, watch streams as JSON lines.  ``KubeClient`` is the
protocol every controller, informer and elector is written against;
``testing/fake.py`` ``FakeKube`` serves it in memory and
``testing/httpkube.py`` serves a ``FakeKube`` over a socket.

The client keeps a pool of ``K8S_CLIENT_POOL_SIZE`` idle keep-alive
connections; each carries one request at a time.  A pooled connection
the server has closed is found before reuse (its socket reads as ready
while idle) and replaced; a connection that dies during a create,
update or patch is never re-sent, since the server may have applied the
write.  A watch runs on a connection of its own, read line by line, and
setting its ``stop`` shuts the connection down at once.
"""
from __future__ import annotations

import http.client
import json
import logging
import os
import random
import select
import socket
import ssl
import threading
import time
from typing import (Any, Dict, Iterator, List, Optional, Protocol, Tuple)
from urllib.parse import urlencode, urlsplit

from kubeflow_tpu_torch.platform import config
from kubeflow_tpu_torch.platform.k8s import codec, errors
from kubeflow_tpu_torch.platform.k8s.types import (
    GVK,
    Resource,
    gvk_of,
    name_of,
    namespace_of,
)

WatchEvent = Tuple[str, Resource]  # ("ADDED"|"MODIFIED"|"DELETED"|"BOOKMARK", obj)

SERVICE_ACCOUNT_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"

log = logging.getLogger("kubeflow_tpu_torch.k8s.client")

# Verbs safe to retry blind: reads, delete (a retried delete of a gone
# object answers 404, which callers treat as done) and a watch's
# establishment.  create, update and patch are not: a lost response is
# indistinguishable from an applied write.  A 429 is retried for every
# verb: the server refused the request before processing it.
IDEMPOTENT_VERBS = frozenset({"get", "list", "logs", "delete", "watch"})

# Transient HTTP statuses worth a retry on idempotent verbs.
RETRYABLE_STATUSES = frozenset({500, 502, 503, 504})

# The transport's failures: socket errors (refused, reset, timed out) and
# http.client's (a connection closed before or inside a response).
TRANSPORT_ERRORS = (OSError, http.client.HTTPException)

_CONTENT_TYPES = {
    "merge": "application/merge-patch+json",
    "json": "application/json-patch+json",
    "strategic": "application/strategic-merge-patch+json",
    "apply": "application/apply-patch+yaml",
}


class KubeClient(Protocol):
    """The verbs the platform uses.  All objects are unstructured dicts."""

    def get(self, gvk: GVK, name: str, namespace: Optional[str] = None) -> Resource: ...

    def list(self, gvk: GVK, namespace: Optional[str] = None, *,
             label_selector: Optional[Dict[str, str]] = None,
             field_selector: Optional[Dict[str, str]] = None,
             shard_filter: Optional[str] = None) -> List[Resource]: ...

    def create(self, obj: Resource, *, dry_run: bool = False) -> Resource: ...

    def update(self, obj: Resource) -> Resource: ...

    def update_status(self, obj: Resource) -> Resource: ...

    def patch(self, gvk: GVK, name: str, patch: Any,
              namespace: Optional[str] = None, *,
              patch_type: str = "merge") -> Resource: ...

    def patch_status(self, gvk: GVK, name: str, patch: Any,
                     namespace: Optional[str] = None, *,
                     patch_type: str = "merge") -> Resource: ...

    def delete(self, gvk: GVK, name: str, namespace: Optional[str] = None,
               *, propagation: str = "Background") -> None: ...

    def watch(self, gvk: GVK, namespace: Optional[str] = None, *,
              resource_version: Optional[str] = None,
              label_selector: Optional[Dict[str, str]] = None,
              shard_filter: Optional[str] = None,
              stop: Optional[threading.Event] = None
              ) -> Iterator[WatchEvent]: ...

    def can_i(self, user: str, verb: str, gvk: GVK,
              namespace: Optional[str] = None, *,
              groups: Optional[List[str]] = None,
              subresource: str = "") -> bool: ...

    def pod_logs(self, name: str, namespace: str, *,
                 container: Optional[str] = None) -> str: ...


def _selector_string(label_selector: Optional[Dict[str, str]]) -> Optional[str]:
    if not label_selector:
        return None
    return ",".join(f"{k}={v}" for k, v in sorted(label_selector.items()))


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


class CircuitBreaker:
    """After ``threshold`` consecutive transient failures the circuit
    opens and requests fail fast (TransportError) for ``cooldown``
    seconds; then one half-open probe goes through, whose success closes
    it and whose failure re-opens it.  threshold <= 0 disables it.
    Thread-safe."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"

    def __init__(self, threshold: int, cooldown: float):
        self.threshold = int(threshold)
        self.cooldown = float(cooldown)
        self._lock = threading.Lock()
        self._failures = 0
        self._state = self.CLOSED
        self._opened_at = 0.0
        self._probing = False

    def _set_state(self, state: str) -> None:
        from kubeflow_tpu_torch.platform.runtime import metrics

        self._state = state
        metrics.rest_client_circuit_state.set(
            {self.CLOSED: 0, self.HALF_OPEN: 1, self.OPEN: 2}[state])
        if state == self.OPEN:
            metrics.rest_client_circuit_opens_total.inc()

    def allow(self) -> bool:
        """May a request go now?  While open, only the one half-open
        probe a cooldown gets True."""
        if self.threshold <= 0:
            return True
        with self._lock:
            if self._state == self.CLOSED:
                return True
            if (time.monotonic() - self._opened_at >= self.cooldown
                    and not self._probing):
                self._probing = True
                self._set_state(self.HALF_OPEN)
                return True
            return False

    def on_success(self) -> None:
        if self.threshold <= 0:
            return
        with self._lock:
            self._failures = 0
            self._probing = False
            if self._state != self.CLOSED:
                self._set_state(self.CLOSED)

    def on_failure(self) -> None:
        if self.threshold <= 0:
            return
        with self._lock:
            self._failures += 1
            self._probing = False
            if self._failures >= self.threshold and self._state != self.OPEN:
                self._set_state(self.OPEN)
            if self._state == self.OPEN:
                self._opened_at = time.monotonic()

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def consecutive_failures(self) -> int:
        with self._lock:
            return self._failures


class Response:
    """A whole response: status, headers and body."""

    def __init__(self, status_code: int, headers, content: bytes):
        self.status_code = status_code
        self.headers = headers
        self.content = content

    @property
    def text(self) -> str:
        return self.content.decode("utf-8", "replace")

    def json(self) -> Any:
        return json.loads(self.content)


class StreamResponse:
    """A streamed response (a watch): read line by line off its own
    connection, which ``close`` ends."""

    def __init__(self, resp: http.client.HTTPResponse,
                 conn: http.client.HTTPConnection):
        self.status_code = resp.status
        self.headers = resp.headers
        self._resp = resp
        self._conn = conn
        self.sock = conn.sock

    def readline(self) -> bytes:
        return self._resp.readline()

    def close(self) -> None:
        self._conn.close()


class _StopWatcher:
    """Shuts a watch's socket down once its ``stop`` event is set, so a
    stream blocked in a read ends at once instead of at its next event
    or its window's end.  An informer's refilter relies on it: it breaks
    a stream whose server-side shard filter went stale, and a quiet
    stream would otherwise hold the new range's events back for a whole
    window.  One polling thread a client, alive only while a watch with
    a ``stop`` is open."""

    POLL_S = 0.05

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[int, Tuple[threading.Event, socket.socket]] = {}
        self._next = 0
        self._thread: Optional[threading.Thread] = None

    def add(self, stop: threading.Event, sock: socket.socket) -> int:
        with self._lock:
            token = self._next
            self._next += 1
            self._entries[token] = (stop, sock)
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="watch-stop", daemon=True)
                self._thread.start()
            return token

    def remove(self, token: int) -> None:
        with self._lock:
            self._entries.pop(token, None)

    def _run(self) -> None:
        while True:
            with self._lock:
                if not self._entries:
                    self._thread = None
                    return
                fired = [(k, sock) for k, (stop, sock) in
                         self._entries.items() if stop.is_set()]
                for k, _ in fired:
                    del self._entries[k]
            for _, sock in fired:
                try:
                    sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass  # already closed
            time.sleep(self.POLL_S)


class _ConnectionPool:
    """Idle keep-alive connections to one host, at most ``size`` kept.
    ``take`` hands out an idle connection whose socket is still open (a
    connection the server closed reads as ready while idle: it is
    dropped) or a new one; ``give`` returns one after a complete
    response."""

    def __init__(self, scheme: str, host: str, port: Optional[int],
                 size: int, ssl_context: Optional[ssl.SSLContext]):
        self.scheme = scheme
        self.host = host
        self.port = port
        self.size = size
        self.ssl_context = ssl_context
        self._lock = threading.Lock()
        self._idle: List[http.client.HTTPConnection] = []
        self.opened = 0          # connections made
        self.stale_dropped = 0   # idle ones found closed by the server

    def new(self, connect_timeout: float) -> http.client.HTTPConnection:
        if self.scheme == "https":
            conn = http.client.HTTPSConnection(
                self.host, self.port, timeout=connect_timeout,
                context=self.ssl_context)
        else:
            conn = http.client.HTTPConnection(
                self.host, self.port, timeout=connect_timeout)
        conn.connect()
        conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        with self._lock:
            self.opened += 1
        return conn

    @staticmethod
    def _open(conn: http.client.HTTPConnection) -> bool:
        sock = conn.sock
        if sock is None:
            return False
        try:
            ready, _, _ = select.select([sock], [], [], 0)
        except (OSError, ValueError):
            return False
        return not ready

    def take(self, connect_timeout: float) -> http.client.HTTPConnection:
        while True:
            with self._lock:
                conn = self._idle.pop() if self._idle else None
            if conn is None:
                return self.new(connect_timeout)
            if self._open(conn):
                return conn
            with self._lock:
                self.stale_dropped += 1
            conn.close()

    def give(self, conn: http.client.HTTPConnection) -> None:
        with self._lock:
            if len(self._idle) < self.size:
                self._idle.append(conn)
                return
        conn.close()

    def close(self) -> None:
        with self._lock:
            idle, self._idle = self._idle, []
        for conn in idle:
            conn.close()


class RestKubeClient:
    """KubeClient over an API server.

    Config: explicit arguments, then the in-cluster service account
    (``KUBERNETES_SERVICE_HOST``/``_PORT`` and its token), then the
    kubeconfig at ``$KUBECONFIG`` (default ``~/.kube/config``), which must
    be JSON (``kubectl config view --raw -o json`` writes one).

    Resilience, each knob read from the environment (an invalid value
    keeps the default):

    * every verb has a finite (connect, read) timeout,
      ``K8S_CLIENT_TIMEOUT_CONNECT`` (5 s) and ``K8S_CLIENT_TIMEOUT``
      (30 s); a watch reads within ``WATCH_TIMEOUT_SECONDS`` + 30;
    * transient failures (transport errors, 5xx) are retried with full
      jitter for idempotent verbs only; a 429 for every verb, honouring
      ``Retry-After`` up to 30 s (``K8S_CLIENT_RETRIES`` 3,
      ``K8S_CLIENT_RETRY_BASE`` 0.1 s, ``K8S_CLIENT_RETRY_CAP`` 5 s);
    * a circuit breaker of ``K8S_CLIENT_CB_THRESHOLD`` (5) consecutive
      failures and ``K8S_CLIENT_CB_COOLDOWN`` (10 s); ``health()`` is its
      state;
    * a token bucket of ``K8S_CLIENT_QPS`` (50; 0 disables) and
      ``K8S_CLIENT_BURST`` (100), which a watch does not take from.
    """

    # The server closes a watch after this many seconds and the caller's
    # loop re-establishes it, resumed from the last resourceVersion.
    WATCH_TIMEOUT_SECONDS = 300

    # The shard filter's surface, which informers feature-detect: list and
    # watch forward a subscription as the ``shardFilter`` query parameter.
    supports_shard_filter = True

    def __init__(
        self,
        base_url: Optional[str] = None,
        *,
        token: Optional[str] = None,
        ca_cert: Optional[str] = None,
        client_cert: Optional[Tuple[str, str]] = None,
        verify: Optional[bool] = None,
        timeout: Optional[float] = None,
        connect_timeout: Optional[float] = None,
        qps: Optional[float] = None,
        burst: Optional[int] = None,
        retries: Optional[int] = None,
        retry_base: Optional[float] = None,
        retry_cap: Optional[float] = None,
        breaker_threshold: Optional[int] = None,
        breaker_cooldown: Optional[float] = None,
        pool_size: Optional[int] = None,
    ):
        if base_url is None:
            base_url, token, ca_cert, client_cert = self._resolve_config()
        self.base_url = base_url.rstrip("/")

        def knob(value, name, default, parser, doc):
            return value if value is not None else config.knob(
                name, default, parser, doc=doc)

        self.timeout = knob(timeout, "K8S_CLIENT_TIMEOUT", 30.0, float,
                            "per-request read timeout (s)")
        self.connect_timeout = knob(connect_timeout,
                                    "K8S_CLIENT_TIMEOUT_CONNECT", 5.0, float,
                                    "per-request connect timeout (s)")
        self.retries = knob(retries, "K8S_CLIENT_RETRIES", 3, int,
                            "retry budget, idempotent verbs")
        self.retry_base = knob(retry_base, "K8S_CLIENT_RETRY_BASE", 0.1,
                               float, "full-jitter backoff base (s)")
        self.retry_cap = knob(retry_cap, "K8S_CLIENT_RETRY_CAP", 5.0, float,
                              "full-jitter backoff cap (s)")
        self.breaker = CircuitBreaker(
            knob(breaker_threshold, "K8S_CLIENT_CB_THRESHOLD", 5, int,
                 "consecutive failures that open the circuit"),
            knob(breaker_cooldown, "K8S_CLIENT_CB_COOLDOWN", 10.0, float,
                 "open-circuit cooldown before half-open (s)"))
        qps = knob(qps, "K8S_CLIENT_QPS", 50.0, float,
                   "client-side rate limit (0 disables)")
        burst = knob(burst, "K8S_CLIENT_BURST", 100, int,
                     "token-bucket burst for the rate limit")
        self._limiter = TokenBucket(qps, burst) if qps > 0 else None
        self.pool_size = max(1, knob(pool_size, "K8S_CLIENT_POOL_SIZE", 32,
                                     int, "connection-pool size per host"))
        parts = urlsplit(self.base_url)
        if parts.scheme not in ("http", "https") or not parts.hostname:
            raise ValueError(f"not an http(s) URL: {base_url!r}")
        self._prefix = parts.path.rstrip("/")
        context = None
        if parts.scheme == "https":
            context = ssl.create_default_context(
                cafile=ca_cert if verify is None else None)
            if verify is False:
                context.check_hostname = False
                context.verify_mode = ssl.CERT_NONE
            if client_cert:
                context.load_cert_chain(*client_cert)
        self._pool = _ConnectionPool(parts.scheme, parts.hostname,
                                     parts.port, self.pool_size, context)
        self._headers = {"Accept": "application/json"}
        if token:
            self._headers["Authorization"] = f"Bearer {token}"
        self._stop_watcher = _StopWatcher()

    def health(self) -> dict:
        """The circuit's state and its consecutive transient failures."""
        return {
            "circuit": self.breaker.state,
            "consecutive_failures": self.breaker.consecutive_failures,
        }

    def close(self) -> None:
        """Close the idle pooled connections."""
        self._pool.close()

    @staticmethod
    def _resolve_config() -> Tuple[str, Optional[str], Optional[str],
                                   Optional[Tuple[str, str]]]:
        host = config.knob("KUBERNETES_SERVICE_HOST", "",
                           doc="in-cluster apiserver host (set by kubelet)")
        if host and os.path.exists(f"{SERVICE_ACCOUNT_DIR}/token"):
            port = config.knob("KUBERNETES_SERVICE_PORT", "443",
                               doc="in-cluster apiserver port")
            with open(f"{SERVICE_ACCOUNT_DIR}/token") as f:
                token = f.read().strip()
            ca = f"{SERVICE_ACCOUNT_DIR}/ca.crt"
            return (f"https://{host}:{port}", token,
                    ca if os.path.exists(ca) else None, None)
        path = config.knob("KUBECONFIG",
                           os.path.expanduser("~/.kube/config"),
                           doc="kubeconfig path when not in-cluster")
        if not os.path.exists(path):
            raise RuntimeError(
                "no API server config: not in-cluster and no kubeconfig at "
                + path)
        with open(path) as f:
            text = f.read()
        try:
            kc = json.loads(text)
        except ValueError:
            raise RuntimeError(
                f"kubeconfig {path} is not JSON: this client reads JSON "
                "kubeconfigs only (no YAML parser in the standard library); "
                "write one with `kubectl config view --raw -o json`"
            ) from None
        ctx_name = kc.get("current-context")
        ctx = next(c["context"] for c in kc["contexts"]
                   if c["name"] == ctx_name)
        cluster = next(c["cluster"] for c in kc["clusters"]
                       if c["name"] == ctx["cluster"])
        user = next(u["user"] for u in kc["users"]
                    if u["name"] == ctx["user"])
        cert = None
        if "client-certificate" in user:
            cert = (user["client-certificate"], user["client-key"])
        return (cluster["server"], user.get("token"),
                cluster.get("certificate-authority"), cert)

    # -- plumbing ------------------------------------------------------------

    @staticmethod
    def _retry_after_of(resp) -> Optional[float]:
        raw = resp.headers.get("Retry-After")
        if raw is None:
            return None
        try:
            return max(0.0, float(raw))
        except (TypeError, ValueError):
            return None  # the HTTP-date form: unspecified

    def _should_retry(self, exc: errors.ApiError, verb: str,
                      attempt: int) -> bool:
        """Bounded attempts; 429 for every verb; transport errors and
        retryable 5xx for idempotent verbs only; never a fail-fast of the
        open circuit."""
        if getattr(exc, "circuit_open", False):
            return False
        if attempt >= self.retries:
            return False
        if isinstance(exc, errors.TooManyRequests):
            return True
        if verb not in IDEMPOTENT_VERBS:
            return False
        return (isinstance(exc, errors.TransportError)
                or exc.status in RETRYABLE_STATUSES)

    def _retry_delay(self, exc: errors.ApiError, attempt: int) -> float:
        """A server's Retry-After (at most 30 s), else full jitter:
        uniform in [0, min(cap, base * 2^attempt)]."""
        if exc.retry_after is not None:
            return min(exc.retry_after, 30.0)
        return random.uniform(
            0.0, min(self.retry_cap, self.retry_base * (2 ** attempt)))

    def _send(self, method: str, path: str, *, params: Optional[dict],
              data: Optional[bytes], headers: Dict[str, str], stream: bool,
              timeout: Tuple[float, float]):
        """One HTTP exchange.  A whole response comes back as a
        ``Response`` and its connection returns to the pool; a stream of
        status < 400 as a ``StreamResponse`` on a connection of its own.
        Raises the transport's errors (TRANSPORT_ERRORS)."""
        connect, read = timeout
        url = self._prefix + path
        if params:
            url += "?" + urlencode(params)
        conn = (self._pool.new(connect) if stream
                else self._pool.take(connect))
        try:
            conn.sock.settimeout(read)
            conn.request(method, url, body=data,
                         headers={**self._headers, **headers})
            resp = conn.getresponse()
            if stream and resp.status < 400:
                return StreamResponse(resp, conn)
            body = resp.read()
        except BaseException:
            conn.close()
            raise
        if stream or resp.will_close:
            conn.close()
        else:
            self._pool.give(conn)
        return Response(resp.status, resp.headers, body)

    def _request(self, method: str, path: str, *,
                 params: Optional[dict] = None, body: Optional[Any] = None,
                 stream: bool = False, verb: Optional[str] = None,
                 kind: str = "", limiter_exempt: bool = False):
        """``verb``/``kind`` label the client's metrics (the semantic
        verb: list and get both ride GET).  Wraps ``_request_once`` in the
        bounded retry policy."""
        from kubeflow_tpu_torch.platform.runtime import metrics
        from kubeflow_tpu_torch.telemetry import causal

        verb = verb or method.lower()
        headers: Dict[str, str] = {}
        # Every verb carries the current trace context, so a server that
        # reads it (HttpKube, a proxy) links the request to its journey.
        tp = causal.current_traceparent()
        if tp:
            headers[causal.TRACEPARENT_HEADER] = tp
        if method == "PATCH":
            # Taken once, outside the retry loop: a second attempt must
            # not fall back to "merge".
            ptype = (params or {}).pop("_patch_type", "merge")
            headers["Content-Type"] = _CONTENT_TYPES[ptype]
        data = None
        if body is not None:
            # Through the codec: frozen cache views cross without a thaw
            # copy, a never-materialized watch object as its raw bytes.
            data = codec.encode(body).encode("utf-8")
            headers.setdefault("Content-Type", "application/json")
        attempt = 0
        while True:
            try:
                return self._request_once(
                    method, path, params=params, data=data, headers=headers,
                    stream=stream, verb=verb, kind=kind,
                    limiter_exempt=limiter_exempt)
            except errors.ApiError as e:
                if not errors.is_transient(e):
                    raise
                if not self._should_retry(e, verb, attempt):
                    raise
                delay = self._retry_delay(e, attempt)
                attempt += 1
                metrics.rest_client_retries_total.labels(verb=verb).inc()
                log.debug("retrying %s %s (attempt %d) in %.3fs after: %s",
                          verb, path, attempt, delay, e)
                if delay > 0:
                    time.sleep(delay)

    def _request_once(self, method: str, path: str, *, params, data,
                      headers, stream: bool, verb: str, kind: str,
                      limiter_exempt: bool = False):
        """One attempt: the circuit's gate, the rate limit, the exchange
        and the metrics.  Transport failures surface as
        ``errors.TransportError``."""
        from kubeflow_tpu_torch.platform.runtime import metrics, trace

        if not self.breaker.allow():
            metrics.rest_client_requests_total.labels(
                verb=verb, kind=kind, code="<circuit-open>").inc()
            err = errors.TransportError(
                f"circuit breaker open ({self.breaker.consecutive_failures}"
                " consecutive failures); refusing to call the apiserver")
            err.circuit_open = True
            raise err
        if self._limiter is not None and not limiter_exempt:
            self._limiter.acquire()
        code = "<error>"
        t0 = time.perf_counter()
        try:
            with trace.span(f"k8s.{verb}", kind=kind) as sp:
                try:
                    resp = self._send(
                        method, path, params=params, data=data,
                        headers=headers, stream=stream,
                        timeout=(self.connect_timeout,
                                 (self.WATCH_TIMEOUT_SECONDS + 30) if stream
                                 else self.timeout))
                except TRANSPORT_ERRORS as e:
                    self.breaker.on_failure()
                    raise errors.TransportError(
                        f"{method} {path}: {e!r}") from e
                code = str(resp.status_code)
                if sp is not None:
                    sp.attrs["code"] = code
                if resp.status_code >= 400:
                    try:
                        status = resp.json()
                        message = status.get("message", resp.text)
                    except (ValueError, AttributeError):
                        status, message = None, resp.text
                    err = errors.error_for_status(
                        resp.status_code, message, status,
                        retry_after=self._retry_after_of(resp))
                    # Only server-side breakage trips the breaker: a 4xx
                    # (429 too: a throttling server is up) is the caller's.
                    if err.status in RETRYABLE_STATUSES:
                        self.breaker.on_failure()
                    else:
                        self.breaker.on_success()
                    raise err
                self.breaker.on_success()
                return resp
        finally:
            metrics.rest_client_request_duration_seconds.labels(
                verb=verb, kind=kind).observe(time.perf_counter() - t0)
            metrics.rest_client_requests_total.labels(
                verb=verb, kind=kind, code=code).inc()

    # -- verbs ---------------------------------------------------------------

    def get(self, gvk: GVK, name: str, namespace: Optional[str] = None) -> Resource:
        return self._request("GET", gvk.path(namespace, name),
                             verb="get", kind=gvk.kind).json()

    def list(self, gvk, namespace=None, *, label_selector=None,
             field_selector=None, shard_filter=None) -> List[Resource]:
        """``field_selector``: dotted field path -> exact value, sent as
        the API server's fieldSelector."""
        params = {}
        sel = _selector_string(label_selector)
        if sel:
            params["labelSelector"] = sel
        fsel = _selector_string(field_selector)
        if fsel:
            params["fieldSelector"] = fsel
        if shard_filter:
            params["shardFilter"] = shard_filter
        data = self._request("GET", gvk.path(namespace), params=params,
                             verb="list", kind=gvk.kind).json()
        return data.get("items", [])

    def list_with_rv(self, gvk, namespace=None, *, shard_filter=None):
        """The items and the collection's resourceVersion, the point a
        watch resumes from (global even when shard-filtered)."""
        params = {"shardFilter": shard_filter} if shard_filter else None
        data = self._request("GET", gvk.path(namespace), params=params,
                             verb="list", kind=gvk.kind).json()
        rv = (data.get("metadata") or {}).get("resourceVersion")
        return data.get("items", []), rv

    def create(self, obj: Resource, *, dry_run: bool = False) -> Resource:
        from kubeflow_tpu_torch.telemetry import causal

        gvk = gvk_of(obj)
        # A context-free platform object gets its journey root before it
        # crosses the wire, on a copy: the caller's dict stays as it was.
        obj = causal.stamped_copy_on_admission(obj)
        params = {"dryRun": "All"} if dry_run else None
        return self._request(
            "POST", gvk.path(namespace_of(obj)), params=params, body=obj,
            verb="create", kind=gvk.kind).json()

    def update(self, obj: Resource) -> Resource:
        gvk = gvk_of(obj)
        return self._request(
            "PUT", gvk.path(namespace_of(obj), name_of(obj)), body=obj,
            verb="update", kind=gvk.kind).json()

    def update_status(self, obj: Resource) -> Resource:
        gvk = gvk_of(obj)
        path = gvk.path(namespace_of(obj), name_of(obj)) + "/status"
        return self._request("PUT", path, body=obj,
                             verb="update_status", kind=gvk.kind).json()

    def patch(self, gvk, name, patch, namespace=None, *,
              patch_type="merge") -> Resource:
        return self._request(
            "PATCH", gvk.path(namespace, name),
            params={"_patch_type": patch_type}, body=patch,
            verb="patch", kind=gvk.kind).json()

    def patch_status(self, gvk, name, patch, namespace=None, *,
                     patch_type="merge") -> Resource:
        """PATCH on the /status subresource (no resourceVersion, so no 409
        against concurrent spec writes)."""
        return self._request(
            "PATCH", gvk.path(namespace, name) + "/status",
            params={"_patch_type": patch_type}, body=patch,
            verb="patch_status", kind=gvk.kind).json()

    def delete(self, gvk, name, namespace=None, *,
               propagation="Background") -> None:
        self._request("DELETE", gvk.path(namespace, name),
                      body={"propagationPolicy": propagation},
                      verb="delete", kind=gvk.kind)

    def watch(self, gvk, namespace=None, *, resource_version=None,
              label_selector=None, shard_filter=None,
              stop: Optional[threading.Event] = None):
        params: Dict[str, Any] = {
            "watch": "true",
            # Whole seconds: an API server refuses a fractional window.
            "timeoutSeconds": str(max(1, int(self.WATCH_TIMEOUT_SECONDS))),
        }
        if resource_version:
            params["resourceVersion"] = resource_version
        sel = _selector_string(label_selector)
        if sel:
            params["labelSelector"] = sel
        if shard_filter:
            params["shardFilter"] = shard_filter
        # Establishment is idempotent (nothing has streamed yet): the
        # retry policy and the breaker apply, the rate limit does not.
        # Once events flow, a failure propagates: only the caller knows
        # the resourceVersion to resume from.
        resp = self._request(
            "GET", gvk.path(namespace), params=params, stream=True,
            verb="watch", kind=gvk.kind, limiter_exempt=True)
        sock = getattr(resp, "sock", None)
        token = (self._stop_watcher.add(stop, sock)
                 if stop is not None and sock is not None else None)
        try:
            while True:
                if stop is not None and stop.is_set():
                    return
                try:
                    # One line at a time: a quiet kind's event is never
                    # held back behind a read buffer waiting to fill.
                    line = resp.readline()
                except (*TRANSPORT_ERRORS, ValueError) as e:
                    if stop is not None and stop.is_set():
                        return
                    raise errors.TransportError(
                        f"watch {gvk.kind} stream: {e!r}") from e
                if not line:
                    return  # the server closed the window
                line = line.strip()
                if line:
                    yield codec.decode_event(line)
        finally:
            if token is not None:
                self._stop_watcher.remove(token)
            resp.close()

    def pod_logs(self, name, namespace, *, container=None) -> str:
        params = {"container": container} if container else None
        path = f"/api/v1/namespaces/{namespace}/pods/{name}/log"
        return self._request("GET", path, params=params,
                             verb="logs", kind="Pod").text

    def can_i(self, user, verb, gvk, namespace=None, *, groups=None,
              subresource="") -> bool:
        review = {
            "apiVersion": "authorization.k8s.io/v1",
            "kind": "SubjectAccessReview",
            "spec": {
                "user": user,
                "groups": groups or [],
                "resourceAttributes": {
                    "group": gvk.group,
                    "resource": gvk.plural,
                    "subresource": subresource,
                    "namespace": namespace or "",
                    "verb": verb,
                },
            },
        }
        resp = self._request(
            "POST", "/apis/authorization.k8s.io/v1/subjectaccessreviews",
            body=review, verb="create", kind="SubjectAccessReview").json()
        return bool(resp.get("status", {}).get("allowed"))
