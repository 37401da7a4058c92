"""The serving front door: hold-and-replay cold starts, per-tenant QoS.
The port's copy of ``kubeflow_tpu/platform/activator.py``; its front
runs on the port's standard-library ``App`` (``web/serve_app.py``, the
replica's app too; it loads no torch, nor does this module) with
the prefix route ``/serve/<ns>/<name>/<rest>``, where the reference's
runs on werkzeug.

* **Zero-drop cold starts.**  A request for a service with no ready
  endpoints is HELD in a bounded per-service queue while the activator
  stamps the ``inferenceservices.kubeflow.org/wake-at`` annotation (and
  re-stamps it while requests stay held, so a controller that read a
  stale stamp converges).  When the controller's replicas pass their
  ``/readyz`` warm generate, the held requests REPLAY into them with
  bounded full-jitter retries.  A held request fails only explicitly:
  hold-queue overflow (503 + Retry-After), wake deadline expiry (503 +
  Retry-After), or its OWN deadline expiring first (504: a dead request
  is evicted, never replayed).
* **The QoS point.**  Admission is a per-tenant token bucket
  (``X-KFT-Tenant``): past the burst, a hammering tenant gets a 429 +
  Retry-After while other tenants' buckets are untouched.  Past the SLO
  knee (the stored-series TTFT p99 against the service's
  ``ttftP99TargetSeconds``, read from the TSDB the controller's scrape
  fills) every request costs ``KFT_ACTIVATOR_SHED_COST`` tokens, so the
  tenants driving the overload run dry (429, reason ``slo-shed``).  Hold
  queues drain in weighted fair-share order across tenants (smooth
  weighted round-robin), and the priority class (``X-KFT-Priority``)
  rides through to the replica's scheduler.
* **A data path.**  The activator proxies: it forwards the body and the
  QoS and trace headers (the deadline as the REMAINING budget),
  observes per-tenant seconds into ``runtime/metrics.py``, and passes
  backend responses through verbatim, the replica's own 503 and 504
  envelopes included.  A replica is reached directly, whatever proxy
  the environment names.

Endpoint discovery is push, not probe: the InferenceService reconciler
publishes each service's ready endpoints (and its TTFT target) into the
process-shared ``EndpointBook`` every pass, and ``forget``s them on
delete.

Every knob is ``KFT_ACTIVATOR_*`` with the reference's default, read
through ``config.knob(validate=)``: a value that does not parse or is
out of range raises ``ValueError`` where it is read.

Drive it on the CPU::

    act = Activator(kube, book=book, tsdb=tsdb)
    server = create_activator_app(act).make_server("127.0.0.1", 0)
    # POST http://127.0.0.1:<port>/serve/<ns>/<name>/v1/generate
"""
from __future__ import annotations

import math
import random
import threading
import time
import urllib.error
import urllib.request
from typing import Callable, Dict, List, Optional, Tuple

from kubeflow_tpu_torch.platform import config
from kubeflow_tpu_torch.platform.apis import inferenceservice as api
from kubeflow_tpu_torch.platform.k8s.types import INFERENCESERVICE
from kubeflow_tpu_torch.platform.runtime import metrics
from kubeflow_tpu_torch.platform.web.generate_client import (
    HEADER_DEADLINE,
    HEADER_PRIORITY,
    HEADER_TENANT,
    full_jitter_backoff,
)
from kubeflow_tpu_torch.platform.web.serve_app import (
    App,
    failure,
    json_response,
    success,
)


# -- knobs --------------------------------------------------------------------

def _positive(what):
    return lambda v: None if v > 0 else f"{what} must be > 0, got {v!r}"


def _at_least(floor, what):
    return lambda v: (None if v >= floor
                      else f"{what} must be >= {floor}, got {v!r}")


def hold_queue_limit() -> int:
    """Requests held a service across a cold start; the next sheds with
    503 hold-overflow."""
    return config.knob(
        "KFT_ACTIVATOR_HOLD_QUEUE", 64, int,
        doc="max requests held per service across a cold start; the "
            "next one sheds with 503 hold-overflow",
        validate=_at_least(1, "hold queue"))


def wake_deadline_seconds() -> float:
    """Seconds a request stays held waiting for the wake; past it the
    hold sheds with 503 wake-timeout."""
    return config.knob(
        "KFT_ACTIVATOR_WAKE_DEADLINE_SECONDS", 120.0, float,
        doc="max seconds a request stays held waiting for the wake; "
            "past it the hold sheds with 503 wake-timeout",
        validate=_positive("wake deadline"))


def restamp_seconds() -> float:
    """Re-stamp cadence of the wake-at annotation while requests stay
    held."""
    return config.knob(
        "KFT_ACTIVATOR_RESTAMP_SECONDS", 2.0, float,
        doc="re-stamp cadence for the wake-at annotation while requests "
            "stay held (defeats a controller holding a stale stamp)",
        validate=_positive("restamp interval"))


def replay_retries() -> int:
    """Full-jitter replay attempts against a just-woken service before
    the hold fails."""
    return config.knob(
        "KFT_ACTIVATOR_REPLAY_RETRIES", 6, int,
        doc="max full-jitter replay attempts against a just-woken "
            "service before the hold fails",
        validate=_at_least(0, "replay retries"))


def replay_base_seconds() -> float:
    """Full-jitter replay backoff base (the cap doubles from here)."""
    return config.knob(
        "KFT_ACTIVATOR_REPLAY_BASE_SECONDS", 0.1, float,
        doc="full-jitter replay backoff base (cap doubles from here)",
        validate=_positive("replay base"))


def replay_cap_seconds() -> float:
    """Full-jitter replay backoff cap."""
    return config.knob(
        "KFT_ACTIVATOR_REPLAY_CAP_SECONDS", 5.0, float,
        doc="full-jitter replay backoff cap",
        validate=_positive("replay cap"))


def tenant_rate() -> float:
    """Token-bucket refill rate a tenant, requests a second."""
    return config.knob(
        "KFT_ACTIVATOR_TENANT_RATE", 50.0, float,
        doc="token-bucket refill rate per tenant, requests/second",
        validate=_positive("tenant rate"))


def tenant_burst() -> float:
    """Token-bucket burst a tenant (the bucket's capacity)."""
    return config.knob(
        "KFT_ACTIVATOR_TENANT_BURST", 100.0, float,
        doc="token-bucket burst per tenant (bucket capacity)",
        validate=_at_least(1.0, "tenant burst"))


def tenant_weights() -> Dict[str, float]:
    """``"a=2,b=1"`` → fair-share dequeue weights; absent tenants get 1."""
    def parse(raw: str) -> Dict[str, float]:
        out = {}
        for part in raw.split(","):
            part = part.strip()
            if not part:
                continue
            name, _, val = part.partition("=")
            out[name.strip()] = float(val)
        return out

    return config.knob(
        "KFT_ACTIVATOR_TENANT_WEIGHTS", {}, parse,
        doc="weighted fair-share dequeue weights, 'tenantA=2,tenantB=1' "
            "(unlisted tenants weigh 1)",
        validate=lambda v: (None if all(w > 0 for w in v.values())
                            else "weights must be > 0"))


def shed_ttft_multiple() -> float:
    """The SLO knee: a stored-series TTFT p99 above this multiple of the
    service's ttftP99TargetSeconds turns the admission surcharge on."""
    return config.knob(
        "KFT_ACTIVATOR_SHED_TTFT_MULTIPLE", 4.0, float,
        doc="SLO knee: stored-series TTFT p99 above this multiple of the "
            "service's ttftP99TargetSeconds turns on admission surcharge",
        validate=_at_least(1.0, "shed multiple"))


def shed_cost() -> float:
    """Tokens one request costs past the SLO knee (1 below it)."""
    return config.knob(
        "KFT_ACTIVATOR_SHED_COST", 4.0, float,
        doc="tokens one request costs past the SLO knee (1 below it): "
            "the burn-driven surcharge that sheds heavy tenants first",
        validate=_at_least(1.0, "shed cost"))


# -- endpoint book ------------------------------------------------------------

class ServiceRecord:
    """What the controller knows that the data path needs: the ready
    replica base URLs and the SLO target the shed signal compares
    against."""

    __slots__ = ("endpoints", "ttft_target_s", "phase")

    def __init__(self, endpoints: Tuple[str, ...],
                 ttft_target_s: Optional[float], phase: str):
        self.endpoints = endpoints
        self.ttft_target_s = ttft_target_s
        self.phase = phase


class EndpointBook:
    """Push-model endpoint discovery: the InferenceService reconciler
    ``publish``es each pass (and ``forget``s on delete); the activator
    reads and subscribes.  Thread-safe; subscribers are called OUTSIDE
    the lock with the service key so a publish can wake held requests
    without lock-ordering games."""

    def __init__(self):
        self._lock = threading.Lock()
        self._records: Dict[str, ServiceRecord] = {}
        self._subscribers: List[Callable[[str], None]] = []

    def publish(self, key: str, *, endpoints, ttft_target_s=None,
                phase: str = "") -> None:
        rec = ServiceRecord(tuple(e for e in endpoints if e),
                            ttft_target_s, phase)
        with self._lock:
            self._records[key] = rec
            subs = list(self._subscribers)
        for fn in subs:
            fn(key)

    def forget(self, key: str) -> None:
        with self._lock:
            self._records.pop(key, None)
            subs = list(self._subscribers)
        for fn in subs:
            fn(key)

    def get(self, key: str) -> Optional[ServiceRecord]:
        with self._lock:
            return self._records.get(key)

    def subscribe(self, fn: Callable[[str], None]) -> None:
        with self._lock:
            self._subscribers.append(fn)

    def snapshot(self) -> dict:
        with self._lock:
            return {k: {"endpoints": list(r.endpoints),
                        "ttftTargetSeconds": r.ttft_target_s,
                        "phase": r.phase}
                    for k, r in self._records.items()}


_default_book: Optional[EndpointBook] = None
_default_book_lock = threading.Lock()


def default_book() -> EndpointBook:
    """The process-shared book (the ``fleetscrape.default_tsdb`` pattern):
    controllers publish into it, the activator reads from it — one
    process, one discovery truth."""
    global _default_book
    with _default_book_lock:
        if _default_book is None:
            _default_book = EndpointBook()
        return _default_book


# -- QoS primitives -----------------------------------------------------------

class TokenBucket:
    """Classic token bucket, monotonic-clock refill.  ``take(cost)``
    returns (granted, retry_after_seconds) — the retry hint is how long
    until ``cost`` tokens will have refilled, which becomes the 429's
    Retry-After."""

    def __init__(self, rate: float, burst: float, *,
                 now: Callable[[], float] = time.monotonic):
        self.rate = max(rate, 1e-9)
        self.burst = burst
        self.tokens = float(burst)
        self.now = now
        self._t = now()
        self._lock = threading.Lock()

    def take(self, cost: float = 1.0) -> Tuple[bool, float]:
        with self._lock:
            t = self.now()
            self.tokens = min(self.burst,
                              self.tokens + (t - self._t) * self.rate)
            self._t = t
            if self.tokens >= cost:
                self.tokens -= cost
                return True, 0.0
            return False, (cost - self.tokens) / self.rate


class _Waiter:
    """One held request: the worker thread parks on ``turn`` until the
    fair-share drain hands it the baton (or a deadline evicts it)."""

    __slots__ = ("tenant", "t_held")

    def __init__(self, tenant: str):
        self.tenant = tenant
        self.t_held = time.monotonic()


class _ServiceFront:
    """Per-service hold state: tenant-keyed FIFO deques drained in
    smooth weighted round-robin order.  All mutation under ``lock``;
    held threads wait on ``cond`` and re-check ``next_waiter()`` — only
    the waiter holding the baton forwards, then notifies the rest, so
    the drain ORDER is fair-share while the forwards themselves overlap."""

    def __init__(self, weights: Dict[str, float]):
        self.lock = threading.Lock()
        self.cond = threading.Condition(self.lock)
        self.held: Dict[str, List[_Waiter]] = {}
        self.buckets: Dict[str, TokenBucket] = {}
        self.weights = weights
        self._wrr_current: Dict[str, float] = {}
        self._rr = 0
        self.last_stamp = 0.0

    def bucket(self, tenant: str) -> TokenBucket:
        with self.lock:
            b = self.buckets.get(tenant)
            if b is None:
                b = self.buckets[tenant] = TokenBucket(
                    tenant_rate(), tenant_burst())
            return b

    # All the methods below are called with ``lock`` held.

    def held_count(self) -> int:
        return sum(len(q) for q in self.held.values())

    def enqueue(self, w: _Waiter) -> None:
        self.held.setdefault(w.tenant, []).append(w)

    def remove(self, w: _Waiter) -> None:
        q = self.held.get(w.tenant)
        if q and w in q:
            q.remove(w)
        if q is not None and not q:
            del self.held[w.tenant]

    def next_waiter(self) -> Optional[_Waiter]:
        """Smooth weighted round-robin pick across tenants with held
        requests — pure read (the WRR state advances only in
        ``advance``), so every parked thread can evaluate it."""
        tenants = [t for t, q in self.held.items() if q]
        if not tenants:
            return None
        best, best_cur = None, None
        for t in sorted(tenants):
            cur = (self._wrr_current.get(t, 0.0)
                   + self.weights.get(t, 1.0))
            if best_cur is None or cur > best_cur:
                best, best_cur = t, cur
        return self.held[best][0]

    def advance(self, w: _Waiter) -> None:
        """Commit one drain: ``w`` (the current ``next_waiter``) leaves
        the queue and its tenant pays the WRR debt."""
        tenants = [t for t, q in self.held.items() if q]
        total = sum(self.weights.get(t, 1.0) for t in tenants)
        for t in tenants:
            self._wrr_current[t] = (self._wrr_current.get(t, 0.0)
                                    + self.weights.get(t, 1.0))
        self._wrr_current[w.tenant] -= total
        self.remove(w)
        if not self.held:
            self._wrr_current.clear()


# -- the activator ------------------------------------------------------------

# A replica is reached directly: no proxy from the environment.
_OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def _default_forward(url, method, body, headers, timeout):
    """POST/GET ``url``; returns (status, headers-dict, body-bytes).
    Errors that mean 'backend unreachable' raise OSError for the replay
    loop to classify."""
    req = urllib.request.Request(url, data=body if body else None,
                                 headers=headers, method=method)
    try:
        with _OPENER.open(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers or {}), e.read()


class Activator:
    """The front-door data path (module docstring has the contract).

    ``client`` writes the wake annotation; ``book`` feeds endpoint
    discovery (default: the process-shared one the controller publishes
    into); ``tsdb`` is the stored-series home of the TTFT shed signal
    (default: the process-shared store the scrape pipeline fills);
    ``forward`` is the one transport hook (hermetic tests swap it)."""

    def __init__(self, client, *, book: Optional[EndpointBook] = None,
                 tsdb=None, forward=None, timeout: float = 30.0,
                 rng: Optional[random.Random] = None,
                 now: Callable[[], float] = time.time):
        from kubeflow_tpu_torch.telemetry import fleetscrape

        self.client = client
        self.book = book if book is not None else default_book()
        self.tsdb = tsdb if tsdb is not None else fleetscrape.default_tsdb()
        self.forward = forward or _default_forward
        self.timeout = timeout
        self.rng = rng or random.Random()
        self.now = now
        self._fronts: Dict[str, _ServiceFront] = {}
        self._fronts_lock = threading.Lock()
        self._knee_cache: Dict[str, Tuple[float, bool]] = {}
        self.book.subscribe(self._on_publish)

    # -- plumbing ---------------------------------------------------------

    def _front(self, key: str) -> _ServiceFront:
        with self._fronts_lock:
            f = self._fronts.get(key)
            if f is None:
                f = self._fronts[key] = _ServiceFront(tenant_weights())
            return f

    def _on_publish(self, key: str) -> None:
        with self._fronts_lock:
            f = self._fronts.get(key)
        if f is not None:
            with f.lock:
                f.cond.notify_all()

    def debug_snapshot(self) -> dict:
        with self._fronts_lock:
            fronts = dict(self._fronts)
        held = {}
        for key, f in fronts.items():
            with f.lock:
                if f.held:
                    held[key] = {t: len(q) for t, q in f.held.items()}
        return {"services": self.book.snapshot(), "held": held}

    # -- shed signal -------------------------------------------------------

    def _over_knee(self, key: str) -> bool:
        """Stored-series TTFT p99 past the knee?  Cached ~1s: the sample
        is a TSDB pass-join, not something to recompute per request."""
        rec = self.book.get(key)
        if rec is None or rec.ttft_target_s is None:
            return False
        cached = self._knee_cache.get(key)
        t = time.monotonic()
        if cached is not None and t - cached[0] < 1.0:
            return cached[1]
        from kubeflow_tpu_torch.telemetry import fleetscrape

        sample = fleetscrape.serve_sample(self.tsdb, key)
        over = (sample.ttft_p99_s is not None
                and sample.ttft_p99_s
                > rec.ttft_target_s * shed_ttft_multiple())
        self._knee_cache[key] = (t, over)
        return over

    # -- wake stamping -----------------------------------------------------

    def _stamp_wake(self, ns: str, name: str, front: _ServiceFront) -> None:
        """MERGE-patch the wake annotation with the CURRENT time.  Called
        on first hold and re-called every ``restamp_seconds`` while
        requests stay held: the autoscaler wakes on a stamp postdating
        its last scale-down, so a controller replica that raced an old
        stamp converges on the next re-stamp."""
        t = time.monotonic()
        with front.lock:
            if t - front.last_stamp < restamp_seconds() and front.last_stamp:
                return
            front.last_stamp = t
        try:
            self.client.patch(
                INFERENCESERVICE, name,
                {"metadata": {"annotations": {
                    api.ANNOTATION_WAKE: f"{self.now():.3f}"}}},
                ns, patch_type="merge")
            metrics.activator_wake_stamps_total.inc()
        except Exception:  # noqa: BLE001 — the hold retries on cadence
            with front.lock:
                front.last_stamp = 0.0

    # -- request path ------------------------------------------------------

    def handle(self, ns: str, name: str, rest: str, request):
        """One request (the port's ``web.serve_app.Request``) through the
        front door; returns ``(status, headers, body)``.  ``rest`` is
        the path past the VirtualService prefix (the backend sees
        ``/<rest>``: the Istio rewrite, honored)."""
        key = f"{ns}/{name}"
        tenant = request.headers.get(HEADER_TENANT) or "default"
        raw_deadline = request.headers.get(HEADER_DEADLINE)
        deadline = None
        if raw_deadline:
            try:
                deadline = time.monotonic() + float(raw_deadline)
            except ValueError:
                return failure(
                    f"malformed {HEADER_DEADLINE} {raw_deadline!r}", 400)
        front = self._front(key)

        # Admission: the per-tenant token bucket, with the burn-driven
        # surcharge past the SLO knee.  This is the ONLY early-out ahead
        # of the hold path — a held request was always admitted first.
        over = self._over_knee(key)
        cost = shed_cost() if over else 1.0
        granted, wait = front.bucket(tenant).take(cost)
        if not granted:
            reason = "slo-shed" if over else "tenant-bucket"
            return self._shed(tenant, reason, 429,
                              f"tenant {tenant!r} over admission rate "
                              f"({reason})",
                              retry_after=wait)

        rec = self.book.get(key)
        if rec is None:
            metrics.activator_proxy_requests_total.labels(
                outcome="error").inc()
            return failure(f"no such service {key}", 404)
        body = request.body
        headers = self._forward_headers(request, tenant, deadline,
                                        HEADER_TENANT, HEADER_PRIORITY,
                                        HEADER_DEADLINE)
        if rec.endpoints:
            return self._proxy(front, key, tenant, rest, request.method,
                               body, headers, deadline, held=False)
        return self._hold(front, ns, name, tenant, rest, request.method,
                          body, headers, deadline)

    def _forward_headers(self, request, tenant, deadline,
                         h_tenant, h_priority, h_deadline) -> dict:
        headers = {"Content-Type":
                   request.headers.get("Content-Type",
                                       "application/json"),
                   h_tenant: tenant}
        prio = request.headers.get(h_priority)
        if prio:
            headers[h_priority] = prio
        tp = request.headers.get("Traceparent") \
            or request.headers.get("traceparent")
        if tp:
            headers["traceparent"] = tp
        if deadline is not None:
            # Forwarded as the REMAINING budget (recomputed again right
            # before each attempt in _proxy): the replica's own deadline
            # gate then accounts the same clock this hold does.
            headers[h_deadline] = \
                f"{max(deadline - time.monotonic(), 0.0):.3f}"
        return headers

    def _shed(self, tenant: str, reason: str, status: int, msg: str, *,
              retry_after: Optional[float] = None):
        metrics.serve_requests_shed_total.labels(
            tenant=tenant, reason=reason).inc()
        metrics.activator_proxy_requests_total.labels(outcome="shed").inc()
        headers = None
        if status in (429, 503):
            headers = {"Retry-After":
                       str(max(1, math.ceil(retry_after or 1.0)))}
        return failure(msg, status, headers=headers)

    def _hold(self, front: _ServiceFront, ns: str, name: str, tenant: str,
              rest: str, method: str, body: bytes, headers: dict,
              deadline: Optional[float]):
        """Park one request across a cold start.  The thread sleeps on
        the front's condition; a book publish (ready endpoints) or
        another drain notifies it.  Exits: fair-share turn with a ready
        endpoint (replay), own-deadline 504, wake-deadline 503, or
        overflow 503 before ever parking."""
        key = f"{ns}/{name}"
        w = _Waiter(tenant)
        with front.lock:
            if front.held_count() >= hold_queue_limit():
                # Shed OUTSIDE the queue: the bound is the promise that
                # a hold never grows past what a wake can drain.
                pass_overflow = True
            else:
                pass_overflow = False
                front.enqueue(w)
        if pass_overflow:
            return self._shed(tenant, "hold-overflow", 503,
                              f"hold queue full for {key}",
                              retry_after=wake_deadline_seconds() / 4)
        metrics.serve_requests_held.inc()
        self._stamp_wake(ns, name, front)
        give_up = time.monotonic() + wake_deadline_seconds()
        try:
            while True:
                now = time.monotonic()
                if deadline is not None and now >= deadline:
                    with front.lock:
                        front.remove(w)
                    return self._shed(tenant, "deadline", 504,
                                      "request deadline expired while "
                                      f"held for {key} to wake")
                if now >= give_up:
                    with front.lock:
                        front.remove(w)
                    return self._shed(
                        tenant, "wake-timeout", 503,
                        f"wake deadline expired holding for {key}",
                        retry_after=wake_deadline_seconds())
                self._stamp_wake(ns, name, front)
                with front.lock:
                    rec = self.book.get(key)
                    if (rec is not None and rec.endpoints
                            and front.next_waiter() is w):
                        front.advance(w)
                        break
                    waits = [give_up - now, restamp_seconds()]
                    if deadline is not None:
                        waits.append(deadline - now)
                    front.cond.wait(timeout=max(min(waits), 0.01))
            # Drained: replay outside the lock, then hand the baton on.
            with front.lock:
                front.cond.notify_all()
            return self._proxy(front, key, tenant, rest, method, body,
                               headers, deadline, held=True)
        finally:
            metrics.serve_requests_held.dec()

    def _proxy(self, front: _ServiceFront, key: str, tenant: str,
               rest: str, method: str, body: bytes, headers: dict,
               deadline: Optional[float], *, held: bool):
        """Forward with bounded full-jitter retries.  Retries cover only
        outcomes a retry can fix — transport errors and the replica's
        503 (warming / overloaded) — and stop at the request deadline;
        every other status passes through verbatim."""
        last_err = "no ready endpoint"
        for attempt in range(replay_retries() + 1):
            if deadline is not None and time.monotonic() >= deadline:
                return self._shed(tenant, "deadline", 504,
                                  "request deadline expired during "
                                  f"replay to {key}")
            rec = self.book.get(key)
            if rec is None or not rec.endpoints:
                last_err = "no ready endpoint"
            else:
                with front.lock:
                    front._rr += 1
                    url = rec.endpoints[front._rr % len(rec.endpoints)]
                if deadline is not None:
                    headers = dict(headers)
                    headers[HEADER_DEADLINE] = \
                        f"{max(deadline - time.monotonic(), 0.0):.3f}"
                t0 = time.perf_counter()
                try:
                    status, rhead, rbody = self.forward(
                        url + "/" + rest.lstrip("/"), method, body,
                        headers, self.timeout)
                except Exception as e:  # noqa: BLE001 — transport
                    # failure classifies as retryable
                    last_err = f"transport: {e}"
                else:
                    if status != 503:
                        metrics.serve_tenant_ttft_seconds.labels(
                            tenant=tenant).observe(
                                time.perf_counter() - t0)
                        metrics.activator_proxy_requests_total.labels(
                            outcome="replayed" if held else "ok").inc()
                        out_headers = {"Content-Type":
                                       rhead.get("Content-Type",
                                                 "application/json")}
                        if rhead.get("Retry-After"):
                            out_headers["Retry-After"] = \
                                rhead["Retry-After"]
                        return status, out_headers, rbody
                    last_err = f"backend 503 from {url}"
            if attempt < replay_retries():
                time.sleep(full_jitter_backoff(
                    attempt, base=replay_base_seconds(),
                    cap=replay_cap_seconds(), rng=self.rng))
        metrics.activator_proxy_requests_total.labels(outcome="error").inc()
        return failure(
            f"replay budget exhausted for {key}: {last_err}", 503,
            headers={"Retry-After":
                     str(max(1, math.ceil(replay_cap_seconds())))})


_debug_registered: Optional[Activator] = None


def register_debug(activator: Optional[Activator]) -> None:
    """Single-slot debug registry (the ``jobqueue.debug_snapshot``
    pattern): the process running the activator registers it, so a
    health port can serve ``/debug/activator`` without holding a
    reference."""
    global _debug_registered
    _debug_registered = activator


def debug_snapshot() -> Optional[dict]:
    """The registered activator's snapshot, or None when no activator
    runs in this process (the health port answers 404)."""
    act = _debug_registered
    return act.debug_snapshot() if act is not None else None


def activator_port() -> int:
    """The front door's listen port (0: no activator in this replica)."""
    return config.knob(
        "KFT_ACTIVATOR_PORT", 8012, int,
        doc="serving front-door listen port (0 disables the activator "
            "data path in this replica)",
        validate=_at_least(0, "activator port"))


def create_activator_app(activator: Activator) -> App:
    """The front: the VirtualService path shape (``/serve/<ns>/<name>/
    <path>``) as a prefix route of the port's ``App``, plus health and
    a debug snapshot.  ``app.make_server(host, port)`` serves it."""
    app = App("activator")

    @app.route("/healthz")
    def healthz(request):
        return success({"healthy": True})

    @app.route("/debug/activator")
    def debug_activator(request):
        return json_response(activator.debug_snapshot())

    @app.route_prefix("/serve/", methods=("GET", "POST"))
    def serve(request, path):
        parts = path.split("/", 2)
        if len(parts) < 3 or not parts[0] or not parts[1]:
            return failure(f"no route /serve/{path}", 404)
        ns, name, rest = parts
        return activator.handle(ns, name, rest, request)

    return app
