"""Controller runtime: watch -> work queue -> level-triggered reconcile.

The port's copy of ``kubeflow_tpu/platform/runtime/controller.py``:
the reconciler's contract (``Request``, ``Result``, ``Reconciler``), the
rate-limited work queue, ``Controller`` and ``Manager`` (the slice of
controller-runtime the platform needs).

* The work queue is client-go's: pending keys are deduplicated, a key
  handed out by ``get`` stays excluded until ``done`` (re-adds park and
  fire on ``done``, at the earliest time asked for), failures back off
  exponentially until ``forget``.  So one key is never reconciled by two
  workers at once, at any worker count.
* A ``Controller`` watches its primary kind, the kinds it owns (events
  mapped to the controlling owner) and mapped kinds, from informers
  (``runtime/informer.py``) or raw client watches; resyncs from its
  primary's cache; runs N workers; carries each event's causal context
  from delivery to the reconcile (``telemetry/causal.py``); backs off on
  error and parks a key after ``CONTROLLER_MAX_RETRIES`` consecutive
  failures (the dead letter: a ``ReconcileFailed`` condition and a
  Warning event); and a watchdog reports a reconcile stuck past
  ``CONTROLLER_STUCK_SECONDS``.
* A ``Manager`` starts its controllers together, behind a Lease when
  ``leader_election=True`` (``runtime/leader.py``); lost leadership is
  terminal.
* Sharded HA (``runtime/sharding.py``): with ``shards=`` (a
  ``ShardCoordinator``) a controller enqueues and reconciles only the
  keys of the shards its replica owns, filters its informers to them
  (and, with ``KF_SHARD_SERVER_FILTER`` on, the server's streams too),
  resyncs a moved range when a shard is acquired, and sets the fence
  context around each reconcile so the replica's ``FencedClient``
  proves every write against the key's shard lease.  A ``Manager`` with
  ``shards=`` starts the coordinator before its controllers and stops
  it first, which releases the leases for an instant handover.

Threads, not goroutines.  The work queue is the native engine's
(``platform/native.py`` ``NativeWorkQueue``) when it loads, the Python
``_WorkQueue`` otherwise, with one interface and one set of series;
``Manager.start`` loads the engine first, so no watch event pays for
its build.
"""
from __future__ import annotations

import dataclasses
import heapq
import json
import logging
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional, Tuple

from kubeflow_tpu_torch.platform import config
from kubeflow_tpu_torch.platform.k8s.types import (
    GVK,
    Resource,
    controller_of,
    meta,
    name_of,
    namespace_of,
)
from kubeflow_tpu_torch.telemetry import causal

log = logging.getLogger("kubeflow_tpu_torch.runtime")

# Dead letter: after this many consecutive non-conflict failures of one
# key, stop the backoff requeues, write a terminal ReconcileFailed
# condition and Warning event on the primary, and park the key until a
# watch event or resync revives it.  0 retries forever.
DEFAULT_MAX_RETRIES = config.env_int("CONTROLLER_MAX_RETRIES", 15)
# A reconcile still in flight after this many seconds counts in
# reconcile_stuck_total and logs its trace so far.  0: no watchdog.
DEFAULT_STUCK_SECONDS = config.env_float("CONTROLLER_STUCK_SECONDS", 300.0)
# Reconcile workers a controller (CONTROLLER_WORKERS; one controller's
# by CONTROLLER_WORKERS_<NAME>, the name upper-cased with dashes as
# underscores): the queue's per-key exclusion makes any count safe.
DEFAULT_WORKERS = 4


def worker_count(name: str) -> int:
    """The worker count of controller ``name`` from the environment (its
    own override, then the fleet default)."""
    per = config.env_int(
        "CONTROLLER_WORKERS_" + name.upper().replace("-", "_"), 0)
    if per > 0:
        return per
    return max(1, config.env_int("CONTROLLER_WORKERS", DEFAULT_WORKERS))


@dataclasses.dataclass(frozen=True, order=True)
class Request:
    namespace: str
    name: str


@dataclasses.dataclass
class Result:
    requeue_after: Optional[float] = None  # seconds


class Reconciler:
    """Subclass and implement reconcile().  Raise to trigger backoff requeue."""

    def reconcile(self, req: Request) -> Optional[Result]:  # pragma: no cover
        raise NotImplementedError


class _WorkQueue:
    """Delaying, rate-limited queue with dedup of pending items and
    per-key mutual exclusion: a key returned by ``get`` is processing
    until ``done(key)``; re-adds meanwhile park in a dirty set and
    re-enqueue on ``done`` (client-go's work queue)."""

    def __init__(self, *, base_delay: float = 0.05, max_delay: float = 30.0,
                 metrics=None):
        # The WorkQueueMetrics shim (runtime/metrics.py), or None.
        self.metrics = metrics
        self._cond = threading.Condition()
        self._heap: List[Tuple[float, int, Request]] = []
        # req -> (seq of the live heap entry, its time); stale heap
        # entries (superseded by an earlier reschedule) drop on pop.
        self._pending: Dict[Request, Tuple[int, float]] = {}
        self._processing: set = set()
        self._dirty: Dict[Request, float] = {}  # re-adds while processing
        self._seq = 0
        self._failures: Dict[Request, int] = {}
        self._base = base_delay
        self._max = max_delay
        self._shutdown = False

    def add(self, req: Request, *, delay: float = 0.0) -> None:
        """Enqueue; an earlier add supersedes a later pending entry (a
        watch event does not wait out a backoff for its key)."""
        with self._cond:
            if self._shutdown:
                return
            if self.metrics is not None:
                self.metrics.on_add(req, delay=delay)
            when = time.monotonic() + max(delay, 0.0)
            if req in self._processing:
                # Parked until done(), at the earliest time asked for.
                cur = self._dirty.get(req)
                if cur is None or when < cur:
                    self._dirty[req] = when
                return
            live = self._pending.get(req)
            if live is not None and live[1] <= when:
                return  # an entry at least as early is queued
            self._seq += 1
            self._pending[req] = (self._seq, when)
            heapq.heappush(self._heap, (when, self._seq, req))
            self._cond.notify()

    def add_rate_limited(self, req: Request) -> None:
        with self._cond:
            if self._shutdown:
                return
            n = self._failures.get(req, 0)
            self._failures[req] = n + 1
        if self.metrics is not None:
            self.metrics.on_retry(req)
        self.add(req, delay=min(self._base * (2**n), self._max))

    def forget(self, req: Request) -> None:
        with self._cond:
            self._failures.pop(req, None)

    def get(self, timeout: float = 0.2) -> Optional[Request]:
        deadline = time.monotonic() + timeout
        with self._cond:
            while True:
                if self._shutdown:
                    return None
                now = time.monotonic()
                if self._heap and self._heap[0][0] <= now:
                    _, seq, req = heapq.heappop(self._heap)
                    live = self._pending.get(req)
                    if live is None or live[0] != seq:
                        continue  # superseded by a rescheduled entry
                    del self._pending[req]
                    self._processing.add(req)
                    if self.metrics is not None:
                        self.metrics.on_get(req)
                    return req
                if now >= deadline:
                    return None
                wait = deadline - now
                if self._heap:
                    wait = min(wait, self._heap[0][0] - now)
                self._cond.wait(timeout=max(wait, 0.001))

    def done(self, req: Request) -> None:
        """Release a key ``get`` handed out; a parked re-add fires now."""
        with self._cond:
            if self.metrics is not None and req in self._processing:
                self.metrics.on_done(req)
            self._processing.discard(req)
            when = self._dirty.pop(req, None)
            if when is not None and not self._shutdown:
                self._seq += 1
                self._pending[req] = (self._seq, when)
                heapq.heappush(self._heap, (when, self._seq, req))
                self._cond.notify()

    def pending(self) -> int:
        """Backlog depth: pending plus parked re-adds."""
        with self._cond:
            return len(self._pending) + len(self._dirty)

    def shut_down(self) -> None:
        with self._cond:
            self._shutdown = True
            self._cond.notify_all()


def make_workqueue(*, base_delay: float = 0.05, max_delay: float = 30.0,
                   name: Optional[str] = None):
    """A work queue: the native engine's ``NativeWorkQueue`` when it
    loads, else the Python ``_WorkQueue`` (same interface, held equal by
    the tests).  ``name`` turns on the ``workqueue_*`` series labelled
    ``{name=...}``, the same from either engine.  Every key ``get``
    returns must be released with ``done(key)``, in a ``finally``: until
    then the key is never handed out again."""
    from kubeflow_tpu_torch.platform import native

    shim = None
    if name is not None:
        from kubeflow_tpu_torch.platform.runtime import metrics

        shim = metrics.WorkQueueMetrics(name)
    if native.available():
        return native.NativeWorkQueue(base_delay=base_delay,
                                      max_delay=max_delay, metrics=shim)
    return _WorkQueue(base_delay=base_delay, max_delay=max_delay,
                      metrics=shim)


EventMapper = Callable[[Resource], List[Request]]


def _server_filter_enabled() -> bool:
    """KF_SHARD_SERVER_FILTER: push each informer's shard subscription to
    the server (the ``shard_filter`` of list and watch), so a replica's
    stream carries only its own ranges.  ``0`` turns it off (the full
    stream, the informer's admit filter alone); any other value leaves
    it on, and shows at /debug/knobs as env-invalid."""
    try:
        return config.knob(
            "KF_SHARD_SERVER_FILTER", "1",
            doc="server-side shard filtering of watch/list streams: "
                "1 on (default), 0 off (client-side admit only)",
            validate=lambda v: None if v in ("0", "1")
            else "must be '0' or '1'") != "0"
    except ValueError:
        return True


class Controller:
    def __init__(
        self,
        name: str,
        reconciler: Reconciler,
        *,
        primary: GVK,
        owns: Optional[List[GVK]] = None,
        watches: Optional[List[Tuple[GVK, EventMapper]]] = None,
        namespace: Optional[str] = None,
        resync_period: Optional[float] = None,
        workers: Optional[int] = None,
        runnables: Optional[List[Callable[["Controller"], None]]] = None,
        informers: Optional[dict] = None,
        shared_informers: Optional[dict] = None,
        on_start: Optional[Callable[[], None]] = None,
        on_stop: Optional[Callable[[], None]] = None,
        max_retries: Optional[int] = None,
        stuck_deadline: Optional[float] = None,
        shards=None,
        shard_sources: Optional[Dict[GVK, Optional[str]]] = None,
    ):
        self.name = name
        self.reconciler = reconciler
        self.primary = primary
        self.owns = owns or []
        self.watches = watches or []
        self.namespace = namespace
        self.resync_period = resync_period
        # None: resolved from the environment now.
        self.workers = workers if workers is not None else worker_count(name)
        # GVK -> Informer: a kind with an informer here is sourced from
        # its delta stream, the cache updated before the mapper enqueues,
        # so a reconcile an event triggers sees a cache at least as fresh
        # as that event.  ``informers`` are owned (started and stopped
        # here); ``shared_informers`` belong to another controller of the
        # manager, started idempotently here and never stopped.
        self._owned_informers: dict = informers or {}
        self._shared_informers: dict = shared_informers or {}
        self.informers: dict = {**self._shared_informers,
                                **self._owned_informers}
        # Side effects that live exactly as long as the controller (the
        # fleet collector pointed at this client, unhooked on stop).
        self._on_start = on_start
        self._on_stop = on_stop
        # Extra loops sharing the controller's lifecycle; each gets the
        # controller and returns when controller._stop is set.
        self.runnables = runnables or []
        self.queue = make_workqueue(name=name)
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()
        self.reconcile_count = 0
        self.error_count = 0
        # Dead letter: consecutive non-conflict failures per key (a 409
        # never counts) and the parked keys with their last error.  A
        # parked key still reconciles on a watch event or resync.
        self.max_retries = (max_retries if max_retries is not None
                            else DEFAULT_MAX_RETRIES)
        self.dead_letters: Dict[Request, str] = {}
        self._key_failures: Dict[Request, int] = {}
        # The watchdog's view: req -> [monotonic start, trace, reported].
        self.stuck_deadline = (stuck_deadline if stuck_deadline is not None
                               else DEFAULT_STUCK_SECONDS)
        self._inflight: Dict[Request, list] = {}
        self._inflight_lock = threading.Lock()
        # The causal context a watch-delivered object carried, from its
        # enqueue to its dequeue (the queue carries only keys): Request ->
        # (TraceContext, delivery wall time).
        self._pending_ctx: Dict[Request, Tuple] = {}
        self._pending_ctx_lock = threading.Lock()
        self._client = None    # set by start(); dead-letter writes need it
        self._recorder = None  # the dead letter's EventRecorder, lazily
        # Sharded HA: a ShardCoordinator partitions the keyspace across
        # replicas.  The controller then enqueues only owned keys, drops
        # unowned keys at dequeue (ownership may move while a key waits),
        # filters its informers to the owned ranges and resyncs a moved
        # range on an acquisition.  The write invariant (one replica a
        # key) is the FencedClient's: this filter is the fast path, the
        # fence is the proof.
        self.shards = shards
        # GVK -> ShardFilter source overriding what _wire_sharding
        # derives (primary "self", owned kinds "owner=<primary kind>");
        # ``watches`` kinds stream unfiltered unless named here (their
        # mappers are Python the server cannot mirror).  None forces a
        # kind unfiltered.
        self.shard_sources: Dict[GVK, Optional[str]] = dict(
            shard_sources or {})

    # -- event plumbing ------------------------------------------------------

    def _owns(self, req: Request) -> bool:
        """The enqueue/dequeue shard filter: an unsharded controller owns
        every key."""
        return (self.shards is None
                or self.shards.owns_key(req.namespace, req.name))

    def _primary_mapper(self, obj: Resource) -> List[Request]:
        return [Request(namespace_of(obj) or "", name_of(obj))]

    def _owner_mapper(self, obj: Resource) -> List[Request]:
        ref = controller_of(obj)
        if ref and ref.get("kind") == self.primary.kind:
            return [Request(namespace_of(obj) or "", ref.get("name", ""))]
        return []

    def _enqueue(self, obj: Resource, mapper: EventMapper) -> None:
        reqs = [r for r in mapper(obj) if self._owns(r)]
        self._note_event(obj, reqs)
        for req in reqs:
            self.queue.add(req)

    def _note_event(self, obj: Resource, reqs: List[Request]) -> None:
        """At watch delivery: record the stamp's watch lag (its first
        delivery only, within causal.WATCH_LAG_MAX_S) and park the
        object's context for the dequeue.  An object without a context (a
        kubelet's pod) passes: the reconcile falls back to the primary's
        own annotation."""
        if not reqs:
            return
        ctx = causal.from_object(obj)
        if ctx is None:
            return
        now = time.time()
        if ctx.stamped_ts is not None:
            lag = now - ctx.stamped_ts
            if lag >= 0.0 and causal.first_lag_observation(
                    ctx.trace_id, ctx.span_id):
                from kubeflow_tpu_torch.platform.runtime import metrics

                kind = obj.get("kind", "")
                if lag <= causal.WATCH_LAG_MAX_S:
                    causal.record(
                        "watch_lag", trace_id=ctx.trace_id,
                        parent_span_id=ctx.span_id, segment="watch_lag",
                        start_ts=ctx.stamped_ts, end_ts=now, kind=kind,
                        controller=self.name, **self._replica())
                    metrics.informer_watch_lag_seconds.labels(
                        kind=kind).observe(lag)
                else:
                    # A relist's replay of an old stamp, or a watch path
                    # degraded past the bound: counted, not a span.
                    metrics.informer_watch_lag_overflow_total.labels(
                        kind=kind).inc()
        with self._pending_ctx_lock:
            if len(self._pending_ctx) > 8192:
                # Keys that never dequeue here (a moved shard, the queue's
                # dedup) would grow this without bound; a flush costs a
                # queue_wait span, not correctness.
                self._pending_ctx.clear()
            for req in reqs:
                self._pending_ctx[req] = (ctx, now)

    def _replica(self) -> dict:
        """The ``replica`` attribute of a sharded controller's spans."""
        return ({"replica": self.shards.identity}
                if self.shards is not None else {})

    def _event_context(self, req: Request):
        """(context, delivery time) parked for a dequeued key, or
        (None, None)."""
        with self._pending_ctx_lock:
            return self._pending_ctx.pop(req, (None, None))

    def _install_lazy_context(self, req: Request, box: dict) -> None:
        """Arm this thread's causal context with a factory that reads the
        primary's annotation from the informer cache, resolved only if the
        reconcile writes; the parent lands in ``box``."""
        informer = self.informers.get(self.primary)
        if informer is None or not informer.has_synced:
            return

        def factory():
            obj = informer.get(req.name, req.namespace or None)
            pctx = causal.from_object(obj) if obj is not None else None
            if pctx is None:
                return None
            box["parent"] = pctx
            return causal.child(pctx)

        causal.set_lazy(factory)

    def _watch_loop(self, client, gvk: GVK, mapper: EventMapper) -> None:
        """A raw watch source.  A re-establishment resumes from the last
        resourceVersion seen (no replay of the whole kind); an ERROR
        event, or a 410 at establishment, falls back to one full replay;
        consecutive failures back off exponentially."""
        from kubeflow_tpu_torch.platform.k8s.errors import ApiError

        rv: Optional[str] = None
        failures = 0
        while not self._stop.is_set():
            try:
                for etype, obj in client.watch(
                    gvk, self.namespace, resource_version=rv, stop=self._stop
                ):
                    failures = 0
                    if etype == "ERROR":
                        rv = None
                        self._stop.wait(1.0)
                        break
                    self._enqueue(obj, mapper)
                    new_rv = meta(obj).get("resourceVersion")
                    if new_rv is not None:
                        rv = new_rv
            except Exception as e:
                if not self._stop.is_set():
                    log.warning("%s: watch on %s failed, retrying:\n%s",
                                self.name, gvk.kind, traceback.format_exc())
                    if isinstance(e, ApiError) and e.status == 410:
                        rv = None
                    failures += 1
                    self._stop.wait(min(1.0 * 2 ** (failures - 1), 30.0))

    def _resync_once(self, client) -> int:
        """Enqueue every owned primary key; returns how many.  From the
        primary's informer when it has synced (its keys only: under
        sharding already the owned ranges, the ownership check a second
        fence for the window between a release and the refilter), else
        one LIST."""
        n = 0
        informer = self.informers.get(self.primary)
        if informer is not None and informer.has_synced:
            for ns, name in informer.keys(self.namespace):
                req = Request(ns, name)
                if self._owns(req):
                    self.queue.add(req)
                    n += 1
        else:
            for obj in client.list(self.primary, self.namespace):
                for req in self._primary_mapper(obj):
                    if self._owns(req):
                        self.queue.add(req)
                        n += 1
        return n

    def _resync_loop(self, client) -> None:
        while not self._stop.wait(self.resync_period):
            try:
                self._resync_once(client)
            except Exception:
                log.warning("%s: resync list failed", self.name, exc_info=True)

    def _worker(self) -> None:
        from kubeflow_tpu_torch.telemetry import profiler

        profiler.register_thread_role(self.name)
        while not self._stop.is_set():
            req = self.queue.get()
            if req is None:
                continue
            try:
                self._reconcile_one(req)
            finally:
                self.queue.done(req)

    def _reconcile_one(self, req: Request) -> None:
        from kubeflow_tpu_torch.platform.k8s.errors import (
            AlreadyExists,
            Conflict,
        )
        from kubeflow_tpu_torch.platform.runtime import metrics, trace

        if not self._owns(req):
            # Ownership moved while the key waited (a rebalance, a
            # handover): the key is another replica's now.  Drop it, with
            # no retry history to greet it if the shard comes back.
            self.queue.forget(req)
            self._key_failures.pop(req, None)
            with self._pending_ctx_lock:
                self._pending_ctx.pop(req, None)
            return
        if self.shards is not None:
            from kubeflow_tpu_torch.platform.runtime import sharding

            # The fence context: every write this reconcile makes (inline
            # or fanned out through a FlightPool) is fenced on this key's
            # shard by the replica's FencedClient.
            sharding.set_current_request((req.namespace, req.name))
        # The reconcile's trace: spans opened on this thread attach to it;
        # the dequeue span replays the queue wait the shim observed.
        tr = trace.begin(self.name, f"{req.namespace}/{req.name}")
        shim = self.queue.metrics
        if tr is not None and shim is not None:
            tr.add_span("dequeue", duration_s=shim.wait_of(req),
                        queue="workqueue")
        # The causal journey: the context parked at watch delivery (or,
        # lazily, the primary's own) is this thread's current context, so
        # writes and child stamps link to it.
        cctx, delivered_ts = self._event_context(req)
        rctx = None
        lazy_box: Dict = {}
        wall0 = time.time()
        causal.consume_mark()  # clear a stale mark on this worker
        if cctx is not None:
            causal.record(
                "queue_wait", trace_id=cctx.trace_id,
                parent_span_id=cctx.span_id, segment="queue_wait",
                start_ts=delivered_ts, end_ts=wall0, controller=self.name)
            rctx = causal.child(cctx)
            causal.set_current(rctx)
            if tr is not None:
                tr.links["causal_trace_id"] = cctx.trace_id
                tr.links["causal_span_id"] = rctx.span_id
        else:
            self._install_lazy_context(req, lazy_box)
        outcome = "success"
        t0 = time.perf_counter()
        with self._inflight_lock:
            self._inflight[req] = [time.monotonic(), tr, False]
        try:
            with trace.span("reconcile"):
                result = self.reconciler.reconcile(req)
            self.queue.forget(req)
            self.reconcile_count += 1
            self._on_reconcile_success(req)
            if result and result.requeue_after:
                outcome = "requeue_after"
                self.queue.add(req, delay=result.requeue_after)
        except Exception as e:
            outcome = "error"
            self.error_count += 1
            metrics.reconcile_errors_total.labels(controller=self.name).inc()
            # A 409 of optimistic concurrency heals by the requeue and
            # never counts toward the dead letter; AlreadyExists (also a
            # 409) is a create collision a requeue cannot heal.
            if isinstance(e, Conflict) and not isinstance(e, AlreadyExists):
                log.info("%s: reconcile %s/%s conflicted (will retry): %s",
                         self.name, req.namespace, req.name, e)
                self.queue.add_rate_limited(req)
            else:
                log.error("%s: reconcile %s/%s failed:\n%s",
                          self.name, req.namespace, req.name,
                          traceback.format_exc())
                failures = self._key_failures.get(req, 0) + 1
                self._key_failures[req] = failures
                if self.max_retries and failures > self.max_retries:
                    outcome = "dead_letter"
                    self._dead_letter(req, e, failures)
                else:
                    self.queue.add_rate_limited(req)
        finally:
            if self.shards is not None:
                from kubeflow_tpu_torch.platform.runtime import sharding

                sharding.set_current_request(None)
            # An event-driven reconcile always lands on the journey; a
            # lazy-context one (a resync, an event on an unstamped
            # object) only when it acted: its factory resolved because a
            # write asked for the context.
            if rctx is None:
                rctx = causal.current_resolved()
                cctx = lazy_box.get("parent")
                if tr is not None and rctx is not None and cctx is not None:
                    tr.links["causal_trace_id"] = cctx.trace_id
                    tr.links["causal_span_id"] = rctx.span_id
            if rctx is not None and (delivered_ts is not None
                                     or causal.consume_mark()):
                causal.record(
                    "reconcile", trace_id=rctx.trace_id,
                    span_id=rctx.span_id,
                    parent_span_id=(cctx.span_id if cctx is not None
                                    else None),
                    segment="reconcile", start_ts=wall0,
                    end_ts=time.time(), controller=self.name,
                    request=f"{req.namespace}/{req.name}", result=outcome,
                    **self._replica())
            causal.set_current(None)
            with self._inflight_lock:
                self._inflight.pop(req, None)
            metrics.controller_runtime_reconcile_time_seconds.labels(
                controller=self.name, result=outcome
            ).observe(time.perf_counter() - t0)
            trace.finish(result=outcome)

    # -- dead-letter path ----------------------------------------------------

    def _on_reconcile_success(self, req: Request) -> None:
        self._key_failures.pop(req, None)
        if self.dead_letters.pop(req, None) is not None:
            log.info("%s: %s/%s recovered from dead-letter",
                     self.name, req.namespace, req.name)
            self._write_terminal_condition(req, clear=True)

    def _dead_letter(self, req: Request, exc: Exception, failures: int) -> None:
        """Park a key that exhausted its retries: no more backoff
        requeues, a terminal ``ReconcileFailed`` condition and Warning
        event on the primary, and a count.  A re-park of a parked key (a
        resync tried it again) writes nothing."""
        from kubeflow_tpu_torch.platform.runtime import metrics

        already_parked = req in self.dead_letters
        self.dead_letters[req] = str(exc)
        # The next revival reconciles promptly, not after a maxed backoff.
        self.queue.forget(req)
        if already_parked:
            return
        metrics.reconcile_dead_letter_total.labels(controller=self.name).inc()
        log.error("%s: %s/%s dead-lettered after %d consecutive failures "
                  "(parked until a new event; last error: %s)",
                  self.name, req.namespace, req.name, failures, exc)
        self._write_terminal_condition(req, message=str(exc))

    def _write_terminal_condition(self, req: Request, *,
                                  message: str = "", clear: bool = False) -> None:
        """Set (or clear) status.conditions[ReconcileFailed] on the
        primary and record the event, best effort: the client may be what
        is broken, and the bookkeeping above stands regardless."""
        client = self._client
        if client is None:
            return
        try:
            obj = client.get(self.primary, req.name, req.namespace or None)
        except Exception:
            return
        conditions = [c for c in (obj.get("status") or {}).get("conditions", [])
                      if c.get("type") != "ReconcileFailed"]
        if not clear:
            conditions.append({
                "type": "ReconcileFailed", "status": "True",
                "reason": "MaxRetriesExceeded",
                "message": message,
                "lastTransitionTime": time.strftime(
                    "%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            })
        try:
            # A conditions-only merge patch of the status: no
            # resourceVersion, so it cannot 409 against whatever broke
            # the reconcile.
            patcher = getattr(client, "patch_status", None)
            if patcher is not None:
                patcher(self.primary, req.name,
                        {"status": {"conditions": conditions}},
                        req.namespace or None)
            else:
                obj.setdefault("status", {})["conditions"] = conditions
                # kft: disable=R004 fallback for test doubles without patch_status
                client.update_status(obj)
        except Exception:
            log.debug("%s: could not write ReconcileFailed condition for "
                      "%s/%s", self.name, req.namespace, req.name,
                      exc_info=True)
        if not clear:
            try:
                from kubeflow_tpu_torch.platform.runtime.events import (
                    EventRecorder,
                )

                if self._recorder is None:
                    # One recorder a controller: its correlator turns a
                    # repeated dead letter into a count increment.
                    self._recorder = EventRecorder(client, self.name)
                self._recorder.event(
                    obj, "Warning", "ReconcileFailed",
                    f"reconcile gave up after max retries: {message}")
            except Exception:
                log.debug("%s: could not record ReconcileFailed event for "
                          "%s/%s", self.name, req.namespace, req.name,
                          exc_info=True)

    # -- stuck-reconcile watchdog --------------------------------------------

    def _watchdog_loop(self) -> None:
        """Report in-flight reconciles past their deadline, once each: a
        count and one log line with the trace so far (where it is
        stuck)."""
        from kubeflow_tpu_torch.platform.runtime import metrics

        period = max(0.01, min(self.stuck_deadline / 4.0, 5.0))
        while not self._stop.wait(period):
            now = time.monotonic()
            with self._inflight_lock:
                overdue = [
                    (req, entry) for req, entry in self._inflight.items()
                    if now - entry[0] >= self.stuck_deadline and not entry[2]
                ]
                for _req, entry in overdue:
                    entry[2] = True
            for req, entry in overdue:
                metrics.reconcile_stuck_total.labels(
                    controller=self.name).inc()
                tr = entry[1]
                # The trace belongs to a live reconcile on another thread:
                # serializing it may race, and must not kill this thread.
                dump = ""
                if tr is not None:
                    try:
                        dump = "; trace so far: " + json.dumps(
                            tr.to_dict(), sort_keys=True)
                    except Exception:
                        dump = "; trace unavailable (reconcile actively " \
                               "tracing)"
                log.error(
                    "%s: reconcile %s/%s stuck for %.1fs (deadline %.1fs)%s",
                    self.name, req.namespace, req.name,
                    now - entry[0], self.stuck_deadline, dump)

    # -- sharded HA ----------------------------------------------------------

    def _wire_sharding(self, pairs: List[Tuple[GVK, EventMapper]]) -> None:
        """Point every event-source informer's admit filter at the shard
        map and subscribe to rebalances.  The filter routes an object
        through the same mappers as the event path: it is cached iff one
        request it maps to falls in an owned shard, so the caches hold
        exactly what this replica's reconciles read (a Pod by its
        notebook's key, not its own)."""
        from kubeflow_tpu_torch.platform.runtime.sharding import ShardFilter

        mappers_by_gvk: Dict[GVK, List[EventMapper]] = {}
        for gvk, mapper in pairs:
            mappers_by_gvk.setdefault(gvk, []).append(mapper)
        # The server-side subscription of each kind: the ShardFilter
        # source that mirrors its key derivation.
        server_filter = _server_filter_enabled()
        sources: Dict[GVK, Optional[str]] = {self.primary: "self"}
        for g in self.owns:
            sources[g] = f"owner={self.primary.kind}"
        sources.update(self.shard_sources)
        for gvk, mappers in mappers_by_gvk.items():
            informer = self.informers.get(gvk)
            if informer is None:
                continue

            def admit(obj, _mappers=tuple(mappers)) -> bool:
                for mapper in _mappers:
                    for req in mapper(obj):
                        if self.shards.owns_key(req.namespace, req.name):
                            return True
                return False

            if informer.admit is not None:
                # First sharer wins: a shared informer (the culler over
                # the notebook controller's Notebook cache) keeps its
                # owner's filter, which maps keys identically.
                log.debug("%s: informer %s already shard-filtered by its "
                          "owner; keeping that filter", self.name, gvk.kind)
                continue
            informer.admit = admit
            source = sources.get(gvk)
            if server_filter and source is not None:
                # Attached only together with admit (the same controller,
                # the same key derivation): the server must deliver a
                # superset of what admit takes.  It subscribes owned and
                # draining shards: a draining shard's deltas flow until
                # its lease is released.
                def subscription(_source=source):
                    shards = frozenset(
                        self.shards.owned() | self.shards.draining())
                    if not shards:
                        # Nothing leased yet: stream unfiltered and let
                        # admit drop, or the informer would be blind to an
                        # acquisition racing its first establishment.
                        return None
                    return ShardFilter(self.shards.num_shards,
                                       shards, _source).spec()

                informer.shard_subscription = subscription
        self.shards.add_listener(self._on_shard_change)
        self.shards.add_drain_hook(self._shard_quiesced)

    def _shard_quiesced(self, shard: int) -> bool:
        """The drain hook of a voluntary handover: True when no reconcile
        of a key in ``shard`` is in flight here.  The coordinator
        releases a lease only once every controller says so, so a
        straggler's write never overlaps the acquirer's."""
        from kubeflow_tpu_torch.platform.runtime.sharding import shard_of

        with self._inflight_lock:
            return not any(
                shard_of(r.namespace, r.name, self.shards.num_shards)
                == shard
                for r in self._inflight)

    def _on_shard_change(self, acquired: set, released: set) -> None:
        """The rebalance reaction (on the coordinator's dispatch thread, or
        on the worker that fenced itself): a release drops the moved
        ranges from the caches; an acquisition also relists, so the moved
        range lands and its ADDED deltas enqueue — the only resync a
        rebalance costs."""
        if self._stop.is_set():
            return
        log.info("%s: shard map changed (acquired=%s released=%s)",
                 self.name, sorted(acquired), sorted(released))
        # The event's epoch dedupes an informer shared by two controllers:
        # one relist a rebalance.
        token = getattr(self.shards, "current_event_epoch", None)
        for informer in dict.fromkeys(self.informers.values()):
            try:
                informer.refilter(relist=bool(acquired), token=token)
            except Exception:
                log.exception("%s: refilter after shard change failed",
                              self.name)
        if acquired and self.informers.get(self.primary) is None:
            # A raw-watch primary has no informer to relist: one LIST,
            # enqueueing only the acquired ranges.
            from kubeflow_tpu_torch.platform.runtime.sharding import shard_of

            client = self._client
            if client is None:
                return
            try:
                for obj in client.list(self.primary, self.namespace):
                    for req in self._primary_mapper(obj):
                        if shard_of(req.namespace, req.name,
                                    self.shards.num_shards) in acquired:
                            self.queue.add(req)
            except Exception:
                log.warning("%s: moved-range list failed (resync will "
                            "recover)", self.name, exc_info=True)

    # -- lifecycle -----------------------------------------------------------

    def _spawn(self, target, name: str, *args) -> None:
        t = threading.Thread(target=target, args=args, name=name, daemon=True)
        t.start()
        self._threads.append(t)

    def start(self, client) -> None:
        self._client = client
        if self._on_start is not None:
            self._on_start()
        pairs: List[Tuple[GVK, EventMapper]] = [
            (self.primary, self._primary_mapper)]
        pairs += [(g, self._owner_mapper) for g in self.owns]
        pairs += self.watches
        if self.shards is not None:
            self._wire_sharding(pairs)
        for gvk, mapper in pairs:
            informer = self.informers.get(gvk)
            if informer is not None:
                informer.add_handler(
                    lambda _etype, obj, _mapper=mapper:
                    self._enqueue(obj, _mapper))
                continue
            self._spawn(self._watch_loop, f"{self.name}-watch-{gvk.kind}",
                        client, gvk, mapper)
        primary_informer = self.informers.get(self.primary)
        if (primary_informer is not None and self.resync_period
                and primary_informer in self._owned_informers.values()):
            # The resync reads the cache, so the informer's relist is the
            # real safety net against missed deltas: give it this
            # controller's period (owned informers only).
            primary_informer.resync_period = min(
                primary_informer.resync_period, self.resync_period)
        for informer in self.informers.values():
            informer.start()
        for informer in self.informers.values():
            # Workers never run against an unsynced cache (it would read
            # as zero pods and write false status): a sync failure is
            # fatal.
            if not informer.wait_for_sync(30.0):
                self.stop()
                raise RuntimeError(
                    f"{self.name}: informer cache for "
                    f"{informer.gvk.kind} failed to sync within 30s; "
                    "refusing to start workers against an unsynced cache")
        if self.resync_period:
            self._spawn(self._resync_loop, f"{self.name}-resync", client)
        for i in range(self.workers):
            self._spawn(self._worker, f"{self.name}-worker-{i}")
        if self.stuck_deadline and self.stuck_deadline > 0:
            self._spawn(self._watchdog_loop, f"{self.name}-watchdog")
        for i, fn in enumerate(self.runnables):
            self._spawn(fn, f"{self.name}-runnable-{i}", self)

    def stop(self) -> None:
        self._stop.set()
        self.queue.shut_down()
        if self.shards is not None:
            self.shards.remove_listener(self._on_shard_change)
            self.shards.remove_drain_hook(self._shard_quiesced)
        for informer in self._owned_informers.values():
            informer.stop()
        if self._on_stop is not None:
            self._on_stop()

    @property
    def stopped(self) -> bool:
        return self._stop.is_set()

    def reconcile_now(self, req: Request) -> Optional[Result]:
        """A synchronous reconcile, for deterministic tests."""
        return self.reconciler.reconcile(req)


class Manager:
    """A client and its controllers, started and stopped together.

    With ``leader_election=True`` the manager contends for a
    coordination.k8s.io Lease and starts its controllers only once it
    leads.  Lost leadership is terminal: the controllers stop and
    ``healthy()`` turns false, so the liveness probe restarts the pod.

    With ``shards=`` (a ``ShardCoordinator`` its controllers share) every
    replica is active on its own ranges: the coordinator starts before
    the controllers, so leases land while the caches sync, and stops
    first, releasing the leases so survivors take over at once.  It
    excludes ``leader_election``: sharding replaces the single leader.
    """

    def __init__(self, client, *, leader_election: bool = False,
                 lease_name: str = "kubeflow-tpu-controller-leader",
                 lease_namespace: str = "kubeflow",
                 identity: Optional[str] = None,
                 shards=None):
        self.client = client
        self.controllers: List[Controller] = []
        self._started = False
        self._lost_leadership = False
        self.elector = None
        self.shards = shards
        if shards is not None and leader_election:
            raise ValueError(
                "leader_election and shards are mutually exclusive: "
                "sharding replaces the single-leader model")
        if leader_election:
            from kubeflow_tpu_torch.platform.runtime.leader import (
                LeaderElector,
            )

            self.elector = LeaderElector(
                client,
                name=lease_name,
                namespace=lease_namespace,
                identity=identity,
                on_started_leading=self._start_controllers,
                on_stopped_leading=self._on_lost_leadership,
            )

    def add(self, controller: Controller) -> Controller:
        self.controllers.append(controller)
        if self._started:
            controller.start(self.client)
        return controller

    def _start_controllers(self) -> None:
        self._started = True
        for c in self.controllers:
            c.start(self.client)

    def _on_lost_leadership(self) -> None:
        # Terminal: a stopped controller cannot restart (its queue is
        # shut down), so stop contending too.
        self._lost_leadership = True
        if self.elector is not None:
            self.elector._stop.set()  # signal only; joining self deadlocks
        for c in self.controllers:
            c.stop()

    def start(self) -> None:
        from kubeflow_tpu_torch.platform import native

        # Build and load the engine now, not on the first event's path.
        native.preload()
        if self.shards is not None:
            self.shards.start()
        if self.elector is not None:
            self.elector.start()  # controllers start when the lease lands
        else:
            self._start_controllers()

    def stop(self) -> None:
        if self.shards is not None:
            self.shards.stop()  # release the leases first: instant handover
        if self.elector is not None:
            self.elector.stop()
        for c in self.controllers:
            c.stop()

    def healthy(self) -> bool:
        if self._lost_leadership:
            return False
        if self.elector is not None:
            return True  # a standby is waiting, not broken
        return self._started

    @property
    def is_leader(self) -> bool:
        return self.elector.is_leader if self.elector else self._started
