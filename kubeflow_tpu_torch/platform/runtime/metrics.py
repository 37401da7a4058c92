"""The control plane's metrics that the notebook and job paths write, on
the port's own registry (``telemetry/metrics.py``; no
``prometheus_client``).

The port's copy of the series of ``kubeflow_tpu/platform/runtime/
metrics.py`` that the notebook reconciler, the event recorder and the
flight pool write: notebook creations and their failures, the
spawn-to-ready histogram, the event recorder's outcomes, the flights
fanned out, and the scrape-time fleet gauges (``notebook_running`` and
``gpus_requested`` per namespace, in place of the reference's
``tpu_chips_requested``).  And those the GPUJob reconciler and its
queue write, the reference's ``tpujob_*`` as ``gpujob_*``: gang
restarts, preemptions by reason, the queue wait at admission, the queue
depth per profile, the slices allocated, and the scrape-time job fleet
gauges (``gpujob_jobs{phase}``, ``gpujob_slices_ready`` and
``gpujob_slices`` per namespace), with the scrape-time
``gpujob_queue_oldest_wait_seconds{profile}`` read from the registered
queue.  And the controller runtime's: client-go's work-queue series
(through the ``WorkQueueMetrics`` shim), reconcile latency, errors,
stuck reconciles and dead letters, the culler's probes and culls, the
shard coordinator's lease transitions and its scrape-time
``controller_shard_owned{controller,shard}``, and the informers' watch
restarts, watch lag, relist durations and last-sync ages.  And the REST
client's (``k8s/client.py``): requests by verb, kind and code, their
latency, retries and the circuit breaker's state and trips; and
``native_engine_active{component}`` (``platform/native.py``).  And the
serving front door's: the InferenceService controller's scale events,
cold starts, rollouts and scrape errors with the scrape-time
``inferenceservice_services{phase}``, ``inferenceservice_replicas`` and
``inferenceservice_ready_replicas`` per namespace; the activator's held
requests, sheds, per-tenant first-byte seconds, proxy outcomes and wake
stamps; and the fleet scrape's errors, samples, targets and the TSDB's
evictions (``telemetry/fleetscrape.py``).  And the user's front
door's: ``request_kf{component,kind}`` and ``request_kf_failure{component,
kind,severity}`` (the web apps, KFAM and the profile controller),
``degraded_responses_total{component}`` (a web read served from a cache)
and ``service_heartbeat{component,severity}`` with its ticker
(``start_heartbeat``/``stop_heartbeat``).  ``render()`` is the
``/metrics`` page.
"""
from __future__ import annotations

import threading
import time
import weakref
from typing import Dict, Tuple

from kubeflow_tpu_torch.telemetry.metrics import (
    Counter,
    Gauge,
    Histogram,
    Registry,
    ScrapeGauge,
)

registry = Registry()

notebook_create_total = Counter(
    "notebook_create_total", "Total Notebook creations handled",
    registry=registry)
notebook_create_failed_total = Counter(
    "notebook_create_failed_total", "Failed Notebook creations",
    registry=registry)
notebook_culling_total = Counter(
    "notebook_culling_total", "Total notebooks culled for idleness",
    registry=registry)
last_culling_timestamp = Gauge(
    "last_notebook_culling_timestamp_seconds",
    "Timestamp of the last culling operation", registry=registry)
notebook_spawn_seconds = Histogram(
    "notebook_spawn_to_ready_seconds",
    "Seconds from Notebook creation to all workers Ready",
    buckets=(5, 10, 20, 30, 60, 120, 300, 600), registry=registry)
flight_pool_flights_total = Counter(
    "flight_pool_flights_total",
    "Secondary writes fanned out through a FlightPool (one per submitted "
    "call; inline short-circuits are not counted)",
    ["pool"], registry=registry)
event_recorder_events_total = Counter(
    "event_recorder_events_total",
    "EventRecorder outcomes after correlation: create (novel key), patch "
    "(count-increment of the existing Event), drop (spam-filter token "
    "bucket exhausted, no API call)",
    ["action"], registry=registry)


class NotebookFleetCollector:
    """The scrape-time fleet gauges: one Notebook list over ``client`` a
    family and scrape, never one a reconcile.  The client is swappable
    (``register_fleet_collector``), so a restarted controller re-points
    the registered gauges."""

    def __init__(self):
        self.client = None

    def per_namespace(self) -> Dict[str, Tuple[int, int]]:
        """namespace -> (GPUs requested, notebooks running), stopped
        notebooks left out; empty without a client or when the list
        fails (a scrape must not take the page down)."""
        from kubeflow_tpu_torch.platform.apis import notebook as nbapi
        from kubeflow_tpu_torch.platform.k8s.types import (
            NOTEBOOK,
            namespace_of,
        )

        client = self.client
        if client is None:
            return {}
        try:
            notebooks = client.list(NOTEBOOK, None)
        except Exception:  # noqa: BLE001 — a scrape must not fail
            return {}
        per_ns: Dict[str, Tuple[int, int]] = {}
        for nb in notebooks:
            if nbapi.is_stopped(nb):
                continue
            ns = namespace_of(nb) or ""
            n_gpus, n_running = per_ns.get(ns, (0, 0))
            s = nbapi.gpu_slice_or_none(nb)
            per_ns[ns] = (n_gpus + (s.total_gpus if s else 0), n_running + 1)
        return per_ns


_fleet_collector = NotebookFleetCollector()
ScrapeGauge(
    "gpus_requested", "nvidia.com/gpu requested by notebooks, per namespace",
    lambda: [((ns,), g) for ns, (g, _) in
             sorted(_fleet_collector.per_namespace().items())],
    ["namespace"], registry=registry)
ScrapeGauge(
    "notebook_running", "Running notebooks by namespace",
    lambda: [((ns,), n) for ns, (_, n) in
             sorted(_fleet_collector.per_namespace().items())],
    ["namespace"], registry=registry)


def register_fleet_collector(client) -> None:
    """Point the fleet gauges at ``client`` (None unhooks them)."""
    _fleet_collector.client = client


gpujob_restarts_total = Counter(
    "gpujob_restarts_total",
    "whole-gang GPUJob restarts (any worker pod failure tears down and "
    "recreates every slice)", registry=registry)
gpujob_queue_depth = Gauge(
    "gpujob_queue_depth",
    "GPUJobs parked Queued waiting for quota/pool capacity, per profile "
    "namespace", ["profile"], registry=registry)
gpujob_queue_wait_seconds = Histogram(
    "gpujob_queue_wait_seconds",
    "Seconds a GPUJob waited in the admission queue before its gang was "
    "granted capacity (observed at admission; re-admissions after a "
    "preemption measure from the Queued transition)",
    buckets=(0.5, 1, 5, 15, 60, 300, 1800, 7200), registry=registry)
gpujob_preemptions_total = Counter(
    "gpujob_preemptions_total",
    "GPUJob gangs preempted, by reason: 'priority' (a higher-priority "
    "head waiter claimed the GPUs) or 'capacity' (the node pool shrank "
    "under the gang).  Both ride the SIGTERM-checkpoint path",
    ["reason"], registry=registry)
gpujob_slices_allocated = Gauge(
    "gpujob_slices_allocated",
    "GPU slices currently granted to admitted GPUJob gangs, fleet-wide "
    "(the jobqueue ledger's allocation tally)", registry=registry)

_queue_depth_lock = threading.Lock()
_queue_depth_namespaces: set = set()


def set_gpujob_queue_depth(depths: Dict[str, int]) -> None:
    """Refresh the per-profile queue-depth gauge from one ledger snapshot,
    zeroing namespaces that drained (a vanished label would read as a
    frozen last value on dashboards)."""
    global _queue_depth_namespaces
    with _queue_depth_lock:
        stale = _queue_depth_namespaces - set(depths)
        _queue_depth_namespaces = set(depths)
    for ns in stale:
        gpujob_queue_depth.labels(profile=ns).set(0)
    for ns, depth in depths.items():
        gpujob_queue_depth.labels(profile=ns).set(depth)


class GpuJobFleetCollector:
    """The scrape-time GPUJob fleet gauges: jobs per lifecycle phase
    fleet-wide and the per-namespace slice readiness summed from job
    statuses, one GPUJob list a scrape.  The client is swappable
    (``register_gpujob_collector``), as the notebook fleet collector's."""

    def __init__(self):
        self.client = None

    def read(self) -> Tuple[Dict[str, int], Dict[str, Tuple[int, int]]]:
        """(jobs by phase, namespace -> (ready workers, workers)); empty
        without a client or when the list fails."""
        from kubeflow_tpu_torch.platform.k8s.types import GPUJOB, namespace_of

        client = self.client
        by_phase: Dict[str, int] = {}
        per_ns: Dict[str, Tuple[int, int]] = {}
        if client is None:
            return by_phase, per_ns
        try:
            jobs = client.list(GPUJOB, None)
        except Exception:  # noqa: BLE001 — a scrape must not fail
            return by_phase, per_ns
        for job in jobs:
            status = job.get("status") or {}
            phase = status.get("phase") or "Pending"
            by_phase[phase] = by_phase.get(phase, 0) + 1
            ns = namespace_of(job) or ""
            n_ready, n_total = per_ns.get(ns, (0, 0))
            for s in status.get("slices") or []:
                n_ready += int(s.get("ready", 0) or 0)
                n_total += int(s.get("total", 0) or 0)
            per_ns[ns] = (n_ready, n_total)
        return by_phase, per_ns


_gpujob_collector = GpuJobFleetCollector()
ScrapeGauge(
    "gpujob_jobs", "GPUJobs by lifecycle phase",
    lambda: [((p,), n) for p, n in
             sorted(_gpujob_collector.read()[0].items())],
    ["phase"], registry=registry)
ScrapeGauge(
    "gpujob_slices_ready", "ready GPUJob slice workers, per namespace",
    lambda: [((ns,), r) for ns, (r, _) in
             sorted(_gpujob_collector.read()[1].items())],
    ["namespace"], registry=registry)
ScrapeGauge(
    "gpujob_slices", "expected GPUJob slice workers, per namespace",
    lambda: [((ns,), t) for ns, (_, t) in
             sorted(_gpujob_collector.read()[1].items())],
    ["namespace"], registry=registry)


def register_gpujob_collector(client) -> None:
    """Point the GPUJob fleet gauges at ``client`` (None unhooks them)."""
    _gpujob_collector.client = client


# -- the controller runtime ---------------------------------------------------

_QUEUE_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 30.0,
                  60.0)

workqueue_adds_total = Counter(
    "workqueue_adds_total", "Adds handled by workqueue", ["name"],
    registry=registry)
workqueue_retries_total = Counter(
    "workqueue_retries_total", "Rate-limited (backoff) re-adds by workqueue",
    ["name"], registry=registry)
workqueue_queue_duration_seconds = Histogram(
    "workqueue_queue_duration_seconds",
    "Seconds an item waits in the workqueue before being handed to a "
    "worker", ["name"], buckets=_QUEUE_BUCKETS, registry=registry)
workqueue_work_duration_seconds = Histogram(
    "workqueue_work_duration_seconds",
    "Seconds processing an item takes (get to done)",
    ["name"], buckets=_QUEUE_BUCKETS, registry=registry)


class WorkQueueMetrics:
    """The work queue's instrumentation: the queue calls ``on_add``,
    ``on_retry``, ``on_get`` and ``on_done`` at client-go's points, and
    the timing state lives here, keyed by request."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._queued_at: Dict[object, float] = {}   # key -> eligible time
        self._started_at: Dict[object, float] = {}  # key -> worker pickup
        self._waits: Dict[object, float] = {}       # key -> its queue wait
        self._adds = workqueue_adds_total.labels(name=name)
        self._retries = workqueue_retries_total.labels(name=name)
        self._queue_dur = workqueue_queue_duration_seconds.labels(name=name)
        self._work_dur = workqueue_work_duration_seconds.labels(name=name)

    def on_add(self, key, *, delay: float = 0.0) -> None:
        """An accepted add.  The queued-at time is when the item becomes
        eligible (now + delay), the earliest over deduplicated re-adds,
        so the queue duration is the wait in a hot queue, not a backoff's
        sleep."""
        self._adds.inc()
        when = time.monotonic() + max(delay, 0.0)
        with self._lock:
            cur = self._queued_at.get(key)
            if cur is None or when < cur:
                self._queued_at[key] = when

    def on_retry(self, key) -> None:
        self._retries.inc()

    def on_get(self, key) -> None:
        now = time.monotonic()
        with self._lock:
            when = self._queued_at.pop(key, None)
            wait = max(0.0, now - when) if when is not None else 0.0
            self._started_at[key] = now
            self._waits[key] = wait
        self._queue_dur.observe(wait)

    def on_done(self, key) -> None:
        now = time.monotonic()
        with self._lock:
            t0 = self._started_at.pop(key, None)
            self._waits.pop(key, None)
        if t0 is not None:
            self._work_dur.observe(now - t0)

    def wait_of(self, key) -> float:
        """The queue wait of a key being processed (the reconcile trace's
        ``dequeue`` span)."""
        with self._lock:
            return self._waits.get(key, 0.0)


controller_runtime_reconcile_time_seconds = Histogram(
    "controller_runtime_reconcile_time_seconds",
    "Reconcile latency by controller and outcome "
    "(success|error|requeue_after|dead_letter)",
    ["controller", "result"], buckets=_QUEUE_BUCKETS, registry=registry)
reconcile_errors_total = Counter(
    "reconcile_errors_total", "Reconcile errors by controller",
    ["controller"], registry=registry)
reconcile_stuck_total = Counter(
    "reconcile_stuck_total",
    "Reconciles that exceeded the stuck-reconcile deadline "
    "(the watchdog dumped their trace; they may still be running)",
    ["controller"], registry=registry)
reconcile_dead_letter_total = Counter(
    "reconcile_dead_letter_total",
    "Keys parked on the dead-letter path after exhausting max retries "
    "(terminal ReconcileFailed condition written; no more backoff "
    "requeues until a new event or resync revives the key)",
    ["controller"], registry=registry)
culling_probe_failures_total = Counter(
    "notebook_culling_probe_failures_total",
    "Idleness probes that errored, timed out or found the probe budget "
    "spent (the notebook counts as BUSY: never culled on a broken probe)",
    registry=registry)
controller_lease_transitions_total = Counter(
    "controller_lease_transitions_total",
    "Shard-lease lifecycle events by the sharded coordinator: acquire, "
    "renew, expire, release, fenced",
    ["controller", "reason"], registry=registry)
informer_watch_restarts_total = Counter(
    "informer_watch_restarts_total",
    "Informer watch stream failures/expiries that forced a re-establish",
    ["kind"], registry=registry)
informer_watch_lag_seconds = Histogram(
    "informer_watch_lag_seconds",
    "API write committed -> watch event delivered, measured once per "
    "causal stamp at its first delivery (the journey's watch_lag span)",
    ["kind"], buckets=_QUEUE_BUCKETS, registry=registry)
informer_relist_duration_seconds = Histogram(
    "informer_relist_duration_seconds",
    "Full LIST + store rebuild duration per informer relist",
    ["kind"], buckets=_QUEUE_BUCKETS, registry=registry)
informer_watch_lag_overflow_total = Counter(
    "informer_watch_lag_overflow_total",
    "watch deliveries whose measured lag exceeded the replay bound "
    "(causal.WATCH_LAG_MAX_S; one count per stamp): relist replays of "
    "old stamps, or a watch path degraded past the bound",
    ["kind"], registry=registry)


# -- the REST client and the native engine ------------------------------------

rest_client_request_duration_seconds = Histogram(
    "rest_client_request_duration_seconds",
    "API-server request latency by verb and kind",
    ["verb", "kind"], buckets=_QUEUE_BUCKETS, registry=registry)
rest_client_requests_total = Counter(
    "rest_client_requests_total",
    "API-server requests by verb, kind, and status code "
    "(code='<error>' for transport failures, '<circuit-open>' for calls "
    "the breaker refused)",
    ["verb", "kind", "code"], registry=registry)
rest_client_retries_total = Counter(
    "rest_client_retries_total",
    "Transparent client-side retries by verb (bounded, idempotent verbs "
    "and 429s; k8s/client.py's retry policy)",
    ["verb"], registry=registry)
rest_client_circuit_state = Gauge(
    "rest_client_circuit_state",
    "Client circuit breaker state (0=closed, 1=half-open, 2=open)",
    registry=registry)
rest_client_circuit_opens_total = Counter(
    "rest_client_circuit_opens_total",
    "Times the client circuit breaker tripped open (consecutive transient "
    "failures crossed the threshold)",
    registry=registry)
native_engine_active = Gauge(
    "native_engine_active",
    "Whether the native C++ engine serves this component (1) or the "
    "Python engine does (0); set at the first load attempt "
    "(platform/native.py)",
    ["component"], registry=registry)


# id(informer) -> (kind, weakref), for the scrape-time
# informer_last_sync_age_seconds: Informer.start registers, stop
# deregisters.  The gauge reports the worst (largest) age per kind, so a
# wedged informer cannot hide behind a healthy one of its kind.
_informers: Dict[int, tuple] = {}
_informers_lock = threading.Lock()


def register_informer(informer) -> None:
    with _informers_lock:
        _informers[id(informer)] = (informer.gvk.kind,
                                    weakref.ref(informer))


def deregister_informer(informer) -> None:
    with _informers_lock:
        _informers.pop(id(informer), None)


def running_informers() -> list:
    """The informers started and not yet stopped in this process."""
    with _informers_lock:
        refs = [ref for _kind, ref in _informers.values()]
    return [i for i in (ref() for ref in refs) if i is not None]


def _sync_ages():
    """Seconds since each kind's informers last completed a relist
    (counted from start() before the first one)."""
    now = time.monotonic()
    ages: Dict[str, float] = {}
    with _informers_lock:
        refs = dict(_informers)
    for key, (kind, ref) in refs.items():
        informer = ref()
        if informer is None:
            with _informers_lock:
                if _informers.get(key) == (kind, ref):
                    del _informers[key]
            continue
        since = informer.last_sync_monotonic or informer.started_monotonic
        if since is not None:
            ages[kind] = max(ages.get(kind, 0.0), now - since)
    return [((kind,), age) for kind, age in sorted(ages.items())]


ScrapeGauge(
    "informer_last_sync_age_seconds",
    "Seconds since the informer last completed a full relist",
    _sync_ages, ["kind"], registry=registry)


# id(coordinator) -> weakref, for the scrape-time shard-ownership gauge
# (controller_shard_owned).  ShardCoordinator.start registers, stop and
# crash deregister.
_shard_coords: Dict[int, object] = {}
_shard_coords_lock = threading.Lock()


def register_shard_coordinator(coord) -> None:
    with _shard_coords_lock:
        _shard_coords[id(coord)] = weakref.ref(coord)


def deregister_shard_coordinator(coord) -> None:
    with _shard_coords_lock:
        _shard_coords.pop(id(coord), None)


def _shard_owned():
    """One sample per shard of every registered coordinator: 1 owned, 0
    not, so a fleet-wide sum per shard above 1 is the double-ownership
    alarm."""
    with _shard_coords_lock:
        refs = dict(_shard_coords)
    out = []
    for key, ref in refs.items():
        coord = ref()
        if coord is None:
            with _shard_coords_lock:
                if _shard_coords.get(key) is ref:
                    del _shard_coords[key]
            continue
        owned = coord.owned()
        out += [((coord.name, str(shard)), 1.0 if shard in owned else 0.0)
                for shard in range(coord.num_shards)]
    return out


ScrapeGauge(
    "controller_shard_owned",
    "Shard-lease ownership by this replica's coordinator: 1 = owned, 0 = "
    "not (every shard of every registered coordinator is emitted, so a "
    "fleet-wide sum per shard > 1 is the double-ownership alarm)",
    _shard_owned, ["controller", "shard"], registry=registry)


def _oldest_waits():
    from kubeflow_tpu_torch.platform.runtime import jobqueue

    return [((ns,), age) for ns, age in
            sorted((jobqueue.oldest_queue_waits() or {}).items())]


ScrapeGauge(
    "gpujob_queue_oldest_wait_seconds",
    "age of the oldest GPUJob currently parked Queued, per profile "
    "namespace (0 series when nothing waits)",
    _oldest_waits, ["profile"], registry=registry)


# -- the serving front door (controllers/inferenceservice.py, activator.py)


class InferenceServiceFleetCollector:
    """The scrape-time InferenceService gauges: services per lifecycle
    phase fleet-wide, and target and ready replicas per namespace summed
    from statuses (the target is the serving side of the GPU ledger's
    charge: replicas x one replica's GPUs), one InferenceService list a
    scrape.  The client is swappable
    (``register_inferenceservice_collector``)."""

    def __init__(self):
        self.client = None

    def read(self) -> Tuple[Dict[str, int], Dict[str, Tuple[int, int]]]:
        """(services by phase, namespace -> (target replicas, ready
        replicas)); empty without a client or when the list fails."""
        from kubeflow_tpu_torch.platform.k8s.types import (
            INFERENCESERVICE,
            namespace_of,
        )

        client = self.client
        by_phase: Dict[str, int] = {}
        per_ns: Dict[str, Tuple[int, int]] = {}
        if client is None:
            return by_phase, per_ns
        try:
            items = client.list(INFERENCESERVICE, None)
        except Exception:  # noqa: BLE001 — a scrape must not fail
            return by_phase, per_ns
        for svc in items:
            status = svc.get("status") or {}
            phase = status.get("phase") or "Pending"
            by_phase[phase] = by_phase.get(phase, 0) + 1
            ns = namespace_of(svc) or ""
            n_target, n_ready = per_ns.get(ns, (0, 0))
            per_ns[ns] = (
                n_target + int(status.get("replicas", 0) or 0),
                n_ready + int(status.get("readyReplicas", 0) or 0))
        return by_phase, per_ns


_inferenceservice_collector = InferenceServiceFleetCollector()
ScrapeGauge(
    "inferenceservice_services", "InferenceServices by lifecycle phase",
    lambda: [((p,), n) for p, n in
             sorted(_inferenceservice_collector.read()[0].items())],
    ["phase"], registry=registry)
ScrapeGauge(
    "inferenceservice_replicas",
    "target model-server replicas, per namespace (the GPU ledger's "
    "charge is this times one replica's GPUs)",
    lambda: [((ns,), t) for ns, (t, _) in
             sorted(_inferenceservice_collector.read()[1].items())],
    ["namespace"], registry=registry)
ScrapeGauge(
    "inferenceservice_ready_replicas",
    "serving-revision replicas Ready, per namespace",
    lambda: [((ns,), r) for ns, (_, r) in
             sorted(_inferenceservice_collector.read()[1].items())],
    ["namespace"], registry=registry)


def register_inferenceservice_collector(client) -> None:
    """Point the InferenceService gauges at ``client`` (None unhooks
    them; wired to the serving controller's start and stop)."""
    _inferenceservice_collector.client = client


inferenceservice_scale_events_total = Counter(
    "inferenceservice_scale_events_total",
    "autoscaler width changes by direction: 'up' (target tracking), "
    "'down' (cooldown-limited), 'to_zero' (idle window elapsed)",
    ["direction"], registry=registry)
inferenceservice_cold_starts_total = Counter(
    "inferenceservice_cold_starts_total",
    "scale-from-zero wakes (activator annotation or traffic observed "
    "while parked at zero)", registry=registry)
inferenceservice_rollouts_total = Counter(
    "inferenceservice_rollouts_total",
    "revision rollouts started (pod-spec-affecting spec change hashed "
    "to a new revision)", registry=registry)
inferenceservice_scrape_errors_total = Counter(
    "inferenceservice_scrape_errors_total",
    "replica /metrics scrapes that failed, by reason: 'timeout' / "
    "'connect' (a down or unreachable replica, absent from that "
    "autoscaling pass; an all-fail pass holds width) vs 'parse' (the "
    "replica answered garbage)",
    ["reason"], registry=registry)
serve_requests_held = Gauge(
    "serve_requests_held",
    "requests currently parked in the activator's per-service hold "
    "queues, waiting for a scaled-to-zero service to wake",
    registry=registry)
serve_requests_shed_total = Counter(
    "serve_requests_shed_total",
    "activator requests refused, by tenant and reason: 'tenant-bucket' "
    "(429, token bucket empty), 'slo-shed' (429, admission surcharge "
    "past the TTFT SLO knee drained the bucket), 'hold-overflow' (503, "
    "per-service hold queue full), 'wake-timeout' (503, wake deadline "
    "expired mid-hold), 'deadline' (504, the request's own "
    "X-KFT-Deadline-Seconds expired while held)",
    ["tenant", "reason"], registry=registry)
serve_tenant_ttft_seconds = Histogram(
    "serve_tenant_ttft_seconds",
    "activator-observed seconds to a replica's response, per tenant",
    ["tenant"], buckets=(0.001, 0.005, 0.02, 0.1, 0.5, 2.0, 10.0),
    registry=registry)
activator_proxy_requests_total = Counter(
    "activator_proxy_requests_total",
    "requests through the activator data path, by outcome: 'ok' "
    "(forwarded, 2xx/4xx passthrough), 'replayed' (held across a cold "
    "start, then served), 'shed' (refused with a structured 429/503/"
    "504), 'error' (replay budget exhausted or backend unreachable)",
    ["outcome"], registry=registry)
activator_wake_stamps_total = Counter(
    "activator_wake_stamps_total",
    "wake-at annotation stamps written by the activator (first stamp "
    "and periodic re-stamps while requests stay held)",
    registry=registry)
fleetscrape_scrape_errors_total = Counter(
    "fleetscrape_scrape_errors_total",
    "fleet scrapes that failed, by bounded reason: 'timeout' (socket "
    "stall), 'connect' (unreachable/refused/hook failure), 'parse' "
    "(page fetched but unparseable)",
    ["reason"], registry=registry)
fleetscrape_samples_total = Counter(
    "fleetscrape_samples_total",
    "samples written into the in-process TSDB by the fleet scrape",
    registry=registry)
fleetscrape_targets = Gauge(
    "fleetscrape_targets",
    "scrape targets discovered on the most recent discovery pass",
    registry=registry)
kft_tsdb_series_evicted_total = Counter(
    "kft_tsdb_series_evicted_total",
    "series evicted from the fleet TSDB at its max_series bound "
    "(oldest-last-sample first); a climbing rate means the store is "
    "undersized for the fleet (KFT_TSDB_MAX_SERIES)",
    registry=registry)


# The profile controller's and KFAM's monitoring pattern (reference
# profile-controller/controllers/monitoring.go:28-60, kfam/monitoring.go),
# which the web apps share through their middleware: per-kind request
# counters, severity-labelled failure counters and a liveness heartbeat
# on a fixed cadence.
SEVERITY_MINOR = "minor"
SEVERITY_MAJOR = "major"
SEVERITY_CRITICAL = "critical"

request_kf = Counter(
    "request_kf_total",
    "Requests handled, by component and resource kind",
    ["component", "kind"], registry=registry)
request_kf_failure = Counter(
    "request_kf_failure_total",
    "Failed requests, by component, resource kind, and severity",
    ["component", "kind", "severity"], registry=registry)
service_heartbeat = Counter(
    "service_heartbeat_total",
    "Heartbeat signal on a fixed cadence indicating the service is alive",
    ["component", "severity"], registry=registry)
degraded_responses_total = Counter(
    "degraded_responses_total",
    "Web responses served from a possibly-stale informer cache because "
    "the live apiserver read failed transiently (degraded: true)",
    ["component"], registry=registry)

_heartbeats: Dict[str, threading.Event] = {}
_heartbeats_lock = threading.Lock()


def start_heartbeat(component: str, *, interval: float = 10.0):
    """Tick ``service_heartbeat{component}`` every ``interval`` seconds
    from a daemon thread.  Idempotent per component while its heartbeat
    lives; a stopped one is replaced, so a component can restart its
    heartbeat.  Returns the stop Event."""
    with _heartbeats_lock:
        existing = _heartbeats.get(component)
        if existing is not None and not existing.is_set():
            return existing
        stop = threading.Event()
        _heartbeats[component] = stop

    def tick():
        counter = service_heartbeat.labels(component=component,
                                           severity=SEVERITY_CRITICAL)
        while not stop.wait(interval):
            counter.inc()

    threading.Thread(target=tick, name=f"heartbeat-{component}",
                     daemon=True).start()
    return stop


def stop_heartbeat(component: str) -> None:
    """Stop a component's heartbeat and drop its entry, so a later
    ``start_heartbeat(component)`` starts a fresh ticker."""
    with _heartbeats_lock:
        stop = _heartbeats.pop(component, None)
    if stop is not None:
        stop.set()


def render() -> str:
    return registry.render()
