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
restarts and watch lag.
``render()`` is the ``/metrics`` page.
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
informer_watch_lag_overflow_total = Counter(
    "informer_watch_lag_overflow_total",
    "watch deliveries whose measured lag exceeded the replay bound "
    "(causal.WATCH_LAG_MAX_S; one count per stamp): relist replays of "
    "old stamps, or a watch path degraded past the bound",
    ["kind"], registry=registry)


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


def render() -> str:
    return registry.render()
