"""The control plane's metrics that the notebook path writes, on the
port's own registry (``telemetry/metrics.py``; no ``prometheus_client``).

The port's copy of the series of ``kubeflow_tpu/platform/runtime/
metrics.py`` that the notebook reconciler, the event recorder and the
flight pool write: notebook creations and their failures, the
spawn-to-ready histogram, the event recorder's outcomes, the flights
fanned out, and the scrape-time fleet gauges (``notebook_running`` and
``gpus_requested`` per namespace, in place of the reference's
``tpu_chips_requested``).  ``render()`` is the ``/metrics`` page.
"""
from __future__ import annotations

from typing import Dict, Tuple

from kubeflow_tpu_torch.telemetry.metrics import (
    Counter,
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


def render() -> str:
    return registry.render()
