"""Dashboard metrics service: cluster utilization time series.  The
port's copy of ``kubeflow_tpu/platform/dashboard/metrics_service.py``.

The reference's dashboard defines a MetricsService interface with three
time-series queries (node CPU, pod CPU, pod memory) and ships only a
Stackdriver implementation (centraldashboard/app/metrics_service.ts:
20-42).  The interface is kept and the bundled implementation targets a
Prometheus endpoint over ``urllib.request``.  The accelerator series is
``gpu_duty_cycle``, DCGM's ``DCGM_FI_DEV_GPU_UTIL`` averaged by pod,
where the reference reads ``tpu_duty_cycle_percent``; the reconcile and
work-queue queries read the control plane's own series.
"""
from __future__ import annotations

import dataclasses
import enum
import json
import time
import urllib.parse
import urllib.request
from typing import Callable, List, Optional


class Interval(enum.Enum):
    """Time-series window (reference metrics_service.ts:2-8)."""

    Last5m = 5
    Last15m = 15
    Last30m = 30
    Last60m = 60
    Last180m = 180

    @property
    def minutes(self) -> int:
        return self.value

    @classmethod
    def parse(cls, raw: Optional[str], default: "Interval" = None) -> "Interval":
        default = default or cls.Last15m
        if not raw:
            return default
        try:
            return cls[raw]
        except KeyError:
            return default


@dataclasses.dataclass
class TimeSeriesPoint:
    timestamp: float  # unix seconds
    label: str        # node / pod the sample belongs to
    value: float

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class MetricsService:
    """Interface (reference metrics_service.ts:20-42).  Implementations
    return points sorted by timestamp; label identifies the series."""

    def node_cpu_utilization(self, interval: Interval) -> List[TimeSeriesPoint]:
        raise NotImplementedError

    def pod_cpu_utilization(self, interval: Interval) -> List[TimeSeriesPoint]:
        raise NotImplementedError

    def pod_memory_usage(self, interval: Interval) -> List[TimeSeriesPoint]:
        raise NotImplementedError

    def gpu_duty_cycle(self, interval: Interval) -> List[TimeSeriesPoint]:
        """GPU utilization per pod (percent); optional for
        implementations."""
        raise NotImplementedError

    def reconcile_latency(self, interval: Interval) -> List[TimeSeriesPoint]:
        """Control-plane extension: p99 reconcile latency per controller
        (controller_runtime_reconcile_time_seconds); optional."""
        raise NotImplementedError

    def workqueue_depth(self, interval: Interval) -> List[TimeSeriesPoint]:
        """Control-plane extension: workqueue backlog per controller
        (workqueue_depth); optional."""
        raise NotImplementedError


# PromQL for each series.  Rates over 5m windows, aggregated per node or
# pod: the shapes the Stackdriver implementation queried.  ``gpu`` is
# DCGM's utilization gauge (dcgm-exporter); the reconcile and workqueue
# entries read the series ``runtime/metrics.py`` exports.
QUERIES = {
    "node": 'sum by (instance) (rate(node_cpu_seconds_total{mode!="idle"}[5m]))',
    "podcpu": "sum by (pod) (rate(container_cpu_usage_seconds_total[5m]))",
    "podmem": "sum by (pod) (container_memory_working_set_bytes)",
    "gpu": "avg by (pod) (DCGM_FI_DEV_GPU_UTIL)",
    "reconcile": (
        "histogram_quantile(0.99, sum by (controller, le) "
        "(rate(controller_runtime_reconcile_time_seconds_bucket[5m])))"
    ),
    "workqueue": "sum by (name) (workqueue_depth)",
}

LABEL_KEYS = ("instance", "pod", "node", "controller", "name")

Fetch = Callable[[str, dict], dict]  # (url, params) -> parsed JSON


def _default_fetch(url: str, params: dict) -> dict:
    """GET ``url?params`` and parse the JSON body; a non-2xx status
    raises (``urllib.error.HTTPError``)."""
    query = urllib.parse.urlencode(params)
    with urllib.request.urlopen(f"{url}?{query}", timeout=30) as resp:
        return json.loads(resp.read())


class PrometheusMetricsService(MetricsService):
    """MetricsService over the Prometheus HTTP API (query_range).

    ``fetch`` is injectable for tests; the default is ``urllib.request``.
    Failures surface as empty series rather than exceptions: the
    dashboard panel degrades to "no data", as the reference's frontend
    treats a metrics error.
    """

    def __init__(self, base_url: str, *, fetch: Fetch = None,
                 step_seconds: int = 60,
                 now: Callable[[], float] = time.time):
        self.base_url = base_url.rstrip("/")
        self.fetch = fetch or _default_fetch
        self.step = step_seconds
        self._now = now

    def _query_range(self, promql: str, interval: Interval) -> List[TimeSeriesPoint]:
        end = self._now()
        start = end - interval.minutes * 60
        try:
            data = self.fetch(
                f"{self.base_url}/api/v1/query_range",
                {"query": promql, "start": start, "end": end, "step": self.step},
            )
        except Exception:
            return []
        if not isinstance(data, dict) or data.get("status") != "success":
            return []
        points: List[TimeSeriesPoint] = []
        for series in (data.get("data") or {}).get("result") or []:
            metric = series.get("metric") or {}
            label = next(
                (metric[k] for k in LABEL_KEYS if metric.get(k)), ""
            )
            for ts, value in series.get("values") or []:
                try:
                    points.append(TimeSeriesPoint(float(ts), label, float(value)))
                except (TypeError, ValueError):
                    continue
        points.sort(key=lambda p: p.timestamp)
        return points

    def node_cpu_utilization(self, interval: Interval) -> List[TimeSeriesPoint]:
        return self._query_range(QUERIES["node"], interval)

    def pod_cpu_utilization(self, interval: Interval) -> List[TimeSeriesPoint]:
        return self._query_range(QUERIES["podcpu"], interval)

    def pod_memory_usage(self, interval: Interval) -> List[TimeSeriesPoint]:
        return self._query_range(QUERIES["podmem"], interval)

    def gpu_duty_cycle(self, interval: Interval) -> List[TimeSeriesPoint]:
        return self._query_range(QUERIES["gpu"], interval)

    def reconcile_latency(self, interval: Interval) -> List[TimeSeriesPoint]:
        return self._query_range(QUERIES["reconcile"], interval)

    def workqueue_depth(self, interval: Interval) -> List[TimeSeriesPoint]:
        return self._query_range(QUERIES["workqueue"], interval)
