"""Fleet scrape: the one scrape-to-store path between a serving
replica's ``/metrics`` and the decisions made from it.  The port's copy
of the part of ``kubeflow_tpu/telemetry/fleetscrape.py`` that the
InferenceService controller and the activator read: ``default_tsdb``,
``Target``, ``ScrapeStats``, ``FleetScraper``, ``serve_sample``,
``inferenceservice_targets`` and ``self_target``.

``FleetScraper`` owns the fetch: targets (a URL through the scraper
hook, or an in-process page callable for a self-scrape) fan out on a
dedicated named ``FlightPool`` (``scrape_pool``: a slow target must not
starve the controllers' shared pool), pages parse once (the port's
``telemetry/metrics.parse_text``), and every sample lands in the
:class:`~kubeflow_tpu_torch.telemetry.tsdb.TSDB` carrying the target's
labels and the one per-pass timestamp that makes pass-joins exact.  A
URL is fetched with ``urllib.request`` and no proxy: a replica is
reached directly, whatever proxy the environment names.

Scrape failures are counted with a bounded ``reason`` label,
``timeout`` / ``connect`` / ``parse``, so an alert can tell a down
replica from a parse regression.

``serve_sample`` computes the autoscaler's :class:`ServeSample` from
stored series alone: per-replica gauge means, summed counters, TTFT p99
over the merged-bucket delta between this pass and the previous one
(first pass and post-outage passes re-baseline to no signal).

The reference's ``MetricsPipeline`` (the cadence loop over the SLO
rules and goodput) and ``peer_targets`` wait for the port of those
modules.
"""
from __future__ import annotations

import dataclasses
import logging
import socket
import threading
import time
import urllib.error
import urllib.request
from typing import Callable, Dict, List, Optional

from kubeflow_tpu_torch.platform import config
from kubeflow_tpu_torch.telemetry.tsdb import TSDB

log = logging.getLogger("kubeflow_tpu_torch.telemetry.fleetscrape")

SCRAPE_TIMEOUT_S = 2.0
# One record per scrape pass per service: value = replicas that answered.
# serve_sample() joins this pass and the previous one.
PASS_SERIES = "fleetscrape_pass"

_default_tsdb: Optional[TSDB] = None
_default_tsdb_lock = threading.Lock()


def default_tsdb() -> TSDB:
    """The process-wide shared store: the InferenceService reconciler
    (via make_controller) writes its replica scrapes here and the
    manager's rule engine reads the same series — ONE scrape path, one
    history.  Sized through knobs so a large fleet can scale the bounds
    (a store that hits max_series churn-evicts live series and silently
    corrupts burn windows — ``kft_tsdb_series_evicted_total`` is the
    alarm).  Tests that need isolation pass their own TSDB instead."""
    global _default_tsdb
    with _default_tsdb_lock:
        if _default_tsdb is None:
            # KFT_TSDB_CAPACITY: samples kept a series (a ring; ~1.5 h
            # at a 15 s cadence); KFT_TSDB_MAX_SERIES: the series bound,
            # past which the oldest-last-sample series is evicted.
            _default_tsdb = TSDB(
                capacity=config.env_int("KFT_TSDB_CAPACITY", 360),
                max_series=config.env_int("KFT_TSDB_MAX_SERIES", 8192))
        return _default_tsdb


@dataclasses.dataclass
class Target:
    """One scrape endpoint: a URL (fetched through the scraper hook) or
    an in-process page callable (``fetch`` — the self-scrape of a local
    registry).  ``labels`` ride every stored sample.  ``names`` (when
    set) stores only those sample names — the fleet-scale guard: a
    serving replica's page carries dozens of series but the decision
    loops read six, and ingesting everything from hundreds of replicas
    would blow the TSDB's series bound into eviction churn."""

    url: Optional[str] = None
    fetch: Optional[Callable[[], Optional[str]]] = None
    labels: Dict[str, str] = dataclasses.field(default_factory=dict)
    names: Optional[frozenset] = None


@dataclasses.dataclass
class ScrapeStats:
    targets: int = 0
    ok: int = 0
    samples: int = 0
    errors: Dict[str, int] = dataclasses.field(default_factory=dict)


_scrape_pool = None
_scrape_pool_lock = threading.Lock()


def scrape_pool():
    """The fleetscrape fan-out pool: dedicated (never the controllers'
    shared pool — a slow scrape target must not starve reconcile
    fan-outs) and NAMED, so its workers carry a stable ``fleetscrape``
    profile role instead of sampling as Thread-N.  Re-resolved when the
    size knob changes (the shared_pool() pattern)."""
    from kubeflow_tpu_torch.platform.runtime.flight import FlightPool

    global _scrape_pool
    size = config.env_int("KFT_FLEETSCRAPE_POOL_SIZE", 8)
    with _scrape_pool_lock:
        if _scrape_pool is None or _scrape_pool.size != size:
            _scrape_pool = FlightPool(size, name="fleetscrape")
        return _scrape_pool


# A replica is reached directly: no proxy from the environment.
_OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def fetch_url(url: str, timeout: float = SCRAPE_TIMEOUT_S):
    """(text, None) or (None, reason) — the default classified fetcher.
    ``timeout`` = socket-level stall, ``connect`` = everything else that
    kept bytes from arriving (refused, reset, DNS)."""
    try:
        with _OPENER.open(url, timeout=timeout) as resp:
            return resp.read().decode("utf-8", "replace"), None
    except socket.timeout:
        return None, "timeout"
    except urllib.error.URLError as e:
        reason = getattr(e, "reason", None)
        if isinstance(reason, socket.timeout):
            return None, "timeout"
        return None, "connect"
    except (OSError, ValueError):
        return None, "connect"


class FleetScraper:
    """Fan scrapes out, parse once, store with target labels.

    ``scraper``: the single swappable fetch hook (``scraper(url) ->
    text | None``) shared with the InferenceService controller's
    hermetic harnesses — a hook returning None counts as ``connect``
    (the hook cannot say more), a hook raising ``TimeoutError`` as
    ``timeout``; when no hook is given the classified default fetcher
    runs.  ``on_error(reason)`` lets an owner bump its OWN failure
    counter (the serving controller keeps
    ``inferenceservice_scrape_errors_total{reason}``) next to the
    pipeline-wide ``fleetscrape_scrape_errors_total{reason}``.
    """

    def __init__(self, tsdb: Optional[TSDB] = None, *,
                 scraper: Optional[Callable[[str], Optional[str]]] = None,
                 on_error: Optional[Callable[[str], None]] = None,
                 pool=None, now=time.time):
        self.tsdb = tsdb if tsdb is not None else default_tsdb()
        self.scraper = scraper
        self.on_error = on_error
        self.now = now
        self._pool = pool
        self._sources: List[Callable[[], List[Target]]] = []
        self._seen_evictions = tsdb.evictions if tsdb is not None else 0

    # -- discovery ------------------------------------------------------------

    def add_source(self, fn: Callable[[], List[Target]]) -> None:
        """Register a target-discovery hook (called per pass; exceptions
        are logged and skipped — one broken source must not stop the
        pipeline's other targets)."""
        self._sources.append(fn)

    def targets(self) -> List[Target]:
        out: List[Target] = []
        for fn in self._sources:
            try:
                out.extend(fn() or [])
            except Exception:
                log.debug("target source %r failed", fn, exc_info=True)
        return out

    # -- scraping -------------------------------------------------------------

    def _fetch(self, target: Target):
        if target.fetch is not None:
            try:
                return target.fetch(), None
            except TimeoutError:
                return None, "timeout"
            except Exception:
                return None, "connect"
        if target.url is None:
            return None, "connect"
        if self.scraper is not None:
            try:
                return self.scraper(target.url), None
            except TimeoutError:
                return None, "timeout"
            except Exception:
                return None, "connect"
        return fetch_url(target.url)

    def _count_error(self, reason: str) -> None:
        from kubeflow_tpu_torch.platform.runtime import metrics

        metrics.fleetscrape_scrape_errors_total.labels(reason=reason).inc()
        if self.on_error is not None:
            self.on_error(reason)

    def _scrape_one(self, target: Target, ts: float):
        """(ok, samples) for one target; errors classified + counted."""
        text, reason = self._fetch(target)
        if text is None:
            self._count_error(reason or "connect")
            return False, 0
        if not text:
            # An empty page is a live-but-silent target: no samples, and
            # as ``parse_serve_pages`` reads it, it does not count as scraped.
            return False, 0
        try:
            n = self.tsdb.ingest_page(text, labels=target.labels, ts=ts,
                                      names=target.names)
        except ValueError:
            self._count_error("parse")
            return False, 0
        return True, n

    def scrape(self, targets: Optional[List[Target]] = None,
               ts: Optional[float] = None) -> ScrapeStats:
        """One pass over ``targets`` (default: the discovery sources),
        fanned out on the shared FlightPool, every sample stamped with
        the SAME pass timestamp."""
        from kubeflow_tpu_torch.platform.runtime import metrics

        discovery_pass = targets is None
        if discovery_pass:
            targets = self.targets()
            # The fleet-wide target count is a DISCOVERY-pass fact; a
            # per-service scrape_service call must not stomp it with one
            # service's replica count.
            metrics.fleetscrape_targets.set(len(targets))
        if ts is None:
            ts = self.now()
        stats = ScrapeStats(targets=len(targets))
        if not targets:
            return stats
        pool = self._pool
        if pool is None:
            pool = self._pool = scrape_pool()
        results = pool.run(
            [lambda t=t: self._scrape_one(t, ts) for t in targets],
            return_exceptions=True)
        for res in results:
            if isinstance(res, BaseException):
                log.debug("scrape slot failed", exc_info=res)
                self._count_error("connect")
                continue
            ok, n = res
            if ok:
                stats.ok += 1
                stats.samples += n
        metrics.fleetscrape_samples_total.inc(stats.samples)
        # Surface the store's eviction churn: series evicted at the
        # max_series bound silently lose burn-window history, so the
        # count must be scrapeable, not a buried attribute.
        evictions = self.tsdb.evictions
        if evictions > self._seen_evictions:
            metrics.kft_tsdb_series_evicted_total.inc(
                evictions - self._seen_evictions)
            self._seen_evictions = evictions
        return stats

    def scrape_service(self, key: str, targets: List[Target],
                       ts: Optional[float] = None) -> ScrapeStats:
        """One autoscaler pass for service ``key`` ("ns/name"): scrape
        the replica targets and record the pass (replicas that answered)
        so ``serve_sample`` can join this pass against the previous
        one.  Recorded even at zero targets/answers — an outage pass
        re-baselines the TTFT delta.

        Pass timestamps are forced strictly monotonic per service: the
        exact-ts pass join must survive callers with coarse (or frozen
        test) clocks — two passes sharing a timestamp would be
        indistinguishable."""
        if ts is None:
            ts = self.now()
        prev = self.tsdb.latest_n(PASS_SERIES, {"service": key}, n=1)
        if prev and ts <= prev[0][0]:
            ts = prev[0][0] + 1e-6
        stats = self.scrape(targets, ts=ts)
        self.tsdb.append(PASS_SERIES, {"service": key}, stats.ok, ts=ts)
        return stats


# -- the autoscaler's stored-series sample ------------------------------------


def serve_sample(tsdb: TSDB, key: str):
    """The :class:`ServeSample` for service ``key`` from stored series,
    the same sample ``parse_serve_pages`` gives on the same pages with
    the bucket delta between passes:

    * gauges (queue depth, slot occupancy) and the request counter come
      from the LATEST pass's exact-timestamp samples (a replica that
      missed the pass contributes nothing);
    * TTFT p99 is computed over ``max(0, cur - prev)`` per ``le`` of the
      pass-merged buckets — so a replica restart (bucket reset) clamps
      to zero instead of going negative, a NEW replica's cumulative
      history counts once (it is absent from the previous merge), and a
      pass with no answering replicas yields no signal and re-baselines
      the next one.
    """
    from kubeflow_tpu_torch.platform.runtime.autoscale import ServeSample
    from kubeflow_tpu_torch.telemetry.metrics import quantile_from_buckets

    passes = tsdb.latest_n(PASS_SERIES, {"service": key}, n=2)
    if not passes:
        return ServeSample()
    pass_ts, replicas = passes[0]
    replicas = int(replicas)
    if replicas <= 0:
        return ServeSample()
    m = {"service": key}

    def _sum(name: str) -> float:
        return sum(v for _labels, v in tsdb.values_at(name, m, pass_ts))

    queue_sum = _sum("serve_queue_depth")
    active_sum = _sum("serve_decode_slots_active")
    slots_sum = _sum("serve_decode_slots")
    requests = _sum("generate_requests_total")
    ttft = None
    if len(passes) > 1 and passes[1][1] > 0:
        prev_ts = passes[1][0]
        cur = tsdb.merged_at("serve_time_to_first_token_seconds_bucket",
                             m, ts=pass_ts)
        prev = tsdb.merged_at("serve_time_to_first_token_seconds_bucket",
                              m, ts=prev_ts)
        delta = {le: max(0.0, c - prev.get(le, 0.0))
                 for le, c in cur.items()}
        ttft = quantile_from_buckets(delta, 0.99)
    return ServeSample(
        replicas_scraped=replicas,
        queue_depth=queue_sum / replicas,
        ttft_p99_s=ttft,
        slot_occupancy=(active_sum / slots_sum) if slots_sum > 0 else None,
        requests_total=requests,
    )


# -- discovery helpers --------------------------------------------------------


def self_target(render: Callable[[], bytes], *,
                labels: Optional[Dict[str, str]] = None) -> Target:
    """Self-scrape of an in-process registry: ``render`` is e.g.
    ``runtime.metrics.render`` — the same exposition text /metrics
    serves, parsed through the same path as any remote page."""

    def fetch() -> str:
        out = render()
        return out.decode() if isinstance(out, bytes) else out

    return Target(fetch=fetch, labels=dict(labels or {}))


# The serve series the decision loops actually read: the autoscaler's
# sample (serve_sample), the serve-TTFT burn rule, and goodput's slot
# occupancy.  Replica pages carry much more; at hundreds of replicas
# storing it all would churn the TSDB's series bound — so replica
# targets filter to this set by default.
SERVE_SAMPLE_NAMES = frozenset({
    "serve_queue_depth",
    "serve_decode_slots",
    "serve_decode_slots_active",
    "generate_requests_total",
    "serve_time_to_first_token_seconds_bucket",
    "serve_replica_revision",
})


def inferenceservice_targets(pods: List[dict], *, port: int,
                             service_key: str,
                             names: Optional[frozenset] = SERVE_SAMPLE_NAMES
                             ) -> List[Target]:
    """Replica targets for one InferenceService from its READY pods via
    the existing endpoint contract (the ``inferenceservices.kubeflow.org
    /endpoint`` annotation, else pod IP).  ``names=None`` stores the
    whole page."""
    from kubeflow_tpu_torch.platform.apis.inferenceservice import ANNOTATION_ENDPOINT
    from kubeflow_tpu_torch.platform.k8s.types import deep_get, name_of

    out = []
    for pod in pods:
        override = deep_get(pod, "metadata", "annotations",
                            ANNOTATION_ENDPOINT)
        if override:
            url = override.rstrip("/")
        else:
            ip = deep_get(pod, "status", "podIP")
            url = f"http://{ip}:{port}" if ip else None
        if url is None:
            continue
        out.append(Target(url=url + "/metrics",
                          labels={"service": service_key,
                                  "replica": name_of(pod)},
                          names=names))
    return out
