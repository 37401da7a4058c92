"""Incident flight recorder: the port's copy of
``kubeflow_tpu/telemetry/incidents.py``.

When a burn-rate alert turns to firing (``telemetry/slo.py``'s
``RuleEngine``), the evidence an operator needs is spread over the live
``/debug/`` surfaces and ages out of their rings while the page is in
flight.  ``IncidentRecorder.capture()`` snapshots it at transition time
into one bounded, deterministic bundle:

* the offending rule and its live burn rates;
* the TSDB window around the burn (the rule's bucket series over its
  slow window, replayable through the quantile and burn math offline);
* the SLO's recorded series (the engine's recording rules, if any);
* merged causal journeys for the worst objects in the burn window
  (``telemetry/causal.py``'s span store, top-K traces by span duration);
* the covering profile window (``telemetry/profiler.py``);
* the live ``/debug/queue``, ``/debug/goodput`` and alert snapshots,
  any entrypoint-wired extras (``/debug/shards``), and the effective
  knobs (``config.effective()``).

Bundles land in a bounded ring (``KFT_INCIDENT_RING``), debounced per
alert (``KFT_INCIDENT_DEBOUNCE_SECONDS``: a flapping alert must not
churn the ring), listed by manifest at ``/debug/incidents`` and fetched
whole at ``/debug/incidents/<id>``.  Each capture is announced by one
fleet-wide Event through the stamping apply helpers: its name and owned
content are deterministic in the alert alone, so N replicas observing
the same transition write one ``kft-incident-<alert>`` object.
"""
from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from kubeflow_tpu_torch.platform import config
from kubeflow_tpu_torch.telemetry.tsdb import TSDB

log = logging.getLogger("kubeflow_tpu_torch.telemetry.incidents")


class IncidentRecorder:
    """Capture-on-page evidence bundles for one process.  Attach to a
    ``RuleEngine`` (``engine.incidents = recorder``; ``MetricsPipeline``
    wires this by default) and register with
    :func:`register_debug_incidents` to serve ``/debug/incidents``."""

    def __init__(self, tsdb: TSDB, *, client=None,
                 namespace: str = "kubeflow",
                 component: str = "incident-recorder",
                 ring: Optional[int] = None,
                 debounce_s: Optional[float] = None,
                 max_journeys: Optional[int] = None,
                 max_series: Optional[int] = None,
                 max_samples: Optional[int] = None,
                 now=time.time):
        self.tsdb = tsdb
        self.client = client
        self.namespace = namespace
        self.component = component
        self.now = now
        self.ring = int(ring if ring is not None else config.knob(
            "KFT_INCIDENT_RING", 16, int,
            doc="incident bundles kept in the flight-recorder ring"))
        self.debounce_s = float(
            debounce_s if debounce_s is not None else config.knob(
                "KFT_INCIDENT_DEBOUNCE_SECONDS", 300.0, float,
                doc="minimum seconds between captures of the same alert "
                    "(a flapping alert must not churn the ring)"))
        self.max_journeys = int(
            max_journeys if max_journeys is not None else config.knob(
                "KFT_INCIDENT_JOURNEYS", 3, int,
                doc="worst-object causal journeys snapshotted per bundle"))
        self.max_series = int(
            max_series if max_series is not None else config.knob(
                "KFT_INCIDENT_SERIES", 64, int,
                doc="TSDB series kept per incident bundle export"))
        self.max_samples = int(
            max_samples if max_samples is not None else config.knob(
                "KFT_INCIDENT_SAMPLES", 240, int,
                doc="newest samples kept per exported incident series"))
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(1, self.ring))
        self._last_capture: Dict[str, float] = {}
        # Entrypoint-wired extra snapshot sections (e.g. main.py adds
        # "shards" when sharded HA runs); each callable returns a
        # JSON-able snapshot or None to skip.
        self._sections: Dict[str, Callable[[], Optional[dict]]] = {}

    def add_section(self, name: str,
                    fn: Callable[[], Optional[dict]]) -> None:
        self._sections[name] = fn

    # -- capture --------------------------------------------------------------

    def capture(self, rule, st, at: Optional[float] = None, *,
                engine=None) -> Optional[dict]:
        """Snapshot one bundle for ``rule``'s firing transition at
        ``at``; returns the bundle, or None when debounced.  Everything
        in the bundle is a deterministic function of (rule, at, shared
        state) so sibling replicas produce equivalent manifests."""
        at = self.now() if at is None else at
        with self._lock:
            last = self._last_capture.get(rule.name)
            if last is not None and at - last < self.debounce_s:
                return None
            self._last_capture[rule.name] = at

        start = at - rule.slow_window_s
        bundle = {
            "id": f"{rule.name}-{int(at)}",
            "alert": self._alert_section(rule, st, at),
            "tsdb": self._tsdb_section(rule.metric, dict(rule.matcher),
                                       start, at),
            "journeys": self._journey_section(start, at),
            "profile": self._profile_section(),
            "knobs": config.effective(),
        }
        recorded = self._recorded_section(engine, start, at)
        if recorded:
            bundle["recorded"] = recorded
        for name, snap in self._snapshot_sections(engine).items():
            bundle[name] = snap
        bundle["manifest"] = self._manifest(bundle, rule, at)

        with self._lock:
            self._ring.append(bundle)
        self._bump_metric(rule.name)
        self._emit_event(rule)
        return bundle

    def _alert_section(self, rule, st, at: float) -> dict:
        return {
            "alert": rule.name,
            "state": st.state,
            "capturedAt": round(at, 3),
            "metric": rule.metric,
            "thresholdSeconds": rule.threshold,
            "objective": rule.objective,
            "fastBurn": (round(st.fast_burn, 3)
                         if st.fast_burn is not None else None),
            "slowBurn": (round(st.slow_burn, 3)
                         if st.slow_burn is not None else None),
            "windows": {"fastSeconds": rule.fast_window_s,
                        "slowSeconds": rule.slow_window_s},
            "doc": rule.doc,
        }

    def _export(self, metric: str, matcher: dict,
                start: float, end: float) -> List[dict]:
        series = []
        for labels, samples in self.tsdb.window(metric, matcher,
                                                start, end):
            series.append({
                "labels": dict(sorted(labels.items())),
                "samples": [[round(ts, 6), value]
                            for ts, value in samples[-self.max_samples:]],
            })
        series.sort(key=lambda s: sorted(s["labels"].items()))
        return series[:self.max_series]

    def _tsdb_section(self, metric: str, matcher: dict,
                      start: float, end: float) -> dict:
        return {
            "metric": metric,
            "matcher": dict(sorted(matcher.items())),
            "start": round(start, 3),
            "end": round(end, 3),
            "series": self._export(metric, matcher, start, end),
        }

    def _recorded_section(self, engine, start: float,
                          end: float) -> List[dict]:
        if engine is None or not getattr(engine, "recording", None):
            return []
        return [self._tsdb_section(rec.record, dict(rec.matcher),
                                   start, end)
                for rec in engine.recording]

    def _journey_section(self, start: float, end: float) -> List[dict]:
        """Merged causal journeys for the worst objects of the burn
        window: group in-window spans by trace, rank traces by their
        longest span, keep the top K, export each trace's full
        journey."""
        from kubeflow_tpu_torch.telemetry import causal

        worst: Dict[str, float] = {}
        for span in causal.STORE.recent(start=start, end=end):
            tid = span["trace_id"]
            worst[tid] = max(worst.get(tid, 0.0), span["duration_ms"])
        ranked = sorted(worst.items(), key=lambda kv: (-kv[1], kv[0]))
        out = []
        for tid, duration_ms in ranked[:self.max_journeys]:
            out.append({
                "trace_id": tid,
                "worst_span_ms": duration_ms,
                "spans": causal.merge_journeys(causal.journey(tid)),
            })
        return out

    def _profile_section(self) -> Optional[dict]:
        from kubeflow_tpu_torch.telemetry import profiler

        p = profiler.debug_profiler()
        if p is None:
            return None
        wid = p.current_window_id()
        return {"window": wid, "folded": p.folded(),
                "selfSeconds": {role: round(s, 3) for role, s
                                in sorted(p.self_seconds().items())}}

    def _snapshot_sections(self, engine) -> Dict[str, Optional[dict]]:
        from kubeflow_tpu_torch.platform.runtime import jobqueue
        from kubeflow_tpu_torch.telemetry import goodput

        out: Dict[str, Optional[dict]] = {
            "queue": jobqueue.debug_snapshot(),
            "goodput": goodput.debug_snapshot(),
            "alerts": engine.snapshot() if engine is not None else None,
        }
        for name, fn in sorted(self._sections.items()):
            try:
                out[name] = fn()
            except Exception:
                log.debug("incident section %s failed", name,
                          exc_info=True)
                out[name] = None
        return out

    def _manifest(self, bundle: dict, rule, at: float) -> dict:
        """The ``/debug/incidents`` listing row: deterministic in (rule,
        at, shared state) so sibling replicas list equivalent evidence."""
        profile = bundle.get("profile")
        return {
            "id": bundle["id"],
            "alert": rule.name,
            "state": "firing",
            "capturedAt": int(at),
            "sections": sorted(k for k, v in bundle.items()
                               if k not in ("id", "manifest")
                               and v is not None),
            "series": len(bundle["tsdb"]["series"]),
            "journeys": len(bundle["journeys"]),
            "profileWindow": (profile or {}).get("window"),
        }

    def _bump_metric(self, alert: str) -> None:
        from kubeflow_tpu_torch.platform.runtime import metrics

        metrics.kft_incidents_captured_total.labels(alert=alert).inc()

    def _emit_event(self, rule) -> None:
        """Announce the capture fleet-wide: one Event object per alert
        through the stamping apply helpers; a deterministic name and
        owned content (no burn numbers, no bundle ids with replica-local
        clocks in the message) make the sibling replica's apply a no-op
        and a create race land on AlreadyExists."""
        if self.client is None:
            return
        from kubeflow_tpu_torch.platform.k8s import errors
        from kubeflow_tpu_torch.platform.k8s.types import EVENT
        from kubeflow_tpu_torch.platform.runtime.apply import create_or_update

        ev = {
            "apiVersion": "v1",
            "kind": "Event",
            "metadata": {"name": f"kft-incident-{rule.name}",
                         "namespace": self.namespace},
            "involvedObject": {"kind": "FleetSLO", "name": rule.name,
                               "namespace": self.namespace},
            "type": "Warning",
            "reason": "IncidentCaptured",
            "message": (f"incident bundle captured for burn-rate alert "
                        f"{rule.name}; evidence at /debug/incidents on "
                        f"each replica"),
            "source": {"component": self.component},
        }
        try:
            create_or_update(
                self.client, EVENT, ev,
                owned_fields=("type", "reason", "message",
                              "involvedObject", "source"))
        except errors.AlreadyExists:
            pass  # a sibling replica announced this incident first
        except errors.ApiError:
            log.debug("incident event emission failed", exc_info=True)

    # -- reads ----------------------------------------------------------------

    def snapshot(self) -> dict:
        """The /debug/incidents payload: manifests, newest first."""
        with self._lock:
            manifests = [b["manifest"] for b in reversed(self._ring)]
        return {"incidents": manifests, "ring": self.ring,
                "debounceSeconds": self.debounce_s}

    def get(self, incident_id: str) -> Optional[dict]:
        """One full bundle (the /debug/incidents/<id> payload)."""
        with self._lock:
            for b in self._ring:
                if b["id"] == incident_id:
                    return b
        return None


# -- /debug/incidents registry (single-slot, like jobqueue's) -----------------

_debug_recorder: Optional[IncidentRecorder] = None


def register_debug_incidents(rec: Optional[IncidentRecorder]) -> None:
    global _debug_recorder
    _debug_recorder = rec


def debug_snapshot() -> Optional[dict]:
    r = _debug_recorder
    return r.snapshot() if r is not None else None


def debug_get(incident_id: str) -> Optional[dict]:
    r = _debug_recorder
    return r.get(incident_id) if r is not None else None
