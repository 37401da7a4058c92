"""Declarative SLO rules over the fleet TSDB: multi-window burn-rate
alerting and recording rules.  The port's copy of
``kubeflow_tpu/telemetry/slo.py``.

The model is the SRE-workbook burn-rate pattern on latency SLOs: an
objective says "``objective`` of events complete within ``threshold``
seconds"; from a histogram's buckets, *good* = the windowed increase of
the largest bucket at or under the threshold and *total* = the ``+Inf``
bucket's increase, so

    error_ratio = 1 - good / total
    burn_rate   = error_ratio / (1 - objective)

A burn rate of 1.0 spends the error budget exactly over the SLO period;
the alert fires only when both a fast window (catches a cliff within one
evaluation) and a slow window (keeps a single bad scrape from paging)
burn above their thresholds, and resolves when either recovers with
events in its window.  Window lengths, burn thresholds, the objective
and each SLO's latency threshold are knobs (``platform/config.py``'s
registry; ``/debug/knobs`` shows them).  The queue-wait rule reads the
GPUJob queue's ``gpujob_queue_wait_seconds_bucket``, where the
reference's reads ``tpujob_queue_wait_seconds_bucket``.

State transitions are counted in ``kft_alert_transitions_total`` and
mirrored into ``kft_alerts_firing``; with a client attached, each
transition is recorded as one fleet-wide Kubernetes Event through the
stamping apply helpers: the Event's name and owned content are
deterministic in the alert, so ``create_or_update``'s content hash makes
N replicas evaluating the same rules write exactly one object.
``/debug/alerts`` serves the live state through a single-slot registry.
"""
from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import Dict, List, Optional, Tuple

from kubeflow_tpu_torch.platform import config
from kubeflow_tpu_torch.telemetry.tsdb import TSDB

log = logging.getLogger("kubeflow_tpu_torch.telemetry.slo")

STATE_INACTIVE = "inactive"
STATE_FIRING = "firing"


@dataclasses.dataclass(frozen=True)
class BurnRateRule:
    """One latency-SLO burn-rate alert over a stored bucket series."""

    name: str                      # alert name (bounded label value)
    metric: str                    # bucket series, e.g. "..._seconds_bucket"
    threshold: float               # latency objective bound (seconds)
    objective: float = 0.99        # fraction of events under threshold
    matcher: Tuple[Tuple[str, str], ...] = ()
    fast_window_s: float = 300.0
    slow_window_s: float = 3600.0
    fast_burn: float = 14.4        # SRE-workbook page thresholds
    slow_burn: float = 6.0
    min_events: float = 1.0        # fast-window total below this = no signal
    doc: str = ""

    def burn_rates(self, tsdb: TSDB, at: float
                   ) -> Tuple[Optional[float], Optional[float], float]:
        """(fast_burn_rate, slow_burn_rate, fast_total_events); None
        where the window holds no events (no signal ≠ healthy ≠ burning
        — an absent series must neither fire nor resolve-with-proof)."""
        m = dict(self.matcher)
        fast = self._burn(tsdb, at, self.fast_window_s, m)
        slow = self._burn(tsdb, at, self.slow_window_s, m)
        return fast[0], slow[0], fast[1]

    def _burn(self, tsdb: TSDB, at: float, window: float, matcher: dict
              ) -> Tuple[Optional[float], float]:
        buckets = tsdb.bucket_increases(self.metric, matcher,
                                        window=window, at=at)
        total = buckets.get(math.inf, 0.0)
        if total <= 0:
            return None, 0.0
        # Good = the largest bucket bound at or under the threshold
        # (cumulative buckets: that IS the count within objective); a
        # threshold between bounds degrades conservatively to the bound
        # below it.
        good_bounds = [b for b in buckets
                       if b != math.inf and b <= self.threshold + 1e-12]
        good = buckets[max(good_bounds)] if good_bounds else 0.0
        error_ratio = min(max(1.0 - good / total, 0.0), 1.0)
        budget = max(1.0 - self.objective, 1e-9)
        return error_ratio / budget, total


@dataclasses.dataclass(frozen=True)
class RecordingRule:
    """Precompute a quantile over a bucket series into a new stored
    series (``record``) each evaluation — dashboards and later rules
    read the recorded series instead of re-walking buckets."""

    record: str                    # output series name
    metric: str                    # input bucket series
    q: float = 0.99
    window_s: float = 300.0
    matcher: Tuple[Tuple[str, str], ...] = ()

    def evaluate(self, tsdb: TSDB, at: float) -> Optional[float]:
        value = tsdb.histogram_quantile(self.q, self.metric,
                                        dict(self.matcher),
                                        window=self.window_s, at=at)
        if value is not None:
            tsdb.append(self.record, dict(self.matcher), value, ts=at)
        return value


@dataclasses.dataclass
class AlertState:
    state: str = STATE_INACTIVE
    since: float = 0.0
    fast_burn: Optional[float] = None
    slow_burn: Optional[float] = None
    transitions: int = 0


def default_rules() -> List[BurnRateRule]:
    """The four fleet SLOs: serve TTFT p99, reconcile p99, informer
    watch lag, GPUJob queue wait.  Thresholds default to existing
    histogram bucket bounds so the good-bucket lookup is exact."""
    fast = config.knob("KFT_SLO_FAST_WINDOW_SECONDS", 300.0, float,
                       doc="burn-rate fast window (the paging window)")
    slow = config.knob("KFT_SLO_SLOW_WINDOW_SECONDS", 3600.0, float,
                       doc="burn-rate slow window (the confirmation window)")
    fast_burn = config.knob("KFT_SLO_FAST_BURN", 14.4, float,
                            doc="fast-window burn-rate page threshold")
    slow_burn = config.knob("KFT_SLO_SLOW_BURN", 6.0, float,
                            doc="slow-window burn-rate page threshold")
    objective = config.knob("KFT_SLO_OBJECTIVE", 0.99, float,
                            doc="fraction of events that must land under "
                                "each SLO's latency threshold")

    def rule(name, metric, threshold_knob, threshold_default, doc):
        return BurnRateRule(
            name=name, metric=metric,
            threshold=config.knob(threshold_knob, threshold_default, float,
                                  doc=f"{name} latency threshold (s)"),
            objective=objective, fast_window_s=fast, slow_window_s=slow,
            fast_burn=fast_burn, slow_burn=slow_burn, doc=doc)

    return [
        rule("serve-ttft-p99",
             "serve_time_to_first_token_seconds_bucket",
             "KFT_SLO_TTFT_SECONDS", 5.0,
             "time-to-first-token across scraped serving replicas"),
        rule("reconcile-p99",
             "controller_runtime_reconcile_time_seconds_bucket",
             "KFT_SLO_RECONCILE_SECONDS", 1.0,
             "control-plane reconcile latency (self-scrape)"),
        rule("watch-lag",
             "informer_watch_lag_seconds_bucket",
             "KFT_SLO_WATCH_LAG_SECONDS", 5.0,
             "API write -> watch delivery lag (self-scrape)"),
        rule("queue-wait",
             "gpujob_queue_wait_seconds_bucket",
             "KFT_SLO_QUEUE_WAIT_SECONDS", 300.0,
             "GPUJob admission-queue wait (self-scrape)"),
    ]


class RuleEngine:
    """Evaluate burn-rate + recording rules on a cadence; own the alert
    state machine and its fleet-wide Event emission."""

    def __init__(self, tsdb: TSDB, rules: Optional[List[BurnRateRule]] = None,
                 *, recording: Optional[List[RecordingRule]] = None,
                 client=None, namespace: str = "kubeflow",
                 component: str = "slo-engine", incidents=None, now=time.time):
        self.tsdb = tsdb
        self.rules = list(default_rules() if rules is None else rules)
        self.recording = list(recording or [])
        self.client = client
        self.namespace = namespace
        self.component = component
        # Optional flight recorder (telemetry/incidents.py): every
        # transition TO firing captures one evidence bundle.  Kept as a
        # plain attribute so tests and MetricsPipeline can attach one
        # after construction.
        self.incidents = incidents
        self.now = now
        self.states: Dict[str, AlertState] = {
            r.name: AlertState() for r in self.rules}
        self.last_eval_at: Optional[float] = None

    # -- evaluation -----------------------------------------------------------

    def evaluate(self, at: Optional[float] = None) -> List[dict]:
        """One evaluation pass; returns the transitions it caused
        (``[{"alert", "state", "fast_burn", "slow_burn"}]``)."""
        from kubeflow_tpu_torch.platform.runtime import metrics

        if at is None:
            at = self.now()
        self.last_eval_at = at
        for rec in self.recording:
            rec.evaluate(self.tsdb, at)
        transitions: List[dict] = []
        for rule in self.rules:
            fast, slow, events = rule.burn_rates(self.tsdb, at)
            st = self.states[rule.name]
            st.fast_burn, st.slow_burn = fast, slow
            burning = (fast is not None and slow is not None
                       and events >= rule.min_events
                       and fast > rule.fast_burn and slow > rule.slow_burn)
            if burning and st.state != STATE_FIRING:
                self._transition(rule, st, STATE_FIRING, at, transitions)
            elif (not burning and st.state == STATE_FIRING
                  and fast is not None):
                # Recovery needs evidence (a window with events that no
                # longer burns), not silence: a target outage mid-page
                # must not auto-resolve the page.
                self._transition(rule, st, STATE_INACTIVE, at, transitions)
            metrics.kft_alerts_firing.labels(alert=rule.name).set(
                1.0 if st.state == STATE_FIRING else 0.0)
        return transitions

    def _transition(self, rule: BurnRateRule, st: AlertState,
                    to_state: str, at: float,
                    transitions: List[dict]) -> None:
        from kubeflow_tpu_torch.platform.runtime import metrics

        st.state = to_state
        st.since = at
        st.transitions += 1
        label = "firing" if to_state == STATE_FIRING else "resolved"
        metrics.kft_alert_transitions_total.labels(
            alert=rule.name, state=label).inc()
        transitions.append({"alert": rule.name, "state": label,
                            "fast_burn": st.fast_burn,
                            "slow_burn": st.slow_burn})
        self._emit_event(rule, firing=(to_state == STATE_FIRING))
        if to_state == STATE_FIRING and self.incidents is not None:
            # Page-time evidence: the flight recorder snapshots the burn
            # window, worst journeys, profile window and debug surfaces
            # into one bundle (debounced per alert inside capture()).
            # A capture failure must never break the alert state machine.
            try:
                self.incidents.capture(rule, st, at, engine=self)
            except Exception:
                log.debug("incident capture for %s failed", rule.name,
                          exc_info=True)

    def _emit_event(self, rule: BurnRateRule, *, firing: bool) -> None:
        """One fleet-wide Event per transition, through the stamping
        apply helpers.  Name and owned content are deterministic in
        (alert, state): every replica generates the same object, so the
        content hash makes the second apply a no-op and a create race
        lands on AlreadyExists: exactly one Event object fleet-wide,
        flipped in place on resolve."""
        if self.client is None:
            return
        from kubeflow_tpu_torch.platform.k8s import errors
        from kubeflow_tpu_torch.platform.k8s.types import EVENT
        from kubeflow_tpu_torch.platform.runtime.apply import create_or_update

        ev = {
            "apiVersion": "v1",
            "kind": "Event",
            "metadata": {"name": f"kft-alert-{rule.name}",
                         "namespace": self.namespace},
            "involvedObject": {"kind": "FleetSLO", "name": rule.name,
                               "namespace": self.namespace},
            "type": "Warning" if firing else "Normal",
            "reason": "AlertFiring" if firing else "AlertResolved",
            # Deterministic on purpose: burn-rate values differ per
            # replica/evaluation and would defeat the cross-replica
            # content-hash dedup; the live numbers are on /debug/alerts.
            "message": (f"burn-rate alert {rule.name} "
                        f"{'firing' if firing else 'resolved'}: "
                        f"{rule.doc or rule.metric} vs "
                        f"{rule.threshold:g}s objective "
                        f"{rule.objective:g}"),
            "source": {"component": self.component},
        }
        try:
            create_or_update(
                self.client, EVENT, ev,
                owned_fields=("type", "reason", "message",
                              "involvedObject", "source"))
        except errors.AlreadyExists:
            pass  # a sibling replica announced this transition first
        except errors.ApiError:
            log.debug("alert event emission failed", exc_info=True)

    # -- introspection --------------------------------------------------------

    def snapshot(self) -> dict:
        """The /debug/alerts payload."""
        alerts = []
        for rule in self.rules:
            st = self.states[rule.name]
            alerts.append({
                "alert": rule.name,
                "state": st.state,
                "since": round(st.since, 3) if st.since else None,
                "fastBurn": (round(st.fast_burn, 3)
                             if st.fast_burn is not None else None),
                "slowBurn": (round(st.slow_burn, 3)
                             if st.slow_burn is not None else None),
                "metric": rule.metric,
                "thresholdSeconds": rule.threshold,
                "objective": rule.objective,
                "windows": {"fastSeconds": rule.fast_window_s,
                            "slowSeconds": rule.slow_window_s,
                            "fastBurnThreshold": rule.fast_burn,
                            "slowBurnThreshold": rule.slow_burn},
                "transitions": st.transitions,
                "doc": rule.doc,
            })
        return {"alerts": alerts,
                "lastEvalAt": (round(self.last_eval_at, 3)
                               if self.last_eval_at else None)}


# -- /debug/alerts registry (single-slot, like jobqueue's) --------------------

_debug_engine: Optional[RuleEngine] = None


def register_debug_alerts(engine: Optional[RuleEngine]) -> None:
    global _debug_engine
    _debug_engine = engine


def debug_snapshot() -> Optional[dict]:
    e = _debug_engine
    return e.snapshot() if e is not None else None
