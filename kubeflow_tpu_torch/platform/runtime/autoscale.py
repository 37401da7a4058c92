"""Target-tracking autoscaler for InferenceService replicas.  The port's
copy of ``kubeflow_tpu/platform/runtime/autoscale.py``, whole.

The decision function is PURE — ``decide_scale(current, sample, targets,
state, now)`` → (replicas, reason, new_state) — with every bit of memory
it needs (last traffic time, last scale-down time, last counter reading)
in the ``ScaleState`` value the caller persists on the CR status.  That
makes it testable without a cluster, restart-safe (the state rebuilds
from watch state like everything else), and identical across sharded HA
replicas.

Scaling model:

* **Target tracking, per signal.**  Each scraped serve series yields a
  desired width ``ceil(current * observed / target)`` — the classic
  HPA formula; the FINAL desired width is the max over signals, so the
  most-pressured signal wins.  Signals: per-replica scheduler queue depth
  (``serve_queue_depth``), TTFT p99 (``serve_time_to_first_token_seconds``)
  against an absolute ceiling, and decode-slot occupancy
  (``serve_decode_slots_active / serve_decode_slots``).
* **Asymmetric hysteresis.**  Scale-UP applies immediately (queued users
  are waiting); scale-DOWN is rate-limited to one step per
  ``cooldown_seconds`` AND never more than halving per step, so a noisy
  series cannot flap the fleet (the pinned no-flap property).
* **Scale-to-zero.**  With ``min_replicas == 0``, a service whose traffic
  counter has not moved for ``idle_seconds`` drops to zero in one step
  (idleness is binary — draining 4→2→1→0 replicas that serve nothing just
  burns GPUs).  A wake request (the activator annotation) postdating the
  idle transition brings it back to ``max(min, 1)`` immediately; the
  cooldown never delays a wake.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ScaleTargets:
    """Per-service autoscaling knobs (spec.scale + spec.replicas)."""

    min_replicas: int = 1
    max_replicas: int = 1
    queue_depth: float = 4.0          # per-replica pending rows
    ttft_p99_s: Optional[float] = None  # absolute ceiling; None = off
    slot_occupancy: float = 0.8       # active / total decode slots
    idle_seconds: float = 300.0
    cooldown_seconds: float = 30.0


@dataclasses.dataclass(frozen=True)
class ServeSample:
    """One scrape pass over the service's READY replicas, reduced to
    per-replica means (queue/occupancy) and fleet-wide aggregates
    (requests, p99).  ``replicas_scraped == 0`` means no replica answered
    (cold, or every scrape failed) — the decision then holds width rather
    than acting on silence."""

    replicas_scraped: int = 0
    queue_depth: float = 0.0          # mean per-replica
    ttft_p99_s: Optional[float] = None
    slot_occupancy: Optional[float] = None
    requests_total: float = 0.0       # cumulative counter, summed


@dataclasses.dataclass(frozen=True)
class ScaleState:
    """The decision function's whole memory, persisted by the caller."""

    last_traffic_at: float = 0.0      # when requests_total last moved
    last_requests_total: float = 0.0
    last_scale_down_at: float = 0.0
    idle_since_zero: bool = False     # currently parked at zero for idleness
    scraped: bool = False             # a replica has answered a scrape in
    #                                   this nonzero-width episode


@dataclasses.dataclass(frozen=True)
class ScaleDecision:
    replicas: int
    reason: str                       # "", "ScaleUp", "ScaleDown",
    #                                   "ScaleToZero", "Wake", "Cooldown"
    state: ScaleState


def _desired_for(current: int, observed: Optional[float],
                 target: Optional[float]) -> Optional[int]:
    """Desired width from one signal, or None when the signal is absent
    (an unscraped series must neither pin nor shrink the fleet)."""
    if observed is None or not target or target <= 0:
        return None
    return max(0, math.ceil(current * (observed / target)))


def decide_scale(current: int, sample: ServeSample, targets: ScaleTargets,
                 state: ScaleState, now: float, *,
                 wake_requested_at: Optional[float] = None
                 ) -> ScaleDecision:
    """One autoscaling step.  ``current`` is the current TARGET width
    (status.replicas), not the ready count — the controller scales intent,
    and readiness catches up."""
    lo = max(targets.min_replicas, 0)
    hi = max(targets.max_replicas, max(lo, 1))

    # Traffic bookkeeping: the request counter moving UP = traffic.  A
    # fresh state (last_traffic_at == 0) starts its idle window NOW, not
    # at the epoch — a just-created idle service gets its full window.
    # The baseline FOLLOWS the scraped sum in both directions: a
    # scale-down or a restarted pod shrinks the fleet-wide sum, and a
    # frozen high-water mark would then read steady traffic as idleness
    # until the survivors re-crossed it (scaling an active service to
    # zero).  A downward move re-baselines without counting as traffic.
    moved = (sample.replicas_scraped > 0
             and sample.requests_total > state.last_requests_total)
    last_traffic = (now if moved or state.last_traffic_at == 0.0
                    else state.last_traffic_at)
    next_state = dataclasses.replace(
        state, last_traffic_at=last_traffic,
        last_requests_total=(sample.requests_total
                             if sample.replicas_scraped
                             else state.last_requests_total))

    # Spec bounds are authoritative and immediate: an operator edit to
    # replicas.min/max takes effect this pass, cooldown or not.
    if current > hi:
        return ScaleDecision(hi, "ScaleDown", next_state)
    if 0 < current < max(lo, 1):
        return ScaleDecision(max(lo, 1), "ScaleUp", next_state)
    if current == 0 and lo > 0:
        return ScaleDecision(
            max(lo, 1), "ScaleUp",
            dataclasses.replace(next_state, idle_since_zero=False,
                                scraped=False))

    # Wake beats everything: a request hit a scaled-to-zero service.
    if current == 0:
        woken = (wake_requested_at is not None
                 and (not state.idle_since_zero
                      or wake_requested_at > state.last_scale_down_at))
        if woken or moved:
            return ScaleDecision(
                max(lo, 1), "Wake",
                dataclasses.replace(next_state, idle_since_zero=False,
                                    scraped=False, last_traffic_at=now))
        return ScaleDecision(0, "", next_state)

    if sample.replicas_scraped == 0:
        # Nothing answered the scrape (replicas still warming, or the
        # scrape path is down): hold width in BOTH directions — silence
        # is not a signal, and in particular not idleness: a cold pool
        # must never idle out to zero before its first replica warms.
        return ScaleDecision(current, "", next_state)
    if not state.scraped:
        # First contact in this episode: the replicas just became
        # scrapeable after a warm-up of arbitrary length, so the idle
        # window restarts NOW — a cold start slower than idle_seconds
        # must not read as an idle service.
        last_traffic = now
        next_state = dataclasses.replace(next_state, scraped=True,
                                         last_traffic_at=now)

    # Scale-to-zero: idle window elapsed with a zero floor, decided only
    # on a pass that really scraped the (traffic-counter) series.
    if lo == 0 and now - last_traffic >= targets.idle_seconds:
        return ScaleDecision(
            0, "ScaleToZero",
            dataclasses.replace(next_state, idle_since_zero=True,
                                scraped=False,
                                last_scale_down_at=now))

    desires = [d for d in (
        _desired_for(current, sample.queue_depth, targets.queue_depth),
        _desired_for(current, sample.ttft_p99_s, targets.ttft_p99_s),
        _desired_for(current, sample.slot_occupancy,
                     targets.slot_occupancy),
    ) if d is not None]
    desired = max(desires) if desires else current
    desired = min(max(desired, max(lo, 1)), hi)

    if desired > current:
        return ScaleDecision(desired, "ScaleUp", next_state)
    if desired < current:
        if now - state.last_scale_down_at < targets.cooldown_seconds:
            return ScaleDecision(current, "Cooldown", next_state)
        # Never more than halving per step: one noisy near-zero sample
        # must not collapse the fleet.
        step_floor = max(current // 2, max(lo, 1))
        return ScaleDecision(
            max(desired, step_floor), "ScaleDown",
            dataclasses.replace(next_state, last_scale_down_at=now))
    return ScaleDecision(current, "", next_state)


def state_from_status(status: dict) -> ScaleState:
    """Rebuild the decision memory from a CR status (watch state — the
    same restart-survival contract as the jobqueue ledger)."""
    status = status or {}
    return ScaleState(
        last_traffic_at=float(status.get("lastTrafficAt") or 0.0),
        last_requests_total=float(status.get("observedRequests") or 0.0),
        last_scale_down_at=float(status.get("lastScaleAt") or 0.0),
        idle_since_zero=bool(status.get("idleSinceZero") or False),
        scraped=bool(status.get("scraped") or False),
    )


def state_to_status(state: ScaleState) -> dict:
    return {
        "lastTrafficAt": round(state.last_traffic_at, 3),
        "observedRequests": round(state.last_requests_total, 1),
        "lastScaleAt": round(state.last_scale_down_at, 3),
        "idleSinceZero": state.idle_since_zero,
        "scraped": state.scraped,
    }


def targets_from_spec(svc: dict) -> ScaleTargets:
    """ScaleTargets from an InferenceService resource (defaults from
    apis/inferenceservice.py)."""
    from kubeflow_tpu_torch.platform.apis import inferenceservice as api
    from kubeflow_tpu_torch.platform.k8s.types import deep_get

    lo, hi = api.replica_bounds(svc)
    scale = deep_get(svc, "spec", "scale", default={}) or {}

    def num(key, default):
        val = scale.get(key)
        return default if val is None else float(val)

    ttft = scale.get("ttftP99TargetSeconds")
    return ScaleTargets(
        min_replicas=lo,
        max_replicas=hi,
        queue_depth=num("queueDepthTarget", api.DEFAULT_QUEUE_DEPTH_TARGET),
        ttft_p99_s=None if ttft is None else float(ttft),
        slot_occupancy=num("slotOccupancyTarget",
                           api.DEFAULT_SLOT_OCCUPANCY_TARGET),
        idle_seconds=num("idleSeconds", api.DEFAULT_IDLE_SECONDS),
        cooldown_seconds=num("cooldownSeconds",
                             api.DEFAULT_COOLDOWN_SECONDS),
    )
