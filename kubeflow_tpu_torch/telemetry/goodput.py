"""Per-tenant GPU goodput accounting: what fraction of the GPU-seconds
each profile held did work.  The port's copy of
``kubeflow_tpu/telemetry/goodput.py``, in GPU-seconds where the
reference counts chip-seconds.

The goodput decomposition over the ledger's allocated GPUs: the job
queue grants every admitted gang's GPUs and the InferenceService
controller declares every replica's, so allocated GPU-seconds per
profile namespace are watch-state facts.  This module integrates them
against productive GPU-seconds (training gangs weighted by their ready
workers, serving replicas by their scraped decode-slot occupancy) and
tiles the remainder into a bounded non-goodput decomposition:

    allocated == goodput + queued + restarting + idle     (exactly)

* **queued**: GPUs granted but not yet working: an admitted gang whose
  pods are still Pending, a serving replica that has not passed
  readiness (cold starts, rollout warms);
* **restarting**: GPUs held through a gang restart or a two-phase
  preemption drain (the checkpoint tax);
* **idle**: GPUs on ready workers doing nothing: empty decode slots, a
  Running gang whose workers lost readiness.

The tiling holds by construction: each workload's instantaneous GPUs
are split into the four states with explicit clamps before the dt
integration, so the invariant cannot drift however the inputs
misbehave.  Serving occupancy reads the fleet TSDB with a staleness
bound: a dead replica's frozen last sample stops counting after
``KFT_GOODPUT_STALENESS_SECONDS``.

``gpu_goodput_ratio{profile}`` and ``gpu_seconds_total{profile,state}``
(the reference's ``tpu_goodput_ratio`` and ``tpu_chip_seconds_total``)
land in the control plane's registry; ``/debug/goodput`` serves the
cumulative ledger through a single-slot registry, its keys
``*GpuSeconds`` where the reference's are ``*ChipSeconds``.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Iterable, List, Optional

from kubeflow_tpu_torch.platform import config

STATES = ("goodput", "queued", "restarting", "idle")


@dataclasses.dataclass(frozen=True)
class WorkloadUse:
    """One workload's instantaneous allocated GPUs, decomposed.  The
    constructor inputs are clamped by the factories;
    ``idle`` is always the exact remainder."""

    profile: str
    gpus: float
    productive: float = 0.0
    queued: float = 0.0
    restarting: float = 0.0

    @property
    def idle(self) -> float:
        return max(0.0, self.gpus - self.productive - self.queued
                   - self.restarting)


def job_use(job: dict) -> Optional[WorkloadUse]:
    """A GPUJob's GPU decomposition from its watch state, or None when
    it holds no GPUs (Queued, terminal, invalid)."""
    from kubeflow_tpu_torch.platform.apis import gpujob as jobapi
    from kubeflow_tpu_torch.platform.k8s.types import deep_get

    spec = jobapi.gpu_slice_or_none(job)
    if spec is None:
        return None
    phase = jobapi.phase_of(job)
    if phase in jobapi.TERMINAL_PHASES or phase not in jobapi.HOLDING_PHASES:
        return None
    alloc = jobapi.allocated_slices(job)
    if alloc is None:
        # Pre-queue legacy jobs hold their full spec width once Running.
        if phase != jobapi.PHASE_RUNNING:
            return None
        alloc = spec.num_slices
    gpus = float(alloc) * spec.gpus
    if gpus <= 0:
        return None
    ns = deep_get(job, "metadata", "namespace", default="") or ""
    if phase in (jobapi.PHASE_RESTARTING, jobapi.PHASE_PREEMPTING):
        return WorkloadUse(ns, gpus, restarting=gpus)
    if phase == jobapi.PHASE_PENDING:
        return WorkloadUse(ns, gpus, queued=gpus)
    # Running: productive in proportion to ready workers (the gang's own
    # telemetry — status.slices ready/total); the rest is idle.
    ready = total = 0
    for s in deep_get(job, "status", "slices", default=[]) or []:
        ready += int(s.get("ready", 0) or 0)
        total += int(s.get("total", 0) or 0)
    frac = min(max(ready / total, 0.0), 1.0) if total > 0 else 0.0
    return WorkloadUse(ns, gpus, productive=gpus * frac)


def service_use(svc: dict, *, tsdb=None, at: Optional[float] = None,
                staleness: Optional[float] = None
                ) -> Optional[WorkloadUse]:
    """An InferenceService's GPU decomposition: target replicas are the
    declared charge; unready replicas are ``queued`` (cold start /
    rollout warm); ready replicas are productive in proportion to their
    scraped decode-slot occupancy (``serve_decode_slots_active`` /
    ``serve_decode_slots`` from the fleet TSDB, staleness-bounded) and
    idle for the rest.  None when the service holds no GPUs."""
    from kubeflow_tpu_torch.platform.apis import inferenceservice as svcapi
    from kubeflow_tpu_torch.platform.k8s.types import meta, name_of

    gpus = svcapi.gpus_of(svc)
    if gpus <= 0:
        return None
    ns = meta(svc).get("namespace") or ""
    key = f"{ns}/{name_of(svc)}"
    status = svc.get("status") or {}
    replicas = max(int(status.get("replicas", 0) or 0), 0)
    ready = min(max(int(status.get("readyReplicas", 0) or 0), 0),
                replicas if replicas else 0)
    # Both revisions' widths charge during a rollout (gpus_of); the
    # readiness fraction keys off the serving revision's counts — the
    # warming revision's share reads as queued, which is what a warm IS.
    frac_ready = (ready / replicas) if replicas > 0 else 0.0
    ready_gpus = gpus * frac_ready
    queued = gpus - ready_gpus
    occ = 0.0
    if tsdb is not None and ready_gpus > 0:
        active = sum(v for _l, _ts, v in tsdb.instant(
            "serve_decode_slots_active", {"service": key},
            at=at, staleness=staleness))
        slots = sum(v for _l, _ts, v in tsdb.instant(
            "serve_decode_slots", {"service": key},
            at=at, staleness=staleness))
        if slots > 0:
            occ = min(max(active / slots, 0.0), 1.0)
    productive = ready_gpus * occ
    # idle = ready_gpus * (1 - occ), by the remainder property.
    return WorkloadUse(ns, gpus, productive=productive, queued=queued)


class GoodputAccountant:
    """Integrate instantaneous WorkloadUse decompositions into
    cumulative per-profile GPU-second buckets.  ``observe`` is the
    watch-state entrypoint (jobs + services lists → uses → tick); tests
    drive ``tick`` directly with synthetic uses and a fake clock."""

    def __init__(self, *, now=time.time, staleness: Optional[float] = None):
        self.now = now
        self.staleness = (staleness if staleness is not None
                          else config.knob(
                              "KFT_GOODPUT_STALENESS_SECONDS", 60.0, float,
                              doc="serve occupancy samples older than this "
                                  "stop counting toward goodput (a dead "
                                  "replica's frozen series must not)"))
        self._lock = threading.Lock()
        self._last_ts: Optional[float] = None
        # profile -> {state: GPU-seconds} (+ "allocated")
        self._acc: Dict[str, Dict[str, float]] = {}

    # -- integration ----------------------------------------------------------

    def observe(self, jobs: Iterable[dict], services: Iterable[dict], *,
                tsdb=None, at: Optional[float] = None) -> None:
        if at is None:
            at = self.now()
        uses: List[WorkloadUse] = []
        for job in jobs or ():
            use = job_use(job)
            if use is not None:
                uses.append(use)
        for svc in services or ():
            use = service_use(svc, tsdb=tsdb, at=at,
                              staleness=self.staleness)
            if use is not None:
                uses.append(use)
        self.tick(uses, at=at)

    def tick(self, uses: Iterable[WorkloadUse],
             at: Optional[float] = None) -> None:
        from kubeflow_tpu_torch.platform.runtime import metrics

        if at is None:
            at = self.now()
        with self._lock:
            last = self._last_ts
            if last is None:
                self._last_ts = at
                return
            if at <= last:
                # A backwards (NTP step) or duplicate timestamp must not
                # move the integration anchor: rewinding it would
                # re-integrate an interval that was already counted.
                return
            self._last_ts = at
            dt = at - last
            per_tick: Dict[str, Dict[str, float]] = {}
            for use in uses:
                # Clamp each named bucket into the remaining allocation
                # in order so the sum can never exceed the GPUs, then tile
                # the rest as idle — the invariant holds by construction
                # whatever the inputs claim.
                gpus = max(use.gpus, 0.0)
                queued = min(max(use.queued, 0.0), gpus)
                restarting = min(max(use.restarting, 0.0), gpus - queued)
                productive = min(max(use.productive, 0.0),
                                 gpus - queued - restarting)
                idle = gpus - queued - restarting - productive
                buckets = per_tick.setdefault(
                    use.profile, dict.fromkeys(STATES, 0.0))
                buckets["goodput"] += productive
                buckets["queued"] += queued
                buckets["restarting"] += restarting
                buckets["idle"] += idle
            for profile, buckets in per_tick.items():
                acc = self._acc.setdefault(
                    profile, dict.fromkeys((*STATES, "allocated"), 0.0))
                for state in STATES:
                    cs = buckets[state] * dt
                    acc[state] += cs
                    acc["allocated"] += cs
                    if cs > 0:
                        metrics.gpu_seconds_total.labels(
                            profile=profile, state=state).inc(cs)
            for profile, acc in self._acc.items():
                if acc["allocated"] > 0:
                    metrics.gpu_goodput_ratio.labels(profile=profile).set(
                        acc["goodput"] / acc["allocated"])

    # -- introspection --------------------------------------------------------

    def snapshot(self) -> dict:
        """The /debug/goodput payload: cumulative GPU-seconds per
        profile, the ratio, and the tiling check (always True by
        construction, served so a reader can verify, not trust)."""
        with self._lock:
            profiles = {}
            for profile, acc in sorted(self._acc.items()):
                allocated = acc["allocated"]
                profiles[profile] = {
                    "allocatedGpuSeconds": round(allocated, 3),
                    **{f"{s}GpuSeconds": round(acc[s], 3) for s in STATES},
                    "goodputRatio": (round(acc["goodput"] / allocated, 4)
                                     if allocated > 0 else None),
                    "tiles": abs(sum(acc[s] for s in STATES)
                                 - allocated) < 1e-6,
                }
            return {"profiles": profiles,
                    "lastTickAt": (round(self._last_ts, 3)
                                   if self._last_ts else None)}


# -- /debug/goodput registry (single-slot, like jobqueue's) -------------------

_debug_accountant: Optional[GoodputAccountant] = None


def register_debug_goodput(acct: Optional[GoodputAccountant]) -> None:
    global _debug_accountant
    _debug_accountant = acct


def debug_snapshot() -> Optional[dict]:
    a = _debug_accountant
    return a.snapshot() if a is not None else None
