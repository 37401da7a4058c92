"""GPUJob reconciler: GPUJob CR → gang of per-slice StatefulSets + Service.

The port's copy of ``kubeflow_tpu/platform/controllers/tpujob.py`` with
GPU slices (``spec.gpu``) in place of TPU slices; the reconcile is the
reference's:

* **Gang creation** — one worker StatefulSet per slice (``replicas =
  hosts``, pod ordinal == worker id, Parallel pod management), every pod
  a ``gpu/pods.py`` ``job_worker_container``: ``nvidia.com/gpu``, the
  env contract of ``parallel/envspec.py`` (the SAME constants
  ``parallel/dist.py`` discovers with), the command under the launcher,
  ``spec.checkpointDir`` as ``KFT_CHECKPOINT_DIR``; its node selector is
  the queue's pool (``GpuSliceSpec.pool_selectors``: the product and
  ``nvidia.com/gpu.count``, as many GPUs as a pod takes).
  All behind ONE headless coordinator Service (``<name>-workers``,
  publishNotReadyAddresses) so worker DNS resolves during the rendezvous.
* **The grace** — the pod template's ``terminationGracePeriodSeconds``
  and the default preemption grace are ``pods.JOB_GRACE_S``: the
  launcher's own wait for its processes to checkpoint, plus a margin to
  kill them.  The reference sets no pod grace (the kubelet's 30 s) and
  frees a preempted gang's chips after 30 s; a full-width GPU worker's
  checkpoint outlasts both.
* **All-or-nothing restarts** — any worker pod failing tears down the
  WHOLE generation and recreates it under a bumped generation label; the
  restarted gang resumes from its checkpoint because the directory is
  stable across generations.  ``spec.backoffLimit`` bounds the
  restarts, ``restartPolicy: Never`` disables them.
* **Status aggregation** — Pending → Running → Succeeded/Failed/Restarting
  with per-slice ready counts and the restart counter.
* **Quota-aware gang queueing** — admission is a decision of the
  ``runtime/jobqueue.py`` ledger (free GPUs per profile quota + free
  pool slots): a gang that does not fit WHOLE parks ``Queued`` with a
  structured reason.  ``spec.priority`` adds preemption: a
  higher-priority head waiter makes the lowest-priority running gang
  checkpoint-then-evict — two-phase (mark ``Preempting`` and delete its
  StatefulSets, the SIGTERM; then free its GPUs once its pods have
  terminated or the grace has run out), and the preemptor is never
  half-admitted.  ``spec.gpu.minSlices`` adds elastic capacity: a
  preempted or shrunk gang resumes the SAME checkpoint at fewer slices
  and grows back when capacity frees.

Terminal phases are sticky, and a finished gang's StatefulSets are deleted
so the GPUs free at once (pods are left for log retrieval).

``make_controller`` drives the reconciler from watches: pods and
StatefulSets are read from indexed informer caches, and the queue's
ledger is fed by its own informers on GPUJobs, quotas, nodes and
InferenceServices; a GPUJob delta wakes the keys that can act on it
(``JobQueue.kick_requests``).  A reconciler built bare on a client
(``reconcile(Request(ns, name))``) reads the client, and its queue
rebuilds from lists each reconcile.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

from kubeflow_tpu_torch.parallel import envspec
from kubeflow_tpu_torch.platform import config
from kubeflow_tpu_torch.platform.apis import gpujob as jobapi
from kubeflow_tpu_torch.platform.gpu import GpuSliceSpec, pods as gpu_pods
from kubeflow_tpu_torch.platform.k8s import errors
from kubeflow_tpu_torch.platform.k8s.types import (
    GPUJOB,
    POD,
    SERVICE,
    STATEFULSET,
    Resource,
    deep_get,
    meta,
    name_of,
    pod_ready,
    set_owner,
    thaw,
)
from kubeflow_tpu_torch.platform.runtime import EventRecorder, Reconciler, Request, Result
from kubeflow_tpu_torch.platform.runtime import jobqueue as jq
from kubeflow_tpu_torch.platform.runtime import metrics
from kubeflow_tpu_torch.platform.runtime import apply
from kubeflow_tpu_torch.platform.runtime.apply import patch_status_diff
from kubeflow_tpu_torch.platform.runtime.flight import shared_pool
from kubeflow_tpu_torch.telemetry import causal

GENERATION_ANNOTATION = "gpujobs.kubeflow.org/generation"

# How long a Preempting gang gets to checkpoint before its GPUs are
# reclaimed (phase 2 completes early once every worker pod is gone or
# terminal): the worker pod's own grace, so the queue waits as long as
# the kubelet lets the launcher wait for the save.
DEFAULT_PREEMPTION_GRACE_S = float(gpu_pods.JOB_GRACE_S)
# Queued / shrunk jobs poll the ledger on this cadence as a backstop for
# missed kick events — progress must never depend on a watch delta
# arriving.
DEFAULT_QUEUE_POLL_S = 1.0


class _SliceNameConflict(Exception):
    """A slice StatefulSet name is already owned by a different workload."""


class GPUJobReconciler(Reconciler):
    def __init__(self, client, *, cluster_domain: Optional[str] = None,
                 informers: Optional[dict] = None,
                 queue: Optional[jq.JobQueue] = None,
                 preemption_grace: Optional[float] = None,
                 queue_poll: Optional[float] = None):
        self.client = client
        # GVK -> Informer (make_controller wires them): pod and
        # StatefulSet reads come from the indexed caches.  Absent, reads
        # go to the client.
        self.informers: dict = informers or {}
        self.recorder = EventRecorder(client, "gpujob-controller")
        self.flights = shared_pool()
        self.cluster_domain = cluster_domain or config.env(
            "CLUSTER_DOMAIN", "cluster.local")
        # The admission ledger: make_controller passes an informer-fed
        # one; by default one that rebuilds from the client's lists for
        # every decision.
        self.queue = queue if queue is not None else jq.JobQueue(client)
        self.preemption_grace = (
            preemption_grace if preemption_grace is not None
            else config.env_float("GPUJOB_PREEMPTION_GRACE_SECONDS",
                                  DEFAULT_PREEMPTION_GRACE_S))
        self.queue_poll = (queue_poll if queue_poll is not None
                           else DEFAULT_QUEUE_POLL_S)

    # -- cache-backed reads ---------------------------------------------------

    def _cached_get(self, gvk, name: str, ns: str) -> Optional[Resource]:
        from kubeflow_tpu_torch.platform.runtime.informer import (
            cache_or_client_get,
        )

        return cache_or_client_get(self.informers.get(gvk), self.client,
                                   gvk, name, ns)

    def _pods_of(self, ns: str, name: str) -> List[Resource]:
        inf = self.informers.get(POD)
        if inf is not None:
            return inf.index_list("gpujob", f"{ns}/{name}")
        return self.client.list(
            POD, ns, label_selector={jobapi.LABEL_GPUJOB_NAME: name})

    def _stses_of(self, ns: str, name: str) -> List[Resource]:
        inf = self.informers.get(STATEFULSET)
        if inf is not None:
            return inf.index_list("gpujob", f"{ns}/{name}")
        return self.client.list(
            STATEFULSET, ns,
            label_selector={jobapi.LABEL_GPUJOB_NAME: name})

    # -- reconcile -----------------------------------------------------------

    def reconcile(self, req: Request) -> Optional[Result]:
        try:
            job = self.client.get(GPUJOB, req.name, req.namespace)
        except errors.NotFound:
            # ownerReference GC tears the gang down with the CR.
            return None

        try:
            jobapi.validate(job)
        except jobapi.ValidationError as e:
            status = {"conditions": [{
                "type": "Degraded", "status": "True",
                "reason": "InvalidSpec", "message": str(e),
            }]}
            if job.get("status") != status:
                self.recorder.event(job, "Warning", "InvalidGPUJob", str(e))
                patch_status_diff(self.client, GPUJOB, job, status)
            return None

        ns, name = meta(job)["namespace"], name_of(job)
        if jobapi.phase_of(job) in jobapi.TERMINAL_PHASES:
            # Terminal is sticky; a new run is a new CR.  But finish any
            # GPU-freeing teardown a transient fault interrupted after
            # the terminal status landed — otherwise the StatefulSets
            # would hold their GPU hosts forever.
            self.queue.forget(ns, name)
            if self._stses_of(ns, name):
                self._teardown_gang(ns, name, delete_pods=False)
            return None

        # Read-your-writes for the ledger: the clientless queue rebuilds
        # from lists; the informer-fed one just folds in THIS job's live
        # truth (our own status writes may outrun the watch stream).
        self.queue.ensure_fresh()
        self.queue.observe(job)
        spec = jobapi.gpu_slice(job)
        phase = jobapi.phase_of(job)

        if phase == jobapi.PHASE_PREEMPTING:
            return self._finish_preemption(job, spec)

        alloc = jobapi.allocated_slices(job)
        if alloc is None:
            # Not holding GPUs: admission is a queue decision.  Either
            # the whole gang is granted (possibly elastically, at
            # minSlices <= k <= slices) and we fall through to create it
            # THIS reconcile, or the job parks Queued with a structured
            # reason and polls the ledger.
            admitted = self._admission(job, spec)
            if isinstance(admitted, Result):
                return admitted
            job, alloc = admitted

        generation = jobapi.generation_of(job)

        # A higher-priority head waiter (or a shrunk node pool) claimed
        # this gang's GPUs: begin the two-phase checkpoint-then-evict.
        yielding = self.queue.should_yield(ns, name)
        if yielding is not None and phase in (
                jobapi.PHASE_RUNNING, jobapi.PHASE_PENDING,
                jobapi.PHASE_RESTARTING):
            return self._begin_preemption(job, spec, yielding)

        # Elastic grow-back: a shrunk Running gang resizes up when
        # capacity frees and nothing is waiting (waiters first).
        if phase == jobapi.PHASE_RUNNING and alloc < spec.num_slices:
            grow = self.queue.grow_target(ns, name)
            if grow is not None and grow > alloc:
                return self._begin_resize(job, alloc, grow)

        # Conflict-check every slice name BEFORE writing anything: a
        # partial gang would hold GPU hosts forever at the barrier.
        try:
            for s in range(alloc):
                self._check_sts_ownership(ns, name,
                                          self.slice_sts_name(name, s))
        except _SliceNameConflict as e:
            self.recorder.event(job, "Warning", "SliceNameConflict", str(e))
            status = {"conditions": [{
                "type": "Degraded", "status": "True",
                "reason": "SliceNameConflict", "message": str(e),
            }]}
            if job.get("status") != status:
                patch_status_diff(self.client, GPUJOB, job, status)
            return None

        pods = self._pods_of(ns, name)
        current, stale = self._split_by_generation(pods, generation)
        # Stragglers of a torn-down generation: GC opportunistically so
        # they never pollute the new gang's aggregation.  Worker names are
        # REUSED across generations (StatefulSet ordinals), so a lagging
        # informer cache can present a just-recreated current-generation
        # pod under a stale object: re-check the generation on a fresh GET
        # before the delete.
        for pod in stale:
            pod_name = name_of(pod)
            try:
                live = self.client.get(POD, pod_name, ns)
            except errors.NotFound:
                continue
            except errors.ApiError:
                continue  # retried on the requeue this reconcile gets
            live_gen = deep_get(live, "metadata", "labels",
                                jobapi.LABEL_GENERATION)
            if live_gen == str(generation):
                continue  # cache lag: the name already belongs to this gang
            try:
                self.client.delete(POD, pod_name, ns)
            except errors.ApiError:
                pass

        failed = [p for p in current
                  if deep_get(p, "status", "phase") == "Failed"]
        if failed:
            return self._handle_gang_failure(job, spec, generation, failed)

        self._reconcile_statefulsets(job, spec, generation, alloc)
        self._reconcile_headless_service(job)
        self._update_status(job, spec, generation, alloc, current)
        if alloc < spec.num_slices:
            # Shrunk gang: poll for grow-back capacity.
            return Result(requeue_after=max(self.queue_poll, 2.0))
        return None

    # -- admission / queueing -------------------------------------------------

    def _admission(self, job: Resource, spec: GpuSliceSpec):
        """Decide admission for a job holding no GPUs.  Returns a
        ``Result`` (parked Queued, polling) or ``(fresh_job, alloc)``
        after committing the claim — allocatedSlices is written BEFORE
        any StatefulSet exists, so a rebuilt ledger always accounts a
        gang that might be mid-creation and the fleet can never
        oversubscribe through a crash window."""
        ns, name = meta(job)["namespace"], name_of(job)
        decision = self.queue.decide(ns, name)
        if decision.action == "admit":
            # Commit-time confirm under the admission mutex: the decision
            # above may have run on a stale ledger; the confirm rebuilds
            # from LIVE lists and the commit lands inside the same
            # critical section.
            with self.queue.admission_mutex:
                decision = self.queue.confirm(self.client, ns, name)
                if decision.action == "admit":
                    queued_since = jobapi.queued_at(job)
                    if queued_since is not None:
                        metrics.gpujob_queue_wait_seconds.observe(
                            max(0.0, time.time() - queued_since))
                    # Causal journey: ONE admission_queue span per
                    # admission — queuedAt → granted for a parked job,
                    # zero-length inside this reconcile for a job that
                    # fit at once.
                    jctx = causal.from_object(job)
                    if jctx is not None:
                        admit_ts = time.time()
                        causal.record(
                            "admission_queue", trace_id=jctx.trace_id,
                            parent_span_id=jctx.span_id,
                            segment="admission_queue",
                            start_ts=(queued_since
                                      if queued_since is not None
                                      else admit_ts),
                            end_ts=admit_ts, object=name,
                            slices=decision.slices)
                    # Re-admissions (a preemption wrote status.generation
                    # before) start a NEW gang generation; a first-ever
                    # admission keeps generation == restarts.
                    prior_gen = deep_get(job, "status", "generation")
                    new_gen = (jobapi.generation_of(job) + 1
                               if prior_gen is not None
                               else jobapi.generation_of(job))
                    status = {
                        "phase": jobapi.PHASE_PENDING,
                        "restarts": jobapi.restarts_of(job),
                        "generation": new_gen,
                        "allocatedSlices": decision.slices,
                        "slices": self._slice_counts_named(
                            name, spec, {}, decision.slices),
                    }
                    patch_status_diff(self.client, GPUJOB, job, status)
                    fresh = self.client.get(GPUJOB, name, ns)
                    self.queue.observe(fresh)
        if decision.action == "admit":
            self.recorder.event(
                job, "Normal", "Admitted",
                f"granted {decision.slices}/{spec.num_slices} slice(s) "
                f"(generation {new_gen})"
                + (" — elastic" if decision.slices < spec.num_slices
                   else ""))
            return fresh, decision.slices
        if decision.action != "wait":
            # "admitted": the live rebuild found allocatedSlices already
            # set — this reconcile read a stale job.  "unknown": the
            # entry vanished mid-decision (delete race).  Neither is a
            # reason to park a possibly-running gang under a Queued
            # status; re-read and retry shortly.
            if decision.action == "admitted":
                fresh = self.client.get(GPUJOB, name, ns)
                self.queue.observe(fresh)
                alloc = jobapi.allocated_slices(fresh)
                if alloc is not None:
                    return fresh, alloc
            return Result(requeue_after=min(self.queue_poll, 0.25))
        # Park Queued with the structured reason.  The Unschedulable
        # condition carries the human-readable detail; status.reason is
        # the REASON printer column.
        queued_since = jobapi.queued_at(job)
        status = {
            "phase": jobapi.PHASE_QUEUED,
            "restarts": jobapi.restarts_of(job),
            "reason": decision.reason,
            "queuedAt": (queued_since if queued_since is not None
                         else round(time.time(), 3)),
            "conditions": [{
                "type": "Unschedulable", "status": "True",
                "reason": decision.reason, "message": decision.message,
            }],
        }
        prior_gen = deep_get(job, "status", "generation")
        if prior_gen is not None:
            status["generation"] = int(prior_gen)
        if deep_get(job, "status", "reason") != decision.reason:
            self.recorder.event(
                job, "Normal", "Queued",
                f"{decision.reason}: {decision.message}")
        if job.get("status") != status:
            patch_status_diff(self.client, GPUJOB, job, status)
            self.queue.observe(self.client.get(GPUJOB, name, ns))
        return Result(requeue_after=self.queue_poll)

    # -- preemption (two-phase checkpoint-then-evict) -------------------------

    def _delete_statefulsets(self, ns: str, name: str) -> None:
        """The SIGTERM: tear down the StatefulSets only — worker pods ride
        out their grace period checkpointing."""
        for sts in self._stses_of(ns, name):
            try:
                self.client.delete(STATEFULSET, name_of(sts), ns)
            except errors.NotFound:
                pass

    def _begin_preemption(self, job: Resource, spec: GpuSliceSpec,
                          yielding) -> Optional[Result]:
        """Phase 1: commit the Preempting intent, then tear down the
        slice StatefulSets — the kubelet delivers SIGTERM and the pod's
        grace to every worker, and ``train/run.py``'s handler saves a
        checkpoint.  The GPUs stay CHARGED to this job (allocatedSlices
        kept) until phase 2 confirms the drain, so the preemptor can never
        be half-admitted into capacity the victim still holds."""
        by, why = yielding
        ns, name = meta(job)["namespace"], name_of(job)
        status = dict(job.get("status") or {})
        status.update({
            "phase": jobapi.PHASE_PREEMPTING,
            "reason": (jq.REASON_PREEMPTED if why == "priority"
                       else "CapacityShrunk"),
            "preemption": {"by": by, "reason": why,
                           "at": round(time.time(), 3)},
            "conditions": [{
                "type": "Preempted", "status": "True",
                "reason": "PreemptedBy" if why == "priority"
                          else "CapacityShrunk",
                "message": (f"checkpoint-then-evict for {by}" if by
                            else "node pool shrank under the gang"),
            }],
        })
        patch_status_diff(self.client, GPUJOB, job, status)
        metrics.gpujob_preemptions_total.labels(reason=why).inc()
        self.recorder.event(
            job, "Warning", "Preempting",
            (f"higher-priority job {by} claims this gang's GPUs; "
             if by else "node pool shrank; ")
            + "checkpointing then releasing "
            f"{jobapi.allocated_slices(job)} slice(s)")
        self.queue.observe(self.client.get(GPUJOB, name, ns))
        self._delete_statefulsets(ns, name)
        return Result(requeue_after=min(self.queue_poll, 0.25))

    def _begin_resize(self, job: Resource, alloc: int,
                      target: int) -> Optional[Result]:
        """Elastic grow-back = a voluntary self-preemption: same graceful
        drain (checkpoint over SIGTERM), but phase 2 re-admits at the
        recomputed width instead of parking Queued.  Never consumes
        backoffLimit — a resize is not a failure."""
        ns, name = meta(job)["namespace"], name_of(job)
        status = dict(job.get("status") or {})
        status.update({
            "phase": jobapi.PHASE_PREEMPTING,
            "reason": jq.REASON_RESIZING,
            "resize": {"to": target, "at": round(time.time(), 3)},
            "conditions": [{
                "type": "Preempted", "status": "True",
                "reason": jq.REASON_RESIZING,
                "message": f"growing from {alloc} to {target} slice(s); "
                           "checkpointing for the restart",
            }],
        })
        patch_status_diff(self.client, GPUJOB, job, status)
        self.recorder.event(
            job, "Normal", "Resizing",
            f"capacity freed: growing from {alloc} to {target} slice(s) "
            "via checkpoint-restart")
        self.queue.observe(self.client.get(GPUJOB, name, ns))
        self._delete_statefulsets(ns, name)
        return Result(requeue_after=min(self.queue_poll, 0.25))

    def _finish_preemption(self, job: Resource,
                           spec: GpuSliceSpec) -> Optional[Result]:
        """Phase 2: wait for the checkpoint drain — every current-
        generation worker pod gone/terminal, or the grace deadline — then
        reclaim the GPUs.  A preemption parks the job back in the queue
        (it re-admits elastically when capacity allows); a resize
        re-admits immediately at the recomputed width."""
        ns, name = meta(job)["namespace"], name_of(job)
        generation = jobapi.generation_of(job)
        intent = (deep_get(job, "status", "resize")
                  or deep_get(job, "status", "preemption") or {})
        started = float(intent.get("at") or 0.0)
        deadline = started + self.preemption_grace
        pods = self._pods_of(ns, name)
        current, _stale = self._split_by_generation(pods, generation)
        active = [p for p in current
                  if deep_get(p, "status", "phase")
                  not in ("Succeeded", "Failed")]
        now = time.time()
        if active and now < deadline:
            return Result(requeue_after=min(
                max(deadline - now, 0.05), 0.25))
        # Drain confirmed (or deadline passed): clear the slate.
        self._teardown_gang(ns, name, delete_pods=True)
        resize = deep_get(job, "status", "resize")
        if resize is not None:
            # Recompute against the CURRENT ledger — capacity may have
            # moved (or a waiter arrived) during the drain.  Never below
            # the held width, never above the spec.
            alloc = jobapi.allocated_slices(job) or 1
            target = self.queue.grow_target(ns, name)
            new_alloc = min(max(target if target is not None else alloc,
                                alloc), spec.num_slices)
            status = {
                "phase": jobapi.PHASE_PENDING,
                "restarts": jobapi.restarts_of(job),
                "generation": generation + 1,
                "allocatedSlices": new_alloc,
                "slices": self._slice_counts_named(
                    name, spec, {}, new_alloc),
            }
            patch_status_diff(self.client, GPUJOB, job, status)
        else:
            status = {
                "phase": jobapi.PHASE_QUEUED,
                "restarts": jobapi.restarts_of(job),
                "generation": generation,
                "reason": jq.REASON_PREEMPTED,
                "queuedAt": round(time.time(), 3),
                "conditions": [{
                    "type": "Unschedulable", "status": "True",
                    "reason": jq.REASON_PREEMPTED,
                    "message": "gang evicted after checkpoint; waiting "
                               "to resume (elastically at minSlices "
                               "when capacity allows)",
                }],
            }
            patch_status_diff(self.client, GPUJOB, job, status)
            self.recorder.event(
                job, "Normal", "PreemptionComplete",
                "checkpoint drain finished; GPUs released, job "
                "re-queued for elastic resume")
        self.queue.observe(self.client.get(GPUJOB, name, ns))
        return Result(requeue_after=self.queue_poll)

    # -- gang restart ---------------------------------------------------------

    def _handle_gang_failure(self, job: Resource, spec: GpuSliceSpec,
                             generation: int,
                             failed: List[Resource]) -> Optional[Result]:
        """All-or-nothing: one failed worker condemns the whole generation.
        Either recreate the gang under generation+1 (it resumes from the
        same checkpoint directory) or, with the backoff exhausted /
        restartPolicy Never, go terminally Failed."""
        ns, name = meta(job)["namespace"], name_of(job)
        who = ", ".join(sorted(name_of(p) for p in failed))
        restarts = jobapi.restarts_of(job)
        alloc = jobapi.allocated_slices(job) or spec.num_slices
        exhausted = (jobapi.restart_policy(job) == "Never"
                     or restarts >= jobapi.backoff_limit(job))
        if exhausted:
            self._teardown_gang(ns, name, delete_pods=False)
            self.recorder.event(
                job, "Warning", "GangFailed",
                f"worker pod(s) {who} failed; restartPolicy="
                f"{jobapi.restart_policy(job)} backoffLimit="
                f"{jobapi.backoff_limit(job)} exhausted after "
                f"{restarts} restart(s)")
            status = {
                "phase": jobapi.PHASE_FAILED,
                "restarts": restarts,
                "slices": self._slice_counts_named(name, spec, {}, alloc),
                "conditions": [{
                    "type": "Failed", "status": "True",
                    "reason": "BackoffLimitExceeded",
                    "message": f"worker pod(s) {who} failed",
                }],
            }
            if deep_get(job, "status", "generation") is not None:
                status["generation"] = generation
            patch_status_diff(self.client, GPUJOB, job, status)
            # Terminal Failed frees the GPUs in the ledger — THIS is why
            # a crashlooping high-priority job can never starve the
            # queue: backoffLimit turns it terminal and the next waiter
            # admits into the freed capacity.
            self.queue.observe(self.client.get(GPUJOB, name, ns))
            return None
        self.recorder.event(
            job, "Warning", "GangRestart",
            f"worker pod(s) {who} failed; tearing down all "
            f"{alloc} slice(s) and restarting the gang "
            f"(generation {generation + 1})")
        status = {
            "phase": jobapi.PHASE_RESTARTING,
            "restarts": restarts + 1,
            "slices": self._slice_counts_named(name, spec, {}, alloc),
        }
        if deep_get(job, "status", "generation") is not None:
            # Failure restarts bump BOTH counters; resizes/re-admissions
            # bump only the generation.  The gang KEEPS its allocation
            # across a restart — a crash is not a queue event.
            status["generation"] = generation + 1
            status["allocatedSlices"] = alloc
        # Persist the bumped counter BEFORE tearing anything down: the
        # teardown deletes the Failed pods (the evidence), so a fault
        # after it would otherwise replay this restart at the SAME
        # generation, unaccounted against backoffLimit.
        patch_status_diff(self.client, GPUJOB, job, status)
        metrics.gpujob_restarts_total.inc()
        self._teardown_gang(ns, name, delete_pods=True)
        return None

    def _teardown_gang(self, ns: str, name: str, *,
                       delete_pods: bool) -> None:
        """Delete every slice StatefulSet (and, on a restart, every worker
        pod so the new generation starts clean; a terminally-Failed job
        keeps its pods for post-mortem logs, like a finished Job's)."""
        for sts in self._stses_of(ns, name):
            try:
                # Orphan on the keep-pods path: the default Background
                # propagation would cascade to the StatefulSet-owned
                # worker pods on a real cluster.
                self.client.delete(
                    STATEFULSET, name_of(sts), ns,
                    propagation="Background" if delete_pods else "Orphan")
            except errors.NotFound:
                pass
        if delete_pods:
            for pod in self._pods_of(ns, name):
                try:
                    self.client.delete(POD, name_of(pod), ns)
                except errors.ApiError:
                    pass

    # -- statefulsets ---------------------------------------------------------

    slice_sts_name = staticmethod(gpu_pods.slice_sts_name)

    def generate_statefulset(self, job: Resource, slice_idx: int = 0,
                             generation: int = 0,
                             num_slices: Optional[int] = None) -> Resource:
        """``num_slices`` is the GRANTED gang width (elastic admission may
        run fewer slices than spec.gpu.slices); default = the full spec."""
        ns, name = meta(job)["namespace"], name_of(job)
        spec = jobapi.gpu_slice(job)
        if num_slices is None:
            num_slices = spec.num_slices
        sts_name = self.slice_sts_name(name, slice_idx)

        pod_spec = thaw(
            deep_get(job, "spec", "template", "spec", default={}))
        gpu_pods.job_worker_container(
            pod_spec, ns=ns, name=name, spec=spec, slice_idx=slice_idx,
            num_slices=num_slices, cluster_domain=self.cluster_domain,
            checkpoint_dir=jobapi.checkpoint_dir(job))
        # The pods run on the nodes of the pool the queue charges them
        # to: those of the product with as many GPUs as a pod takes.
        pod_spec["nodeSelector"].update(spec.pool_selectors())
        # The kubelet must not kill the launcher while it still waits for
        # its processes' checkpoint (a template may ask for longer).
        pod_spec["terminationGracePeriodSeconds"] = max(
            int(pod_spec.get("terminationGracePeriodSeconds") or 0),
            gpu_pods.JOB_GRACE_S)

        labels = {
            "statefulset": sts_name,
            jobapi.LABEL_GPUJOB_NAME: name,
            jobapi.LABEL_GPUJOB_WORKER: "true",
            jobapi.LABEL_GENERATION: str(generation),
        }
        sts = {
            "apiVersion": "apps/v1",
            "kind": "StatefulSet",
            "metadata": {
                "name": sts_name,
                "namespace": ns,
                "labels": dict(labels),
                "annotations": {GENERATION_ANNOTATION: str(generation)},
            },
            "spec": {
                "replicas": spec.num_hosts,
                "serviceName": f"{name}-workers",
                "podManagementPolicy": "Parallel",  # the whole gang at once
                "selector": {"matchLabels": {"statefulset": sts_name}},
                "template": {
                    "metadata": {"labels": dict(labels)},
                    "spec": pod_spec,
                },
            },
        }
        set_owner(sts, job)
        return sts

    def _check_sts_ownership(self, ns: str, job_name: str,
                             sts_name: str) -> None:
        current = self._cached_get(STATEFULSET, sts_name, ns)
        if current is None:
            return
        owner = deep_get(current, "metadata", "labels",
                         jobapi.LABEL_GPUJOB_NAME)
        if owner != job_name:
            raise _SliceNameConflict(
                f"StatefulSet {ns}/{sts_name} belongs to "
                f"{'GPUJob ' + owner if owner else 'another workload'}, "
                f"not GPUJob {job_name}; rename one of them")

    def _reconcile_statefulsets(self, job: Resource, spec: GpuSliceSpec,
                                generation: int, alloc: int) -> None:
        """Gang-create: every missing slice StatefulSet of the CURRENT
        generation, concurrently, at the GRANTED width ``alloc``.  A
        leftover from an older generation is deleted and recreated."""
        created = self.flights.run([
            (lambda s=s: self._reconcile_one_statefulset(
                job, s, generation, alloc))
            for s in range(alloc)
        ])
        if any(created):
            self.recorder.event(
                job, "Normal", "GangCreated",
                f"created {alloc} slice StatefulSet(s) x "
                f"{spec.num_hosts} worker(s) (generation {generation})")

    def _reconcile_one_statefulset(self, job: Resource, slice_idx: int,
                                   generation: int, alloc: int) -> bool:
        """Returns True when this pass created the slice's StatefulSet."""
        desired = self.generate_statefulset(job, slice_idx, generation,
                                            num_slices=alloc)
        ns, name = meta(desired)["namespace"], name_of(desired)
        current = self._cached_get(STATEFULSET, name, ns)
        if current is not None:
            live_gen = deep_get(current, "metadata", "annotations",
                                GENERATION_ANNOTATION)
            if live_gen == str(generation):
                return False
            # Older generation still standing (teardown raced a transient
            # delete failure): clear it now, recreate below.
            try:
                self.client.delete(STATEFULSET, name, ns)
            except errors.NotFound:
                pass
        try:
            apply.create(self.client, desired)
            return True
        except errors.AlreadyExists:
            # A raced 409 whose create may never have landed: present
            # means someone created it; absent means the create really
            # failed, so raise for a backoff requeue.
            try:
                self.client.get(STATEFULSET, name, ns)
            except errors.NotFound:
                raise
            return False

    # -- coordinator service --------------------------------------------------

    def generate_headless_service(self, job: Resource) -> Resource:
        ns, name = meta(job)["namespace"], name_of(job)
        svc = {
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {"name": f"{name}-workers", "namespace": ns,
                         "labels": {jobapi.LABEL_GPUJOB_NAME: name}},
            "spec": {
                "clusterIP": "None",
                # Worker DNS must resolve BEFORE readiness: the
                # rendezvous happens during bring-up.
                "publishNotReadyAddresses": True,
                # One governing service spans every slice's StatefulSet —
                # cross-slice coordinator DNS resolves through it.
                "selector": {jobapi.LABEL_GPUJOB_NAME: name},
                "ports": [{"name": "coordinator",
                           "port": envspec.DEFAULT_COORDINATOR_PORT,
                           "protocol": "TCP"}],
            },
        }
        set_owner(svc, job)
        return svc

    def _reconcile_headless_service(self, job: Resource) -> None:
        desired = self.generate_headless_service(job)
        ns, name = meta(desired)["namespace"], name_of(desired)
        if self._cached_get(SERVICE, name, ns) is not None:
            return  # spec is generation-invariant; nothing to update
        try:
            apply.create(self.client, desired)
        except errors.AlreadyExists:
            pass

    # -- status ---------------------------------------------------------------

    @staticmethod
    def _split_by_generation(pods: List[Resource], generation: int):
        current, stale = [], []
        for pod in pods:
            gen = deep_get(pod, "metadata", "labels",
                           jobapi.LABEL_GENERATION)
            (current if gen == str(generation) else stale).append(pod)
        return current, stale

    def _update_status(self, job: Resource, spec: GpuSliceSpec,
                       generation: int, alloc: int,
                       current: List[Resource]) -> None:
        ns, name = meta(job)["namespace"], name_of(job)
        expected = [
            f"{self.slice_sts_name(name, s)}-{i}"
            for s in range(alloc)
            for i in range(spec.num_hosts)
        ]
        by_name = {name_of(p): p for p in current}
        phases = {n: deep_get(by_name[n], "status", "phase")
                  for n in expected if n in by_name}
        succeeded = sum(1 for p in phases.values() if p == "Succeeded")
        ready = sum(1 for n in expected
                    if n in by_name and pod_ready(by_name[n]))

        if expected and succeeded == len(expected):
            phase = jobapi.PHASE_SUCCEEDED
        elif expected and ready + succeeded == len(expected):
            # Workers finish at slightly different times: a pod that
            # already exited 0 is no longer Ready but keeps counting
            # toward Running.
            phase = jobapi.PHASE_RUNNING
        elif jobapi.restarts_of(job) > 0:
            phase = jobapi.PHASE_RESTARTING
        else:
            phase = jobapi.PHASE_PENDING

        status: dict = {
            "phase": phase,
            "restarts": jobapi.restarts_of(job),
            "slices": self._slice_counts_named(name, spec, by_name, alloc),
        }
        if deep_get(job, "status", "generation") is not None:
            status["generation"] = generation
            status["allocatedSlices"] = alloc
        if job.get("status") != status:
            patch_status_diff(self.client, GPUJOB, job, status)
        if phase == jobapi.PHASE_SUCCEEDED:
            # Terminal phase committed; NOW free the GPUs (keep the
            # Succeeded pods for logs).  If this teardown faults, the
            # terminal-sticky branch in reconcile() finishes the sweep.
            self._teardown_gang(ns, name, delete_pods=False)
            self.queue.observe(self.client.get(GPUJOB, name, ns))
            self.recorder.event(
                job, "Normal", "JobSucceeded",
                f"all {len(expected)} worker(s) across {alloc} "
                f"slice(s) succeeded after "
                f"{jobapi.restarts_of(job)} restart(s)")

    def _slice_counts_named(self, name: str, spec: GpuSliceSpec,
                            by_name: Dict[str, Resource],
                            alloc: Optional[int] = None) -> List[dict]:
        out = []
        for s in range(alloc if alloc is not None else spec.num_slices):
            sts = self.slice_sts_name(name, s)
            ready = sum(
                1 for i in range(spec.num_hosts)
                if f"{sts}-{i}" in by_name
                and pod_ready(by_name[f"{sts}-{i}"]))
            out.append({"slice": s, "ready": ready,
                        "total": spec.num_hosts})
        return out


# -- watch mappers / indexers -------------------------------------------------


def pods_to_gpujob_requests(obj: Resource) -> List[Request]:
    """Watch mapper: pod events → owning GPUJob (by gpujob-name label)."""
    labels = deep_get(obj, "metadata", "labels", default={}) or {}
    job = labels.get(jobapi.LABEL_GPUJOB_NAME)
    if not job:
        return []
    return [Request(deep_get(obj, "metadata", "namespace", default=""), job)]


def _job_label_index(obj: Resource) -> List[str]:
    labels = deep_get(obj, "metadata", "labels", default={}) or {}
    job = labels.get(jobapi.LABEL_GPUJOB_NAME)
    ns = deep_get(obj, "metadata", "namespace", default="")
    return [f"{ns}/{job}"] if job else []


def make_controller(client, **kwargs):
    """The GPUJob controller: the reconciler's informers on GPUJobs, pods,
    StatefulSets and Services, and the queue's own on GPUJobs, quotas,
    nodes and InferenceServices feeding its ledger; every GPUJob delta
    wakes the keys the new state lets act (``kick_requests``).  A quota
    or node change only updates the ledger: a Queued job's poll
    (``requeue_after``) admits it.  The collector and the debug registry
    are hooked for the controller's life."""
    from kubeflow_tpu_torch.platform.k8s.types import (
        INFERENCESERVICE,
        NODE,
        RESOURCEQUOTA,
    )
    from kubeflow_tpu_torch.platform.runtime import Controller
    from kubeflow_tpu_torch.platform.runtime.informer import Informer

    # Sharded HA: the coordinator filters these informers (a worker pod
    # is cached iff its job's key is owned) and the FencedClient proves
    # every gang write against the key's shard lease.
    shards = kwargs.pop("shards", None)
    informers = {
        GPUJOB: Informer(client, GPUJOB),
        POD: Informer(client, POD, indexers={"gpujob": _job_label_index}),
        STATEFULSET: Informer(client, STATEFULSET,
                              indexers={"gpujob": _job_label_index}),
        SERVICE: Informer(client, SERVICE),
    }
    # The ledger's feed stays out of the controller's informer dict, and
    # so unsharded: the queue is one priority-then-FIFO order over every
    # job, quota, node and InferenceService (serving's GPUs are declared
    # charges on the same quota), and every replica computes the same
    # schedule to act on the keys it owns.  Its informers live with the
    # controller's on_start and on_stop.
    queue = jq.JobQueue()
    queue.informer_backed = True
    queue_informers = {
        GPUJOB: Informer(client, GPUJOB),
        RESOURCEQUOTA: Informer(client, RESOURCEQUOTA),
        NODE: Informer(client, NODE),
        INFERENCESERVICE: Informer(client, INFERENCESERVICE),
    }

    def _on_job_delta(etype, obj):
        if etype == "DELETED":
            queue.forget(deep_get(obj, "metadata", "namespace",
                                  default="") or "",
                         name_of(obj))
        else:
            queue.observe(obj)

    queue_informers[GPUJOB].add_handler(_on_job_delta)

    def _on_service_delta(etype, obj):
        ns = deep_get(obj, "metadata", "namespace", default="") or ""
        if etype == "DELETED":
            queue.forget_service(ns, name_of(obj))
        else:
            queue.observe_service(obj)

    queue_informers[INFERENCESERVICE].add_handler(_on_service_delta)
    queue_informers[RESOURCEQUOTA].add_handler(
        lambda _e, _o: queue.set_quotas(
            queue_informers[RESOURCEQUOTA].list()))
    queue_informers[NODE].add_handler(
        lambda _e, _o: queue.set_nodes(queue_informers[NODE].list()))

    reconciler = GPUJobReconciler(client, informers=informers,
                                  queue=queue, **kwargs)

    def on_start():
        metrics.register_gpujob_collector(client)
        jq.register_debug_queue(queue)
        for informer in queue_informers.values():
            informer.start()
        for informer in queue_informers.values():
            # Best effort: an unsynced ledger admits permissively until
            # its feed lands, never a failed start.
            informer.wait_for_sync(30.0)

    def on_stop():
        metrics.register_gpujob_collector(None)
        jq.register_debug_queue(None)
        for informer in queue_informers.values():
            informer.stop()

    ctrl = Controller(
        "gpujob-controller",
        reconciler,
        primary=GPUJOB,
        owns=[STATEFULSET, SERVICE],
        watches=[(POD, pods_to_gpujob_requests)],
        informers=informers,
        on_start=on_start,
        on_stop=on_stop,
        resync_period=300.0,
        shards=shards,
    )

    def _kick(_etype, obj):
        # The capacity-change fan-out: a job delta wakes the head waiters
        # (admission), the preemption targets (yield) and the shrunk
        # gangs (grow-back), of this replica's owned shards.  The Queued
        # job's poll is the guarantee; this is the latency path.
        for ns, name in queue.kick_requests():
            req = Request(ns, name)
            if ctrl._owns(req):
                ctrl.queue.add(req)

    queue_informers[GPUJOB].add_handler(_kick)
    return ctrl
