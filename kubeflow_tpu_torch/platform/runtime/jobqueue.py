"""JobQueue: the cluster-level gang admission ledger for GPUJobs.

The port's copy of ``kubeflow_tpu/platform/runtime/jobqueue.py`` over
GPU pools and the ``nvidia.com/gpu`` quota.  Admission is a *queue
decision*: every non-terminal GPUJob is an entry in one
priority-then-FIFO ledger of

* **pool capacity** — free slice slots per ``(product, GPUs a node)``
  pool, from the GPU node inventory (``gpu/topology.py``
  ``gpu_pool_hosts``; ``hosts // hosts_per_slice``).  A slice's pods
  select exactly these nodes (``GpuSliceSpec.pool_selectors``: the
  product and ``nvidia.com/gpu.count`` labels), one pod a node, as a TPU
  slice selects the nodes of its topology.  A pool with NO matching
  nodes is *unlimited* — a cluster that doesn't feed node objects must
  not deadlock every job;
* **profile quota** — free ``nvidia.com/gpu`` per namespace from the
  ResourceQuota, charged with the *declared* GPUs of admitted gangs
  (pod-level enforcement stays with the apiserver's quota plugin),

and a decision function over it.  Everything here is REBUILT from watch
state (job statuses + quotas + nodes + InferenceServices), never from
in-process bookkeeping alone — so the queue survives controller
restarts, and a victim preempts *itself* when ``should_yield`` says a
higher-priority waiter is entitled to its GPUs.

Ordering contract (the reference's):

* rank = (priority DESC, creationTimestamp ASC, name ASC) — priority then
  FIFO.  ISO-8601 creationTimestamps compare lexicographically.
* Head-of-line: a job admits only if every better-ranked waiter does NOT
  currently fit at its own ``minSlices`` — so the queue drains in rank
  order as capacity frees (a small job never jumps an admissible head; a
  crashlooper at the head can't starve the queue because ``backoffLimit``
  turns it terminal, which frees its entry).
* Preemption rights belong to the HEAD waiter only: victims are admitted
  gangs of strictly lower priority, picked lowest-priority/youngest-first,
  minimally — never a gang of equal or higher priority.
* Elastic: admission grants ``k = min(spec.slices, free)`` down to
  ``minSlices``; a shrunk running gang grows back only when the waiting
  queue is empty (waiters first).

Decision cost: admitting the head is O(1) against the incrementally
maintained sorted index + per-pool/per-namespace tallies.
"""
from __future__ import annotations

import bisect
import dataclasses
import threading
import time
from typing import Dict, List, Optional, Tuple

from kubeflow_tpu_torch.platform.gpu import topology
from kubeflow_tpu_torch.platform.k8s import quota as quota_mod
from kubeflow_tpu_torch.platform.k8s.types import (
    Resource,
    deep_get,
    parse_timestamp,
)

# Structured Unschedulable reasons (status.reason + the REASON printer
# column + the Unschedulable condition's reason).
REASON_QUOTA = "InsufficientQuota"
REASON_CAPACITY = "InsufficientCapacity"
REASON_QUEUED_BEHIND = "QueuedBehind"
REASON_AWAITING_PREEMPTION = "AwaitingPreemption"
REASON_PREEMPTED = "Preempted"
REASON_RESIZING = "Resizing"

_GPU_QUOTA_KEY = quota_mod.GPU_REQUESTS


@dataclasses.dataclass(frozen=True)
class GangDemand:
    """One GPUJob's parsed resource demand, as the ledger accounts it."""

    namespace: str
    name: str
    priority: int
    slices: int
    min_slices: int
    gpus_per_slice: int
    hosts_per_slice: int
    gpus_per_host: int      # GPUs a pod takes: the GPUs of its pool's nodes
    accelerator: str        # short name ("h100-80gb")
    product: str            # the nodes' product label
    created: str            # ISO creationTimestamp (lexicographic == temporal)

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    @property
    def pool(self) -> Tuple[str, int]:
        return (self.product, self.gpus_per_host)

    @property
    def pool_name(self) -> str:
        return f"{self.accelerator}/{self.gpus_per_host}"

    @property
    def rank(self) -> Tuple:
        return (-self.priority, self.created, self.namespace, self.name)


@dataclasses.dataclass
class Decision:
    """Outcome of one admission decision for one job."""

    action: str                       # admit | wait | admitted | unknown
    slices: int = 0                   # granted gang width on admit
    reason: str = ""                  # structured Unschedulable reason
    message: str = ""


class _Entry:
    __slots__ = ("demand", "alloc", "queued_at")

    def __init__(self, demand: GangDemand, alloc: Optional[int],
                 queued_at: Optional[float] = None):
        self.demand = demand
        self.alloc = alloc            # None = waiting; int = admitted slices
        # Waiting entries only: status.queuedAt (the creationTimestamp
        # until the park commits), read by the oldest-wait gauge.
        self.queued_at = queued_at


def demand_of(job: Resource) -> Optional[GangDemand]:
    """Parse a GPUJob into its ledger demand; None for stored-invalid
    specs (their own reconcile parks them Degraded — they hold nothing
    and wait for nothing)."""
    from kubeflow_tpu_torch.platform.apis import gpujob as jobapi

    spec = jobapi.gpu_slice_or_none(job)
    if spec is None:
        return None
    try:
        priority = jobapi.priority_of(job)
        min_slices = jobapi.min_slices_of(job)
    except (TypeError, ValueError):
        return None
    if priority < 1 or not (1 <= min_slices <= spec.num_slices):
        return None
    return GangDemand(
        namespace=deep_get(job, "metadata", "namespace", default="") or "",
        name=deep_get(job, "metadata", "name", default="") or "",
        priority=priority,
        slices=spec.num_slices,
        min_slices=min_slices,
        gpus_per_slice=spec.gpus,
        hosts_per_slice=spec.num_hosts,
        gpus_per_host=spec.pool[1],
        accelerator=spec.accelerator.name,
        product=spec.pool[0],
        created=deep_get(job, "metadata", "creationTimestamp",
                         default="") or "",
    )


class JobQueue:
    """The admission ledger.  Thread-safe; fed incrementally from
    informer deltas (``observe``/``forget``, ``set_nodes``/
    ``set_quotas``, ``observe_service``/``forget_service``: the path
    ``controllers/gpujob.py`` ``make_controller`` wires) or rebuilt on
    demand from a client (``ensure_fresh``, the bare reconciler's path).
    All decisions are pure functions of the current state."""

    def __init__(self, client=None, *, now=time.time):
        self._client = client
        self._now = now
        self._lock = threading.RLock()
        self._entries: Dict[str, _Entry] = {}
        self._waiting: List[Tuple[Tuple, str]] = []    # sorted (rank, key)
        self._pool_alloc: Dict[Tuple[str, int], int] = {}
        self._ns_gpus: Dict[str, float] = {}
        # Incremental tallies — every per-event read (gauges) must stay
        # O(1)-ish, never a rescan of the queue.
        self._waiting_by_ns: Dict[str, int] = {}
        self._alloc_total = 0
        self._shrunk: set = set()      # admitted keys with alloc < slices
        # (product, GPUs a node) -> GPU host count, from nodes.
        self._pool_hosts: Dict[Tuple[str, int], int] = {}
        self._ns_quota: Dict[str, float] = {}          # ns -> hard GPUs
        # ns -> stored nvidia.com/gpu status.used — GPUs held by LIVE
        # pods of EVERY consumer (notebooks, serving, gang workers), kept
        # by the apiserver's quota bookkeeping.  The effective commitment
        # is max(declared gang GPUs, stored used): ignoring stored would
        # over-admit gangs into GPUs a notebook already holds, and the
        # apiserver plugin would then 403 PART of the gang's pods — the
        # half-scheduled-gang deadlock this queue exists to prevent.
        self._ns_used: Dict[str, float] = {}
        # InferenceService replica GPUs, DECLARED from watch state
        # (apis/inferenceservice.gpus_of): a model server mid-scale-up
        # holds its GPUs in intent before its pods land.
        self._svc_gpus: Dict[str, float] = {}        # "ns/name" -> GPUs
        self._svc_ns_gpus: Dict[str, float] = {}     # ns -> tally
        self._epoch = 0
        self._targets_cache: Tuple[int, Dict[str, Tuple[str, str]]] = (-1, {})
        # (epoch, (rank, key) of the best-ranked currently-admissible
        # waiter, or None): the head-of-line check in decide() reads
        # this instead of rescanning the prefix per call.
        self._first_adm_cache: Tuple[int, Optional[Tuple]] = (-1, None)
        # Fed by informer deltas: ensure_fresh rebuilds nothing.
        self.informer_backed = False
        # Serializes commit-time admissions within one controller: the
        # confirm() live rebuild + the status commit happen atomically so
        # two workers can never admit two gangs into one free slot off
        # the same stale snapshot (see GPUJobReconciler._admission).
        self.admission_mutex = threading.Lock()

    # -- feeding -------------------------------------------------------------

    def ensure_fresh(self) -> None:
        """Rebuild the whole ledger from live lists of the client this
        queue was built on.  An informer-backed queue (or one without a
        client) skips it: its deltas keep the state current."""
        if self.informer_backed or self._client is None:
            return
        self.rebuild(self._client)

    def rebuild(self, client) -> None:
        """Rebuild the ledger from live lists over ``client``."""
        from kubeflow_tpu_torch.platform.k8s.types import (
            GPUJOB,
            NODE,
            RESOURCEQUOTA,
        )

        self.refresh(client.list(GPUJOB, None),
                     client.list(RESOURCEQUOTA, None),
                     client.list(NODE, None),
                     self._list_services(client))

    def confirm(self, client, namespace: str, name: str) -> Decision:
        """Commit-time double check for an ``admit`` verdict: rebuild the
        ledger from LIVE lists (read-your-writes) and decide again.
        Callers hold ``admission_mutex`` across this and the status
        commit."""
        self.rebuild(client)
        return self.decide(namespace, name)

    @staticmethod
    def _list_services(client) -> list:
        """Live InferenceService list for ledger rebuilds; empty on a
        cluster without the CRD (the serving charge simply stays zero)."""
        from kubeflow_tpu_torch.platform.k8s import errors as k8s_errors
        from kubeflow_tpu_torch.platform.k8s.types import INFERENCESERVICE

        try:
            return client.list(INFERENCESERVICE, None)
        except k8s_errors.ApiError:
            return []

    def refresh(self, jobs, quotas, nodes, services=None) -> None:
        with self._lock:
            self._entries.clear()
            self._waiting = []
            self._pool_alloc.clear()
            self._ns_gpus.clear()
            self._waiting_by_ns.clear()
            self._alloc_total = 0
            self._shrunk.clear()
            self._svc_gpus.clear()
            self._svc_ns_gpus.clear()
            self.set_nodes(nodes)
            self.set_quotas(quotas)
            for svc in services or ():
                self._observe_service_locked(svc)
            for job in jobs:
                self._observe_locked(job)
            self._bump()

    def set_nodes(self, nodes) -> None:
        with self._lock:
            self._pool_hosts = topology.gpu_pool_hosts(nodes)
            self._bump()

    def set_quotas(self, quotas) -> None:
        with self._lock:
            self._ns_quota = {}
            self._ns_used = {}
            for q in quotas or ():
                ns = deep_get(q, "metadata", "namespace", default="") or ""
                hard = deep_get(q, "spec", "hard", default={}) or {}
                used_map = deep_get(q, "status", "used", default={}) or {}
                for key, val in hard.items():
                    if quota_mod.usage_key(key) != _GPU_QUOTA_KEY:
                        continue
                    try:
                        limit = quota_mod.parse_quantity(val)
                    except (ValueError, TypeError):
                        continue
                    cur = self._ns_quota.get(ns)
                    self._ns_quota[ns] = (limit if cur is None
                                          else min(cur, limit))
                    try:
                        used = quota_mod.parse_quantity(
                            used_map.get(key, 0.0) or 0.0)
                    except (ValueError, TypeError):
                        used = 0.0
                    self._ns_used[ns] = max(self._ns_used.get(ns, 0.0),
                                            used)
            self._bump()

    def observe(self, job: Resource) -> None:
        """Upsert one job's entry from its current spec+status (the
        reconciler's read-your-writes refresh).  A no-op — no epoch bump,
        caches stay warm — when nothing changed."""
        with self._lock:
            if self._observe_locked(job):
                self._bump()

    def _observe_locked(self, job: Resource) -> bool:
        from kubeflow_tpu_torch.platform.apis import gpujob as jobapi

        ns = deep_get(job, "metadata", "namespace", default="") or ""
        name = deep_get(job, "metadata", "name", default="") or ""
        key = f"{ns}/{name}"
        phase = jobapi.phase_of(job)
        demand = (None if phase in jobapi.TERMINAL_PHASES
                  else demand_of(job))
        if demand is None:
            had = key in self._entries
            self._drop_locked(key)
            return had
        alloc = jobapi.allocated_slices(job)
        if alloc is not None and phase not in jobapi.HOLDING_PHASES:
            alloc = None
        queued_at = None
        if alloc is None:
            queued_at = jobapi.queued_at(job)
            if queued_at is None:
                queued_at = parse_timestamp(demand.created)
        cur = self._entries.get(key)
        if (cur is not None and cur.demand == demand
                and cur.alloc == alloc and cur.queued_at == queued_at):
            return False
        self._drop_locked(key)
        self._entries[key] = _Entry(demand, alloc, queued_at)
        if alloc is None:
            bisect.insort(self._waiting, (demand.rank, key))
            self._waiting_by_ns[ns] = self._waiting_by_ns.get(ns, 0) + 1
        else:
            self._pool_alloc[demand.pool] = (
                self._pool_alloc.get(demand.pool, 0) + alloc)
            self._ns_gpus[ns] = (self._ns_gpus.get(ns, 0.0)
                                 + alloc * demand.gpus_per_slice)
            self._alloc_total += alloc
            if alloc < demand.slices:
                self._shrunk.add(key)
        return True

    def forget(self, namespace: str, name: str) -> None:
        with self._lock:
            if self._drop_locked(f"{namespace}/{name}"):
                self._bump()

    # -- InferenceService charges (the serving-side quota weld) ---------------

    def observe_service(self, svc: Resource) -> None:
        """Upsert one InferenceService's GPU charge from its current
        spec+status.  No-op when the charge is unchanged."""
        with self._lock:
            if self._observe_service_locked(svc):
                self._bump()

    def _observe_service_locked(self, svc: Resource) -> bool:
        from kubeflow_tpu_torch.platform.apis import inferenceservice as svcapi

        ns = deep_get(svc, "metadata", "namespace", default="") or ""
        name = deep_get(svc, "metadata", "name", default="") or ""
        key = f"{ns}/{name}"
        gpus = svcapi.gpus_of(svc)
        cur = self._svc_gpus.get(key)
        if cur == gpus or (cur is None and gpus == 0.0):
            return False
        if cur is not None:
            self._svc_ns_gpus[ns] = max(
                0.0, self._svc_ns_gpus.get(ns, 0.0) - cur)
        if gpus > 0.0:
            self._svc_gpus[key] = gpus
            self._svc_ns_gpus[ns] = self._svc_ns_gpus.get(ns, 0.0) + gpus
        else:
            self._svc_gpus.pop(key, None)
            if self._svc_ns_gpus.get(ns, 0.0) <= 0.0:
                self._svc_ns_gpus.pop(ns, None)
        return True

    def forget_service(self, namespace: str, name: str) -> None:
        with self._lock:
            key = f"{namespace}/{name}"
            gpus = self._svc_gpus.pop(key, None)
            if gpus is None:
                return
            left = self._svc_ns_gpus.get(namespace, 0.0) - gpus
            if left > 0.0:
                self._svc_ns_gpus[namespace] = left
            else:
                self._svc_ns_gpus.pop(namespace, None)
            self._bump()

    def service_headroom(self, namespace: str, *,
                         own_gpus: float = 0.0) -> float:
        """Free GPUs in ``namespace`` for a serving scale-up: quota hard
        minus the effective commitment (admitted gangs + other services +
        stored live pods), with the caller's own current charge counted
        as free to itself.  ``inf`` when the namespace has no GPU
        quota."""
        with self._lock:
            hard = self._ns_quota.get(namespace)
            if hard is None:
                return float("inf")
            return max(0.0, hard - self._ns_effective_used(
                namespace, own_gpus=own_gpus))

    def _drop_locked(self, key: str) -> bool:
        entry = self._entries.pop(key, None)
        if entry is None:
            return False
        ns = entry.demand.namespace
        if entry.alloc is None:
            i = bisect.bisect_left(self._waiting, (entry.demand.rank, key))
            if i < len(self._waiting) and self._waiting[i][1] == key:
                del self._waiting[i]
            left = self._waiting_by_ns.get(ns, 0) - 1
            if left > 0:
                self._waiting_by_ns[ns] = left
            else:
                self._waiting_by_ns.pop(ns, None)
        else:
            pool = entry.demand.pool
            self._pool_alloc[pool] = max(
                0, self._pool_alloc.get(pool, 0) - entry.alloc)
            self._ns_gpus[ns] = max(
                0.0, self._ns_gpus.get(ns, 0.0)
                - entry.alloc * entry.demand.gpus_per_slice)
            self._alloc_total = max(0, self._alloc_total - entry.alloc)
            self._shrunk.discard(key)
        return True

    def _bump(self) -> None:
        self._epoch += 1
        self._update_gauges()

    # -- capacity math -------------------------------------------------------

    def _pool_capacity(self, d: GangDemand) -> Optional[int]:
        """Slice slots the cluster can host for this demand's pool, or
        None when the node inventory says nothing about it (unlimited: no
        node feed, no pool gating)."""
        hosts = self._pool_hosts.get(d.pool)
        if hosts is None:
            return None
        return hosts // max(d.hosts_per_slice, 1)

    def _k_max(self, d: GangDemand, *, extra_pool: int = 0,
               extra_gpus: float = 0.0, own_alloc: int = 0) -> int:
        """Largest gang width currently grantable to ``d`` given free pool
        slots and free namespace GPUs (``own_alloc``: capacity the job
        itself already holds, counted as free for resize decisions)."""
        cap = self._pool_capacity(d)
        if cap is None:
            pool_avail = d.slices
        else:
            pool_avail = (cap - self._pool_alloc.get(d.pool, 0)
                          + extra_pool + own_alloc)
        hard = self._ns_quota.get(d.namespace)
        if hard is None:
            gpu_avail = d.slices
        else:
            gpu_avail = int((hard - self._ns_effective_used(
                d.namespace, own_gpus=own_alloc * d.gpus_per_slice)
                + extra_gpus) // max(d.gpus_per_slice, 1))
        return max(0, min(d.slices, pool_avail, gpu_avail))

    def _ns_effective_used(self, ns: str, *, own_gpus: float = 0.0
                           ) -> float:
        """GPUs committed in ``ns``: max(declared GPUs, the quota's
        stored status.used) — declared covers admitted gangs AND
        InferenceService replica targets whose pods haven't landed yet,
        stored covers every OTHER consumer's live pods (notebooks).
        ``own_gpus`` (a resize decision) is subtracted
        from both sides: the caller's own allocation is free capacity to
        itself and its own running pods are inside stored."""
        declared = (self._ns_gpus.get(ns, 0.0)
                    + self._svc_ns_gpus.get(ns, 0.0) - own_gpus)
        stored = self._ns_used.get(ns, 0.0) - own_gpus
        return max(declared, stored, 0.0)

    def _admissible(self, d: GangDemand) -> bool:
        return self._k_max(d) >= d.min_slices

    # -- decisions -----------------------------------------------------------

    def _first_admissible(self) -> Optional[Tuple]:
        """(rank, key) of the best-ranked waiter that currently fits, or
        None.  Cached per state epoch."""
        epoch, cached = self._first_adm_cache
        if epoch == self._epoch:
            return cached
        found = None
        for rank, key in self._waiting:
            if self._admissible(self._entries[key].demand):
                found = (rank, key)
                break
        self._first_adm_cache = (self._epoch, found)
        return found

    def decide(self, namespace: str, name: str) -> Decision:
        """The admission decision for one job.  Head-of-line: a job waits
        while any better-ranked waiter currently fits — that job will be
        admitted by its own reconcile; this one queues behind it."""
        with self._lock:
            key = f"{namespace}/{name}"
            entry = self._entries.get(key)
            if entry is None:
                return Decision("unknown")
            if entry.alloc is not None:
                return Decision("admitted", slices=entry.alloc)
            d = entry.demand
            first = self._first_admissible()
            if first is not None and first[0] < d.rank:
                other = self._entries[first[1]].demand
                return Decision(
                    "wait", reason=REASON_QUEUED_BEHIND,
                    message=f"queued behind {first[1]} "
                            f"(priority {other.priority})")
            k = self._k_max(d)
            if k >= d.min_slices:
                return Decision("admit", slices=k)
            targets = self._targets()
            victims = sorted(v for v, (by, _r) in targets.items()
                             if by == key)
            if victims:
                return Decision(
                    "wait", reason=REASON_AWAITING_PREEMPTION,
                    message="preempting " + ", ".join(victims))
            # Which constraint binds, for the structured reason.
            cap = self._pool_capacity(d)
            pool_free = (d.slices if cap is None
                         else cap - self._pool_alloc.get(d.pool, 0))
            if pool_free >= d.min_slices:
                hard = self._ns_quota.get(d.namespace)
                used = self._ns_effective_used(d.namespace)
                return Decision(
                    "wait", reason=REASON_QUOTA,
                    message=f"namespace {d.namespace} "
                            f"{topology.RESOURCE_GPU} quota {hard:g} GPUs, "
                            f"{used:g} committed; need "
                            f"{d.min_slices * d.gpus_per_slice}")
            return Decision(
                "wait", reason=REASON_CAPACITY,
                message=f"pool {d.pool_name}: "
                        f"{max(pool_free, 0)} free slice slot(s), "
                        f"need {d.min_slices}")

    def _targets(self) -> Dict[str, Tuple[str, str]]:
        """victim key -> (preemptor key or "", reason).  Cached per state
        epoch: one O(admitted) scan per mutation, not per query."""
        epoch, cached = self._targets_cache
        if epoch == self._epoch:
            return cached
        targets: Dict[str, Tuple[str, str]] = {}
        admitted = [e for e in self._entries.values()
                    if e.alloc is not None]
        # Capacity shrink: a pool whose allocation exceeds its (shrunk)
        # node inventory sheds its lowest-ranked gangs until it fits —
        # they re-queue and resume elastically at whatever still fits.
        by_pool: Dict[Tuple[str, int], List[_Entry]] = {}
        for e in admitted:
            by_pool.setdefault(e.demand.pool, []).append(e)
        for pool, entries in by_pool.items():
            cap = self._pool_capacity(entries[0].demand)
            if cap is None:
                continue
            over = self._pool_alloc.get(pool, 0) - cap
            if over <= 0:
                continue
            for e in sorted(entries,
                            key=lambda e: (-e.demand.priority,
                                           e.demand.created,
                                           e.demand.name),
                            reverse=True):
                if over <= 0:
                    break
                targets[e.demand.key] = ("", "capacity")
                over -= e.alloc
        # Priority preemption: rights belong to the head waiter only.
        if self._waiting:
            head = self._entries[self._waiting[0][1]].demand
            if not self._admissible(head):
                freed_pool, freed_gpus = 0, 0.0
                chosen: List[str] = []
                k_before = self._k_max(head)
                for e in sorted(
                        (e for e in admitted
                         if e.demand.priority < head.priority
                         and e.demand.key not in targets),
                        key=lambda e: (-e.demand.priority,
                                       e.demand.created, e.demand.name),
                        reverse=True):
                    v = e.demand
                    same_pool = v.pool == head.pool
                    same_ns = v.namespace == head.namespace
                    if not same_pool and not same_ns:
                        continue
                    next_pool = freed_pool + (e.alloc if same_pool else 0)
                    next_gpus = freed_gpus + (
                        e.alloc * v.gpus_per_slice if same_ns else 0.0)
                    k_after = self._k_max(head, extra_pool=next_pool,
                                          extra_gpus=next_gpus)
                    if k_after <= k_before:
                        # Minimal set: a candidate that relaxes no
                        # BINDING constraint (e.g. frees GPUs when only
                        # pool slots bind) must never be evicted.
                        continue
                    chosen.append(v.key)
                    freed_pool, freed_gpus = next_pool, next_gpus
                    k_before = k_after
                    if k_after >= head.min_slices:
                        for vk in chosen:
                            targets[vk] = (head.key, "priority")
                        break
        self._targets_cache = (self._epoch, targets)
        return targets

    def should_yield(self, namespace: str, name: str
                     ) -> Optional[Tuple[str, str]]:
        """For an ADMITTED job: (preemptor key or "", reason) when the
        schedule says this gang must checkpoint-and-release its GPUs —
        either a higher-priority head waiter claimed them ("priority") or
        the pool shrank under it ("capacity").  None otherwise."""
        with self._lock:
            entry = self._entries.get(f"{namespace}/{name}")
            if entry is None or entry.alloc is None:
                return None
            return self._targets().get(entry.demand.key)

    def grow_target(self, namespace: str, name: str) -> Optional[int]:
        """For an elastically-shrunk ADMITTED job: the larger gang width
        it may resize to, or None.  Waiters first: growth never races the
        queue — it is only offered while no job is waiting at all."""
        with self._lock:
            entry = self._entries.get(f"{namespace}/{name}")
            if entry is None or entry.alloc is None:
                return None
            d = entry.demand
            if entry.alloc >= d.slices or self._waiting:
                return None
            k = self._k_max(d, own_alloc=entry.alloc)
            return k if k > entry.alloc else None

    # -- introspection -------------------------------------------------------

    # -- event fan-out + introspection ---------------------------------------

    def kick_requests(self, limit: int = 4) -> List[Tuple[str, str]]:
        """Keys whose reconciles could act on the current state: the head
        waiters (admission), the current preemption targets (yield) and
        the shrunk gangs (grow-back).  The controller maps every GPUJob
        delta through this, so a capacity change wakes exactly the keys
        that can use it."""
        with self._lock:
            out: List[Tuple[str, str]] = []
            for _rank, key in self._waiting[:limit]:
                d = self._entries[key].demand
                out.append((d.namespace, d.name))
            for vk in self._targets():
                ns, _, name = vk.partition("/")
                out.append((ns, name))
            for key in list(self._shrunk)[:limit]:
                e = self._entries.get(key)
                if e is not None:
                    out.append((e.demand.namespace, e.demand.name))
            return out

    def depth_by_namespace(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._waiting_by_ns)

    def oldest_wait_by_namespace(self, now: Optional[float] = None
                                 ) -> Dict[str, float]:
        """Age of the oldest queued job per profile namespace: the
        starvation signal that ``gpujob_queue_wait_seconds``, observed
        only at admission, cannot carry.  Read at scrape time only."""
        if now is None:
            now = self._now()
        out: Dict[str, float] = {}
        with self._lock:
            for _rank, key in self._waiting:
                entry = self._entries[key]
                if entry.queued_at is None:
                    continue
                age = max(0.0, now - entry.queued_at)
                ns = entry.demand.namespace
                if age > out.get(ns, -1.0):
                    out[ns] = age
        return out

    def allocated_total(self) -> int:
        with self._lock:
            return self._alloc_total

    def snapshot(self) -> dict:
        """The live ledger, the reference's /debug/queue page: waiting
        order, admitted allocations, pool + quota tallies."""
        with self._lock:
            waiting = []
            for _rank, key in self._waiting:
                d = self._entries[key].demand
                waiting.append({
                    "key": key, "priority": d.priority,
                    "slices": d.slices, "minSlices": d.min_slices,
                    "pool": d.pool_name,
                    "gpusPerSlice": d.gpus_per_slice,
                })
            admitted = []
            for key, e in sorted(self._entries.items()):
                if e.alloc is None:
                    continue
                admitted.append({
                    "key": key, "priority": e.demand.priority,
                    "allocatedSlices": e.alloc,
                    "specSlices": e.demand.slices,
                    "pool": e.demand.pool_name,
                })
            # Key every pool map by "<short name>/<GPUs a node>", the
            # demands' own pool name, so the free-slot math joins; nodes
            # of a product no accelerator names keep the product label.
            short_by_product = {a.product: a.name
                                for a in topology.ACCELERATORS.values()}
            pools = {}
            for (product, gpus), hosts in sorted(self._pool_hosts.items()):
                short = short_by_product.get(product, product)
                pools[f"{short}/{gpus}"] = {"hosts": hosts,
                                            "product": product}
            return {
                "waiting": waiting,
                "admitted": admitted,
                "pools": pools,
                "poolAllocatedSlices": {
                    f"{short_by_product.get(p, p)}/{g}": n
                    for (p, g), n in sorted(self._pool_alloc.items())},
                "namespaceQuotaGpus": dict(sorted(self._ns_quota.items())),
                "namespaceCommittedGpus": {
                    ns: round(self._ns_effective_used(ns), 1)
                    for ns in sorted(set(self._ns_gpus) |
                                     set(self._ns_used) |
                                     set(self._svc_ns_gpus))
                    if self._ns_effective_used(ns)},
                # Serving's share of the commitment: InferenceService
                # replica GPUs, per service — the rows that explain an
                # InsufficientQuota park when no gang holds the GPUs.
                "inferenceServiceGpus": {
                    key: round(gpus, 1)
                    for key, gpus in sorted(self._svc_gpus.items())},
                "preemptionTargets": {
                    vk: {"by": by, "reason": r}
                    for vk, (by, r) in sorted(self._targets().items())},
            }

    def _update_gauges(self) -> None:
        from kubeflow_tpu_torch.platform.runtime import metrics

        metrics.set_gpujob_queue_depth(dict(self._waiting_by_ns))
        metrics.gpujob_slices_allocated.set(self._alloc_total)


# -- the debug registry: the job controller registers its queue on start and
#    unhooks it on stop; the reference's /debug/queue page serves the
#    snapshot, the oldest-wait gauge reads the ages. -------------------------

_debug_queue: Optional[JobQueue] = None


def register_debug_queue(queue: Optional[JobQueue]) -> None:
    global _debug_queue
    _debug_queue = queue


def debug_snapshot() -> Optional[dict]:
    q = _debug_queue
    return q.snapshot() if q is not None else None


def oldest_queue_waits() -> Optional[Dict[str, float]]:
    """The oldest-wait gauge's read; None until a job controller
    registers its queue."""
    q = _debug_queue
    return q.oldest_wait_by_namespace() if q is not None else None

