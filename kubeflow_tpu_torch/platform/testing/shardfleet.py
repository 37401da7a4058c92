"""ShardedFleet: N simulated controller replicas over one apiserver.  The
port's copy of ``kubeflow_tpu/platform/testing/shardfleet.py``.

One ``FakeKube``, a kubelet simulator bringing worker pods Running, a
convergence tracker on the Notebook watch stream, and R replicas — each
a ``Manager`` with its own ``ShardCoordinator``, its own ``ChaosKube``
(the per-replica call log the fencing assertions join against; faults
optional) and its own ``FencedClient`` write gate, running the
controllers ``controller_factory`` builds (the notebook controller by
default; a list of controllers, such as the notebook controller and the
culler sharing its informer, runs under one Manager):

    FencedClient( ChaosKube( FakeKube ) )
       ^ fence decides        ^ logs what actually reached the wire

so a fenced write appears in NEITHER log — which is exactly the
invariant: the wire never sees a key written by two replicas in
overlapping ownership windows.

Replica lifecycle knobs mirror the failure modes: ``kill()`` (the
controllers down, their threads gone, then the coordinator's crash —
leases age out, survivors absorb), ``stop_replica()`` (graceful: leases
released, instant handover), ``pause()/resume_replica()`` (renewals
frozen with the replica alive — the split-brain case).

The fleet's nodes are GPU nodes (``gpu_nodes``, each a full
``h100-80gb`` host) and a wave's Notebooks ask one H100 each
(``spec.gpu``), where the reference's carry ``spec.tpu``.  Drive it on
the CPU::

    fleet = ShardedFleet(replicas=3, lease_seconds=1.0, renew_seconds=0.1)
    fleet.wait_stable_shard_map()
    fleet.create_wave(200)
    fleet.kill(1)
    fleet.wait_converged(timeout=30)
    fleet.assert_fencing_invariant()
    fleet.close()
"""
from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Dict, List, Optional, Tuple

from kubeflow_tpu_torch.platform.runtime.sharding import (
    FencedClient,
    ShardCoordinator,
)
from kubeflow_tpu_torch.platform.testing.chaos import ChaosKube
from kubeflow_tpu_torch.platform.testing.fake import FakeKube

# The wave's device block: one H100 a notebook.
WAVE_GPU = {"accelerator": "h100-80gb", "gpus": 1}
# How long kill() waits for a stopped controller's threads to end.
KILL_JOIN_S = 10.0


@dataclasses.dataclass
class Replica:
    index: int
    chaos: ChaosKube          # per-replica wire log (faults optional)
    coordinator: ShardCoordinator
    client: FencedClient      # what the controllers write through
    manager: object           # the replica's Manager(client, shards=)
    controllers: list         # every controller it runs
    alive: bool = True

    @property
    def controller(self):
        """The replica's first (primary) controller."""
        return self.controllers[0]


class ShardedFleet:
    def __init__(self, *, replicas: int = 4, num_shards: int = 8,
                 workers: int = 4, lease_seconds: float = 0.5,
                 renew_seconds: float = 0.05,
                 chaos_faults: Optional[list] = None,
                 chaos_seed: int = 0,
                 namespace: str = "fleet",
                 controller_factory=None,
                 gpu_nodes: int = 1):
        from kubeflow_tpu_torch.platform.controllers.notebook import (
            make_controller,
        )

        logging.getLogger("kubeflow_tpu_torch.runtime").setLevel(
            logging.ERROR)
        # Which controllers each replica runs: the notebook reconciler by
        # default; any factory with the (client, shards=) signature that
        # returns a Controller or a list of them works.
        self._controller_factory = controller_factory or (
            lambda client, **kw: make_controller(
                client, use_istio=False, **kw))
        self.namespace = namespace
        self.num_shards = num_shards
        self.lease_seconds = lease_seconds
        self.renew_seconds = renew_seconds
        self.workers = workers
        self.kube = FakeKube()
        self.kube.add_namespace(namespace)
        self.kube.add_namespace("kubeflow")  # shard/member leases
        # The GPU node inventory, one full host a node: GPUJob fleets size
        # it to their slice demand (the queue's ledger admits a gang only
        # on free hosts of its pool).
        for i in range(max(gpu_nodes, 1)):
            self.kube.add_gpu_node(f"gpu-node-{i + 1}")
        self._stop = threading.Event()
        self._converged: set = set()
        self._converged_lock = threading.Lock()
        self._conv_event = threading.Event()
        self._target = 0
        self._threads: List[threading.Thread] = []
        for fn in (self._kubelet_loop, self._convergence_loop):
            t = threading.Thread(target=fn, daemon=True)
            t.start()
            self._threads.append(t)
        self.replicas: List[Replica] = []
        for i in range(replicas):
            self.replicas.append(self._replica(i, chaos_faults or [],
                                               chaos_seed + i))
        for r in self.replicas:
            r.manager.start()

    def _replica(self, i: int, faults: list, seed: int) -> Replica:
        from kubeflow_tpu_torch.platform.runtime import Manager

        chaos = ChaosKube(self.kube, faults, seed=seed)
        coord = ShardCoordinator(
            self.kube,  # lease traffic stays on the healthy store
            num_shards=self.num_shards, identity=f"r{i}",
            lease_seconds=self.lease_seconds,
            renew_seconds=self.renew_seconds,
        )
        fenced = FencedClient(chaos, coord, log_writes=True)
        made = self._controller_factory(fenced, shards=coord)
        controllers = list(made) if isinstance(made, (list, tuple)) \
            else [made]
        controllers[0].workers = self.workers
        mgr = Manager(fenced, shards=coord)
        for c in controllers:
            mgr.add(c)
        return Replica(i, chaos, coord, fenced, mgr, controllers)

    # -- lifecycle / chaos ----------------------------------------------------

    def kill(self, index: int) -> None:
        """The crash: the controllers down and their threads gone (a
        killed process writes nothing after it is gone), then the
        coordinator stops renewing WITHOUT releasing — survivors absorb
        after the lease TTL."""
        r = self.replicas[index]
        for c in r.controllers:
            c.stop()
        deadline = time.monotonic() + KILL_JOIN_S
        for c in r.controllers:
            for t in c._threads:
                t.join(timeout=max(0.0, deadline - time.monotonic()))
        r.coordinator.crash()
        r.alive = False

    def stop_replica(self, index: int) -> None:
        """Graceful shutdown: leases released first, instant handover."""
        r = self.replicas[index]
        r.manager.stop()
        r.alive = False

    def pause(self, index: int) -> None:
        self.replicas[index].coordinator.pause()

    def resume_replica(self, index: int) -> None:
        self.replicas[index].coordinator.resume()

    def add_replica(self) -> Replica:
        """Membership churn: a joiner appears mid-flight; incumbents shed
        toward the new fair share and the joiner resyncs the moved
        ranges."""
        r = self._replica(len(self.replicas), [], 1000 + len(self.replicas))
        self.replicas.append(r)
        r.manager.start()
        return r

    def close(self) -> None:
        self._stop.set()
        for r in self.replicas:
            if r.alive:
                r.manager.stop()
                r.alive = False
        for t in self._threads:
            t.join(timeout=5)

    # -- simulators -----------------------------------------------------------

    def _kubelet_loop(self) -> None:
        from kubeflow_tpu_torch.platform.k8s import errors
        from kubeflow_tpu_torch.platform.k8s.types import STATEFULSET, deep_get

        acked: Dict[str, int] = {}
        for etype, sts in self.kube.watch(STATEFULSET, self.namespace,
                                          stop=self._stop):
            name = sts["metadata"]["name"]
            if etype == "DELETED":
                # Gang teardown (a GPUJob restart): forget the ack so the
                # recreated same-name StatefulSet gets its pods again.
                acked.pop(name, None)
                continue
            replicas = deep_get(sts, "spec", "replicas", default=0)
            if acked.get(name) == replicas or not replicas:
                continue
            tmpl = deep_get(sts, "spec", "template")
            for i in range(replicas):
                pod = {
                    "apiVersion": "v1", "kind": "Pod",
                    "metadata": {
                        "name": f"{name}-{i}", "namespace": self.namespace,
                        "labels": dict(
                            deep_get(tmpl, "metadata", "labels",
                                     default={}) or {}),
                    },
                    "spec": deep_get(tmpl, "spec"),
                }
                try:
                    self.kube.create(pod)
                except errors.AlreadyExists:
                    pass
                try:
                    self.kube.set_pod_phase(self.namespace, f"{name}-{i}",
                                            "Running", ready=True)
                except errors.ApiError:
                    pass
            acked[name] = replicas

    def _convergence_loop(self) -> None:
        from kubeflow_tpu_torch.platform.k8s.types import NOTEBOOK, deep_get

        for _etype, nb in self.kube.watch(NOTEBOOK, self.namespace,
                                          stop=self._stop):
            ready = deep_get(nb, "status", "readyReplicas", default=0)
            reps = deep_get(nb, "status", "replicas", default=0)
            if reps and ready == reps:
                with self._converged_lock:
                    self._converged.add(nb["metadata"]["name"])
                    if (self._target
                            and len(self._converged) >= self._target):
                        self._conv_event.set()

    # -- phases ---------------------------------------------------------------

    def create_wave(self, n: int, *, prefix: str = "nb") -> None:
        with self._converged_lock:
            self._target = n + len(self._converged)
            self._conv_event.clear()
        for i in range(n):
            self.kube.create({
                "apiVersion": "kubeflow.org/v1beta1", "kind": "Notebook",
                "metadata": {"name": f"{prefix}-{i:05d}",
                             "namespace": self.namespace},
                "spec": {
                    "gpu": dict(WAVE_GPU),
                    "template": {"spec": {"containers": [
                        {"name": "notebook",
                         "image": "ghcr.io/kubeflow-tpu/jupyter-jax-tpu"}]}},
                },
            })

    def wait_converged(self, *, timeout: float = 300.0) -> None:
        if not self._conv_event.wait(timeout):
            with self._converged_lock:
                missing = self._target - len(self._converged)
            owners = {r.index: sorted(r.coordinator.owned())
                      for r in self.replicas if r.alive}
            raise TimeoutError(
                f"{missing} notebooks unconverged after {timeout}s "
                f"(live shard map: {owners})")

    def wave(self, n: int, *, timeout: float = 300.0,
             prefix: str = "nb") -> float:
        t0 = time.perf_counter()
        self.create_wave(n, prefix=prefix)
        self.wait_converged(timeout=timeout)
        return time.perf_counter() - t0

    def wait_stable_shard_map(self, *, timeout: float = 15.0
                              ) -> Dict[int, list]:
        """Block until the live replicas' owned sets form a clean
        partition of the keyspace (complete, disjoint, nothing mid-drain)
        with every live replica between floor and ceil of its fair
        share, and return it.  Transient double-claims are EXPECTED
        during handover — a replica that lost a lease learns it on its
        next renew — so map assertions poll for the settled state;
        writes are protected throughout by fencing, asserted
        separately."""
        deadline = time.monotonic() + timeout
        want = set(range(self.num_shards))
        while True:
            per = {r.index: sorted(r.coordinator.owned())
                   for r in self.replicas if r.alive}
            draining = any(r.coordinator.draining()
                           for r in self.replicas if r.alive)
            flat = [s for owned in per.values() for s in owned]
            n_live = max(len(per), 1)
            lo = self.num_shards // n_live
            hi = -(-self.num_shards // n_live)
            balanced = all(lo <= len(owned) <= hi
                           for owned in per.values())
            if (not draining and balanced
                    and len(flat) == len(set(flat))
                    and set(flat) == want):
                return per
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"shard map never settled: {per} "
                    f"(draining={draining})")
            time.sleep(0.02)

    # -- invariant assertions -------------------------------------------------

    def ownership_windows(self) -> Dict[int, List[Tuple[int, float, float]]]:
        """Per shard: (replica, open_t, close_write_deadline) windows from
        every coordinator's ownership log.  A still-open window closes at
        +inf for a live replica, and at ``last_renew + lease_seconds`` for
        crashed ones (the log's crash record carries it)."""
        windows: Dict[int, List[Tuple[int, float, float]]] = {}
        for r in self.replicas:
            open_at: Dict[int, float] = {}
            for entry in list(r.coordinator.ownership_log):
                shard, action, t, deadline = entry
                if action == "acquire":
                    open_at[shard] = t
                else:
                    t0 = open_at.pop(shard, None)
                    if t0 is not None:
                        windows.setdefault(shard, []).append(
                            (r.index, t0, deadline if deadline is not None
                             else t))
            for shard, t0 in open_at.items():
                windows.setdefault(shard, []).append(
                    (r.index, t0, float("inf")))
        return windows

    def assert_fencing_invariant(self, *, kinds: Optional[set] = None,
                                 namespace: Optional[str] = None) -> int:
        """The cross-process exclusion proof, from the logs:

        1. every write that reached the wire (per-replica ChaosKube
           write_log, Lease traffic excluded) was fenced — it appears in
           that replica's FencedClient log with a shard + token;
        2. every fenced write's timestamp falls inside one of its
           replica's ownership windows for that shard;
        3. for each shard, windows of DIFFERENT replicas never overlap
           (close uses the write deadline — ``last_renew + TTL`` for
           crashes — so a successor's acquire can't predate it).

        Returns the number of writes checked (callers assert > 0 so a
        silent no-write run can't vacuously pass)."""
        ns = namespace or self.namespace
        windows = self.ownership_windows()
        checked = 0
        for r in self.replicas:
            fenced_writes = [w for w in list(r.client.write_log)
                             if w["namespace"] == ns
                             and (kinds is None or w["kind"] in kinds)]
            wire_writes = [w for w in list(r.chaos.write_log)
                           if w[3] == ns
                           and (kinds is None or w[2] in kinds)]
            # 1: the wire never saw fewer of this replica's writes than
            # the fence authorized (faulted calls are logged on the wire
            # but raise before FencedClient's success log).
            assert len(wire_writes) >= len(fenced_writes), (
                f"replica {r.index}: {len(fenced_writes)} fenced writes "
                f"but only {len(wire_writes)} on the wire")
            for w in fenced_writes:
                assert w.get("shard") is not None, (
                    f"replica {r.index}: unfenced write {w}")
                spans = [s for s in windows.get(w["shard"], ())
                         if s[0] == r.index and s[1] <= w["t"] <= s[2]]
                assert spans, (
                    f"replica {r.index} wrote {w['kind']} "
                    f"{w['namespace']}/{w['name']} (key {w['key']}, shard "
                    f"{w['shard']}) at t={w['t']:.3f} outside every "
                    f"ownership window {windows.get(w['shard'])}")
                checked += 1
        for shard, spans in windows.items():
            spans = sorted(spans, key=lambda s: s[1])
            for (ra, a0, a1), (rb, b0, b1) in zip(spans, spans[1:]):
                if ra == rb:
                    continue
                assert b0 >= a1, (
                    f"shard {shard}: replica {rb}'s window opens at "
                    f"{b0:.3f} before replica {ra}'s write deadline "
                    f"{a1:.3f} — overlapping ownership")
        return checked

    def assert_no_writes_after(self, index: int, t: float, *,
                               kinds: Optional[set] = None) -> None:
        """Split-brain assertion: replica ``index``'s wire log shows no
        write at/after monotonic time ``t`` (Lease traffic excluded by
        construction — the coordinator bypasses the ChaosKube)."""
        r = self.replicas[index]
        late = [w for w in list(r.chaos.write_log)
                if w[0] >= t and (kinds is None or w[2] in kinds)]
        assert not late, (
            f"replica {index} wrote after t={t:.3f}: {late[:5]}")

    def cache_stats(self) -> Dict[int, dict]:
        """Per-replica informer load: cached objects and deltas admitted
        vs seen, over every informer of the replica's controllers."""
        out = {}
        for r in self.replicas:
            informers = dict.fromkeys(
                i for c in r.controllers for i in c.informers.values())
            out[r.index] = {
                "cached_objects": sum(len(i) for i in informers),
                "events_seen": sum(i.events_seen for i in informers),
                "events_admitted": sum(i.events_admitted
                                       for i in informers),
            }
        return out
