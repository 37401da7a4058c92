"""The port's ``ShardedFleet`` (``kubeflow_tpu_torch/platform/testing/
shardfleet.py``): replicas of the notebook or GPUJob controller, each a
``Manager`` with its own shard coordinator and fenced client over one
``FakeKube``, killed, paused and churned, the port's counterparts of
the reference's fleet cases (``tests/ctrlplane/test_sharding.py``,
``tests/ctrlplane/test_jobqueue.py``):

* a replica killed mid-wave: every notebook converges, the dead
  replica's shards are absorbed within the reference's bound, the
  fencing invariant holds, and every notebook's children equal those
  the reference's fleet writes for the same wave (a one-GPU notebook
  against the reference's one-host TPU notebook, the device fields
  compared apart as in ``test_torch_notebook.py``);
* the GPUJob fleet across a kill: every gang restarts under the
  survivor with every write fenced, as the reference's TPUJob fleet;
* the queue's drain order across a kill: priority, then FIFO;
* a paused replica whose leases expire fences itself;
* reconcile trace ids unique across a fleet, and one notebook's journey
  across a kill, joined with ``merge_journeys``;
* membership churn during a converge.

Steadiness: every fleet runs a lease of 1.0 s renewed every 0.1 s (the
reference's unit timings are 0.5 s and 0.05 s), and every wait polls
state and is bounded at 30 s."""
import threading
import time

from kubeflow_tpu.platform.testing.shardfleet import ShardedFleet as RefFleet
from kubeflow_tpu_torch.platform.apis import gpujob as jobapi
from kubeflow_tpu_torch.platform.controllers import gpujob as jobctrl
from kubeflow_tpu_torch.platform.k8s.types import (
    GPUJOB,
    NOTEBOOK,
    POD,
    SERVICE,
    STATEFULSET,
    name_of,
)
from kubeflow_tpu_torch.platform.runtime.sharding import shard_of
from kubeflow_tpu_torch.platform.testing.shardfleet import ShardedFleet
from kubeflow_tpu_torch.telemetry import causal
from test_torch_notebook import (
    GPU_KEY,
    LIBTPU_ONLY,
    SHARED_ENV,
    TPU_KEY,
    _clean,
    _without_devices,
)

TTL = 1.0
RENEW = 0.1
WAIT_S = 30.0
H100 = "h100-80gb"


def fleet(**kw):
    kw.setdefault("lease_seconds", TTL)
    kw.setdefault("renew_seconds", RENEW)
    return ShardedFleet(**kw)


def wait_for(fn, what, timeout=WAIT_S, detail=None):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        out = fn()
        if out:
            return out
        time.sleep(0.05)
    raise AssertionError(f"no {what} within {timeout} s"
                         + (f": {detail()}" if detail is not None else ""))


def first_absorb_times(survivors, crashed, kill_t):
    """Per crashed shard: seconds from the kill to the first survivor
    acquisition."""
    first = {}
    for r in survivors:
        for s, a, t, _ in r.coordinator.ownership_log:
            if a == "acquire" and s in crashed and t > kill_t:
                dt = t - kill_t
                if s not in first or dt < first[s]:
                    first[s] = dt
    return first


def children(kube, ns, names):
    """Each notebook's StatefulSet and Services, without what two servers
    mint apart."""
    out = {}
    for name in names:
        out[name] = {
            "StatefulSet": [_clean(o) for o in kube.list(
                STATEFULSET, ns, label_selector={"notebook-name": name})],
            "Service": sorted(
                (_clean(o) for o in kube.list(SERVICE, ns)
                 if o["metadata"]["name"] in (name, f"{name}-workers")),
                key=lambda o: o["metadata"]["name"]),
        }
    return out


def test_kill_mid_wave_converges_fenced_with_the_reference_children():
    n = 200
    names = [f"nb-{i:05d}" for i in range(n)]
    f = fleet(replicas=3, num_shards=8)
    try:
        f.wait_stable_shard_map()
        f.create_wave(n)
        time.sleep(0.05)
        kill_t = time.monotonic()
        f.kill(1)
        f.wait_converged(timeout=WAIT_S)
        f.wait_stable_shard_map(timeout=WAIT_S)
        survivors = [r for r in f.replicas if r.alive]
        crashed = {s for s, a, _, _ in f.replicas[1].coordinator.ownership_log
                   if a == "crash"}
        absorb = first_absorb_times(survivors, crashed, kill_t)
        assert crashed and set(absorb) == crashed
        assert max(absorb.values()) <= TTL + 4 * RENEW + 1.0, absorb
        assert f.assert_fencing_invariant(
            kinds={"Notebook", "StatefulSet", "Service"}) >= n
        f.assert_no_writes_after(1, time.monotonic())
        for r in survivors:
            assert not r.controller.dead_letters
            assert len(r.controller.informers[NOTEBOOK]) < n
        got = children(f.kube, f.namespace, names)
    finally:
        f.close()
    ref = RefFleet(replicas=3, num_shards=8, lease_seconds=TTL,
                   renew_seconds=RENEW)
    try:
        ref.wait_stable_shard_map()
        ref.wave(n, timeout=WAIT_S)
        want = children(ref.kube, ref.namespace, names)
    finally:
        ref.close()
    for name in names:
        g, _ = _without_devices(got[name], GPU_KEY,
                                SHARED_ENV | {"KFT_GPUS_PER_HOST"})
        w, _ = _without_devices(want[name], TPU_KEY,
                                SHARED_ENV | LIBTPU_ONLY)
        assert len(g["StatefulSet"]) == 1 and len(g["Service"]) == 2
        assert g == w, name


def make_job(name, ns, *, slices=1, priority=None, created=None,
             gpus=8):
    spec = {"gpu": {"accelerator": H100, "gpus": gpus, "slices": slices},
            "template": {"spec": {"containers": [{
                "name": "worker", "image": "trainer",
                "command": ["python", "-m", "kubeflow_tpu_torch.train.run"],
            }]}}}
    if priority is not None:
        spec["priority"] = priority
    job = {"apiVersion": "kubeflow.org/v1alpha1", "kind": "GPUJob",
           "metadata": {"name": name, "namespace": ns}, "spec": spec}
    if created is not None:
        job["metadata"]["creationTimestamp"] = created
    return job


def test_gpujob_gang_writes_fenced_across_a_replica_kill():
    """Six gangs of two slices over two replicas; after a kill, every
    gang loses a worker and the survivor runs the whole-gang restart for
    the gangs it owned and those it absorbed, every write fenced."""
    n = 6
    f = fleet(replicas=2, num_shards=4, workers=2,
              controller_factory=jobctrl.make_controller, gpu_nodes=2 * n)

    def all_jobs_at(phase, restarts):
        js = f.kube.list(GPUJOB, f.namespace)
        return len(js) == n and all(
            jobapi.phase_of(j) == phase and jobapi.restarts_of(j) == restarts
            for j in js)

    try:
        f.wait_stable_shard_map()
        for i in range(n):
            f.kube.create(make_job(f"gj-{i:03d}", f.namespace, slices=2))
        wait_for(lambda: all_jobs_at("Running", 0), "initial gangs")
        f.kill(0)
        for i in range(n):
            f.kube.set_pod_phase(f.namespace, f"gj-{i:03d}-s1-0", "Failed")
        wait_for(lambda: all_jobs_at("Running", 1),
                 "every gang restarted by the survivor")
        assert f.assert_fencing_invariant(
            kinds={"StatefulSet", "Service", "GPUJob"}) > 0
        survivor = f.replicas[1]
        assert sorted(survivor.coordinator.owned()) == [0, 1, 2, 3]
        assert not survivor.controller.dead_letters
        # The survivor restarted the gangs of every shard, its own and
        # the absorbed.
        restarted = {shard_of(f.namespace, w["name"], 4)
                     for w in survivor.client.write_log
                     if w["kind"] == "GPUJob"}
        assert restarted == {shard_of(f.namespace, f"gj-{i:03d}", 4)
                             for i in range(n)}
    finally:
        f.close()


def watch_admission_order(kube, ns, stop, order, lock):
    for _etype, job in kube.watch(GPUJOB, ns, stop=stop):
        if jobapi.allocated_slices(job) is not None:
            name = job["metadata"]["name"]
            with lock:
                if name not in order:
                    order.append(name)


def finish_gang(kube, name, ns):
    """The kubelet: every worker pod of the job exits 0."""
    for pod in kube.list(POD, ns, label_selector={
            jobapi.LABEL_GPUJOB_NAME: name}):
        kube.set_pod_phase(ns, name_of(pod), "Succeeded", ready=False)


def test_replica_kill_preserves_the_drain_order():
    """The queue is a pure function of watch state: a kill while the
    whole queue is parked must not reorder it — the survivor absorbs the
    dead replica's keys and admits priority-then-FIFO, every write
    fenced, no dead letter."""
    f = fleet(replicas=2, num_shards=4, workers=2, gpu_nodes=2,
              controller_factory=lambda client, **kw: jobctrl.make_controller(
                  client, preemption_grace=0.1, queue_poll=0.1, **kw))
    ns = f.namespace
    stop = threading.Event()
    order, lock = [], threading.Lock()
    watcher = threading.Thread(target=watch_admission_order,
                               args=(f.kube, ns, stop, order, lock),
                               daemon=True)
    watcher.start()
    names = []
    try:
        f.wait_stable_shard_map()
        # Two unpreemptable holders fill the two-host budget, so the six
        # jobs all queue together.
        for h in range(2):
            f.kube.create(make_job(f"holder-{h}", ns, priority=900))
        wait_for(lambda: all(jobapi.allocated_slices(f.kube.get(
            GPUJOB, f"holder-{h}", ns)) is not None for h in range(2)),
            "the holders' admission")
        for i, prio in enumerate([100, 100, 400, 400, 200, 200]):
            name = f"kj-{prio}-{i}"
            names.append(name)
            f.kube.create(make_job(name, ns, priority=prio,
                                   created=f"2026-01-01T00:00:{i:02d}Z"))

        def admitted():
            with lock:
                return len([n for n in order if n.startswith("kj-")])

        f.kill(0)

        def drained():
            for job in f.kube.list(GPUJOB, ns):
                if jobapi.phase_of(job) == "Running":
                    finish_gang(f.kube, job["metadata"]["name"], ns)
            return admitted() == len(names)

        wait_for(drained, "every job admitted")
        with lock:
            got = [n for n in order if n.startswith("kj-")]
        expected = sorted(names, key=lambda n: (-int(n.split("-")[1]),
                                                int(n.split("-")[2])))
        assert got == expected
        assert f.assert_fencing_invariant(
            kinds={"StatefulSet", "Service", "GPUJob"}) > 0
        assert not f.replicas[1].controller.dead_letters
    finally:
        stop.set()
        f.close()


def test_lease_expiry_under_a_paused_replica():
    """Split brain: a paused replica's leases expire, the survivor takes
    them, and the stale owner's writes fence themselves: nothing of it
    reaches the wire after the takeover."""
    f = fleet(replicas=2, num_shards=4)
    try:
        f.wave(60, timeout=WAIT_S)
        victim, survivor = f.replicas
        owned_before = set(victim.coordinator.owned())
        assert owned_before
        pause_t = time.monotonic()
        f.pause(0)
        wait_for(lambda: len(survivor.coordinator.owned()) == 4,
                 "the survivor's takeover")
        takeover_t = max(
            t for s, a, t, _ in survivor.coordinator.ownership_log
            if a == "acquire" and s in owned_before and t > pause_t)
        from kubeflow_tpu_torch.platform.k8s import errors

        for nb in f.kube.list(NOTEBOOK, f.namespace):
            nb = dict(nb)
            nb["status"] = dict(nb.get("status") or {})
            nb["status"]["readyReplicas"] = 0
            try:
                f.kube.update_status(nb)
            except errors.ApiError:
                pass
        wait_for(lambda: victim.client.fenced_total > 0
                 and victim.coordinator.owned() == frozenset(),
                 "the stale owner's fence")
        f.assert_no_writes_after(0, takeover_t)
        f.assert_fencing_invariant()
        def unrepaired():
            return [nb["metadata"]["name"]
                    for nb in f.kube.list(NOTEBOOK, f.namespace)
                    if nb.get("status", {}).get("readyReplicas") != 1]

        def state():
            c = survivor.controller
            return {
                "unrepaired": [
                    (n, shard_of(f.namespace, n, 4),
                     (c.informers[NOTEBOOK].get(n, f.namespace) or {}).get(
                         "status"),
                     len(c.informers[POD].index_list(
                         "notebook", f"{f.namespace}/{n}")))
                    for n in unrepaired()[:5]],
                "owned": (sorted(survivor.coordinator.owned()),
                          sorted(victim.coordinator.owned())),
                "pending": c.queue.pending(), "errors": c.error_count,
                "log": (survivor.coordinator.ownership_log[-6:],
                        victim.coordinator.ownership_log[-6:])}

        wait_for(lambda: not unrepaired(), "the new owner's repair",
                 detail=state)
    finally:
        f.close()


def test_trace_ids_unique_across_a_fleet():
    from kubeflow_tpu_torch.platform.runtime import trace as rtrace

    rtrace.clear()
    f = fleet(replicas=4, num_shards=8)
    try:
        f.wait_stable_shard_map()
        f.wave(40, timeout=WAIT_S)
    finally:
        f.close()
    ids = [t["trace_id"] for t in rtrace.recent()]
    assert ids
    assert all(len(i) == 32 and int(i, 16) >= 0 for i in ids), ids[:3]
    assert len(ids) == len(set(ids))


def test_journey_continues_across_a_replica_kill():
    f = fleet(replicas=2, num_shards=4)
    try:
        f.wait_stable_shard_map()
        f.wave(12, timeout=WAIT_S)
        owned0 = f.replicas[0].coordinator.owned()
        victim = next(f"nb-{i:05d}" for i in range(12)
                      if shard_of(f.namespace, f"nb-{i:05d}", 4) in owned0)
        ctx = causal.from_object(f.kube.get(NOTEBOOK, victim, f.namespace))
        assert ctx is not None
        before = [s for s in causal.journey(ctx.trace_id)
                  if s.get("segment") == "reconcile"]
        assert before and all(s.get("replica") == "r0" for s in before)
        f.kill(0)
        f.wait_stable_shard_map()
        nb = f.kube.get(NOTEBOOK, victim, f.namespace)
        nb["spec"]["gpu"]["gpus"] = 2
        f.kube.update(nb)
        wait_for(lambda: [s for s in causal.journey(ctx.trace_id)
                          if s.get("segment") == "reconcile"
                          and s.get("replica") == "r1"],
                 "the survivor's reconcile on the journey")
        merged = causal.merge_journeys(causal.journey(ctx.trace_id),
                                       causal.journey(ctx.trace_id))
        assert len(merged) == len(causal.journey(ctx.trace_id))
        assert [s["start_ts"] for s in merged] == sorted(
            s["start_ts"] for s in merged)
        assert {s.get("replica") for s in merged
                if s.get("segment") == "reconcile"} == {"r0", "r1"}
        assert {s["trace_id"] for s in merged} == {ctx.trace_id}
    finally:
        f.close()


def test_membership_churn_during_a_converge():
    f = fleet(replicas=2, num_shards=8)
    try:
        f.create_wave(300)
        time.sleep(0.05)
        joiner = f.add_replica()
        time.sleep(0.15)
        f.stop_replica(0)
        f.wait_converged(timeout=WAIT_S)
        per = f.wait_stable_shard_map(timeout=WAIT_S)
        assert per.get(joiner.index), "the joiner never acquired a shard"
        assert f.assert_fencing_invariant() > 0
        for r in f.replicas:
            if r.alive:
                assert not r.controller.dead_letters
    finally:
        f.close()
