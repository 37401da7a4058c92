"""The port's controller runtime end to end (``Manager``, ``Controller``,
informers, the notebook's, culler's and GPUJob's ``make_controller``)
against the reference's, each package on its own ``FakeKube``:

* the two cases of ``tests/ctrlplane/test_runtime_e2e.py``: a notebook's
  lifecycle through a ``Manager`` yields the reference's children and
  status (the GPU notebook against the reference's TPU notebook of the
  same hosts, device fields compared apart as in
  ``test_torch_notebook.py``), and the resync reads the cache;
* the dead letter after ``CONTROLLER_MAX_RETRIES``: the same condition,
  event and count, and the same recovery;
* the GPUJob path under a ``Manager``: the queue's ``kick_requests``,
  oldest wait and ``debug_snapshot`` equal the reference's TPUJob
  queue's on the same script, and the statuses as the gang ends;
* on the port alone, the card phase's story with a stand-in prober: a
  culled notebook frees the quota, and the Queued job is admitted.

Every wait is bounded at 20 s."""
import threading
import time

import pytest

from kubeflow_tpu.platform.controllers import notebook as ref_nb_ctrl
from kubeflow_tpu.platform.controllers import tpujob as ref_job_ctrl
from kubeflow_tpu.platform.k8s import types as ref_types
from kubeflow_tpu.platform.runtime import Manager as RefManager
from kubeflow_tpu.platform.runtime import controller as ref_controller
from kubeflow_tpu.platform.runtime import informer as ref_informer
from kubeflow_tpu.platform.runtime import jobqueue as ref_jq
from kubeflow_tpu.platform.runtime import metrics as ref_metrics
from kubeflow_tpu.platform.testing import FakeKube as RefKube
from kubeflow_tpu_torch.platform import (
    FakeKube,
    Manager,
    culling_controller,
    gpujob_controller,
    notebook_controller,
)
from kubeflow_tpu_torch.platform.apis import notebook as nbapi
from kubeflow_tpu_torch.platform.controllers import gpujob as port_job_ctrl
from kubeflow_tpu_torch.platform.controllers import notebook as port_nb_ctrl
from kubeflow_tpu_torch.platform.k8s import types as port_types
from kubeflow_tpu_torch.platform.k8s.types import (
    GPUJOB,
    LEASE,
    NOTEBOOK,
    POD,
    RESOURCEQUOTA,
    STATEFULSET,
)
from kubeflow_tpu_torch.platform.runtime import controller as port_controller
from kubeflow_tpu_torch.platform.runtime import informer as port_informer
from kubeflow_tpu_torch.platform.runtime import jobqueue as jq
from kubeflow_tpu_torch.platform.runtime import metrics
from test_torch_gpujob import gpu_words
from test_torch_gpujob import worlds as job_worlds
from test_torch_notebook import (
    GPU_KEY,
    LIBTPU_ONLY,
    NS,
    SAME_HOSTS,
    SHARED_ENV,
    TPU_KEY,
    _without_devices,
    _worlds,
    make_notebook,
)

WAIT_S = 20.0


def wait_for(fn, what, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        out = fn()
        if out:
            return out
        time.sleep(0.02)
    raise AssertionError(f"no {what} within {timeout} s")


def _status(w, name="nb"):
    return w.kube.get(w.NOTEBOOK, name, NS).get("status") or {}


def test_notebook_lifecycle_through_manager():
    """The reference's e2e case on both packages: two hosts (the port's
    16 GPUs, the reference's v5e 4x4), the StatefulSet from the watch,
    then ready pods mirrored into the status."""
    gpu, tpu = SAME_HOSTS["two-hosts"]
    ref, port = _worlds()
    kwargs = dict(use_istio=True, add_fsgroup=True, mirror_min_interval=0)
    for w, mgr_cls, make, nb in (
            (ref, RefManager, ref_nb_ctrl.make_controller,
             make_notebook(tpu=tpu)),
            (port, Manager, port_nb_ctrl.make_controller,
             make_notebook(gpu=gpu))):
        w.NOTEBOOK = ref_types.NOTEBOOK if w is ref else NOTEBOOK
        w.mgr = mgr_cls(w.kube)
        w.mgr.add(make(w.kube, **kwargs))
        w.mgr.start()
        w.kube.create(nb)
    try:
        for w in (ref, port):
            sts = wait_for(lambda: w.kube.list(
                port_types.STATEFULSET, NS), "StatefulSet")
            assert sts[0]["spec"]["replicas"] == 2
            wait_for(lambda: _status(w).get("replicas") == 2, "status")
            w.run_pods()
            wait_for(lambda: _status(w).get("readyReplicas") == 2,
                     "ready status")
    finally:
        for w in (ref, port):
            w.mgr.stop()
    assert _status(port) == _status(ref)
    assert _status(port)["conditions"][0]["status"] == "True"
    got, _ = _without_devices(port.children(), GPU_KEY,
                              SHARED_ENV | {"KFT_GPUS_PER_HOST"})
    want, _ = _without_devices(ref.children(), TPU_KEY,
                               SHARED_ENV | LIBTPU_ONLY)
    assert got == want
    assert [c.stopped for c in port.mgr.controllers] == [True]


@pytest.mark.parametrize("package", ["reference", "port"])
def test_resync_reads_informer_cache_not_apiserver(package):
    """An informer-sourced primary resyncs from the cache: no Notebook
    LIST reaches the API server after the start."""
    port = package == "port"
    ctl = port_controller if port else ref_controller
    inf_mod = port_informer if port else ref_informer
    kube = FakeKube() if port else RefKube()
    kube.add_namespace("ns")
    kube.create(make_notebook("nb") | {"metadata": {"name": "nb",
                                                     "namespace": "ns"}})
    gvk = NOTEBOOK if port else ref_types.NOTEBOOK
    lists, seen, done = [], [], threading.Event()
    orig_list = kube.list

    def counting_list(g, namespace=None, **kw):
        lists.append(g.kind)
        return orig_list(g, namespace, **kw)

    class Probe(ctl.Reconciler):
        def reconcile(self, req):
            seen.append(req)
            if len(seen) >= 3:  # the first + two resync passes
                done.set()

    c = ctl.Controller("resync-probe", Probe(), primary=gvk,
                       informers={gvk: inf_mod.Informer(kube, gvk)},
                       resync_period=0.1)
    c.start(kube)
    kube.list = counting_list   # only the lists after the start
    try:
        assert done.wait(WAIT_S), seen
        time.sleep(0.25)
    finally:
        c.stop()
        kube.list = orig_list
    assert "Notebook" not in lists, lists
    assert {(r.namespace, r.name) for r in seen} == {("ns", "nb")}


# -- the dead letter -------------------------------------------------------------


def _dead_letter_run(port):
    ctl = port_controller if port else ref_controller
    kube = FakeKube() if port else RefKube()
    kube.add_namespace(NS)
    gvk = NOTEBOOK if port else ref_types.NOTEBOOK
    fail = threading.Event()
    fail.set()
    calls = []

    class Broken(ctl.Reconciler):
        def reconcile(self, req):
            calls.append(req)
            if fail.is_set():
                raise RuntimeError("spec cannot be rendered")

    counter = ((lambda: metrics.reconcile_dead_letter_total.sample(
        controller="dl-probe") or 0) if port else
        (lambda: ref_metrics.registry.get_sample_value(
            "reconcile_dead_letter_total", {"controller": "dl-probe"}) or 0))
    before = counter()
    c = ctl.Controller("dl-probe", Broken(), primary=gvk, max_retries=2,
                       workers=1)
    c.start(kube)
    try:
        kube.create(make_notebook())
        wait_for(lambda: c.dead_letters, "dead letter")
        wait_for(lambda: len(calls) >= 4, "the condition's revival")
        time.sleep(0.3)   # parked: no more backoff retries
        parked_calls = len(calls)
        status = kube.get(gvk, "nb", NS)["status"]
        events = [{k: e.get(k) for k in ("type", "reason", "message",
                                         "involvedObject", "source",
                                         "count")}
                  for e in kube.list(port_types.EVENT, NS)]
        for e in events:
            e["involvedObject"] = {k: v for k, v in e["involvedObject"].items()
                                   if k in ("kind", "name", "namespace")}
        # A new event revives the key; a success clears the condition.
        fail.clear()
        nb = kube.get(gvk, "nb", NS)
        nb["metadata"]["annotations"] = {"touch": "1"}
        kube.update(nb)
        wait_for(lambda: not c.dead_letters, "recovery")
        wait_for(lambda: not (kube.get(gvk, "nb", NS).get("status") or {})
                 .get("conditions"), "cleared condition")
    finally:
        c.stop()
    for cond in status["conditions"]:
        assert cond.pop("lastTransitionTime")
    return (parked_calls, status, events, counter() - before,
            (kube.get(gvk, "nb", NS).get("status") or {}))


def test_dead_letter_after_max_retries_as_the_reference():
    ref, port = _dead_letter_run(False), _dead_letter_run(True)
    assert port == ref
    parked_calls, status, events, count, after = port
    # Three failures park the key; the condition's own write is a watch
    # event that tries it once more, and the re-park writes nothing.
    assert parked_calls == 4 and count == 1
    assert status == {"conditions": [{
        "type": "ReconcileFailed", "status": "True",
        "reason": "MaxRetriesExceeded",
        "message": "spec cannot be rendered"}]}
    assert [e["reason"] for e in events] == ["ReconcileFailed"]
    assert events[0]["type"] == "Warning"
    assert after == {"conditions": []}


# -- the GPUJob path under a Manager ------------------------------------------------


def _job_managers():
    """A Manager with the job controller in each world, on a quota of two
    slices; "a" (two slices) is admitted, "b" and "c" wait behind it."""
    out = []
    for w in job_worlds():
        w.kube.create(w.quota(16))
        make = (port_job_ctrl if w.port else ref_job_ctrl).make_controller
        ctrl = make(w.kube, queue_poll=0.2)
        w.mgr = (Manager if w.port else RefManager)(w.kube)
        w.mgr.add(ctrl)
        w.mgr.start()
        w.kube.create(w.make_job("a", slices=2, priority=100,
                                 created="2026-01-01T00:00:01Z"))
        wait_for(lambda: w.alloc("a") == 2, "admission of a")
        w.kube.create(w.make_job("b", slices=2, priority=100,
                                 created="2026-01-01T00:00:02Z"))
        w.kube.create(w.make_job("c", slices=1, priority=50,
                                 created="2026-01-01T00:00:03Z"))
        for name in ("b", "c"):
            wait_for(lambda: w.phase(name) == "Queued", f"{name} Queued")
        out.append(w)
    return out


def _queue_view(w):
    q = (jq if w.port else ref_jq)._debug_queue
    snap = (jq if w.port else ref_jq).debug_snapshot()
    queued = min(w.job(n)["status"]["queuedAt"] for n in ("b", "c"))
    view = {"kick": sorted(q.kick_requests()),
            "oldest": {ns: round(age, 3) for ns, age in
                       q.oldest_wait_by_namespace(now=queued + 100.0)
                       .items()},
            "snapshot": snap}
    return view if w.port else gpu_words(view)


def test_gpujob_queue_under_manager_equals_the_reference():
    ref, port = _job_managers()
    try:
        got, want = _queue_view(port), _queue_view(ref)
        assert got == want
        assert got["kick"] == [("fleet", "b"), ("fleet", "c")]
        assert got["oldest"] == {"fleet": 100.0}
        assert [w["key"] for w in got["snapshot"]["waiting"]] == [
            "fleet/b", "fleet/c"]
        assert [a["key"] for a in got["snapshot"]["admitted"]] == ["fleet/a"]
        page = metrics.render()
        assert 'gpujob_queue_oldest_wait_seconds{profile="fleet"}' in page
        # "a" ends: its delta wakes the head waiter, which takes the GPUs.
        for w in (ref, port):
            w.run_gang("a")
            wait_for(lambda: w.phase("a") == "Running", "a Running")
            w.finish_gang("a")
            wait_for(lambda: w.alloc("b") == 2, "admission of b")
            wait_for(lambda: w.phase("a") == "Succeeded", "a Succeeded")
            # c is re-queued by a kick after b's admission: its reason
            # moves from QueuedBehind to InsufficientQuota a moment after
            # b's grant is visible (2.8 ms in one traced run under load).
            wait_for(lambda: w.job("c")["status"].get("reason")
                     == "InsufficientQuota", "c re-queued on the quota")
        assert port.statuses("abc") == ref.statuses("abc")
        assert [port.phase(n) for n in "abc"] == ["Succeeded", "Pending",
                                                  "Queued"]
    finally:
        for w in (ref, port):
            w.mgr.stop()
    assert jq.debug_snapshot() is None and ref_jq.debug_snapshot() is None
    assert jq.oldest_queue_waits() is None
    assert 'gpujob_queue_oldest_wait_seconds{' not in metrics.render()


# -- the card phase's story, on the port alone ------------------------------------


class StandInKernels:
    """A kernels API's answers: busy while ``busy``, else idle since
    ``last``; every probe is counted by state."""

    def __init__(self):
        self.busy, self.last = True, "2000-01-01T00:00:00Z"
        self.probes = {"busy": 0, "idle": 0}

    def __call__(self, url):
        state = "busy" if self.busy else "idle"
        self.probes[state] += 1
        return [{"id": "k", "name": "python3", "last_activity": self.last,
                 "execution_state": state, "connections": 1}]


def test_culled_notebook_frees_its_gpu_for_the_queued_job():
    kube = FakeKube()
    for ns in ("kubeflow", "ns"):
        kube.add_namespace(ns)
    kube.add_gpu_node("n0", accelerator="h100-80gb", gpus=1)
    kube.create({"apiVersion": "v1", "kind": "ResourceQuota",
                 "metadata": {"name": "gpus", "namespace": "ns"},
                 "spec": {"hard": {"requests.nvidia.com/gpu": "1"}}})
    kernels = StandInKernels()
    culled_before = metrics.notebook_culling_total.sample()
    mgr = Manager(kube, leader_election=True, identity="smoke")
    mgr.elector.retry_seconds = 0.05
    nb_ctrl = mgr.add(notebook_controller(kube, use_istio=False))
    mgr.add(culling_controller(
        kube, notebook_informer=nb_ctrl.informers[NOTEBOOK], prober=kernels,
        idle_minutes=0.01, check_period_minutes=0.005))
    mgr.add(gpujob_controller(kube, queue_poll=0.2))
    mgr.start()
    try:
        wait_for(lambda: mgr.is_leader, "leadership")
        assert kube.get(LEASE, "kubeflow-tpu-controller-leader",
                        "kubeflow")["spec"]["holderIdentity"] == "smoke"
        kube.create({"apiVersion": "kubeflow.org/v1beta1",
                     "kind": "Notebook",
                     "metadata": {"name": "nb", "namespace": "ns"},
                     "spec": {"gpu": {"accelerator": "h100-80gb", "gpus": 1},
                              "template": {"spec": {"containers": [
                                  {"name": "nb", "image": "x"}]}}}})
        sts = wait_for(lambda: kube.list(STATEFULSET, "ns"), "StatefulSet")
        tmpl = sts[0]["spec"]["template"]
        kube.create({"apiVersion": "v1", "kind": "Pod",
                     "metadata": {"name": "nb-0", "namespace": "ns",
                                  "labels": dict(tmpl["metadata"]["labels"])},
                     "spec": tmpl["spec"]})
        kube.set_pod_phase("ns", "nb-0", "Running", ready=True)
        kube.create({"apiVersion": "kubeflow.org/v1alpha1", "kind": "GPUJob",
                     "metadata": {"name": "train", "namespace": "ns"},
                     "spec": {"gpu": {"accelerator": "h100-80gb", "gpus": 1},
                              "template": {"spec": {"containers": [{
                                  "name": "t", "image": "x",
                                  "command": ["python", "-c", "pass"]}]}}}})
        status = wait_for(lambda: (kube.get(GPUJOB, "train", "ns").get(
            "status") or {}).get("phase") == "Queued" and kube.get(
                GPUJOB, "train", "ns")["status"], "Queued job")
        assert status["reason"] == jq.REASON_QUOTA
        assert metrics.gpujob_queue_depth.sample(profile="ns") == 1
        # While busy: activity recorded, never a stop.
        wait_for(lambda: nbapi.LAST_ACTIVITY_ANNOTATION in kube.get(
            NOTEBOOK, "nb", "ns")["metadata"].get("annotations", {}),
            "last activity")
        assert not nbapi.is_stopped(kube.get(NOTEBOOK, "nb", "ns"))
        kernels.last = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
        kernels.busy = False
        wait_for(lambda: nbapi.is_stopped(kube.get(NOTEBOOK, "nb", "ns")),
                 "cull")
        wait_for(lambda: kube.get(STATEFULSET, "nb", "ns")["spec"][
            "replicas"] == 0, "scale to 0")
        assert (kube.get(GPUJOB, "train", "ns")["status"]["phase"]
                == "Queued")
        kube.delete(POD, "nb-0", "ns")   # the kubelet ends the pod
        used = kube.get(RESOURCEQUOTA, "gpus", "ns")["status"]["used"]
        assert used == {"requests.nvidia.com/gpu": "0"}
        wait_for(lambda: (kube.get(GPUJOB, "train", "ns").get("status")
                          or {}).get("allocatedSlices") == 1, "admission")
        wait_for(lambda: any(s["metadata"]["name"] == "train"
                             for s in kube.list(STATEFULSET, "ns")), "gang")
        assert jq.debug_snapshot()["admitted"][0]["key"] == "ns/train"
    finally:
        mgr.stop()
    assert all(c.stopped for c in mgr.controllers)
    assert jq.debug_snapshot() is None
    assert metrics.notebook_culling_total.sample() - culled_before == 1
    assert kernels.probes["busy"] >= 1 and kernels.probes["idle"] >= 1
    assert min(c.reconcile_count for c in mgr.controllers) >= 1
