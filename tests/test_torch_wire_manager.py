"""The port's controller runtime over the wire: one leader-elected
``Manager`` running the notebook, culling and GPUJob controllers through
``make_transport(kube, "http", watch_window=1)`` (the port's
``RestKubeClient`` against its ``HttpKubeServer``), held against the same
flow over the in-memory transport, and against the reference's
``Manager`` with its notebook, culling and TPUJob controllers over the
reference's own ``make_transport(kube, "http", watch_window=1)``.  The
flow is the card phase's: a notebook admitted, culled once its kernels
go idle, and a Queued job admitted on the accelerator it frees.  Every
child (StatefulSets, Services, pods' specs), status and event is equal
between the port's two transports, leaving out what a store mints
(``uid``, ``resourceVersion``, timestamps, the causal annotations) as
``test_torch_notebook.py`` does; against the reference, the GPU
notebook and job of one GPU are held to the TPU ones of one v5e chip
under the rules of ``test_torch_notebook.py`` and ``test_torch_gpujob.py``
(the device fields compared apart, the reference's words in the port's).
Also: ``traceparent`` carried across the wire
(``tests/ctrlplane/test_causal.py``), and a ``ShardedFleet`` of two
replicas over the wire converging 20 notebooks under the fencing
invariant with the shard filter pushed to the server.  Every wait is
bounded at 30 s."""
import copy
import json
import time
import urllib.request
from types import SimpleNamespace

from kubeflow_tpu.platform.apis import notebook as ref_nbapi
from kubeflow_tpu.platform.controllers import culling as ref_culling
from kubeflow_tpu.platform.controllers import notebook as ref_nb_ctrl
from kubeflow_tpu.platform.controllers import tpujob as ref_job_ctrl
from kubeflow_tpu.platform.k8s import types as ref_types
from kubeflow_tpu.platform.runtime import Manager as RefManager
from kubeflow_tpu.platform.runtime import jobqueue as ref_jq
from kubeflow_tpu.platform.runtime import metrics as ref_metrics
from kubeflow_tpu.platform.testing import FakeKube as RefKube
from kubeflow_tpu.platform.testing.httpkube import (
    make_transport as ref_make_transport,
)
from kubeflow_tpu_torch.platform import (
    FakeKube,
    Manager,
    culling_controller,
    gpujob_controller,
    native,
    notebook_controller,
)
from kubeflow_tpu_torch.platform.apis import notebook as nbapi
from kubeflow_tpu_torch.platform.controllers import notebook as nb_ctrl
from kubeflow_tpu_torch.platform.k8s import types as port_types
from kubeflow_tpu_torch.platform.k8s import codec
from kubeflow_tpu_torch.platform.k8s.client import RestKubeClient
from kubeflow_tpu_torch.platform.k8s.types import (
    EVENT,
    GPUJOB,
    LEASE,
    NOTEBOOK,
    POD,
    RESOURCEQUOTA,
    SERVICE,
    STATEFULSET,
)
from kubeflow_tpu_torch.platform.runtime import jobqueue as jq
from kubeflow_tpu_torch.platform.runtime import metrics
from kubeflow_tpu_torch.platform.testing.chaos import ChaosKube
from kubeflow_tpu_torch.platform.testing.httpkube import (
    HttpKubeServer,
    make_transport,
)
from kubeflow_tpu_torch.platform.testing.shardfleet import ShardedFleet
from kubeflow_tpu_torch.telemetry import causal
from test_torch_gpujob import GPU_ONLY, gpu_words
from test_torch_notebook import GPU_KEY, LIBTPU_ONLY, TPU_KEY

WAIT_S = 30.0
KINDS = ("Notebook", "GPUJob", "StatefulSet", "Service", "Pod", "Event",
         "Lease", "ResourceQuota", "Node", "PodDisruptionBudget",
         "InferenceService", "VirtualService")
CAUSAL = ("kubeflow.org/traceparent", "kubeflow.org/tracestate")
# Annotations whose values are wall-clock times.
CLOCK_ANNOTATIONS = (nbapi.LAST_ACTIVITY_ANNOTATION, nbapi.STOP_ANNOTATION)


def wait_for(fn, what, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        out = fn()
        if out:
            return out
        time.sleep(0.02)
    raise AssertionError(f"no {what} within {timeout} s")


def _clean(obj):
    """``obj`` without what a store or a clock mints: server-set metadata,
    causal stamps, owner uids, timestamps (any key naming a time), and the
    values of the culler's time annotations."""
    if isinstance(obj, list):
        return [_clean(v) for v in obj]
    if not isinstance(obj, dict):
        return obj
    out = {}
    for k, v in obj.items():
        if k in ("uid", "resourceVersion", "generation") or \
                "time" in k.lower():
            continue
        if k == "annotations":
            v = {a: ("<time>" if a in CLOCK_ANNOTATIONS else x)
                 for a, x in v.items() if a not in CAUSAL}
        out[k] = _clean(v)
    return out


class StandInKernels:
    """A kernels API's answers: busy while ``busy``, else idle since
    ``last``."""

    def __init__(self):
        self.busy, self.last = True, "2000-01-01T00:00:00Z"

    def __call__(self, url):
        state = "busy" if self.busy else "idle"
        return [{"id": "k", "name": "python3", "last_activity": self.last,
                 "execution_state": state, "connections": 1}]


def watch_counts():
    return PORT.watch_counts()


# Each package's side of the flow: its store, transport, manager and
# controllers, its device words and its job kind.
PORT = SimpleNamespace(
    Kube=FakeKube, make_transport=make_transport, Manager=Manager,
    notebook_controller=notebook_controller,
    culling_controller=culling_controller, job_controller=gpujob_controller,
    types=port_types, nbapi=nbapi, jq=jq, JOB=GPUJOB, job_kind="GPUJob",
    device="gpu", block={"accelerator": "h100-80gb", "gpus": 1},
    quota_key="requests.nvidia.com/gpu",
    add_node=lambda kube: kube.add_gpu_node("n0", accelerator="h100-80gb",
                                            gpus=1),
    stopped=lambda c: c.stopped,
    watch_counts=lambda: {
        k: metrics.rest_client_requests_total.sample(
            verb="watch", kind=k, code="200") or 0 for k in KINDS})
REF = SimpleNamespace(
    Kube=RefKube, make_transport=ref_make_transport, Manager=RefManager,
    notebook_controller=ref_nb_ctrl.make_controller,
    culling_controller=ref_culling.make_controller,
    job_controller=ref_job_ctrl.make_controller,
    types=ref_types, nbapi=ref_nbapi, jq=ref_jq, JOB=ref_types.TPUJOB,
    job_kind="TPUJob", device="tpu",
    block={"accelerator": "v5e", "topology": "1x1"},
    quota_key="requests.google.com/tpu",
    add_node=lambda kube: kube.add_tpu_node("n0", topology="1x1", chips=1),
    stopped=lambda c: c._stop.is_set(),
    watch_counts=lambda: {
        k: ref_metrics.registry.get_sample_value(
            "rest_client_requests_total",
            {"verb": "watch", "kind": k, "code": "200"}) or 0
        for k in KINDS + ("TPUJob",)})


def run_flow(transport, pkg=PORT):
    """The card phase's story on ``pkg``'s stack over ``transport``;
    returns what it left in the store, cleaned, and what the client did.
    Over the wire the flow holds, once the job is Queued, until every
    watched kind has resumed its watch twice (1 s windows), so the cull
    and the admission travel on resumed streams."""
    t = pkg.types
    kube = pkg.Kube()
    for ns in ("kubeflow", "ns"):
        kube.add_namespace(ns)
    pkg.add_node(kube)
    kube.create({"apiVersion": "v1", "kind": "ResourceQuota",
                 "metadata": {"name": "gpus", "namespace": "ns"},
                 "spec": {"hard": {pkg.quota_key: "1"}}})
    window = 1 if transport == "http" else None
    client, server = pkg.make_transport(kube, transport, watch_window=window)
    kernels = StandInKernels()
    mgr = pkg.Manager(client, leader_election=True, identity="wire")
    mgr.elector.retry_seconds = 0.05
    nb_ctrl_ = mgr.add(pkg.notebook_controller(client, use_istio=False,
                                               mirror_min_interval=0))
    mgr.add(pkg.culling_controller(
        client, notebook_informer=nb_ctrl_.informers[t.NOTEBOOK],
        prober=kernels, idle_minutes=0.01, check_period_minutes=0.005))
    mgr.add(pkg.job_controller(client, queue_poll=0.2))
    api = pkg.nbapi

    def job_status():
        return kube.get(pkg.JOB, "train", "ns").get("status") or {}

    started = pkg.watch_counts()
    try:
        mgr.start()
        wait_for(lambda: mgr.is_leader, "leadership")
        kube.create({"apiVersion": "kubeflow.org/v1beta1",
                     "kind": "Notebook",
                     "metadata": {"name": "nb", "namespace": "ns"},
                     "spec": {pkg.device: dict(pkg.block),
                              "template": {"spec": {"containers": [
                                  {"name": "nb", "image": "x"}]}}}})
        sts = wait_for(lambda: kube.list(t.STATEFULSET, "ns"), "StatefulSet")
        tmpl = sts[0]["spec"]["template"]
        kube.create({"apiVersion": "v1", "kind": "Pod",
                     "metadata": {"name": "nb-0", "namespace": "ns",
                                  "labels": dict(tmpl["metadata"]["labels"])},
                     "spec": tmpl["spec"]})
        kube.set_pod_phase("ns", "nb-0", "Running", ready=True)
        wait_for(lambda: (kube.get(t.NOTEBOOK, "nb", "ns").get("status")
                          or {}).get("readyReplicas") == 1, "ready")
        kube.create({"apiVersion": "kubeflow.org/v1alpha1",
                     "kind": pkg.job_kind,
                     "metadata": {"name": "train", "namespace": "ns"},
                     "spec": {pkg.device: dict(pkg.block),
                              "template": {"spec": {"containers": [{
                                  "name": "t", "image": "x",
                                  "command": ["python", "-c", "pass"]}]}}}})
        wait_for(lambda: job_status().get("phase") == "Queued", "Queued")
        if server is not None:
            def resumed():
                now = pkg.watch_counts()
                return all(now[k] - started[k] >= 3 for k in now
                           if now[k] > started[k]) and now != started
            wait_for(resumed, "two resumes of every watch")
        wait_for(lambda: api.LAST_ACTIVITY_ANNOTATION in kube.get(
            t.NOTEBOOK, "nb", "ns")["metadata"].get("annotations", {}),
            "last activity")
        kernels.last = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
        kernels.busy = False
        wait_for(lambda: api.is_stopped(kube.get(t.NOTEBOOK, "nb", "ns")),
                 "cull")
        wait_for(lambda: kube.get(t.STATEFULSET, "nb", "ns")["spec"][
            "replicas"] == 0, "scale to 0")
        kube.delete(t.POD, "nb-0", "ns")
        wait_for(lambda: job_status().get("allocatedSlices") == 1,
                 "admission")
        wait_for(lambda: any(s["metadata"]["name"] == "train"
                             for s in kube.list(t.STATEFULSET, "ns")), "gang")
        wait_for(lambda: (kube.get(t.NOTEBOOK, "nb", "ns").get("status")
                          or {}).get("readyReplicas", 0) == 0, "nb at rest")
        time.sleep(0.5)      # let the last status writes land
        holder = kube.get(t.LEASE, "kubeflow-tpu-controller-leader",
                          "kubeflow")["spec"]["holderIdentity"]
        queues = [type(c.queue).__name__ for c in mgr.controllers]
    finally:
        mgr.stop()
        if server is not None:
            server.stop()
    state = {
        "notebook": _clean(kube.get(t.NOTEBOOK, "nb", "ns")),
        "job": _clean(kube.get(pkg.JOB, "train", "ns")),
        "statefulsets": sorted((_clean(s) for s in
                                kube.list(t.STATEFULSET, "ns")),
                               key=lambda o: o["metadata"]["name"]),
        "services": sorted((_clean(s) for s in kube.list(t.SERVICE, "ns")),
                           key=lambda o: o["metadata"]["name"]),
        "pods": sorted((_clean(p["spec"]) for p in kube.list(t.POD, "ns")),
                       key=json.dumps),
        "quota": kube.get(t.RESOURCEQUOTA, "gpus", "ns")["status"],
        "events": sorted({(e.get("type"), e.get("reason"),
                           e["involvedObject"]["kind"],
                           e["involvedObject"]["name"], e.get("message"))
                          for e in kube.list(t.EVENT, "ns")}),
    }
    return state, {"holder": holder, "queues": queues,
                   "stopped": all(map(pkg.stopped, mgr.controllers)),
                   "queue_cleared": pkg.jq.debug_snapshot() is None}


def _device_free(state, port):
    """``state`` with the device fields of every StatefulSet's pod taken
    out (the device's limits and requests, the node selector, the
    device-only env, the job's launcher command and grace, the template
    hash) and the reference's words in the port's: what a GPU stack and a
    TPU stack of the same hosts must agree on."""
    state = copy.deepcopy(state)
    key, skip = (GPU_KEY, GPU_ONLY) if port else (TPU_KEY, LIBTPU_ONLY)
    for sts in state["statefulsets"]:
        sts["metadata"].get("annotations", {}).pop(
            nb_ctrl.HASH_ANNOTATION, None)
        pod = sts["spec"]["template"]["spec"]
        pod.pop("nodeSelector", None)
        pod.pop("terminationGracePeriodSeconds", None)
        main = pod["containers"][0]
        main.pop("command", None)
        for flavor in ("limits", "requests"):
            main.get("resources", {}).get(flavor, {}).pop(key, None)
            if not main.get("resources", {}).get(flavor, True):
                del main["resources"][flavor]
        if main.get("resources") == {}:
            del main["resources"]
        main["env"] = [e for e in main.get("env", [])
                       if e["name"] not in skip]
    for obj in (state["notebook"], state["job"]):
        obj["spec"].pop("gpu" if port else "tpu")
        obj.get("status", {}).pop("queuedAt", None)
    return state if port else gpu_words(state)


def test_manager_over_the_wire_equals_the_memory_transport():
    assert native.available(), native.load_error()
    requests = metrics.rest_client_requests_total
    verbs = ("get", "list", "watch", "create", "update", "patch",
             "patch_status", "update_status")

    def count(verb):
        return sum(requests.sample(verb=verb, kind=k, code=c) or 0
                   for k in KINDS for c in ("200", "201"))

    before = {v: count(v) for v in verbs}
    watches_before = watch_counts()
    stats = codec.stats()
    mem, mem_run = run_flow("memory")
    wire, wire_run = run_flow("http")
    after = {v: count(v) - before[v] for v in verbs}
    assert wire == mem
    assert mem_run["holder"] == wire_run["holder"] == "wire"
    assert wire_run["queues"] == ["NativeWorkQueue"] * 3
    assert mem_run["stopped"] and wire_run["stopped"]
    assert mem_run["queue_cleared"] and wire_run["queue_cleared"]
    # Every verb the flow needs went over the wire, the watches resumed
    # (1 s windows), and the wire's watch deltas took the lazy decode.
    for verb in ("get", "list", "watch", "create"):
        assert after[verb] > 0, (verb, after)
    assert after["update"] + after["patch"] + after["patch_status"] > 0
    # Each watched kind re-established its watch at least twice.
    watched = {k: n - watches_before[k] for k, n in watch_counts().items()
               if n - watches_before[k]}
    assert len(watched) >= 5 and min(watched.values()) >= 3, watched
    now = codec.stats()
    assert now["decode_native"] > stats["decode_native"]
    assert now["decode_python"] == stats["decode_python"]
    assert now["materialize"] - stats["materialize"] <= \
        now["decode_native"] - stats["decode_native"]
    assert mem["job"]["status"]["allocatedSlices"] == 1
    assert mem["notebook"]["metadata"]["annotations"][
        nbapi.STOP_ANNOTATION] == "<time>"


def test_manager_over_the_wire_equals_the_reference_over_its_wire():
    """The same flow on the reference's stack over its own wire (its
    ``RestKubeClient`` on ``requests``, its ``HttpKubeServer`` on
    werkzeug, 1 s windows): the same children, statuses and events, the
    same holder, and the flow's end state."""
    ref, ref_run = run_flow("http", REF)
    port, port_run = run_flow("http")
    got, want = _device_free(port, True), _device_free(ref, False)
    for key in want:
        assert got[key] == want[key], key
    assert port_run["holder"] == ref_run["holder"] == "wire"
    assert port_run["stopped"] and ref_run["stopped"]
    assert port_run["queue_cleared"] and ref_run["queue_cleared"]
    assert got["job"]["status"]["allocatedSlices"] == 1
    assert [s["metadata"]["name"] for s in got["statefulsets"]] == [
        "nb", "train"]


def test_traceparent_rides_the_wire():
    kube = FakeKube()
    kube.add_namespace("ns")
    client, server = make_transport(kube, "http")
    try:
        parent = causal.mint()
        with causal.use(parent):
            created = client.create({
                "apiVersion": "kubeflow.org/v1beta1", "kind": "Notebook",
                "metadata": {"name": "nb", "namespace": "ns"}, "spec": {}})
        ctx = causal.from_object(created)
        assert ctx is not None and ctx.trace_id == parent.trace_id
    finally:
        server.stop()


def test_header_only_carry_server_side_mint():
    kube = FakeKube()
    kube.add_namespace("ns")
    server = HttpKubeServer(kube).start()
    try:
        parent = causal.mint()
        body = json.dumps({
            "apiVersion": "kubeflow.org/v1beta1", "kind": "Notebook",
            "metadata": {"name": "nb", "namespace": "ns"}, "spec": {},
        }).encode()
        req = urllib.request.Request(
            server.base_url + "/apis/kubeflow.org/v1beta1/namespaces/ns/"
            "notebooks", data=body, method="POST",
            headers={"Content-Type": "application/json",
                     "traceparent": parent.to_traceparent()})
        opener = urllib.request.build_opener(
            urllib.request.ProxyHandler({}))
        opener.open(req, timeout=10).read()
        stored = kube.get(NOTEBOOK, "nb", "ns")
        assert causal.from_object(stored).trace_id == parent.trace_id
    finally:
        server.stop()


def test_create_does_not_stamp_the_callers_object():
    kube = FakeKube()
    kube.add_namespace("ns")
    client, server = make_transport(kube, "http")
    try:
        obj = {"apiVersion": "kubeflow.org/v1beta1", "kind": "Notebook",
               "metadata": {"name": "nb", "namespace": "ns"}, "spec": {}}
        before = copy.deepcopy(obj)
        created = client.create(obj)
        assert obj == before
        assert causal.from_object(created) is not None
    finally:
        server.stop()


class WireFleet(ShardedFleet):
    """A ``ShardedFleet`` whose replicas reach the store over HTTP: each
    replica's ``ChaosKube`` (the fence's wire log) wraps its own
    ``RestKubeClient`` to one ``HttpKubeServer``, whose requests are
    logged.  The coordinators' leases stay on the store, as in the
    in-memory fleet."""

    def __init__(self, **kw):
        self.server_log = []
        self._clients = []
        self._server = None
        super().__init__(**kw)

    def _replica(self, i, faults, seed):
        if self._server is None:
            self._server = HttpKubeServer(self.kube).start()
            handle = self._server.app.handle

            def logged(method, path, query, headers, body):
                self.server_log.append((method, path, query))
                return handle(method, path, query, headers, body)

            self._server.app.handle = logged
        client = RestKubeClient(self._server.base_url, qps=0)
        client.WATCH_TIMEOUT_SECONDS = 1
        self._clients.append(client)
        r = super()._replica(i, faults, seed)
        inner = ChaosKube(client, faults, seed=seed)
        r.chaos = inner
        r.client.inner = inner
        return r

    def close(self):
        try:
            super().close()
        finally:
            if self._server is not None:
                self._server.stop()


def test_sharded_fleet_over_the_wire_converges_fenced():
    fleet = WireFleet(replicas=2, lease_seconds=1.0, renew_seconds=0.1)
    try:
        fleet.wait_stable_shard_map()
        stable_at = len(fleet.server_log)
        fleet.create_wave(20)
        fleet.wait_converged(timeout=WAIT_S)
        # The 1 s windows close: every replica's Notebook watch resumes.
        wait_for(lambda: sum(
            1 for m, p, q in fleet.server_log[stable_at:]
            if p.endswith("/notebooks") and "watch=true" in q) >= 2,
            "resumed Notebook watches")
        fleet.assert_fencing_invariant()
        writes = [r.chaos.write_log for r in fleet.replicas]
        assert all(writes), "each replica wrote its own ranges"
    finally:
        fleet.close()
    # The subscriptions reached the server on list and watch alike (a
    # replica that owns no shard at a moment streams unfiltered, by
    # design: fail-open).
    notebooks = [q for m, p, q in fleet.server_log
                 if m == "GET" and p.endswith("/notebooks")]
    filtered = [q for q in notebooks if "shardFilter=" in q]
    assert any("watch=true" in q for q in filtered), notebooks
    assert any("watch=true" not in q for q in filtered), notebooks
