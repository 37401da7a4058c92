"""The port's InferenceService controller (``kubeflow_tpu_torch/platform/
controllers/inferenceservice.py``) and fleet sim (``testing/
servesim.py``) against the reference's, each package on its own
``FakeKube`` with its own ``InferenceFleetSim`` playing the pods.  The
reference's service serves on a v5e 2x4 slice (8 chips a replica), the
port's on 8 H100s a replica; the quota counts chips or GPUs, 1 for 1.

One script runs on both, step by step on a frozen clock: create, the
sim's pods Ready, scale up clamped by the quota, scale down after the
cooldown, scale to zero after the idle window, the wake from the
activator's annotation, a rollout held until the new revision's
``/readyz`` answers and then flipped, and the delete.  After every step
the statuses, the children (Deployments, Services, VirtualServices),
the events, the scale counters and the endpoints published to the
activator's book are equal under the GPU words.  The serving charge
parks a GPUJob on the reference's InsufficientQuota and lifts it, and
the invalid spec and its revert keep the revision record, as the
reference's.  On the port alone, ``make_controller`` under a ``Manager``
with the activator in front wakes a parked service for a held request
and replays it into the replica.  Every wait is bounded."""
import copy
import http.server
import json
import threading
import time
import urllib.request

import pytest

from kubeflow_tpu.platform import activator as ref_activator
from kubeflow_tpu.platform.apis import inferenceservice as ref_api
from kubeflow_tpu.platform.apis import tpujob as ref_jobapi
from kubeflow_tpu.platform.controllers import inferenceservice as ref_ctrl
from kubeflow_tpu.platform.controllers.tpujob import TPUJobReconciler
from kubeflow_tpu.platform.k8s import errors as ref_errors
from kubeflow_tpu.platform.k8s import types as ref_types
from kubeflow_tpu.platform.runtime import Request as RefRequest
from kubeflow_tpu.platform.runtime import metrics as ref_metrics
from kubeflow_tpu.platform.testing import FakeKube as RefKube
from kubeflow_tpu.platform.testing.servesim import (
    InferenceFleetSim as RefSim,
)
from kubeflow_tpu_torch.platform import (
    Activator,
    EndpointBook,
    FakeKube,
    InferenceFleetSim,
    Manager,
    create_activator_app,
    inferenceservice_controller,
)
from kubeflow_tpu_torch.platform.apis import gpujob as jobapi
from kubeflow_tpu_torch.platform.apis import inferenceservice as api
from kubeflow_tpu_torch.platform.controllers import inferenceservice as ctrl
from kubeflow_tpu_torch.platform.controllers.gpujob import GPUJobReconciler
from kubeflow_tpu_torch.platform.gpu import slice_spec
from kubeflow_tpu_torch.platform.k8s import errors
from kubeflow_tpu_torch.platform.k8s import types as port_types
from kubeflow_tpu_torch.platform.runtime import Request
from kubeflow_tpu_torch.platform.runtime import metrics
from kubeflow_tpu_torch.telemetry.tsdb import TSDB

NS = "serve"
WAIT_S = 20.0
SERVE_MODULE = ("kubeflow_tpu.models.serve", "kubeflow_tpu_torch.models.serve")


def gpu_words(x):
    """The reference's words as the port says them."""
    if isinstance(x, dict):
        return {gpu_words(k): gpu_words(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(gpu_words(v) for v in x)
    if not isinstance(x, str):
        return x
    for a, b in (("google.com/tpu chips", "nvidia.com/gpu GPUs"),
                 ("google.com/tpu", "nvidia.com/gpu"), SERVE_MODULE):
        x = x.replace(a, b)
    return x


def wait_for(fn, what, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        out = fn()
        if out:
            return out
        time.sleep(0.02)
    raise AssertionError(f"no {what} within {timeout} s")


class World:
    """One package's API server, fleet sim, reconciler and clock."""

    def __init__(self, port):
        self.port = port
        self.kube = FakeKube() if port else RefKube()
        self.kube.add_namespace(NS)
        self.types = port_types if port else ref_types
        self.errors = errors if port else ref_errors
        self.api = api if port else ref_api
        self.Req = Request if port else RefRequest
        self.pages = {}
        self.gate = {}   # revision -> whether its pods pass /readyz
        self.hashes = {}  # revision hash -> its order of appearance
        self.now = [1000.0]
        self.sim = (InferenceFleetSim if port else RefSim)(
            self.kube, NS, poll_seconds=0.02,
            endpoint_for=lambda svc, rev, i: f"http://{svc}-v{rev}-{i}",
            ready_gate=lambda svc, rev, i: self.gate.get(str(rev), True))
        # A reconcile reads the pods twice: the sim acts between
        # reconciles, never inside one, so both packages read the same.
        self.lock = threading.Lock()
        level = self.sim._level

        def locked_level():
            with self.lock:
                level()

        self.sim._level = locked_level
        self.book = (EndpointBook if port else ref_activator.EndpointBook)()
        self.r = (ctrl.InferenceServiceReconciler if port else
                  ref_ctrl.InferenceServiceReconciler)(
            self.kube, scraper=lambda url: self.pages.get(url),
            sync_period=0.01, now=lambda: self.now[0], book=self.book)

    def close(self):
        self.sim.close()
        assert not self.sim.errors, self.sim.errors

    def service(self, **spec):
        device = ({"gpu": {"accelerator": "h100-80gb", "gpus": 8}}
                  if self.port else
                  {"tpu": {"accelerator": "v5e", "topology": "2x4"}})
        return {"apiVersion": "kubeflow.org/v1alpha1",
                "kind": "InferenceService",
                "metadata": {"name": "llm", "namespace": NS},
                "spec": {"model": "llama_125m", **device, **spec}}

    def quota(self, n):
        key = "nvidia.com/gpu" if self.port else "google.com/tpu"
        self.kube.create({"apiVersion": "v1", "kind": "ResourceQuota",
                          "metadata": {"name": "kf-resource-quota",
                                       "namespace": NS},
                          "spec": {"hard": {key: str(n)}}})

    def reconcile(self):
        with self.lock:
            return self.r.reconcile(self.Req(NS, "llm"))

    def svc(self):
        return self.kube.get(self.types.INFERENCESERVICE, "llm", NS)

    def edit(self, fn):
        svc = copy.deepcopy(self.types.thaw(self.svc()))
        fn(svc)
        self.kube.update(svc)

    def settle(self):
        """Wait until the sim's pods match every Deployment's width and
        each pod's readiness matches its revision's gate."""
        def done():
            want = {}
            for d in self.kube.list(self.types.DEPLOYMENT, NS):
                rev = d["metadata"]["labels"][self.api.LABEL_REVISION]
                for i in range(d["spec"]["replicas"]):
                    want[f"{d['metadata']['name']}-{i}"] = self.gate.get(
                        rev, True)
            have = {p["metadata"]["name"]: self.types.pod_ready(p)
                    for p in self.kube.list(self.types.POD, NS)}
            return have == want
        wait_for(done, "the sim's pods")

    def scale_counts(self):
        out = {}
        for d in ("up", "down", "to_zero"):
            if self.port:
                v = metrics.inferenceservice_scale_events_total.sample(
                    direction=d)
            else:
                v = ref_metrics.registry.get_sample_value(
                    "inferenceservice_scale_events_total", {"direction": d})
            out[d] = v or 0.0
        for name in ("inferenceservice_cold_starts_total",
                     "inferenceservice_rollouts_total"):
            if self.port:
                v = getattr(metrics, name).values()[()]
            else:
                v = ref_metrics.registry.get_sample_value(name)
            out[name] = v or 0.0
        return out

    def view(self):
        """Everything compared, in the port's words."""
        def strip(obj):
            obj = self.types.thaw(obj)
            meta = obj["metadata"]
            keep = {k: meta[k] for k in ("name", "labels", "annotations")
                    if meta.get(k)}
            # The hash of what create_or_update wrote: of a TPU or a GPU
            # template.
            keep.get("annotations", {}).pop("kubeflow.org/generated-hash",
                                            None)
            if not keep.get("annotations"):
                keep.pop("annotations", None)
            keep["owners"] = [o["kind"] + "/" + o["name"] for o in
                              meta.get("ownerReferences", [])]
            return {**obj, "metadata": keep}

        deployments = sorted((strip(d) for d in
                              self.kube.list(self.types.DEPLOYMENT, NS)),
                             key=lambda d: d["metadata"]["name"])
        if not self.port:
            for d in deployments:
                tmpl = d["spec"]["template"]["spec"]
                # The port's replica: the GPU node selector and the
                # launcher's GPUs-a-host env (gpu/pods.py).
                tmpl["nodeSelector"] = slice_spec(
                    "h100-80gb", 8).node_selectors()
                tmpl["containers"][0]["env"].append(
                    {"name": "KFT_GPUS_PER_HOST", "value": "8"})
        events = sorted((e["reason"], e["type"], e["message"],
                         e.get("count", 1))
                        for e in self.kube.list(self.types.EVENT, NS))
        try:
            status = self.types.thaw(self.svc()).get("status")
        except self.errors.NotFound:
            status = None
        if status and "revisionHash" in status:
            # A hash of spec.tpu or spec.gpu: compared by when each
            # revision's hash first appeared.
            h = status["revisionHash"]
            status["revisionHash"] = self.hashes.setdefault(
                h, len(self.hashes))
        view = {
            "status": status,
            "deployments": deployments,
            "services": [strip(s) for s in
                         self.kube.list(self.types.SERVICE, NS)],
            "virtualservices": [strip(v) for v in self.kube.list(
                self.types.VIRTUALSERVICE, NS)],
            "events": events,
            "book": self.book.snapshot(),
        }
        return view if self.port else gpu_words(view)


@pytest.fixture
def worlds():
    made = [World(False), World(True)]
    yield made
    for w in made:
        w.close()


def page(queue=0.0, requests=0.0):
    return (f"serve_queue_depth {queue}\n"
            f'generate_requests_total{{outcome="ok"}} {requests}\n')


def step(worlds, fn=None):
    """Run ``fn(world)`` on both, reconcile, let the sims settle, and
    compare; returns the port's view."""
    before = [w.scale_counts() for w in worlds]
    for w in worlds:
        if fn is not None:
            fn(w)
        w.reconcile()
        w.settle()
    views = [w.view() for w in worlds]
    counts = [{k: v - b[k] for k, v in w.scale_counts().items()}
              for w, b in zip(worlds, before)]
    assert views[0] == views[1]
    assert counts[0] == counts[1]
    return views[1], counts[1]


def test_lifecycle_equals_the_reference(worlds):
    def create(w):
        w.quota(24)
        w.kube.create(w.service(
            replicas={"min": 0, "max": 4, "initial": 1},
            scale={"idleSeconds": 60.0, "cooldownSeconds": 10.0}))

    view, _ = step(worlds, create)
    assert view["status"]["phase"] == "Pending"
    assert view["book"]["serve/llm"]["endpoints"] == []
    view, _ = step(worlds)
    assert view["status"]["phase"] == "Ready"
    assert view["book"]["serve/llm"]["endpoints"] == ["http://llm-v1-0"]

    def busy(w):
        w.pages["http://llm-v1-0/metrics"] = page(queue=20.0, requests=5.0)

    # ceil(1 * 20/4) = 5, max 4, and 24 GPUs pay for 3: clamped.
    view, counts = step(worlds, busy)
    assert view["status"]["replicas"] == 3
    assert view["status"]["reason"] == api.REASON_QUOTA_CLAMPED
    assert counts["up"] == 1
    assert any(e[0] == "QuotaClamped" and "nvidia.com/gpu GPUs" in e[2]
               for e in view["events"])
    view, _ = step(worlds)
    assert view["status"]["phase"] == "Ready"

    def calm(w):
        w.now[0] += 11.0
        for i in range(3):
            w.pages[f"http://llm-v1-{i}/metrics"] = page(requests=9.0)

    view, counts = step(worlds, calm)
    assert view["status"]["replicas"] == 1 and counts["down"] == 1

    def idle(w):
        w.now[0] += 61.0

    view, counts = step(worlds, idle)
    assert view["status"]["phase"] == "Idle"
    assert view["status"]["replicas"] == 0 and counts["to_zero"] == 1
    assert view["book"]["serve/llm"]["phase"] == "Idle"
    # The next pass, after the sim drained the pod, publishes none.
    view, _ = step(worlds)
    assert view["book"]["serve/llm"] == {
        "endpoints": [], "ttftTargetSeconds": None, "phase": "Idle"}

    def wake(w):
        w.now[0] += 5.0
        w.edit(lambda s: s["metadata"].setdefault("annotations", {}).update(
            {w.api.ANNOTATION_WAKE: f"{w.now[0] - 1.0:.3f}"}))

    view, counts = step(worlds, wake)
    assert view["status"]["phase"] == "Waking"
    assert counts["inferenceservice_cold_starts_total"] == 1
    view, _ = step(worlds)
    assert view["status"]["phase"] == "Ready"

    def roll(w):
        w.gate["2"] = False
        w.edit(lambda s: s["spec"].update(checkpointDir="/ckpt/new"))

    view, counts = step(worlds, roll)
    assert view["status"]["phase"] == "Rolling"
    assert [d["metadata"]["name"] for d in view["deployments"]] == [
        "llm-v1", "llm-v2"]
    assert counts["inferenceservice_rollouts_total"] == 1
    view, _ = step(worlds)  # revision 2's pod not ready: no flip
    assert view["services"][0]["spec"]["selector"][api.LABEL_REVISION] == "1"

    def ready2(w):
        w.gate["2"] = True
        w.pages["http://llm-v2-0/readyz"] = '{"ready": true}'
        w.settle()

    view, _ = step(worlds, ready2)
    assert view["services"][0]["spec"]["selector"][api.LABEL_REVISION] == "2"
    assert [d["metadata"]["name"] for d in view["deployments"]] == ["llm-v2"]
    assert any(e[0] == "RolloutComplete" for e in view["events"])

    def delete(w):
        w.kube.delete(w.types.INFERENCESERVICE, "llm", NS)

    view, _ = step(worlds, delete)
    assert view["status"] is None and view["book"] == {}
    assert view["deployments"] == []


def test_serving_charge_parks_a_gpujob_as_the_reference(worlds):
    """3 replicas hold 24 of 32 GPUs: a 2-slice job of 8 a slice waits
    on InsufficientQuota; one replica lifts it."""
    out = []
    for w in worlds:
        w.quota(32)
        w.kube.create(w.service(replicas={"min": 3, "max": 3}))
        w.reconcile()
        w.settle()
        job = {"apiVersion": "kubeflow.org/v1alpha1",
               "metadata": {"name": "train", "namespace": NS}}
        if w.port:
            job["kind"] = "GPUJob"
            job["spec"] = {"gpu": {"accelerator": "h100-80gb", "gpus": 8,
                                   "slices": 2},
                           "template": {"spec": {"containers": [
                               {"name": "w", "command": ["train"]}]}}}
            jr, kind, japi = GPUJobReconciler(w.kube), w.types.GPUJOB, jobapi
        else:
            job["kind"] = "TPUJob"
            job["spec"] = {"tpu": {"accelerator": "v5e", "topology": "2x4",
                                   "slices": 2},
                           "template": {"spec": {"containers": [
                               {"name": "w"}]}}}
            jr, kind, japi = (TPUJobReconciler(w.kube), w.types.TPUJOB,
                              ref_jobapi)
        w.kube.create(job)
        jr.reconcile(w.Req(NS, "train"))
        parked = w.kube.get(kind, "train", NS)
        w.edit(lambda s: s["spec"].update(
            replicas={"min": 1, "max": 1, "initial": 1}))
        w.reconcile()
        w.settle()  # the surplus pods' GPUs are free once they are gone
        jr.reconcile(w.Req(NS, "train"))
        out.append((japi.phase_of(parked),
                    parked["status"].get("reason"),
                    japi.allocated_slices(w.kube.get(kind, "train", NS)),
                    w.view()["status"]))
    assert out[0] == out[1]
    assert out[1][:3] == ("Queued", "InsufficientQuota", 2)


@pytest.mark.parametrize("bad", [
    {"quantize": "int4"}, {"replicas": {"min": 3, "max": 2}},
    {"port": 0}, {"scale": {"idleSeconds": -1}}])
def test_invalid_spec_and_revert_equal_the_reference(worlds, bad):
    step(worlds, lambda w: w.kube.create(w.service(
        replicas={"min": 1, "max": 2})))
    view, _ = step(worlds, lambda w: w.edit(lambda s: s["spec"].update(bad)))
    assert view["status"]["conditions"][0]["reason"] == "InvalidSpec"
    assert view["status"]["revision"] == 1

    def revert(w):
        def fix(s):
            for k in bad:
                s["spec"].pop(k)
        w.edit(fix)

    view, _ = step(worlds, revert)
    assert view["status"]["revision"] == view["status"]["targetRevision"] == 1


# -- the front door under a Manager, on the port ------------------------------


class Replica:
    """A stand-in model server: /readyz, /metrics and /v1/generate."""

    def __init__(self):
        self.generated = []
        replica = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def _reply(self, status, body, ctype="application/json"):
                data = body.encode()
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/readyz":
                    self._reply(200, '{"ready": true}')
                elif self.path == "/metrics":
                    self._reply(200, page(requests=len(replica.generated)),
                                "text/plain")
                else:
                    self._reply(404, "{}")

            def do_POST(self):
                body = self.rfile.read(int(self.headers["Content-Length"]))
                replica.generated.append(json.loads(body))
                self._reply(200, json.dumps({"tokens": [[7, 8, 9]]}))

            def log_message(self, *args):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                      Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        threading.Thread(target=self.server.serve_forever,
                         kwargs={"poll_interval": 0.05}, daemon=True).start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


def test_a_held_request_wakes_a_parked_service_under_a_manager():
    """Parked at zero, a request through the activator is held and
    stamps the wake; the controller scales to 1, the sim's pod passes
    the replica's /readyz, the endpoint is published and the request
    replays into the replica; idle again, the service parks."""
    kube = FakeKube()
    kube.add_namespace("kubeflow")
    kube.add_namespace(NS)
    replica = Replica()
    book, tsdb = EndpointBook(), TSDB()
    sim = InferenceFleetSim(kube, NS, poll_seconds=0.02,
                            endpoint_for=lambda *a: replica.url)
    mgr = Manager(kube)
    mgr.add(inferenceservice_controller(kube, book=book, tsdb=tsdb,
                                        sync_period=0.1))
    front = create_activator_app(Activator(kube, book=book, tsdb=tsdb))
    server = front.make_server("127.0.0.1", 0)
    threading.Thread(target=server.serve_forever,
                     kwargs={"poll_interval": 0.05}, daemon=True).start()
    mgr.start()
    try:
        kube.create({"apiVersion": "kubeflow.org/v1alpha1",
                     "kind": "InferenceService",
                     "metadata": {"name": "llm", "namespace": NS},
                     "spec": {"model": "llama3_8b",
                              "gpu": {"accelerator": "h100-80gb", "gpus": 1},
                              "replicas": {"min": 0, "max": 1, "initial": 0},
                              "scale": {"idleSeconds": 1.0}}})
        wait_for(lambda: (kube.get(port_types.INFERENCESERVICE, "llm", NS)
                          .get("status") or {}).get("phase") == "Idle",
                 "the parked service")
        assert kube.list(port_types.POD, NS) == []
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}"
            f"/serve/{NS}/llm/v1/generate",
            data=json.dumps({"tokens": [[1, 2]]}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=WAIT_S) as r:
            assert json.load(r) == {"tokens": [[7, 8, 9]]}
        assert replica.generated == [{"tokens": [[1, 2]]}]
        svc = kube.get(port_types.INFERENCESERVICE, "llm", NS)
        assert api.ANNOTATION_WAKE in svc["metadata"]["annotations"]
        assert metrics.activator_proxy_requests_total.sample(
            outcome="replayed") >= 1
        wait_for(lambda: (kube.get(port_types.INFERENCESERVICE, "llm", NS)
                          ["status"]["phase"] == "Idle"
                          and not kube.list(port_types.POD, NS)),
                 "the service parked again")
        reasons = {e["reason"] for e in kube.list(port_types.EVENT, NS)}
        assert {"Scaled"} <= reasons
    finally:
        mgr.stop()
        server.shutdown()
        server.server_close()
        sim.close()
        replica.close()
    assert not sim.errors
