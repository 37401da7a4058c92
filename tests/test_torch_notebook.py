"""The port's notebook control plane (``kubeflow_tpu_torch/platform/``)
against the JAX package's: the same Notebook reconciled by the
reference's ``NotebookReconciler`` on its ``FakeKube`` and by the port's
on its own.

Without an accelerator every child is equal: the StatefulSet, the
Service, the headless Service, the PDB, the VirtualService, the status
after ready pods, the mirrored events, stop and start, an invalid
spec's ``Degraded`` status, and the version conversion.  A notebook
with ``spec.gpu`` equals the reference's TPU notebook of the same host
and slice count with the device fields taken out, and its device fields
are ``gpu/pods.py`` ``inject_gpu`` on the plain template.  Every compare
leaves out ``uid``, ``resourceVersion``, ``creationTimestamp``, the
causal annotations and the wall-clock stamps of events, and is
otherwise exact."""
import copy

import pytest

from kubeflow_tpu.platform.apis import notebook as jax_nbapi
from kubeflow_tpu.platform.controllers import notebook as jax_ctrl
from kubeflow_tpu.platform.k8s import types as jax_types
from kubeflow_tpu.platform.runtime import Request as JaxRequest
from kubeflow_tpu.platform.testing import FakeKube as JaxFakeKube
from kubeflow_tpu.platform.tpu import slice_spec as tpu_slice_spec
from kubeflow_tpu_torch.platform import FakeKube, NotebookReconciler, Request
from kubeflow_tpu_torch.platform.apis import notebook as nbapi
from kubeflow_tpu_torch.platform.controllers import notebook as ctrl
from kubeflow_tpu_torch.platform.gpu import pods, topology
from kubeflow_tpu_torch.platform.k8s.types import (
    EVENT,
    NOTEBOOK,
    POD,
    PODDISRUPTIONBUDGET,
    SERVICE,
    STATEFULSET,
    VIRTUALSERVICE,
)
from kubeflow_tpu_torch.platform.runtime import metrics

NS = "user1"
H100 = "h100-80gb"
TPU_KEY, GPU_KEY = "google.com/tpu", "nvidia.com/gpu"
CAUSAL = ("kubeflow.org/traceparent", "kubeflow.org/tracestate")
# Wall-clock fields an event carries: the two worlds stamp them a moment
# apart.
EVENT_CLOCK = ("firstTimestamp", "lastTimestamp")
KINDS = (STATEFULSET, SERVICE, PODDISRUPTIONBUDGET, VIRTUALSERVICE, EVENT)
# (port spec.gpu, reference spec.tpu) of the same hosts and slices.
SAME_HOSTS = {
    "one-gpu": ({"accelerator": H100, "gpus": 1},
                {"accelerator": "v5e", "topology": "1x1"}),
    "one-host": ({"accelerator": H100, "gpus": 8},
                 {"accelerator": "v5e", "topology": "2x4"}),
    "two-hosts": ({"accelerator": H100, "gpus": 16},
                  {"accelerator": "v5e", "topology": "4x4"}),
    "two-slices": ({"accelerator": H100, "gpus": 8, "slices": 2},
                   {"accelerator": "v5e", "topology": "2x4", "slices": 2}),
    "two-by-two": ({"accelerator": H100, "gpus": 16, "slices": 2},
                   {"accelerator": "v5e", "topology": "4x4", "slices": 2}),
}


def make_notebook(name="nb", *, gpu=None, tpu=None, annotations=None,
                  port=None, containers=None):
    main = {"name": name, "image": "jupyter:latest",
            "resources": {"requests": {"cpu": "2", "memory": "8Gi"}}}
    if port is not None:
        main["ports"] = [{"containerPort": port}]
    nb = {"apiVersion": "kubeflow.org/v1beta1", "kind": "Notebook",
          "metadata": {"name": name, "namespace": NS},
          "spec": {"template": {"spec": {
              "containers": [main] if containers is None else containers}}}}
    if gpu:
        nb["spec"]["gpu"] = gpu
    if tpu:
        nb["spec"]["tpu"] = tpu
    if annotations:
        nb["metadata"]["annotations"] = dict(annotations)
    return nb


class World:
    """One package's fake API server and reconciler."""

    def __init__(self, kube, reconciler, request):
        self.kube, self.r, self.request = kube, reconciler, request

    def reconcile(self, name="nb"):
        return self.r.reconcile(self.request(NS, name))

    def children(self):
        return {g.kind: sorted((_clean(o) for o in self.kube.list(g, NS)),
                               key=_order)
                for g in KINDS}

    def status(self, name="nb"):
        return self.kube.get(NOTEBOOK, name, NS).get("status")

    def run_pods(self, name="nb", ready=True):
        """The kubelet's half: every StatefulSet replica as a pod, marked
        (not) ready with fixed conditions and a container state."""
        for sts in self.kube.list(STATEFULSET, NS):
            tmpl = sts["spec"]["template"]
            for i in range(sts["spec"]["replicas"]):
                pod_name = f"{sts['metadata']['name']}-{i}"
                labels = dict(tmpl["metadata"]["labels"])
                labels["apps.kubernetes.io/pod-index"] = str(i)
                labels["statefulset.kubernetes.io/pod-name"] = pod_name
                try:
                    self.kube.create({
                        "apiVersion": "v1", "kind": "Pod",
                        "metadata": {"name": pod_name, "namespace": NS,
                                     "labels": labels},
                        "spec": copy.deepcopy(tmpl["spec"])})
                except Exception:   # noqa: BLE001 — the pod exists
                    pass
                pod = self.kube.get(POD, pod_name, NS)
                pod["status"] = {
                    "phase": "Running",
                    "conditions": [{
                        "type": "Ready", "status": str(ready),
                        "lastTransitionTime": "2099-01-01T00:00:00Z"}],
                    "containerStatuses": [{"name": name, "state": {
                        "running": {"startedAt": "2099-01-01T00:00:00Z"}}}]}
                self.kube.update_status(pod)

    def event(self, pod_name, reason="FailedScheduling",
              message="0/3 nodes available: insufficient accelerators",
              count=1, ts="2099-01-01T00:00:00Z"):
        return self.kube.create({
            "apiVersion": "v1", "kind": "Event",
            "metadata": {"name": f"{pod_name}.{reason.lower()}.{count}",
                         "namespace": NS},
            "involvedObject": {"kind": "Pod", "name": pod_name,
                               "namespace": NS},
            "reason": reason, "message": message, "type": "Warning",
            "count": count, "firstTimestamp": ts, "lastTimestamp": ts})


def _worlds():
    ref_kube, port_kube = JaxFakeKube(), FakeKube()
    for kube in (ref_kube, port_kube):
        kube.add_namespace(NS)
    kwargs = dict(use_istio=True, add_fsgroup=True, mirror_min_interval=0)
    return (World(ref_kube, jax_ctrl.NotebookReconciler(ref_kube, **kwargs),
                  JaxRequest),
            World(port_kube, NotebookReconciler(port_kube, **kwargs),
                  Request))


def _order(obj):
    io = obj.get("involvedObject") or {}
    return (obj["metadata"].get("name", ""), obj.get("reason", ""),
            io.get("kind", ""), io.get("name", ""))


def _clean(obj):
    """``obj`` without what the two worlds mint apart: server-set
    metadata, the causal stamps, owner uids, generated event names and
    the events' wall-clock stamps."""
    obj = copy.deepcopy(obj)
    md = obj.get("metadata", {})
    for k in ("uid", "resourceVersion", "creationTimestamp", "generation"):
        md.pop(k, None)
    if md.get("generateName"):
        md.pop("name", None)
    ann = md.get("annotations")
    if ann is not None:
        for k in CAUSAL:
            ann.pop(k, None)
    for ref in md.get("ownerReferences", []):
        ref.pop("uid", None)
    if obj.get("kind") == "Event":
        for k in EVENT_CLOCK:
            obj.pop(k, None)
        obj.get("involvedObject", {}).pop("uid", None)
        if "mirror-pass" in md.get("name", ""):
            obj.pop("count", None)
    return obj


def _both(nb_ref, nb_port=None):
    ref, port = _worlds()
    ref.kube.create(nb_ref)
    port.kube.create(nb_ref if nb_port is None else nb_port)
    return ref, port


# -- without an accelerator: every child equal ---------------------------------

PLAIN = {
    "plain": dict(),
    "port-9000": dict(port=9000),
    "routing": dict(annotations={
        nbapi.ANNOTATION_REWRITE_URI: "/lab",
        nbapi.ANNOTATION_HEADERS_REQUEST_SET: '{"X-Forwarded": "1"}'}),
    "env-and-sidecar": dict(containers=[
        {"name": "nb", "image": "j", "env": [{"name": "NB_PREFIX",
                                              "value": "/mine"}]},
        {"name": "side", "image": "s"}]),
    "long-name": dict(name="n" * 52),
}


@pytest.mark.parametrize("case", sorted(PLAIN))
def test_children_and_status_equal_the_reference(case):
    kw = dict(PLAIN[case])
    name = kw.pop("name", "nb")
    ref, port = _both(make_notebook(name, **kw))
    for w in (ref, port):
        w.reconcile(name)
    assert port.children() == ref.children()
    assert port.status(name) == ref.status(name) == {
        "readyReplicas": 0, "replicas": 1}
    for w in (ref, port):
        w.run_pods(name, ready=False)
        w.reconcile(name)
    assert port.status(name) == ref.status(name)
    for w in (ref, port):
        w.run_pods(name, ready=True)
        w.reconcile(name)
    assert port.status(name) == ref.status(name)
    assert port.status(name)["readyReplicas"] == 1
    assert port.status(name)["containerState"] == {
        "running": {"startedAt": "2099-01-01T00:00:00Z"}}
    # A second pass writes nothing new.
    before = port.children()
    port.reconcile(name)
    assert port.children() == before


def test_stop_and_start_equal_the_reference():
    ref, port = _both(make_notebook())
    for w in (ref, port):
        w.reconcile()
    for stopped in (True, False):
        for w in (ref, port):
            nb = w.kube.get(NOTEBOOK, "nb", NS)
            ann = nb["metadata"].setdefault("annotations", {})
            if stopped:
                ann[nbapi.STOP_ANNOTATION] = "2099-01-01T00:00:00Z"
            else:
                ann.pop(nbapi.STOP_ANNOTATION)
            w.kube.update(nb)
            w.reconcile()
        assert port.children() == ref.children()
        assert port.status() == ref.status()
        sts = port.kube.get(STATEFULSET, "nb", NS)
        assert sts["spec"]["replicas"] == (0 if stopped else 1)


@pytest.mark.parametrize("bad", ["no-containers", "long-name",
                                 "gpu-count", "gpu-model"])
def test_invalid_spec_is_degraded_as_the_reference(bad):
    if bad == "no-containers":
        ref_nb = port_nb = make_notebook(containers=[])
    elif bad == "long-name":
        ref_nb = port_nb = make_notebook("n" * 53)
    elif bad == "gpu-count":
        # 12 GPUs fill no whole 8-GPU host; 12 chips fill no v5e topology.
        port_nb = make_notebook(gpu={"accelerator": H100, "gpus": 12})
        ref_nb = make_notebook(tpu={"accelerator": "v5e", "topology": "3x4"})
    else:
        port_nb = make_notebook(gpu={"accelerator": "a100"})
        ref_nb = make_notebook(tpu={"accelerator": "v9"})
    ref, port = _both(ref_nb, port_nb)
    name = port_nb["metadata"]["name"]
    for w in (ref, port):
        w.reconcile(name)
        w.reconcile(name)   # a second pass writes no second event
    got, want = port.status(name), ref.status(name)
    assert [c["type"] for c in got["conditions"]] == ["Degraded"]
    assert got["conditions"][0]["reason"] == "InvalidSpec"
    if bad.startswith("gpu"):
        assert "GPU" in got["conditions"][0]["message"]
        for s in (got, want):
            s["conditions"][0].pop("message")
    assert got == want
    got, want = port.children(), ref.children()
    assert not got["StatefulSet"] and not got["Service"]
    for ev in got["Event"] + want["Event"]:
        ev.pop("message")
    assert got == want


def test_mirrored_events_equal_the_reference():
    ref, port = _both(make_notebook())
    for w in (ref, port):
        w.reconcile()
        w.event("nb-0")
        w.event("other-app-0")          # not this notebook's
        w.event("nb-0", reason="BackOff", count=3)
        w.event("nb-0", reason="Old", ts="2000-01-01T00:00:00Z")
        w.reconcile()
    got = port.children()["Event"]
    assert got == ref.children()["Event"]
    mirrored = [e for e in got if e["involvedObject"]["kind"] == "Notebook"
                and e["source"]["component"] == "notebook-controller"
                and e["reason"] != "CreatedStatefulSet"]
    assert sorted(e["reason"] for e in mirrored) == ["BackOff",
                                                     "FailedScheduling"]
    # A recurring source event bumps its mirror in place.
    for w in (ref, port):
        ev = w.kube.get(EVENT, "nb-0.backoff.3", NS)
        ev["count"] = 4
        w.kube.update(ev)
        w.reconcile()
    assert port.children()["Event"] == ref.children()["Event"]
    # The notebook goes, and so does its mirror marker.
    for w in (ref, port):
        w.kube.delete(NOTEBOOK, "nb", NS)
        w.reconcile()
    got = port.children()
    assert got == ref.children()
    assert not got["StatefulSet"] and not got["Service"]
    assert not any(e["metadata"].get("name", "").endswith(".mirror-pass")
                   for e in got["Event"])


def test_mappers_equal_the_reference():
    pods_in = [{"metadata": {"namespace": NS, "labels": labels}}
               for labels in ({nbapi.LABEL_NOTEBOOK_NAME: "nb"}, {}, None)]
    for pod in pods_in:
        assert ([tuple(vars(r).values())
                 for r in ctrl.pods_to_notebook_requests(pod)]
                == [tuple(vars(r).values())
                    for r in jax_ctrl.pods_to_notebook_requests(pod)])
    for kind, name in [("Pod", "nb-0"), ("Pod", "nb-s1-3"), ("Pod", "x"),
                       ("StatefulSet", "nb"), ("StatefulSet", "nb-s2"),
                       ("Notebook", "nb")]:
        ev = {"metadata": {"namespace": NS},
              "involvedObject": {"kind": kind, "name": name}}
        assert ([tuple(vars(r).values())
                 for r in ctrl.events_to_notebook_requests(ev)]
                == [tuple(vars(r).values())
                    for r in jax_ctrl.events_to_notebook_requests(ev)])


# -- with spec.gpu: the reference's notebook of the same hosts -----------------


def _pod_of(sts):
    return sts["spec"]["template"]["spec"]


def _without_devices(children, key, env_names):
    """``children`` with the StatefulSets' device fields taken out: the
    ``key`` limits and requests, the node selector and the env names of
    the device block; what is taken is returned beside them."""
    children = copy.deepcopy(children)
    taken = []
    for sts in children["StatefulSet"]:
        pod = _pod_of(sts)
        main = pod["containers"][0]
        taken.append({
            "limits": main["resources"]["limits"].pop(key),
            "requests": main["resources"]["requests"].pop(key),
            "nodeSelector": pod.pop("nodeSelector"),
            "env": [e for e in main["env"] if e["name"] in env_names]})
        main["env"] = [e for e in main["env"] if e["name"] not in env_names]
        if not main["resources"]["limits"]:
            del main["resources"]["limits"]
        sts["metadata"]["annotations"].pop(ctrl.HASH_ANNOTATION)
    return children, taken


LIBTPU_ONLY = {"TPU_TOPOLOGY", "TPU_ACCELERATOR_TYPE", "TPU_CHIPS_PER_HOST"}
SHARED_ENV = {"TPU_WORKER_ID", "TPU_WORKER_HOSTNAMES", "TPU_HOSTS_PER_SLICE",
              "MEGASCALE_SLICE_ID", "MEGASCALE_NUM_SLICES",
              "MEGASCALE_COORDINATOR_ADDRESS"}


@pytest.mark.parametrize("case", sorted(SAME_HOSTS))
def test_gpu_notebook_equals_the_reference_of_the_same_hosts(case):
    gpu, tpu = SAME_HOSTS[case]
    spec = topology.slice_spec(gpu["accelerator"], gpu["gpus"],
                               gpu.get("slices"))
    ref_spec = tpu_slice_spec(tpu["accelerator"], tpu["topology"],
                              tpu.get("slices"))
    assert (spec.num_hosts, spec.num_slices) == (ref_spec.num_hosts,
                                                 ref_spec.num_slices)
    ref, port = _both(make_notebook(tpu=tpu), make_notebook(gpu=gpu))
    for w in (ref, port):
        w.reconcile()
    got, got_dev = _without_devices(
        port.children(), GPU_KEY, SHARED_ENV | {"KFT_GPUS_PER_HOST"})
    want, want_dev = _without_devices(
        ref.children(), TPU_KEY, SHARED_ENV | LIBTPU_ONLY)
    assert got == want
    assert len(got["StatefulSet"]) == spec.num_slices
    assert [s["spec"]["replicas"] for s in got["StatefulSet"]] == \
        [spec.num_hosts] * spec.num_slices
    pdbs = got["PodDisruptionBudget"]
    assert ([p["spec"]["minAvailable"] for p in pdbs]
            == ([spec.total_hosts] if spec.multi_host else []))
    # The device fields: the GPU count and product, and the reference's
    # env block with KFT_GPUS_PER_HOST where libtpu's names were.
    for g, w in zip(got_dev, want_dev):
        assert g["limits"] == g["requests"] == str(spec.gpus_per_pod)
        assert g["nodeSelector"] == {
            topology.LABEL_GPU_PRODUCT: "NVIDIA-H100-80GB-HBM3"}
        ref_env = [e for e in w["env"] if e["name"] not in LIBTPU_ONLY]
        assert [e for e in g["env"] if e["name"] != "KFT_GPUS_PER_HOST"] \
            == ref_env
        assert {"name": "KFT_GPUS_PER_HOST",
                "value": str(spec.gpus_per_pod)} in g["env"]
    # Each StatefulSet's pod is inject_gpu on the plain notebook's pod.
    plain = port.r.generate_statefulset(
        port.kube.get(NOTEBOOK, "nb", NS) | {"spec": make_notebook()["spec"]})
    for s in range(spec.num_slices):
        sts = port.kube.get(STATEFULSET, pods.slice_sts_name("nb", s), NS)
        want_pod = copy.deepcopy(_pod_of(plain))
        pods.inject_gpu(want_pod, want_pod["containers"][0], ns=NS,
                        name="nb", spec=spec, slice_idx=s)
        assert _pod_of(sts) == want_pod
    # Ready pods: the status counts every host of every slice.
    for w in (ref, port):
        w.run_pods()
        w.reconcile()
    assert port.status() == ref.status()
    assert port.status()["readyReplicas"] == spec.total_hosts


def test_gpu_slices_lowered_delete_the_stale_statefulset():
    ref, port = _both(
        make_notebook(tpu=SAME_HOSTS["two-slices"][1]),
        make_notebook(gpu=SAME_HOSTS["two-slices"][0]))
    for w, block in ((ref, "tpu"), (port, "gpu")):
        w.reconcile()
        nb = w.kube.get(NOTEBOOK, "nb", NS)
        nb["spec"][block]["slices"] = 1
        w.kube.update(nb)
        w.reconcile()
    assert [s["metadata"]["name"] for s in port.kube.list(STATEFULSET, NS)] \
        == [s["metadata"]["name"] for s in ref.kube.list(STATEFULSET, NS)] \
        == ["nb"]


def test_gpu_slice_name_conflict_parks_as_the_reference():
    ref, port = _both(make_notebook("nb-s1"))
    ref.kube.create(make_notebook(tpu=SAME_HOSTS["two-slices"][1]))
    port.kube.create(make_notebook(gpu=SAME_HOSTS["two-slices"][0]))
    for w in (ref, port):
        w.reconcile("nb-s1")
        w.reconcile()
    assert port.status() == ref.status()
    assert port.status()["conditions"][0]["reason"] == "SliceNameConflict"
    assert port.children() == ref.children()


def test_budget_and_fleet_gauges_count_gpus():
    kube = FakeKube()
    kube.add_namespace(NS)
    kube.create({"apiVersion": "v1", "kind": "ResourceQuota",
                 "metadata": {"name": "gpus", "namespace": NS},
                 "spec": {"hard": {GPU_KEY: "24"}}})
    kube.create(make_notebook(gpu={"accelerator": H100, "gpus": 16}))
    kube.create(make_notebook("small", gpu={"accelerator": H100, "gpus": 2}))
    kube.create(make_notebook("off", gpu={"accelerator": H100, "gpus": 8},
                              annotations={nbapi.STOP_ANNOTATION: "t"}))
    assert nbapi.namespace_gpu_budget(kube, NS) == {
        "hard": 24, "used": 18, "remaining": 6}
    created = metrics.notebook_create_total.sample()
    r = NotebookReconciler(kube, use_istio=False)
    for name in ("nb", "small", "off"):
        r.reconcile(Request(NS, name))
    assert metrics.notebook_create_total.sample() == created + 3
    metrics.register_fleet_collector(kube)
    try:
        page = metrics.render()
    finally:
        metrics.register_fleet_collector(None)
    assert f'gpus_requested{{namespace="{NS}"}} 18.0' in page
    assert f'notebook_running{{namespace="{NS}"}} 2.0' in page
    assert "gpus_requested{" not in metrics.render()


# -- conversion -----------------------------------------------------------------


def _spoke(version, status=True, **kw):
    nb = make_notebook(**kw)
    nb["apiVersion"] = f"kubeflow.org/{version}"
    if status:
        nb["status"] = {"readyReplicas": 1, "containerState": {
            "running": {}}}
    return nb


@pytest.mark.parametrize("src", jax_nbapi.VERSIONS)
@pytest.mark.parametrize("dst", jax_nbapi.VERSIONS)
def test_conversion_equals_the_reference(src, dst):
    nb = _spoke(src, annotations={"keep": "me"})
    assert nbapi.convert(nb, dst) == jax_nbapi.convert(nb, dst)
    review = {"apiVersion": "apiextensions.k8s.io/v1",
              "kind": "ConversionReview",
              "request": {"uid": "u", "desiredAPIVersion":
                          f"kubeflow.org/{dst}", "objects": [nb]}}
    assert nbapi.convert_review(review) == jax_nbapi.convert_review(review)


def test_conversion_refusals_equal_the_reference():
    for bad in [{"request": {"uid": "u", "desiredAPIVersion":
                             "kubeflow.org/v1", "objects": [
                                 {"apiVersion": "other/v1"}]}},
                {"request": {"desiredAPIVersion": "kubeflow.org/v9",
                             "objects": [_spoke("v1")]}},
                {"request": "junk"}, "junk"]:
        assert nbapi.convert_review(bad) == jax_nbapi.convert_review(bad)


def _tpu_names(obj):
    """``obj`` with the port's GPU spellings written as the reference's
    TPU ones (the count where the topology stands, v5e for the H100)."""
    text = repr(obj)
    for a, b in [(nbapi.ANNOTATION_GPU_ACCELERATOR,
                  jax_nbapi.ANNOTATION_TPU_ACCELERATOR),
                 (nbapi.ANNOTATION_GPU_COUNT,
                  jax_nbapi.ANNOTATION_TPU_TOPOLOGY),
                 (nbapi.ANNOTATION_GPU_SLICES,
                  jax_nbapi.ANNOTATION_TPU_SLICES),
                 (GPU_KEY, TPU_KEY), (H100, "v5e")]:
        text = text.replace(repr(a), repr(b))
    return eval(text)   # noqa: S307 — a repr of plain dicts


@pytest.mark.parametrize("gpu", [
    {"accelerator": H100, "gpus": 16, "slices": 2},
    {"accelerator": H100, "gpus": 4},
    {"accelerator": H100},
    {"gpus": 16},
])
@pytest.mark.parametrize("version", ["v1", "v1alpha1"])
def test_gpu_conversion_round_trips_as_the_reference(gpu, version):
    hub = make_notebook(gpu=gpu)
    hub["status"] = {"readyReplicas": 1, "containerState": {"running": {}}}
    spoke = nbapi.convert(hub, version)
    back = copy.deepcopy(hub)
    if version == "v1alpha1":   # v1alpha1 has no containerState
        back["status"].pop("containerState")
    assert nbapi.convert(spoke, "v1beta1") == back
    # The reference's spoke of the TPU notebook of the same count has the
    # same shape, with its names.
    tpu = {"accelerator": "v5e"} if "accelerator" in gpu else {}
    if "gpus" in gpu:
        tpu["topology"] = f"{gpu['gpus']}"
    if "slices" in gpu:
        tpu["slices"] = gpu["slices"]
    ref_hub = make_notebook(tpu=tpu)
    ref_hub["status"] = hub["status"]
    want = jax_nbapi.convert(ref_hub, version)
    got = _tpu_names(spoke)
    limits = got["spec"]["template"]["spec"]["containers"][0][
        "resources"].get("limits", {})
    if "accelerator" in gpu:
        s = topology.slice_spec(H100, gpu.get("gpus"))
        assert limits.pop(TPU_KEY) == str(s.gpus_per_pod)
        want["spec"]["template"]["spec"]["containers"][0]["resources"].get(
            "limits", {}).pop(TPU_KEY, None)
    assert limits == {}
    for nb in (got, want):
        res = nb["spec"]["template"]["spec"]["containers"][0]["resources"]
        if not res.get("limits"):
            res.pop("limits", None)
    assert got == want
    # The spoke's annotations lift back, a bad count to no count.
    spoke["metadata"]["annotations"][nbapi.ANNOTATION_GPU_COUNT] = "0"
    lifted = nbapi.convert(spoke, "v1beta1")["spec"].get("gpu", {})
    assert "gpus" not in lifted


def test_crd_manifest_has_the_gpu_block():
    got, want = nbapi.crd_manifest(), jax_nbapi.crd_manifest()
    hub = {v["name"]: v for v in got["spec"]["versions"]}["v1beta1"]
    props = hub["schema"]["openAPIV3Schema"]["properties"]["spec"][
        "properties"]
    assert props.pop("gpu") == {"type": "object", "properties": {
        "accelerator": {"type": "string"},
        "gpus": {"type": "integer", "minimum": 1},
        "slices": {"type": "integer", "minimum": 1}}}
    ref_hub = {v["name"]: v for v in want["spec"]["versions"]}["v1beta1"]
    ref_hub["schema"]["openAPIV3Schema"]["properties"]["spec"][
        "properties"].pop("tpu")
    assert got == want


def test_types_equal_the_reference():
    """The GVK table and the object helpers are the reference's; the table
    has the port's GPUJob beside the reference's TPUJob."""
    from kubeflow_tpu_torch.platform.k8s import types

    want = [(g.group, g.version, g.kind, g.plural, g.namespaced)
            for g in jax_types.WELL_KNOWN]
    at = want.index(("kubeflow.org", "v1alpha1", "TPUJob", "tpujobs", True))
    want.insert(at + 1, ("kubeflow.org", "v1alpha1", "GPUJob", "gpujobs",
                         True))
    assert [(g.group, g.version, g.kind, g.plural, g.namespaced)
            for g in types.WELL_KNOWN] == want
    for kind in ["NetworkPolicy", "Ingress", "Endpoints", "Gateway", "Key"]:
        assert types.pluralize(kind) == jax_types.pluralize(kind)
    for api, kind in [("v1", "Pod"), ("x.io/v2", "Thing")]:
        assert types.gvk_for(api, kind).path("ns", "n") == \
            jax_types.gvk_for(api, kind).path("ns", "n")
    obj = {"metadata": {"name": "a", "labels": {"x": "1"}},
           "spec": {"l": [1, {"d": 2}]}}
    frozen = types.freeze(obj)
    with pytest.raises(TypeError):
        frozen["spec"]["l"].append(3)
    assert types.thaw(frozen) == obj and types.thaw(frozen) is not obj
    for ts in ["2099-01-01T00:00:00Z", "2099-01-01T00:00:00.5Z",
               "2099-01-01T00:00:00+02:00", "junk", None]:
        assert types.parse_timestamp(ts) == jax_types.parse_timestamp(ts)


# -- the runtime under the reconciler ------------------------------------------


def test_children_join_the_notebooks_journey_as_the_reference():
    """A Notebook is stamped at admission; reconciled under its context,
    every child carries the same trace id and every child write is a
    ``write_rtt`` span of the journey, in both packages."""
    from kubeflow_tpu.telemetry import causal as jax_causal
    from kubeflow_tpu_torch.telemetry import causal

    ref, port = _both(make_notebook(gpu=SAME_HOSTS["two-hosts"][0]))
    ref.kube.delete(NOTEBOOK, "nb", NS)
    ref.kube.create(make_notebook(tpu=SAME_HOSTS["two-hosts"][1]))
    journeys = []
    for w, mod in ((ref, jax_causal), (port, causal)):
        nb = w.kube.get(NOTEBOOK, "nb", NS)
        ctx = mod.from_object(nb)
        assert ctx is not None and ctx.stamped_ts is not None
        assert mod.annotations_of(nb) == {
            k: nb["metadata"]["annotations"][k] for k in CAUSAL}
        with mod.use(ctx):
            w.reconcile()
        kinds = set()
        for g in (STATEFULSET, SERVICE, PODDISRUPTIONBUDGET,
                  VIRTUALSERVICE):
            for obj in w.kube.list(g, NS):
                assert mod.from_object(obj).trace_id == ctx.trace_id
                kinds.add(g.kind)
        assert kinds == {"StatefulSet", "Service", "PodDisruptionBudget",
                         "VirtualService"}
        journeys.append(sorted(
            (s["name"], s["segment"], s["kind"], s["object"], s["ok"],
             s["parent_span_id"] == ctx.span_id)
            for s in mod.journey(ctx.trace_id)))
    assert journeys[1] == journeys[0]
    assert ("k8s.create", "write_rtt", "StatefulSet", "nb", True, True) \
        in journeys[1]
    # Only the platform's group is minted at admission.
    for obj in ({"apiVersion": "v1", "kind": "Pod"},
                {"apiVersion": "kubeflow.org/v1beta1", "kind": "Notebook"}):
        a, b = copy.deepcopy(obj), copy.deepcopy(obj)
        assert ((causal.mint_on_admission(a) is None)
                == (jax_causal.mint_on_admission(b) is None))
        assert set(causal.annotations_of(a)) == \
            set(jax_causal.annotations_of(b))


def test_event_correlation_equals_the_reference():
    """The recorder's aggregation and spam filter: the same calls on a
    fixed clock create, patch and drop the same Events."""
    from kubeflow_tpu.platform.runtime import events as jax_events
    from kubeflow_tpu_torch.platform.runtime import events

    now = [0.0]
    decisions = []
    for mod in (jax_events, events):
        c = mod.EventCorrelator(spam_burst=5, spam_refill_qps=0.5,
                                max_keys=2, now=lambda: now[0])
        out = []
        now[0] = 0.0
        for i in range(40):
            now[0] += 0.25
            # Two keys, then three over a cache of two (LRU evictions).
            pod = f"p{i % 2}" if i < 30 else f"p{i % 3}"
            key = ("ns", "Pod", pod, "", "Warning", "R", "c")
            action, rec = c.observe(key)
            if action == "create":
                c.created(key, f"e{i}")
            if i == 20:
                c.reset(key)
            out.append((action, None if rec is None else
                        (rec.event_name, rec.count)))
        decisions.append(out)
    assert decisions[1] == decisions[0]
    assert {a for a, _ in decisions[1]} == {"create", "patch", "drop"}
    ref, port = _worlds()
    for w, mod in ((ref, jax_events), (port, events)):
        rec = mod.EventRecorder(w.kube, "test", correlator=mod.EventCorrelator(
            spam_burst=3, spam_refill_qps=0.0))
        obj = {"apiVersion": "v1", "kind": "Pod",
               "metadata": {"name": "p", "namespace": NS, "uid": "u"}}
        for i in range(5):
            rec.event(obj, "Warning", "Again", f"try {i}")
    assert port.children()["Event"] == ref.children()["Event"]
    (ev,) = port.children()["Event"]
    assert (ev["count"], ev["message"]) == (3, "try 2")


def test_create_or_update_and_merge_patch_equal_the_reference():
    from kubeflow_tpu.platform.runtime import apply as jax_apply
    from kubeflow_tpu_torch.platform.runtime import apply

    pairs = [({"a": 1, "b": {"c": 2, "d": [1]}}, {"a": 1, "b": {"c": 3}}),
             ({"x": {"y": {"z": 1}}}, {"x": {"y": {"z": 1}}}),
             ({}, {"new": {"deep": None}}), ({"l": [1, 2]}, {"l": [2]})]
    for cur, want in pairs:
        assert apply.merge_patch_for(cur, want) == \
            jax_apply.merge_patch_for(cur, want)
    ref, port = _worlds()
    for w, mod in ((ref, jax_apply), (port, apply)):
        for spec in ({"replicas": 1, "keep": True}, {"replicas": 1,
                                                     "keep": True},
                     {"replicas": 2}):
            mod.create_or_update(w.kube, STATEFULSET, {
                "apiVersion": "apps/v1", "kind": "StatefulSet",
                "metadata": {"name": "s", "namespace": NS},
                "spec": dict(spec)})
    got = port.children()["StatefulSet"]
    assert got == ref.children()["StatefulSet"]
    assert got[0]["spec"] == {"replicas": 2}
