"""The port's GPU job path (``kubeflow_tpu_torch/platform/``'s
``GPUJobReconciler``, its queue and ``GpuJobGangSim``) against the JAX
package's TPUJob path: the same script of jobs, nodes and quotas run by
the reference's ``TPUJobReconciler`` on its ``FakeKube`` and by the
port's on its own.

A v5e host holds 8 chips and an H100 host 8 GPUs, so the reference's
``2x4`` slice is the port's 8 GPUs, ``4x4`` is 16 GPUs (two hosts) and
``2x2`` is 4 GPUs on nodes of 4.  The reference's words are mapped to the
port's (``tpu`` to ``gpu``, chips to GPUs, pool names), and every compare
leaves out ``uid``, ``resourceVersion``, ``creationTimestamp``, the causal
annotations, generated event names and the wall-clock stamps.  The
StatefulSets' device fields (the device request, the node selector, the
device env names, the command under the launcher) are compared apart:
the port's pod is ``gpu/pods.py`` ``job_worker_container`` on the plain
template, whose node selector gains its pool's GPU count (the
reference's pod selects its pool's topology).  The one other
difference, the pod grace, is checked in each test.  Statuses, children and events are otherwise equal step by step.

Also here: the repair of the preempted job's drain (the grace every layer
keeps, the one-copy sharded snapshot), the worker env's round trip to the
port's ``parallel/dist.py`` grid, and a gang that trains with the port's
``train_loop``, is preempted, resumes from its checkpoint and ends with
an unbroken run's losses."""
import copy
import threading
import time
import types

import pytest
import torch

from kubeflow_tpu.platform.apis import tpujob as ref_api
from kubeflow_tpu.platform.controllers import tpujob as ref_ctrl
from kubeflow_tpu.platform.k8s import errors as ref_errors
from kubeflow_tpu.platform.k8s import types as ref_types
from kubeflow_tpu.platform.runtime import Request as RefRequest
from kubeflow_tpu.platform.runtime import jobqueue as ref_jq
from kubeflow_tpu.platform.testing import FakeKube as RefKube
from kubeflow_tpu_torch.parallel import launch
from kubeflow_tpu_torch.platform import (
    FakeKube,
    GPUJobReconciler,
    GpuJobGangSim,
    Request,
)
from kubeflow_tpu_torch.platform.apis import gpujob as jobapi
from kubeflow_tpu_torch.platform.controllers import gpujob as ctrl
from kubeflow_tpu_torch.platform.gpu import pods
from kubeflow_tpu_torch.platform.k8s import errors
from kubeflow_tpu_torch.platform.k8s import types as port_types
from kubeflow_tpu_torch.platform.k8s.types import (
    EVENT,
    GPUJOB,
    POD,
    SERVICE,
    STATEFULSET,
)
from kubeflow_tpu_torch.platform.runtime import jobqueue as jq

H100 = "h100-80gb"
TPU_KEY, GPU_KEY = "google.com/tpu", "nvidia.com/gpu"
# The reference's v5e topology -> the GPUs of a slice of the same hosts,
# and the GPUs of one node of that slice's pool.
GPUS = {"1x1": 1, "2x2": 4, "2x4": 8, "4x4": 16}
NODE_GPUS = {"1x1": 1, "2x2": 4, "2x4": 8, "4x4": 8}
POOLS = {"v5e/1x1": "h100-80gb/1", "v5e/2x2": "h100-80gb/4",
         "v5e/2x4": "h100-80gb/8", "v5e/4x4": "h100-80gb/8"}
CAUSAL = ("kubeflow.org/traceparent", "kubeflow.org/tracestate")
# The env names only libtpu reads, and the one only the GPU pod has.
LIBTPU_ONLY = {"TPU_TOPOLOGY", "TPU_ACCELERATOR_TYPE", "TPU_CHIPS_PER_HOST"}
GPU_ONLY = {"KFT_GPUS_PER_HOST"}
TRAIN_COMMAND = ["python", "-m", "kubeflow_tpu.train.run"]


# -- the two worlds ------------------------------------------------------------


def gpu_words(x):
    """The reference's words as the port says them, in every string and
    key of ``x``."""
    if isinstance(x, dict):
        return {gpu_words(k): gpu_words(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(gpu_words(v) for v in x)
    if not isinstance(x, str):
        return x
    for a, b in (("google.com/tpu", "nvidia.com/gpu"),
                 ("tpujob", "gpujob"), ("TPUJob", "GPUJob"),
                 ("chipsPerSlice", "gpusPerSlice"), ("Chips", "Gpus"),
                 ("chips", "GPUs"), *POOLS.items()):
        x = x.replace(a, b)
    return x


class World:
    """One package's fake API server, job kind and reconciler."""

    def __init__(self, port, ns="fleet"):
        self.port = port
        self.ns = ns
        self.kube = FakeKube() if port else RefKube()
        self.kube.add_namespace(ns)
        self.api = jobapi if port else ref_api
        self.jq = jq if port else ref_jq
        self.errors = errors if port else ref_errors
        self.types = port_types if port else ref_types
        self.JOB = GPUJOB if port else ref_types.TPUJOB
        self.label = (jobapi.LABEL_GPUJOB_NAME if port
                      else ref_api.LABEL_TPUJOB_NAME)
        self.Reconciler = (GPUJobReconciler if port
                           else ref_ctrl.TPUJobReconciler)
        self.Request = Request if port else RefRequest
        self.device_key = GPU_KEY if port else TPU_KEY
        # The reconcilers' arguments (a queue test's short grace and poll).
        self.defaults = {}

    # -- objects

    def make_job(self, name, ns=None, *, slices=1, min_slices=None,
                 priority=None, topology="2x4", backoff_limit=None,
                 restart_policy=None, created=None, checkpoint_dir=None):
        if self.port:
            block = {"accelerator": H100, "gpus": GPUS[topology],
                     "slices": slices}
        else:
            block = {"accelerator": "v5e", "topology": topology,
                     "slices": slices}
        if min_slices is not None:
            block["minSlices"] = min_slices
        spec = {"gpu" if self.port else "tpu": block,
                "template": {"spec": {"containers": [{
                    "name": "worker", "image": "trainer",
                    "command": list(TRAIN_COMMAND)}]}}}
        for key, val in (("priority", priority),
                         ("backoffLimit", backoff_limit),
                         ("restartPolicy", restart_policy),
                         ("checkpointDir", checkpoint_dir)):
            if val is not None:
                spec[key] = val
        job = {"apiVersion": "kubeflow.org/v1alpha1",
               "kind": "GPUJob" if self.port else "TPUJob",
               "metadata": {"name": name, "namespace": ns or self.ns},
               "spec": spec}
        if created is not None:
            job["metadata"]["creationTimestamp"] = created
        return job

    def quota(self, n, ns=None):
        return {"apiVersion": "v1", "kind": "ResourceQuota",
                "metadata": {"name": "kf-resource-quota",
                             "namespace": ns or self.ns},
                "spec": {"hard": {self.device_key: str(n)}}}

    def node(self, name, topology="2x4"):
        if self.port:
            return {"apiVersion": "v1", "kind": "Node",
                    "metadata": {"name": name, "labels": {
                        "nvidia.com/gpu.product": "NVIDIA-H100-80GB-HBM3",
                        "nvidia.com/gpu.count": str(NODE_GPUS[topology])}},
                    "status": {"capacity": {
                        GPU_KEY: str(NODE_GPUS[topology])}}}
        return {"apiVersion": "v1", "kind": "Node",
                "metadata": {"name": name, "labels": {
                    "cloud.google.com/gke-tpu-accelerator":
                        "tpu-v5-lite-podslice",
                    "cloud.google.com/gke-tpu-topology": topology}},
                "status": {"capacity": {TPU_KEY: str(NODE_GPUS[topology])}}}

    def add_nodes(self, n, topology="2x4", prefix="node"):
        for i in range(n):
            self.kube.create(self.node(f"{prefix}-{i + 1}", topology))

    def slice_sts_name(self, name, s):
        return self.Reconciler.slice_sts_name(name, s)

    # -- the controller

    def reconciler(self, **kwargs):
        return self.Reconciler(self.kube, **{**self.defaults, **kwargs})

    def reconcile(self, name, ns=None, **kwargs):
        return self.reconciler(**kwargs).reconcile(
            self.Request(ns or self.ns, name))

    def drive(self, names, rounds=6, **kwargs):
        for _ in range(rounds):
            for name in names:
                self.reconcile(name, **kwargs)

    def job(self, name, ns=None):
        return self.kube.get(self.JOB, name, ns or self.ns)

    def phase(self, name):
        return self.api.phase_of(self.job(name))

    def alloc(self, name):
        return self.api.allocated_slices(self.job(name))

    def worker_pods(self, name):
        return self.kube.list(self.types.POD, self.ns,
                              label_selector={self.label: name})

    def finish_gang(self, name, phase="Succeeded"):
        """Kubelet-sim: every worker pod of the job exits."""
        for pod in self.worker_pods(name):
            self.kube.set_pod_phase(self.ns, pod["metadata"]["name"], phase,
                                    ready=False)

    def run_gang(self, name):
        """Kubelet-sim: every expected worker pod Running and ready."""
        job = self.job(name)
        k = self.api.allocated_slices(job)
        if k is None:
            k = (job["spec"]["gpu" if self.port else "tpu"].get("slices")
                 or 1)
        for s in range(k):
            sts = self.kube.get(self.types.STATEFULSET,
                                self.slice_sts_name(name, s), self.ns)
            tmpl = sts["spec"]["template"]
            for i in range(sts["spec"]["replicas"]):
                pod_name = f"{sts['metadata']['name']}-{i}"
                try:
                    self.kube.create({
                        "apiVersion": "v1", "kind": "Pod",
                        "metadata": {"name": pod_name, "namespace": self.ns,
                                     "labels": dict(tmpl["metadata"]
                                                    ["labels"])},
                        "spec": copy.deepcopy(tmpl["spec"])})
                except self.errors.AlreadyExists:
                    pass
                self.kube.set_pod_phase(self.ns, pod_name, "Running",
                                        ready=True)

    # -- what is compared

    def statuses(self, names):
        out = {}
        for name in names:
            status = copy.deepcopy(self.job(name).get("status") or {})
            status.pop("queuedAt", None)
            for intent in ("preemption", "resize"):
                if intent in status:
                    status[intent].pop("at", None)
            out[name] = status
        return out if self.port else gpu_words(out)

    def children(self):
        out = {}
        for kind in ("STATEFULSET", "SERVICE", "EVENT"):
            gvk = getattr(self.types, kind)
            objs = [_clean(o) for o in self.kube.list(gvk, self.ns)]
            if kind == "STATEFULSET":
                objs = [self._without_devices(o)
                        if self.label in o["metadata"].get("labels", {})
                        else o for o in objs]
            out[gvk.kind] = sorted(
                objs if self.port else gpu_words(objs), key=_order)
        out["Pod"] = sorted(
            (p["metadata"]["name"], (p.get("status") or {}).get("phase"))
            for p in self.kube.list(self.types.POD, self.ns))
        return out

    def view(self, names):
        return {"status": self.statuses(names), **self.children()}

    def _without_devices(self, sts):
        """``sts`` without its pod's device fields.  The port's are held
        here to ``job_worker_container`` on the plain template, the job's
        grace and its pool's GPU count in the node selector."""
        pod = sts["spec"]["template"]["spec"]
        main = pod["containers"][0]
        if self.port:
            assert pod.pop("terminationGracePeriodSeconds") == \
                pods.JOB_GRACE_S
            job = self.job(sts["metadata"]["labels"][self.label])
            assert pod["nodeSelector"].pop("nvidia.com/gpu.count") == \
                str(jobapi.gpu_slice(job).gpus_per_pod)
            want = copy.deepcopy(job["spec"]["template"]["spec"])
            pods.job_worker_container(
                want, ns=self.ns, name=job["metadata"]["name"],
                spec=jobapi.gpu_slice(job),
                slice_idx=int(main["env"][[e["name"] for e in main["env"]]
                                         .index("MEGASCALE_SLICE_ID")]
                              ["value"]),
                num_slices=int({e["name"]: e.get("value")
                                for e in main["env"]}["MEGASCALE_NUM_SLICES"]),
                checkpoint_dir=jobapi.checkpoint_dir(job))
            assert pod == want
            assert main["command"] == pods.LAUNCHER + TRAIN_COMMAND
        for flavor in ("limits", "requests"):
            main["resources"][flavor].pop(self.device_key)
            if not main["resources"][flavor]:
                del main["resources"][flavor]
        if not main["resources"]:
            del main["resources"]
        pod.pop("nodeSelector")
        main.pop("command")
        skip = GPU_ONLY if self.port else LIBTPU_ONLY
        main["env"] = [e for e in main["env"] if e["name"] not in skip]
        return sts


def _clean(obj):
    """``obj`` without what the two worlds mint apart."""
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
        for k in ("firstTimestamp", "lastTimestamp"):
            obj.pop(k, None)
        obj.get("involvedObject", {}).pop("uid", None)
    return obj


def _order(obj):
    io = obj.get("involvedObject") or {}
    return (obj["metadata"].get("name", ""), io.get("name", ""),
            obj.get("reason", ""), obj.get("message", ""))


def worlds(ns="fleet"):
    return World(False, ns), World(True, ns)


def same(ref, port, names):
    """The two worlds' statuses and children, equal."""
    got, want = port.view(names), ref.view(names)
    for key in want:
        assert got[key] == want[key], key
    return got


# -- gang creation ---------------------------------------------------------------

JOBS_NS = "jobs"
# (reference topology, slices, nodes): one slice of one host, two slices
# of two hosts, three slices of one host.
GANGS = {"one-slice": ("2x4", 1, 1), "two-by-two-hosts": ("4x4", 2, 4),
         "three-slices": ("2x4", 3, 3)}


def _gang_worlds(case, **job_kw):
    topo, slices, nodes = GANGS[case]
    ref, port = worlds(JOBS_NS)
    for w in (ref, port):
        w.add_nodes(nodes, topo)
        w.kube.create(w.make_job("tjob", topology=topo, slices=slices,
                                 **job_kw))
    return ref, port


@pytest.mark.parametrize("case", sorted(GANGS))
def test_gang_and_coordinator_service_equal_the_reference(case):
    ref, port = _gang_worlds(case)
    for w in (ref, port):
        w.reconcile("tjob")
    got = same(ref, port, ["tjob"])
    _topo, slices, _ = GANGS[case]
    spec = jobapi.gpu_slice(port.job("tjob"))
    assert [s["metadata"]["name"] for s in got["StatefulSet"]] == \
        sorted(pods.slice_sts_name("tjob", s) for s in range(slices))
    for s in range(slices):
        sts = port.kube.get(STATEFULSET, pods.slice_sts_name("tjob", s),
                            JOBS_NS)
        assert sts["spec"]["replicas"] == spec.num_hosts
        assert sts["spec"]["podManagementPolicy"] == "Parallel"
        assert sts["metadata"]["ownerReferences"][0]["kind"] == "GPUJob"
        labels = sts["spec"]["template"]["metadata"]["labels"]
        assert labels == {"statefulset": sts["metadata"]["name"],
                          "gpujob-name": "tjob", "gpujob-worker": "true",
                          "gpujob-generation": "0"}
        pod = sts["spec"]["template"]["spec"]
        main = pod["containers"][0]
        assert main["resources"]["limits"][GPU_KEY] == \
            str(spec.gpus_per_pod)
        assert pod["terminationGracePeriodSeconds"] == pods.JOB_GRACE_S
        env = {e["name"]: e.get("value") for e in main["env"]}
        assert env["MEGASCALE_SLICE_ID"] == str(s)
        assert env["MEGASCALE_NUM_SLICES"] == str(slices)
    svc = port.kube.get(SERVICE, "tjob-workers", JOBS_NS)
    assert svc["spec"]["clusterIP"] == "None"
    assert svc["spec"]["publishNotReadyAddresses"] is True
    assert svc["spec"]["selector"] == {"gpujob-name": "tjob"}
    assert port.statuses(["tjob"])["tjob"]["phase"] == "Pending"
    assert port.statuses(["tjob"])["tjob"]["slices"] == [
        {"slice": s, "ready": 0, "total": spec.num_hosts}
        for s in range(slices)]


def test_checkpoint_dir_rides_as_kft_env():
    ref, port = _gang_worlds("two-by-two-hosts", checkpoint_dir="/ckpt/run1")
    for w in (ref, port):
        w.reconcile("tjob")
    same(ref, port, ["tjob"])
    sts = port.kube.get(STATEFULSET, "tjob", JOBS_NS)
    env = {e["name"]: e.get("value") for e in
           sts["spec"]["template"]["spec"]["containers"][0]["env"]}
    assert env["KFT_CHECKPOINT_DIR"] == "/ckpt/run1"


def test_worker_env_reaches_the_ports_dist_grid(monkeypatch):
    """The drift pin: the env the controller injects, read back by the
    port's ``parallel/dist.py``, gives the reference's grid, slice-major,
    and the launcher's node rank."""
    from kubeflow_tpu.parallel import dist as ref_dist
    from kubeflow_tpu_torch.parallel import dist

    ref, port = _gang_worlds("two-by-two-hosts")
    grids = []
    for w, d in ((ref, ref_dist), (port, dist)):
        sts = w.reconciler().generate_statefulset(w.job("tjob"), slice_idx=1,
                                                  generation=0)
        for e in sts["spec"]["template"]["spec"]["containers"][0]["env"]:
            if "value" in e:
                monkeypatch.setenv(e["name"], e["value"])
        monkeypatch.setenv("TPU_WORKER_ID", "1")   # the pod-index fieldRef
        env = d.worker_env()
        assert env["num_slices"] == "2" and env["slice_id"] == "1"
        assert env["hostnames"].split(",") == [
            "tjob-s1-0.tjob-workers.jobs.svc.cluster.local",
            "tjob-s1-1.tjob-workers.jobs.svc.cluster.local"]
        grids.append(d.process_grid())
    assert grids[1] == grids[0] == (
        "tjob-0.tjob-workers.jobs.svc.cluster.local:8476", 4, 1 * 2 + 1)
    main = sts["spec"]["template"]["spec"]["containers"][0]
    assert launch.gpus_per_host(
        {e["name"]: e.get("value") for e in main["env"]}) == 8
    grid = launch.launch_grid(dist.worker_env(), 8)
    assert grid == ("tjob-0.tjob-workers.jobs.svc.cluster.local", 8476,
                    4, 3, 8)
    assert [e["RANK"] for e in launch.worker_envs(grid)] == \
        [str(3 * 8 + r) for r in range(8)]


# -- invalid specs ----------------------------------------------------------------


@pytest.mark.parametrize("bad", ["topology", "priority"])
def test_invalid_spec_parks_degraded_as_the_reference(bad):
    ref, port = worlds(JOBS_NS)
    for w in (ref, port):
        w.add_nodes(4, "4x4")
        job = w.make_job("bad", topology="4x4", slices=2)
        if bad == "priority":
            job["spec"]["priority"] = 0
        elif w.port:
            job["spec"]["gpu"]["gpus"] = 12     # fills no whole host
        else:
            job["spec"]["tpu"]["topology"] = "3x3"
        w.kube.create(job)
        w.reconcile("bad")
        w.reconcile("bad")      # a second pass writes no second event
    got, want = port.view(["bad"]), ref.view(["bad"])
    cond = got["status"]["bad"]["conditions"][0]
    assert (cond["type"], cond["reason"]) == ("Degraded", "InvalidSpec")
    if bad == "topology":
        assert "GPU" in cond["message"]
        for view in (got, want):
            view["status"]["bad"]["conditions"][0].pop("message")
            for ev in view["Event"]:
                ev.pop("message")
    else:
        assert "priority" in cond["message"]
    assert got == want
    assert not got["StatefulSet"] and not got["Service"]
    assert [(e["type"], e["reason"]) for e in got["Event"]] == \
        [("Warning", "InvalidGPUJob")]


def test_slice_name_conflict_parks_instead_of_fighting():
    ref, port = _gang_worlds("two-by-two-hosts")
    for w in (ref, port):
        w.kube.create({
            "apiVersion": "apps/v1", "kind": "StatefulSet",
            "metadata": {"name": "tjob-s1", "namespace": JOBS_NS,
                         "labels": {"notebook-name": "tjob-s1"}},
            "spec": {"replicas": 1}})
        w.reconcile("tjob")
    got = same(ref, port, ["tjob"])
    assert got["status"]["tjob"]["conditions"][0]["reason"] == \
        "SliceNameConflict"
    # Nothing partial: slice 0 was not created either.
    assert [s["metadata"]["name"] for s in got["StatefulSet"]] == ["tjob-s1"]


def test_validate_refuses_what_the_reference_refuses():
    """The reference's matrix, mutated alike in both blocks: each refused
    by both with the same field named; and a worker without a command,
    which only the port refuses (the launcher runs that command)."""
    ref, port = worlds(JOBS_NS)
    cases = [
        (lambda j, b: j["spec"].pop(b), "accelerator"),
        (lambda j, b: j["spec"][b].pop("accelerator"), "accelerator"),
        (lambda j, b: j["spec"][b].update(accelerator="v9z"), "unknown"),
        (lambda j, b: j["spec"].update(restartPolicy="Always"),
         "restartPolicy"),
        (lambda j, b: j["spec"].update(backoffLimit=-1), "backoffLimit"),
        (lambda j, b: j["spec"]["template"]["spec"].update(containers=[]),
         "containers"),
        (lambda j, b: j["metadata"].update(name="x" * 53), "52"),
        (lambda j, b: j["spec"].update(priority=0), "priority"),
        (lambda j, b: j["spec"].update(priority=-3), "priority"),
        (lambda j, b: j["spec"].update(priority="high"), "priority"),
        (lambda j, b: j["spec"].update(priority=True), "priority"),
        (lambda j, b: j["spec"][b].update(minSlices=3), "minSlices"),
        (lambda j, b: j["spec"][b].update(minSlices=0), "minSlices"),
        (lambda j, b: j["spec"][b].update(minSlices="one"), "minSlices"),
    ]
    for mutate, msg in cases:
        for w, block in ((ref, "tpu"), (port, "gpu")):
            job = w.make_job("tjob", topology="4x4", slices=2)
            mutate(job, block)
            with pytest.raises(w.api.ValidationError, match=msg):
                w.api.validate(job)
    for w in (ref, port):
        w.api.validate(w.make_job("tjob", topology="4x4", slices=2))
        w.api.validate(w.make_job("tjob", topology="4x4", slices=2,
                                  priority=500, min_slices=1))
    job = port.make_job("tjob")
    del job["spec"]["template"]["spec"]["containers"][0]["command"]
    with pytest.raises(jobapi.ValidationError, match="command"):
        jobapi.validate(job)


def test_elastic_spec_helpers_default_to_rigid():
    ref, port = worlds(JOBS_NS)
    for w in (ref, port):
        job = w.make_job("tjob", topology="4x4", slices=2)
        assert w.api.priority_of(job) == 100
        assert w.api.min_slices_of(job) == 2
        assert w.api.min_slices_of(w.make_job("tjob", slices=2,
                                              min_slices=1)) == 1
    assert jobapi.crd_manifest()["spec"]["names"] == {
        "kind": "GPUJob", "plural": "gpujobs", "singular": "gpujob"}
    gpu = jobapi.crd_manifest()["spec"]["versions"][0]["schema"][
        "openAPIV3Schema"]["properties"]["spec"]["properties"]["gpu"]
    assert set(gpu["properties"]) == {"accelerator", "gpus", "slices",
                                      "minSlices"}


def test_pod_mapper_routes_by_job_label():
    pod = {"metadata": {"namespace": JOBS_NS,
                        "labels": {"gpujob-name": "tjob"}}}
    assert ctrl.pods_to_gpujob_requests(pod) == [Request(JOBS_NS, "tjob")]
    assert ctrl.pods_to_gpujob_requests({"metadata": {"labels": {}}}) == []
    assert ctrl.pods_to_gpujob_requests({"metadata": {}}) == []


# -- status -----------------------------------------------------------------------


def test_running_then_succeeded_frees_the_gpus():
    ref, port = _gang_worlds("two-by-two-hosts")
    for w in (ref, port):
        w.reconcile("tjob")
        w.run_gang("tjob")
        w.reconcile("tjob")
    got = same(ref, port, ["tjob"])
    assert got["status"]["tjob"]["phase"] == "Running"
    assert got["status"]["tjob"]["slices"] == [
        {"slice": 0, "ready": 2, "total": 2},
        {"slice": 1, "ready": 2, "total": 2}]
    for w in (ref, port):
        w.finish_gang("tjob")
        w.reconcile("tjob")
    got = same(ref, port, ["tjob"])
    assert got["status"]["tjob"]["phase"] == "Succeeded"
    assert not got["StatefulSet"]
    assert len(got["Pod"]) == 4           # kept for logs
    for w in (ref, port):
        w.reconcile("tjob")               # terminal is sticky
    same(ref, port, ["tjob"])
    assert port.reconciler().queue.snapshot()["admitted"] == []


# -- gang restarts ------------------------------------------------------------------


def test_worker_failure_restarts_the_whole_gang():
    from kubeflow_tpu_torch.platform.runtime import metrics

    ref, port = _gang_worlds("two-by-two-hosts", checkpoint_dir="/ckpt")
    for w in (ref, port):
        w.reconcile("tjob")
        w.run_gang("tjob")
        w.reconcile("tjob")
    before = metrics.gpujob_restarts_total.sample()
    for w in (ref, port):
        w.kube.set_pod_phase(JOBS_NS, "tjob-s1-0", "Failed")
        w.reconcile("tjob")
    got = same(ref, port, ["tjob"])
    assert got["status"]["tjob"]["phase"] == "Restarting"
    assert got["status"]["tjob"]["restarts"] == 1
    assert got["Pod"] == []
    assert metrics.gpujob_restarts_total.sample() == before + 1
    for w in (ref, port):
        w.reconcile("tjob")
    got = same(ref, port, ["tjob"])
    for s in ("tjob", "tjob-s1"):
        sts = port.kube.get(STATEFULSET, s, JOBS_NS)
        assert sts["metadata"]["annotations"][
            "gpujobs.kubeflow.org/generation"] == "1"
    for w in (ref, port):
        w.run_gang("tjob")
        w.reconcile("tjob")
    got = same(ref, port, ["tjob"])
    assert (got["status"]["tjob"]["phase"],
            got["status"]["tjob"]["restarts"]) == ("Running", 1)


@pytest.mark.parametrize("policy", ["backoff-0", "never"])
def test_exhausted_restarts_go_terminally_failed(policy):
    kw = (dict(backoff_limit=0) if policy == "backoff-0"
          else dict(restart_policy="Never", backoff_limit=5))
    ref, port = _gang_worlds("two-by-two-hosts", **kw)
    for w in (ref, port):
        w.reconcile("tjob")
        w.run_gang("tjob")
        w.kube.set_pod_phase(JOBS_NS, "tjob-s1-1", "Failed")
        w.reconcile("tjob")
    got = same(ref, port, ["tjob"])
    status = got["status"]["tjob"]
    assert (status["phase"], status["restarts"]) == ("Failed", 0)
    assert status["conditions"][0]["reason"] == "BackoffLimitExceeded"
    assert not got["StatefulSet"] and len(got["Pod"]) == 4
    for w in (ref, port):
        w.reconcile("tjob")
    assert not same(ref, port, ["tjob"])["StatefulSet"]


def test_stale_generation_pods_are_collected():
    ref, port = _gang_worlds("two-by-two-hosts")
    for w in (ref, port):
        w.reconcile("tjob")
        w.kube.create({
            "apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": "tjob-ghost", "namespace": JOBS_NS,
                         "labels": {w.label: "tjob",
                                    w.api.LABEL_GENERATION: "7"}},
            "spec": {"containers": [{"name": "worker"}]}})
        w.reconcile("tjob")
    got = same(ref, port, ["tjob"])
    assert "tjob-ghost" not in [name for name, _ in got["Pod"]]


# -- the grace: the repair of the preempted job's drain ------------------------------


def test_pod_grace_covers_the_launchers_wait_and_is_the_queues():
    assert pods.JOB_GRACE_S >= launch.SHUTDOWN_TIMEOUT_S
    assert pods.JOB_GRACE_S == \
        launch.SHUTDOWN_TIMEOUT_S + pods.JOB_KILL_MARGIN_S
    assert ctrl.DEFAULT_PREEMPTION_GRACE_S == pods.JOB_GRACE_S
    # The reference frees a preempted gang after 30 s and sets no pod
    # grace (the kubelet's 30 s): both less than the launcher waits.
    assert ref_ctrl.DEFAULT_PREEMPTION_GRACE_S == 30.0 < pods.JOB_GRACE_S
    kube = FakeKube()
    kube.add_namespace(JOBS_NS)
    assert GPUJobReconciler(kube).preemption_grace == pods.JOB_GRACE_S
    job = World(True, JOBS_NS).make_job("tjob")
    job["spec"]["template"]["spec"]["terminationGracePeriodSeconds"] = 900
    kube.create(job)
    sts = GPUJobReconciler(kube).generate_statefulset(
        kube.get(GPUJOB, "tjob", JOBS_NS))
    assert sts["spec"]["template"]["spec"][
        "terminationGracePeriodSeconds"] == 900   # a longer ask is kept


def test_preemption_grace_knob(monkeypatch):
    kube = FakeKube()
    monkeypatch.setenv("GPUJOB_PREEMPTION_GRACE_SECONDS", "42.5")
    assert GPUJobReconciler(kube).preemption_grace == 42.5
    assert GPUJobReconciler(kube, preemption_grace=3).preemption_grace == 3
    monkeypatch.setenv("GPUJOB_PREEMPTION_GRACE_SECONDS", "soon")
    assert GPUJobReconciler(kube).preemption_grace == pods.JOB_GRACE_S


class Clock:
    def __init__(self, t=1_000_000.0):
        self.t = t

    def __call__(self):
        return self.t


@pytest.mark.parametrize("drain", ["pods-exit-at-45s", "pods-never-exit"])
def test_a_drain_past_30s_holds_its_gpus_until_the_pods_end(drain,
                                                            monkeypatch):
    """On a fake clock: a preempted gang whose pods outlive the reference's
    30 s stays Preempting, and its preemptor Queued, until its pods
    terminate — or, if they never do, until the grace runs out."""
    w = World(True)
    clock = Clock()
    monkeypatch.setattr(ctrl, "time", types.SimpleNamespace(time=clock))
    w.add_nodes(1)

    def reconcile(name):
        return GPUJobReconciler(w.kube, queue_poll=0.05).reconcile(
            Request(w.ns, name))

    w.kube.create(w.make_job("victim", priority=50,
                             checkpoint_dir="/ckpt/victim"))
    reconcile("victim")
    w.run_gang("victim")
    reconcile("victim")
    assert w.phase("victim") == "Running"
    w.kube.create(w.make_job("vip", priority=500))
    reconcile("vip")
    reconcile("victim")
    assert w.phase("victim") == "Preempting"
    assert w.kube.list(STATEFULSET, w.ns) == []        # the SIGTERM
    t0 = clock.t
    exit_at = 45.0 if drain == "pods-exit-at-45s" else None
    end = t0 + pods.JOB_GRACE_S + 5
    freed_at = None
    while clock.t < end:
        clock.t += 0.5
        if exit_at is not None and clock.t - t0 >= exit_at \
                and w.worker_pods("victim")[0]["status"]["phase"] \
                == "Running":
            w.finish_gang("victim")
        for name in ("vip", "victim"):
            reconcile(name)
        if w.alloc("victim") is None:
            freed_at = clock.t - t0
            break
        assert w.phase("victim") == "Preempting"
        assert w.alloc("vip") is None
        assert w.phase("vip") == "Queued"
    if exit_at is not None:
        assert exit_at <= freed_at < exit_at + 1.0
    else:
        assert pods.JOB_GRACE_S <= freed_at < pods.JOB_GRACE_S + 1.0
    assert freed_at > 30.0
    assert w.phase("victim") == "Queued"
    reconcile("vip")
    assert w.alloc("vip") == 1


# -- the one-copy sharded snapshot ------------------------------------------------------


def test_sharded_snapshot_is_a_copy_training_cannot_change():
    """``ShardedTrainState.full_state`` on the CPU returns what the
    two-copy version returned (each tensor whole, equal), and none of it
    aliases the module or the optimizer: a step after the snapshot leaves
    it as it was.  A CPU tensor is cloned, never put in the caller's
    pinned buffers, and a process that writes nothing gets nothing."""
    from kubeflow_tpu_torch.models.registry import create_model
    from kubeflow_tpu_torch.parallel import mesh, sharding
    from kubeflow_tpu_torch.parallel.train import shard_train_state
    from kubeflow_tpu_torch.train.checkpoint import optimizer_state_by_name
    from kubeflow_tpu_torch.train.steps import TrainState, adamw

    class OneProcess:
        mesh_dim_names = mesh.AXIS_NAMES

        def size(self, dim):
            return 1

        def get_local_rank(self, axis):
            return 0

    model = create_model("llama_debug", device="cpu",
                         param_dtype=torch.float32)
    with torch.no_grad():
        model.reset_parameters(torch.Generator().manual_seed(0))
    model.requires_grad_(True)
    state = shard_train_state(TrainState(model, adamw(model.parameters(),
                                                      1e-2)),
                              OneProcess(), sharding.llama_rules())

    def step():
        for p in state.module.parameters():
            p.grad = torch.randn_like(p)
        state.optimizer.step()

    step()
    buffers = {}
    assert state.full_state(buffers, to_host=False) is None
    params, optim = state.full_state(buffers)
    assert buffers == {}
    # What the two-copy version returned: .cpu().clone() of each.
    want_params = {k: v.detach().cpu().clone()
                   for k, v in state.module.state_dict().items()}
    want_optim = optimizer_state_by_name(state.module, state.optimizer)
    assert set(params) == set(want_params)
    for k, v in want_params.items():
        assert params[k].dtype == v.dtype and torch.equal(params[k], v), k
    assert optim["param_groups"] == want_optim["param_groups"]
    for name, per in want_optim["state"].items():
        for k, v in per.items():
            assert torch.equal(optim["state"][name][k], v), (name, k)
    live = {t.data_ptr() for t in state.module.state_dict().values()}
    live |= {v.data_ptr() for per in state.optimizer.state.values()
             for v in per.values() if isinstance(v, torch.Tensor)}
    got = [*params.values()] + [v for per in optim["state"].values()
                                for v in per.values()
                                if isinstance(v, torch.Tensor)]
    assert not live & {t.data_ptr() for t in got}
    kept = {k: v.clone() for k, v in params.items()}
    kept_m = {n: per["exp_avg"].clone() for n, per in optim["state"].items()}
    step()
    for k, v in kept.items():
        assert torch.equal(params[k], v), k
    for n, v in kept_m.items():
        assert torch.equal(optim["state"][n]["exp_avg"], v), n
    assert any(not torch.equal(params[k], v)
               for k, v in state.module.state_dict().items())


# -- a gang that trains, is preempted and resumes ---------------------------------------


def test_gang_sim_trains_through_a_preemption_to_the_unbroken_losses(
        tmp_path):
    """``GpuJobGangSim`` runs the port's trainer (``train.run.train``,
    llama_debug on the CPU) as the gang's work.  A higher-priority job
    preempts it before its step 4: its StatefulSet's deletion stops the
    loop, which saves step 3, its pod exits, the controller frees the GPU
    on the pod's termination, the preemptor runs, and the job resumes
    from its checkpoint in the next generation and finishes.  Its losses
    equal an unbroken run's."""
    from kubeflow_tpu_torch.train import run

    argv = ["--model", "llama_debug", "--batch", "2", "--seq", "16",
            "--steps", "6", "--log-every", "1", "--device", "cpu"]
    ckpt = str(tmp_path / "ckpt")

    def losses(args, stop):
        _, history = run.train(args, torch.device("cpu"), stop)
        return [(h["step"], h["loss"]) for h in history if "loss" in h]

    unbroken = losses(run.parse_args(argv)[1], None)
    before_step_4 = threading.Event()

    class HeldStop:
        """The loop's stop: the top of step 4 waits for the SIGTERM."""

        def __init__(self, stop):
            self.stop, self.checks = stop, 0

        def is_set(self):
            self.checks += 1
            if self.checks == 4:
                before_step_4.set()
                self.stop.wait(60)
            return self.stop.is_set()

    logged = {}

    def work(job, generation, stop):
        if job != "victim":
            logged[job] = generation
            return
        args = run.parse_args(argv + ["--checkpoint-dir", ckpt])[1]
        logged[generation] = losses(
            args, HeldStop(stop) if generation == 0 else stop)

    w = World(True)
    w.add_nodes(1)
    sim = GpuJobGangSim(w.kube, w.ns, work=work)
    deadline = time.monotonic() + 120

    def until(cond, names):
        while not cond():
            assert time.monotonic() < deadline, w.statuses(names)
            for name in names:
                w.reconcile(name)
            time.sleep(0.02)

    try:
        w.kube.create(w.make_job("victim", priority=50, checkpoint_dir=ckpt))
        until(before_step_4.is_set, ["victim"])
        w.kube.create(w.make_job("vip", priority=500))
        until(lambda: w.phase("vip") == "Succeeded", ["vip", "victim"])
        until(lambda: w.phase("victim") == "Succeeded", ["vip", "victim"])
    finally:
        sim.close()
    assert not sim.errors, sim.errors
    assert logged["vip"] == 0
    assert [s for s, _ in logged[0]] == [1, 2, 3]
    # The re-admission is the job's next generation: it resumed at step 4.
    assert [s for s, _ in logged[1]] == [4, 5, 6]
    victim = w.job("victim")
    assert (jobapi.generation_of(victim), jobapi.restarts_of(victim)) == \
        (1, 0)
    got = logged[0] + logged[1]
    assert [s for s, _ in got] == [s for s, _ in unbroken]
    for (_, a), (_, b) in zip(got, unbroken):
        assert a == pytest.approx(b, rel=1e-6)
    assert w.kube.list(STATEFULSET, w.ns) == []
    assert not [p for p in w.kube.list(POD, w.ns)
                if p["status"]["phase"] not in ("Succeeded", "Failed")]
    reasons = {e["reason"] for e in w.kube.list(EVENT, w.ns)}
    assert {"Preempting", "PreemptionComplete", "Admitted",
            "JobSucceeded"} <= reasons


def test_smoke_pod_log_stays_whole_while_it_is_polled():
    """``chip_smoke.py``'s ``JobPods`` reads a pod's log every 0.1 s while
    the pod writes it: each read leaves the file's offset, which the pod
    shares, where the pod's next line belongs."""
    import os
    import sys

    import chip_smoke

    want = [f"train_step step={i} loss=10.{i:04d}" for i in range(300)]
    writer = ("import time\n"
              "for i in range(300):\n"
              "    print(f'train_step step={i} loss=10.{i:04d}', flush=True)\n"
              "    time.sleep(0.001)\n")
    pod = chip_smoke.Pod([sys.executable, "-c", writer], dict(os.environ),
                         "writer")
    while pod.proc.poll() is None:
        pod.output()
    out = pod.output()
    assert pod.stop() == 0
    assert out.splitlines() == want
