"""The platform's GPU seams (``kubeflow_tpu_torch/platform/``,
``parallel/envspec.py``'s blocks and ``parallel/launch.py``) against the
JAX package's TPU counterparts: the slice math, the node scans, the
quota with its admission in the in-memory API server, the pod pieces the
controllers build, the env's round trip to a launcher's ranks, and one
launcher world over gloo.

Every comparison is exact (the pieces are integers, strings and dicts);
the gloo world has a hard 60 s limit."""
import copy
import socket
import subprocess
import sys
import textwrap

import pytest
import requests

from kubeflow_tpu.parallel import dist as jax_dist, envspec as jax_envspec
from kubeflow_tpu.platform.apis import inferenceservice as isvc_api
from kubeflow_tpu.platform.controllers.inferenceservice import (
    InferenceServiceReconciler,
)
from kubeflow_tpu.platform.controllers.notebook import NotebookReconciler
from kubeflow_tpu.platform.controllers.tpujob import TPUJobReconciler
from kubeflow_tpu.platform.k8s import quota as jax_quota
from kubeflow_tpu.platform.k8s.types import (
    INFERENCESERVICE,
    NOTEBOOK,
    TPUJOB,
)
from kubeflow_tpu.platform.runtime.jobqueue import JobQueue
from kubeflow_tpu.platform.testing import FakeKube
from kubeflow_tpu.platform.tpu import topology as tpu_topology
from kubeflow_tpu.platform.web.crud_backend import AuthContext
from kubeflow_tpu_torch.parallel import envspec, launch
from kubeflow_tpu_torch.platform.gpu import pods, topology
from kubeflow_tpu_torch.platform.apis import notebook as nbapi
from kubeflow_tpu_torch.platform.k8s import errors as port_errors
from kubeflow_tpu_torch.platform.k8s import quota
from kubeflow_tpu_torch.platform.k8s.types import NOTEBOOK as PORT_NOTEBOOK
from kubeflow_tpu_torch.platform.k8s.types import (
    POD,
    RESOURCEQUOTA,
    STATEFULSET,
)
from kubeflow_tpu_torch.platform.testing import FakeKube as PortKube
from test_torch_multirank import REPO, wait_all, worker_env

H100 = "h100-80gb"
TPU_KEY, GPU_KEY = "google.com/tpu", "nvidia.com/gpu"
# The names only libtpu reads: the TPU pod has them, the GPU pod has
# KFT_GPUS_PER_HOST in their place.
LIBTPU_ONLY = {"TPU_TOPOLOGY", "TPU_ACCELERATOR_TYPE", "TPU_CHIPS_PER_HOST"}
POD_INDEX = "metadata.labels['apps.kubernetes.io/pod-index']"


def test_envspec_blocks_equal_the_reference():
    kw = dict(topology="4x4", accelerator="v5e", chips=16, chips_per_host=8,
              num_hosts=2, hostnames="a,b")
    assert envspec.tpu_bootstrap_env(**kw) == \
        jax_envspec.tpu_bootstrap_env(**kw)
    assert envspec.megascale_env(1, 3, "coord") == \
        jax_envspec.megascale_env(1, 3, "coord")
    assert envspec.elastic_env(4) == jax_envspec.elastic_env(4)
    tpu = jax_envspec.tpu_bootstrap_env(**kw)
    gpu = envspec.gpu_bootstrap_env(gpus_per_host=8, num_hosts=2,
                                    hostnames="a,b")
    assert [e for e in tpu if e["name"] not in LIBTPU_ONLY] == \
        [e for e in gpu if e["name"] != envspec.ENV_KFT_GPUS_PER_HOST]
    assert {"name": "KFT_GPUS_PER_HOST", "value": "8"} in gpu


# -- slice math ---------------------------------------------------------------


def _spec_or_error(fn):
    try:
        return fn()
    except ValueError:
        return ValueError


@pytest.mark.parametrize("slices", [1, 2, 3])
def test_slice_math_equals_the_reference(slices):
    """v5e hosts hold 8 chips, H100 hosts 8 GPUs: ``1xN`` chips and N
    GPUs resolve alike, or both refuse."""
    for n in range(1, 41):
        ref = _spec_or_error(
            lambda: tpu_topology.slice_spec("v5e", f"1x{n}", slices))
        got = _spec_or_error(lambda: topology.slice_spec(H100, n, slices))
        if ref is ValueError:
            assert got is ValueError, n
            continue
        assert (got.gpus, got.num_hosts, got.gpus_per_pod, got.total_hosts,
                got.total_gpus, got.multi_host, got.multi_slice) == \
            (ref.chips, ref.num_hosts, ref.chips_per_pod, ref.total_hosts,
             ref.total_chips, ref.multi_host, ref.multi_slice), n
        assert got.pod_resources() == {
            GPU_KEY: ref.pod_resources()[TPU_KEY]}
        assert got.node_selectors() == {
            topology.LABEL_GPU_PRODUCT: "NVIDIA-H100-80GB-HBM3"}


def test_slice_spec_defaults_and_refusals():
    # The default: one full host, as the reference's default topology.
    ref = tpu_topology.slice_spec("v5e")
    got = topology.slice_spec(H100)
    assert (got.gpus, got.num_hosts, got.num_slices) == \
        (ref.chips, ref.num_hosts, ref.num_slices) == (8, 1, 1)
    assert topology.slice_spec(H100, 8, "2").num_slices == 2
    assert topology.slice_spec(H100, 16, 2) is topology.slice_spec(H100, 16,
                                                                  2)
    for args in [("a100", 8, 1), ("", 8, 1), (None, 8, 1), (H100, 0, 1),
                 (H100, -8, 1), (H100, 2.5, 1), (H100, "8", 1),
                 (H100, True, 1), (H100, 8, 0), (H100, 8, -1),
                 (H100, 8, "x"), (H100, 12, 1)]:
        with pytest.raises(ValueError):
            topology.slice_spec(*args)
    for args in [("v6x", "2x4", 1), ("v5e", "2x4", 0), ("v5e", "2x4", "x")]:
        with pytest.raises(ValueError):
            tpu_topology.slice_spec(*args)


# -- node scans ---------------------------------------------------------------

# TPU node label -> the GPU product a relabelled node carries.
PRODUCT = {"tpu-v5-lite-podslice": "NVIDIA-H100-80GB-HBM3",
           "tpu-v4-podslice": "NVIDIA-A100-SXM4-40GB",
           "tpu-unknown": "NVIDIA-UNKNOWN"}
# Each topology's chips a node: distinct, so a GPU node's count stands
# for its topology.
CHIPS = {"1x1": "1", "2x2": "4", "2x4": "8"}


def _tpu_nodes():
    nodes = []
    for i, (acc, topo, cap) in enumerate([
            ("tpu-v5-lite-podslice", "2x4", True),
            ("tpu-v5-lite-podslice", "2x4", True),
            ("tpu-v5-lite-podslice", "2x2", True),
            ("tpu-v5-lite-podslice", "1x1", False),
            ("tpu-v4-podslice", "2x2", True),
            ("tpu-unknown", "2x4", True),
            (None, "2x4", True)]):
        labels = {tpu_topology.LABEL_TOPOLOGY: topo}
        if acc:
            labels[tpu_topology.LABEL_ACCELERATOR] = acc
        capacity = {"cpu": "96"}
        if cap:
            capacity[TPU_KEY] = CHIPS[topo]
        nodes.append({"apiVersion": "v1", "kind": "Node",
                      "metadata": {"name": f"node-{i}", "labels": labels},
                      "status": {"capacity": capacity}})
    return nodes


def _relabelled(node):
    labels = node["metadata"]["labels"]
    cap = dict(node["status"]["capacity"])
    if TPU_KEY in cap:
        cap[GPU_KEY] = cap.pop(TPU_KEY)
    acc = labels.get(tpu_topology.LABEL_ACCELERATOR)
    new = {topology.LABEL_GPU_PRODUCT: PRODUCT[acc]} if acc else {}
    new[topology.LABEL_GPU_COUNT] = CHIPS[
        labels[tpu_topology.LABEL_TOPOLOGY]]
    return {"apiVersion": "v1", "kind": "Node",
            "metadata": {"name": node["metadata"]["name"], "labels": new},
            "status": {"capacity": cap}}


def test_node_scans_equal_the_reference():
    nodes = _tpu_nodes()
    gpu_nodes = [_relabelled(n) for n in nodes]

    ref = tpu_topology.topologies_on_nodes(nodes)
    got = topology.gpus_on_nodes(gpu_nodes)
    assert got == {H100: sorted(int(CHIPS[t]) for t in ref["v5e"])}
    assert sorted(ref) == ["v4", "v5e"]     # the A100 is no entry here

    q = JobQueue()
    q.set_nodes(nodes)
    want = {(PRODUCT[acc], int(CHIPS[topo])): hosts
            for (acc, topo), hosts in q._pool_hosts.items()}
    assert topology.gpu_pool_hosts(gpu_nodes) == want
    assert sum(want.values()) == 5

    from kubeflow_tpu.platform.dashboard.app import create_app

    kube = FakeKube()
    kube.add_namespace("user1")
    for node in nodes:
        kube.create(node)
    server, base = create_app(kube, auth=AuthContext()).test_server()
    try:
        overview = requests.get(
            f"{base}/api/tpu-overview",
            headers={"kubeflow-userid": "alice@example.com"},
            timeout=30).json()
    finally:
        server.shutdown()
        server.server_close()
    assert topology.gpu_capacity(gpu_nodes) == \
        overview["clusterCapacityChips"] == 1 + 8 + 8 + 4 + 4 + 8 + 8 - 1


def test_gpus_on_nodes_skips_what_offers_nothing():
    def node(cap, product="NVIDIA-H100-80GB-HBM3"):
        return {"metadata": {"labels": {topology.LABEL_GPU_PRODUCT:
                                        product,
                                        topology.LABEL_GPU_COUNT: str(cap)}},
                "status": {"capacity": {GPU_KEY: cap}}}

    nodes = [node("8"), node("0"), node("junk"), node(""), node(4),
             node("2", "NVIDIA-L4"), {}]
    assert topology.gpus_on_nodes(nodes) == {H100: [4, 8]}
    assert topology.gpu_pool_hosts(nodes) == {
        ("NVIDIA-H100-80GB-HBM3", 8): 1, ("NVIDIA-H100-80GB-HBM3", 4): 1,
        ("NVIDIA-L4", 2): 1}
    # A node no job's pods can select (no count label) is in no pool.
    del nodes[0]["metadata"]["labels"][topology.LABEL_GPU_COUNT]
    assert topology.gpu_pool_hosts(nodes) == {
        ("NVIDIA-H100-80GB-HBM3", 4): 1, ("NVIDIA-L4", 2): 1}


# -- quota --------------------------------------------------------------------


def _renamed(obj):
    """``obj`` with every google.com/tpu in a key renamed nvidia.com/gpu."""
    if isinstance(obj, dict):
        return {k.replace(TPU_KEY, GPU_KEY): _renamed(v)
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_renamed(v) for v in obj]
    return obj


def _quota(name, hard, used=None):
    q = {"apiVersion": "v1", "kind": "ResourceQuota",
         "metadata": {"name": name, "namespace": "user1"},
         "spec": {"hard": hard}}
    if used is not None:
        q["status"] = {"used": used}
    return q


QUOTAS = {
    "none": [],
    "cpu-only": [_quota("q", {"cpu": "8"}, {"cpu": "2"})],
    "bare": [_quota("q", {TPU_KEY: "32"}, {TPU_KEY: "8"})],
    "requests": [_quota("q", {f"requests.{TPU_KEY}": "16"},
                        {f"requests.{TPU_KEY}": "4"})],
    "tightest": [_quota("a", {TPU_KEY: "64"}, {TPU_KEY: "8"}),
                 _quota("b", {f"requests.{TPU_KEY}": "24"},
                        {f"requests.{TPU_KEY}": "16"}),
                 _quota("c", {f"limits.{TPU_KEY}": "1"})],
    "malformed": [_quota("bad", {TPU_KEY: "lots"}, {TPU_KEY: "1"}),
                  _quota("ok", {TPU_KEY: "1k"}, {TPU_KEY: "500m"})],
    "no-status": [_quota("q", {TPU_KEY: "8"})],
    "over": [_quota("q", {TPU_KEY: "8"}, {TPU_KEY: "12"})],
}


@pytest.mark.parametrize("name", sorted(QUOTAS))
def test_gpu_remaining_equals_tpu_remaining(name):
    for declared, pod_used in [(0.0, 0.0), (8.0, 0.0), (16.0, 8.0),
                               (4.0, 20.0)]:
        want = jax_quota.tpu_remaining(QUOTAS[name], declared=declared,
                                       workload_pod_used=pod_used)
        got = quota.gpu_remaining(_renamed(QUOTAS[name]), declared=declared,
                                  workload_pod_used=pod_used)
        assert got == want, (declared, pod_used)


def test_quota_helpers_equal_the_reference():
    for q in ["500m", "2Gi", "1e3", "1.5k", "16", 3, 2.5, " 4 "]:
        assert quota.parse_quantity(q) == jax_quota.parse_quantity(q)
    for q in ["", "nan", "inf", "abc", "1e999"]:
        with pytest.raises(ValueError):
            quota.parse_quantity(q)
        with pytest.raises(ValueError):
            jax_quota.parse_quantity(q)
    for k in ["pods", "cpu", GPU_KEY, f"limits.{GPU_KEY}",
              f"requests.{GPU_KEY}"]:
        assert quota.usage_key(k) == jax_quota.usage_key(k)
    pod = {"spec": {
        "containers": [
            {"resources": {"limits": {GPU_KEY: "8", "cpu": "4"},
                           "requests": {"cpu": "2", "memory": "8Gi"}}},
            {"resources": {"requests": {"cpu": "500m"}}}],
        "initContainers": [
            {"resources": {"limits": {"cpu": "8", "memory": "1Gi"}}},
            {"resources": {"requests": {"memory": "16Gi"}}}]}}
    assert quota.pod_quota_usage(pod) == jax_quota.pod_quota_usage(pod)
    assert quota.effective_used(10, 4, 6) == jax_quota.effective_used(10, 4, 6)


def _reference_notebook_usage():
    """The spawner's ``_notebook_usage``, reached through the routes'
    closures of the reference's Jupyter app."""
    from kubeflow_tpu.platform.apps.jupyter.app import create_app

    app = create_app(FakeKube())
    seen, found = set(), []

    def walk(fn):
        if id(fn) in seen:
            return
        seen.add(id(fn))
        if getattr(fn, "__name__", "") == "_notebook_usage":
            found.append(fn)
            return
        for cell in getattr(fn, "__closure__", None) or ():
            try:
                value = cell.cell_contents
            except ValueError:
                continue
            if callable(value):
                walk(value)

    for view in app._views.values():
        walk(view)
    assert len(found) == 1
    return found[0]


def test_notebook_gpu_usage_equals_the_reference():
    usage_of = _reference_notebook_usage()
    template = {"containers": [
        {"name": "nb", "resources": {
            "requests": {"cpu": "2", "memory": "8Gi"},
            "limits": {"cpu": "4", TPU_KEY: "8"}}},
        {"name": "side", "resources": {"requests": {"cpu": "100m"}}}]}
    for n, slices in [(8, 1), (16, 2), (4, 3), (32, 1), (None, None)]:
        nb = {"apiVersion": "kubeflow.org/v1beta1", "kind": "Notebook",
              "metadata": {"name": "nb", "namespace": "user1"},
              "spec": {"template": {"spec": copy.deepcopy(template)}}}
        spec = None
        if n is not None:
            nb["spec"]["tpu"] = {"accelerator": "v5e",
                                 "topology": f"1x{n}", "slices": slices}
            spec = topology.slice_spec(H100, n, slices)
        got = quota.notebook_gpu_usage(
            {"spec": _renamed(copy.deepcopy(template))}, spec)
        assert got == _renamed(usage_of(nb)), (n, slices)


# -- quota admission ----------------------------------------------------------


def _gpu_pod(name, gpus=None, cpu="1", phase=None, init=None):
    res = {"requests": {"cpu": cpu}}
    if gpus is not None:
        res["limits"] = {GPU_KEY: str(gpus)}
    pod = {"apiVersion": "v1", "kind": "Pod",
           "metadata": {"name": name, "namespace": "user1",
                        "labels": {"notebook-name": name.rsplit("-", 1)[0]}},
           "spec": {"containers": [{"name": "c", "resources": res}]}}
    if init is not None:
        pod["spec"]["initContainers"] = [
            {"name": "i", "resources": {"limits": {GPU_KEY: str(init)}}}]
    if phase is not None:
        pod["status"] = {"phase": phase}
    return pod


def test_quota_formatting_and_validation_equal_the_reference():
    for v, key in [(16, GPU_KEY), (0.5, "cpu"), (2**31, "requests.memory"),
                   (2**31 + 1, "memory"), (1536, "limits.memory"),
                   (1024, GPU_KEY), (3 * 2**40, "requests.storage"),
                   (0.0, "pods"), (1.25, "cpu")]:
        assert quota.format_quantity(v, key) == \
            jax_quota.format_quantity(v, key)
    quota.validate_hard({GPU_KEY: "8", "memory": "1Gi", "cpu": "500m"})
    for bad in [{GPU_KEY: "lots"}, {"cpu": ""}, {"memory": "nan"},
                {GPU_KEY: None}]:
        with pytest.raises(ValueError) as got:
            quota.validate_hard(bad)
        with pytest.raises(ValueError) as want:
            jax_quota.validate_hard(bad)
        assert str(got.value) == str(want.value)


GPU_QUOTAS = {
    "bare": [_quota("q", {GPU_KEY: "8"}, {GPU_KEY: "6"})],
    "requests": [_quota("q", {f"requests.{GPU_KEY}": "8"},
                        {f"requests.{GPU_KEY}": "7"})],
    "limits": [_quota("q", {f"limits.{GPU_KEY}": "4"})],
    "pods-and-cpu": [_quota("a", {"pods": "2", "cpu": "3"},
                            {"pods": "1", "cpu": "2500m"}),
                     _quota("b", {GPU_KEY: "64"})],
    "none": [],
}


@pytest.mark.parametrize("name", sorted(GPU_QUOTAS))
def test_find_violation_and_status_equal_the_reference(name):
    quotas = GPU_QUOTAS[name]
    pods_in = [_gpu_pod("a-0", 2), _gpu_pod("b-0", 1, cpu="500m"),
               _gpu_pod("c-0", 4, phase="Succeeded"),
               _gpu_pod("d-0", init=8), _gpu_pod("e-0", phase="Failed")]
    assert quota.live_usage(pods_in) == jax_quota.live_usage(pods_in)
    totals = quota.live_usage(pods_in)
    for incoming in pods_in + [_gpu_pod("f-0", 1), _gpu_pod("g-0", 16)]:
        usage = quota.pod_quota_usage(incoming)
        for override in (None, {q["metadata"]["name"]: totals
                                for q in quotas}):
            got = quota.find_violation(quotas, usage, used_override=override)
            want = jax_quota.find_violation(quotas, usage,
                                            used_override=override)
            assert (got is None) == (want is None)
            if got is not None:
                assert (got.message(), got.remaining, got.quota_name,
                        got.hard_key) == (want.message(), want.remaining,
                                          want.quota_name, want.hard_key)
                assert str(got).startswith("exceeded quota: ")
    assert quota.quota_status(quotas, pods_in) == \
        jax_quota.quota_status(quotas, pods_in)
    assert quota.quota_status(quotas, totals={GPU_KEY: 3.0}) == \
        jax_quota.quota_status(quotas, totals={GPU_KEY: 3.0})


def _kube_script(kube, errors_mod):
    """One sequence of API calls; returns what each answered (objects
    without server-minted fields, or the error's class and message)."""
    out = []

    def call(fn, *a, **kw):
        try:
            obj = fn(*a, **kw)
        except errors_mod.ApiError as e:
            out.append((type(e).__name__, e.status, str(e)))
            return None
        if isinstance(obj, (dict, list)):
            obj = copy.deepcopy(obj)
            # A list's items too: a second may pass between the two
            # packages' scripts.
            for o in obj if isinstance(obj, list) else [obj]:
                for k in ("uid", "creationTimestamp"):
                    o.get("metadata", {}).pop(k, None)
        out.append(obj)
        return obj

    call(kube.add_namespace, "user1")
    call(kube.create, _gpu_pod("nowhere-0", 1) | {"metadata": {
        "name": "x", "namespace": "gone"}})
    call(kube.create, _quota("bad", {GPU_KEY: "lots"}))
    call(kube.create, _quota("gpus", {GPU_KEY: "4", "pods": "3"}))
    call(kube.create, _gpu_pod("a-0", 2))
    call(kube.create, _gpu_pod("b-0", 2))
    call(kube.create, _gpu_pod("c-0", 1))                 # over the GPUs
    call(kube.create, _gpu_pod("c-0", 1), dry_run=True)
    call(kube.create, _gpu_pod("d-0") | {"spec": {"containers": [
        {"name": "c", "resources": {"limits": {"cpu": "junk"}}}]}})
    call(kube.get, RESOURCEQUOTA, "gpus", "user1")
    call(kube.patch, POD, "b-0", {"spec": {"containers": [
        {"name": "c", "resources": {"limits": {GPU_KEY: "3"}}}]}}, "user1")
    call(kube.patch, POD, "b-0", [{"op": "add",
                                   "path": "/metadata/labels/x",
                                   "value": "1"}], "user1",
         patch_type="json")
    call(kube.set_pod_phase, "user1", "a-0", "Succeeded")  # frees 2
    call(kube.create, _gpu_pod("c-0", 1))
    call(kube.create, _gpu_pod("e-0"))            # the third live pod
    call(kube.get, RESOURCEQUOTA, "gpus", "user1")
    call(kube.patch, RESOURCEQUOTA, "gpus",
         {"spec": {"hard": {GPU_KEY: "x"}}}, "user1")
    call(kube.delete, POD, "b-0", "user1")
    call(kube.get, RESOURCEQUOTA, "gpus", "user1")
    stale = call(kube.get, POD, "c-0", "user1")
    call(kube.update, stale)
    call(kube.update, stale)                              # a stale write
    owner = call(kube.create, {"apiVersion": "apps/v1",
                               "kind": "StatefulSet",
                               "metadata": {"name": "s",
                                            "namespace": "user1"}})
    uid = kube.get(STATEFULSET, "s", "user1")["metadata"]["uid"]
    child = _gpu_pod("s-0") | {}
    child["metadata"]["ownerReferences"] = [{"uid": uid, "name": "s"}]
    call(kube.create, child)
    call(kube.delete, STATEFULSET, "s", "user1")          # cascades
    call(kube.list, POD, "user1")
    call(kube.list, POD, "user1", label_selector={"notebook-name": "c"})
    call(kube.get, RESOURCEQUOTA, "gpus", "user1")
    return out


def test_fake_kube_admission_equals_the_reference():
    """The port's in-memory API server answers a script of calls as the
    reference's does: namespaces, quota validation, admission with the
    apiserver's message, dry runs, resizes, JSON patches, terminal
    phases releasing quota, stale writes and the cascade on delete."""
    from kubeflow_tpu.platform.k8s import errors as jax_errors

    got = _kube_script(PortKube(), port_errors)
    want = _kube_script(FakeKube(), jax_errors)
    refusals = [r for r in got if isinstance(r, tuple)]
    assert [r[0] for r in refusals] == [
        "NotFound", "Invalid", "Forbidden", "Forbidden", "Invalid",
        "Forbidden", "Invalid", "Conflict"]
    assert refusals[2][2] == (
        'pods "c-0" is forbidden: exceeded quota: gpus, requested: '
        'nvidia.com/gpu=1, used: nvidia.com/gpu=4, limited: '
        'nvidia.com/gpu=4')
    assert got == want


def test_fake_kube_watch_and_gpu_node_equal_the_reference():
    from kubeflow_tpu_torch.platform.gpu.topology import gpus_on_nodes
    from kubeflow_tpu_torch.platform.k8s.types import NODE

    port, ref = PortKube(), FakeKube()
    streams = []
    for kube in (port, ref):
        kube.add_namespace("user1")
        kube.create(_gpu_pod("a-0", 1))
        streams.append(kube.watch(POD, "user1"))
        kube.create(_gpu_pod("b-0", 1))
        kube.delete(POD, "a-0", "user1")
    for events in zip(*[[next(s) for _ in range(3)] for s in streams]):
        (t1, o1), (t2, o2) = events
        assert (t1, o1["metadata"]["name"]) == (t2, o2["metadata"]["name"])
    port.add_gpu_node("g0")
    port.add_gpu_node("g1", gpus=4)
    assert gpus_on_nodes(port.list(NODE)) == {"h100-80gb": [4, 8]}
    assert topology.gpu_capacity(port.list(NODE)) == 12


def test_namespace_gpu_budget_equals_gpu_remaining():
    """``namespace_gpu_budget`` is ``quota.gpu_remaining`` over the
    namespace's quotas with the running notebooks' declared GPUs and
    their pods' usage, and equals the reference's
    ``namespace_tpu_budget`` of the same notebooks and pods."""
    from kubeflow_tpu.platform.apis import notebook as jax_nbapi

    def nb(name, gpus=None, stopped=False, tpu=None):
        out = {"apiVersion": "kubeflow.org/v1beta1", "kind": "Notebook",
               "metadata": {"name": name, "namespace": "user1"},
               "spec": {"template": {"spec": {"containers": [
                   {"name": name}]}}}}
        if gpus:
            out["spec"]["gpu"] = {"accelerator": H100, "gpus": gpus}
        if tpu:
            out["spec"]["tpu"] = {"accelerator": "v5e", "topology": tpu}
        if stopped:
            out["metadata"]["annotations"] = {nbapi.STOP_ANNOTATION: "t"}
        return out

    port, ref = PortKube(), FakeKube()
    for kube in (port, ref):
        kube.add_namespace("user1")
    assert nbapi.namespace_gpu_budget(port, "user1") is None
    hard = {GPU_KEY: "32"}
    port.create(_quota("q", hard))
    ref.create(_quota("q", {TPU_KEY: "32"}))
    for name, gpus, topo, stopped in [("a", 16, "4x4", False),
                                      ("b", 8, "2x4", True),
                                      ("c", 1, "1x1", False),
                                      ("d", None, None, False)]:
        port.create(nb(name, gpus, stopped))
        ref.create(nb(name, stopped=stopped, tpu=topo))
    # Pods: one of a running notebook, one of the stopped one (still
    # terminating), one of no notebook.
    for kube, key in ((port, GPU_KEY), (ref, TPU_KEY)):
        for pod_name, n in [("a-0", 8), ("b-0", 8), ("job-0", 4)]:
            pod = _gpu_pod(pod_name)
            pod["spec"]["containers"][0]["resources"]["limits"] = {
                key: str(n)}
            kube.create(pod)
    running = [o for o in port.list(PORT_NOTEBOOK, "user1")
               if not nbapi.is_stopped(o)]
    declared = sum(nbapi.declared_gpus(o) for o in running)
    pod_used = nbapi.running_notebook_pod_usage(port, "user1", running).get(
        f"requests.{GPU_KEY}", 0.0)
    want = quota.gpu_remaining(port.list(RESOURCEQUOTA, "user1"),
                               declared=declared, workload_pod_used=pod_used)
    assert (declared, pod_used) == (17.0, 8.0)
    got = nbapi.namespace_gpu_budget(port, "user1")
    assert got == want == jax_nbapi.namespace_tpu_budget(ref, "user1")
    assert got == {"hard": 32, "used": 29, "remaining": 3}


# -- pod pieces ---------------------------------------------------------------


def _env(container):
    return {e["name"]: e for e in container.get("env", [])}


def _split(ref_pod, got_pod):
    """The two pod specs with their three expected differences taken out
    (resource key, node selector, env block), after checking each."""
    ref_pod, got_pod = copy.deepcopy(ref_pod), copy.deepcopy(got_pod)
    ref_main, got_main = ref_pod["containers"][0], got_pod["containers"][0]
    for kind in ("limits", "requests"):
        chips = ref_main["resources"][kind].pop(TPU_KEY)
        assert got_main["resources"][kind].pop(GPU_KEY) == chips
    assert set(ref_pod.pop("nodeSelector")) == {
        tpu_topology.LABEL_ACCELERATOR, tpu_topology.LABEL_TOPOLOGY}
    assert got_pod.pop("nodeSelector") == {
        topology.LABEL_GPU_PRODUCT: "NVIDIA-H100-80GB-HBM3"}
    ref_env, got_env = _env(ref_main), _env(got_main)
    assert got_env["KFT_GPUS_PER_HOST"]["value"] == \
        ref_env["TPU_CHIPS_PER_HOST"]["value"]
    assert LIBTPU_ONLY <= set(ref_env)
    assert not LIBTPU_ONLY & set(got_env)
    ref_main["env"] = [e for e in ref_main["env"]
                       if e["name"] not in LIBTPU_ONLY]
    got_main["env"] = [e for e in got_main["env"]
                       if e["name"] != "KFT_GPUS_PER_HOST"]
    return ref_pod, got_pod


def _pod_of(sts):
    return sts["spec"]["template"]["spec"]


def test_notebook_pods_equal_the_reference():
    kube = FakeKube()
    kube.add_namespace("user1")
    nb = {"apiVersion": "kubeflow.org/v1beta1", "kind": "Notebook",
          "metadata": {"name": "nb", "namespace": "user1"},
          "spec": {"tpu": {"accelerator": "v5e", "topology": "1x16",
                           "slices": 2},
                   "template": {"spec": {"containers": [{
                       "name": "nb", "image": "jupyter",
                       "env": [{"name": "TPU_WORKER_HOSTNAMES",
                                "value": "mine"}],
                       "resources": {"requests": {"cpu": "2"}}}]}}}}
    kube.create(nb)
    nb = kube.get(NOTEBOOK, "nb", "user1")
    r = NotebookReconciler(kube, use_istio=True, add_fsgroup=True,
                           mirror_min_interval=0)
    # The controller's pod without the accelerator: what a GPU notebook's
    # pod starts from.
    plain = copy.deepcopy(nb)
    del plain["spec"]["tpu"]
    base = _pod_of(r.generate_statefulset(plain, 0))
    spec = topology.slice_spec(H100, 16, 2)
    for s in range(2):
        ref = _pod_of(r.generate_statefulset(nb, s))
        got = copy.deepcopy(base)
        pods.inject_gpu(got, got["containers"][0], ns="user1", name="nb",
                        spec=spec, slice_idx=s,
                        cluster_domain=r.cluster_domain)
        ref_rest, got_rest = _split(ref, got)
        assert got_rest == ref_rest
        env = _env(got["containers"][0])
        assert env["TPU_WORKER_HOSTNAMES"]["value"] == "mine"
        assert env["MEGASCALE_SLICE_ID"]["value"] == str(s)
        assert "KFT_SPEC_SLICES" not in env
        assert "command" not in got["containers"][0]   # never wrapped
    # One slice: no MEGASCALE block for a notebook.
    one = copy.deepcopy(base)
    pods.inject_gpu(one, one["containers"][0], ns="user1", name="nb",
                    spec=topology.slice_spec(H100, 8))
    assert not any(k.startswith("MEGASCALE")
                   for k in _env(one["containers"][0]))


@pytest.mark.parametrize("alloc", [2, 1])
def test_job_worker_pods_equal_the_reference(alloc):
    kube = FakeKube()
    kube.add_namespace("jobs")
    job = {"apiVersion": "kubeflow.org/v1alpha1", "kind": "TPUJob",
           "metadata": {"name": "tjob", "namespace": "jobs"},
           "spec": {"tpu": {"accelerator": "v5e", "topology": "1x16",
                            "slices": 2},
                    "checkpointDir": "/ckpt/tjob",
                    "template": {"spec": {"containers": [{
                        "name": "trainer", "image": "trainer",
                        "command": ["python", "-m", "kubeflow_tpu.train.run",
                                    "--model", "llama_1b4"],
                        "args": ["--steps", "10"]}]}}}}
    kube.create(job)
    job = kube.get(TPUJOB, "tjob", "jobs")
    r = TPUJobReconciler(kube)
    spec = topology.slice_spec(H100, 16, 2)
    for s in range(alloc):
        ref = _pod_of(r.generate_statefulset(job, s, 0, num_slices=alloc))
        template = copy.deepcopy(job["spec"]["template"]["spec"])
        main = template["containers"][0]
        main["command"][2] = "kubeflow_tpu_torch.train.run"
        got = copy.deepcopy(template)
        container = pods.job_worker_container(
            got, ns="jobs", name="tjob", spec=spec, slice_idx=s,
            num_slices=alloc, cluster_domain=r.cluster_domain,
            checkpoint_dir="/ckpt/tjob")
        assert container is got["containers"][0]
        ref_cmd = ref["containers"][0]["command"]
        assert container["command"] == pods.LAUNCHER + [
            "python", "-m", "kubeflow_tpu_torch.train.run", "--model",
            "llama_1b4"]
        assert ref_cmd == ["python", "-m", "kubeflow_tpu.train.run"] + \
            container["command"][len(pods.LAUNCHER) + 3:]
        ref_rest, got_rest = _split(ref, got)
        del ref_rest["containers"][0]["command"]
        del got_rest["containers"][0]["command"]
        assert got_rest == ref_rest
        env = {k: e.get("value") for k, e in _env(container).items()}
        assert (env["MEGASCALE_NUM_SLICES"], env["KFT_SPEC_SLICES"],
                env["KFT_CHECKPOINT_DIR"]) == (str(alloc), "2", "/ckpt/tjob")
    # A one-slice job still carries the MEGASCALE block.
    one = {"containers": [{"command": ["python", "x.py"]}]}
    env = _env(pods.job_worker_container(
        one, ns="jobs", name="j", spec=topology.slice_spec(H100, 1)))
    assert env["MEGASCALE_NUM_SLICES"]["value"] == "1"
    assert one["containers"][0]["name"] == "worker"
    with pytest.raises(ValueError, match="command"):
        pods.job_worker_container({"containers": [{"image": "x"}]},
                                  ns="jobs", name="j",
                                  spec=topology.slice_spec(H100, 1))


@pytest.mark.parametrize("mesh", [None, "tp=8"])
def test_serving_deployment_equals_the_reference(mesh):
    kube = FakeKube()
    kube.add_namespace("serve")
    svc = {"apiVersion": "kubeflow.org/v1alpha1", "kind": "InferenceService",
           "metadata": {"name": "llm", "namespace": "serve"},
           "spec": {"model": "llama3_8b", "port": 9000,
                    "tpu": {"accelerator": "v5e", "topology": "2x4"},
                    "checkpointDir": "/ckpt/llm", "quantize": "int8",
                    "maxSeqLen": 4096}}
    if mesh:
        svc["spec"]["mesh"] = mesh
    kube.create(svc)
    svc = kube.get(INFERENCESERVICE, "llm", "serve")
    r = InferenceServiceReconciler(kube, scraper=lambda url: None,
                                   sync_period=0.01, now=lambda: 1000.0)
    ref = r.generate_deployment(svc, 3, 2)
    got = pods.serving_deployment(
        ns="serve", name="llm", revision=3, replicas=2, model="llama3_8b",
        spec=topology.slice_spec(H100, 8), image=r.image,
        port=isvc_api.port_of(svc), checkpoint_dir="/ckpt/llm",
        quantize="int8", mesh=mesh, max_seq_len=4096)
    assert ref["metadata"].pop("ownerReferences")   # the controller's
    ref_cmd = ref["spec"]["template"]["spec"]["containers"][0]["command"]
    got_cmd = got["spec"]["template"]["spec"]["containers"][0]["command"]
    want = ["python", "-m", "kubeflow_tpu_torch.models.serve"] + ref_cmd[3:]
    assert got_cmd == (pods.LAUNCHER + want if mesh else want)
    assert ("--mesh" in got_cmd) == bool(mesh)
    ref_pod, got_pod = _pod_of(ref), _pod_of(got)
    for kind in ("limits", "requests"):
        res = got_pod["containers"][0]["resources"][kind]
        assert res == {GPU_KEY: "8"} and \
            ref_pod["containers"][0]["resources"][kind] == {TPU_KEY: "8"}
        ref_pod["containers"][0]["resources"][kind] = res
    assert ref_pod.pop("nodeSelector") == \
        tpu_topology.slice_spec("v5e", "2x4").node_selectors()
    assert got_pod.pop("nodeSelector") == {
        topology.LABEL_GPU_PRODUCT: "NVIDIA-H100-80GB-HBM3"}
    got_env = got_pod["containers"][0]["env"]
    assert got_env.pop() == {"name": "KFT_GPUS_PER_HOST", "value": "8"}
    for pod in (ref_pod, got_pod):
        del pod["containers"][0]["command"]
    assert got == ref


def test_serving_is_one_host():
    for args in [(H100, 16, 1), (H100, 8, 2), (H100, 1, 2)]:
        with pytest.raises(ValueError, match="one host"):
            pods.serving_container(model="llama3_8b", revision=1, image="x",
                                   spec=topology.slice_spec(*args))
    svc = {"metadata": {"name": "llm"},
           "spec": {"model": "m", "tpu": {"accelerator": "v5e",
                                          "topology": "4x4"}}}
    with pytest.raises(isvc_api.ValidationError, match="single-host"):
        isvc_api.validate(svc)


# -- the env's round trip to a launcher's ranks -------------------------------


def _kubelet_env(container, ordinal, address=None):
    """The container's env as the kubelet resolves it: the pod-index
    fieldRef becomes ``ordinal``; with ``address``, every worker name in
    a value becomes it (no cluster DNS here)."""
    out = {}
    for e in container["env"]:
        if "valueFrom" in e:
            assert e["valueFrom"] == {"fieldRef": {"fieldPath": POD_INDEX}}
            out[e["name"]] = str(ordinal)
        else:
            out[e["name"]] = e["value"]
    if address is not None:
        for k in ("TPU_WORKER_HOSTNAMES", "MEGASCALE_COORDINATOR_ADDRESS"):
            out[k] = ",".join(address for _ in out[k].split(","))
    return out


@pytest.mark.parametrize("slices", [1, 2])
@pytest.mark.parametrize("hosts", [1, 2])
@pytest.mark.parametrize("gpus", [1, 2, 8])
def test_launcher_ranks_round_trip(slices, hosts, gpus):
    """Every pod's env through ``launch_grid`` and ``worker_envs``: the
    global ranks 0..S*H*G-1 once each, pod (s, i) holding [(s*H+i)*G,
    (s*H+i+1)*G), at the reference's coordinator and process id."""
    acc = topology.GpuAccelerator("test", "TEST", gpus, 80)
    spec = topology.GpuSliceSpec(acc, gpus * hosts, hosts, gpus, slices)
    port = 4321
    ranks = []
    for s in range(slices):
        for i in range(hosts):
            pod = {"containers": [{"command": ["python", "train.py"]}]}
            main = pods.job_worker_container(pod, ns="ns", name="job",
                                             spec=spec, slice_idx=s)
            env = _kubelet_env(main, i)
            addr, mport, nnodes, node_rank, nproc = launch.launch_grid(
                envspec.worker_env_from(env), int(env["KFT_GPUS_PER_HOST"]),
                port=port)
            assert nproc == gpus and nnodes == slices * hosts
            want = jax_dist.process_grid(jax_envspec.worker_env_from(env),
                                         coordinator_port=port)
            if want is None:
                assert (addr, mport, node_rank) == ("127.0.0.1", port, 0)
            else:
                assert (f"{addr}:{mport}", nnodes, node_rank) == want
                assert addr == "job-0.job-workers.ns.svc.cluster.local"
            envs = launch.worker_envs((addr, mport, nnodes, node_rank,
                                       nproc))
            got = [int(e["RANK"]) for e in envs]
            assert [e["LOCAL_RANK"] for e in envs] == [
                str(local) for local in range(nproc)]
            assert {e["WORLD_SIZE"] for e in envs} == {
                str(slices * hosts * gpus)}
            first = (s * hosts + i) * gpus
            assert got == list(range(first, first + gpus))
            ranks += got
    assert sorted(ranks) == list(range(slices * hosts * gpus))


def test_launch_grid_defaults_and_refusals():
    env = envspec.worker_env_from({})
    assert launch.launch_grid(env, 4) == ("127.0.0.1", None, 1, 0, 4)
    env = envspec.worker_env_from({"TPU_WORKER_ID": "1",
                                   "TPU_WORKER_HOSTNAMES": "h0,h1"})
    assert launch.launch_grid(env, 8) == ("h0", 8476, 2, 1, 8)
    with pytest.raises(ValueError):
        launch.launch_grid(env, 0)
    for bad in [{}, {"KFT_GPUS_PER_HOST": "0"},
                {"KFT_GPUS_PER_HOST": "two"}]:
        with pytest.raises(ValueError, match="KFT_GPUS_PER_HOST"):
            launch.gpus_per_host(bad)
    assert launch.gpus_per_host({"KFT_GPUS_PER_HOST": "8"}) == 8
    envs = launch.worker_envs(("a", 1, 2, 1, 8))
    assert len(envs) == 8
    assert envs[3] == {"MASTER_ADDR": "a", "MASTER_PORT": "1",
                       "WORLD_SIZE": "16", "RANK": "11", "LOCAL_RANK": "3"}


def test_launcher_refuses_without_the_gpus(monkeypatch, capsys):
    """``--device cuda`` (the default) on a host without the GPUs stops,
    as does a pod without KFT_GPUS_PER_HOST or a command; nothing is
    started."""
    monkeypatch.setattr(launch, "supervise", None)   # never reached
    for gpus, args, said in [
            ("1", ["--", "true"], "has 0 CUDA device"),
            (None, ["--device", "cpu", "--", "true"], "KFT_GPUS_PER_HOST"),
            ("1", ["--device", "cpu"], "no command")]:
        if gpus is None:
            monkeypatch.delenv("KFT_GPUS_PER_HOST", raising=False)
        else:
            monkeypatch.setenv("KFT_GPUS_PER_HOST", gpus)
        with pytest.raises(SystemExit) as exit_:
            launch.main(args)
        assert exit_.value.code == 2
        assert said in capsys.readouterr().err


# -- one launcher world over gloo ---------------------------------------------

CHILD = textwrap.dedent("""
    import datetime, os, sys
    import torch, torch.distributed as td
    from kubeflow_tpu_torch.parallel import dist
    assert dist.initialize_from_env(
        device_type="cpu", timeout=datetime.timedelta(seconds=50))
    t = torch.tensor([float(td.get_rank())])
    td.all_reduce(t)
    # One write a line: under unbuffered output (PYTHONUNBUFFERED) print
    # writes the text and the newline apart, and the launcher's processes
    # share one pipe.
    sys.stdout.write(" ".join(str(v) for v in (
        "RANK", os.environ["TPU_WORKER_ID"], td.get_rank(),
        td.get_world_size(), os.environ["LOCAL_RANK"], int(t.item()))) + "\\n")
    sys.stdout.flush()
    td.destroy_process_group()
""")


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_launcher_world_over_gloo():
    """2 pods x 2 processes: each pod a launcher with the env
    ``job_worker_container`` built (worker names resolved to 127.0.0.1);
    every child joins one world of 4, ranks slice-major."""
    spec = topology.GpuSliceSpec(
        topology.GpuAccelerator("test", "TEST", 2, 80), 4, 2, 2, 1)
    port = _free_port()
    procs = []
    for i in range(2):
        pod = {"containers": [{"command": ["python", "-c", CHILD]}]}
        main = pods.job_worker_container(pod, ns="ns", name="job",
                                         spec=spec)
        env = _kubelet_env(main, i, address="127.0.0.1")
        cmd = main["command"]
        assert cmd[:len(pods.LAUNCHER)] == pods.LAUNCHER
        cmd = ([sys.executable] + cmd[1:len(pods.LAUNCHER) - 1]
               + ["--device", "cpu", "--master-port", str(port), "--",
                  sys.executable] + cmd[len(pods.LAUNCHER) + 1:])
        procs.append(subprocess.Popen(
            cmd, cwd=REPO, env=worker_env(env), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = wait_all(procs, timeout=60)
    rows = sorted(tuple(int(x) for x in line.split()[1:])
                  for out in outs for line in out.splitlines()
                  if line.startswith("RANK "))
    # (worker id, rank, world, local rank, sum of ranks)
    assert rows == [(0, 0, 4, 0, 6), (0, 1, 4, 1, 6), (1, 2, 4, 0, 6),
                    (1, 3, 4, 1, 6)]
