"""The port's PodDefault webhook (``kubeflow_tpu_torch/platform/webhook/``
and ``apis/poddefault.py``) against the JAX package's: for the same
PodDefaults and pod, ``filter_pod_defaults`` selects the same,
``apply_pod_defaults`` gives the same pod, ``safe_to_apply`` the same
refusal and ``mutate_admission_review`` the same response, JSON patch
included.  The cases are the reference's own
(``tests/ctrlplane/test_webhook.py``).  The reference's response is
taken with its Python patch, the one the port computes (its native
engine, where built, emits the same patch by its own tests).  Every
compare is exact."""
import base64
import copy
import json

import pytest

from kubeflow_tpu.platform import native as jax_native
from kubeflow_tpu.platform.apis import poddefault as jax_pd
from kubeflow_tpu.platform.webhook import jsonpatch as jax_jsonpatch
from kubeflow_tpu.platform.webhook import mutate as jax_mutate
from kubeflow_tpu_torch.platform import gpu_pod_default, mutate_admission_review
from kubeflow_tpu_torch.platform.apis import poddefault
from kubeflow_tpu_torch.platform.webhook import jsonpatch, mutate

H100 = "h100-80gb"


@pytest.fixture(autouse=True)
def python_patch(monkeypatch):
    """The reference's ``create_patch_fast`` on its Python diff."""
    monkeypatch.setattr(jax_native, "available", lambda: False)


def make_pod(labels=None, annotations=None, env=None, command=None):
    pod = {
        "apiVersion": "v1", "kind": "Pod",
        "metadata": {"name": "nb-0", "namespace": "user1",
                     "labels": labels or {},
                     "annotations": annotations or {}},
        "spec": {"containers": [
            {"name": "notebook", "image": "jupyter", "env": env or []},
            {"name": "istio-proxy", "image": "proxy"}]},
    }
    if command:
        pod["spec"]["containers"][0]["command"] = command
    return pod


def make_pd(name="pd", selector=None, **spec):
    return {"apiVersion": "kubeflow.org/v1alpha1", "kind": "PodDefault",
            "metadata": {"name": name, "namespace": "user1",
                         "resourceVersion": "7"},
            "spec": {"selector": selector or {"matchLabels": {
                "use-pd": "true"}}, **spec}}


ON = {"use-pd": "true"}
CASES = {
    "env-volume-mount": (make_pod(ON), [make_pd(
        env=[{"name": "FOO", "value": "1"}],
        volumes=[{"name": "v", "emptyDir": {}}],
        volumeMounts=[{"name": "v", "mountPath": "/v"}])]),
    "identical-collision": (
        make_pod(ON, env=[{"name": "FOO", "value": "1"}]),
        [make_pd(env=[{"name": "FOO", "value": "1"}])]),
    "env-conflict": (
        make_pod(ON, env=[{"name": "FOO", "value": "1"}]),
        [make_pd(env=[{"name": "FOO", "value": "2"}])]),
    "command-unset": (make_pod(ON), [make_pd(command=["run.sh"],
                                             args=["--fast"])]),
    "command-set": (make_pod(ON, command=["mine.sh"]),
                    [make_pd(command=["run.sh"], args=["--fast"])]),
    "sidecar-tolerations": (make_pod(ON), [make_pd(
        sidecars=[{"name": "logger", "image": "fluentd"}],
        tolerations=[{"key": "nvidia.com/gpu", "operator": "Exists",
                      "effect": "NoSchedule"}])]),
    "toleration-conflict": (make_pod(ON), [
        make_pd("a", tolerations=[{"key": "k", "value": "1"}]),
        make_pd("b", tolerations=[{"key": "k", "value": "2"}])]),
    "labels-annotations": (make_pod(ON, annotations={"x": "1"}), [make_pd(
        labels={"team": "a"}, annotations={"y": "2"},
        serviceAccountName="sa", automountServiceAccountToken=False,
        imagePullSecrets=[{"name": "reg"}],
        envFrom=[{"configMapRef": {"name": "cm"}}],
        initContainers=[{"name": "init", "image": "busybox"}])]),
    "annotation-conflict": (make_pod(ON, annotations={"y": "mine"}),
                            [make_pd(annotations={"y": "2"})]),
    "two-in-name-order": (make_pod(ON), [
        make_pd("b", env=[{"name": "B", "value": "1"}]),
        make_pd("a", env=[{"name": "A", "value": "1"}])]),
    "match-expressions": (make_pod({"tier": "gold"}), [make_pd(selector={
        "matchExpressions": [
            {"key": "tier", "operator": "In", "values": ["gold", "silver"]},
            {"key": "legacy", "operator": "DoesNotExist"}]},
        env=[{"name": "GOLD", "value": "1"}])]),
    "not-selected": (make_pod({"tier": "bronze"}), [make_pd(selector={
        "matchExpressions": [{"key": "tier", "operator": "NotIn",
                              "values": ["bronze"]}]})]),
    "excluded": (make_pod(ON, annotations={
        mutate.EXCLUDE_ANNOTATION: "true"}), [make_pd(
            env=[{"name": "FOO", "value": "1"}])]),
    "mirror-pod": (make_pod(ON, annotations={
        mutate.MIRROR_ANNOTATION: "x"}), [make_pd(
            env=[{"name": "FOO", "value": "1"}])]),
    "gpu-pod-default": (make_pod({"gpu-h100-80gb": "true"}),
                        [gpu_pod_default("user1", H100, 8)]),
    "gpu-identical-env": (
        make_pod({"gpu-h100-80gb": "true"},
                 env=[{"name": "KFT_GPUS_PER_HOST", "value": "8"}]),
        [gpu_pod_default("user1", H100)]),
    "gpu-env-conflict": (
        make_pod({"gpu-h100-80gb": "true"},
                 env=[{"name": "KFT_GPUS_PER_HOST", "value": "1"}]),
        [gpu_pod_default("user1", H100)]),
}


def _review(pod, resource="pods", uid="u1"):
    return {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
            "request": {"uid": uid, "namespace": "user1",
                        "resource": {"group": "", "version": "v1",
                                     "resource": resource},
                        "object": pod}}


@pytest.mark.parametrize("case", sorted(CASES))
def test_merge_and_review_equal_the_reference(case):
    pod, pds = CASES[case]
    pod0, pds0 = copy.deepcopy(pod), copy.deepcopy(pds)
    selected = mutate.filter_pod_defaults(pds, pod)
    assert selected == jax_mutate.filter_pod_defaults(pds, pod)
    refusal = mutate.safe_to_apply(pod, selected)
    assert refusal == jax_mutate.safe_to_apply(pod, selected)
    if refusal is None:
        got = mutate.apply_pod_defaults(pod, selected)
        assert got == jax_mutate.apply_pod_defaults(pod, selected)
    else:
        with pytest.raises(mutate.MergeConflict, match="conflict|exists"):
            mutate.apply_pod_defaults(pod, selected)
    review = mutate_admission_review(_review(pod), pds)
    assert review == jax_mutate.mutate_admission_review(_review(pod), pds)
    response = review["response"]
    assert response["allowed"] and response["uid"] == "u1"
    if refusal is not None:
        assert "patch" not in response
        assert response["status"]["message"].startswith(
            "skipping PodDefaults: ")
    elif selected:
        patch = json.loads(base64.b64decode(response["patch"]))
        assert response["patchType"] == "JSONPatch"
        assert jsonpatch.apply_patch(pod, patch) == \
            mutate.apply_pod_defaults(pod, selected)
    else:
        assert "patch" not in response
    # Nothing the caller handed in is touched.
    assert (pod, pds) == (pod0, pds0)


def test_non_pod_review_is_allowed_as_the_reference():
    review = _review({"kind": "Service"}, resource="services", uid="u9")
    got = mutate_admission_review(review, [make_pd()])
    assert got == jax_mutate.mutate_admission_review(review, [make_pd()])
    assert got["response"] == {"uid": "u9", "allowed": True}
    bare = {"request": {"uid": "u3", "resource": {"resource": "pods"},
                        "object": make_pod(ON)}}
    assert mutate_admission_review(bare, [make_pd()]) == \
        jax_mutate.mutate_admission_review(bare, [make_pd()])


@pytest.mark.parametrize("before,after", [
    ({"a": {"b": 1, "drop": 2}, "list": [1, 2], "keep": "x"},
     {"a": {"b": 9, "new": {"deep": True}}, "list": [1, 2, 3], "keep": "x"}),
    ({"metadata": {"annotations": {}}},
     {"metadata": {"annotations": {"a/b~c": "v"}}}),
    ({"x": 1}, {"x": "1"}),
    ([1, 2], {"now": "a map"}),
])
def test_jsonpatch_equals_the_reference(before, after):
    patch = jsonpatch.create_patch(before, after)
    assert patch == jax_jsonpatch.create_patch(before, after)
    assert jsonpatch.apply_patch(before, patch) == after
    ops = [{"op": "add", "path": "/n", "value": [1]},
           {"op": "add", "path": "/n/-", "value": 2},
           {"op": "copy", "from": "/n", "path": "/m"},
           {"op": "move", "from": "/m", "path": "/o"},
           {"op": "replace", "path": "/n/0", "value": 0},
           {"op": "test", "path": "/n/1", "value": 2},
           {"op": "remove", "path": "/o"}]
    doc = {"keep": True}
    assert jsonpatch.apply_patch(doc, ops) == \
        jax_jsonpatch.apply_patch(doc, ops)
    for bad in ([{"op": "remove", "path": "/gone"}],
                [{"op": "test", "path": "/keep", "value": False}],
                [{"op": "nope", "path": "/keep"}],
                [{"op": "add", "path": "relative", "value": 1}]):
        with pytest.raises(jsonpatch.PatchError):
            jsonpatch.apply_patch(doc, bad)
        with pytest.raises(jax_jsonpatch.PatchError):
            jax_jsonpatch.apply_patch(doc, bad)


@pytest.mark.parametrize("gpus", [None, 1, 4, 16])
def test_gpu_pod_default_is_the_tpu_one_with_the_gpu_env(gpus):
    """The same label scheme, selector and memory-backed /dev/shm as the
    reference's ``tpu_pod_default``; ``KFT_GPUS_PER_HOST`` (the GPUs of
    one host of the slice) in place of the libtpu-only names."""
    got = poddefault.gpu_pod_default("user1", H100, gpus)
    want = jax_pd.tpu_pod_default("user1", "v5e", "2x4")
    host = 8 if gpus is None or gpus > 8 else gpus
    assert got["metadata"] == {"name": "gpu-h100-80gb",
                               "namespace": "user1"}
    assert want["metadata"]["name"] == "tpu-v5e"
    assert got["spec"]["selector"] == {"matchLabels": {
        "gpu-h100-80gb": "true"}}
    assert got["spec"]["env"] == [{"name": "KFT_GPUS_PER_HOST",
                                   "value": str(host)}]
    assert "GPU h100-80gb runtime" in got["spec"]["desc"]
    for key in ("volumes", "volumeMounts"):
        assert json.dumps(got["spec"][key]).replace("gpu-shm", "tpu-shm") \
            == json.dumps(want["spec"][key])
    assert set(got) == set(want) and set(got["spec"]) == set(want["spec"])
    assert poddefault.crd_manifest() == jax_pd.crd_manifest()
    with pytest.raises(ValueError):
        poddefault.gpu_pod_default("user1", H100, 12)
