"""The port's tensorboard controller (``kubeflow_tpu_torch/platform/
controllers/tensorboard.py``) against the JAX package's: the
reference's four cases (``tests/ctrlplane/test_tensorboard_controller.
py``) run on both reconcilers over their own ``FakeKube``, with the
Deployment, Service, VirtualService and the Tensorboard's status
compared after ``uid``, ``creationTimestamp`` and the causal context's
annotations (a random trace id) are stripped.  No TPU word is in this
path: the objects compare exactly."""
import importlib
import json
from types import SimpleNamespace

import pytest

RANDOM = ("uid", "creationTimestamp", "resourceVersion",
          "kubeflow.org/traceparent", "kubeflow.org/tracestate")


def package(root):
    def mod(name):
        return importlib.import_module(f"{root}.platform.{name}")

    return SimpleNamespace(
        root=root, tensorboard=mod("controllers.tensorboard"),
        FakeKube=mod("testing.fake").FakeKube, types=mod("k8s.types"),
        Request=mod("runtime.controller").Request)


REF = package("kubeflow_tpu")
PORT = package("kubeflow_tpu_torch")


def strip(x):
    if isinstance(x, dict):
        return {k: strip(v) for k, v in x.items() if k not in RANDOM}
    if isinstance(x, list):
        return [strip(v) for v in x]
    return x


def make_tb(name="tb", logspath="pvc://logs-claim/run1"):
    return {"apiVersion": "tensorboard.kubeflow.org/v1alpha1",
            "kind": "Tensorboard",
            "metadata": {"name": name, "namespace": "user1"},
            "spec": {"logspath": logspath}}


def kube_of(P):
    k = P.FakeKube()
    k.add_namespace("user1")
    return k


def children(P, kube):
    t = P.types
    out = {}
    for gvk in (t.DEPLOYMENT, t.SERVICE, t.VIRTUALSERVICE, t.TENSORBOARD):
        out[gvk.kind] = [strip(json.loads(json.dumps(
            o, default=t.json_default))) for o in kube.list(gvk, "user1")]
    return out


def both(script):
    return script(REF), script(PORT)


def pod_spec(world):
    (dep,) = world["Deployment"]
    return dep["spec"]["template"]["spec"]


def test_pvc_logspath():
    def script(P):
        kube = kube_of(P)
        kube.create(make_tb())
        P.tensorboard.TensorboardReconciler(kube).reconcile(
            P.Request("user1", "tb"))
        return children(P, kube)

    ref, got = both(script)
    assert got == ref
    spec = pod_spec(got)
    assert spec["volumes"][0]["persistentVolumeClaim"]["claimName"] == \
        "logs-claim"
    mount = spec["containers"][0]["volumeMounts"][0]
    assert mount["mountPath"] == "/logs" and mount["subPath"] == "run1"
    assert "--logdir=/logs" in spec["containers"][0]["args"]
    assert "--path_prefix=/tensorboard/user1/tb" in spec["containers"][0][
        "args"]
    assert spec["containers"][0]["image"] == "tensorflow/tensorflow:2.15.0"
    assert got["Service"][0]["spec"]["ports"][0]["targetPort"] == 6006
    assert got["VirtualService"][0]["metadata"]["name"] == \
        "tensorboard-user1-tb"


@pytest.mark.parametrize("secret", [True, False])
def test_gcs_logspath_mounts_creds_when_secret_exists(secret):
    def script(P):
        kube = kube_of(P)
        if secret:
            kube.create({"apiVersion": "v1", "kind": "Secret",
                         "metadata": {"name": "user-gcp-sa",
                                      "namespace": "user1"}})
        kube.create(make_tb(logspath="gs://bucket/logs"))
        P.tensorboard.TensorboardReconciler(kube).reconcile(
            P.Request("user1", "tb"))
        return children(P, kube)

    ref, got = both(script)
    assert got == ref
    spec = pod_spec(got)
    env = {e["name"]: e["value"] for e in spec["containers"][0]["env"]}
    assert ("GOOGLE_APPLICATION_CREDENTIALS" in env) is secret
    assert "--logdir=gs://bucket/logs" in spec["containers"][0]["args"]


@pytest.mark.parametrize("node", ["node-7", None])
def test_rwo_scheduling_affinity(node):
    def script(P):
        kube = kube_of(P)
        kube.create({
            "apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": "nb-0", "namespace": "user1"},
            "spec": {**({"nodeName": node} if node else {}),
                     "volumes": [{"name": "ws", "persistentVolumeClaim": {
                         "claimName": "logs-claim"}}]}})
        kube.create(make_tb())
        P.tensorboard.TensorboardReconciler(
            kube, rwo_pvc_scheduling=True).reconcile(
                P.Request("user1", "tb"))
        return children(P, kube)

    ref, got = both(script)
    assert got == ref
    spec = pod_spec(got)
    if node is None:
        assert "affinity" not in spec
        return
    terms = spec["affinity"]["nodeAffinity"][
        "requiredDuringSchedulingIgnoredDuringExecution"]["nodeSelectorTerms"]
    assert terms[0]["matchExpressions"][0]["values"] == ["node-7"]


def test_status_from_deployment():
    def script(P):
        kube = kube_of(P)
        kube.create(make_tb())
        r = P.tensorboard.TensorboardReconciler(kube)
        r.reconcile(P.Request("user1", "tb"))
        dep = kube.get(P.types.DEPLOYMENT, "tb", "user1")
        dep["status"] = {"readyReplicas": 1,
                         "conditions": [{"type": "Available",
                                         "status": "True"}]}
        kube.update_status(dep)
        r.reconcile(P.Request("user1", "tb"))
        # A steady reconcile writes nothing.
        rv = kube.get(P.types.DEPLOYMENT, "tb", "user1")["metadata"][
            "resourceVersion"]
        r.reconcile(P.Request("user1", "tb"))
        same = kube.get(P.types.DEPLOYMENT, "tb", "user1")["metadata"][
            "resourceVersion"] == rv
        return children(P, kube), same

    ref, got = both(script)
    assert got == ref
    (tb,) = got[0]["Tensorboard"]
    assert tb["status"]["readyReplicas"] == 1 and got[1] is True


def test_make_controller_equals_the_reference():
    def script(P):
        c = P.tensorboard.make_controller(kube_of(P))
        return (c.name, c.primary.kind, [g.kind for g in c.owns],
                c.resync_period, sorted(c.informers))

    ref, got = both(script)
    assert got == ref
