"""The port's profile controller (``kubeflow_tpu_torch/platform/
controllers/profile.py``) against the JAX package's: the reference's
eight cases (``tests/ctrlplane/test_profile_controller.py``), each run
on both reconcilers over their own ``FakeKube``, with every object the
reconcile leaves compared after ``uid``, ``creationTimestamp`` and the
causal context's annotations (a random trace id) are stripped.

The one mapping: the reference's quota asks ``google.com/tpu`` and the
port's ``nvidia.com/gpu``, the same count; the quota's key is compared
after the port's is renamed to the reference's."""
import importlib
import json
import time
from types import SimpleNamespace

import pytest

TPU_KEY, GPU_KEY = "google.com/tpu", "nvidia.com/gpu"


def package(root):
    def mod(name):
        return importlib.import_module(f"{root}.platform.{name}")

    return SimpleNamespace(
        root=root, profile=mod("controllers.profile"),
        FakeKube=mod("testing.fake").FakeKube, errors=mod("k8s.errors"),
        types=mod("k8s.types"), Request=mod("runtime.controller").Request,
        metrics=mod("runtime.metrics"),
        gpu=root.endswith("_torch"))


REF = package("kubeflow_tpu")
PORT = package("kubeflow_tpu_torch")


def device_key(P):
    return GPU_KEY if P.gpu else TPU_KEY


def make_profile(P, name="alice", owner="alice@example.com", quota=None,
                 plugins=None):
    p = {"apiVersion": "kubeflow.org/v1", "kind": "Profile",
         "metadata": {"name": name},
         "spec": {"owner": {"kind": "User", "name": owner}}}
    if quota:
        hard = {(device_key(P) if k == "device" else k): v
                for k, v in quota["hard"].items()}
        p["spec"]["resourceQuotaSpec"] = {"hard": hard}
    if plugins:
        p["spec"]["plugins"] = plugins
    return p


def kube_of(P):
    k = P.FakeKube()
    k.add_namespace("default")
    return k


# Minted at random by each API server or reconcile: the causal
# context's annotations (telemetry/causal.py) are dropped with the uid.
RANDOM = ("uid", "creationTimestamp", "kubeflow.org/traceparent",
          "kubeflow.org/tracestate")


def strip(x):
    if isinstance(x, dict):
        return {(TPU_KEY if k == GPU_KEY else k): strip(v)
                for k, v in x.items() if k not in RANDOM}
    if isinstance(x, list):
        return [strip(v) for v in x]
    return x


def world(P, kube):
    """Every object of the kinds a Profile's reconcile writes, stripped
    and sorted, plus the Profile's status and the Warning events'
    reasons."""
    t = P.types
    out = {}
    for gvk in (t.NAMESPACE, t.SERVICEACCOUNT, t.ROLEBINDING,
                t.AUTHORIZATIONPOLICY, t.RESOURCEQUOTA, t.PROFILE):
        objs = [strip(json.loads(json.dumps(o, default=t.json_default)))
                for o in kube.list(gvk)]
        for o in objs:
            o.get("metadata", {}).pop("resourceVersion", None)
        out[gvk.kind] = sorted(objs, key=lambda o: json.dumps(o,
                                                              sort_keys=True))
    out["events"] = sorted(e.get("reason") for e in kube.list(t.EVENT))
    return out


def both(script):
    return script(REF), script(PORT)


def reconcile(P, kube, **kwargs):
    r = P.profile.ProfileReconciler(kube, **kwargs)
    r.reconcile(P.Request("", "alice"))
    return r


def test_profile_creates_workspace_with_a_gpu_quota():
    def script(P):
        kube = kube_of(P)
        kube.create(make_profile(P, quota={"hard": {"device": "32",
                                                    "cpu": "64"}}))
        reconcile(P, kube)
        return world(P, kube)

    ref, got = both(script)
    assert got == ref
    (quota,) = got["ResourceQuota"]
    assert quota["metadata"]["name"] == "kf-resource-quota"
    assert quota["spec"]["hard"] == {TPU_KEY: "32", "cpu": "64"}
    (policy,) = got["AuthorizationPolicy"]
    assert policy["spec"]["rules"][0]["when"][0]["values"] == [
        "alice@example.com"]
    assert policy["spec"]["rules"][2]["to"][0]["operation"]["paths"] == [
        "*/api/kernels"]
    assert {o["metadata"]["name"] for o in got["ServiceAccount"]} == {
        "default-editor", "default-viewer"}
    assert {o["metadata"]["name"] for o in got["RoleBinding"]} == {
        "default-editor", "default-viewer", "namespaceAdmin"}
    (profile,) = got["Profile"]
    assert profile["status"] == {"status": "Succeeded", "message": ""}
    assert profile["metadata"]["finalizers"] == ["profile-finalizer"]
    # The port's quota is on the GPU key.
    kube = kube_of(PORT)
    kube.create(make_profile(PORT, quota={"hard": {"device": "1"}}))
    reconcile(PORT, kube)
    assert kube.get(PORT.types.RESOURCEQUOTA, "kf-resource-quota",
                    "alice")["spec"]["hard"] == {GPU_KEY: "1"}


def test_foreign_namespace_not_taken_over():
    def script(P):
        kube = kube_of(P)
        kube.add_namespace("alice")  # pre-existing, no owner annotation
        kube.create(make_profile(P))
        reconcile(P, kube)
        # Another owner's namespace is refused too.
        kube.create(make_profile(P, name="bob-ns", owner="bob@example.com"))
        ns = kube.get(P.types.NAMESPACE, "alice")
        ns["metadata"]["annotations"] = {"owner": "carol@example.com"}
        kube.update(ns)
        reconcile(P, kube)
        return world(P, kube)

    ref, got = both(script)
    assert got == ref
    (alice,) = [p for p in got["Profile"]
                if p["metadata"]["name"] == "alice"]
    assert alice["status"]["status"] == "Failed"
    assert "carol@example.com" in alice["status"]["message"]
    assert got["ServiceAccount"] == [] and got["events"] == [
        "ProfileFailed", "ProfileFailed"]


def test_quota_removed_when_spec_cleared():
    def script(P):
        kube = kube_of(P)
        kube.create(make_profile(P, quota={"hard": {"device": "8"}}))
        reconcile(P, kube)
        first = world(P, kube)["ResourceQuota"]
        p = kube.get(P.types.PROFILE, "alice")
        del p["spec"]["resourceQuotaSpec"]
        kube.update(p)
        reconcile(P, kube)
        return first, world(P, kube)

    ref, got = both(script)
    assert got == ref
    assert len(got[0]) == 1 and got[1]["ResourceQuota"] == []


def test_workload_identity_plugin_and_finalizer():
    def script(P):
        kube = kube_of(P)
        iam_calls = []
        plugin = P.profile.WorkloadIdentityPlugin(
            bind_iam=lambda sa, member, add: iam_calls.append(
                (sa, member, add)),
            identity_pool="proj.svc.id.goog")
        kube.create(make_profile(P, plugins=[
            {"kind": "WorkloadIdentity",
             "spec": {"gcpServiceAccount": "ml@proj.iam.gserviceaccount.com"}},
            {"kind": "Unknown", "spec": {}}]))
        r = P.profile.ProfileReconciler(kube, plugins=[plugin])
        r.reconcile(P.Request("", "alice"))
        applied = world(P, kube)
        kube.delete(P.types.PROFILE, "alice")
        r.reconcile(P.Request("", "alice"))
        try:
            kube.get(P.types.PROFILE, "alice")
            gone = False
        except P.errors.NotFound:
            gone = True
        return applied, iam_calls, gone

    ref, got = both(script)
    assert got == ref
    applied, calls, gone = got
    (editor,) = [sa for sa in applied["ServiceAccount"]
                 if sa["metadata"]["name"] == "default-editor"]
    assert editor["metadata"]["annotations"][
        "iam.gke.io/gcp-service-account"] == \
        "ml@proj.iam.gserviceaccount.com"
    assert calls == [
        ("ml@proj.iam.gserviceaccount.com",
         "serviceAccount:proj.svc.id.goog[alice/default-editor]", True),
        ("ml@proj.iam.gserviceaccount.com",
         "serviceAccount:proj.svc.id.goog[alice/default-editor]", False)]
    assert gone and applied["events"] == ["UnknownPlugin"]


def test_irsa_plugin_equals_the_reference():
    def script(P):
        kube = kube_of(P)
        edits = []
        plugin = P.profile.IrsaPlugin(
            edit_trust=lambda arn, sa, add: edits.append((arn, sa, add)))
        kube.create(make_profile(P, plugins=[{
            "kind": "AwsIamForServiceAccount",
            "spec": {"awsIamRole": "arn:aws:iam::1:role/x"}}]))
        r = P.profile.ProfileReconciler(kube, plugins=[plugin])
        r.reconcile(P.Request("", "alice"))
        kube.delete(P.types.PROFILE, "alice")
        r.reconcile(P.Request("", "alice"))
        return world(P, kube), edits

    ref, got = both(script)
    assert got == ref
    assert [add for _a, _s, add in got[1]] == [True, False]


def test_idempotent():
    def script(P):
        kube = kube_of(P)
        kube.create(make_profile(P, quota={"hard": {"cpu": "4",
                                                    "device": "2"}}))
        reconcile(P, kube)
        before = {g.kind: [o["metadata"]["resourceVersion"]
                           for o in kube.list(g)]
                  for g in (P.types.RESOURCEQUOTA, P.types.ROLEBINDING,
                            P.types.AUTHORIZATIONPOLICY)}
        reconcile(P, kube)
        after = {g.kind: [o["metadata"]["resourceVersion"]
                          for o in kube.list(g)]
                 for g in (P.types.RESOURCEQUOTA, P.types.ROLEBINDING,
                           P.types.AUTHORIZATIONPOLICY)}
        return before == after, world(P, kube)

    ref, got = both(script)
    assert got == ref
    assert got[0] is True


def test_namespace_labels_hot_reload(tmp_path):
    def script(P):
        labels = tmp_path / f"{P.root}-namespace-labels"
        labels.write_text("istio-injection: enabled\n")
        kube = kube_of(P)
        kube.create(make_profile(P))
        r = P.profile.ProfileReconciler(
            kube, default_namespace_labels_path=str(labels))
        r.reconcile(P.Request("", "alice"))
        first = dict(kube.get(P.types.NAMESPACE, "alice")["metadata"][
            "labels"])
        labels.write_text("istio-injection: enabled\nteam: ml\n"
                          "# a comment\nquoted: 'x y'\n")
        r.reconcile(P.Request("", "alice"))
        second = dict(kube.get(P.types.NAMESPACE, "alice")["metadata"][
            "labels"])
        return first, second

    ref, got = both(script)
    assert got == ref
    assert got[0] == {"istio-injection": "enabled"}
    assert got[1]["team"] == "ml" and got[1]["quoted"] == "x y"


def test_labels_file_watcher_triggers_reconcile_all(tmp_path):
    def wait_label(P, kube, key, value):
        deadline = time.time() + 5
        while time.time() < deadline:
            try:
                ns = kube.get(P.types.NAMESPACE, "alice")
                if ns["metadata"]["labels"].get(key) == value:
                    return True
            except P.errors.NotFound:
                pass
            time.sleep(0.02)
        return False

    def script(P):
        labels = tmp_path / f"{P.root}-labels"
        labels.write_text("a: b\n")
        kube = kube_of(P)
        kube.create(make_profile(P))
        c = P.profile.make_controller(
            kube, default_namespace_labels_path=str(labels))
        shape = (c.name, c.primary.kind, c.resync_period,
                 sorted(c.informers), len(c.runnables))
        c.runnables = [P.profile.labels_file_watcher(str(labels),
                                                     poll_seconds=0.05)]
        c.start(kube)
        try:
            first = wait_label(P, kube, "a", "b")
            time.sleep(0.1)
            labels.write_text("a: b\nc: d\n")
            second = wait_label(P, kube, "c", "d")
        finally:
            c.stop()
        return shape, first, second

    ref, got = both(script)
    assert got == ref
    assert got == (("profile-controller", "Profile", 300.0, [], 1),
                   True, True)


def test_request_counters_incremented():
    def value(P, kind):
        if P is REF:
            return P.metrics.registry.get_sample_value(
                "request_kf_total",
                {"component": "profile", "kind": kind}) or 0.0
        return P.metrics.request_kf.sample(component="profile",
                                           kind=kind) or 0.0

    kinds = ("namespace", "serviceaccount", "rolebinding",
             "authorizationpolicy", "resourcequota", "plugin")

    def script(P):
        before = [value(P, k) for k in kinds]
        kube = kube_of(P)
        kube.create(make_profile(P, quota={"hard": {"device": "16"}}))
        reconcile(P, kube)
        return [value(P, k) - b for k, b in zip(kinds, before)]

    ref, got = both(script)
    assert got == ref == [1.0] * len(kinds)


def test_heartbeat_rides_the_controller():
    c = PORT.profile.make_controller(kube_of(PORT), heartbeat=True)
    c._on_start()
    assert "profile" in PORT.metrics._heartbeats
    stop = PORT.metrics._heartbeats["profile"]
    assert PORT.metrics.start_heartbeat("profile") is stop
    c._on_stop()
    assert stop.is_set() and "profile" not in PORT.metrics._heartbeats


@pytest.mark.parametrize("text,want", [
    ("", {}), ("a: b\n", {"a": "b"}), ('{"a": 1}', {"a": "1"}),
    ("a: yes\nb: off\nc: 'on'\n", {"a": "True", "b": "False", "c": "on"}),
    ("a: b # tail\n\n# c: d\n", {"a": "b"}),
])
def test_labels_file_reads_as_the_reference_loader(text, want):
    import yaml

    got = PORT.profile.read_labels_file(text)
    assert got == want
    ref = yaml.safe_load(text) or {}
    assert got == {str(k): str(v) for k, v in ref.items()}
