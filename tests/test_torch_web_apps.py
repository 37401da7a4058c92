"""The port's web apps (``kubeflow_tpu_torch/platform/apps/`` and
``kfam/``) against the JAX package's: the JWA, VWA, TWA and KFAM cases
of ``tests/ctrlplane/test_web_apps.py`` (all but its three dashboard
cases) and the spawner's quota cases of ``tests/ctrlplane/
test_quota.py``, each script run on both packages over their own
``FakeKube`` through werkzeug's test ``Client``, with statuses, JSON
bodies and the objects the apps write compared.  ``uid``,
``creationTimestamp`` (and a row's ``age``, which is it) and the causal
context's annotations (a random trace id) are stripped.

The TPU→GPU mapping, stated once (``ref_words``): the port's words are
turned into the reference's and the results then compared exactly.

* ``spec.gpu {accelerator: h100-80gb, gpus: N[, slices]}`` is the
  reference's ``spec.tpu {accelerator: v5e, topology: T[, slices]}``
  with T the v5e topology of N chips (``TOPOLOGY``); both put N devices
  on ceil(N / 8) hosts.  The form's ``gpus`` block and the row's ``gpu``
  field are the reference's ``tpus`` and ``tpu``;
* ``nvidia.com/gpu`` (and its ``requests.``/``limits.`` keys) is
  ``google.com/tpu``; the PodDefault label ``gpu-h100-80gb`` is
  ``tpu-v5e``; the images are ``IMAGES``' pairs (and their short
  names); the picker's ``gpus`` list is the reference's ``tpus``;
* "GPU quota exceeded (requested N, remaining M of H GPUs in ns)" is
  "TPU quota exceeded (requested N, remaining M of H chips in ns)", and
  "GPU count N not offered for h100-80gb" is "topology 'T' not offered
  for v5e"; "Waiting for GPU capacity" and "Insufficient
  nvidia.com/gpu" are the reference's TPU phrases.

The picker's listing is compared on its envelope and quota: a GPU count
is offered where a node holds one of its pods, a TPU topology where a
node carries its label, so the two lists differ by design (the port's
rule is held on its own)."""
import importlib
import json
import os
import re
from types import SimpleNamespace

import pytest
from werkzeug.test import Client

USER = {"kubeflow-userid": "alice@example.com"}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TOPOLOGY = {1: "1x1", 4: "2x2", 8: "2x4", 16: "4x4", 32: "4x8", 64: "8x8",
            256: "16x16"}
IMAGES = {
    "ghcr.io/kubeflow-tpu/jupyter-pytorch-cuda:latest":
        "ghcr.io/kubeflow-tpu/jupyter-jax-tpu:latest",
    "ghcr.io/kubeflow-tpu/jupyter-pytorch-cuda-full:latest":
        "ghcr.io/kubeflow-tpu/jupyter-pytorch-xla:latest",
    "ghcr.io/kubeflow-tpu/codeserver-pytorch-cuda:latest":
        "ghcr.io/kubeflow-tpu/codeserver-jax:latest",
}
WORDS = {"nvidia.com/gpu": "google.com/tpu",
         "requests.nvidia.com/gpu": "requests.google.com/tpu",
         "limits.nvidia.com/gpu": "limits.google.com/tpu",
         "gpu-h100-80gb": "tpu-v5e", "h100-80gb": "v5e",
         "nvidia.com/gpu.product": "cloud.google.com/gke-tpu-accelerator",
         "gpu-node-pool": "tpu-node-pool",
         "Prefer GPU node pool": "Prefer TPU node pool",
         "gpu-reserved": "tpu-reserved",
         "Reserved GPU pool": "Reserved TPU pool", "gpus": "tpus",
         **IMAGES,
         **{a.split("/")[-1]: b.split("/")[-1] for a, b in IMAGES.items()}}
RANDOM = ("uid", "creationTimestamp", "age", "kubeflow.org/traceparent",
          "kubeflow.org/tracestate")
QUOTA_MSG = re.compile(r"GPU quota exceeded \(requested (\d+), remaining "
                       r"(\d+) of (\d+) GPUs in (\S+)\)")
NOT_OFFERED = re.compile(r"GPU count (\d+) not offered for h100-80gb")
SCHEDULING = (("Waiting for GPU capacity", "Waiting for TPU capacity"),
              ("Insufficient nvidia.com/gpu", "Insufficient google.com/tpu"))


def _tpu_block(gpu):
    out = {"accelerator": WORDS.get(gpu["accelerator"], gpu["accelerator"])}
    if gpu.get("gpus"):
        out["topology"] = TOPOLOGY[gpu["gpus"]]
    if gpu.get("slices"):
        out["slices"] = gpu["slices"]
    return out


def ref_words(x):
    """The port's result in the reference's words (the module's
    docstring)."""
    if isinstance(x, dict):
        out = {}
        for k, v in x.items():
            if k in RANDOM:
                continue
            if k == "gpu" and (v is None or "accelerator" in v):
                out["tpu"] = None if v is None else _tpu_block(v)
                continue
            out[WORDS.get(k, k)] = ref_words(v)
        return out
    if isinstance(x, list):
        return [ref_words(v) for v in x]
    if isinstance(x, str):
        x = QUOTA_MSG.sub(r"TPU quota exceeded (requested \1, remaining "
                          r"\2 of \3 chips in \4)", x)
        x = NOT_OFFERED.sub(
            lambda m: f"topology {TOPOLOGY[int(m.group(1))]!r} not offered "
                      f"for v5e", x)
        for gpu, tpu in SCHEDULING:
            x = x.replace(gpu, tpu)
        return WORDS.get(x, x)
    return x


def strip(x):
    """The reference's result with the random fields dropped."""
    if isinstance(x, dict):
        return {k: strip(v) for k, v in x.items() if k not in RANDOM}
    if isinstance(x, list):
        return [strip(v) for v in x]
    return x


def package(root):
    def mod(name):
        return importlib.import_module(f"{root}.platform.{name}")

    return SimpleNamespace(
        root=root, gpu=root.endswith("_torch"),
        FakeKube=mod("testing.fake").FakeKube, types=mod("k8s.types"),
        crud=mod("web.crud_backend"), jupyter=mod("apps.jupyter.app"),
        form=mod("apps.jupyter.form"), status=mod("apps.jupyter.status"),
        volumes=mod("apps.volumes.app"),
        tensorboards=mod("apps.tensorboards.app"), kfam=mod("kfam.app"),
        bindings=mod("kfam.bindings"))


REF = package("kubeflow_tpu")
PORT = package("kubeflow_tpu_torch")


def both(script):
    """``script(P)`` on each package: (reference, port in the reference's
    words)."""
    ref = strip(json.loads(json.dumps(script(REF), default=str)))
    got = ref_words(json.loads(json.dumps(script(PORT), default=str)))
    return ref, got


def kube_of(P, nodes=True):
    k = P.FakeKube()
    k.add_namespace("user1")
    if nodes:
        if P.gpu:
            k.add_gpu_node("node-1", gpus=8)
            k.add_gpu_node("node-2", gpus=8)
        else:
            k.add_tpu_node("node-1", topology="2x4")
            k.add_tpu_node("node-2", topology="4x4")
    return k


def device(P, n, slices=None):
    """The form's device block asking ``n`` devices."""
    if P.gpu:
        block = {"accelerator": "h100-80gb", "gpus": n}
    else:
        block = {"accelerator": "v5e", "topology": TOPOLOGY.get(n, str(n))}
    if slices is not None:
        block["slices"] = slices
    return {"gpus" if P.gpu else "tpus": block}


def picker(P):
    return "/api/namespaces/user1/" + ("gpus" if P.gpu else "tpus")


def quota(P, hard):
    key = "nvidia.com/gpu" if P.gpu else "google.com/tpu"
    return {"apiVersion": "v1", "kind": "ResourceQuota",
            "metadata": {"name": "kf-resource-quota", "namespace": "user1"},
            "spec": {"hard": {(key if k == "device" else k): v
                              for k, v in hard.items()}}}


def client(app, **kw):
    return Client(app, **kw)


def req(c, method, path, body=None, headers=USER):
    kw = {"headers": headers}
    if body is not None:
        kw["json"] = body
    r = c.open(path, method=method, **kw)
    try:
        payload = r.get_json()
    except Exception:  # noqa: BLE001 — a non-JSON body
        payload = r.get_data(as_text=True)
    return r.status_code, payload


def objects(P, kube, gvk_name, ns="user1"):
    gvk = getattr(P.types, gvk_name)
    out = [json.loads(json.dumps(o, default=P.types.json_default))
           for o in kube.list(gvk, ns)]
    for o in out:
        o["metadata"].pop("resourceVersion", None)
    return sorted(out, key=lambda o: o["metadata"]["name"])


def jwa(P, kube, **kw):
    return client(P.jupyter.create_app(kube, auth=P.crud.AuthContext(),
                                       secure_cookies=False, **kw))


# -- JWA ----------------------------------------------------------------------


def test_jwa_requires_identity_header():
    def script(P):
        c = jwa(P, kube_of(P))
        s1, body1 = req(c, "GET", "/api/config", headers={})
        s2, body2 = req(c, "GET", "/api/config")
        return s1, body1, s2, dict.fromkeys(body2["config"], True)

    ref, got = both(script)
    assert got == ref
    assert got[0] == 401 and got[2] == 200 and "tpus" in got[3]


def test_jwa_healthz_no_auth():
    def script(P):
        return req(jwa(P, kube_of(P)), "GET", "/healthz", headers={})

    ref, got = both(script)
    assert got == ref == [200, {"status": "ok"}]


def test_jwa_listing_envelope_and_quota():
    def script(P):
        kube = kube_of(P)
        c = jwa(P, kube)
        out = [req(c, "GET", picker(P))[1]["quota"]]
        kube.create(quota(P, {"device": "24"}))
        status, body = req(c, "GET", picker(P))
        out += [status, sorted(ref_words(body) if P.gpu else body),
                body["quota"],
                [o["accelerator"] for o in body["gpus" if P.gpu else "tpus"]]]
        out.append(req(jwa(P, kube_of(P, nodes=False)), "GET", picker(P)))
        return out

    ref, got = both(script)
    assert got == ref
    assert got[2] == ["quota", "status", "success", "tpus"]
    assert got[3] == {"hard": 24, "used": 0, "remaining": 24}
    assert got[5] == [200, {"success": True, "status": 200, "tpus": [],
                            "quota": None}]


@pytest.mark.parametrize("per_node,offered", [
    (8, [1, 2, 4, 8, 16, 32, 64]), (1, [1]), (4, [1, 2, 4])])
def test_jwa_offers_counts_a_node_holds(per_node, offered):
    kube = kube_of(PORT, nodes=False)
    kube.add_gpu_node("n", gpus=per_node)
    status, body = req(jwa(PORT, kube), "GET", picker(PORT))
    assert status == 200
    assert body["gpus"] == [{"accelerator": "h100-80gb", "gpus": offered}]


def test_jwa_spawn_flow():
    def script(P):
        kube = kube_of(P)
        c = jwa(P, kube)
        body = {"name": "mynb", "serverType": "jupyter", **device(P, 16),
                "configurations": ["gpu-h100-80gb" if P.gpu else "tpu-v5e"]}
        out = [req(c, "POST", "/api/namespaces/user1/notebooks", body)]
        out.append(objects(P, kube, "NOTEBOOK"))
        out.append(objects(P, kube, "PVC"))
        out.append(req(c, "GET", "/api/namespaces/user1/notebooks"))
        out.append(req(c, "GET", "/api/namespaces/user1/notebooks/mynb"))
        return out

    ref, got = both(script)
    assert got == ref
    (nb,) = got[1]
    assert nb["spec"]["tpu"] == {"accelerator": "v5e", "topology": "4x4"}
    container = nb["spec"]["template"]["spec"]["containers"][0]
    assert container["resources"]["limits"]["cpu"] == "4.8"
    assert got[2][0]["metadata"]["name"] == "mynb-workspace"
    # In the port's own words:
    kube = kube_of(PORT)
    req(jwa(PORT, kube), "POST", "/api/namespaces/user1/notebooks",
        {"name": "mynb", **device(PORT, 16)})
    nb = kube.get(PORT.types.NOTEBOOK, "mynb", "user1")
    assert nb["spec"]["gpu"] == {"accelerator": "h100-80gb", "gpus": 16}
    assert "tpu" not in nb["spec"]


def test_jwa_spawn_multislice():
    def script(P):
        kube = kube_of(P)
        c = jwa(P, kube)
        out = [req(c, "POST", "/api/namespaces/user1/notebooks",
                   {"name": "ms", **device(P, 16, slices=2)})]
        out.append(objects(P, kube, "NOTEBOOK"))
        out.append(req(c, "POST", "/api/namespaces/user1/notebooks",
                       {"name": "big", **device(P, 16, slices=9)}))
        out.append(req(c, "POST", "/api/namespaces/user1/notebooks",
                       {"name": "zero", **device(P, 16, slices=0)}))
        out.append(req(c, "POST", "/api/namespaces/user1/notebooks",
                       {"name": "junk", **device(P, 16, slices="x")}))
        return out

    ref, got = both(script)
    # The slice-count messages name the device: "TPU" and "GPU".
    assert got[:3] == ref[:3]
    assert got[2][0] == 400 and "exceeds" in got[2][1]["log"]
    for r, g in zip(ref[3:], got[3:]):
        assert g[0] == r[0] == 400
        assert g[1]["log"] == r[1]["log"].replace("TPU", "GPU")
    assert got[1][0]["spec"]["tpu"]["slices"] == 2


def test_jwa_rejects_unoffered():
    def script(P):
        c = jwa(P, kube_of(P))
        return [req(c, "POST", "/api/namespaces/user1/notebooks",
                    {"name": "bad", **device(P, 256)}),
                req(c, "POST", "/api/namespaces/user1/notebooks",
                    {"name": "bad", "gpus" if P.gpu else "tpus":
                     {"accelerator": "a100"}}),
                req(c, "POST", "/api/namespaces/user1/notebooks",
                    {"name": "", **device(P, 8)})]

    ref, got = both(script)
    assert got[0] == ref[0] and got[2] == ref[2]
    assert got[0][0] == 400 and "not offered" in got[0][1]["log"]
    # An unknown accelerator names the device kind.
    assert got[1][0] == ref[1][0] == 400
    assert got[1][1]["log"] == "unknown GPU accelerator 'a100'"
    assert ref[1][1]["log"] == "unknown TPU accelerator 'a100'"


def test_port_form_refuses_what_slice_spec_refuses():
    c = jwa(PORT, kube_of(PORT))
    for gpus, msg in [("x", "invalid GPU count 'x'"),
                      (True, "invalid GPU count True"),
                      (2.5, "invalid GPU count 2.5")]:
        status, body = req(c, "POST", "/api/namespaces/user1/notebooks",
                           {"name": "n", "gpus": {"accelerator": "h100-80gb",
                                                  "gpus": gpus}})
        assert (status, body["log"]) == (400, msg)
    status, _ = req(c, "POST", "/api/namespaces/user1/notebooks",
                    {"name": "n", "gpus": {"accelerator": "h100-80gb",
                                           "gpus": "2"}})
    assert status == 200


def test_jwa_stop_start_delete():
    def script(P):
        kube = kube_of(P)
        c = jwa(P, kube)
        out = [req(c, "POST", "/api/namespaces/user1/notebooks",
                   {"name": "nb1"})[0]]
        out.append(req(c, "PATCH", "/api/namespaces/user1/notebooks/nb1",
                       {"stopped": True})[0])
        nb = kube.get(P.types.NOTEBOOK, "nb1", "user1")
        out.append(sorted(nb["metadata"]["annotations"]))
        out.append(req(c, "PATCH", "/api/namespaces/user1/notebooks/nb1",
                       {"stopped": False})[0])
        nb = kube.get(P.types.NOTEBOOK, "nb1", "user1")
        out.append(sorted(nb["metadata"].get("annotations", {})))
        out.append(req(c, "PATCH", "/api/namespaces/user1/notebooks/nb1",
                       {}))
        out.append(req(c, "DELETE", "/api/namespaces/user1/notebooks/nb1"))
        out.append(objects(P, kube, "NOTEBOOK"))
        out.append(req(c, "DELETE", "/api/namespaces/user1/notebooks/nb1"))
        return out

    ref, got = both(script)
    assert got == ref
    assert "kubeflow-resource-stopped" in got[2]
    assert "kubeflow-resource-stopped" not in got[4]
    assert got[6] == [200, {"success": True, "status": 200}]
    assert got[8][0] == 404


def test_jwa_authz_denied():
    def script(P):
        kube = kube_of(P)
        kube.authz_policy = (lambda **kw: kw["verb"] == "list"
                             and kw["gvk"].kind == "Node")
        c = jwa(P, kube)
        return [req(c, "GET", "/api/namespaces/user1/notebooks"),
                req(c, "GET", picker(P))[0],
                req(c, "POST", "/api/namespaces/user1/notebooks",
                    {"name": "x"}),
                req(c, "GET", "/api/namespaces/user1/notebooks/x/pod/x-0/"
                    "logs")]

    ref, got = both(script)
    assert got == ref
    assert got[0][0] == 403 and got[1] == 200
    assert got[0][1]["log"] == ("user 'alice@example.com' cannot list "
                                "notebooks in namespace user1")


def test_duplicate_spawn_is_409():
    def script(P):
        c = jwa(P, kube_of(P))
        return [req(c, "POST", "/api/namespaces/user1/notebooks",
                    {"name": "dup"})[0],
                req(c, "POST", "/api/namespaces/user1/notebooks",
                    {"name": "dup"})]

    ref, got = both(script)
    assert got == ref
    assert got[1][0] == 409 and "already exists" in got[1][1]["log"]


def test_jwa_pod_logs_pod_and_events():
    def script(P):
        kube = kube_of(P)
        for i in (10, 2, 0):
            kube.create({"apiVersion": "v1", "kind": "Pod",
                         "metadata": {"name": f"mynb-{i}",
                                      "namespace": "user1",
                                      "labels": {"notebook-name": "mynb"}},
                         "spec": {"containers": [{"name": "mynb"}]}})
        kube.set_pod_logs("user1", "mynb-0", "line1\nline2",
                          container="mynb")
        for name, obj in [("e1", "mynb-0"), ("e2", "mynb10"),
                          ("e3", "mynb")]:
            kube.create({"apiVersion": "v1", "kind": "Event",
                         "metadata": {"name": name, "namespace": "user1"},
                         "involvedObject": {"kind": "Pod", "name": obj},
                         "type": "Warning", "reason": "x",
                         "message": "Insufficient " + (
                             "nvidia.com/gpu" if P.gpu
                             else "google.com/tpu")})
        c = jwa(P, kube)
        return [req(c, "GET", "/api/namespaces/user1/notebooks/mynb/pod/"
                    "mynb-0/logs"),
                req(c, "GET", "/api/namespaces/user1/notebooks/mynb/pod/"
                    "ghost-0/logs")[0],
                req(c, "GET", "/api/namespaces/user1/notebooks/mynb/pod")[
                    1]["pods"],
                req(c, "GET", "/api/namespaces/user1/notebooks/none/pod"),
                [e["metadata"]["name"] for e in req(
                    c, "GET", "/api/namespaces/user1/notebooks/mynb/"
                    "events")[1]["events"]]]

    ref, got = both(script)
    assert got == ref
    assert got[0] == [200, {"success": True, "status": 200,
                            "logs": ["line1", "line2"]}]
    assert got[1] == 404 and got[2] == ["mynb-0", "mynb-2", "mynb-10"]
    assert got[4] == ["e1", "e3"]


def test_jwa_pvcs_and_poddefaults():
    def script(P):
        kube = kube_of(P)
        kube.create({"apiVersion": "kubeflow.org/v1alpha1",
                     "kind": "PodDefault",
                     "metadata": {"name": "pd", "namespace": "user1"},
                     "spec": {"selector": {"matchLabels": {"lbl": "true"}},
                              "desc": "a default"}})
        kube.create({"apiVersion": "v1", "kind": "PersistentVolumeClaim",
                     "metadata": {"name": "data", "namespace": "user1"},
                     "spec": {}})
        c = jwa(P, kube)
        return [req(c, "GET", "/api/namespaces/user1/poddefaults"),
                req(c, "GET", "/api/namespaces/user1/pvcs")]

    ref, got = both(script)
    assert got == ref


# -- the spawner's quota pre-flight -------------------------------------------


def _pod(P, name, n, labels=None):
    key = "nvidia.com/gpu" if P.gpu else "google.com/tpu"
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": name, "namespace": "user1",
                         **({"labels": labels} if labels else {})},
            "spec": {"containers": [{"name": "c", "resources": {
                "requests": {key: str(n)}, "limits": {key: str(n)}}}]}}


def test_quota_preflight_equals_the_reference():
    """test_quota.py's spawner cases in one script: over quota with the
    remaining budget, existing usage, back-to-back spawns, a stopped
    notebook releasing its claim, multislice, a cpu quota, the restart's
    pre-flight and a malformed quantity."""

    def script(P):
        out = []
        post = "/api/namespaces/user1/notebooks"

        def fresh(hard):
            kube = kube_of(P)
            kube.create(quota(P, hard))
            return kube, jwa(P, kube)

        kube, c = fresh({"device": "8"})
        out.append(req(c, "POST", post, {"name": "big", **device(P, 16)}))
        kube, c = fresh({"device": "16"})
        out.append(req(c, "POST", post, {"name": "first",
                                         **device(P, 8)})[0])
        kube.create(_pod(P, "first-0", 8, {"notebook-name": "first"}))
        out.append(req(c, "POST", post, {"name": "second",
                                         **device(P, 16)}))
        out.append(req(c, "POST", post, {"name": "third",
                                         **device(P, 8)})[0])
        out.append(req(c, "GET", picker(P))[1]["quota"])
        kube, c = fresh({"device": "8"})
        out.append(req(c, "POST", post, {"name": "first",
                                         **device(P, 8)})[0])
        out.append(req(c, "POST", post, {"name": "second",
                                         **device(P, 8)}))
        out.append(req(c, "PATCH", post + "/first", {"stopped": True})[0])
        out.append(req(c, "POST", post, {"name": "second",
                                         **device(P, 8)})[0])
        out.append(req(c, "PATCH", post + "/first", {"stopped": False}))
        out.append(req(c, "PATCH", post + "/second", {"stopped": True})[0])
        out.append(req(c, "PATCH", post + "/first", {"stopped": False})[0])
        kube, c = fresh({"device": "24"})
        out.append(req(c, "POST", post, {"name": "ms",
                                         **device(P, 16, slices=2)}))
        kube, c = fresh({"cpu": "1"})
        out.append(req(c, "POST", post, {"name": "fat", "cpu": "4",
                                         **device(P, 8)}))
        kube, c = fresh({"cpu": "8"})
        out.append(req(c, "POST", post, {"name": "bad", "cpu": "abc",
                                         **device(P, 8)}))
        return out

    ref, got = both(script)
    assert got == ref
    assert got[0] == [403, {
        "success": False, "status": 403,
        "log": "TPU quota exceeded (requested 16, remaining 8 of 8 chips "
               "in user1)",
        "user_action": "TPU quota exceeded (requested 16, remaining 8 of 8 "
                       "chips in user1)"}]
    assert got[12][0] == 403 and "requested 32" in got[12][1]["log"]
    assert "namespace quota exceeded" in got[13][1]["log"]
    assert got[14][0] == 400


def test_quota_message_in_the_port_words():
    kube = kube_of(PORT)
    kube.create(quota(PORT, {"device": "1"}))
    c = jwa(PORT, kube)
    assert req(c, "POST", "/api/namespaces/user1/notebooks",
               {"name": "a", **device(PORT, 1)})[0] == 200
    status, body = req(c, "POST", "/api/namespaces/user1/notebooks",
                       {"name": "b", **device(PORT, 1)})
    assert (status, body["log"]) == (
        403, "GPU quota exceeded (requested 1, remaining 0 of 1 GPUs in "
             "user1)")


def test_status_equals_the_reference():
    def script(P):
        insufficient = "0/3 nodes are available: 3 Insufficient " + (
            "nvidia.com/gpu" if P.gpu else "google.com/tpu") + "."
        nb = {"metadata": {"name": "nb", "annotations": {}}, "status": {}}
        cases = [
            (nb, []),
            ({**nb, "metadata": {"name": "nb", "deletionTimestamp": "t"}},
             []),
            ({"metadata": {"name": "nb", "annotations": {
                "kubeflow-resource-stopped": "t"}}}, []),
            ({**nb, "status": {"replicas": 2, "readyReplicas": 2}}, []),
            ({**nb, "status": {"conditions": [{"type": "Degraded",
                                               "status": "True",
                                               "message": "bad spec"}]}},
             []),
            ({**nb, "status": {"containerState": {"waiting": {
                "reason": "ImagePullBackOff", "message": "no"}}}}, []),
            (nb, [{"type": "Warning", "message": insufficient}]),
            (nb, [{"type": "Warning", "message": "other"}]),
            (nb, [{"type": "Normal", "message": "fine"}]),
        ]
        return [P.status.process_status(n, e) for n, e in cases]

    ref, got = both(script)
    assert got == ref
    assert got[6]["phase"] == "waiting"


# -- the spawner config --------------------------------------------------------


def _chips(topology):
    n = 1
    for d in topology.split("x"):
        n *= int(d)
    return n


def test_spawner_config_is_the_reference_yaml_in_gpu_words():
    """``spawner_ui_config.json`` equals ``yaml.safe_load`` of the
    reference's ``spawner_ui_config.yaml`` under the mapping: the
    ``tpus`` block becomes ``gpus`` at the same place, with ``value``
    ``{accelerator: none}``, the one GPU model of ``ACCELERATORS`` with
    every power-of-two count up to the largest v5e slice the reference
    offers, and ``maxSlices``/``readOnly`` kept; the images, the
    affinity's node label and the toleration's key are the module's
    word pairs; every other field is the reference's."""
    import yaml

    from kubeflow_tpu_torch.platform.gpu import ACCELERATORS

    with open(os.path.join(REPO, "kubeflow_tpu/platform/apps/jupyter/"
                           "spawner_ui_config.yaml")) as f:
        ref = yaml.safe_load(f)["spawnerFormDefaults"]
    got = PORT.form.load_spawner_config()
    with open(PORT.form.CONFIG_PATH) as f:
        assert json.load(f)["spawnerFormDefaults"] == got
    tpus = ref["tpus"]
    v5e = next(o for o in tpus["options"] if o["accelerator"] == "v5e")
    largest = max(_chips(t) for t in v5e["topologies"])
    want = {}
    for key, value in ref.items():
        if key == "tpus":
            want["gpus"] = {
                "value": {"accelerator": tpus["value"]["accelerator"]},
                "options": [{"accelerator": acc, "gpus": [
                    2 ** i for i in range(largest.bit_length())]}
                    for acc in ACCELERATORS],
                "maxSlices": tpus["maxSlices"],
                "readOnly": tpus["readOnly"]}
        else:
            want[key] = value
    assert list(ref_words(got)) == list(ref) and \
        list(got) == list(want)
    mapped = ref_words({k: v for k, v in got.items() if k != "gpus"})
    assert mapped == {k: v for k, v in ref.items() if k != "tpus"}
    assert got["gpus"] == want["gpus"]
    assert got["gpus"]["options"] == [
        {"accelerator": "h100-80gb", "gpus": [1, 2, 4, 8, 16, 32, 64]}]
    text = open(PORT.form.CONFIG_PATH).read()
    for word in ("google.com/tpu", "jax-tpu", "pytorch-xla", "gke-tpu"):
        assert word not in text


def test_spawner_config_knob_and_hot_reload(tmp_path, monkeypatch):
    path = tmp_path / "spawner.json"
    cfg = json.load(open(PORT.form.CONFIG_PATH))
    cfg["spawnerFormDefaults"]["cpu"]["value"] = "2"
    path.write_text(json.dumps(cfg))
    monkeypatch.setenv("SPAWNER_CONFIG", str(path))
    assert PORT.form.load_spawner_config()["cpu"]["value"] == "2"
    cfg["spawnerFormDefaults"]["cpu"]["value"] = "3"
    path.write_text(json.dumps(cfg))
    os.utime(path, (1, 1))
    assert PORT.form.load_spawner_config()["cpu"]["value"] == "3"


# -- VWA and TWA ----------------------------------------------------------------


def test_vwa_pvc_lifecycle():
    def script(P):
        kube = kube_of(P)
        c = client(P.volumes.create_app(kube, auth=P.crud.AuthContext(),
                                        secure_cookies=False))
        out = [req(c, "POST", "/api/namespaces/user1/pvcs",
                   {"name": "data", "size": "5Gi", "mode": "ReadWriteOnce"}),
               req(c, "POST", "/api/namespaces/user1/pvcs",
                   {"name": "fast", "class": "ssd"})[0],
               req(c, "POST", "/api/namespaces/user1/pvcs", {})]
        out.append(req(c, "GET", "/api/namespaces/user1/pvcs"))
        kube.create({"apiVersion": "v1", "kind": "Pod",
                     "metadata": {"name": "user-pod", "namespace": "user1"},
                     "spec": {"containers": [{"name": "c", "volumeMounts": [
                         {"name": "v", "mountPath": "/data"}]}],
                         "volumes": [{"name": "v", "persistentVolumeClaim":
                                      {"claimName": "data"}}]}})
        out.append(req(c, "GET", "/api/namespaces/user1/pvcs/data/pods"))
        out.append(req(c, "DELETE", "/api/namespaces/user1/pvcs/data"))
        kube.delete(P.types.POD, "user-pod", "user1")
        out.append(req(c, "DELETE", "/api/namespaces/user1/pvcs/data"))
        out.append(req(c, "GET", "/api/storageclasses"))
        out.append(objects(P, kube, "PVC"))
        return out

    ref, got = both(script)
    assert got == ref
    assert got[3][1]["pvcs"][0]["capacity"] == "5Gi"
    assert got[5][0] == 409 and got[6][0] == 200


def test_vwa_single_pvc_and_events():
    def script(P):
        kube = kube_of(P)
        c = client(P.volumes.create_app(kube, auth=P.crud.AuthContext(),
                                        secure_cookies=False))
        req(c, "POST", "/api/namespaces/user1/pvcs",
            {"name": "data", "size": "5Gi"})
        for name, obj in [("ev1", "data"), ("ev2", "other")]:
            kube.create({"apiVersion": "v1", "kind": "Event",
                         "metadata": {"name": name, "namespace": "user1"},
                         "involvedObject": {"kind": "PersistentVolumeClaim",
                                            "name": obj},
                         "reason": name, "message": "m"})
        return [req(c, "GET", "/api/namespaces/user1/pvcs/data"),
                req(c, "GET", "/api/namespaces/user1/pvcs/data/events"),
                req(c, "GET", "/api/namespaces/user1/pvcs/ghost")]

    ref, got = both(script)
    assert got == ref
    assert [e["reason"] for e in got[1][1]["events"]] == ["ev1"]
    assert got[2][0] == 404


def test_twa_pvcs_poddefaults_and_lifecycle():
    def script(P):
        kube = kube_of(P)
        c = client(P.tensorboards.create_app(
            kube, auth=P.crud.AuthContext(), secure_cookies=False))
        kube.create({"apiVersion": "v1", "kind": "PersistentVolumeClaim",
                     "metadata": {"name": "logs", "namespace": "user1"},
                     "spec": {"resources": {"requests": {"storage": "1Gi"}}}})
        kube.create({"apiVersion": "kubeflow.org/v1alpha1",
                     "kind": "PodDefault",
                     "metadata": {"name": "pd", "namespace": "user1"},
                     "spec": {"selector": {"matchLabels": {"pd": "true"}},
                              "desc": "Attach env"}})
        return [req(c, "GET", "/api/namespaces/user1/pvcs"),
                req(c, "GET", "/api/namespaces/user1/poddefaults"),
                req(c, "POST", "/api/namespaces/user1/tensorboards",
                    {"name": "tb1", "logspath": "pvc://logs/run"}),
                req(c, "POST", "/api/namespaces/user1/tensorboards",
                    {"name": "tb2"}),
                req(c, "GET", "/api/namespaces/user1/tensorboards"),
                objects(P, kube, "TENSORBOARD"),
                req(c, "DELETE", "/api/namespaces/user1/tensorboards/tb1"),
                req(c, "GET", "/api/namespaces/user1/tensorboards")]

    ref, got = both(script)
    assert got == ref
    assert got[0][1]["pvcs"] == ["logs"]
    assert got[1][1]["poddefaults"] == [
        {"name": "pd", "label": "pd", "desc": "Attach env"}]
    assert got[3][0] == 400
    assert got[4][1]["tensorboards"][0]["logspath"] == "pvc://logs/run"
    assert got[7][1]["tensorboards"] == []


# -- KFAM -----------------------------------------------------------------------


def _binding(user="bob@example.com", ns="user1", role="kubeflow-edit"):
    return {"user": {"kind": "User", "name": user}, "referredNamespace": ns,
            "roleRef": {"kind": "ClusterRole", "name": role}}


@pytest.mark.parametrize("use_informer", [False, True])
def test_kfam_binding_flow(use_informer):
    import time

    def script(P):
        kube = kube_of(P)
        kube.create({"apiVersion": "kubeflow.org/v1", "kind": "Profile",
                     "metadata": {"name": "user1"},
                     "spec": {"owner": {"kind": "User",
                                        "name": "alice@example.com"}}})
        app = P.kfam.create_app(kube, auth=P.crud.AuthContext(),
                                secure_cookies=False,
                                use_informer=use_informer)
        c = client(app)
        out = [req(c, "POST", "/kfam/v1/bindings", _binding())]

        def listed():
            deadline = time.time() + 5
            while True:
                got = req(c, "GET", "/kfam/v1/bindings?namespace=user1")
                if not use_informer or len(got[1]["bindings"]) == len(
                        kube.list(P.types.ROLEBINDING, "user1")) \
                        or time.time() > deadline:
                    return got
                time.sleep(0.01)

        out.append(listed())
        out.append(req(c, "GET", "/kfam/v1/bindings?user=bob@example.com"))
        out.append(objects(P, kube, "ROLEBINDING"))
        out.append(objects(P, kube, "AUTHORIZATIONPOLICY"))
        out.append(req(c, "POST", "/kfam/v1/bindings",
                       _binding(role="kubeflow-owner")))
        out.append(req(c, "POST", "/kfam/v1/bindings", {"user": {}}))
        kube.authz_policy = lambda **kw: False  # no cluster admin
        out.append(req(c, "POST", "/kfam/v1/bindings", _binding(),
                       headers={"kubeflow-userid": "mallory@example.com"}))
        out.append(req(c, "GET", "/kfam/v1/role/clusteradmin?user=x"))
        kube.authz_policy = None
        out.append(req(c, "DELETE", "/kfam/v1/bindings", _binding()))
        out.append(objects(P, kube, "ROLEBINDING"))
        out.append(req(c, "GET", "/kfam/v1/role/clusteradmin"))
        informer = app.config.get("rolebinding_informer") if P.gpu else None
        if informer is not None:
            informer.stop()
        return out

    ref, got = both(script)
    assert got == ref
    assert got[0][0] == 200
    assert any(b["user"]["name"] == "bob@example.com"
               for b in got[1][1]["bindings"])
    assert got[3][0]["metadata"]["name"] == \
        "user-bob-example-com-clusterrole-edit"
    assert got[5][0] == 400 and got[7][0] == 403
    assert got[8][1]["isClusterAdmin"] is False
    assert [o["metadata"]["name"] for o in got[10]] == []


def test_kfam_profiles():
    def script(P):
        kube = kube_of(P)
        c = client(P.kfam.create_app(kube, auth=P.crud.AuthContext(),
                                     secure_cookies=False))
        profile = {"metadata": {"name": "ws1"},
                   "spec": {"owner": {"name": "alice@example.com"}}}
        out = [req(c, "POST", "/kfam/v1/profiles", profile)]
        out.append(req(c, "POST", "/kfam/v1/profiles", {"metadata": {}}))
        kube.authz_policy = lambda **kw: False
        out.append(req(c, "POST", "/kfam/v1/profiles", {
            "metadata": {"name": "ws2"},
            "spec": {"owner": {"name": "bob@example.com"}}}))
        out.append(req(c, "DELETE", "/kfam/v1/profiles/ws1",
                       headers={"kubeflow-userid": "bob@example.com"}))
        out.append(req(c, "DELETE", "/kfam/v1/profiles/ws1"))
        kube.authz_policy = None
        out.append([o["metadata"]["name"]
                    for o in kube.list(P.types.PROFILE)])
        return out

    ref, got = both(script)
    assert got == ref
    assert [s for s, _ in got[:5]] == [200, 400, 403, 403, 200]


def test_binding_name_sanitizing_equals_the_reference():
    import random

    rng = random.Random(7)
    alphabet = "abcXYZ019.@-_+ !é/"
    users = ["bob@example.com", "A.B@C", "a-b@c", "--x--", "é@ü.de"] + [
        "".join(rng.choice(alphabet) for _ in range(rng.randint(1, 20)))
        for _ in range(60)]
    for user in users:
        for role in ("admin", "edit", "view"):
            assert PORT.bindings.binding_name(user, role) == \
                REF.bindings.binding_name(user, role), user
