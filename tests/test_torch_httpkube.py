"""The port's ``RestKubeClient`` against its ``HttpKubeServer`` over its
``FakeKube`` (``kubeflow_tpu_torch/platform/k8s/client.py``,
``testing/httpkube.py``): the reference's wire cases
(``tests/ctrlplane/test_httpkube.py``), JSON ``Status`` errors as typed
exceptions, resourceVersion 409s, patches by Content-Type, selectors,
subresources, chunked watch lines with resume, SARs, pod logs.  One case
replays the same script against the reference's stack (its client on
``requests``, its server on werkzeug) and compares what comes back."""
import json
import socket
import threading
import time

import pytest

from kubeflow_tpu.platform.k8s import errors as ref_errors
from kubeflow_tpu.platform.k8s.client import RestKubeClient as RefClient
from kubeflow_tpu.platform.testing import FakeKube as RefKube
from kubeflow_tpu.platform.testing.httpkube import (
    HttpKubeServer as RefServer,
)
from kubeflow_tpu_torch.platform.k8s import errors
from kubeflow_tpu_torch.platform.k8s.client import RestKubeClient
from kubeflow_tpu_torch.platform.k8s.types import (
    EVENT,
    GVK,
    NAMESPACE,
    NOTEBOOK,
    POD,
    PROFILE,
)
from kubeflow_tpu_torch.platform.testing.fake import FakeKube
from kubeflow_tpu_torch.platform.testing.httpkube import (
    HttpKubeServer,
    make_transport,
)

# The object fields a store mints; the rest must be equal across stacks.
VOLATILE = ("uid", "resourceVersion", "creationTimestamp", "generation",
            "managedFields")


@pytest.fixture(scope="module")
def stack():
    kube = FakeKube()
    kube.add_namespace("user1")
    server = HttpKubeServer(kube).start()
    client = RestKubeClient(server.base_url, qps=0)
    yield kube, client
    client.close()
    server.stop()


def nb(name, ns="user1"):
    return {"apiVersion": "kubeflow.org/v1beta1", "kind": "Notebook",
            "metadata": {"name": name, "namespace": ns},
            "spec": {"template": {"spec": {"containers": [
                {"name": name, "image": "img"}]}}}}


def test_crud_round_trip(stack):
    kube, client = stack
    created = client.create(nb("rt"))
    assert created["metadata"]["resourceVersion"]
    got = client.get(NOTEBOOK, "rt", "user1")
    assert got["spec"]["template"]["spec"]["containers"][0]["image"] == "img"
    got["spec"]["template"]["spec"]["containers"][0]["image"] = "img:2"
    assert client.update(got)["metadata"]["generation"] == 2
    assert "rt" in [n["metadata"]["name"]
                    for n in client.list(NOTEBOOK, "user1")]
    client.delete(NOTEBOOK, "rt", "user1")
    with pytest.raises(errors.NotFound):
        client.get(NOTEBOOK, "rt", "user1")


def test_resource_version_conflict_is_409(stack):
    kube, client = stack
    client.create(nb("conf"))
    a = client.get(NOTEBOOK, "conf", "user1")
    b = client.get(NOTEBOOK, "conf", "user1")
    client.update(a)
    with pytest.raises(errors.Conflict):
        client.update(b)
    client.delete(NOTEBOOK, "conf", "user1")


def test_create_conflict_and_dry_run(stack):
    kube, client = stack
    client.create(nb("dup"))
    with pytest.raises(errors.Conflict):
        client.create(nb("dup"))
    client.create(nb("ghost"), dry_run=True)
    with pytest.raises(errors.NotFound):
        client.get(NOTEBOOK, "ghost", "user1")
    client.delete(NOTEBOOK, "dup", "user1")


def test_patch_types_by_content_type(stack):
    kube, client = stack
    client.create(nb("patchy"))
    out = client.patch(NOTEBOOK, "patchy",
                       {"metadata": {"annotations": {"a": "1"}}}, "user1")
    assert out["metadata"]["annotations"]["a"] == "1"
    out = client.patch(
        NOTEBOOK, "patchy",
        [{"op": "add", "path": "/metadata/annotations/b", "value": "2"}],
        "user1", patch_type="json")
    assert out["metadata"]["annotations"]["b"] == "2"
    out = client.patch_status(NOTEBOOK, "patchy",
                              {"status": {"readyReplicas": 1}}, "user1")
    assert out["status"] == {"readyReplicas": 1}
    client.delete(NOTEBOOK, "patchy", "user1")


def test_update_status_subresource(stack):
    kube, client = stack
    client.create(nb("status-nb"))
    got = client.get(NOTEBOOK, "status-nb", "user1")
    got["status"] = {"readyReplicas": 1}
    client.update_status(got)
    assert client.get(NOTEBOOK, "status-nb", "user1")["status"] == {
        "readyReplicas": 1}
    client.delete(NOTEBOOK, "status-nb", "user1")


def test_selectors_serialize_over_the_wire(stack):
    kube, client = stack
    for name, owner in (("sel-1", "sel-nb"), ("sel-2", "other")):
        kube.create({"apiVersion": "v1", "kind": "Pod",
                     "metadata": {"name": name, "namespace": "user1",
                                  "labels": {"notebook-name": owner}},
                     "spec": {"containers": [{"name": "c", "image": "i"}]}})
    pods = client.list(POD, "user1",
                       label_selector={"notebook-name": "sel-nb"})
    assert [p["metadata"]["name"] for p in pods] == ["sel-1"]
    kube.create({"apiVersion": "v1", "kind": "Event",
                 "metadata": {"name": "sel-ev", "namespace": "user1"},
                 "involvedObject": {"kind": "Pod", "name": "sel-1"},
                 "reason": "x", "message": "y", "type": "Normal"})
    evs = client.list(EVENT, "user1",
                      field_selector={"involvedObject.name": "sel-1"})
    assert [e["metadata"]["name"] for e in evs] == ["sel-ev"]


def test_cluster_scoped_paths(stack):
    kube, client = stack
    client.create({"apiVersion": "kubeflow.org/v1", "kind": "Profile",
                   "metadata": {"name": "wire-prof"},
                   "spec": {"owner": {"kind": "User", "name": "a@x.io"}}})
    assert client.get(PROFILE, "wire-prof")["spec"]["owner"]["name"] == \
        "a@x.io"
    assert "user1" in [n["metadata"]["name"] for n in client.list(NAMESPACE)]
    client.delete(PROFILE, "wire-prof")


def test_watch_streams_json_lines(stack):
    kube, client = stack
    stop = threading.Event()
    seen = []

    def consume():
        for etype, obj in client.watch(NOTEBOOK, "user1", stop=stop):
            seen.append((etype, obj["metadata"]["name"]))
            if len(seen) >= 2:
                return

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    time.sleep(0.3)
    kube.create(nb("w-1"))
    kube.create(nb("w-2"))
    t.join(timeout=10)
    stop.set()
    assert not t.is_alive()
    assert ("ADDED", "w-1") in seen and ("ADDED", "w-2") in seen
    kube.delete(NOTEBOOK, "w-1", "user1")
    kube.delete(NOTEBOOK, "w-2", "user1")


def test_watch_resume_from_rv_skips_backlog(stack):
    kube, client = stack
    client.create(nb("rv-1"))
    _, rv = client.list_with_rv(NOTEBOOK, "user1")
    stop = threading.Event()
    seen = []

    def consume():
        for etype, obj in client.watch(NOTEBOOK, "user1",
                                       resource_version=rv, stop=stop):
            seen.append((etype, obj["metadata"]["name"]))
            return

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    time.sleep(0.3)
    kube.create(nb("rv-2"))
    t.join(timeout=10)
    stop.set()
    assert seen == [("ADDED", "rv-2")]
    kube.delete(NOTEBOOK, "rv-1", "user1")
    kube.delete(NOTEBOOK, "rv-2", "user1")


def test_subject_access_review_round_trip(stack):
    kube, client = stack
    kube.authz_policy = lambda user, verb, gvk, **kw: user == "allowed@x.io"
    try:
        assert client.can_i("allowed@x.io", "list", NOTEBOOK, "user1")
        assert not client.can_i("denied@x.io", "list", NOTEBOOK, "user1")
    finally:
        kube.authz_policy = None


def test_pod_log_subresource(stack):
    kube, client = stack
    kube.create({"apiVersion": "v1", "kind": "Pod",
                 "metadata": {"name": "loggy", "namespace": "user1"},
                 "spec": {"containers": [{"name": "main", "image": "i"}]}})
    kube.set_pod_logs("user1", "loggy", "hello wire", container="main")
    assert client.pod_logs("loggy", "user1", container="main") == \
        "hello wire"


def test_unknown_resource_is_a_404_status(stack):
    kube, client = stack
    bogus = GVK("nope.example.com", "v1", "Widget", "widgets")
    with pytest.raises(errors.NotFound) as e:
        client.list(bogus, "user1")
    assert e.value.body["kind"] == "Status" and e.value.body["code"] == 404


def test_already_exists_reason_survives_the_wire(stack):
    kube, client = stack
    client.create(nb("typed-dup"))
    with pytest.raises(errors.AlreadyExists):
        client.create(nb("typed-dup"))
    client.delete(NOTEBOOK, "typed-dup", "user1")


def test_sar_resolves_the_registered_gvk(stack):
    kube, client = stack
    kube.authz_policy = lambda user, verb, gvk, **kw: gvk.kind == "Notebook"
    try:
        assert client.can_i("u@x.io", "list", NOTEBOOK, "user1")
        assert not client.can_i("u@x.io", "list", POD, "user1")
    finally:
        kube.authz_policy = None


def test_server_speaks_keep_alive_and_chunked_watch_lines():
    """The server's wire: one kept-alive connection carries several
    requests, each with Content-Length; a watch is chunked, one JSON line
    a chunk, the socket NODELAY; the server binds 127.0.0.1."""
    kube = FakeKube()
    kube.add_namespace("user1")
    kube.create(nb("k"))
    server = HttpKubeServer(kube).start()
    try:
        assert server.host == "127.0.0.1" and server.port > 0
        client = RestKubeClient(server.base_url, qps=0)
        for _ in range(5):
            client.get(NOTEBOOK, "k", "user1")
        assert client._pool.opened == 1
        with socket.create_connection((server.host, server.port), 5) as s:
            s.sendall(b"GET /apis/kubeflow.org/v1beta1/namespaces/user1/"
                      b"notebooks?watch=true&timeoutSeconds=1 HTTP/1.1\r\n"
                      b"Host: x\r\n\r\n")
            data = b""
            deadline = time.monotonic() + 10
            while not data.endswith(b"0\r\n\r\n") and \
                    time.monotonic() < deadline:
                data += s.recv(65536)
        head, _, body = data.partition(b"\r\n\r\n")
        assert b"Transfer-Encoding: chunked" in head
        size, _, rest = body.partition(b"\r\n")
        line = rest[:int(size, 16)]
        assert line.endswith(b"\n") and \
            json.loads(line)["object"]["metadata"]["name"] == "k"
        client.close()
    finally:
        server.stop()


def _script(client, errs, kube_create):
    """One sequence of calls; returns what each gave back, objects with
    their minted fields dropped and errors as their class and reason."""
    out = []

    def record(fn):
        try:
            value = fn()
        except errs.ApiError as e:
            out.append(("error", type(e).__name__,
                        (e.body or {}).get("reason")))
            return None
        out.append(("ok", _strip(value)))
        return value

    ns = "user1"
    record(lambda: client.create(nb("a")))
    record(lambda: client.create(nb("a")))
    got = record(lambda: client.get(NOTEBOOK, "a", ns))
    stale = dict(got)
    got["spec"]["template"]["spec"]["containers"][0]["image"] = "img:2"
    record(lambda: client.update(got))
    record(lambda: client.update(stale))
    record(lambda: client.patch(NOTEBOOK, "a",
                                {"metadata": {"labels": {"x": "1"}}}, ns))
    record(lambda: client.patch(
        NOTEBOOK, "a", [{"op": "replace", "path": "/metadata/labels/x",
                         "value": "2"}], ns, patch_type="json"))
    record(lambda: client.patch_status(NOTEBOOK, "a",
                                       {"status": {"readyReplicas": 1}}, ns))
    record(lambda: client.create(nb("b"), dry_run=True))
    record(lambda: client.get(NOTEBOOK, "b", ns))
    kube_create({"apiVersion": "v1", "kind": "Pod",
                 "metadata": {"name": "p", "namespace": ns,
                              "labels": {"notebook-name": "a"}},
                 "spec": {"containers": [{"name": "c", "image": "i"}]}})
    record(lambda: client.list(POD, ns,
                               label_selector={"notebook-name": "a"}))
    record(lambda: client.list(POD, ns,
                               label_selector={"notebook-name": "z"}))
    record(lambda: client.pod_logs("p", ns))
    record(lambda: client.can_i("u", "get", NOTEBOOK, ns))
    record(lambda: client.delete(NOTEBOOK, "a", ns))
    record(lambda: client.delete(NOTEBOOK, "a", ns))
    record(lambda: client.get(NOTEBOOK, "a", ns))
    record(lambda: client.list(NOTEBOOK, ns))
    return out


def _strip(value):
    if isinstance(value, list):
        return [_strip(v) for v in value]
    if not isinstance(value, dict):
        return value
    out = {}
    for k, v in value.items():
        if k in VOLATILE:
            continue
        if k == "annotations":
            v = {a: x for a, x in v.items()
                 if not a.startswith("kubeflow.org/trace")}
        out[k] = _strip(v)
    return out


def test_same_script_same_answers_as_the_reference_stack():
    results = []
    for kube_cls, server_cls, client_cls, errs in (
            (FakeKube, HttpKubeServer, RestKubeClient, errors),
            (RefKube, RefServer, RefClient, ref_errors)):
        kube = kube_cls()
        kube.add_namespace("user1")
        server = server_cls(kube).start()
        try:
            client = client_cls(server.base_url, qps=0)
            results.append(_script(client, errs, kube.create))
        finally:
            server.stop()
    port, ref = results
    assert port == ref
    assert [r[0] for r in port].count("error") == 5


def test_a_store_fault_answers_a_500_status(stack):
    kube, client = stack
    client.create(nb("bad-patch"))
    with pytest.raises(errors.InternalError) as e:
        client.patch(NOTEBOOK, "bad-patch",
                     [{"op": "remove", "path": "/metadata/nope"}], "user1",
                     patch_type="json")
    assert e.value.body["code"] == 500 and "PatchError" in str(e.value)
    assert client.get(NOTEBOOK, "bad-patch", "user1")
    client.delete(NOTEBOOK, "bad-patch", "user1")


def test_make_transport_memory_and_http():
    kube = FakeKube()
    assert make_transport(kube, "memory") == (kube, None)
    with pytest.raises(ValueError):
        make_transport(kube, "memory", watch_window=5)
    client, server = make_transport(kube, "http", watch_window=5)
    try:
        assert isinstance(client, RestKubeClient)
        assert client.WATCH_TIMEOUT_SECONDS == 5
        assert client.base_url == server.base_url
    finally:
        server.stop()
    with pytest.raises(ValueError):
        make_transport(kube, "carrier-pigeon")
