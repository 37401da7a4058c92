"""The port's CRUD-backend middleware and static serving
(``kubeflow_tpu_torch/platform/web/crud_backend.py`` and
``static_serving.py``) against the JAX package's: the same script on
each package's ``FakeKube`` (and ``ChaosKube`` for a failing API
server), through werkzeug's test ``Client`` on both WSGI apps, with
statuses, JSON bodies and the counters' deltas compared.  Objects in
bodies are compared with ``uid`` and ``creationTimestamp`` stripped.

Covered: the authn gate's 401 and the probes without an identity, the
CSRF double-submit, ``request_kf`` by kind with 5xx counted as
failures, the degraded stamp of a cache-served read, the apps' cached
frozen reads over HTTP, and static serving's traversal cases (each a
404, as the reference's) and content types."""
import importlib
import json
import os
from types import SimpleNamespace

import pytest
from werkzeug.security import safe_join as werkzeug_safe_join
from werkzeug.test import Client

USER = {"kubeflow-userid": "alice@example.com"}


def package(root):
    def mod(name):
        return importlib.import_module(f"{root}.platform.{name}")

    crud = mod("web.crud_backend")
    return SimpleNamespace(
        root=root, FakeKube=mod("testing.fake").FakeKube,
        ChaosKube=mod("testing.chaos").ChaosKube,
        Fault=mod("testing.chaos").Fault,
        Informer=mod("runtime.informer").Informer,
        metrics=mod("runtime.metrics"), types=mod("k8s.types"),
        framework=mod("web.framework"), crud=crud,
        static=mod("web.static_serving"),
        jupyter=mod("apps.jupyter.app"), volumes=mod("apps.volumes.app"),
        tensorboards=mod("apps.tensorboards.app"))


REF = package("kubeflow_tpu")
PORT = package("kubeflow_tpu_torch")
BOTH = pytest.mark.parametrize("P", [REF, PORT], ids=["reference", "port"])


def sample(P, name, **labels):
    """A counter's value for one label set (0.0 where never used)."""
    if P is REF:
        return P.metrics.registry.get_sample_value(name, labels) or 0.0
    metric = {"request_kf_total": P.metrics.request_kf,
              "request_kf_failure_total": P.metrics.request_kf_failure,
              "degraded_responses_total":
                  P.metrics.degraded_responses_total}[name]
    return metric.sample(**labels) or 0.0


def strip(x):
    """``x`` with every ``uid`` and ``creationTimestamp`` dropped (they
    differ between two API servers by construction), and a table row's
    ``age``, which is its object's ``creationTimestamp``."""
    if isinstance(x, dict):
        return {k: strip(v) for k, v in x.items()
                if k not in ("uid", "creationTimestamp", "age")}
    if isinstance(x, list):
        return [strip(v) for v in x]
    return x


def call(app, method, path, *, body=None, headers=None, use_cookies=True):
    kw = {"headers": headers or {}}
    if body is not None:
        kw["json"] = body
    resp = Client(app, use_cookies=use_cookies).open(path, method=method,
                                                     **kw)
    text = resp.get_data(as_text=True)
    try:
        payload = json.loads(text)
    except ValueError:
        payload = text
    return resp, strip(payload)


def both(script):
    """``script(P)`` on each package; their results, reference first."""
    return script(REF), script(PORT)


def kube_of(P):
    k = P.FakeKube()
    k.add_namespace("user1")
    return k


# -- authn and probes ---------------------------------------------------------


def _who_app(P, auth):
    app = P.framework.App("who")
    backend = P.crud.CrudBackend(kube_of(P), auth)
    P.crud.install_standard_middleware(app, backend, secure_cookies=False)

    @app.route("/api/namespaces/<ns>/whoami")
    def whoami(request, ns):
        return {"user": P.crud.current_user(request), "ns": ns}

    return app


def test_authn_gate_and_probes_equal_the_reference(monkeypatch):
    monkeypatch.setenv("DEV_USER", "dev@example.com")

    def script(P):
        jwa = P.jupyter.create_app(kube_of(P), secure_cookies=False)
        out = []
        for method, path, headers in [
                ("GET", "/api/config", {}),
                ("GET", "/api/namespaces/user1/notebooks", {}),
                ("POST", "/api/namespaces/user1/notebooks", {}),
                ("GET", "/healthz", {}),
                ("HEAD", "/healthz", {}),
                ("GET", "/nope", {}),
                ("GET", "/api/namespaces/user1/notebooks", USER)]:
            resp, payload = call(jwa, method, path, headers=headers)
            out.append((method, path, resp.status_code, payload))
        resp, _ = call(jwa, "GET", "/metrics")
        out.append(("metrics", resp.status_code,
                    resp.headers["Content-Type"]))
        for auth, headers in [
                (P.crud.AuthContext(), USER),
                (P.crud.AuthContext(userid_header="x-user"),
                 {"X-User": "bob@example.com"}),
                (P.crud.AuthContext(userid_prefix="accounts:"),
                 {"kubeflow-userid": "accounts:carol@example.com"}),
                (P.crud.AuthContext(disable_auth=True), {}),
                (P.crud.AuthContext(), {})]:
            resp, payload = call(_who_app(P, auth), "GET",
                                 "/api/namespaces/n1/whoami",
                                 headers=headers)
            out.append((resp.status_code, payload))
        return out

    ref, got = both(script)
    assert got == ref
    assert got[0][2] == 401 and got[3][2:] == (200, {"status": "ok"})
    assert got[-2] == (200, {"user": "dev@example.com", "ns": "n1"})


def test_metrics_page_carries_the_request_counters():
    app = PORT.jupyter.create_app(kube_of(PORT), secure_cookies=False)
    call(app, "GET", "/api/namespaces/user1/notebooks", headers=USER)
    resp, page = call(app, "GET", "/metrics")
    assert resp.headers["Content-Type"] == "text/plain; version=0.0.4"
    assert ('request_kf_total{component="jupyter-web-app",'
            'kind="notebooks"}') in page


# -- CSRF ---------------------------------------------------------------------


def test_csrf_double_submit_equals_the_reference():
    """The reference's test_csrf_double_submit on both packages: the
    first response sets the cookie; a mutation without the header echoing
    it is a 403, with it a 200; a safe method needs no header."""

    def script(P):
        app = P.framework.App("secure")
        backend = P.crud.CrudBackend(kube_of(P), P.crud.AuthContext())
        P.crud.install_standard_middleware(app, backend, secure_cookies=True)

        @app.route("/mutate", methods=["POST", "GET"])
        def mutate(request):
            return {"ok": True}

        r0 = Client(app).get("/healthz")
        cookie = r0.headers["Set-Cookie"]
        name, _, rest = cookie.partition("=")
        token = rest.split(";")[0]
        attrs = sorted(a.strip() for a in rest.split(";")[1:])
        jar = {"Cookie": f"XSRF-TOKEN={token}"}
        out = [name, attrs, len(token) >= 32]
        for headers in ({**USER, **jar}, {**USER, **jar,
                                          "X-XSRF-TOKEN": token},
                        {**USER, **jar, "X-XSRF-TOKEN": "wrong"},
                        {**USER, "X-XSRF-TOKEN": token}, USER):
            resp, payload = call(app, "POST", "/mutate", headers=headers,
                                 use_cookies=False)
            out.append((resp.status_code, payload,
                        "Set-Cookie" in resp.headers))
        resp, payload = call(app, "GET", "/mutate", headers=USER,
                             use_cookies=False)
        out.append((resp.status_code, payload))
        return out

    ref, got = both(script)
    assert got == ref
    assert got[0] == "XSRF-TOKEN"
    assert got[1] == ["Path=/", "SameSite=Strict", "Secure"]
    assert [s for s, _p, _c in got[3:8]] == [403, 200, 403, 403, 403]
    # A request that carried the cookie is not given a new one.
    assert got[4][2] is False and got[6][2] is True


# -- request counters ---------------------------------------------------------


def test_request_kf_counts_per_kind_equal_the_reference():
    """The reference's request-counter cases: a /api route counts under
    its kind, probes and /metrics under none, a 4xx as a request and a
    5xx as a failure."""

    def script(P):
        kube = kube_of(P)
        app = P.jupyter.create_app(kube, secure_cookies=False)
        fail = P.framework.App("fail-app")
        P.crud.install_standard_middleware(
            fail, P.crud.CrudBackend(
                kube, P.crud.AuthContext(disable_auth=True)),
            secure_cookies=False)

        @fail.route("/api/namespaces/<ns>/widgets")
        def widgets(request, ns):
            raise RuntimeError("boom")

        @fail.route("/api/namespaces/<ns>/gadgets")
        def gadgets(request, ns):
            raise P.framework.HttpError(409, "taken")

        def counts():
            return [sample(P, "request_kf_total",
                           component="jupyter-web-app", kind=k)
                    for k in ("notebooks", "pvcs", "config", "healthz")] + [
                sample(P, "request_kf_total", component="fail-app",
                       kind=k) for k in ("widgets", "gadgets")] + [
                sample(P, "request_kf_failure_total", component="fail-app",
                       kind=k, severity="major")
                for k in ("widgets", "gadgets")]

        before = counts()
        statuses = [call(app, "GET", p, headers=USER)[0].status_code
                    for p in ("/api/namespaces/user1/notebooks",
                              "/api/namespaces/user1/notebooks",
                              "/api/namespaces/user1/pvcs", "/api/config",
                              "/healthz", "/metrics",
                              "/api/namespaces/user1/notebooks/ghost")]
        statuses += [call(fail, "GET", p)[0].status_code
                     for p in ("/api/namespaces/x/widgets",
                               "/api/namespaces/x/gadgets",
                               "/api/nope")]
        return statuses, [a - b for a, b in zip(counts(), before)]

    ref, got = both(script)
    assert got == ref
    assert got == ([200, 200, 200, 200, 200, 200, 404, 500, 409, 404],
                   [3.0, 1.0, 1.0, 0.0, 0.0, 1.0, 1.0, 0.0])


def test_kind_of_rule_equals_the_reference():
    rules = ["/api/namespaces/<ns>/notebooks",
             "/api/namespaces/<ns>/notebooks/<name>/pod/<pod>/logs",
             "/api/namespaces", "/api/storageclasses",
             "/api/activities/<ns>", "/api/namespaces/<ns>",
             "/api/<x>/<y>", "/api/", "/healthz", "/metrics",
             "/kfam/v1/bindings", None, ""]
    got = [PORT.crud._kind_of_rule(r) for r in rules]
    assert got == [REF.crud._kind_of_rule(r) for r in rules]
    assert got[:5] == ["notebooks", "notebooks", "namespaces",
                       "storageclasses", "activities"]


# -- degraded reads -----------------------------------------------------------


def _pvc(name):
    return {"apiVersion": "v1", "kind": "PersistentVolumeClaim",
            "metadata": {"name": name, "namespace": "user1"},
            "spec": {"accessModes": ["ReadWriteOnce"],
                     "resources": {"requests": {"storage": "1Gi"}}}}


def _volumes(P, client, caches=None):
    return P.volumes.create_app(
        client, auth=P.crud.AuthContext(disable_auth=True),
        secure_cookies=False, caches=caches)


def test_degraded_stamp_equals_the_reference():
    """The reference's degraded cases (test_resilience.py): a synced
    cache behind a failing API server answers its own kind, an uncached
    kind fails as a 503 with Retry-After, an unsynced cache holding
    yesterday's data answers with ``degraded: true`` (counted), an empty
    never-synced cache refuses, and a healthy read is not stamped."""

    def script(P):
        kube = kube_of(P)
        kube.create(_pvc("vol-a"))
        synced = P.Informer(kube, P.types.PVC)
        synced.start()
        assert synced.wait_for_sync(10.0)
        synced.stop()
        chaos = P.ChaosKube(kube, [P.Fault(
            "timeout", 1.0, verbs=frozenset({"list", "get"}))])
        out = []
        resp, payload = call(_volumes(P, chaos, {P.types.PVC: synced}),
                             "GET", "/api/namespaces/user1/pvcs")
        out.append((resp.status_code, resp.headers.get("Retry-After"),
                    payload))
        unsynced = P.Informer(chaos, P.types.PVC)
        unsynced._store = dict(synced._store)
        before = sample(P, "degraded_responses_total",
                        component="volumes-web-app")
        resp, payload = call(_volumes(P, chaos, {P.types.PVC: unsynced}),
                             "GET", "/api/namespaces/user1/pvcs/vol-a")
        out.append((resp.status_code, payload,
                    sample(P, "degraded_responses_total",
                           component="volumes-web-app") - before))
        empty = P.Informer(chaos, P.types.PVC)
        resp, payload = call(_volumes(P, chaos, {P.types.PVC: empty}),
                             "GET", "/api/namespaces/user1/pvcs")
        out.append((resp.status_code, payload))
        resp, payload = call(_volumes(P, kube), "GET",
                             "/api/namespaces/user1/pvcs/vol-a")
        out.append((resp.status_code, payload))
        return out

    ref, got = both(script)
    assert got == ref
    assert got[0][:2] == (503, "5")
    assert got[1][0] == 200 and got[1][1]["degraded"] is True
    assert got[1][2] == 1.0
    assert got[2][0] == 503 and "degraded" not in got[3][1]


# -- cached frozen reads -------------------------------------------------------


def test_cached_frozen_reads_over_http_equal_the_reference():
    """The reference's cached-reads case: each app with its informer
    caches wired, driven over its hot routes through real sockets; a
    handler that mutated a frozen cached object, or serialized one
    outside ``json_response``, would 500.  A GET right after its POST
    reads through the lagging cache.  The JWA's accelerator words differ
    by the mapping ``spec.tpu {v5e, 2x4}`` -> ``spec.gpu {h100-80gb,
    8}`` (both eight devices on one host)."""
    import requests

    def script(P):
        kube = kube_of(P)
        gpu = P is PORT
        if gpu:
            kube.add_gpu_node("node-1", gpus=8)
        else:
            kube.add_tpu_node("node-1", topology="2x4")
        kube.create({"apiVersion": "v1", "kind": "ResourceQuota",
                     "metadata": {"name": "q", "namespace": "user1"},
                     "spec": {"hard": {("nvidia.com/gpu" if gpu
                                        else "google.com/tpu"): "16"}}})
        kube.create(_pvc("vol1"))
        t = P.types
        caches = {g: P.Informer(kube, g).start()
                  for g in (t.NOTEBOOK, t.PVC, t.PODDEFAULT,
                            t.RESOURCEQUOTA, t.NODE, t.STORAGECLASS,
                            t.TENSORBOARD)}
        servers, out = [], []
        try:
            for inf in caches.values():
                assert inf.wait_for_sync(10)

            def serve(app):
                server, base = app.test_server()
                servers.append(server)
                return base

            auth = P.crud.AuthContext()
            jwa = serve(P.jupyter.create_app(kube, auth=auth,
                                             caches=caches,
                                             secure_cookies=False))
            device = ({"gpus": {"accelerator": "h100-80gb", "gpus": 8}}
                      if gpu else
                      {"tpus": {"accelerator": "v5e", "topology": "2x4"}})
            r = requests.post(f"{jwa}/api/namespaces/user1/notebooks",
                              headers=USER,
                              json={"name": "cached-nb", "image": "img",
                                    **device})
            out.append(r.status_code)
            r = requests.get(f"{jwa}/api/namespaces/user1/notebooks/"
                             "cached-nb", headers=USER)
            out.append((r.status_code,
                        r.json()["notebook"]["metadata"]["name"]))
            r = requests.get(f"{jwa}/api/namespaces/user1/"
                             + ("gpus" if gpu else "tpus"), headers=USER)
            out.append((r.status_code, r.json()["quota"]))
            for path in ("/api/namespaces/user1/pvcs",
                         "/api/namespaces/user1/notebooks",
                         "/api/namespaces/user1/poddefaults"):
                out.append(requests.get(jwa + path,
                                        headers=USER).status_code)
            vwa = serve(P.volumes.create_app(kube, auth=auth, caches=caches,
                                             secure_cookies=False))
            for path in ("/api/namespaces/user1/pvcs",
                         "/api/storageclasses"):
                r = requests.get(vwa + path, headers=USER)
                out.append((r.status_code, strip(r.json())))
            twa = serve(P.tensorboards.create_app(
                kube, auth=auth, caches=caches, secure_cookies=False))
            r = requests.post(f"{twa}/api/namespaces/user1/tensorboards",
                              headers=USER,
                              json={"name": "tb1",
                                    "logspath": "pvc://vol1/logs"})
            out.append((r.status_code, strip(r.json())))
            for path in ("/api/namespaces/user1/tensorboards",
                         "/api/namespaces/user1/pvcs"):
                r = requests.get(twa + path, headers=USER)
                out.append((r.status_code, strip(r.json())))
        finally:
            for server in servers:
                server.shutdown()
                server.server_close()
            for inf in caches.values():
                inf.stop()
        return out

    ref, got = both(script)
    assert got == ref
    assert got[2] == (200, {"hard": 16, "used": 8, "remaining": 8})


# -- static serving -----------------------------------------------------------

TRAVERSALS = ["/shared/../jupyter/app.js", "/shared/%2e%2e/jupyter/app.js",
              "/shared/..%2Fjupyter%2Fapp.js", "/shared/%2E%2E%2F..%2Fetc",
              "/shared/x/../../jupyter/index.html", "/shared/..",
              "/shared/a\\b", "/shared/..\\jupyter\\app.js",
              "/shared/%5C..%5Cjupyter%5Capp.js", "/shared/nope.js",
              "/shared/x/%2e%2e/%2e%2e/jupyter/app.js",
              "/shared/common.js%00.css"]


@pytest.mark.parametrize("app_name", ["jupyter", "volumes", "tensorboards"])
def test_static_serving_equals_the_reference(app_name):
    def script(P):
        create = getattr(P, app_name).create_app
        app = create(kube_of(P), secure_cookies=False)
        out = []
        for path in ["/", "/app.js", "/shared/common.js",
                     "/shared/kubeflow.css", "/shared/./common.js",
                     "/shared/x/../common.js", "/index.html"]:
            resp, _ = call(app, "GET", path)
            out.append((path, resp.status_code,
                        resp.headers["Content-Type"]))
        for path in TRAVERSALS + ["/shared/", "/shared//etc/passwd",
                                  "/shared/%2Fetc%2Fpasswd"]:
            resp, payload = call(app, "GET", path)
            out.append((path, resp.status_code, payload))
        return out

    ref, got = both(script)
    assert got == ref
    types = {p: t for p, s, t in got[:7] if s == 200}
    assert types["/app.js"] == types["/shared/common.js"] == \
        "application/javascript; charset=utf-8"
    assert set(types) == {"/", "/app.js", "/shared/common.js",
                          "/shared/kubeflow.css", "/shared/./common.js",
                          "/shared/x/../common.js"}
    for path, status, payload in got[7:7 + len(TRAVERSALS)]:
        assert status == 404, path
        assert payload["log"].startswith("no such asset"), path
    # An absolute name never reaches the file: the router answers it with
    # the merged path's redirect, whose own answer is a 404.
    for path, status, payload in got[-2:]:
        assert status == 308 and payload["log"].endswith(
            "/shared/etc/passwd"), path
    resp, _ = call(getattr(PORT, app_name).create_app(
        kube_of(PORT), secure_cookies=False), "GET", "/shared/etc/passwd")
    assert resp.status_code == 404


def test_static_files_are_the_port_frontends():
    app = PORT.jupyter.create_app(kube_of(PORT), secure_cookies=False)
    resp, _ = call(app, "GET", "/app.js")
    root = os.path.dirname(PORT.static.__file__)
    with open(os.path.join(root, "..", "frontend", "jupyter", "app.js"),
              "rb") as f:
        assert resp.get_data() == f.read()
    assert b"/api/namespaces/${ns}/gpus" in resp.get_data()


@pytest.mark.parametrize("name", [
    "a.js", "x/y.css", "", ".", "..", "../x", "x/..", "x/../..", "/etc/passwd",
    "//etc", "a\\b", "./a", "a//b", "x/../y", "...", "..a", "a/..b"])
def test_safe_join_agrees_with_werkzeug(name):
    assert PORT.static.safe_join("/srv/site", name) == \
        werkzeug_safe_join("/srv/site", name)
