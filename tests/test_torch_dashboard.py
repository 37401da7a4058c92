"""The port's central dashboard (``kubeflow_tpu_torch/platform/
dashboard/`` and ``frontend/dashboard/``) against the JAX package's.

Every route of each package's app is driven through werkzeug's test
``Client`` over its own ``FakeKube`` and the statuses, JSON bodies and
the objects written are compared under ``test_torch_web_apps.ref_words``
(the dashboard cases of ``tests/ctrlplane/test_web_apps.py``), with the
dashboard's own words paired here: ``/api/gpu-overview`` and its keys
``clusterCapacityGPUs``/``requestedGPUsByNamespace`` are the reference's
``/api/tpu-overview`` with ``clusterCapacityChips``/
``requestedChipsByNamespace``, the metric type ``gpu`` is ``tpu`` (in
a route and in its 501 message), and
the version ``gpu-native-0.1.0`` is ``tpu-native-0.1.0``.  A Notebook of
N GPUs stands beside one of a v5e topology of N chips.

The SPA cases of ``tests/ctrlplane/test_frontend_dom.py`` (register,
contributors, the quota card, the activity feed and the chart) run
under the reference's ``BrowserHarness`` on both packages, and what each
DOM shows is compared with "GPU" read as "TPU" and "GPUs" as "chips"."""
import json
import os

import pytest
from werkzeug.test import Client

from kubeflow_tpu.platform.testing.jsdom import BrowserHarness
from test_torch_web_apps import (
    PORT,
    REF,
    TOPOLOGY,
    ref_words,
    req,
    strip,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRONTEND = {
    REF.root: os.path.join(REPO, "kubeflow_tpu", "platform", "frontend",
                           "dashboard"),
    PORT.root: os.path.join(REPO, "kubeflow_tpu_torch", "platform",
                            "frontend", "dashboard"),
}
DASH_WORDS = (("gpu-overview", "tpu-overview"),
              ("clusterCapacityGPUs", "clusterCapacityChips"),
              ("requestedGPUsByNamespace", "requestedChipsByNamespace"),
              ("gpu-native-0.1.0", "tpu-native-0.1.0"),
              ("metrics type 'gpu'", "metrics type 'tpu'"))


def dash_words(x):
    text = json.dumps(x)
    for port, ref in DASH_WORDS:
        text = text.replace(port, ref)
    return ref_words(json.loads(text))


def both(script):
    ref = strip(json.loads(json.dumps(script(REF), default=str)))
    got = dash_words(json.loads(json.dumps(script(PORT), default=str)))
    return ref, got


def mods(P):
    import importlib

    return (importlib.import_module(f"{P.root}.platform.dashboard.app"),
            importlib.import_module(
                f"{P.root}.platform.dashboard.metrics_service"))


def kube_of(P):
    k = P.FakeKube()
    k.add_namespace("user1")
    k.add_namespace("kubeflow")
    for name in ("node-1", "node-2"):
        if P.gpu:
            k.add_gpu_node(name, gpus=8)
        else:
            k.add_tpu_node(name, topology="2x4")
    return k


def dash(P, kube, **kw):
    app, _ = mods(P)
    return Client(app.create_app(kube, auth=P.crud.AuthContext(),
                                 secure_cookies=False, **kw))


def overview(P):
    return "/api/" + ("gpu" if P.gpu else "tpu") + "-overview"


def notebook(P, name, n, slices=None, bad=False):
    if P.gpu:
        dev = {"gpu": {"accelerator": "h100-80gb",
                       "gpus": "x" if bad else n}}
    else:
        dev = {"tpu": {"accelerator": "v5e",
                       "topology": "3x3" if bad else TOPOLOGY[n]}}
    if slices:
        dev["gpu" if P.gpu else "tpu"]["slices"] = slices
    return {"apiVersion": "kubeflow.org/v1beta1", "kind": "Notebook",
            "metadata": {"name": name, "namespace": "user1"},
            "spec": {"template": {"spec": {"containers": [{"image": "x"}]}},
                     **dev}}


def quota(P, ns, n):
    return {"apiVersion": "v1", "kind": "ResourceQuota",
            "metadata": {"name": "q", "namespace": ns},
            "spec": {"hard": {("nvidia.com/gpu" if P.gpu
                               else "google.com/tpu"): str(n)}}}


def test_gpu_overview_equals_the_reference():
    def script(P):
        kube = kube_of(P)
        kube.create(notebook(P, "nb", 16))
        kube.create(notebook(P, "ms", 8, slices=2))
        kube.create(notebook(P, "bad", 16, bad=True))
        c = dash(P, kube)
        out = [req(c, "GET", overview(P))]
        kube.create(quota(P, "user1", 48))
        out.append(req(c, "GET", overview(P) + "?ns=user1"))
        kube.add_namespace("noquota")
        out.append(req(c, "GET", overview(P) + "?ns=noquota"))
        out.append(req(c, "GET", overview(P), headers={}))
        return out

    ref, got = both(script)
    assert got == ref
    body = got[0][1]
    assert body["clusterCapacityChips"] == 16
    assert body["requestedChipsByNamespace"] == {"user1": 32}
    assert got[1][1]["quota"] == {"hard": 48, "used": 32, "remaining": 16}
    assert got[2][1]["quota"] is None and got[3][0] == 401


def test_workgroup_routes_equal_the_reference():
    def script(P):
        kube = kube_of(P)
        c = dash(P, kube)
        bob = {"kubeflow-userid": "bob@example.com"}
        out = [req(c, "GET", "/api/workgroup/env-info")]
        out.append(req(c, "POST", "/api/workgroup/create", {}))
        out.append(req(c, "POST", "/api/workgroup/create", {}))
        out.append(req(c, "POST", "/api/workgroup/create",
                       {"namespace": "elsewhere"}))
        out.append(req(c, "GET", "/api/workgroup/env-info"))
        out.append(req(c, "GET", "/api/workgroup/contributors/"
                       "kubeflow-alice"))
        out.append(req(c, "GET", "/api/workgroup/contributors/"
                       "kubeflow-alice", headers=bob))
        out.append(req(c, "POST", "/api/workgroup/add-contributor",
                       {"contributor": "bob@example.com",
                        "namespace": "kubeflow-alice"}))
        out.append(req(c, "POST", "/api/workgroup/add-contributor", {}))
        out.append(req(c, "POST", "/api/workgroup/add-contributor",
                       {"contributor": "eve@example.com",
                        "namespace": "kubeflow-alice"}, headers=bob))
        out.append(req(c, "GET", "/api/workgroup/contributors/"
                       "kubeflow-alice"))
        out.append(req(c, "GET", "/api/workgroup/env-info", headers=bob))
        out.append(req(c, "DELETE", "/api/workgroup/remove-contributor",
                       {"contributor": "bob@example.com",
                        "namespace": "kubeflow-alice"}))
        out.append(req(c, "GET", "/api/workgroup/contributors/"
                       "kubeflow-alice"))
        out.append(req(c, "GET", "/api/namespaces"))
        out.append(req(c, "DELETE", "/api/workgroup/nuke-self"))
        out.append(sorted(p["metadata"]["name"]
                          for p in kube.list(P.types.PROFILE)))
        return out

    ref, got = both(script)
    assert got == ref
    assert got[0][1]["hasWorkgroup"] is False
    assert got[1] == [200, {"success": True, "status": 200,
                            "namespace": "kubeflow-alice"}]
    assert got[2][0] == 409
    assert {"namespace": "kubeflow-alice", "role": "owner",
            "user": "alice@example.com"} in got[4][1]["namespaces"]
    assert got[-1] == []


def test_links_settings_namespaces_and_activities_equal_the_reference():
    def script(P):
        kube = kube_of(P)
        c = dash(P, kube)
        out = [req(c, "GET", "/api/dashboard-links"),
               req(c, "GET", "/api/dashboard-settings")]
        kube.create({"apiVersion": "v1", "kind": "ConfigMap",
                     "metadata": {"name": "kubeflow-dashboard-settings",
                                  "namespace": "kubeflow"},
                     "data": {"links": json.dumps({"menuLinks": [
                         {"link": "/x/", "text": "X"}]}),
                         "settings": "not json"}})
        out += [req(c, "GET", "/api/dashboard-links"),
                req(c, "GET", "/api/dashboard-settings"),
                req(c, "GET", "/api/namespaces")]
        for i, stamp in enumerate(("2099-01-01T00:00:00Z",
                                   "2098-01-01T00:00:00Z",
                                   "2100-01-01T00:00:00Z")):
            kube.create({"apiVersion": "v1", "kind": "Event",
                         "metadata": {"name": f"ev-{i}",
                                      "namespace": "user1"},
                         "involvedObject": {"kind": "Notebook",
                                            "name": "nb"},
                         "reason": "Scheduled", "message": f"m{i}",
                         "lastTimestamp": stamp})
        status, body = req(c, "GET", "/api/activities/user1")
        out.append([status, [e["metadata"]["name"] for e in body["events"]]])
        out.append(req(c, "GET", "/healthz", headers={}))
        return out

    ref, got = both(script)
    assert got == ref
    assert got[2][1]["links"] == {"menuLinks": [{"link": "/x/",
                                                 "text": "X"}]}
    assert got[3][1]["settings"] == "not json"
    assert got[5] == [200, ["ev-2", "ev-0", "ev-1"]]


def test_static_spa_is_served():
    for P in (PORT, REF):
        c = dash(P, kube_of(P))
        for path in ("/", "/app.js", "/shared/common.js"):
            r = c.get(path)
            assert r.status_code == 200, (P.root, path)
    page = dash(PORT, kube_of(PORT)).get("/").get_data(as_text=True)
    assert "GPUs (cluster)" in page and "TPU" not in page


def test_metrics_routes_equal_the_reference():
    calls = {}

    def script(P):
        _, ms = mods(P)
        kube = kube_of(P)
        out = [req(dash(P, kube), "GET", "/api/metrics/node")]
        seen = calls.setdefault(P.root, [])

        def fake_fetch(url, params):
            seen.append((url, dict(params)))
            return {"status": "success", "data": {"result": [
                {"metric": {"instance": "node-a"},
                 "values": [[1000, "0.5"], [1060, "0.75"], [1100, "x"]]},
                {"metric": {"pod": "p"}, "values": [[900, "1"]]}]}}

        svc = ms.PrometheusMetricsService("http://prom:9090",
                                          fetch=fake_fetch,
                                          now=lambda: 2000.0)
        c = dash(P, kube, metrics_service=svc)
        accel = "gpu" if P.gpu else "tpu"
        for mtype in ("node", "podcpu", "podmem", accel, "reconcile",
                      "workqueue", "bogus"):
            out.append(req(c, "GET", f"/api/metrics/{mtype}"
                           "?interval=Last5m"))
        out.append(req(c, "GET", "/api/metrics/node?interval=Nope"))

        def broken(url, params):
            raise RuntimeError("prometheus down")

        out.append(req(dash(P, kube, metrics_service=ms.PrometheusMetricsService(
            "http://prom:9090", fetch=broken)), "GET", "/api/metrics/podcpu"))

        class NodeOnly(ms.MetricsService):
            def node_cpu_utilization(self, interval):
                return [ms.TimeSeriesPoint(1.0, "n", 2.0)]

        c = dash(P, kube, metrics_service=NodeOnly())
        out += [req(c, "GET", "/api/metrics/node"),
                req(c, "GET", f"/api/metrics/{accel}")]
        return out

    ref, got = both(script)
    assert got == ref
    assert got[0][0] == 405
    assert [p["value"] for p in got[1][1]["points"]] == [1.0, 0.5, 0.75]
    assert got[7][0] == 404 and got[-1][0] == 501
    port_q = [p["query"] for _, p in calls[PORT.root]]
    ref_q = [p["query"] for _, p in calls[REF.root]]
    assert port_q[3] == "avg by (pod) (DCGM_FI_DEV_GPU_UTIL)"
    assert ref_q[3] == "avg by (pod) (tpu_duty_cycle_percent)"
    assert port_q[:3] + port_q[4:] == ref_q[:3] + ref_q[4:]
    assert [(u, p["end"] - p["start"], p["step"])
            for u, p in calls[PORT.root]] == \
        [(u, p["end"] - p["start"], p["step"]) for u, p in calls[REF.root]]


def test_prometheus_default_fetch_reads_query_range():
    """The port's default fetch is ``urllib.request``: a query_range GET
    whose JSON body is parsed; an HTTP error reads as no data."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlsplit

    from kubeflow_tpu_torch.platform.dashboard import metrics_service as ms

    seen = []

    class H(BaseHTTPRequestHandler):
        def do_GET(self):
            parts = urlsplit(self.path)
            seen.append((parts.path, parse_qs(parts.query)))
            if "bad" in self.path:
                self.send_response(500)
                self.end_headers()
                return
            body = json.dumps({"status": "success", "data": {"result": [
                {"metric": {"pod": "p0"}, "values": [[5, "42"]]}]}}).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        base = f"http://127.0.0.1:{srv.server_port}"
        svc = ms.PrometheusMetricsService(base, now=lambda: 600.0)
        pts = svc.gpu_duty_cycle(ms.Interval.Last5m)
        assert [p.to_dict() for p in pts] == [
            {"timestamp": 5.0, "label": "p0", "value": 42.0}]
        path, qs = seen[0]
        assert path == "/api/v1/query_range"
        assert qs["query"] == ["avg by (pod) (DCGM_FI_DEV_GPU_UTIL)"]
        assert qs["start"] == ["300.0"] and qs["end"] == ["600.0"]
        assert ms.PrometheusMetricsService(base + "/bad").node_cpu_utilization(
            ms.Interval.Last5m) == []
    finally:
        srv.shutdown()


# -- the SPA under the reference's DOM harness --------------------------------


def shown(P, text):
    """Text ``P``'s SPA showed, in the reference's words."""
    if not P.gpu:
        return text
    return text.replace("GPUs", "chips").replace("GPU", "TPU")


def sync_kube(P):
    """A FakeKube whose Profile creates reconcile inline, so the SPA's
    follow-up env-info sees the workgroup."""
    import importlib

    profile = importlib.import_module(f"{P.root}.platform.controllers.profile")
    runtime = importlib.import_module(f"{P.root}.platform.runtime")

    class SyncProfileKube(P.FakeKube):
        def create(self, obj, **kw):
            out = super().create(obj, **kw)
            if obj.get("kind") == "Profile":
                profile.ProfileReconciler(self).reconcile(
                    runtime.Request("", P.types.name_of(out)))
            return out

    kube = SyncProfileKube()
    kube.add_namespace("kubeflow")
    kube.add_namespace("user1")
    if P.gpu:
        kube.add_gpu_node("node-1", gpus=8)
    else:
        kube.add_tpu_node("node-1", topology="2x4")
    return kube


def harness(P, kube, **kw):
    app, _ = mods(P)
    client = Client(app.create_app(kube, secure_cookies=False, **kw))
    return BrowserHarness(FRONTEND[P.root], client,
                          url="http://spa.test/?ns=user1", user="owner@x.io")


def spa_both(script):
    return script(REF), script(PORT)


def test_register_then_contributors_equals_the_reference():
    def script(P):
        kube = sync_kube(P)
        h = harness(P, kube)
        out = [h.get("register-card").hidden]
        h.click("#register-btn")
        out += [h.text("#toast"), h.get("register-card").hidden,
                [o.value for o in h.get("ns-select").options]]
        h.query("[data-view=contributors]").click()
        out.append(h.get("view-contributors").hidden)
        h.set_value("[name=contributor]", "bob@x.io", event="input")
        h.submit("#contrib-form")
        out.append(h.query("#contrib-table tbody").textContent)
        h.query("#contrib-table tbody button.danger").click()
        out.append(h.query("#contrib-table tbody").textContent)
        out.append(shown(P, h.text("#stat-capacity")))
        return out

    ref, got = spa_both(script)
    assert got == ref
    assert got[0] is False and "Created namespace" in got[1]
    assert "bob@x.io" in got[5] and "bob@x.io" not in got[6]
    assert got[7] == "8"


def test_home_quota_card_equals_the_reference():
    def script(P):
        kube = sync_kube(P)
        h = harness(P, kube)
        h.click("#register-btn")
        ns = h.get("ns-select").options[0].value
        h.set_value("#ns-select", ns)
        out = [h.get("quota-card").hidden]
        kube.create(quota(P, ns, 16))
        nb = notebook(P, "holder", 8)
        nb["metadata"]["namespace"] = ns
        kube.create(nb)
        h.set_value("#ns-select", ns)
        out += [h.get("quota-card").hidden, shown(P, h.text("#stat-quota")),
                shown(P, h.text("#quota-card-title")),
                h.text("#stat-requested")]
        return out

    ref, got = spa_both(script)
    assert got == ref
    assert got[:3] == [True, False, "8 of 16 chips free"]
    assert got[3].startswith("TPU quota (")
    port = harness(PORT, sync_kube(PORT))
    page = " ".join(n.textContent for n in port.query_all("h2"))
    assert "GPUs (cluster)" in page and "GPU quota" in page
    assert "TPU" not in page and "chips" not in page


def test_activity_feed_equals_the_reference():
    def script(P):
        kube = sync_kube(P)
        h = harness(P, kube)
        h.click("#register-btn")
        ns = h.get("ns-select").options[0].value
        kube.create({"apiVersion": "v1", "kind": "Event",
                     "metadata": {"name": "ev-1", "namespace": ns},
                     "involvedObject": {"kind": "Notebook", "name": "nb-1",
                                        "namespace": ns},
                     "reason": "FailedScheduling",
                     "message": "0/3 nodes available",
                     "type": "Warning",
                     "lastTimestamp": "2099-01-01T00:00:00Z"})
        h.set_value("#ns-select", ns)
        return h.query("#activity-table tbody").textContent

    ref, got = spa_both(script)
    assert got == ref and "Notebook/nb-1" in got


@pytest.mark.parametrize("service", ["two_series", "none", "flaky",
                                     "accelerator_only"])
def test_chart_equals_the_reference(service):
    def script(P):
        _, ms = mods(P)
        accel = "gpu" if P.gpu else "tpu"
        state = {"calls": 0}

        class Metrics(ms.MetricsService):
            def node_cpu_utilization(self, interval):
                state["calls"] += 1
                if service == "accelerator_only":
                    raise NotImplementedError
                if service == "flaky" and state["calls"] == 1:
                    raise RuntimeError("transient blip")
                return [ms.TimeSeriesPoint(1000 + 60 * i, label,
                                           0.1 * i + bias)
                        for label, bias in (("node-a", 0.0),
                                            ("node-b", 0.3))
                        for i in range(5)]

        def accel_series(self, interval):
            if service == "accelerator_only":
                return [ms.TimeSeriesPoint(1000 + 60 * i, "gpu-0", 0.2 * i)
                        for i in range(3)]
            return []

        setattr(Metrics, f"{accel}_duty_cycle", accel_series)
        kw = {} if service == "none" else {"metrics_service": Metrics()}
        h = harness(P, sync_kube(P), **kw)
        out = [h.get("metrics-card").hidden]
        for mtype in ("node", accel, "podcpu", "node"):
            h.set_value("#metric-type", mtype)
            out.append([h.get("metrics-card").hidden,
                        h.get("metrics-empty").hidden,
                        [(line.getAttribute("data-series"),
                          line.getAttribute("points"))
                         for line in h.query_all("#metric-chart polyline")],
                        [s.textContent for s in
                         h.query_all("#metric-legend .legend-item")]])
        out.append([o.textContent for o in
                    h.get("metric-type").options])
        return out

    ref, got = spa_both(script)
    options = got.pop()
    assert options == [("GPU utilization" if o == "TPU duty cycle" else o)
                       for o in ref.pop()]
    assert got == ref
    if service == "two_series":
        assert got[1][2] and len(got[1][2]) == 2
    if service == "none":
        assert got[0] is True
    if service == "accelerator_only":
        assert len(got[2][2]) == 1
