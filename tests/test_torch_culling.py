"""The port's culling controller (``kubeflow_tpu_torch/platform/
controllers/culling.py``) against the reference's: the eleven cases of
``tests/ctrlplane/test_culling.py``, each through both packages'
``CullingReconciler`` (or ``make_controller``) over their own
``FakeKube``, with the same fake clock and prober.  The notebook's
annotations after each pass (the causal stamps left out), the
``requeue_after``, the probe URLs and the culling counters are equal.
Also the probe budget, and the port's ``default_prober`` (on
``urllib.request``) against a local HTTP server."""
import datetime
import http.server
import json
import socket
import threading
import time

import pytest

from kubeflow_tpu.platform.apis import notebook as ref_nbapi
from kubeflow_tpu.platform.controllers import culling as ref_culling
from kubeflow_tpu.platform.controllers import notebook as ref_notebook
from kubeflow_tpu.platform.k8s import types as ref_types
from kubeflow_tpu.platform.runtime import Request as RefRequest
from kubeflow_tpu.platform.runtime import metrics as ref_metrics
from kubeflow_tpu.platform.testing import FakeKube as RefKube
from kubeflow_tpu_torch.platform import FakeKube, Request
from kubeflow_tpu_torch.platform.apis import notebook as nbapi
from kubeflow_tpu_torch.platform.controllers import culling
from kubeflow_tpu_torch.platform.controllers import notebook
from kubeflow_tpu_torch.platform.k8s.types import NOTEBOOK
from kubeflow_tpu_torch.platform.runtime import metrics
from test_torch_notebook import CAUSAL, make_notebook

T0 = datetime.datetime(2026, 7, 29, 12, 0, 0, tzinfo=datetime.timezone.utc)
NS = "user1"


class Clock:
    def __init__(self):
        self.now = T0

    def __call__(self):
        return self.now

    def advance(self, minutes):
        self.now += datetime.timedelta(minutes=minutes)


class World:
    """One package's API server with notebook ``nb``, its culling module
    and its counters."""

    def __init__(self, port):
        self.port = port
        self.kube = FakeKube() if port else RefKube()
        self.kube.add_namespace(NS)
        self.kube.create(make_notebook())
        self.culling = culling if port else ref_culling
        self.notebook = notebook if port else ref_notebook
        self.nbapi = nbapi if port else ref_nbapi
        self.Request = Request if port else RefRequest
        self.NOTEBOOK = NOTEBOOK if port else ref_types.NOTEBOOK

    def reconciler(self, **kw):
        return self.culling.CullingReconciler(self.kube, **kw)

    def reconcile(self, r, name="nb"):
        return r.reconcile(self.Request(NS, name))

    def annotations(self, name="nb"):
        ann = dict(self.kube.get(self.NOTEBOOK, name, NS)["metadata"]
                   .get("annotations") or {})
        for k in CAUSAL:
            ann.pop(k, None)
        return ann

    def stopped(self, name="nb"):
        return self.nbapi.is_stopped(self.kube.get(self.NOTEBOOK, name, NS))

    def counters(self):
        if self.port:
            return (metrics.notebook_culling_total.sample(),
                    metrics.culling_probe_failures_total.sample())
        return tuple(ref_metrics.registry.get_sample_value(n) for n in (
            "notebook_culling_total",
            "notebook_culling_probe_failures_total"))


def both(scenario):
    """``scenario(world)`` on the reference, then on the port; each
    returns its observations, and the counters' rises are added."""
    out = []
    for port in (False, True):
        w = World(port)
        before = w.counters()
        got = scenario(w)
        out.append((got, tuple(a - b for a, b in zip(w.counters(), before))))
    assert out[1] == out[0]
    return out[1]


def kernels(state, last):
    return [{"execution_state": state, "last_activity": last}]


def test_busy_kernels_record_activity_not_cull():
    def scenario(w):
        r = w.reconciler(
            prober=lambda url: kernels("busy", "2026-07-29T11:59:00Z"),
            idle_minutes=30, now=Clock())
        result = w.reconcile(r)
        return result.requeue_after, w.stopped(), w.annotations()

    (requeue, stopped, ann), counts = both(scenario)
    assert requeue == 60.0 and not stopped and counts == (0, 0)
    assert ann == {nbapi.LAST_ACTIVITY_ANNOTATION: "2026-07-29T12:00:00Z"}


def test_idle_past_window_culls():
    def scenario(w):
        clock = Clock()
        r = w.reconciler(
            prober=lambda url: kernels("idle", "2026-07-29T11:00:00Z"),
            idle_minutes=30, now=clock)
        clock.advance(45)  # 12:45, last activity 11:00: 105 min idle
        result = w.reconcile(r)
        return result, w.stopped(), w.annotations()

    (result, stopped, ann), counts = both(scenario)
    assert result is None and stopped and counts == (1, 0)
    assert ann == {nbapi.STOP_ANNOTATION: "2026-07-29T12:45:00Z"}


def test_idle_within_window_spares():
    def scenario(w):
        r = w.reconciler(
            prober=lambda url: kernels("idle", "2026-07-29T11:50:00Z"),
            idle_minutes=30, now=Clock())
        return w.reconcile(r).requeue_after, w.stopped(), w.annotations()

    (requeue, stopped, ann), counts = both(scenario)
    assert requeue == 60.0 and not stopped and ann == {}


def test_unreachable_notebook_not_culled():
    def scenario(w):
        r = w.reconciler(prober=lambda url: None, idle_minutes=0)
        return w.reconcile(r).requeue_after, w.stopped()

    (requeue, stopped), counts = both(scenario)
    assert requeue == 60.0 and not stopped and counts == (0, 1)


def test_already_stopped_is_noop():
    def scenario(w):
        nb = w.kube.get(w.NOTEBOOK, "nb", NS)
        nb["metadata"].setdefault("annotations", {})[
            w.nbapi.STOP_ANNOTATION] = "x"
        w.kube.update(nb)
        calls = []
        r = w.reconciler(prober=lambda url: calls.append(url))
        return w.reconcile(r), calls

    (result, calls), counts = both(scenario)
    assert result is None and calls == [] and counts == (0, 0)


def test_probe_url_targets_worker0_service():
    def scenario(w):
        return w.reconciler(prober=lambda url: None).kernels_url("user1",
                                                                 "nb")

    url, _ = both(scenario)
    assert url == ("http://nb.user1.svc.cluster.local/notebook/user1/nb"
                   "/api/kernels")


def test_probe_url_dev_mode_uses_kubectl_proxy(monkeypatch):
    monkeypatch.setenv("DEV", "true")
    dev, _ = both(lambda w: w.reconciler(prober=lambda url: []).kernels_url(
        "user1", "nb"))
    assert dev == (
        "http://localhost:8001/api/v1/namespaces/user1/services/nb:http-nb"
        "/proxy/notebook/user1/nb/api/kernels")
    monkeypatch.delenv("DEV")
    plain, _ = both(lambda w: w.reconciler(
        prober=lambda url: []).kernels_url("user1", "nb"))
    assert plain != dev


def test_probe_throttled_to_check_period():
    """An event storm within one check period probes once; the next
    period probes again, a clock stepped back does not extend the
    throttle, and a stopped notebook drops its entry unprobed."""
    def scenario(w):
        clock, probes, results = Clock(), [], []
        r = w.reconciler(
            prober=lambda url: probes.append(url) or kernels(
                "busy", "2026-07-29T11:59:00Z"),
            idle_minutes=30, check_period_minutes=1.0, now=clock)
        for _ in range(5):
            results.append(w.reconcile(r).requeue_after)
        clock.advance(1.01)
        w.reconcile(r)
        clock.advance(-5)
        w.reconcile(r)
        n_before_stop = len(probes)
        nb = w.kube.get(w.NOTEBOOK, "nb", NS)
        nb["metadata"].setdefault("annotations", {})[
            w.nbapi.STOP_ANNOTATION] = "x"
        w.kube.update(nb)
        clock.advance(7)
        w.reconcile(r)
        return (results, n_before_stop, probes,
                (NS, "nb") in r._last_probe)

    (results, n, probes, throttled), _ = both(scenario)
    assert results[0] == 60.0 and all(x <= 60.0 for x in results)
    assert n == 3 and len(probes) == 3 and not throttled


def test_probe_budget_spent_counts_as_busy():
    """With a per-cycle budget, a slow probe spends it and the next
    notebook's probe is skipped as busy (never culled blind)."""
    def scenario(w):
        w.kube.create(make_notebook("nb2"))

        def prober(url):
            time.sleep(0.05)
            return kernels("idle", "2000-01-01T00:00:00Z")

        r = w.reconciler(prober=prober, idle_minutes=1.0,
                         check_period_minutes=10.0, probe_timeout=0.01,
                         probe_budget_s=0.02)
        return ([w.reconcile(r, name) is None for name in ("nb", "nb2")],
                [w.stopped(name) for name in ("nb", "nb2")])

    (culled, stopped), counts = both(scenario)
    assert culled == [True, False] and stopped == [True, False]
    assert counts == (1, 1)


def test_fleet_of_slow_probes_culls_within_budget():
    """Eight probe workers sweep 40 notebooks whose probes take 50 ms
    (250 ms for a few) within a bounded time."""
    def scenario(w):
        n = 40
        for i in range(n):
            w.kube.create(make_notebook(f"fleet-{i}"))
        probed, lock = set(), threading.Lock()

        def slow_prober(url):
            time.sleep(0.25 if url.count("fleet-3") else 0.05)
            with lock:
                probed.add(url)
            return kernels("idle", "2000-01-01T00:00:00Z")

        ctrl = w.culling.make_controller(
            w.kube, prober=slow_prober, idle_minutes=1.0,
            check_period_minutes=0.01)
        ctrl.start(w.kube)
        try:
            deadline = time.monotonic() + 20.0
            while time.monotonic() < deadline:
                stopped = [i for i in range(n) if w.stopped(f"fleet-{i}")]
                if len(stopped) == n:
                    break
                time.sleep(0.05)
        finally:
            ctrl.stop()
        return ctrl.workers, len(stopped), sorted(
            u for u in probed if "fleet-" in u)

    (workers, stopped, probed), counts = both(scenario)
    assert workers == 8 and stopped == 40 and len(probed) == 40
    assert counts[0] >= 40


def test_culler_shares_notebook_informer():
    """One Notebook informer feeds the notebook and culling controllers:
    a second start of it is a no-op, and the culler acts on its stream."""
    def scenario(w):
        nb_ctrl = w.notebook.make_controller(w.kube, use_istio=False)
        shared = nb_ctrl.informers[w.NOTEBOOK]
        cull_ctrl = w.culling.make_controller(
            w.kube, prober=lambda url: kernels("idle",
                                               "2000-01-01T00:00:00Z"),
            idle_minutes=0.0, check_period_minutes=0.001,
            notebook_informer=shared)
        is_shared = cull_ctrl.informers[w.NOTEBOOK] is shared
        nb_ctrl.start(w.kube)
        cull_ctrl.start(w.kube)
        try:
            w.kube.create(make_notebook("shared-nb"))
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline and not w.stopped("shared-nb"):
                time.sleep(0.02)
        finally:
            nb_ctrl.stop()
            cull_ctrl.stop()
        return is_shared, w.stopped("shared-nb"), cull_ctrl.resync_period

    (is_shared, stopped, resync), _ = both(scenario)
    assert is_shared and stopped and resync == 60.0


def test_sharer_stopping_does_not_kill_shared_informer():
    def scenario(w):
        nb_ctrl = w.notebook.make_controller(w.kube, use_istio=False)
        shared = nb_ctrl.informers[w.NOTEBOOK]
        cull_ctrl = w.culling.make_controller(
            w.kube, prober=lambda url: None, notebook_informer=shared)
        nb_ctrl.start(w.kube)
        cull_ctrl.start(w.kube)
        try:
            cull_ctrl.stop()
            alive_after_sharer = not shared._stop.is_set()
        finally:
            nb_ctrl.stop()
        with pytest.raises(RuntimeError, match="not restartable"):
            shared.start()
        return alive_after_sharer, shared._stop.is_set()

    assert both(scenario)[0] == (True, True)


# -- the port's default prober ---------------------------------------------------


class _Kernels(http.server.BaseHTTPRequestHandler):
    """/list answers a kernel list, /error a 500, /dict a JSON object."""

    def do_GET(self):
        body = {"/list": b'[{"id": "k", "execution_state": "idle"}]',
                "/dict": b'{"id": "k"}'}.get(self.path, b"boom")
        self.send_response(500 if self.path == "/error" else 200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):
        pass


@pytest.fixture(scope="module")
def kernels_server():
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Kernels)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()


@pytest.mark.parametrize("path,want", [
    ("/list", [{"id": "k", "execution_state": "idle"}]),
    ("/error", None),
    ("/dict", None),
])
def test_default_prober_answers(kernels_server, path, want):
    assert culling.default_prober(kernels_server + path, timeout=5.0) == want


def test_default_prober_gives_up_within_its_timeout():
    """A server that accepts and never answers: None within the timeout
    plus 1 s."""
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    sock.listen(1)
    try:
        t0 = time.monotonic()
        got = culling.default_prober(
            f"http://127.0.0.1:{sock.getsockname()[1]}/api/kernels",
            timeout=0.5)
        took = time.monotonic() - t0
    finally:
        sock.close()
    assert got is None and took < 0.5 + 1.0


def test_default_prober_is_the_reconcilers_default(kernels_server):
    r = culling.CullingReconciler(FakeKube(), probe_timeout=2.0)
    assert r.prober(kernels_server + "/list") == [
        {"id": "k", "execution_state": "idle"}]
    assert r.prober(kernels_server + "/error") is None
    assert json.dumps(r.prober(kernels_server + "/dict")) == "null"
