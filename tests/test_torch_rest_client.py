"""The port's ``RestKubeClient`` (``kubeflow_tpu_torch/platform/k8s/client.py``)
under failure, held against the reference's ``RestKubeClient`` on the
reference's client cases (``tests/ctrlplane/test_resilience.py``): the
retry policy (idempotent verbs only, bounded, 429 for every verb
honouring ``Retry-After``, full jitter), finite timeouts on every verb,
the circuit breaker, the informer and the watch loop resuming by
resourceVersion over a wire whose streams drop, a stale pooled
connection that never re-sends a create, and the kubeconfig.

Each scripted case gives one script to both clients: the port's one
HTTP exchange (``_send``) and the reference's ``requests`` session
(``_session``) answer from it.  Both sides must make the same calls
(method, path, query, body, headers, stream, timeout), end the same way
(the value, or the error's type, status, reason and whether the circuit
refused it), retry as often, sleep as long and leave the breaker in the
same state.  The wire cases run each package's client against its own
server over its own store."""
import http.client
import json
import random
import socket
import threading
import time
from types import SimpleNamespace

import pytest
import requests

from kubeflow_tpu.platform.k8s.client import CircuitBreaker as RefBreaker
from kubeflow_tpu.platform.k8s.client import RestKubeClient as RefClient
from kubeflow_tpu.platform.k8s.types import NOTEBOOK as REF_NOTEBOOK
from kubeflow_tpu.platform.runtime import metrics as ref_metrics
from kubeflow_tpu.platform.runtime.controller import Controller as RefController
from kubeflow_tpu.platform.runtime.controller import Reconciler as RefReconciler
from kubeflow_tpu.platform.runtime.informer import Informer as RefInformer
from kubeflow_tpu.platform.testing import ChaosKube as RefChaos
from kubeflow_tpu.platform.testing import FakeKube as RefKube
from kubeflow_tpu.platform.testing import Fault as RefFault
from kubeflow_tpu.platform.testing.httpkube import HttpKubeServer as RefServer
from kubeflow_tpu.telemetry import causal as ref_causal
from kubeflow_tpu_torch.platform.k8s import errors
from kubeflow_tpu_torch.platform.k8s.client import (
    CircuitBreaker,
    Response,
    RestKubeClient,
)
from kubeflow_tpu_torch.platform.k8s.types import NOTEBOOK
from kubeflow_tpu_torch.platform.runtime import metrics
from kubeflow_tpu_torch.platform.runtime.controller import (
    Controller,
    Reconciler,
)
from kubeflow_tpu_torch.platform.runtime.informer import Informer
from kubeflow_tpu_torch.platform.testing.chaos import ChaosKube, Fault
from kubeflow_tpu_torch.platform.testing.fake import FakeKube
from kubeflow_tpu_torch.platform.testing.httpkube import HttpKubeServer
from kubeflow_tpu_torch.telemetry import causal

BASE = "http://api.invalid"
VERBS = ("get", "list", "watch", "create", "update", "update_status",
         "patch", "patch_status", "delete", "logs")
NS_OBJ = {"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": "x"}}


# -- one script, both clients -------------------------------------------------


def reply(status, body=None, headers=None):
    return ("reply", status, body if body is not None else {}, headers or {})


REFUSED = ("refused",)          # the connection refused
DISCONNECTED = ("disconnected",)  # the server closed without a reply
STREAM_END = ("stream-end",)    # a watch's stream that ends at once


class EmptyStream(Response):
    """A watch's stream that the server closed at once."""

    def readline(self):
        return b""

    def close(self):
        pass


def port_item(item):
    if item[0] == "reply":
        _, status, body, headers = item
        return Response(status, dict(headers), json.dumps(body).encode())
    if item[0] == "refused":
        return ConnectionRefusedError("refused")
    if item[0] == "disconnected":
        return http.client.RemoteDisconnected("gone")
    return EmptyStream(200, {}, b"")


class RefResponse:
    """A ``requests.Response`` as the reference's client reads it."""

    def __init__(self, status_code, body, headers):
        self.status_code = status_code
        self._body = body
        self.headers = dict(headers)
        self.text = json.dumps(body)

    def json(self):
        return self._body

    def iter_lines(self, chunk_size=512):
        return iter(())

    def close(self):
        pass


def ref_item(item):
    if item[0] == "reply":
        _, status, body, headers = item
        return RefResponse(status, body, headers)
    if item[0] in ("refused", "disconnected"):
        return requests.ConnectionError(item[0])
    return RefResponse(200, {}, {})


def _body(data):
    if not data:
        return None
    return json.loads(data)


class ScriptedSend:
    """Stands in for the port's one exchange."""

    def __init__(self, script):
        self.script = [port_item(i) for i in script]
        self.calls = []

    def __call__(self, method, path, **kw):
        self.calls.append((method, path, dict(kw["params"] or {}),
                           _body(kw["data"]), dict(kw["headers"]),
                           kw["stream"], tuple(kw["timeout"])))
        item = self.script.pop(0) if self.script else port_item(reply(200))
        if isinstance(item, BaseException):
            raise item
        return item


class ScriptedSession:
    """Stands in for the reference's ``requests.Session``."""

    def __init__(self, script):
        self.script = [ref_item(i) for i in script]
        self.calls = []
        self.headers = {}

    def request(self, method, url, **kw):
        assert url.startswith(BASE)
        self.calls.append((method, url[len(BASE):],
                           dict(kw.get("params") or {}),
                           _body(kw.get("data")),
                           dict(kw.get("headers") or {}),
                           kw.get("stream"), tuple(kw["timeout"])))
        item = self.script.pop(0) if self.script else ref_item(reply(200))
        if isinstance(item, BaseException):
            raise item
        return item


def _retries(side):
    if side == "port":
        return sum(metrics.rest_client_retries_total.sample(verb=v) or 0
                   for v in VERBS)
    return sum(ref_metrics.registry.get_sample_value(
        "rest_client_retries_total", {"verb": v}) or 0 for v in VERBS)


def _circuit(side):
    if side == "port":
        return (metrics.rest_client_circuit_opens_total.sample() or 0,
                metrics.rest_client_circuit_state.sample())
    return (ref_metrics.registry.get_sample_value(
        "rest_client_circuit_opens_total") or 0,
        ref_metrics.registry.get_sample_value("rest_client_circuit_state"))


def _ended(fn):
    try:
        return ("returned", fn())
    except Exception as e:  # noqa: BLE001 — the outcome is compared
        return ("raised", type(e).__name__, getattr(e, "status", None),
                getattr(e, "reason", None),
                bool(getattr(e, "circuit_open", False)),
                "circuit breaker open" in str(e))


class Pair:
    """The reference's client and the port's, on one script.  ``record``
    holds lists that monkeypatched functions append to (sleeps, jitter
    draws); each side's share of them is part of its outcome."""

    def __init__(self, script=(), *, record=(), **kwargs):
        kwargs.setdefault("retries", 3)
        kwargs.setdefault("retry_base", 0.001)
        kwargs.setdefault("retry_cap", 0.002)
        kwargs.setdefault("breaker_threshold", 0)  # off unless asked
        self.record = record
        self.ref = RefClient(BASE, qps=0, **kwargs)
        self.port = RestKubeClient(BASE, qps=0, **kwargs)
        self.script(script)

    def script(self, items):
        self.ref._session = ScriptedSession(items)
        self.port._send = ScriptedSend(items)

    def both(self, op):
        """``op(client, NOTEBOOK)`` on the reference, then on the port:
        the same outcome, retries and records, or the case fails."""
        out = {}
        for side, client, gvk in (("ref", self.ref, REF_NOTEBOOK),
                                  ("port", self.port, NOTEBOOK)):
            marks = [len(r) for r in self.record]
            retries = _retries(side)
            random.seed(0)       # the same full-jitter draws on both sides
            ended = _ended(lambda: op(client, gvk))
            out[side] = (ended, _retries(side) - retries,
                         [r[m:] for r, m in zip(self.record, marks)])
        assert out["port"] == out["ref"]
        return out["port"][0]

    @property
    def calls(self):
        """The calls both sides made, equal."""
        port, ref = self.port._send.calls, self.ref._session.calls
        assert port == ref
        return port

    def health(self):
        assert self.port.health() == self.ref.health()
        assert self.port.breaker.state == self.ref.breaker.state
        return self.port.health()


@pytest.fixture
def sleeps(monkeypatch):
    out = []
    monkeypatch.setattr(time, "sleep", lambda s: out.append(s))
    return out


def get_nb(client, gvk):
    return client.get(gvk, "nb", "user1")


def test_get_retried_on_503_then_succeeds():
    pair = Pair([reply(503, {"message": "shedding"}),
                 reply(200, {"metadata": {"name": "nb"}})])
    assert pair.both(get_nb) == ("returned", {"metadata": {"name": "nb"}})
    assert len(pair.calls) == 2


def test_list_retried_on_transport_error():
    pair = Pair([REFUSED, reply(200, {"items": []})])
    assert pair.both(lambda c, g: c.list(g, "user1")) == ("returned", [])
    assert len(pair.calls) == 2


def test_retries_are_bounded():
    pair = Pair([reply(503, {"message": "down"})] * 10, retries=2)
    assert pair.both(get_nb)[:3] == ("raised", "ServiceUnavailable", 503)
    assert len(pair.calls) == 3


def test_create_not_retried_on_500():
    pair = Pair([reply(500, {"message": "boom"}), reply(201)])
    assert pair.both(lambda c, g: c.create(dict(NS_OBJ)))[:2] == \
        ("raised", "InternalError")
    assert len(pair.calls) == 1


def test_update_not_retried_on_transport_error():
    pair = Pair([DISCONNECTED])
    assert pair.both(lambda c, g: c.update(dict(NS_OBJ)))[:2] == \
        ("raised", "TransportError")
    assert len(pair.calls) == 1


def test_patch_not_retried_and_patch_type_taken_once():
    ops = [{"op": "add", "path": "/a", "value": 1}]
    pair = Pair([REFUSED], retries=3)
    assert pair.both(lambda c, g: c.patch(g, "nb", ops, "user1",
                                          patch_type="json"))[:2] == \
        ("raised", "TransportError")
    assert len(pair.calls) == 1
    # A retried patch keeps its Content-Type on every attempt.
    pair = Pair([reply(429, {"reason": "TooManyRequests"},
                       {"Retry-After": "0"}), reply(200, {})])
    pair.both(lambda c, g: c.patch(g, "nb", [], "user1", patch_type="json"))
    calls = pair.calls
    assert [c[4]["Content-Type"] for c in calls] == \
        ["application/json-patch+json"] * 2
    assert all("_patch_type" not in c[2] for c in calls)


def test_create_retried_on_429_honouring_retry_after(sleeps):
    pair = Pair([reply(429, {"message": "slow down",
                             "reason": "TooManyRequests"},
                       {"Retry-After": "0.25"}),
                 reply(201, {"metadata": {"name": "x"}})], record=[sleeps])
    assert pair.both(lambda c, g: c.create(dict(NS_OBJ))) == \
        ("returned", {"metadata": {"name": "x"}})
    assert sleeps == [0.25, 0.25]   # once a side
    assert len(pair.calls) == 2


def test_retry_after_is_capped_at_30s(sleeps):
    pair = Pair([reply(429, {"reason": "TooManyRequests"},
                       {"Retry-After": "3600"}), reply(200, {})],
                record=[sleeps])
    pair.both(get_nb)
    assert sleeps == [30.0, 30.0]


def test_delete_is_idempotent_and_retried():
    pair = Pair([reply(503, {"message": "down"}),
                 reply(200, {"status": "Success"})])
    assert pair.both(lambda c, g: c.delete(g, "nb", "user1")) == \
        ("returned", None)
    calls = pair.calls
    assert len(calls) == 2
    assert calls[0][3] == {"propagationPolicy": "Background"}


def test_jitter_bounds(monkeypatch):
    draws = []
    monkeypatch.setattr(random, "uniform",
                        lambda lo, hi: draws.append((lo, hi)) or 0.0)
    pair = Pair([reply(503, {"message": "down"})] * 4, record=[draws],
                retries=3, retry_base=0.1, retry_cap=0.3)
    assert pair.both(get_nb)[:2] == ("raised", "ServiceUnavailable")
    assert draws == [(0.0, 0.1), (0.0, 0.2), (0.0, 0.3)] * 2


def test_every_verb_carries_a_finite_timeout():
    pair = Pair([reply(200, {"items": [], "metadata": {}})] * 9, retries=0)
    verbs = [
        lambda c, g: c.get(g, "nb", "user1"),
        lambda c, g: c.list(g, "user1"),
        lambda c, g: c.create(dict(NS_OBJ)),
        lambda c, g: c.update(dict(NS_OBJ)),
        lambda c, g: c.update_status(dict(NS_OBJ)),
        lambda c, g: c.patch(g, "nb", {"metadata": {}}, "user1"),
        lambda c, g: c.patch_status(g, "nb", {"status": {}}, "user1"),
        lambda c, g: c.delete(g, "nb", "user1"),
        lambda c, g: c.pod_logs("p", "user1"),
    ]
    for op in verbs:
        assert pair.both(op)[0] == "returned"
    calls = pair.calls
    assert len(calls) == 9
    for call in calls:
        connect, read = call[6]
        assert 0 < connect < float("inf") and 0 < read < float("inf")
        assert call[5] is False
    pair.script([STREAM_END])
    assert pair.both(lambda c, g: list(c.watch(g, "user1"))) == \
        ("returned", [])
    watch = pair.calls[-1]
    assert watch[5] is True
    assert watch[6] == (pair.port.connect_timeout,
                        pair.port.WATCH_TIMEOUT_SECONDS + 30)


def test_every_verb_carries_traceparent():
    pair = Pair([reply(200, {"items": []})] * 2, retries=0)
    tp = causal.mint().to_traceparent()

    def traced(client, gvk):
        mod = causal if client is pair.port else ref_causal
        with mod.use(mod.parse_traceparent(tp)):
            client.list(gvk, "user1")
            client.get(gvk, "nb", "user1")

    pair.both(traced)
    assert [c[4]["traceparent"] for c in pair.calls] == [tp, tp]


def test_breaker_trips_half_opens_and_closes():
    # Cooldowns of half a second: long beside a loaded host's stalls,
    # which must not half-open the circuit between two steps.
    pair = Pair([REFUSED, REFUSED], retries=0, breaker_threshold=2,
                breaker_cooldown=0.5)
    before = {"port": _circuit("port"), "ref": _circuit("ref")}
    for _ in range(2):
        assert pair.both(get_nb)[:2] == ("raised", "TransportError")
    assert pair.health() == {"circuit": "open", "consecutive_failures": 2}
    after = {"port": _circuit("port"), "ref": _circuit("ref")}
    assert after["port"][0] - before["port"][0] == \
        after["ref"][0] - before["ref"][0] == 1
    assert after["port"][1] == after["ref"][1] == 2
    calls = len(pair.calls)
    ended = pair.both(get_nb)
    assert ended[1] == "TransportError" and ended[4] and ended[5]
    assert len(pair.calls) == calls
    time.sleep(0.55)
    pair.script([reply(200, {"metadata": {}})])
    pair.both(get_nb)
    assert pair.health() == {"circuit": "closed", "consecutive_failures": 0}


def test_breaker_reopens_on_a_failed_probe():
    pair = Pair([REFUSED, REFUSED], retries=0, breaker_threshold=1,
                breaker_cooldown=0.5)
    pair.both(get_nb)
    assert pair.health()["circuit"] == "open"
    time.sleep(0.55)
    assert pair.both(get_nb)[:2] == ("raised", "TransportError")
    assert pair.health()["circuit"] == "open"
    assert len(pair.calls) == 2


def test_open_circuit_fails_fast_without_retry_sleeps(sleeps):
    pair = Pair([REFUSED], retries=3, breaker_threshold=1,
                breaker_cooldown=60, record=[sleeps])
    pair.both(get_nb)
    assert pair.health()["circuit"] == "open"
    calls = len(pair.calls)
    sleeps.clear()
    ended = pair.both(get_nb)
    assert ended[4] and ended[5]
    assert len(pair.calls) == calls and sleeps == []


def test_4xx_does_not_trip_the_breaker():
    pair = Pair([reply(404, {"message": "nope", "reason": "NotFound"})] * 3,
                retries=0, breaker_threshold=1, breaker_cooldown=10)
    assert pair.both(get_nb)[:4] == ("raised", "NotFound", 404, "NotFound")
    assert pair.health()["circuit"] == "closed"


def test_breaker_threshold_zero_is_off():
    for b in (CircuitBreaker(0, 10), RefBreaker(0, 10)):
        for _ in range(10):
            b.on_failure()
        assert b.allow() and b.state == "closed"


def test_knobs_from_the_environment_and_invalid_defaults(monkeypatch):
    monkeypatch.setenv("K8S_CLIENT_TIMEOUT", "7")
    monkeypatch.setenv("K8S_CLIENT_RETRIES", "not-a-number")
    monkeypatch.setenv("K8S_CLIENT_POOL_SIZE", "4")
    monkeypatch.setenv("K8S_CLIENT_QPS", "0")

    def knobs(c):
        return (c.timeout, c.connect_timeout, c.retries, c.retry_base,
                c.retry_cap, c.pool_size, c._limiter is None,
                c.breaker.threshold, c.breaker.cooldown)

    got = knobs(RestKubeClient(BASE))
    assert got == knobs(RefClient(BASE))
    assert got == (7.0, 5.0, 3, 0.1, 5.0, 4, True, 5, 10.0)


# -- resume by resourceVersion over a dropping wire ---------------------------

# Each package's stack: its store, fault injector, server, client and
# runtime.
PORT = SimpleNamespace(Kube=FakeKube, Chaos=ChaosKube, Fault=Fault,
                       Server=HttpKubeServer, Client=RestKubeClient,
                       Informer=Informer, Controller=Controller,
                       Reconciler=Reconciler, NOTEBOOK=NOTEBOOK,
                       restarts=lambda: metrics.informer_watch_restarts_total
                       .sample(kind="Notebook") or 0)
REF = SimpleNamespace(Kube=RefKube, Chaos=RefChaos, Fault=RefFault,
                      Server=RefServer, Client=RefClient,
                      Informer=RefInformer, Controller=RefController,
                      Reconciler=RefReconciler, NOTEBOOK=REF_NOTEBOOK,
                      restarts=lambda: ref_metrics.registry.get_sample_value(
                          "informer_watch_restarts_total",
                          {"kind": "Notebook"}) or 0)


def make_nb(name, ns="ns"):
    return {"apiVersion": "kubeflow.org/v1beta1", "kind": "Notebook",
            "metadata": {"name": name, "namespace": ns},
            "spec": {"template": {"spec": {"containers": [{"name": "c"}]}}}}


def wire(pkg, fault, **kw):
    """``pkg``'s store behind a ChaosKube with ``fault`` on watches,
    served over its HTTP server; returns (kube, chaos, client, server)."""
    kube = pkg.Kube()
    kube.add_namespace("ns")
    chaos = pkg.Chaos(kube, [pkg.Fault(fault, 1.0,
                                       verbs=frozenset({"watch"}), **kw)])
    server = pkg.Server(chaos).start()
    return kube, chaos, pkg.Client(server.base_url, qps=0), server


def wait_until(fn, what, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not fn():
        assert time.monotonic() < deadline, what
        time.sleep(0.01)


def informer_over_a_dropping_wire(pkg):
    kube, chaos, client, server = wire(pkg, "drop")
    informer = pkg.Informer(client, pkg.NOTEBOOK)
    informer.start()
    try:
        assert informer.wait_for_sync(10.0)
        for i in range(5):
            kube.create(make_nb(f"nb-{i}"))
            wait_until(lambda: informer.get(f"nb-{i}", "ns") is not None,
                       f"nb-{i} never cached")
        cached = sorted(o["metadata"]["name"] for o in informer.list("ns"))
    finally:
        informer.stop()
        server.stop()
    resumed = [e["resource_version"] for e in chaos.watch_establishments[1:]]
    return {"cached": cached, "lists": chaos.calls["list"],
            "resumed": bool(resumed) and all(rv is not None
                                             for rv in resumed)}


def test_informer_resumes_by_rv_after_stream_drop():
    got = informer_over_a_dropping_wire(PORT)
    assert got == informer_over_a_dropping_wire(REF)
    # One list, never a relist; every re-establishment from a concrete RV.
    assert got == {"cached": [f"nb-{i}" for i in range(5)], "lists": 1,
                   "resumed": True}


def informer_after_a_410(pkg, at):
    """An informer whose first watch meets a 410, taken ``at`` the server
    (a ChaosKube over the store, the 410 a JSON ``Status`` on the wire)
    or at the client (a ChaosKube over the ``RestKubeClient``)."""
    fault = [pkg.Fault("410", 1.0, verbs=frozenset({"watch"}),
                       max_injections=1)]
    kube = pkg.Kube()
    kube.add_namespace("ns")
    if at == "server":
        chaos = pkg.Chaos(kube, fault)
        server = pkg.Server(chaos).start()
        client = pkg.Client(server.base_url, qps=0)
    else:
        server = pkg.Server(kube).start()
        chaos = pkg.Chaos(pkg.Client(server.base_url, qps=0), fault)
        client = chaos
    informer = pkg.Informer(client, pkg.NOTEBOOK)
    restarts = pkg.restarts()
    informer.start()
    try:
        assert informer.wait_for_sync(10.0)
        wait_until(lambda: chaos.calls.get("list", 0) >= 2,
                   "no relist after the 410")
        kube.create(make_nb("after"))
        wait_until(lambda: informer.get("after", "ns") is not None,
                   "not cached after the relist")
    finally:
        informer.stop()
        server.stop()
    return {"relisted": chaos.calls["list"] >= 2,
            "restarted": pkg.restarts() > restarts}


def test_informer_relists_on_410_over_the_wire():
    """The reference's server starts a watch's body lazily, so a 410 there
    goes out as a 500 that the client retries: the reference side takes
    its 410 at the client, the port's on the wire and at the client."""
    got = informer_after_a_410(PORT, "server")
    assert got == informer_after_a_410(PORT, "client") \
        == informer_after_a_410(REF, "client") \
        == {"relisted": True, "restarted": True}


def watch_loop_over_a_dropping_wire(pkg):
    kube, chaos, client, server = wire(pkg, "drop")
    kube.create(make_nb("nb-pre"))
    seen = []

    class Probe(pkg.Reconciler):
        def reconcile(self, req):
            seen.append(req.name)

    ctrl = pkg.Controller("drop-probe", Probe(), primary=pkg.NOTEBOOK,
                          namespace="ns", stuck_deadline=0)
    ctrl.start(client)
    try:
        wait_until(lambda: "nb-pre" in seen, "nb-pre never reconciled")
        for i in range(3):
            kube.create(make_nb(f"nb-{i}"))
            wait_until(lambda: f"nb-{i}" in seen, f"nb-{i} never reconciled")
    finally:
        ctrl.stop()
        server.stop()
    resumed = [e["resource_version"] for e in chaos.watch_establishments[1:]]
    return {"seen": sorted(set(seen)), "lists": chaos.calls.get("list", 0),
            "resumed": bool(resumed) and all(rv is not None
                                             for rv in resumed)}


def test_watch_loop_resumes_by_rv_after_stream_drop():
    got = watch_loop_over_a_dropping_wire(PORT)
    assert got == watch_loop_over_a_dropping_wire(REF)
    assert got == {"seen": ["nb-0", "nb-1", "nb-2", "nb-pre"], "lists": 0,
                   "resumed": True}


def test_stop_ends_a_quiet_watch_at_once():
    """The port's own: a stopped watch ends at once, not at its next event
    or its window's end (the reference's reads ``stop`` between lines
    only, so a quiet stream holds it for the window)."""
    kube = FakeKube()
    kube.add_namespace("ns")
    server = HttpKubeServer(kube).start()
    try:
        client = RestKubeClient(server.base_url, qps=0)
        stop = threading.Event()
        done = threading.Event()

        def consume():
            for _ in client.watch(NOTEBOOK, "ns", stop=stop):
                pass
            done.set()

        threading.Thread(target=consume, daemon=True).start()
        time.sleep(0.3)
        t0 = time.monotonic()
        stop.set()
        assert done.wait(5.0)
        assert time.monotonic() - t0 < 1.0
    finally:
        server.stop()


# -- stale pooled connections -------------------------------------------------


class ScriptedServer:
    """A raw HTTP/1.1 server answering each request by the next action:
    ``ok`` (a JSON reply, kept alive), ``ok-close`` (a reply, then the
    connection closed) or ``drop`` (the request read, the connection
    closed with no reply).  Records (connection number, method, path)."""

    def __init__(self, actions):
        self.actions = list(actions)
        self.requests = []
        self._sock = socket.socket()
        self._sock.bind(("127.0.0.1", 0))
        self._sock.listen(8)
        self.port = self._sock.getsockname()[1]
        self._conns = 0
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        while True:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            self._conns += 1
            threading.Thread(target=self._serve, args=(conn, self._conns),
                             daemon=True).start()

    def _serve(self, conn, number):
        f = conn.makefile("rb")
        try:
            while True:
                line = f.readline()
                if not line:
                    return
                method, path, _ = line.decode().split(" ", 2)
                length = 0
                while True:
                    h = f.readline()
                    if h in (b"\r\n", b"\n", b""):
                        break
                    k, _, v = h.decode().partition(":")
                    if k.strip().lower() == "content-length":
                        length = int(v)
                if length:
                    f.read(length)
                self.requests.append((number, method, path))
                action = self.actions.pop(0) if self.actions else "ok"
                if action == "drop":
                    return
                body = json.dumps({"metadata": {"name": "x"}}).encode()
                conn.sendall(b"HTTP/1.1 201 Created\r\nContent-Type: "
                             b"application/json\r\nContent-Length: %d\r\n"
                             b"\r\n%s" % (len(body), body))
                if action == "ok-close":
                    return
        finally:
            f.close()
            conn.close()

    def close(self):
        self._sock.close()


def stale_connection_then_create(Client):
    server = ScriptedServer(["ok-close", "ok"])
    try:
        client = Client(f"http://127.0.0.1:{server.port}", qps=0, retries=3)
        client.get(NOTEBOOK, "x", "ns")
        time.sleep(0.2)          # the server has closed the pooled socket
        client.create(dict(NS_OBJ))
        return client, server.requests
    finally:
        server.close()


def test_stale_pooled_connection_is_replaced_before_a_create():
    client, got = stale_connection_then_create(RestKubeClient)
    _, want = stale_connection_then_create(RefClient)
    assert got == want
    # The create went once, on a new connection.
    assert [r for r in got if r[1] == "POST"] == [
        (2, "POST", "/api/v1/namespaces")]
    assert client._pool.stale_dropped == 1


def create_on_a_dying_connection(Client, err):
    server = ScriptedServer(["ok", "drop", "ok"])
    try:
        client = Client(f"http://127.0.0.1:{server.port}", qps=0, retries=3)
        client.get(NOTEBOOK, "x", "ns")
        with pytest.raises(err.TransportError):
            client.create(dict(NS_OBJ))
        time.sleep(0.1)
        after_create = [r[1] for r in server.requests]
        # An idempotent verb on the same failure is retried.
        server.actions = ["drop", "ok"]
        client.get(NOTEBOOK, "x", "ns")
        return after_create, [r[1] for r in server.requests]
    finally:
        server.close()


def test_a_create_whose_connection_dies_is_never_resent():
    from kubeflow_tpu.platform.k8s import errors as ref_errors

    got = create_on_a_dying_connection(RestKubeClient, errors)
    assert got == create_on_a_dying_connection(RefClient, ref_errors)
    assert got == (["GET", "POST"], ["GET", "POST", "GET", "GET"])


def test_connection_refused_is_a_transport_error():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    url = f"http://127.0.0.1:{port}"
    before = metrics.rest_client_requests_total.sample(
        verb="get", kind="Notebook", code="<error>") or 0
    ref_before = ref_metrics.registry.get_sample_value(
        "rest_client_requests_total",
        {"verb": "get", "kind": "Notebook", "code": "<error>"}) or 0
    got = _ended(lambda: RestKubeClient(url, qps=0, retries=0).get(
        NOTEBOOK, "x", "ns"))
    assert got == _ended(lambda: RefClient(url, qps=0, retries=0).get(
        REF_NOTEBOOK, "x", "ns"))
    assert got[:3] == ("raised", "TransportError", 503)
    assert (metrics.rest_client_requests_total.sample(
        verb="get", kind="Notebook", code="<error>") or 0) - before == 1
    assert ref_metrics.registry.get_sample_value(
        "rest_client_requests_total",
        {"verb": "get", "kind": "Notebook", "code": "<error>"}) \
        - ref_before == 1


# -- config resolution --------------------------------------------------------


def test_json_kubeconfig_resolves(tmp_path, monkeypatch):
    path = tmp_path / "config"
    path.write_text(json.dumps({
        "apiVersion": "v1", "kind": "Config", "current-context": "c",
        "contexts": [{"name": "c", "context": {"cluster": "k", "user": "u"}}],
        "clusters": [{"name": "k", "cluster": {
            "server": "http://127.0.0.1:6443"}}],
        "users": [{"name": "u", "user": {"token": "secret"}}]}))
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
    monkeypatch.setenv("KUBECONFIG", str(path))
    client, ref = RestKubeClient(), RefClient()
    assert client.base_url == ref.base_url == "http://127.0.0.1:6443"
    assert client._headers["Authorization"] == \
        ref._session.headers["Authorization"] == "Bearer secret"


def test_yaml_kubeconfig_is_refused_with_a_clear_message(tmp_path,
                                                         monkeypatch):
    """The port's own limit (the reference parses YAML, the port reads the
    JSON that ``kubectl config view --raw -o json`` writes)."""
    path = tmp_path / "config"
    path.write_text("apiVersion: v1\nkind: Config\ncurrent-context: c\n")
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
    monkeypatch.setenv("KUBECONFIG", str(path))
    with pytest.raises(RuntimeError, match="not JSON.*-o json"):
        RestKubeClient()


def test_missing_kubeconfig_names_the_path(tmp_path, monkeypatch):
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
    monkeypatch.setenv("KUBECONFIG", str(tmp_path / "absent"))
    for Client in (RestKubeClient, RefClient):
        with pytest.raises(RuntimeError, match="absent"):
            Client()
