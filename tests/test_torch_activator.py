"""The port's serving front door (``kubeflow_tpu_torch/platform/
activator.py``) against the reference's (``kubeflow_tpu/platform/
activator.py``): the reference's app is driven through werkzeug's test
client, the port's ``App`` over a socket, on the same seeded request
sequences.  They agree, status, ``Retry-After``, body and the calls
forwarded, on

* the warm proxy (QoS headers, the remaining deadline, 503 retries, the
  replay budget, a backend's own 504 passed through);
* tenant-bucket 429s and the SLO knee's ``slo-shed``;
* hold and replay, the wake stamp and its re-stamps;
* hold-overflow 503, wake-timeout 503 and the held deadline's 504;
* the fair-share drain order over seeded tenants and weights;
* each knob's default and its refusal of a bad value.

Every wait is bounded."""
import http.client
import json
import random
import threading
import time
import types

import pytest
from werkzeug.test import Client

from kubeflow_tpu.platform import activator as ref_act
from kubeflow_tpu.platform.runtime import metrics as ref_metrics
from kubeflow_tpu.telemetry import fleetscrape as ref_fleetscrape
from kubeflow_tpu_torch.platform import activator as act
from kubeflow_tpu_torch.platform.apis import inferenceservice as api
from kubeflow_tpu_torch.platform.k8s.types import INFERENCESERVICE
from kubeflow_tpu_torch.platform.runtime import metrics
from kubeflow_tpu_torch.telemetry import fleetscrape

WAIT_S = 10.0


class FakeClient:
    """Captures the wake-annotation patches an activator writes."""

    def __init__(self):
        self.patches = []

    def patch(self, gvk, name, patch, namespace=None, *,
              patch_type="merge"):
        self.patches.append((gvk.kind, name, namespace, patch, patch_type))


def recording_forward(calls, script=None):
    """A backend that answers 200 (or ``script``'s statuses in turn) and
    records each call."""
    def forward(url, method, body, headers, timeout):
        calls.append({"url": url, "method": method, "body": body,
                      "headers": dict(headers)})
        status = 200 if not script else script[min(len(calls) - 1,
                                                   len(script) - 1)]
        if status == "down":
            raise OSError("connection refused")
        return status, {"Content-Type": "application/json"}, json.dumps(
            {"success": status == 200, "tokens": [[1, 2]],
             "call": len(calls)}).encode()
    return forward


class Front:
    """One package's activator and the way a request reaches it."""

    def __init__(self, port, *, script=None, **kw):
        self.port = port
        self.mod = act if port else ref_act
        self.book = self.mod.EndpointBook()
        self.client = FakeClient()
        self.calls = []
        self.act = self.mod.Activator(
            self.client, book=self.book,
            forward=recording_forward(self.calls, script), **kw)
        app = self.mod.create_activator_app(self.act)
        if port:
            self.server = app.make_server("127.0.0.1", 0)
            threading.Thread(target=self.server.serve_forever,
                             kwargs={"poll_interval": 0.05},
                             daemon=True).start()
        else:
            self.server, self.wsgi = None, Client(app)

    def close(self):
        if self.server is not None:
            self.server.shutdown()
            self.server.server_close()

    def request(self, path="/serve/ns/svc/v1/generate", *, method="POST",
                headers=None, body=None):
        """(status, Retry-After or None, JSON body)."""
        data = json.dumps(body or {"tokens": [[1]]}).encode()
        headers = {"Content-Type": "application/json", **(headers or {})}
        if not self.port:
            r = (self.wsgi.post(path, data=data, headers=headers)
                 if method == "POST" else self.wsgi.get(path,
                                                         headers=headers))
            return r.status_code, r.headers.get("Retry-After"), r.get_json()
        conn = http.client.HTTPConnection(
            "127.0.0.1", self.server.server_address[1], timeout=WAIT_S * 3)
        try:
            conn.request(method, path, body=data if method == "POST" else None,
                         headers=headers)
            r = conn.getresponse()
            return r.status, r.getheader("Retry-After"), json.loads(r.read())
        finally:
            conn.close()

    def held(self, key="ns/svc"):
        with self.act._fronts_lock:
            front = self.act._fronts.get(key)
        if front is None:
            return 0
        with front.lock:
            return front.held_count()

    def shed(self, tenant, reason):
        if self.port:
            return metrics.serve_requests_shed_total.sample(
                tenant=tenant, reason=reason) or 0.0
        return ref_metrics.registry.get_sample_value(
            "serve_requests_shed_total",
            {"tenant": tenant, "reason": reason}) or 0.0


@pytest.fixture
def fronts():
    made = []

    def make(**kw):
        pair = [Front(False, **kw), Front(True, **kw)]
        made.extend(pair)
        return pair

    yield make
    for f in made:
        f.close()


def wait_for(fn, what):
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline:
        if fn():
            return
        time.sleep(0.01)
    raise AssertionError(f"no {what} within {WAIT_S} s")


def forwarded(calls):
    """The calls as compared: the deadline header as present or not (its
    value is the clock's)."""
    out = []
    for c in calls:
        h = dict(c["headers"])
        if "X-KFT-Deadline-Seconds" in h:
            h["X-KFT-Deadline-Seconds"] = 0.0 < float(
                h["X-KFT-Deadline-Seconds"]) <= 30.0
        out.append((c["url"], c["method"], c["body"], h))
    return out


def background(front, out, key, **kw):
    t = threading.Thread(target=lambda: out.__setitem__(
        key, front.request(**kw)), daemon=True)
    t.start()
    return t


# -- knobs --------------------------------------------------------------------

KNOBS = [
    ("hold_queue_limit", "KFT_ACTIVATOR_HOLD_QUEUE", ["0", "x"]),
    ("wake_deadline_seconds", "KFT_ACTIVATOR_WAKE_DEADLINE_SECONDS",
     ["0", "-1", "soon"]),
    ("restamp_seconds", "KFT_ACTIVATOR_RESTAMP_SECONDS", ["0", "x"]),
    ("replay_retries", "KFT_ACTIVATOR_REPLAY_RETRIES", ["-1", "1.5"]),
    ("replay_base_seconds", "KFT_ACTIVATOR_REPLAY_BASE_SECONDS", ["0"]),
    ("replay_cap_seconds", "KFT_ACTIVATOR_REPLAY_CAP_SECONDS", ["-2"]),
    ("tenant_rate", "KFT_ACTIVATOR_TENANT_RATE", ["0", "fast"]),
    ("tenant_burst", "KFT_ACTIVATOR_TENANT_BURST", ["0.5", "x"]),
    ("tenant_weights", "KFT_ACTIVATOR_TENANT_WEIGHTS", ["a=0", "a=x"]),
    ("shed_ttft_multiple", "KFT_ACTIVATOR_SHED_TTFT_MULTIPLE", ["0.9"]),
    ("shed_cost", "KFT_ACTIVATOR_SHED_COST", ["0", "x"]),
    ("activator_port", "KFT_ACTIVATOR_PORT", ["-1", "http"]),
]


@pytest.mark.parametrize("fn,name,bad", KNOBS, ids=[k[1] for k in KNOBS])
def test_knob_defaults_and_bad_values_raise_as_the_reference(
        monkeypatch, fn, name, bad):
    monkeypatch.delenv(name, raising=False)
    assert getattr(act, fn)() == getattr(ref_act, fn)()
    for raw in bad:
        monkeypatch.setenv(name, raw)
        for mod in (ref_act, act):
            with pytest.raises(ValueError):
                getattr(mod, fn)()
    monkeypatch.setenv(name, "3" if name != "KFT_ACTIVATOR_TENANT_WEIGHTS"
                       else "alice=2, bob=1")
    assert getattr(act, fn)() == getattr(ref_act, fn)()


# -- QoS primitives -----------------------------------------------------------


def test_token_bucket_matches_the_reference_on_a_seeded_clock():
    rng = random.Random(7)
    clock = [0.0]
    pair = [mod.TokenBucket(rate=2.0, burst=4.0, now=lambda: clock[0])
            for mod in (ref_act, act)]
    for _ in range(300):
        clock[0] += rng.choice((0.0, 0.0, 0.1, 0.37, 2.0))
        cost = rng.choice((1.0, 1.0, 4.0))
        a, b = (bucket.take(cost) for bucket in pair)
        assert a == b


@pytest.mark.parametrize("seed", range(6))
def test_fair_share_drain_order_equals_the_reference(seed):
    """Smooth weighted round-robin over seeded tenants, weights and
    arrivals interleaved with drains: the same waiter leaves at every
    step."""
    rng = random.Random(seed)
    tenants = [f"t{i}" for i in range(rng.randint(2, 5))]
    weights = {t: float(rng.randint(1, 4)) for t in tenants
               if rng.random() < 0.7}
    fronts = [mod._ServiceFront(dict(weights)) for mod in (ref_act, act)]
    tags = [{}, {}]
    orders = [[], []]
    for step in range(60):
        if rng.random() < 0.6:
            tenant = rng.choice(tenants)
            for i, (mod, front) in enumerate(zip((ref_act, act), fronts)):
                w = mod._Waiter(tenant)
                tags[i][id(w)] = (tenant, step)
                with front.lock:
                    front.enqueue(w)
        else:
            for i, front in enumerate(fronts):
                with front.lock:
                    w = front.next_waiter()
                    if w is not None:
                        front.advance(w)
                orders[i].append(None if w is None else tags[i][id(w)])
    assert orders[0] == orders[1]
    assert any(o is not None for o in orders[0])


def test_endpoint_book_publish_forget_subscribe():
    books = [mod.EndpointBook() for mod in (ref_act, act)]
    seen = [[], []]
    for book, s in zip(books, seen):
        book.subscribe(s.append)
        book.publish("ns/a", endpoints=["http://x:1", None],
                     ttft_target_s=0.5, phase="Ready")
        book.publish("ns/b", endpoints=[], phase="Idle")
    assert books[0].snapshot() == books[1].snapshot()
    for book in books:
        book.forget("ns/a")
    assert books[0].snapshot() == books[1].snapshot()
    assert seen[0] == seen[1] == ["ns/a", "ns/b", "ns/a"]


# -- the warm path ------------------------------------------------------------


def test_warm_proxy_forwards_the_same_calls(fronts):
    pair = fronts()
    out = []
    for f in pair:
        f.book.publish("ns/svc", endpoints=["http://b:1", "http://b:2"])
        got = [f.request(headers={
            "X-KFT-Tenant": "alice", "X-KFT-Priority": "interactive",
            "X-KFT-Deadline-Seconds": "30",
            "traceparent": "00-" + "a" * 32 + "-" + "b" * 16 + "-01"})]
        got.append(f.request(path="/serve/ns/svc/v1/generate",
                             body={"tokens": [[5, 6]]}))
        got.append(f.request(path="/serve/ns/svc/", method="GET"))
        got.append(f.request(path="/serve/ns/svc/readyz", method="GET"))
        out.append((got, forwarded(f.calls)))
    assert out[0] == out[1]
    assert [c[0] for c in out[1][1]] == [
        "http://b:2/v1/generate", "http://b:1/v1/generate", "http://b:2/",
        "http://b:1/readyz"]


def test_malformed_deadline_400_and_unknown_service_404(fronts):
    out = []
    for f in fronts():
        f.book.publish("ns/svc", endpoints=["http://b:1"])
        out.append([f.request(headers={"X-KFT-Deadline-Seconds": "soon"}),
                    f.request(path="/serve/ns/nope/v1/generate")])
    assert out[0] == out[1]
    assert [s for s, _, _ in out[1]] == [400, 404]


@pytest.mark.parametrize("script,retries", [
    ([503, 503, 200], "6"), (["down", "down", "down"], "2"),
    ([504], "6"), ([400], "6"), (["down", 200], "6")])
def test_replay_retries_and_passthrough_equal(monkeypatch, fronts, script,
                                              retries):
    monkeypatch.setenv("KFT_ACTIVATOR_REPLAY_RETRIES", retries)
    monkeypatch.setenv("KFT_ACTIVATOR_REPLAY_BASE_SECONDS", "0.001")
    monkeypatch.setenv("KFT_ACTIVATOR_REPLAY_CAP_SECONDS", "0.002")
    out = []
    for f in fronts(script=script):
        f.book.publish("ns/svc", endpoints=["http://b:1"])
        out.append((f.request(), len(f.calls)))
    assert out[0] == out[1]


@pytest.mark.parametrize("seed", range(3))
def test_tenant_bucket_429_sequences_equal(monkeypatch, fronts, seed):
    """A seeded sequence of tenants against a burst of 3 and a refill
    too slow to matter: the same answers, the same Retry-After and the
    same shed counts."""
    monkeypatch.setenv("KFT_ACTIVATOR_TENANT_BURST", "3")
    monkeypatch.setenv("KFT_ACTIVATOR_TENANT_RATE", "0.001")
    rng = random.Random(seed)
    seq = [rng.choice(("heavy", "heavy", "quiet", f"s{seed}"))
           for _ in range(14)]
    out = []
    for f in fronts():
        f.book.publish("ns/svc", endpoints=["http://b:1"])
        before = {t: f.shed(t, "tenant-bucket") for t in set(seq)}
        got = [f.request(headers={"X-KFT-Tenant": t}) for t in seq]
        out.append((got, {t: f.shed(t, "tenant-bucket") - before[t]
                          for t in set(seq)}, len(f.calls)))
    assert out[0] == out[1]
    assert any(s == 429 for s, _, _ in out[1][0])


def test_slo_knee_sheds_as_the_reference(monkeypatch, fronts):
    monkeypatch.setenv("KFT_ACTIVATOR_TENANT_BURST", "3")
    monkeypatch.setenv("KFT_ACTIVATOR_SHED_COST", "4")
    ttft = {"p99": 10.0}
    for mod in (ref_fleetscrape, fleetscrape):
        monkeypatch.setattr(
            mod, "serve_sample",
            lambda tsdb, key: types.SimpleNamespace(ttft_p99_s=ttft["p99"]))
    pair = fronts(tsdb=object())
    out = []
    for f in pair:
        f.book.publish("ns/svc", endpoints=["http://b:1"],
                       ttft_target_s=0.5)
        before = f.shed("hammer", "slo-shed")
        got = [f.request(headers={"X-KFT-Tenant": "hammer"})]
        out.append([got, f.shed("hammer", "slo-shed") - before])
    ttft["p99"] = 0.1
    for f, o in zip(pair, out):
        f.act._knee_cache.clear()
        o.append(f.request(headers={"X-KFT-Tenant": "calm"}))
    assert out[0] == out[1]
    assert out[1][0][0][0] == 429 and out[1][1] == 1
    assert out[1][2][0] == 200


# -- the cold path ------------------------------------------------------------


def test_hold_stamps_wake_and_replays_the_same(monkeypatch, fronts):
    monkeypatch.setenv("KFT_ACTIVATOR_RESTAMP_SECONDS", "0.05")
    out = []
    for f in fronts(now=lambda: 1234.5):
        f.book.publish("ns/svc", endpoints=[], phase="Idle")
        results = {}
        threads = [background(f, results, i,
                              headers={"X-KFT-Tenant": t},
                              body={"tokens": [[i]]})
                   for i, t in enumerate(("alice", "bob", "alice"))]
        wait_for(lambda: f.held() == 3, "3 held requests")
        wait_for(lambda: f.client.patches, "a wake stamp")
        first = f.client.patches[0]
        f.book.publish("ns/svc", endpoints=["http://b:1"], phase="Ready")
        for t in threads:
            t.join(WAIT_S)
            assert not t.is_alive()
        out.append(([results[i][:2] for i in range(3)], first,
                    sorted(c["body"] for c in f.calls), f.held()))
    assert out[0] == out[1]
    assert out[1][1] == ("InferenceService", "svc", "ns", {"metadata": {
        "annotations": {api.ANNOTATION_WAKE: "1234.500"}}}, "merge")
    assert INFERENCESERVICE.kind == out[1][1][0]
    assert [s for s, _ in out[1][0]] == [200, 200, 200]


def test_hold_restamps_while_held(monkeypatch, fronts):
    monkeypatch.setenv("KFT_ACTIVATOR_RESTAMP_SECONDS", "0.05")
    for f in fronts(now=lambda: time.monotonic()):
        f.book.publish("ns/svc", endpoints=[])
        results = {}
        t = background(f, results, 0)
        wait_for(lambda: len(f.client.patches) >= 3, "3 stamps")
        f.book.publish("ns/svc", endpoints=["http://b:1"])
        t.join(WAIT_S)
        assert results[0][0] == 200
        stamps = [float(p[3]["metadata"]["annotations"][api.ANNOTATION_WAKE])
                  for p in f.client.patches]
        assert stamps == sorted(stamps) and stamps[-1] > stamps[0]


def test_hold_overflow_503_equal(monkeypatch, fronts):
    monkeypatch.setenv("KFT_ACTIVATOR_HOLD_QUEUE", "2")
    monkeypatch.setenv("KFT_ACTIVATOR_RESTAMP_SECONDS", "0.05")
    out = []
    for f in fronts():
        f.book.publish("ns/svc", endpoints=[])
        results = {}
        threads = [background(f, results, i) for i in range(2)]
        wait_for(lambda: f.held() == 2, "2 held requests")
        before = f.shed("late", "hold-overflow")
        late = f.request(headers={"X-KFT-Tenant": "late"})
        shed = f.shed("late", "hold-overflow") - before
        f.book.publish("ns/svc", endpoints=["http://b:1"])
        for t in threads:
            t.join(WAIT_S)
        out.append((late, shed, [results[i][0] for i in range(2)]))
    assert out[0] == out[1]
    assert out[1][0][:2] == (503, "30") and out[1][1] == 1


def test_wake_timeout_503_equal(monkeypatch, fronts):
    monkeypatch.setenv("KFT_ACTIVATOR_WAKE_DEADLINE_SECONDS", "0.2")
    monkeypatch.setenv("KFT_ACTIVATOR_RESTAMP_SECONDS", "0.05")
    out = []
    for f in fronts():
        f.book.publish("ns/svc", endpoints=[])
        before = f.shed("default", "wake-timeout")
        out.append((f.request(), f.shed("default", "wake-timeout") - before,
                    f.held()))
    assert out[0] == out[1]
    assert out[1][0][:2] == (503, "1") and out[1][1:] == (1, 0)


def test_held_deadline_504_never_replayed_equal(monkeypatch, fronts):
    monkeypatch.setenv("KFT_ACTIVATOR_RESTAMP_SECONDS", "0.05")
    out = []
    for f in fronts():
        f.book.publish("ns/svc", endpoints=[])
        before = f.shed("giveup", "deadline")
        got = f.request(headers={"X-KFT-Tenant": "giveup",
                                 "X-KFT-Deadline-Seconds": "0.15"})
        f.book.publish("ns/svc", endpoints=["http://b:1"])
        time.sleep(0.05)
        out.append((got, f.shed("giveup", "deadline") - before, f.held(),
                    f.calls))
    assert out[0] == out[1]
    assert out[1][0][:2] == (504, None) and out[1][1:] == (1, 0, [])


def test_debug_snapshot_and_health_equal(fronts):
    out = []
    for f in fronts():
        f.book.publish("ns/svc", endpoints=["http://b:1"],
                       ttft_target_s=0.5, phase="Ready")
        out.append((f.request(path="/debug/activator", method="GET"),
                    f.request(path="/healthz", method="GET")))
        f.mod.register_debug(f.act)
        try:
            assert f.mod.debug_snapshot() == f.act.debug_snapshot()
        finally:
            f.mod.register_debug(None)
        assert f.mod.debug_snapshot() is None
    assert out[0] == out[1]
