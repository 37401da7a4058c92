"""The port's incident flight recorder (``kubeflow_tpu_torch/telemetry/
incidents.py``) against the JAX package's, mirroring ``tests/ctrlplane/
test_incidents.py``: the same burn (bucket samples, planted journeys, a
profiler window, queue and goodput snapshots) goes through each
package's ``RuleEngine`` and ``IncidentRecorder``, and the bundles'
sections and contents, the manifests, the debounce and the ring, the
counter and the announce Event must be equal.  Stripped before the
comparison: span ids (random), the profiler's folded stacks and self
seconds (each package's own frames), the knob tables (each package's own
registry, held apart below) and the Events' ``uid``,
``creationTimestamp`` and ``resourceVersion``."""
import importlib
import json
import urllib.error
import urllib.request
from types import SimpleNamespace

import pytest

TTFT_BUCKET = "serve_time_to_first_token_seconds_bucket"
RANDOM = ("uid", "creationTimestamp", "resourceVersion", "span_id",
          "folded", "selfSeconds", "knobs")


def package(root):
    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    return SimpleNamespace(
        root=root, torch=root.endswith("_torch"),
        slo=mod("telemetry.slo"), incidents=mod("telemetry.incidents"),
        causal=mod("telemetry.causal"), profiler=mod("telemetry.profiler"),
        goodput=mod("telemetry.goodput"),
        jobqueue=mod("platform.runtime.jobqueue"),
        metrics=mod("platform.runtime.metrics"),
        TSDB=mod("telemetry.tsdb").TSDB, types=mod("platform.k8s.types"),
        FakeKube=mod("platform.testing.fake").FakeKube,
        main=mod("platform.main"))


REF = package("kubeflow_tpu")
PORT = package("kubeflow_tpu_torch")


def captured(P, alert):
    if P.torch:
        return P.metrics.kft_incidents_captured_total.sample(alert=alert)
    return P.metrics.registry.get_sample_value(
        "kft_incidents_captured_total", {"alert": alert})


def strip(x):
    if isinstance(x, dict):
        return {k: strip(v) for k, v in x.items() if k not in RANDOM}
    if isinstance(x, list):
        return [strip(v) for v in x]
    return x


def both(script):
    ref = strip(json.loads(json.dumps(script(REF), default=str)))
    got = strip(json.loads(json.dumps(script(PORT), default=str)))
    return ref, got


def rule(P, **kw):
    base = dict(name="ttft", metric=TTFT_BUCKET, threshold=1.0,
                objective=0.9, fast_window_s=300.0, slow_window_s=3600.0,
                fast_burn=2.0, slow_burn=1.0)
    base.update(kw)
    return P.slo.BurnRateRule(**base)


def burning_db(P):
    db = P.TSDB()
    for rep in ("r0", "r1"):
        for at, good, total in ((5.0, 0, 0), (10.0, 0, 50)):
            db.append(TTFT_BUCKET, {"replica": rep, "le": "1.0"}, good,
                      ts=at)
            db.append(TTFT_BUCKET, {"replica": rep, "le": "+Inf"}, total,
                      ts=at)
    return db


@pytest.fixture(autouse=True)
def _clean_registries():
    for P in (REF, PORT):
        P.causal.STORE.clear()
        P.jobqueue.register_debug_queue(None)
        P.goodput.register_debug_goodput(None)
    yield
    for P in (REF, PORT):
        P.causal.STORE.clear()
        P.profiler.register_debug_profiler(None)
        P.goodput.register_debug_goodput(None)
        P.incidents.register_debug_incidents(None)


def test_firing_transition_captures_the_reference_s_bundle():
    def script(P):
        kube = P.FakeKube()
        kube.add_namespace("kubeflow")
        db = burning_db(P)
        for tid, at, dur in (("a" * 32, 9.0, 2.0), ("b" * 32, 9.5, 5.0),
                             ("c" * 32, -4000.0, 9.0)):
            P.causal.STORE.record("reconcile", trace_id=tid,
                                  segment="reconcile",
                                  start_ts=at - dur, end_ts=at)
        prof = P.profiler.Profiler(now=lambda: 10.0)
        prof.sample_once()
        P.profiler.register_debug_profiler(prof)
        acct = P.goodput.GoodputAccountant(now=lambda: 0.0)
        acct.tick([], at=0.0)
        acct.tick([P.goodput.WorkloadUse("team", 8.0, productive=4.0)],
                  at=10.0)
        P.goodput.register_debug_goodput(acct)
        rec = P.incidents.IncidentRecorder(db, client=kube, now=lambda: 10.0,
                                           max_journeys=2)
        eng = P.slo.RuleEngine(
            db, [rule(P)],
            recording=[P.slo.RecordingRule(record="ttft:p99",
                                           metric=TTFT_BUCKET, q=0.5,
                                           window_s=100.0)],
            client=kube, incidents=rec, now=lambda: 10.0)
        before = captured(P, "ttft") or 0.0
        transitions = eng.evaluate()
        bundle = rec.get("ttft-10")
        out = {"transitions": transitions, "snapshot": rec.snapshot(),
               "bundle": bundle,
               "captured": captured(P, "ttft") - before,
               "event": kube.get(P.types.EVENT, "kft-incident-ttft",
                                 "kubeflow"),
               "knob_names": sorted(k for k in bundle["knobs"]
                                    if k.startswith("KFT_INCIDENT")),
               "profile_window_now": prof.current_window_id()}
        return out

    ref, got = both(script)
    # The goodput section's keys are GPU-seconds in the port.
    got_goodput = got["bundle"].pop("goodput")
    ref_goodput = ref["bundle"].pop("goodput")
    assert json.loads(json.dumps(got_goodput).replace(
        "GpuSeconds", "ChipSeconds")) == ref_goodput
    assert got == ref
    bundle = got["bundle"]
    assert bundle["manifest"]["id"] == "ttft-10"
    assert [j["trace_id"] for j in bundle["journeys"]] == ["b" * 32,
                                                          "a" * 32]
    assert bundle["tsdb"]["start"] == 10.0 - 3600.0
    assert len(bundle["tsdb"]["series"]) == 4
    assert bundle["recorded"][0]["metric"] == "ttft:p99"
    assert bundle["profile"]["window"] == got["profile_window_now"]
    assert got["captured"] == 1.0
    assert got["event"]["reason"] == "IncidentCaptured"
    assert {"KFT_INCIDENT_DEBOUNCE_SECONDS", "KFT_INCIDENT_RING",
            "KFT_INCIDENT_SAMPLES", "KFT_INCIDENT_SERIES"} <= set(
                got["knob_names"])
    assert got_goodput["profiles"]["team"]["goodputGpuSeconds"] == 40.0
    assert {"alert", "alerts", "goodput", "journeys", "profile",
            "recorded", "tsdb"} <= set(bundle["manifest"]["sections"])


def test_two_replicas_capture_one_event_and_equal_manifests():
    def script(P):
        kube = P.FakeKube()
        kube.add_namespace("kubeflow")
        db = burning_db(P)
        P.causal.STORE.record("reconcile", trace_id="d" * 32,
                              segment="reconcile", start_ts=8.0, end_ts=9.0)
        recorders = [P.incidents.IncidentRecorder(db, client=kube,
                                                  now=lambda: 10.0)
                     for _ in range(2)]
        engines = [P.slo.RuleEngine(db, [rule(P, name="dup")], client=kube,
                                    incidents=r, now=lambda: 10.0)
                   for r in recorders]
        for eng in engines:
            eng.evaluate()
        events = sorted(
            (e for e in kube.list(P.types.EVENT, "kubeflow")),
            key=lambda e: e["metadata"]["name"])
        return [r.snapshot() for r in recorders], events

    ref, got = both(script)
    assert got == ref
    assert got[0][0] == got[0][1]
    assert [e["metadata"]["name"] for e in got[1]] == [
        "kft-alert-dup", "kft-incident-dup"]


@pytest.mark.parametrize("ring,debounce", [(2, 100.0), (1, 0.0),
                                           (4, 250.0)])
def test_debounce_and_ring_equal_the_reference(ring, debounce):
    def script(P):
        rec = P.incidents.IncidentRecorder(burning_db(P), client=None,
                                           now=lambda: 10.0, ring=ring,
                                           debounce_s=debounce)
        st = P.slo.AlertState(state="firing", fast_burn=5.0, slow_burn=5.0)
        r, other = rule(P), rule(P, name="ttft-other")
        out = [rec.capture(r, st, at=10.0) is not None,
               rec.capture(r, st, at=50.0) is not None,
               rec.capture(other, st, at=50.0) is not None,
               rec.capture(r, st, at=200.0) is not None,
               rec.capture(r, st, at=400.0) is not None]
        return out, rec.snapshot(), rec.get("ttft-10") is None

    ref, got = both(script)
    assert got == ref
    if (ring, debounce) == (2, 100.0):
        assert got[0] == [True, False, True, True, True]
        assert [m["id"] for m in got[1]["incidents"]] == ["ttft-400",
                                                         "ttft-200"]


def test_capture_failure_and_extra_sections():
    class Boom:
        def capture(self, *a, **kw):
            raise RuntimeError("recorder exploded")

    def script(P):
        kube = P.FakeKube()
        kube.add_namespace("kubeflow")
        db = burning_db(P)
        eng = P.slo.RuleEngine(db, [rule(P, name="boom")], client=kube,
                               incidents=Boom(), now=lambda: 10.0)
        out = [eng.evaluate(), eng.states["boom"].state]
        rec = P.incidents.IncidentRecorder(db, now=lambda: 10.0)
        rec.add_section("shards", lambda: {"identity": "r0", "owned": [0]})
        rec.add_section("broken", lambda: 1 / 0)
        bundle = rec.capture(rule(P), P.slo.AlertState(state="firing"),
                             at=10.0)
        out += [bundle["shards"], bundle["broken"],
                bundle["manifest"]["sections"]]
        return out

    ref, got = both(script)
    assert got == ref
    assert got[1] == "firing" and got[3] is None
    assert "shards" in got[4] and "broken" not in got[4]


def test_debug_incidents_endpoints_equal_the_reference():
    class _Mgr:
        def healthy(self):
            return True

    def get(base, path):
        try:
            with urllib.request.urlopen(base + path, timeout=10) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, None

    def script(P):
        server = P.main._serve_health(_Mgr(), 0, host="127.0.0.1")
        base = f"http://127.0.0.1:{server.server_port}"
        try:
            out = [get(base, "/debug/incidents"),
                   get(base, "/debug/incidents/ttft-10")]
            rec = P.incidents.IncidentRecorder(burning_db(P),
                                               now=lambda: 10.0)
            rec.capture(rule(P), P.slo.AlertState(state="firing"), at=10.0)
            P.incidents.register_debug_incidents(rec)
            out += [get(base, "/debug/incidents"),
                    get(base, "/debug/incidents/ttft-10"),
                    get(base, "/debug/incidents/no-such-id")]
            out.append(P.incidents.debug_get("ttft-10")["id"])
        finally:
            server.shutdown()
        return out

    ref, got = both(script)
    assert got == ref
    assert [o[0] for o in got[:5]] == [404, 404, 200, 200, 404]


def test_pipeline_wires_a_recorder_by_default():
    from kubeflow_tpu_torch.telemetry import fleetscrape as fs
    from kubeflow_tpu_torch.telemetry.tsdb import TSDB

    pipe = fs.MetricsPipeline(tsdb=TSDB(), now=lambda: 100.0, interval=999.0)
    assert isinstance(pipe.incidents, PORT.incidents.IncidentRecorder)
    assert pipe.engine.incidents is pipe.incidents
    off = fs.MetricsPipeline(tsdb=TSDB(), now=lambda: 100.0, interval=999.0,
                             incidents=False)
    assert off.incidents is None and off.engine.incidents is None
