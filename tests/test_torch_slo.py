"""The port's burn-rate SLO rules (``kubeflow_tpu_torch/telemetry/
slo.py``) against the JAX package's, mirroring ``tests/ctrlplane/
test_slo.py``: the same bucket samples go into each package's TSDB, each
package's ``RuleEngine`` evaluates them, and the burn rates, the firing
and resolving transitions, the ``/debug/alerts`` snapshot, the recording
rules' series, the alert gauges and counters and the Events written to
each package's ``FakeKube`` must be equal.  The Events are compared with
``uid``, ``creationTimestamp`` and ``resourceVersion`` dropped.  The one
difference by design: the queue-wait rule reads the GPUJob queue's
``gpujob_queue_wait_seconds_bucket`` where the reference's reads
``tpujob_queue_wait_seconds_bucket``."""
import importlib
import json
from types import SimpleNamespace

import numpy as np
import pytest

TTFT_BUCKET = "serve_time_to_first_token_seconds_bucket"
RANDOM = ("uid", "creationTimestamp", "resourceVersion")


def package(root):
    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    torch = root.endswith("_torch")
    metrics = mod("platform.runtime.metrics")
    if torch:
        def sample(metric, **labels):
            return getattr(metrics, metric).sample(**labels)
    else:
        def sample(metric, **labels):
            return metrics.registry.get_sample_value(metric, labels)
    return SimpleNamespace(
        root=root, torch=torch, slo=mod("telemetry.slo"),
        TSDB=mod("telemetry.tsdb").TSDB, types=mod("platform.k8s.types"),
        FakeKube=mod("platform.testing.fake").FakeKube, sample=sample)


REF = package("kubeflow_tpu")
PORT = package("kubeflow_tpu_torch")


def strip(x):
    if isinstance(x, dict):
        return {k: strip(v) for k, v in x.items() if k not in RANDOM}
    if isinstance(x, list):
        return [strip(v) for v in x]
    return x


def both(script):
    ref = json.loads(json.dumps(script(REF), default=str))
    got = json.loads(json.dumps(script(PORT), default=str))
    return ref, got


def rule(P, **kw):
    base = dict(name="ttft", metric=TTFT_BUCKET, threshold=1.0,
                objective=0.9, fast_window_s=300.0, slow_window_s=3600.0,
                fast_burn=2.0, slow_burn=1.0)
    base.update(kw)
    return P.slo.BurnRateRule(**base)


def feed(db, *, at, good, total, labels=None):
    db.append(TTFT_BUCKET, {**(labels or {}), "le": "1.0"}, good, ts=at)
    db.append(TTFT_BUCKET, {**(labels or {}), "le": "+Inf"}, total, ts=at)


def events(P, kube, ns="kubeflow"):
    out = [strip(json.loads(json.dumps(e, default=P.types.json_default)))
           for e in kube.list(P.types.EVENT, ns)]
    return sorted(out, key=lambda e: e["metadata"]["name"])


def transitions(P, alert):
    return {s: P.sample("kft_alert_transitions_total", alert=alert, state=s)
            for s in ("firing", "resolved")}


def test_first_scrape_of_a_long_lived_counter_is_not_an_increase():
    def script(P):
        db = P.TSDB()
        feed(db, at=100.0, good=80_000, total=100_000)
        eng = P.slo.RuleEngine(db, [rule(P, name="first")],
                               now=lambda: 100.0)
        return eng.evaluate(), eng.snapshot()

    ref, got = both(script)
    assert got == ref and got[0] == []


def test_burn_rate_math_and_two_window_gate():
    def script(P):
        db = P.TSDB()
        r = rule(P, name="gate")
        feed(db, at=90.0, good=0, total=0)
        feed(db, at=100.0, good=5, total=10)
        rates = r.burn_rates(db, at=100.0)
        eng = P.slo.RuleEngine(db, [r], now=lambda: 100.0)
        out = eng.evaluate()
        return (rates, out, eng.snapshot(),
                P.sample("kft_alerts_firing", alert="gate"),
                transitions(P, "gate"))

    ref, got = both(script)
    assert got == ref
    assert got[0][0] == pytest.approx(5.0) and got[0][2] == 10
    assert [t["state"] for t in got[1]] == ["firing"]
    assert got[3] == 1.0 and got[4]["firing"] == 1.0


def test_fast_window_alone_does_not_fire():
    def script(P):
        db = P.TSDB()
        r = rule(P, name="fastonly", fast_window_s=10.0,
                 slow_window_s=1000.0, fast_burn=2.0, slow_burn=2.0)
        feed(db, at=100.0, good=0, total=100)
        feed(db, at=995.0, good=100, total=200)
        feed(db, at=1000.0, good=200, total=300)
        eng = P.slo.RuleEngine(db, [r], now=lambda: 1000.0)
        return eng.evaluate(), eng.snapshot()

    ref, got = both(script)
    assert got == ref and got[0] == []


def test_no_events_is_no_signal_not_recovery():
    def script(P):
        db = P.TSDB()
        feed(db, at=99.0, good=0, total=0)
        feed(db, at=100.0, good=0, total=10)
        eng = P.slo.RuleEngine(db, [rule(P, name="silence")],
                               now=lambda: 100.0)
        out = [eng.evaluate()]
        out.append(eng.evaluate(at=100.0 + 3600.0 * 3))
        out.append(eng.states["silence"].state)
        feed(db, at=100.0 + 3600.0 * 3, good=110, total=120)
        out.append(eng.evaluate(at=100.0 + 3600.0 * 3 + 1))
        out.append(eng.snapshot())
        return out

    ref, got = both(script)
    assert got == ref
    assert got[1] == [] and got[2] == "firing"
    assert [t["state"] for t in got[3]] == ["resolved"]


def test_recording_rule_materializes_quantile_series():
    def script(P):
        db = P.TSDB()
        feed(db, at=10.0, good=0, total=0)
        feed(db, at=50.0, good=9, total=10)
        rec = P.slo.RecordingRule(record="ttft:p99", metric=TTFT_BUCKET,
                                  q=0.5, window_s=100.0)
        eng = P.slo.RuleEngine(db, [], recording=[rec], now=lambda: 50.0)
        eng.evaluate()
        return db.instant("ttft:p99"), rec.evaluate(db, 50.0)

    ref, got = both(script)
    assert got == ref and got[0] and 0.0 < got[0][0][2] <= 1.0


def test_default_rules_are_the_reference_s_but_the_queue_metric():
    def script(P):
        return [dict(vars(r)) for r in P.slo.default_rules()]

    ref, got = both(script)
    assert [r["name"] for r in got] == ["serve-ttft-p99", "reconcile-p99",
                                        "watch-lag", "queue-wait"]
    queue = got[3]
    assert queue["metric"] == "gpujob_queue_wait_seconds_bucket"
    assert ref[3]["metric"] == "tpujob_queue_wait_seconds_bucket"
    assert queue["doc"] == ref[3]["doc"].replace("TPUJob", "GPUJob")
    for r in (got[3], ref[3]):
        r.pop("metric"), r.pop("doc")
    assert got == ref


def test_default_rules_read_their_knobs(monkeypatch):
    for name, value in [("KFT_SLO_QUEUE_WAIT_SECONDS", "1"),
                        ("KFT_SLO_FAST_WINDOW_SECONDS", "4"),
                        ("KFT_SLO_SLOW_WINDOW_SECONDS", "8"),
                        ("KFT_SLO_FAST_BURN", "2"),
                        ("KFT_SLO_SLOW_BURN", "1"),
                        ("KFT_SLO_OBJECTIVE", "0.5")]:
        monkeypatch.setenv(name, value)

    def script(P):
        rules = P.slo.default_rules()
        return [(r.threshold, r.fast_window_s, r.slow_window_s, r.fast_burn,
                 r.slow_burn, r.objective) for r in rules]

    ref, got = both(script)
    assert got == ref and got[3] == [1.0, 4.0, 8.0, 2.0, 1.0, 0.5]
    from kubeflow_tpu_torch.platform import config

    knobs = config.effective()
    assert knobs["KFT_SLO_QUEUE_WAIT_SECONDS"]["source"] == "env"
    assert knobs["KFT_SLO_FAST_BURN"]["doc"] == \
        "fast-window burn-rate page threshold"


def test_transition_emits_exactly_one_event_across_replicas():
    def script(P):
        kube = P.FakeKube()
        kube.add_namespace("kubeflow")
        db = P.TSDB()
        feed(db, at=5.0, good=0, total=0)
        feed(db, at=10.0, good=0, total=50)
        engines = [P.slo.RuleEngine(db, [rule(P, name="ev")], client=kube,
                                    now=lambda: 10.0) for _ in range(2)]
        out = [[eng.evaluate() for eng in engines], events(P, kube)]
        feed(db, at=11.0, good=550, total=600)
        out.append([eng.evaluate(at=11.0) for eng in engines])
        out.append(events(P, kube))
        return out

    ref, got = both(script)
    assert got == ref
    (fired,) = got[1]
    assert fired["metadata"]["name"] == "kft-alert-ev"
    assert fired["reason"] == "AlertFiring"
    assert fired["metadata"]["annotations"]["kubeflow.org/generated-hash"]
    (resolved,) = got[3]
    assert resolved["reason"] == "AlertResolved"


@pytest.mark.parametrize("seed", range(8))
def test_drawn_traffic_gives_the_reference_s_transcript(seed):
    """Two labelled replicas' cumulative buckets grow by draws from a
    seed, bad stretches included; each step's transitions and the
    snapshot after it are compared."""
    rng = np.random.default_rng(seed)
    steps = []
    good = {"a": 0.0, "b": 0.0}
    total = {"a": 0.0, "b": 0.0}
    bad = False
    for i in range(40):
        if rng.random() < 0.15:
            bad = not bad
        for rep in ("a", "b"):
            n = float(rng.integers(0, 20))
            frac = rng.uniform(0.0, 0.5) if bad else rng.uniform(0.95, 1.0)
            total[rep] += n
            good[rep] += float(np.floor(n * frac))
            steps.append((10.0 * i + rng.uniform(0, 1), rep, good[rep],
                          total[rep]))
    alert = f"drawn{seed}"

    def script(P):
        kube = P.FakeKube()
        kube.add_namespace("kubeflow")
        db = P.TSDB()
        eng = P.slo.RuleEngine(
            db, [rule(P, name=alert, fast_window_s=30.0,
                      slow_window_s=120.0, fast_burn=3.0, slow_burn=1.5,
                      matcher=(("service", "s"),))],
            client=kube, now=lambda: 0.0)
        out = []
        for at, rep, g, t in steps:
            feed(db, at=at, good=g, total=t,
                 labels={"service": "s", "replica": rep})
            out.append([eng.evaluate(at=at + 0.5), eng.snapshot()])
        out.append(events(P, kube))
        out.append(transitions(P, alert))
        return out

    ref, got = both(script)
    assert got == ref
    assert got[-1]["firing"] >= 1
