"""The slice as a whole: the port's fleet metrics pipeline
(``kubeflow_tpu_torch/telemetry/fleetscrape.MetricsPipeline``) against
the JAX package's on one fake-clock story.  Over each package's
``FakeKube``, job ``train`` waits Queued behind job ``hold`` on a
one-device quota, is admitted when ``hold`` finishes, runs, and is done;
the controllers' self-scrape page carries the queue's wait histogram
(``gpujob_queue_wait_seconds`` in the port, ``tpujob_`` in the
reference), and the causal store holds ``train``'s journey as the job
controller records it.  Every ``step(at=)`` is compared: the scrape's
counts, the alert transitions and ``/debug/alerts``, the goodput ledger
(the port's ``*GpuSeconds`` as the reference's ``*ChipSeconds``), the
incident bundle captured at the firing transition, the Events, and the
critical path of ``train``'s journey.  The queue-wait rule runs with the
windows the card's ``platform_main`` phase uses (``KFT_SLO_*`` knobs).
Also ``peer_targets`` and the pipeline's own thread over the port's
informers."""
import importlib
import json
import time
from types import SimpleNamespace

import pytest

# The Events' content hash is over each package's own words (the
# queue-wait rule's doc names its job kind).
RANDOM = ("uid", "creationTimestamp", "resourceVersion", "span_id",
          "knobs", "kubeflow.org/generated-hash")
KNOBS = {"KFT_SLO_QUEUE_WAIT_SECONDS": "1", "KFT_SLO_FAST_WINDOW_SECONDS": "4",
         "KFT_SLO_SLOW_WINDOW_SECONDS": "8", "KFT_SLO_FAST_BURN": "2",
         "KFT_SLO_SLOW_BURN": "1"}
TRACE = "7" * 32
BOUNDS = (0.5, 1.0, 2.5, 5.0, 10.0, 30.0)


def package(root):
    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    torch = root.endswith("_torch")
    return SimpleNamespace(
        root=root, torch=torch, fs=mod("telemetry.fleetscrape"),
        causal=mod("telemetry.causal"), cp=mod("telemetry.critical_path"),
        goodput=mod("telemetry.goodput"), slo=mod("telemetry.slo"),
        incidents=mod("telemetry.incidents"),
        profiler=mod("telemetry.profiler"),
        jobqueue=mod("platform.runtime.jobqueue"),
        TSDB=mod("telemetry.tsdb").TSDB, types=mod("platform.k8s.types"),
        FakeKube=mod("platform.testing.fake").FakeKube,
        job_gvk=mod("platform.k8s.types").GPUJOB if torch
        else mod("platform.k8s.types").TPUJOB,
        wait_metric=("gpujob" if torch else "tpujob")
        + "_queue_wait_seconds")


REF = package("kubeflow_tpu")
PORT = package("kubeflow_tpu_torch")


def strip(x):
    if isinstance(x, dict):
        return {k: strip(v) for k, v in x.items() if k not in RANDOM}
    if isinstance(x, list):
        return [strip(v) for v in x]
    return x


def ref_words(x):
    """The port's result in the reference's words."""
    text = json.dumps(x)
    for port, ref in (("GpuSeconds", "ChipSeconds"),
                      ("gpujob_queue_wait", "tpujob_queue_wait"),
                      ("GPUJob", "TPUJob")):
        text = text.replace(port, ref)
    return json.loads(text)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name, value in KNOBS.items():
        monkeypatch.setenv(name, value)
    for P in (REF, PORT):
        P.causal.STORE.clear()
        P.jobqueue.register_debug_queue(None)
        P.goodput.register_debug_goodput(None)
        P.profiler.register_debug_profiler(None)
    yield
    for P in (REF, PORT):
        P.causal.STORE.clear()
        P.goodput.register_debug_goodput(None)


def job(P, name, phase, *, alloc=None, ready=None):
    status = {"phase": phase, "generation": 0, "restarts": 0}
    if alloc is not None:
        status["allocatedSlices"] = alloc
    if ready is not None:
        status["slices"] = [{"slice": 0, "ready": ready, "total": 1}]
    device = ({"gpu": {"accelerator": "h100-80gb", "gpus": 1}} if P.torch
              else {"tpu": {"accelerator": "v5e", "topology": "1x1"}})
    return {"apiVersion": "kubeflow.org/v1alpha1",
            "kind": P.job_gvk.kind,
            "metadata": {"name": name, "namespace": "team"},
            "spec": {**device, "template": {"spec": {"containers": [
                {"name": "w", "command": ["train"]}]}}},
            "status": status}


# The story: (at, hold's state, train's state, train's queue wait
# observed at that moment or None).
STORY = [
    (0.0, ("Running", 1, 1), ("Queued", None, None), None),
    (1.0, ("Running", 1, 1), ("Queued", None, None), None),
    (2.0, ("Running", 1, 1), ("Queued", None, None), None),
    (3.0, ("Running", 1, 1), ("Queued", None, None), None),
    (4.0, ("Running", 1, 1), ("Queued", None, None), None),
    (5.0, ("Running", 1, 1), ("Queued", None, None), None),
    (6.0, ("Succeeded", None, None), ("Pending", 1, 0), 6.0),
    (7.0, ("Succeeded", None, None), ("Running", 1, 1), None),
    (8.0, ("Succeeded", None, None), ("Running", 1, 1), None),
    (9.0, ("Succeeded", None, None), ("Running", 1, 1), None),
    (10.0, ("Succeeded", None, None), ("Running", 1, 0), None),
    (11.0, ("Succeeded", None, None), ("Running", 1, 1), None),
    (12.0, ("Succeeded", None, None), ("Succeeded", None, None), None),
    (13.0, ("Succeeded", None, None), ("Succeeded", None, None), None),
]
BASE = 1_000.0


def plant_journey(P):
    """``train``'s journey as the job controller records it: the
    reconcile that parks it, the admission wait, the granting reconcile
    and its gang writes, and the pods' start."""
    rec = P.causal.STORE.record
    t = BASE
    rec("watch_lag", trace_id=TRACE, segment="watch_lag",
        start_ts=t - 0.02, end_ts=t)
    rec("queue_wait", trace_id=TRACE, segment="queue_wait",
        start_ts=t, end_ts=t + 0.01)
    rec("reconcile", trace_id=TRACE, segment="reconcile",
        start_ts=t + 0.01, end_ts=t + 0.05)
    rec("admission_queue", trace_id=TRACE, segment="admission_queue",
        start_ts=t + 0.04, end_ts=t + 6.03)
    rec("reconcile", trace_id=TRACE, segment="reconcile",
        start_ts=t + 6.0, end_ts=t + 6.2)
    rec("k8s.create", trace_id=TRACE, segment="write_rtt", kind="Service",
        start_ts=t + 6.05, end_ts=t + 6.08)
    rec("k8s.create", trace_id=TRACE, segment="write_rtt",
        kind="StatefulSet", start_ts=t + 6.1, end_ts=t + 6.15)
    rec("reconcile", trace_id=TRACE, segment="reconcile",
        start_ts=t + 7.0, end_ts=t + 7.05)


def run_story(P):
    kube = P.FakeKube()
    kube.add_namespace("kubeflow")
    kube.add_namespace("team")
    counts = {"n": 0, "sum": 0.0}

    def page():
        lines = []
        cum = 0
        for b in BOUNDS:
            cum = counts["n"] if counts["sum"] <= b and counts["n"] else 0
            lines.append(f'{P.wait_metric}_bucket{{profile="team",'
                         f'le="{b}"}} {cum}')
        lines.append(f'{P.wait_metric}_bucket{{profile="team",le="+Inf"}} '
                     f'{counts["n"]}')
        lines.append(f'{P.wait_metric}_count{{profile="team"}} '
                     f'{counts["n"]}')
        return "\n".join(lines) + "\n"

    clock = {"now": BASE}
    pipe = P.fs.MetricsPipeline(tsdb=P.TSDB(), client=kube,
                                now=lambda: clock["now"], interval=1.0)
    pipe.scraper.add_source(lambda: [P.fs.self_target(
        page, labels={"replica": "ctrl-0"})])
    P.goodput.register_debug_goodput(pipe.goodput)   # as main.py does
    plant_journey(P)
    kube.create(job(P, "hold", "Running", alloc=1, ready=1))
    kube.create(job(P, "train", "Queued"))
    out = []
    for at, hold, train, wait in STORY:
        at += BASE
        clock["now"] = at
        for name, (phase, alloc, ready) in (("hold", hold),
                                            ("train", train)):
            obj = kube.get(P.job_gvk, name, "team")
            obj["status"] = job(P, name, phase, alloc=alloc,
                                ready=ready)["status"]
            kube.update_status(obj)
        if wait is not None:
            counts["n"] += 1
            counts["sum"] += wait
        stats = pipe.step(at=at)
        out.append({"at": at, "scrape": [stats.targets, stats.ok,
                                         stats.samples, stats.errors],
                    "alerts": pipe.engine.snapshot(),
                    "goodput": pipe.goodput.snapshot()})
    incidents = pipe.incidents.snapshot()
    bundles = [pipe.incidents.get(m["id"]) for m in incidents["incidents"]]
    events = sorted(
        (json.loads(json.dumps(e, default=P.types.json_default))
         for e in kube.list(P.types.EVENT, "kubeflow")),
        key=lambda e: e["metadata"]["name"])
    journey = P.causal.journey(TRACE)
    return {"steps": out, "incidents": incidents, "bundles": bundles,
            "events": events, "decompose": P.cp.decompose(journey),
            "acc": pipe.goodput._acc}


def test_queued_job_story_equals_the_reference():
    ref = strip(json.loads(json.dumps(run_story(REF), default=str)))
    got = strip(json.loads(json.dumps(run_story(PORT), default=str)))
    assert ref_words(got) == ref

    # The port's own reading of the story.
    alerts = {s["at"]: {a["alert"]: a for a in s["alerts"]["alerts"]}
              for s in got["steps"]}
    queue = [a["queue-wait"] for a in alerts.values()]
    fired_at = min(s["at"] for s in got["steps"]
                   if alerts[s["at"]]["queue-wait"]["state"] == "firing")
    assert fired_at == BASE + 6.0
    assert queue[-1]["metric"] == "gpujob_queue_wait_seconds_bucket"
    assert queue[-1]["thresholdSeconds"] == 1.0
    (manifest,) = got["incidents"]["incidents"]
    assert manifest["id"] == f"queue-wait-{int(BASE + 6.0)}"
    (bundle,) = got["bundles"]
    assert bundle["alert"]["fastBurn"] > 2 and bundle["alert"]["slowBurn"] > 1
    assert bundle["tsdb"]["metric"] == "gpujob_queue_wait_seconds_bucket"
    assert bundle["tsdb"]["series"]
    assert [j["trace_id"] for j in bundle["journeys"]] == [TRACE]
    assert bundle["goodput"]["profiles"]["team"]["tiles"]
    assert {e["metadata"]["name"] for e in got["events"]} == {
        "kft-alert-queue-wait", "kft-incident-queue-wait"}
    # The admission wait is train's whole Queued stretch, once.
    segs = got["decompose"]["segments"]
    assert segs["admission_queue"] == pytest.approx(6.0, abs=0.1)
    assert sum(segs.values()) == pytest.approx(got["decompose"]["total_s"],
                                               abs=1e-5)
    assert len([e for e in got["decompose"]["path"]
                if e.get("segment") == "admission_queue"]) == 1
    # Goodput: a tick charges the interval before it with the state it
    # reads, so hold holds one GPU over (0, 5] and train over (5, 11]:
    # 11 GPU-seconds, one queued (Pending at 6) and one idle (a worker
    # unready at 10), tiled exactly.
    acc = got["acc"]["team"]
    assert acc["allocated"] == pytest.approx(11.0)
    assert abs(sum(acc[s] for s in ("goodput", "queued", "restarting",
                                    "idle")) - acc["allocated"]) <= \
        1e-9 * acc["allocated"]
    assert acc["queued"] == pytest.approx(1.0)
    assert acc["idle"] == pytest.approx(1.0)


@pytest.mark.parametrize("peers", ["", "http://c-0:8080",
                                   " http://c-0:8080/ , ,http://c-1:8080"])
def test_peer_targets_equal_the_reference(monkeypatch, peers):
    monkeypatch.setenv("KFT_SCRAPE_PEERS", peers)
    got = [(t.url, t.labels, t.names) for t in PORT.fs.peer_targets()]
    ref = [(t.url, t.labels, t.names) for t in REF.fs.peer_targets()]
    assert got == ref
    assert len(got) == len([p for p in peers.split(",") if p.strip()])
    from kubeflow_tpu_torch.platform import config

    assert config.effective()["KFT_SCRAPE_PEERS"]["source"] == "env"


def test_pipeline_thread_reads_its_own_informers():
    """``start()`` opens unsharded GPUJob and InferenceService informers
    on the client and steps on its interval; ``stop()`` joins the thread
    and stops the informers."""
    from kubeflow_tpu_torch.platform.runtime import metrics

    kube = PORT.FakeKube()
    kube.add_namespace("kubeflow")
    kube.add_namespace("team")
    kube.create(job(PORT, "run", "Running", alloc=1, ready=1))
    pipe = PORT.fs.MetricsPipeline(tsdb=PORT.TSDB(), client=kube,
                                   interval=0.05)
    pipe.scraper.add_source(lambda: [PORT.fs.self_target(metrics.render)])
    pipe.start()
    try:
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            row = pipe.goodput.snapshot()["profiles"].get("team")
            if row and row["allocatedGpuSeconds"] > 0.1:
                break
            time.sleep(0.05)
        assert row and row["goodputRatio"] == 1.0 and row["tiles"]
        assert pipe.engine.last_eval_at is not None
        assert len(pipe.tsdb) > 0
    finally:
        pipe.stop()
    assert pipe._thread is None and pipe._informers is None
    assert metrics.gpu_goodput_ratio.sample(profile="team") == 1.0
