"""The port's critical-path analyzer (``kubeflow_tpu_torch/telemetry/
critical_path.py``) against the JAX package's: the span lists of
``tests/ctrlplane/test_causal.py``'s critical-path cases and journeys
drawn from a seed go through both packages' ``critical_path``,
``decompose`` and ``segment_summary``, and the results must be equal,
floats exactly (the port's copy runs the same arithmetic)."""
import numpy as np
import pytest

from kubeflow_tpu.telemetry import critical_path as ref_cp
from kubeflow_tpu_torch.telemetry import causal
from kubeflow_tpu_torch.telemetry import critical_path as cp


def _span(name, seg, t0, t1, trace="t" * 32, **attrs):
    return {"name": name, "trace_id": trace,
            "span_id": causal.new_span_id(), "segment": seg,
            "start_ts": t0, "end_ts": t1,
            "duration_ms": (t1 - t0) * 1e3, **attrs}


CASES = {
    "latest_predecessors": [
        _span("watch_lag", "watch_lag", 0.0, 1.0),
        _span("queue_wait", "queue_wait", 1.0, 2.0),
        _span("reconcile", "reconcile", 2.0, 5.0),
        _span("stale", "watch_lag", 0.0, 0.5),
    ],
    "mutual_eps_predecessors": [
        _span("a", "write_rtt", 10.00000, 10.00001, kind="Service"),
        _span("b", "write_rtt", 10.00002, 10.00003, kind="Service"),
    ],
    "nested_segments": [
        _span("queue_wait", "queue_wait", 0.0, 1.0),
        _span("reconcile", "reconcile", 1.0, 5.0),
        _span("admission_queue", "admission_queue", 2.0, 2.0),
        _span("k8s.create", "write_rtt", 3.0, 4.0, kind="StatefulSet"),
    ],
    "pod_start_gap": [
        _span("reconcile", "reconcile", 0.0, 1.0),
        _span("k8s.create", "write_rtt", 0.2, 0.9, kind="StatefulSet"),
        _span("watch_lag", "watch_lag", 3.0, 3.2),
        _span("reconcile", "reconcile", 3.2, 3.5),
    ],
    "admission_gap": [
        _span("reconcile", "reconcile", 0.0, 0.5),
        _span("reconcile", "reconcile", 4.0, 4.5),
        _span("admission_queue", "admission_queue", 0.4, 4.2),
    ],
    "queued_admission_once": [
        _span("reconcile", "reconcile", 10.0, 10.1),
        _span("admission_queue", "admission_queue", 10.05, 15.1),
        _span("reconcile", "reconcile", 15.0, 15.3),
    ],
    "empty": [],
    "open_span_ignored": [
        _span("reconcile", "reconcile", 0.0, 1.0),
        {**_span("x", "reconcile", 0.5, 0.6), "end_ts": None},
    ],
}

SEGMENTS = ("watch_lag", "queue_wait", "reconcile", "write_rtt",
            "pod_start", "admission_queue", "readiness_warm")
KINDS = ("StatefulSet", "Service", "Deployment", "Pod", "ConfigMap")


def drawn_journey(seed, n=24):
    """A GPUJob-like journey from a seed: a chain of watch, queue and
    reconcile spans, writes nested in the reconciles, an admission wait
    spanning a queued stretch, and stray overlapping spans."""
    rng = np.random.default_rng(seed)
    spans, t = [], float(rng.uniform(0, 100))
    for i in range(n):
        seg = SEGMENTS[int(rng.integers(0, 3))]
        d = float(rng.exponential(0.3))
        spans.append(_span(seg, seg, t, t + d))
        if seg == "reconcile" and rng.random() < 0.6:
            a = t + float(rng.uniform(0, d))
            spans.append(_span("k8s.create", "write_rtt", a,
                               a + float(rng.uniform(0, t + d - a)),
                               kind=KINDS[int(rng.integers(0, 5))]))
        if rng.random() < 0.15:
            w = float(rng.exponential(2.0))
            spans.append(_span("admission_queue", "admission_queue",
                               t + d - 0.01, t + d + w))
            t += w
        if rng.random() < 0.2:
            spans.append(_span("stray", SEGMENTS[int(rng.integers(0, 7))],
                               t - float(rng.uniform(0, 1)),
                               t + float(rng.uniform(0, 1))))
        t += d + float(rng.exponential(0.2)) * (rng.random() < 0.5)
    return spans


def _names(path):
    return [(s["name"], s["start_ts"], s["end_ts"]) for s in path]


@pytest.mark.parametrize("case", sorted(CASES))
def test_case_decomposes_as_the_reference(case):
    spans = CASES[case]
    assert _names(cp.critical_path(spans)) == \
        _names(ref_cp.critical_path(spans))
    got, ref = cp.decompose(spans), ref_cp.decompose(spans)
    assert got == ref
    assert cp.segment_summary(spans) == ref_cp.segment_summary(spans)
    if spans:
        assert sum(got["segments"].values()) == pytest.approx(
            got["total_s"], abs=1e-5)


@pytest.mark.parametrize("seed", range(12))
def test_drawn_journey_decomposes_as_the_reference(seed):
    spans = drawn_journey(seed)
    got, ref = cp.decompose(spans), ref_cp.decompose(spans)
    assert got == ref
    assert sum(got["segments"].values()) == pytest.approx(got["total_s"],
                                                          abs=1e-4)
    # The path entries tile [first start, last end] with no gap.
    path = got["path"]
    for a, b in zip(path, path[1:]):
        assert b["start_ts"] <= a["end_ts"] + cp.TILE_EPS


def test_port_holds_the_reference_assertions():
    d = cp.decompose(CASES["nested_segments"])
    assert d["segments"]["write_rtt"] == pytest.approx(1.0)
    assert d["segments"]["reconcile"] == pytest.approx(3.0)
    assert len([e for e in d["path"]
                if e.get("segment") == "admission_queue"]) == 1
    d = cp.decompose(CASES["pod_start_gap"])
    assert d["segments"]["pod_start"] == pytest.approx(2.0)
    d = cp.decompose(CASES["queued_admission_once"])
    assert d["segments"]["admission_queue"] == pytest.approx(5.0, abs=0.2)
    assert cp.decompose([]) == {"total_s": 0.0, "segments": {}, "path": []}
    assert [s["name"] for s in cp.critical_path(
        CASES["latest_predecessors"])] == ["watch_lag", "queue_wait",
                                          "reconcile"]


def test_span_store_recent_windows_by_end():
    store = causal.SpanStore(maxlen=64)
    for i in range(5):
        store.record("reconcile", trace_id=f"{i:032x}", segment="reconcile",
                     start_ts=float(i), end_ts=float(i) + 0.5)
    assert len(store) == 5
    assert [s["start_ts"] for s in store.recent(start=1.5, end=3.5)] == \
        [1.0, 2.0, 3.0]
    store.clear()
    assert len(store) == 0 and store.recent() == []
