"""The port's compute and replica telemetry (kubeflow_tpu_torch.telemetry)
against the reference's (kubeflow_tpu.telemetry) on the CPU: step
quantiles from the same observations, device memory from the same
snapshot, the attention footprint and its budget warning, the route
counter, and the replica's /debug/profile and traceparent link against
the reference app on the same queries and headers."""
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from prometheus_client import Histogram as PromHistogram
from werkzeug.test import Client

from kubeflow_tpu.models.llama import CONFIGS as JAX_CONFIGS
from kubeflow_tpu.models.llama import Llama as JaxLlama
from kubeflow_tpu.models.serve import GenerationService as JaxService
from kubeflow_tpu.models.serve import create_app as jax_create_app
from kubeflow_tpu.ops import attention as jax_attention
from kubeflow_tpu.telemetry import compute as jax_ctel
from kubeflow_tpu.telemetry import profiler as jax_profiler
from kubeflow_tpu_torch import ops
from kubeflow_tpu_torch.models import create_model
from kubeflow_tpu_torch.models.convert import params_from_jax
from kubeflow_tpu_torch.models.serve import GenerationService, create_app
from kubeflow_tpu_torch.ops import attention as port_attention
from kubeflow_tpu_torch.telemetry import compute as ctel
from kubeflow_tpu_torch.telemetry import metrics as tmetrics
from kubeflow_tpu_torch.telemetry import profiler as port_profiler

QS = (0.1, 0.5, 0.9, 0.99, 1.0)
# The first step's phase: the reference names it after jit compilation,
# the port after the first launch's build and warm-up.
FIRST = {"ref": "compile", "port": "first"}


def _samples(text, name):
    """{labels: value} of one family in Prometheus text."""
    out = {}
    for line in text.splitlines():
        if line.startswith(name + "{") or line.startswith(name + " "):
            key, value = line.rsplit(" ", 1)
            out[key] = float(value)
    return out


@pytest.fixture
def fresh_step_histograms(monkeypatch):
    """Both packages' step histograms replaced by empty ones of the same
    buckets, so observations of other tests in the process do not count."""
    assert tuple(ctel._STEP_BUCKETS) == tuple(jax_ctel._STEP_BUCKETS)
    ref = PromHistogram("train_step_seconds", "step", ["phase"],
                        buckets=jax_ctel._STEP_BUCKETS, registry=None)
    port = tmetrics.Histogram("train_step_seconds", "step", ["phase"],
                              buckets=ctel._STEP_BUCKETS)
    monkeypatch.setattr(jax_ctel, "train_step_seconds", ref)
    monkeypatch.setattr(ctel, "train_step_seconds", port)


def _observe(rs, n_ops):
    """The same random mix of single steps and timed windows into both."""
    for _ in range(n_ops):
        phase = "run" if rs.rand() < 0.8 else "first"
        seconds = float(np.exp(rs.uniform(np.log(5e-4), np.log(900.0))))
        if rs.rand() < 0.5:
            jax_ctel.observe_step(seconds, phase=FIRST["ref"]
                                  if phase == "first" else "run")
            ctel.observe_step(seconds, phase=FIRST["port"]
                              if phase == "first" else "run")
        else:
            n = int(rs.randint(0, 6))
            jax_ctel.observe_window(n, seconds, phase=FIRST["ref"]
                                    if phase == "first" else "run")
            ctel.observe_window(n, seconds, phase=FIRST["port"]
                                if phase == "first" else "run")


def _assert_quantiles_equal(got, want):
    assert set(got) == set(want)
    for q in want:
        if want[q] is None:
            assert got[q] is None, q
        else:
            assert abs(got[q] - want[q]) <= 1e-12, (q, got[q], want[q])


@pytest.mark.parametrize("since", [False, True])
@pytest.mark.parametrize("phase", [None, "run", "first"])
def test_step_quantiles_match_reference(fresh_step_histograms, since, phase):
    rs = np.random.RandomState(17)
    _observe(rs, 40)
    snaps = (jax_ctel.step_snapshot(), ctel.step_snapshot())
    assert snaps[0] == snaps[1]
    _observe(rs, 60)
    ref_phase = port_phase = phase
    if phase == "first":
        ref_phase, port_phase = FIRST["ref"], FIRST["port"]
    want = jax_ctel.step_quantiles(QS, since=snaps[0] if since else None,
                                   phase=ref_phase)
    got = ctel.step_quantiles(QS, since=snaps[1] if since else None,
                              phase=port_phase)
    _assert_quantiles_equal(got, want)
    if not (since and phase):
        # (A snapshot sums every phase, so diffing one phase's slice
        # against it is not a histogram: both packages may answer None.)
        assert any(v is not None for v in got.values())


def test_step_quantile_gauges_render_like_reference(fresh_step_histograms):
    for name in ("train_step_seconds_p50", "train_step_seconds_p99"):
        assert _samples(ctel.render(), name) == {}
        assert _samples(jax_ctel.render().decode(), name) == {}
    _observe(np.random.RandomState(5), 30)
    for name in ("train_step_seconds_p50", "train_step_seconds_p99"):
        got = _samples(ctel.render(), name)
        want = _samples(jax_ctel.render().decode(), name)
        assert list(got) == list(want) == [name]
        assert abs(got[name] - want[name]) <= 1e-12


def test_histogram_helpers_match_reference_on_labelled_histograms():
    """The port's snapshot and quantile helpers over a histogram with two
    labels, slices matched on one of them."""
    buckets = (0.01, 0.1, 1.0, 10.0)
    ref = PromHistogram("h", "h", ["a", "b"], buckets=buckets,
                        registry=None)
    port = tmetrics.Histogram("h", "h", ["a", "b"], buckets=buckets)
    rs = np.random.RandomState(9)
    for _ in range(200):
        a, b = rs.choice(["x", "y"]), rs.choice(["u", "v", "w"])
        v = float(rs.exponential(0.5))
        ref.labels(a=a, b=b).observe(v)
        port.labels(a=a, b=b).observe(v)
    from kubeflow_tpu.telemetry import metrics as jax_tmetrics

    for match in ({}, {"a": "x"}, {"b": "w"}, {"a": "y", "b": "u"},
                  {"a": "none"}):
        assert (tmetrics.histogram_snapshot(port, match)
                == jax_tmetrics.histogram_snapshot(ref, match))
        _assert_quantiles_equal(
            tmetrics.histogram_quantiles(port, match, QS),
            jax_tmetrics.histogram_quantiles(ref, match, QS))


SNAPSHOTS = {
    "none": {},
    "one card": {"cuda:0": {"in_use": 17_179_869_184, "peak": 38_000_000_000,
                            "limit": 85_520_809_984}},
    "two cards": {"cuda:0": {"in_use": 10, "peak": 70, "limit": 100},
                  "cuda:1": {"in_use": 40, "peak": 50, "limit": 100}},
}


@pytest.mark.parametrize("snap", list(SNAPSHOTS))
def test_device_memory_reads_and_render_match_reference(monkeypatch, snap):
    monkeypatch.setattr(jax_ctel, "device_memory_snapshot",
                        lambda: SNAPSHOTS[snap])
    monkeypatch.setattr(ctel, "device_memory_snapshot",
                        lambda: SNAPSHOTS[snap])
    assert ctel.hbm_peak_bytes() == jax_ctel.hbm_peak_bytes()
    assert ctel.free_hbm_bytes() == jax_ctel.free_hbm_bytes()
    got = _samples(ctel.render(), "device_memory_bytes")
    want = _samples(jax_ctel.render().decode(), "device_memory_bytes")
    assert got == want
    assert len(got) == 3 * len(SNAPSHOTS[snap])


def test_device_memory_absent_on_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CPU case does not apply")
    assert ctel.device_memory_snapshot() == {}
    assert ctel.hbm_peak_bytes() is None and ctel.free_hbm_bytes() is None
    assert _samples(ctel.render(), "device_memory_bytes") == {}
    assert "# TYPE device_memory_bytes gauge" in ctel.render()


@pytest.mark.parametrize("shape", [
    (1, 1, 1, 1, False, False), (2, 4, 24, 24, True, False),
    (4, 32, 512, 512, True, True), (2, 32, 300, 812, True, False),
    (4, 16, 1, 512, False, False), (8, 12, 197, 197, False, True),
])
def test_attention_footprint_bytes_match_reference(shape):
    b, h, sq, sk, causal, segments = shape
    kw = dict(batch=b, heads=h, q_len=sq, k_len=sk, causal=causal,
              segments=segments)
    assert (port_attention.attention_footprint_bytes(**kw)
            == jax_attention.attention_footprint_bytes(**kw))


def _warning_payloads(caplog, logger):
    return [json.loads(r.getMessage().split(": ", 1)[1])
            for r in caplog.records if r.name == logger]


@pytest.mark.parametrize("estimate,free", [
    (1 << 20, None), (1 << 20, 1 << 30), (1 << 29, 1 << 30),
    ((1 << 29) + 1, 1 << 30), (3 << 30, 1 << 30), (10, 0),
])
def test_budget_warning_matches_reference(monkeypatch, caplog, estimate,
                                          free):
    """Under the same free memory the estimate warns or stays quiet in
    both packages, with the same JSON keys and values (the time aside),
    the same counter step and the same gauge."""
    monkeypatch.setattr(jax_ctel, "free_hbm_bytes", lambda: free)
    monkeypatch.setattr(ctel, "free_hbm_bytes", lambda: free)
    assert (ctel.ATTENTION_HBM_BUDGET_FRACTION
            == jax_ctel.ATTENTION_HBM_BUDGET_FRACTION)
    attrs = dict(batch=2, heads=32, q_len=300, k_len=812, causal=True,
                 segments=False, impl="plain")
    name = "attention_mask_budget_warnings_total"
    before = (ctel.attention_mask_budget_warnings_total.sample(),
              jax_ctel.registry.get_sample_value(name))
    caplog.set_level(logging.WARNING)
    fired = (ctel.note_attention_estimate(estimate, **attrs),
             jax_ctel.note_attention_estimate(estimate, **attrs))
    assert fired[0] == fired[1]
    assert fired[0] == (free is not None and estimate > 0.5 * free)
    after = (ctel.attention_mask_budget_warnings_total.sample(),
             jax_ctel.registry.get_sample_value(name))
    assert after[0] - before[0] == after[1] - before[1] == int(fired[0])
    assert ctel.attention_estimate_value() == jax_ctel.attention_estimate_value()
    got = _warning_payloads(caplog, "kubeflow_tpu_torch.telemetry.compute")
    want = _warning_payloads(caplog, "kubeflow_tpu.telemetry.compute")
    assert len(got) == len(want) == int(fired[0])
    for g, w in zip(got, want):
        assert set(g) == set(w)
        g.pop("ts"), w.pop("ts")
        assert g == w


def test_route_counter_counts_plain_calls_on_cpu():
    """On CPU tensors an auto call takes the plain route: one count of
    ``plain``, none of ``kernel``, and the pre-flight gauge holds its
    footprint; the decode attention is not counted, as in the
    reference."""
    rs = np.random.RandomState(1)
    q = torch.from_numpy(rs.randn(2, 5, 4, 16).astype(np.float32))
    k = torch.from_numpy(rs.randn(2, 9, 2, 16).astype(np.float32))
    before = {i: ctel.attention_impl_calls(i) for i in ("plain", "kernel")}
    ops.dot_product_attention(q, k, k, causal=True)
    assert ctel.attention_impl_calls("plain") == before["plain"] + 1
    assert ctel.attention_impl_calls("kernel") == before["kernel"]
    assert ctel.attention_estimate_value() == 2 * 4 * 2 * 4 * 5 * 9
    ops.decode_attention(q[:, :1], k, k, torch.zeros(2, 9))
    assert ctel.attention_impl_calls("plain") == before["plain"] + 1


def test_route_counter_counts_a_forward_per_layer():
    model = create_model("llama_debug", device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(0))
    before = ctel.attention_impl_calls("plain")
    with torch.inference_mode():
        model(torch.ones(2, 6, dtype=torch.long))
    assert ctel.attention_impl_calls("plain") == (
        before + model.cfg.n_layers)
    assert ctel.attention_estimate_value() == 2 * 4 * 2 * 4 * 6 * 6


# -- the replica surface against the reference app ---------------------------


@pytest.fixture(scope="module")
def apps():
    """(reference werkzeug client, port app) over llama_debug with the same
    weights, both on the lock path."""
    jm = JaxLlama(JAX_CONFIGS["llama_debug"])
    params = jm.init(jax.random.key(0), jnp.ones((1, 8), jnp.int32))["params"]
    ref = Client(jax_create_app(JaxService(jm, params, use_scheduler=False),
                                model_name="llama_debug"))
    model = create_model("llama_debug", device="cpu")
    model.load_state_dict(params_from_jax(jax.device_get(params), model.cfg))
    port = create_app(GenerationService(model, use_scheduler=False),
                      model_name="llama_debug")
    return ref, port


def _port_get(app, path, headers=None):
    status, h, body = app.handle("GET", path, headers or {}, b"")
    return status, h["Content-Type"], body.decode()


def _ref_get(client, path, headers=None):
    resp = client.get(path, headers=headers or {})
    return resp.status_code, resp.headers["Content-Type"], resp.get_data(
        as_text=True)


@pytest.fixture
def two_profilers():
    """A profiler registered in each package, each sampled once (window 1
    open in both)."""
    profs = (jax_profiler.Profiler(hz=50.0, now=lambda: 0.0),
             port_profiler.Profiler(hz=50.0, now=lambda: 0.0))
    for p in profs:
        p.sample_once()
        assert p.current_window_id() == 1
    jax_profiler.register_debug_profiler(profs[0])
    port_profiler.register_debug_profiler(profs[1])
    try:
        yield profs
    finally:
        jax_profiler.register_debug_profiler(None)
        port_profiler.register_debug_profiler(None)


def test_debug_profile_is_404_without_a_profiler(apps):
    ref, port = apps
    assert jax_profiler.debug_profiler() is None
    assert port_profiler.debug_profiler() is None
    want = _ref_get(ref, "/debug/profile")
    got = _port_get(port, "/debug/profile")
    assert got[:2] == want[:2] and got[0] == 404


@pytest.mark.parametrize("query", [
    "", "?window=1", "?window=999", "?window=nope", "?window=",
    "?seconds=0", "?seconds=abc", "?seconds=0&window=999",
])
def test_debug_profile_status_and_type_match_reference(apps, two_profilers,
                                                       query):
    ref, port = apps
    want = _ref_get(ref, "/debug/profile" + query)
    got = _port_get(port, "/debug/profile" + query)
    assert got[:2] == want[:2], (got, want)
    if got[0] == 200:
        assert got[1] == "text/plain; charset=utf-8"
        # Each package's own stacks: the tests' main thread is the caller
        # and is skipped, so both hold folded lines of the other threads.
        assert all(line.rsplit(" ", 1)[1].isdigit()
                   for line in got[2].splitlines())


def test_debug_profile_is_gated_like_reference(monkeypatch, two_profilers):
    monkeypatch.setenv("DEBUG_TRACES", "false")
    jm = JaxLlama(JAX_CONFIGS["llama_debug"])
    params = jm.init(jax.random.key(0), jnp.ones((1, 8), jnp.int32))["params"]
    ref = Client(jax_create_app(JaxService(jm, params, use_scheduler=False)))
    port = create_app(GenerationService(
        create_model("llama_debug", device="cpu"), use_scheduler=False))
    for path in ("/debug/profile", "/debug/traces"):
        assert _port_get(port, path)[:2] == _ref_get(ref, path)[:2]
        assert _port_get(port, path)[0] == 404


@pytest.mark.parametrize("header", [
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    " 00-4BF92F3577B34DA6A3CE929D0E0E4736-00F067AA0BA902B7-00 ",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7",
    None,
])
def test_traceparent_links_the_request_trace_like_reference(apps, header):
    """A request sent with a traceparent shows the caller's trace id as
    ``causal_trace_id`` (and its span id as ``causal_span_id``) on
    /debug/traces, and ``?trace_id=`` finds it by that link, in both
    apps; a malformed or missing header links nothing."""
    ref, port = apps
    headers = {} if header is None else {"traceparent": header}
    body = {"tokens": [[5, 9, 2]], "max_new_tokens": 2}
    resp = ref.post("/v1/generate", json=body, headers=headers)
    assert resp.status_code == 200
    status, _, _ = port.handle("POST", "/v1/generate", headers,
                               json.dumps(body).encode())
    assert status == 200
    last = [json.loads(_ref_get(ref, "/debug/traces?n=1")[2])["traces"][-1],
            json.loads(_port_get(port, "/debug/traces?n=1")[2])["traces"][-1]]
    links = [{k: t.get(k) for k in ("causal_trace_id", "causal_span_id")}
             for t in last]
    assert links[0] == links[1]
    linked = header is not None and header.count("-") == 3
    if linked:
        trace_id = header.strip().lower().split("-")[1]
        assert links[1] == {"causal_trace_id": trace_id,
                            "causal_span_id": header.strip().lower()
                            .split("-")[2]}
        for get, app in ((_ref_get, ref), (_port_get, port)):
            found = json.loads(get(app, f"/debug/traces?trace_id={trace_id}")
                               [2])["traces"]
            assert found and found[-1]["trace_id"] == (
                last[0] if app is ref else last[1])["trace_id"]
    else:
        assert links[1] == {"causal_trace_id": None, "causal_span_id": None}


def test_metric_values_by_label_set():
    reg = tmetrics.Registry()
    requests = tmetrics.Counter("requests_total", "requests",
                                ["verb", "code"], registry=reg)
    depth = tmetrics.Gauge("depth", "depth", registry=reg)
    assert requests.values() == {}
    requests.labels(verb="get", code="200").inc()
    requests.labels(verb="get", code="200").inc(2)
    requests.labels(verb="list", code="500").inc()
    depth.set(4)
    assert requests.values() == {("get", "200"): 3.0, ("list", "500"): 1.0}
    assert depth.values() == {(): 4.0}
    assert requests.values()[("get", "200")] == \
        requests.sample(verb="get", code="200")
