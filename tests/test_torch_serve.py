"""PyTorch port generation server (kubeflow_tpu_torch.models.serve) on the
standard library's ThreadingHTTPServer, against the JAX reference
service, on the CPU."""
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import pytest
import torch

from kubeflow_tpu.models.llama import CONFIGS as JAX_CONFIGS
from kubeflow_tpu.models.llama import Llama as JaxLlama
from kubeflow_tpu.models.serve import GenerationService as JaxService
from kubeflow_tpu_torch.models import create_model
from kubeflow_tpu_torch.models.convert import params_from_jax
from kubeflow_tpu_torch.models.serve import (
    GenerationService,
    create_app,
    load_service,
)

ROWS = [[5, 9, 2], [7, 1, 4, 8, 3, 3, 9], [11, 200, 17, 4, 4, 6, 1, 0, 42]]


@pytest.fixture(scope="module")
def jax_service():
    jm = JaxLlama(JAX_CONFIGS["llama_debug"])
    params = jm.init(jax.random.key(0), jnp.ones((1, 8), jnp.int32))["params"]
    return JaxService(jm, params)


@pytest.fixture(scope="module")
def server(jax_service):
    model = create_model("llama_debug", device="cpu")
    model.load_state_dict(params_from_jax(
        jax.device_get(jax_service.params), model.cfg))
    # Pinned to the lock path: these tests hold its behaviour (one request
    # at a time behind the lock); tests/test_torch_scheduler.py holds the
    # scheduler that an instrumented service uses by default.
    service = GenerationService(model, use_scheduler=False)
    srv = create_app(service, model_name="llama_debug").make_server(
        "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", service
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _call(base, path, body=None, headers=None):
    data = None if body is None else (
        body if isinstance(body, bytes) else json.dumps(body).encode())
    req = urllib.request.Request(base + path, data=data,
                                 headers=headers or {})
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    try:
        with opener.open(req, timeout=60) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_http_tokens_equal_reference_service(server, jax_service):
    base, _ = server
    status, body = _call(base, "/v1/generate",
                         {"tokens": ROWS, "max_new_tokens": 6})
    assert status == 200
    got = json.loads(body)["tokens"]
    assert got == jax_service.generate(ROWS, max_new_tokens=6)


def test_health_ready_model_and_metrics(server):
    base, _ = server
    assert _call(base, "/healthz")[0] == 200
    status, body = _call(base, "/readyz")
    assert status == 200 and json.loads(body)["ready"] is True
    info = json.loads(_call(base, "/v1/model")[1])
    assert info["model"] == "llama_debug"
    assert info["config"]["vocab_size"] == 256
    _call(base, "/v1/generate", {"tokens": [[1, 2, 3]], "max_new_tokens": 3})
    status, text = _call(base, "/metrics")
    assert status == 200
    assert 'generate_requests_total{outcome="ok"}' in text
    assert "serve_output_tokens_total" in text
    assert "serve_input_tokens_total" in text
    assert "serve_time_to_first_token_seconds_count" in text


def test_traces_carry_request_spans(server):
    base, _ = server
    _call(base, "/v1/generate", {"tokens": [[4, 5]], "max_new_tokens": 2})
    traces = json.loads(_call(base, "/debug/traces?n=1")[1])["traces"]
    names = [s["name"] for s in traces[-1]["spans"]]
    assert names == ["admit", "queue", "prefill", "decode"]
    assert traces[-1]["result"] == "ok"


@pytest.mark.parametrize("body", [
    {},
    {"tokens": []},
    {"tokens": [[1, 2], []]},
    {"tokens": [[1, 999]]},
    {"tokens": [[1, True]]},
    {"tokens": [[1]], "max_new_tokens": 0},
    {"tokens": [[1]], "max_new_tokens": 1000},
    {"tokens": [[1]], "top_k": -1},
    {"tokens": [[1]], "temperature": "hot"},
    b"not json",
])
def test_bad_requests_get_400(server, body):
    base, _ = server
    status, text = _call(base, "/v1/generate", body)
    assert status == 400, text
    assert json.loads(text)["success"] is False


def test_qos_headers_validated(server):
    base, _ = server
    body = {"tokens": [[1, 2]], "max_new_tokens": 2}
    assert _call(base, "/v1/generate", body,
                 {"X-KFT-Priority": "urgent"})[0] == 400
    assert _call(base, "/v1/generate", body,
                 {"X-KFT-Deadline-Seconds": "-1"})[0] == 504
    assert _call(base, "/v1/generate", body,
                 {"X-KFT-Priority": "interactive"})[0] == 200
    assert _call(base, "/nope")[0] == 404


def test_concurrent_requests_serialize_and_balance_counters(server):
    """More request threads than cores, with a short switch interval: every
    response equals the one-at-a-time answer, and the counters balance."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    base, service = server
    bodies = [{"tokens": [ROWS[i % 3]], "max_new_tokens": 3, "seed": i}
              for i in range(16)]
    want = [_call(base, "/v1/generate", b) for b in bodies[:3]]

    def metric(text, name):
        return sum(float(line.rsplit(" ", 1)[1])
                   for line in text.splitlines() if line.startswith(name))

    before = _call(base, "/metrics")[1]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(max_workers=16) as pool:
            got = list(pool.map(lambda b: _call(base, "/v1/generate", b),
                                bodies))
    finally:
        sys.setswitchinterval(old)
    assert [g[0] for g in got] == [200] * 16
    for i, g in enumerate(got):
        assert g[1] == want[i % 3][1]
    after = _call(base, "/metrics")[1]
    ok = 'generate_requests_total{outcome="ok"}'
    assert metric(after, ok) - metric(before, ok) == 16
    assert metric(after, "serve_queue_depth ") == 0
    assert (metric(after, "serve_output_tokens_total ")
            - metric(before, "serve_output_tokens_total ")) == 16 * 3
    assert service._scheduler is None        # the lock path served them


def test_load_service_needs_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        load_service("llama_debug")
    service = load_service("llama_debug", device="cpu", seed=3)
    out = service.generate([[1, 2, 3]], max_new_tokens=2)
    assert len(out) == 1 and len(out[0]) == 2
    with pytest.raises(NotImplementedError, match="not yet ported"):
        load_service("llama_debug", device="cpu", quantize="int8")


def test_metrics_render_prometheus_text():
    from kubeflow_tpu_torch.telemetry.metrics import (
        Counter,
        Gauge,
        Histogram,
        Registry,
    )

    reg = Registry()
    c = Counter("reqs_total", "Requests", ["outcome"], registry=reg)
    g = Gauge("depth", "Queue depth", registry=reg)
    h = Histogram("lat_seconds", "Latency", registry=reg, buckets=(0.1, 1))
    c.labels(outcome='o"k').inc()
    c.labels(outcome='o"k').inc(2)
    g.inc()
    g.dec(3)
    for v in (0.05, 0.5, 5):
        h.observe(v)
    text = reg.render()
    assert '# TYPE reqs_total counter' in text
    assert 'reqs_total{outcome="o\\"k"} 3.0' in text
    assert "depth -2.0" in text
    assert 'lat_seconds_bucket{le="0.1"} 1' in text
    assert 'lat_seconds_bucket{le="1.0"} 2' in text
    assert 'lat_seconds_bucket{le="+Inf"} 3' in text
    assert "lat_seconds_count 3" in text and "lat_seconds_sum 5.55" in text
    with pytest.raises(ValueError):
        c.labels(outcome="x").inc(-1)
    with pytest.raises(ValueError):
        Gauge("depth", "again", registry=reg)
