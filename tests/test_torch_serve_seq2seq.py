"""The PyTorch port's seq2seq serving (``Seq2SeqGenerationService`` behind
``create_app``) and its wire client (``models/client.py``) on the CPU,
mirroring the reference's tests/test_serve.py and tests/test_scheduler.py
T5 cases: HTTP tokens equal to ``generate_seq2seq`` and to the
reference's service on the same converted parameters; the row, source
and new-token limits answer 400; ``max_seq_len``, ``n_layers`` and draft
models raise; int8 serving; the lock path kept with the scheduler gates
on; the client's 200, 400, 503 (Retry-After) and 504 outcomes, and its
parsing equal to the reference client's on the same wire triples."""
import dataclasses
import json
import random
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import client as jax_client
from kubeflow_tpu.models.serve import \
    Seq2SeqGenerationService as JaxSeq2SeqService
from kubeflow_tpu.models.t5 import CONFIGS as JAX_CONFIGS
from kubeflow_tpu.models.t5 import T5 as JaxT5
from kubeflow_tpu_torch.models import client, create_model
from kubeflow_tpu_torch.models.convert import state_from_flax
from kubeflow_tpu_torch.models.generate import generate_seq2seq
from kubeflow_tpu_torch.models.quantize import quantized_bytes
from kubeflow_tpu_torch.models.serve import (
    Seq2SeqGenerationService,
    create_app,
    load_service,
)

ROWS = [[5, 9, 2, 7], [3, 4], [11, 100, 17, 4, 4, 6, 1, 0, 42]]


def _no_proxy_opener():
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    return lambda req, timeout: opener.open(req, timeout=timeout)


class Server:
    """A service behind its app on a local port, with a wire client."""

    def __init__(self, service, name="t5_debug"):
        self.service = service
        self.srv = create_app(service, model_name=name).make_server(
            "127.0.0.1", 0)
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.base = f"http://127.0.0.1:{self.srv.server_address[1]}"
        self.client = client.GenerateClient(self.base, timeout=60,
                                            opener=_no_proxy_opener())

    def get(self, path):
        with _no_proxy_opener()(urllib.request.Request(self.base + path),
                                60) as resp:
            return resp.read().decode()

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()


@pytest.fixture(scope="module")
def reference():
    jm = JaxT5(JAX_CONFIGS["t5_debug"])
    variables = jax.device_get(jm.init(
        jax.random.key(0), jnp.ones((1, 8), jnp.int32),
        jnp.ones((1, 4), jnp.int32)))
    return jm, variables


@pytest.fixture(scope="module")
def server(reference):
    _, variables = reference
    model = create_model("t5_debug", device="cpu")
    model.load_state_dict(state_from_flax(variables, model))
    srv = Server(Seq2SeqGenerationService(model.eval()))
    yield srv
    srv.close()


def _metric(text, name):
    return sum(float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
               if line.startswith(name))


def test_http_tokens_equal_generate_and_reference_service(server, reference):
    jm, variables = reference
    res = server.client.generate(ROWS, max_new_tokens=6)
    assert res.ok and res.status == 200, res.log
    longest = max(len(r) for r in ROWS)
    src = torch.tensor([r + [0] * (longest - len(r)) for r in ROWS])
    mask = torch.arange(longest)[None] < torch.tensor(
        [len(r) for r in ROWS])[:, None]
    want = generate_seq2seq(server.service.model, src, source_mask=mask,
                            max_new_tokens=6)
    assert res.tokens == want.tolist()
    ref = JaxSeq2SeqService(jm, variables["params"])
    assert res.tokens == ref.generate(ROWS, max_new_tokens=6)
    info = json.loads(server.get("/v1/model"))
    assert info["config"]["n_encoder_layers"] == 2
    debug = json.loads(server.get("/debug/serve"))
    assert debug["engine"] is None and debug["paged_fallback"] is None


def test_metrics_count_through_eos_and_queue_drains(server):
    before = server.get("/metrics")
    res = server.client.generate([[5, 9, 2]], max_new_tokens=8)
    assert res.ok
    row = res.tokens[0]
    produced = row.index(1) + 1 if 1 in row else len(row)
    after = server.get("/metrics")
    for name, want in (('generate_requests_total{outcome="ok"}', 1),
                       ("serve_output_tokens_total ", produced),
                       ("generate_tokens_total ", produced)):
        assert _metric(after, name) - _metric(before, name) == want, name
    assert _metric(after, "serve_queue_depth ") == 0


@pytest.mark.parametrize("body,needle", [
    ({"tokens": [[5]], "max_new_tokens": 100_000_000}, "limit"),
    ({"tokens": [list(range(1, 60)) * 100], "max_new_tokens": 2}, "limit"),
    ({"tokens": [[5]] * 1000, "max_new_tokens": 2}, "rows"),
    ({"tokens": [[5, 128]]}, "outside"),
])
def test_request_limits_answer_400(server, body, needle):
    req = urllib.request.Request(
        server.base + "/v1/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        _no_proxy_opener()(req, 60)
        raise AssertionError("expected a 400")
    except urllib.error.HTTPError as e:
        res = client._parse(e.code, dict(e.headers), e.read())
    assert res.status == 400 and not res.ok and not res.retryable
    assert needle in res.log


@pytest.mark.parametrize("kwargs,match", [
    (dict(max_seq_len=512), "max_seq_len"),
    (dict(n_layers=1), "n_layers"),
    (dict(draft_model_name="llama_debug"), "decoder-only serving"),
])
def test_load_service_refuses_what_t5_lacks(kwargs, match):
    with pytest.raises(ValueError, match=match):
        load_service("t5_debug", device="cpu", **kwargs)


def test_load_service_builds_only_the_cut_model_on_the_device(monkeypatch):
    """The config's knobs are checked on the meta device: a model cut to
    fit the card (``n_layers``) is never built whole on it first."""
    from kubeflow_tpu_torch import models

    built = []
    real = models.create_model

    def record(name, *, device="cuda", **overrides):
        built.append((str(device), overrides))
        return real(name, device=device, **overrides)

    monkeypatch.setattr(models, "create_model", record)
    svc = load_service("llama_debug", device="cpu", n_layers=1)
    assert len(svc.model.layers) == 1
    assert [b for b in built if b[0] != "meta"] == [("cpu",
                                                     {"n_layers": 1})]
    built.clear()
    load_service("t5_debug", device="cpu")
    assert [b for b in built if b[0] != "meta"] == [("cpu", {})]


def test_seq2seq_draft_for_a_decoder_raises():
    with pytest.raises(ValueError, match="needs a decoder-only draft"):
        load_service("llama_debug", device="cpu", max_seq_len=64,
                     draft_model_name="t5_debug")


def test_load_service_builds_t5_and_serves_int8():
    plain = load_service("t5_debug", device="cpu", seed=3)
    assert isinstance(plain, Seq2SeqGenerationService)
    svc = load_service("t5_debug", device="cpu", seed=3, quantize="int8")
    assert svc.model.embed.qweight.dtype == torch.int8
    assert quantized_bytes(svc.model) < quantized_bytes(plain.model)
    srv = Server(svc)
    try:
        res = srv.client.generate([[5, 9, 2]], max_new_tokens=4)
        assert res.ok and len(res.tokens[0]) == 4
        assert all(0 <= t < 128 for t in res.tokens[0])
        debug = json.loads(srv.get("/debug/serve"))
        assert debug["quantize"] == "int8"
        assert debug["weight_bytes"] == quantized_bytes(svc.model)
    finally:
        srv.close()


def test_lock_path_kept_with_scheduler_gates_on(monkeypatch):
    monkeypatch.setenv("KFT_SERVE_SCHEDULER", "1")
    monkeypatch.setenv("KFT_SERVE_PAGED", "1")
    srv = Server(load_service("t5_debug", device="cpu"))
    try:
        assert srv.client.generate([[5, 9, 2]], max_new_tokens=4).ok
        assert getattr(srv.service, "_scheduler", None) is None
        traces = json.loads(srv.get("/debug/traces"))["traces"]
        assert [s["name"] for s in traces[-1]["spans"]] == [
            "admit", "queue", "generate"]
    finally:
        srv.close()


def _wait_for(predicate, timeout=30.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if predicate():
            return
        time.sleep(0.01)
    raise AssertionError("condition not reached")


def test_client_503_retry_after_while_warming_then_504_deadline():
    """Holding the service lock stalls /readyz's warm generate: a request
    meanwhile gets 503 with Retry-After; after it, a request whose
    deadline passes while it waits for the lock gets 504, and one sent
    with a spent deadline too."""
    srv = Server(load_service("t5_debug", device="cpu"))
    svc = srv.service
    try:
        svc._lock.acquire()
        ready = threading.Thread(target=srv.get, args=("/readyz",))
        ready.start()
        _wait_for(lambda: _metric(srv.get("/metrics"),
                                  "serve_queue_depth ") == 1)
        res = srv.client.generate([[5, 9]], max_new_tokens=2)
        assert res.status == 503 and res.retryable
        assert res.retry_after == 2.0 and "warm" in res.log
        svc._lock.release()
        ready.join(timeout=60)
        assert not ready.is_alive()
        assert srv.client.generate([[5, 9]], max_new_tokens=2).ok

        svc._lock.acquire()
        out = {}
        waiter = threading.Thread(target=lambda: out.update(
            res=srv.client.generate([[5, 9]], max_new_tokens=2,
                                    deadline_seconds=0.2)))
        waiter.start()
        time.sleep(0.5)
        svc._lock.release()
        waiter.join(timeout=60)
        assert not waiter.is_alive()
        assert out["res"].status == 504 and not out["res"].retryable
        assert "deadline" in out["res"].log
        spent = srv.client.generate([[5, 9]], max_new_tokens=2,
                                    deadline_seconds=0.0)
        assert spent.status == 504 and "already expired" in spent.log
    finally:
        if svc._lock.locked():
            svc._lock.release()
        srv.close()


WIRE = [
    (200, {"Content-Type": "application/json"},
     b'{"success": true, "tokens": [[1, 2]]}'),
    (400, {}, b'{"success": false, "status": 400, "log": "bad rows"}'),
    (503, {"Retry-After": "2"}, b'{"log": "warming"}'),
    (429, {"retry-after": "soon"}, b"{}"),
    (504, {"X-Other": "x"}, b'{"log": "deadline", "tokens": [[1]]}'),
    (200, {}, b"not json"),
    (500, {}, b""),
]


@pytest.mark.parametrize("status,headers,raw", WIRE)
def test_parse_equals_reference_client(status, headers, raw):
    got = client._parse(status, headers, raw)
    want = jax_client._parse(status, headers, raw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.ok, got.retryable) == (want.ok, want.retryable)


def test_headers_and_backoff_equal_reference_client():
    kw = dict(tenant="team-a", priority="batch")
    got = client.GenerateClient("http://h:1/", **kw)
    want = jax_client.GenerateClient("http://h:1/", **kw)
    assert got.base_url == want.base_url
    assert got.headers(deadline_seconds=1.5, traceparent="00-ab") == \
        want.headers(deadline_seconds=1.5, traceparent="00-ab")
    for attempt in range(6):
        assert client.full_jitter_backoff(
            attempt, base=0.1, cap=2.0, rng=random.Random(attempt)) == \
            jax_client.full_jitter_backoff(
                attempt, base=0.1, cap=2.0, rng=random.Random(attempt))
    assert np.isfinite(client.full_jitter_backoff(3, base=0.1, cap=2.0))
